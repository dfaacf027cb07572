// Anatomy probes, encoder family, for Hopper (sm_90a): the positional
// encoding of an (N, 128) f32 input done five ways, each -> (N, 128) f32.
//
// Replaces the Pallas TPU kernels of experiments/kernel_anatomy.py
//   pe_mm_kernel (:151)       E = inp @ P in f32; where(trg > 0, sin(E + ph),
//                             E) * s;
//   pe_vpu_kernel (:164)      the same E from three multiply-adds against
//                             rows 0..2 of P;
//   sin_kernel (:180)         sin(x);
//   pe_mm_bf16_kernel (:188)  pe_mm with inp and P rounded to bf16, f32
//                             accumulation (a rate check: bf16 destroys the
//                             2^k x arguments);
// and of experiments/kernel_anatomy2.py
//   pe_kernel (:177)          the fused kernel's encoders alone: both PEs by
//                             multiply-adds, Cody-Waite sin_cw with
//                             turn-unit phases added after the reduction,
//                             scale rows, the appearance columns rolled in
//                             under the ma mask (shift 21), the transient
//                             columns rolled to the front (shift 74);
//                             pe + dt + tt.
//
// What bounds them: bytes.  Each reads at most 512 and writes 512 bytes a
// point.  pe_only gives a thread one output column and a stride of rows,
// so a warp writes 128 consecutive bytes and the per-column constants sit
// in registers.  pe_vpu reads only the three input columns it needs and
// writes 512 bytes a point, so its stores are the stream: a lane stores a
// float4 of one row's quarter, a warp four whole rows' quarters an
// instruction, with VPU_ROWS input loads of a thread in flight before its
// first store and sinf skipped by warps whose columns hold no trig column.
// Measured on an H100 at 524,288 points, queued (experiments/
// pe_ablation.py, its tuning variants as of commit 789a8fa, which was
// measured with plain stores): 0.116 ms against 0.175 for the first design
// (one thread a column, 16 rows a block, a load before each 4-byte store,
// sinf on every column then a select); plain stores in place of streaming
// ones 0.122; 4 or 16 rows a thread 0.120 / 0.163 (16 halves the blocks an
// SM); a register cap for 6 or 8 blocks an SM spills sinf's frame and runs
// 0.19-0.33; a warp a whole row (sinf in every warp) 0.135.  Of the 0.116:
// the output's bytes 0.087 (torch's fill_ of the same tensor 0.084), the
// input rows 0.025 (a 16-byte read a 512-byte row brings whole sectors),
// sinf 0.003.
//
// The two products run on the Hopper block of fused_mlp_common.cuh as one
// template over the bf16 terms of each operand, pe_mm_hopper_kernel<TERMS>:
// persistent blocks of 128 points as two warpgroups of 64 rows, P's image
// (ops/anatomy.py:pe_image: each term as two 64-K slabs of the B operand's
// swizzled shared-memory image) resident in shared memory after one bulk
// copy a block, wgmma m64n64k16 from shared memory.  TERMS = 1 is
// pe_mm_bf16: inp and P rounded to bf16 to nearest even, one pass of K =
// 128.  TERMS = 3 is pe_mm, the f32 product as six bf16 passes (what JAX
// calls BF16_BF16_F32_X6): each operand split by truncation into hi + mid +
// lo, three bf16 values that share x's sign and hi's exponent and sum back
// to x exactly (for |x| over ~2^-103, where lo is still normal; x = +-inf
// splits into inf, NaN, NaN, so an infinite input gives NaN where x @ P
// gives +-inf), and the six cross products whose term indices sum to at
// most 2, smallest first, into one f32 accumulator (48 k16 steps).  At the
// probe's P (one power of two a column, so P's mid and lo are zero) every
// output sums at most three exact, disjoint products: E is x @ P bit for
// bit.  For a dense P the result is an f32-accurate product, not a
// bit-exact one.  On the tensor cores six passes of 17.2 GFLOP are ~0.10
// ms at 524,288 points, under the 0.16 ms of the bytes, so bytes bound
// both.
//
// What the measurements on an H100 chose (experiments/pe_ablation.py and
// probe_timing.py): each warpgroup's product runs as two of 64 output
// columns, so the epilogue on the first one's fragments overlaps the
// second's passes; the next tile's rows load into registers while the
// products run (~160 registers a thread, so one block an SM: loading them
// into L2 instead, at two blocks an SM, measured slower for both); and
// the epilogue skips sinf by a warp-uniform branch where none of a warp's
// columns is a trig column (the compiler otherwise evaluates sinf for every
// column and selects), which took 15-18% off the two probes.
//
// sin is a pure stream (0.537 GB a launch at 524,288 points): one tile of
// SIN_UNROLL x SIN_THREADS float4s a block, as many blocks as tiles, so the
// hardware's block scheduler hands the next tile to whichever SM frees up
// first; 16-byte loads and stores; a scalar tail takes a count that is not
// a multiple of 4.  Measured on an H100 (experiments/sin_ablation.py): a
// persistent grid that walks the tiles with a grid stride is ~5-8% slower
// (each SM gets a fixed share and the slowest one sets the time); more
// loads in flight a thread (SIN_UNROLL 4) do not help, since 2,048 resident
// threads an SM already keep 32 KB in flight; streaming cache hints
// (__ldcs / __stcs) gain nothing either.
//
// Numerics: sin is sinf (build without --use_fast_math, or it becomes
// __sinf); multiply-adds that the Pallas kernels keep apart are __fmul_rn /
// __fadd_rn so that none is contracted.  Each column of the probes' P has
// one non-zero entry, a power of two, so E is exact in any order of
// summation.
#include "fused_mlp_common.cuh"

namespace {

constexpr int LANES = 128;
constexpr int ROWS_PER_BLOCK = 16;     // pe_only: 2 rows a pass
constexpr int SIN_THREADS = 256;
constexpr int SIN_UNROLL = 1;          // float4s a thread a tile
constexpr int SIN_TILE = SIN_THREADS * SIN_UNROLL;   // float4s a tile

// where(trg > 0, sin(E + ph), E) * s
__device__ __forceinline__ float pe_out(float E, float ph, float trg,
                                        float s) {
  return __fmul_rn(trg > 0.0f ? sinf(__fadd_rn(E, ph)) : E, s);
}

// E = x0 r0 + x1 r1 + x2 r2, left to right
__device__ __forceinline__ float mad3(float x0, float x1, float x2, float r0,
                                      float r1, float r2) {
  float E = __fmul_rn(x0, r0);
  E = __fadd_rn(E, __fmul_rn(x1, r1));
  return __fadd_rn(E, __fmul_rn(x2, r2));
}

__device__ __forceinline__ float accum3(const float* v, float r0, float r1,
                                        float r2) {
  return mad3(v[0], v[1], v[2], r0, r1, r2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// pe_vpu: a warp owns one quarter of the columns (QUARTER = 32, 128 bytes
// of a row) and writes 4 rows of it an instruction, a float4 a lane, so
// every store fills four whole 128-byte segments; the stores are
// streaming (__stcs: evict first, nothing reads them back).  A block of 8
// warps covers VPU_TILE rows, as many blocks as tiles: warps w and w + 4
// take quarter w & 3 of alternate groups of 4 rows.  A thread loads the
// first float4 of each of its VPU_ROWS rows (the row's three inputs; the 8
// lanes of a row share the address) before its first store, so VPU_ROWS
// loads are in flight.  The columns of a warp never change, so whether any
// of them is a trig column is decided once, warp-uniform: a warp with none
// runs no sinf at all.
constexpr int VPU_THREADS = 256;
constexpr int QUARTER = LANES / 4;
constexpr int VPU_ROWS = 8;                       // rows a thread stores
constexpr int VPU_TILE = 2 * 4 * VPU_ROWS;        // rows a block

__global__ void __launch_bounds__(VPU_THREADS)
pe_vpu_kernel(const float* __restrict__ P, const float* __restrict__ ph,
              const float* __restrict__ trg, const float* __restrict__ s,
              const float* __restrict__ inp, float* __restrict__ out, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (warp & 3) * QUARTER + 4 * (lane & 7);   // 4 columns from c
  const float4 p0 = ld4(P + c), p1 = ld4(P + LANES + c),
               p2 = ld4(P + 2 * LANES + c);
  const float4 phc = ld4(ph + c), tc = ld4(trg + c), sc = ld4(s + c);
  const bool trig = __any_sync(
      0xffffffffu, tc.x > 0.0f || tc.y > 0.0f || tc.z > 0.0f || tc.w > 0.0f);
  // row of step u: r0 + 8 u
  const size_t r0 = (size_t)blockIdx.x * VPU_TILE + 4 * (warp >> 2) +
                    (lane >> 3);
  float4 x[VPU_ROWS];
#pragma unroll
  for (int u = 0; u < VPU_ROWS; ++u) {
    const size_t r = r0 + 8 * u;
    x[u] = r < (size_t)n ? ld4(inp + r * LANES)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < VPU_ROWS; ++u) {
    const size_t r = r0 + 8 * u;
    if (r >= (size_t)n) break;
    const float4 v = x[u];
    float4 E = make_float4(mad3(v.x, v.y, v.z, p0.x, p1.x, p2.x),
                           mad3(v.x, v.y, v.z, p0.y, p1.y, p2.y),
                           mad3(v.x, v.y, v.z, p0.z, p1.z, p2.z),
                           mad3(v.x, v.y, v.z, p0.w, p1.w, p2.w));
    float4 o;
    if (trig)
      o = make_float4(pe_out(E.x, phc.x, tc.x, sc.x),
                      pe_out(E.y, phc.y, tc.y, sc.y),
                      pe_out(E.z, phc.z, tc.z, sc.z),
                      pe_out(E.w, phc.w, tc.w, sc.w));
    else
      o = make_float4(__fmul_rn(E.x, sc.x), __fmul_rn(E.y, sc.y),
                      __fmul_rn(E.z, sc.z), __fmul_rn(E.w, sc.w));
    __stcs(reinterpret_cast<float4*>(out + r * LANES + c), o);
  }
}

int launch_pe_vpu(const float* const* f, float* out, int n,
                  cudaStream_t stream) {
  uintptr_t any = reinterpret_cast<uintptr_t>(out);
  for (int i = 0; i < 5; ++i) any |= reinterpret_cast<uintptr_t>(f[i]);
  if (any & 15) return (int)cudaErrorInvalidValue;   // float4 loads, stores
  const int blocks = (n + VPU_TILE - 1) / VPU_TILE;   // one tile a block
  pe_vpu_kernel<<<blocks, VPU_THREADS, 0, stream>>>(f[0], f[1], f[2], f[3],
                                                    f[4], out, n);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float4 sin4(float4 v) {
  return make_float4(sinf(v.x), sinf(v.y), sinf(v.z), sinf(v.w));
}

// out[i] = sinf(x[i]) for i < n; x and out 16-byte aligned.  Block b takes
// tiles b, b + gridDim.x, ...: the loads of a tile are issued before its
// first sinf.
__global__ void __launch_bounds__(SIN_THREADS)
sin_kernel(const float* __restrict__ x, float* __restrict__ out, size_t n) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  const size_t n4 = n / 4;
  for (size_t i = (size_t)blockIdx.x * SIN_TILE + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * SIN_TILE) {
    float4 v[SIN_UNROLL];
#pragma unroll
    for (int u = 0; u < SIN_UNROLL; ++u)
      if (i + u * SIN_THREADS < n4) v[u] = x4[i + u * SIN_THREADS];
#pragma unroll
    for (int u = 0; u < SIN_UNROLL; ++u)
      if (i + u * SIN_THREADS < n4) o4[i + u * SIN_THREADS] = sin4(v[u]);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const size_t e = 4 * n4 + threadIdx.x;
    out[e] = sinf(x[e]);
  }
}

int launch_sin(const float* x, float* out, size_t n, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorInvalidValue;
  size_t blocks = (n / 4 + SIN_TILE - 1) / SIN_TILE;   // one tile a block
  if (blocks == 0) blocks = 1;                          // the tail alone
  sin_kernel<<<(unsigned)blocks, SIN_THREADS, 0, stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

struct EncRows {
  const float *PxR, *phx, *trgx, *sx, *PdR, *phd, *trgd, *sd, *ma;
};

__global__ void __launch_bounds__(THREADS)
pe_only_kernel(EncRows e, const float* __restrict__ inp,
               float* __restrict__ out, int n) {
  const int c = threadIdx.x & (LANES - 1);
  const float x0 = e.PxR[c], x1 = e.PxR[LANES + c], x2 = e.PxR[2 * LANES + c];
  const float d0 = e.PdR[c], d1 = e.PdR[LANES + c], d2 = e.PdR[2 * LANES + c];
  const float phx = e.phx[c], sx = e.sx[c], phd = e.phd[c], sd = e.sd[c];
  const bool trgx = e.trgx[c] > 0.0f, trgd = e.trgd[c] > 0.0f;
  const bool ma = e.ma[c] > 0.0f;
  // roll(inp, s)[:, c] = inp[:, (c - s) mod 128]
  const int a_src = (c - 21) & (LANES - 1), t_src = (c - 74) & (LANES - 1);
  const size_t r0 = (size_t)blockIdx.x * ROWS_PER_BLOCK;
  for (int i = threadIdx.x >> 7; i < ROWS_PER_BLOCK; i += THREADS / LANES) {
    const size_t r = r0 + i;
    if (r >= (size_t)n) break;
    const float* row = inp + r * LANES;
    const float Ex = accum3(row, x0, x1, x2);
    const float pe = __fmul_rn(trgx ? sin_cw(Ex, phx) : Ex, sx);
    const float Ed = accum3(row + 3, d0, d1, d2);
    float dt = __fmul_rn(trgd ? sin_cw(Ed, phd) : Ed, sd);
    if (ma) dt = row[a_src];
    out[r * LANES + c] = __fadd_rn(__fadd_rn(pe, dt), row[t_src]);
  }
}

// ---- pe_mm and pe_mm_bf16 on the Hopper block ----
namespace pm {

using namespace hop;

constexpr int PM_THREADS = CONSUMERS * 128;     // two warpgroups, no producer
constexpr int P_SLAB_BYTES = LANES * 128;       // 128 image rows x 64 K-values
constexpr int K_TILES = LANES / 64;             // operand tiles (slabs) a term
constexpr int TERM_BYTES = K_TILES * P_SLAB_BYTES;   // one bf16 term of P
constexpr int EPI_FLOATS = 3 * LANES;           // ph | trg | s
constexpr int ROWS_A_WARP = WG_ROWS / 4;        // input rows a warp loads
constexpr int N_HALF = LANES / 2;               // output columns a product

// The passes of the product as (A term, B term) hex digit pairs, the first
// pass leftmost; terms 0 hi, 1 mid, 2 lo.  Smallest first: lo.hi, mid.mid,
// hi.lo, mid.hi, hi.mid, hi.hi.  TERMS = 1 runs the last alone.
constexpr unsigned long long PASSES = 0x201102100100ull;
constexpr int N_PASS_ALL = 6;
__host__ __device__ constexpr int n_passes(int terms) {
  return terms == 1 ? 1 : N_PASS_ALL;
}
__host__ __device__ constexpr int pass_term(int pass, int operand) {
  return (int)(PASSES >> (8 * (N_PASS_ALL - 1 - pass) + 4 * (1 - operand))) &
         0xf;
}

// a block: the 1024-byte alignment slack, each warpgroup's operand tiles
// (TERMS terms x 2 tiles of 8 KB), P's image (TERMS x 32 KB), ph / trg / s
// and the image's barrier
__host__ __device__ constexpr int smem_bytes(int terms) {
  return 1024 + CONSUMERS * terms * K_TILES * TILE_BYTES + terms * TERM_BYTES +
         EPI_FLOATS * 4 + 8;
}
static_assert(smem_bytes(3) <= 232448, "over the 227 KB a block can have");

// P's image: each term's 128 K rows cut into slabs of 64 K-values x 128
// image rows (ops/anatomy.py:pe_image_plan is the same walk).  Returns the
// image's size in bytes.
inline int make_pe_plan(Plan& p, int terms) {
  p = Plan{};
  int at = 0;
  for (int j = 0; j < terms; ++j) plan_seg(p, at, LANES, LANES);
  return at;
}

// This warp's 16 rows of the warpgroup's 64 at row0 into registers: row
// 16 warp + m, columns 4 lane .. 4 lane + 3 (a warp reads one 512-byte row
// an instruction); rows past n are zero.
__device__ __forceinline__ void load_rows(float4 (&v)[ROWS_A_WARP],
                                          const float* __restrict__ inp,
                                          size_t row0, int n, int warp,
                                          int lane) {
#pragma unroll
  for (int m = 0; m < ROWS_A_WARP; ++m) {
    const size_t row = row0 + ROWS_A_WARP * warp + m;
    v[m] = row < (size_t)n
               ? __ldg(reinterpret_cast<const float4*>(inp + row * LANES) + lane)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Two f32 values as bf16 bit pairs (a in the low half), truncated: their top
// 16 bits.
__device__ __forceinline__ uint32_t top2(uint32_t a, uint32_t b) {
  return (a >> 16) | (b & 0xffff0000u);
}

// The rows in v as the A operand's terms: TERMS = 1, rounded to bf16 to
// nearest even; TERMS = 3, x = hi + mid + lo by truncation (hi: x with its
// low 16 bits cleared; mid: the same of x - hi; lo = x - hi - mid), term i
// at tiles 2 i, 2 i + 1.  8 bytes a store; a warp writes one row of both
// tiles of a term (two wavefronts).
template <int TERMS>
__device__ __forceinline__ void put_terms(unsigned char* act,
                                          const float4 (&v)[ROWS_A_WARP],
                                          int warp, int lane) {
#pragma unroll
  for (int m = 0; m < ROWS_A_WARP; ++m) {
    const int r = ROWS_A_WARP * warp + m;
    const float x[4] = {v[m].x, v[m].y, v[m].z, v[m].w};
    if constexpr (TERMS == 1) {
      *reinterpret_cast<uint2*>(act + act_off(0, r, 4 * lane)) =
          make_uint2(pack2(x[0], x[1]), pack2(x[2], x[3]));
    } else {
      uint32_t t[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t hi = __float_as_uint(x[e]) & 0xffff0000u;
        const float rest = __fsub_rn(x[e], __uint_as_float(hi));
        const uint32_t mid = __float_as_uint(rest) & 0xffff0000u;
        t[0][e] = hi;
        t[1][e] = mid;
        t[2][e] = __float_as_uint(__fsub_rn(rest, __uint_as_float(mid)));
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
        *reinterpret_cast<uint2*>(act + act_off(K_TILES * i, r, 4 * lane)) =
            make_uint2(top2(t[i][0], t[i][1]), top2(t[i][2], t[i][3]));
    }
  }
}

// The passes of one product into acc: output columns col0 .. col0 + 63,
// 8 k16 steps a pass.
template <int TERMS>
__device__ __forceinline__ void run_passes(float (&acc)[N_HALF / 2],
                                           uint32_t a0, uint32_t b0,
                                           int col0) {
  constexpr int FIRST = N_PASS_ALL - n_passes(TERMS);
#pragma unroll
  for (int p = FIRST; p < N_PASS_ALL; ++p)
#pragma unroll
    for (int kt = 0; kt < K_TILES; ++kt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<N_HALF>::template run<0, 0>(
            acc,
            kdesc(a0 + (K_TILES * pass_term(p, 0) + kt) * TILE_BYTES +
                  32 * kk),
            kdesc(b0 + (K_TILES * pass_term(p, 1) + kt) * P_SLAB_BYTES +
                  col0 * 128 + 32 * kk),
            p > FIRST || kt > 0 || kk > 0);
  wgmma_commit();
}

// where(trg > 0, sin(E + ph), E) * s on one product's fragments, stored as
// f32 pairs: a quad writes 32 contiguous bytes of a row; rows past n are
// not stored.  epi: ph | trg | s in shared memory.
__device__ __forceinline__ void store_out(const float (&acc)[N_HALF / 2],
                                          const float* epi,
                                          float* __restrict__ out,
                                          size_t row0, int n, int col0,
                                          int fr, int fq) {
#pragma unroll
  for (int j = 0; j < N_HALF / 8; ++j) {
    const int c = col0 + 8 * j + 2 * fq;
    const float2 p2 = *reinterpret_cast<const float2*>(epi + c);
    const float2 t2 = *reinterpret_cast<const float2*>(epi + LANES + c);
    const float2 s2 = *reinterpret_cast<const float2*>(epi + 2 * LANES + c);
    // warp-uniform: where none of the warp's 8 columns is a trig column,
    // no sinf at all (the compiler evaluates sinf for every column and
    // selects, else)
    const bool trig = __any_sync(0xffffffffu, t2.x > 0.0f || t2.y > 0.0f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = row0 + fr + 8 * h;
      float2 o;
      if (trig)
        o = make_float2(pe_out(acc[4 * j + 2 * h], p2.x, t2.x, s2.x),
                        pe_out(acc[4 * j + 2 * h + 1], p2.y, t2.y, s2.y));
      else
        o = make_float2(__fmul_rn(acc[4 * j + 2 * h], s2.x),
                        __fmul_rn(acc[4 * j + 2 * h + 1], s2.y));
      if (row < (size_t)n)
        *reinterpret_cast<float2*>(out + row * LANES + c) = o;
    }
  }
}

// E = inp @ P, out = where(trg > 0, sin(E + ph), E) * s, 128 points a tile.
// Persistent blocks of two warpgroups of 64 rows; P's image (TERMS terms,
// bf16) copied once a block by one bulk copy a slab behind one mbarrier.
// Each warpgroup writes its rows' terms as swizzled operand tiles and runs
// the passes as two products of 64 output columns, each into its own f32
// accumulator; the epilogue of the first runs while the second's passes
// do.  The next tile's rows are live in registers across the epilogue.
template <int TERMS>
__global__ void __launch_bounds__(PM_THREADS, 1)
pe_mm_hopper_kernel(const float* __restrict__ inp, float* __restrict__ out,
                    int n, const unsigned char* __restrict__ image,
                    const float* __restrict__ ph,
                    const float* __restrict__ trg,
                    const float* __restrict__ s) {
  constexpr int A_BYTES = TERMS * K_TILES * TILE_BYTES;   // a warpgroup's
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles sit on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* pimg = smem + CONSUMERS * A_BYTES;
  float* epi = reinterpret_cast<float*>(pimg + TERMS * TERM_BYTES);
  const uint32_t bar = smem_u32(epi + EPI_FLOATS);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_smem();
  }
  if (tid < LANES) {
    epi[tid] = ph[tid];
    epi[LANES + tid] = trg[tid];
    epi[2 * LANES + tid] = s[tid];
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, TERMS * TERM_BYTES);
    for (int k = 0; k < TERMS * K_TILES; ++k)
      bulk_g2s(smem_u32(pimg) + k * P_SLAB_BYTES, image + k * P_SLAB_BYTES,
               P_SLAB_BYTES, bar);
  }

  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int fr = 16 * warp + (lane >> 2), fq = lane & 3;
  unsigned char* act = smem + wg * A_BYTES;
  const uint32_t a0 = smem_u32(act), b0 = smem_u32(pimg);
  const int n_tiles = (n + ROWS - 1) / ROWS;
  const size_t stride = (size_t)gridDim.x * ROWS;

  float4 v[ROWS_A_WARP];
  load_rows(v, inp, (size_t)blockIdx.x * ROWS + wg * WG_ROWS, n, warp, lane);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * ROWS + wg * WG_ROWS;
    // the operand tiles are free: this warpgroup's last products completed
    put_terms<TERMS>(act, v, warp, lane);
    fence_async_smem();
    wg_sync(wg);
    mbar_wait(bar, 0);                 // P's image (passes at once later)

    float acc0[N_HALF / 2], acc1[N_HALF / 2];
    wgmma_fence();
    run_passes<TERMS>(acc0, a0, b0, 0);
    run_passes<TERMS>(acc1, a0, b0, N_HALF);
    // the next tile's rows on their way while the products run
    load_rows(v, inp, row0 + stride, n, warp, lane);
    wgmma_wait<1>();
    fence_acc(acc0);
    store_out(acc0, epi, out, row0, n, 0, fr, fq);
    wgmma_wait<0>();
    fence_acc(acc1);
    store_out(acc1, epi, out, row0, n, N_HALF, fr, fq);
  }
}

template <int TERMS>
int launch(const float* const* f, float* out, int n, const void* image,
           cudaStream_t stream) {
  constexpr int SMEM = smem_bytes(TERMS);
  // cp.async.bulk takes a 16-byte aligned source, the rows load as float4
  if (image == nullptr || (reinterpret_cast<uintptr_t>(image) & 15) ||
      (reinterpret_cast<uintptr_t>(f[4]) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pe_mm_hopper_kernel<TERMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pe_mm_hopper_kernel<TERMS>, PM_THREADS, SMEM);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  pe_mm_hopper_kernel<TERMS><<<grid, PM_THREADS, SMEM, stream>>>(
      f[4], out, n, static_cast<const unsigned char*>(image), f[1], f[2],
      f[3]);
  return (int)cudaGetLastError();
}

}  // namespace pm

}  // namespace

extern "C" {

// variant 0 pe_mm, 1 pe_vpu, 2 sin, 3 pe_mm_bf16, 4 pe_only.  ops: device
// pointers to f32 arrays in the Pallas kernel's operand order:
//   pe_mm, pe_vpu, pe_mm_bf16: P (128, 128), ph, trg, s (1, 128), inp
//   sin: x
//   pe_only: PxR (3, 128), phx, trgx, sx, PdR, phd, trgd, sd, ma, inp
// out: (n, 128) f32.  scratch: for variants 0 and 3, P's image
// (ops/anatomy.py:pe_image with 3 terms or 1: the bytes of
// nerf_anatomy_pe_plan), which the kernel reads in place of P; unused
// otherwise.  Returns 0 or the cudaError_t of the launch.
int nerf_anatomy_pe(int variant, const void* const* ops, float* out, int n,
                    void* scratch, void* stream) {
  if (n < 0 || variant < 0 || variant > 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(ops);
  if (variant == 0) return pm::launch<3>(f, out, n, scratch, st);
  if (variant == 3) return pm::launch<1>(f, out, n, scratch, st);
  if (n == 0) return 0;
  if (variant == 1) return launch_pe_vpu(f, out, n, st);
  if (variant == 2) return launch_sin(f[0], out, (size_t)n * LANES, st);
  const int row_blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  EncRows e = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
  pe_only_kernel<<<row_blocks, THREADS, 0, st>>>(e, f[9], out, n);
  return (int)cudaGetLastError();
}

// The pe_mm kernel's block and P's image for `terms` 3 (pe_mm) or 1
// (pe_mm_bf16): info[0] points a block, [1] threads, [2] shared-memory
// bytes, [3] slabs in a weight ring (0: the image stays resident), [4]
// slabs in the plan, [5] the image's bytes, [6] bytes a slab; off / bytes
// (hop::MAX_SLABS each): every slab's byte offset and size.
void nerf_anatomy_pe_plan(int terms, int* info, int* off, int* bytes) {
  hop::Plan plan;
  const int image_bytes = pm::make_pe_plan(plan, terms);
  info[0] = hop::ROWS;
  info[1] = pm::PM_THREADS;
  info[2] = pm::smem_bytes(terms);
  info[3] = 0;
  info[4] = plan.n_slabs;
  info[5] = image_bytes;
  info[6] = pm::P_SLAB_BYTES;
  for (int s = 0; s < plan.n_slabs && s < hop::MAX_SLABS; ++s) {
    off[s] = plan.off[s];
    bytes[s] = plan.bytes[s];
  }
}

}  // extern "C"
