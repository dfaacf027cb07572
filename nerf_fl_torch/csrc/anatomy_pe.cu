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
// point; only pe_mm does real arithmetic (16,384 f32 MACs a point on the
// CUDA cores, which puts it just on the operations side).  The encoder
// kernels give a thread one output column and a stride of rows, so a warp
// writes 128 consecutive bytes and the per-column constants sit in
// registers; pe_vpu reads only the three input columns it needs.  The two
// products reuse the fused kernels' gemm on a 64-point tile: the f32
// instance is plain FMAs (no TF32), the bf16 instance WMMA.
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
// __fadd_rn so that none is contracted.  Each column of P has one non-zero
// entry, a power of two, so E is exact in any order of summation.
#include "fused_mlp_common.cuh"

namespace {

constexpr int LANES = 128;
constexpr int ROWS_PER_BLOCK = 16;     // encoder kernels: 2 rows a pass
constexpr int SIN_THREADS = 256;
constexpr int SIN_UNROLL = 1;          // float4s a thread a tile
constexpr int SIN_TILE = SIN_THREADS * SIN_UNROLL;   // float4s a tile

// where(trg > 0, sin(E + ph), E) * s
__device__ __forceinline__ float pe_out(float E, float ph, float trg,
                                        float s) {
  return __fmul_rn(trg > 0.0f ? sinf(__fadd_rn(E, ph)) : E, s);
}

// E = v[0] r0 + v[1] r1 + v[2] r2, left to right
__device__ __forceinline__ float accum3(const float* v, float r0, float r1,
                                        float r2) {
  float E = __fmul_rn(v[0], r0);
  E = __fadd_rn(E, __fmul_rn(v[1], r1));
  return __fadd_rn(E, __fmul_rn(v[2], r2));
}

__global__ void __launch_bounds__(THREADS)
pe_vpu_kernel(const float* __restrict__ P, const float* __restrict__ ph,
              const float* __restrict__ trg, const float* __restrict__ s,
              const float* __restrict__ inp, float* __restrict__ out, int n) {
  const int c = threadIdx.x & (LANES - 1);
  const float p0 = P[c], p1 = P[LANES + c], p2 = P[2 * LANES + c];
  const float phc = ph[c], trgc = trg[c], sc = s[c];
  const size_t r0 = (size_t)blockIdx.x * ROWS_PER_BLOCK;
  for (int i = threadIdx.x >> 7; i < ROWS_PER_BLOCK; i += THREADS / LANES) {
    const size_t r = r0 + i;
    if (r >= (size_t)n) break;
    out[r * LANES + c] =
        pe_out(accum3(inp + r * LANES, p0, p1, p2), phc, trgc, sc);
  }
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

__global__ void cast_bf16_kernel(const float* __restrict__ src,
                                 bf16* __restrict__ dst, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dst[i] = __float2bfloat16_rn(src[i]);
}

struct PeEpi {
  float* out;                   // the tile's first row
  const float *ph, *trg, *s;
  int rows;
  __device__ void operator()(int r, int c, float v) const {
    if (r < rows) out[(size_t)r * LANES + c] = pe_out(v, ph[c], trg[c], s[c]);
  }
};

template <typename T> constexpr size_t mm_smem() {
  return sizeof(T) * ((size_t)TILE_M * (LANES + Cfg<T>::PAD) +
                      2 * Cfg<T>::KS * (LANES + Cfg<T>::PAD));
}

// E = inp @ P on a 64-point tile: T = float, exact FMAs; T = bf16, inp
// rounded on the way into shared memory and P given already rounded
template <typename T>
__global__ void __launch_bounds__(THREADS)
pe_mm_kernel(const T* __restrict__ P, const float* __restrict__ ph,
             const float* __restrict__ trg, const float* __restrict__ s,
             const float* __restrict__ inp, float* __restrict__ out, int n) {
  constexpr int ALD = LANES + Cfg<T>::PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* a = reinterpret_cast<T*>(smem);
  T* slab = a + TILE_M * ALD;
  const size_t row0 = (size_t)blockIdx.x * TILE_M;
  const int rows = (size_t)n - row0 < TILE_M ? (int)(n - row0) : TILE_M;
  for (int e = threadIdx.x; e < TILE_M * LANES; e += THREADS) {
    const int r = e / LANES, c = e % LANES;
    a[r * ALD + c] = to_t<T>(r < rows ? inp[(row0 + r) * LANES + c] : 0.0f);
  }
  __syncthreads();
  gemm<T, LANES / 16>(a, ALD, LANES, P, slab,
                      PeEpi{out + row0 * LANES, ph, trg, s, rows});
}

template <typename T>
int launch_mm(const T* P, const float* const* r, const float* inp, float* out,
              int n, cudaStream_t stream) {
  constexpr size_t smem = mm_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      pe_mm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pe_mm_kernel<T><<<(n + TILE_M - 1) / TILE_M, THREADS, smem, stream>>>(
      P, r[1], r[2], r[3], inp, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant 0 pe_mm, 1 pe_vpu, 2 sin, 3 pe_mm_bf16, 4 pe_only.  ops: device
// pointers to f32 arrays in the Pallas kernel's operand order:
//   pe_mm, pe_vpu, pe_mm_bf16: P (128, 128), ph, trg, s (1, 128), inp
//   sin: x
//   pe_only: PxR (3, 128), phx, trgx, sx, PdR, phd, trgd, sd, ma, inp
// out: (n, 128) f32.  scratch: 128 x 128 bf16 for variant 3 (P rounded),
// unused otherwise.  Returns 0 or the cudaError_t of the launch.
int nerf_anatomy_pe(int variant, const void* const* ops, float* out, int n,
                    void* scratch, void* stream) {
  if (n < 0 || variant < 0 || variant > 4) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(ops);
  const int row_blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (variant == 0) return launch_mm<float>(f[0], f, f[4], out, n, st);
  if (variant == 1) {
    pe_vpu_kernel<<<row_blocks, THREADS, 0, st>>>(f[0], f[1], f[2], f[3], f[4],
                                                  out, n);
  } else if (variant == 2) {
    return launch_sin(f[0], out, (size_t)n * LANES, st);
  } else if (variant == 3) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    bf16* pb = static_cast<bf16*>(scratch);
    cast_bf16_kernel<<<LANES * LANES / THREADS, THREADS, 0, st>>>(
        f[0], pb, LANES * LANES);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_mm<bf16>(pb, f, f[4], out, n, st);
  } else {
    EncRows e = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
    pe_only_kernel<<<row_blocks, THREADS, 0, st>>>(e, f[9], out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
