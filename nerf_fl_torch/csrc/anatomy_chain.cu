// Anatomy probes, chain family, for Hopper (sm_90a): a bare chain of eight
// 256 x 256 layers, and the skip connection at layer 4 done two ways.
//
// Replaces the Pallas TPU kernels of experiments/kernel_anatomy.py:
//   chain8_kernel (:77)   8 x (h @ W + b in f32, ReLU, round to bf16); the
//                         first 128 columns out as f32: a trunk without
//                         encoders, heads or skip;
//   concat_kernel (:98)   the same chain, layer 4 as ONE product of the
//                         materialised 384-wide row [x[:, :128] | h] with w4;
//   split_kernel (:120)   the same, layer 4 as TWO products (x[:, :128] with
//                         w4[:128], h with w4[128:]) into one f32 accumulator,
//                         with no copy.
// (The TPU file runs chain8 under two grid semantics, "arbitrary" and
// "parallel"; a CUDA grid has no such switch.)
//
// What bounds them: 524,288 MACs a point (557,056 with the skip) against
// 1,024 bytes a point: operations, by a factor of ~3.5 on an H100.
//
// concat runs on the Hopper block of fused_mlp_common.cuh, as the fused
// forward does: persistent blocks of 128 points, two consumer warpgroups of
// 64 rows and a producer thread that streams the probe's weight image
// (ops/anatomy.py:chain_image: layers 0-3, w4c, layers 5-7, 34 slabs of 256
// image rows x 64 K-values) through an mbarrier ring with cp.async.bulk;
// wgmma m64n256k16 with both operands in shared memory, K-major, 128-byte
// swizzle; epilogues on the accumulator fragments.  In that layout
// [x[:, :128] | h] held contiguously would need no copy at all: the fused
// kernel's layer 4 is two segments over its P and H tiles, which is the
// split.  So the concat stays a real copy: at layer 4 each warpgroup copies
// its four h tiles (32 KB) behind the two x tiles of a separate 6-tile
// operand and contracts K = 384 in one segment from there.  That operand
// costs shared memory: 80 KB a warpgroup (h 4 tiles + concat 6), 160 KB for
// two, which leaves room for a ring of two 32 KB slabs, not the fused
// kernels' three; the biases (8 KB) stay in global memory and the epilogue
// reads them through the read-only path.  The ring depth and the shared
// bytes are what concat costs on this card, beside the copy.
//
// chain8 and split still run on the header's first block (gemm /
// load_slab, WMMA, 64-point tiles): h is overwritten in place by each layer,
// weights stream from L2 through the cp.async slab ring, two blocks an SM.
//
// Numerics, as the Pallas kernels (and unlike the fused kernels' hidden
// layers): relu(y + b) in f32 with the f32 bias, then one rounding to bf16.
#include "fused_mlp_common.cuh"

namespace {

enum { SKIP_NONE = 0, SKIP_CONCAT = 1, SKIP_SPLIT = 2 };

constexpr int X_W = 256;          // input row
constexpr int OUT_W = 128;        // output row: h[:, :128]

struct ChainOps {
  const bf16* w[8];
  const float* b[8];
  const bf16* w4;                 // (384, 256), the skip layer's weight
  const bf16* x;
};

// ----------------------------------------------------------------------
// chain8 and split: the header's first block, 64 points a block
// ----------------------------------------------------------------------
constexpr int PAD = Cfg<bf16>::PAD;
constexpr int KS = Cfg<bf16>::KS;
constexpr int HLD = W_TRUNK + PAD;
constexpr int XLD = W_HALF + PAD;
constexpr int SLD = W_TRUNK + PAD;

struct ReluRound {
  bf16* dst;
  int ld;
  const float* bias;
  __device__ void operator()(int r, int c, float v) const {
    dst[r * ld + c] = __float2bfloat16_rn(fmaxf(v + bias[c], 0.0f));
  }
};

// C (64 x 256) = A0 (64 x K0) @ W0 + A1 (64 x K1) @ W1: fused_mlp_common's
// bf16 gemm with its slab loop run once per source over ONE set of
// accumulator fragments, then the same epilogue.  Nothing is copied.
template <typename Epi>
__device__ void gemm_split(const bf16* A0, int lda0, int K0, const bf16* W0,
                           const bf16* A1, int lda1, int K1, const bf16* W1,
                           bf16* slab, Epi epi) {
  constexpr int NF = W_TRUNK / 16, NJ = NF / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = warp & 3, nj0 = warp >> 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int src = 0; src < 2; ++src) {
    const bf16* A = src ? A1 : A0;
    const bf16* W = src ? W1 : W0;
    const int lda = src ? lda1 : lda0, K = src ? K1 : K0;
    const int nslab = (K + KS - 1) / KS;
    load_slab<bf16, W_TRUNK>(slab, W, 0, min(KS, K));
    cp_async_commit();
    for (int s = 0; s < nslab; ++s) {
      const int k0 = s * KS;
      if (s + 1 < nslab)
        load_slab<bf16, W_TRUNK>(slab + ((s + 1) & 1) * KS * SLD, W, k0 + KS,
                                 min(KS, K - k0 - KS));
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* cur = slab + (s & 1) * KS * SLD;
      const int rows = min(KS, K - k0);
      for (int kk = 0; kk < rows; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + mi * 16 * lda + k0 + kk, lda);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, cur + kk * SLD + (nj0 + 2 * j) * 16, SLD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
  }
  float* scratch = reinterpret_cast<float*>(slab) + warp * 256;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      epi(mi * 16 + (e >> 4), (nj0 + 2 * j) * 16 + (e & 15), scratch[e]);
    __syncwarp();
  }
  __syncthreads();
}

template <int SKIP> constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((size_t)TILE_M * HLD + 2 * KS * SLD +
                         (SKIP == SKIP_SPLIT ? TILE_M * XLD : 0));
}

template <int SKIP>
__global__ void __launch_bounds__(THREADS, 2)
anatomy_chain_kernel(ChainOps o, float* __restrict__ out, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h = reinterpret_cast<bf16*>(smem);
  bf16* slab = h + TILE_M * HLD;
  bf16* xs = slab + 2 * KS * SLD;       // x[:, :128], kept for the skip

  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * TILE_M;

  for (int c = tid; c < TILE_M * (X_W / 8); c += THREADS) {
    const int r = c / (X_W / 8), q = c % (X_W / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < (size_t)n)
      v = *reinterpret_cast<const uint4*>(o.x + (row0 + r) * X_W + q * 8);
    *reinterpret_cast<uint4*>(h + r * HLD + q * 8) = v;
    if (SKIP == SKIP_SPLIT && q < W_HALF / 8)
      *reinterpret_cast<uint4*>(xs + r * XLD + q * 8) = v;
  }
  __syncthreads();

  for (int i = 0; i < 8; ++i) {
    const ReluRound epi{h, HLD, o.b[i]};
    if (i == 4 && SKIP == SKIP_SPLIT)
      gemm_split(xs, XLD, W_HALF, o.w4, h, HLD, W_TRUNK,
                 o.w4 + (size_t)W_HALF * W_TRUNK, slab, epi);
    else
      gemm<bf16, 16>(h, HLD, W_TRUNK, o.w[i], slab, epi);
  }

  for (int e = tid; e < TILE_M * OUT_W; e += THREADS) {
    const int r = e / OUT_W, c = e % OUT_W;
    if (row0 + r < (size_t)n)
      out[(row0 + r) * OUT_W + c] = __bfloat162float(h[r * HLD + c]);
  }
}

template <int SKIP>
int launch(const ChainOps& o, float* out, int n, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<SKIP>();
  cudaError_t err = cudaFuncSetAttribute(
      anatomy_chain_kernel<SKIP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int grid = (n + TILE_M - 1) / TILE_M;
  anatomy_chain_kernel<SKIP><<<grid, THREADS, smem, stream>>>(o, out, n);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------
// concat: the Hopper block, 128 points a block
// ----------------------------------------------------------------------
namespace cc {

using namespace hop;

constexpr int H_TILES = W_TRUNK / 64;         // h: tiles 0..3 of a warpgroup
constexpr int T_C = H_TILES;                  // [x[:, :128] | h]: tiles 4..9
constexpr int C_TILES = ACT_W / 64;
constexpr int WG_BYTES = (H_TILES + C_TILES) * TILE_BYTES;   // 80 KB
constexpr int CC_STAGES = 2;                  // weight slabs in flight
constexpr int CC_STAGE_BYTES = W_TRUNK * 128; // 32 KB: 256 image rows
constexpr int CC_SMEM = 1024 + CONSUMERS * WG_BYTES +
                        CC_STAGES * CC_STAGE_BYTES + 2 * CC_STAGES * 8;
static_assert(CC_SMEM <= 232448, "over the 227 KB a block can have");

// The image's walk: layers 0-3, w4c (384 input rows), layers 5-7, each cut
// into slabs of 64 input rows x 256 image rows (ops/anatomy.py:
// chain_image_plan is the same walk).  Returns the image's size in bytes.
inline int make_chain_plan(Plan& p) {
  p = Plan{};
  int at = 0;
  for (int l = 0; l < 8; ++l) plan_seg(p, at, l == 4 ? ACT_W : W_TRUNK, W_TRUNK);
  return at;
}

struct Biases {
  const float* b[8];              // (256,) f32 each, in global memory
};

// This warpgroup's 64 rows of x -> h (tiles 0..3) and x[:, :128] -> the
// first two tiles of the concat operand, 16 bytes a cp.async into the
// swizzled layout (a warp reads one 512-byte row); rows past n are zero.
__device__ __forceinline__ void load_rows(unsigned char* act,
                                          const bf16* __restrict__ x,
                                          size_t row0, int n, int t) {
  for (int i = t; i < WG_ROWS * (X_W / 8); i += 128) {
    const int r = i / (X_W / 8), c = 8 * (i % (X_W / 8));
    unsigned char* dst = act + act_off(0, r, c);
    unsigned char* cat = act + act_off(T_C, r, c);
    if (row0 + r < (size_t)n) {
      const bf16* src = x + (row0 + r) * X_W + c;
      cp_async16(dst, src);
      if (c < W_HALF) cp_async16(cat, src);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      if (c < W_HALF) *reinterpret_cast<uint4*>(cat) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(H_THREADS, 1)
concat_hopper_kernel(const bf16* __restrict__ x, float* __restrict__ out,
                     int n, const unsigned char* __restrict__ image,
                     const __grid_constant__ Plan plan,
                     const __grid_constant__ Biases bias) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles sit on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = smem + CONSUMERS * WG_BYTES;
  const uint32_t full = smem_u32(stages + CC_STAGES * CC_STAGE_BYTES);
  const uint32_t empty = full + 8 * CC_STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < CC_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_smem();
  }
  __syncthreads();

  const int wg = tid >> 7;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS * 128)
      produce<CC_STAGES>(image, plan, full, empty, smem_u32(stages),
                         CC_STAGE_BYTES, n_tiles);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = tid & 127;
  const int fr = 16 * (t >> 5) + ((t & 31) >> 2), fq = t & 3;
  const bool elected = t == 0;
  unsigned char* act = smem + wg * WG_BYTES;
  const uint32_t tile_h = smem_u32(act);
  const uint32_t tile_c = tile_h + T_C * TILE_BYTES;
  Ring ring = {full, empty, smem_u32(stages), CC_STAGE_BYTES, 0, 0, -1};
  float none[8];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * ROWS + wg * WG_ROWS;
    load_rows(act, x, row0, n, t);
    // the next tile's rows on their way into L2 meanwhile (an x row is 512
    // bytes, as a packed f32 input row of next_rows)
    next_rows(reinterpret_cast<const float*>(x),
              row0 + (size_t)gridDim.x * ROWS, n, X_W * 2, t);
    fence_async_smem();
    wg_sync(wg);

    float acc[W_TRUNK / 2];
    for (int i = 0; i < 8; ++i) {
      if (i == 4) {
        // the concat: h's four tiles behind x[:, :128], a real 32 KB copy.
        // Tiles sit on 1024 bytes and the swizzle is a function of the
        // row, so a tile's bytes copy as they are.
        const uint4* src = reinterpret_cast<const uint4*>(act);
        uint4* dst = reinterpret_cast<uint4*>(act + (T_C + 2) * TILE_BYTES);
#pragma unroll 4
        for (int e = t; e < H_TILES * TILE_BYTES / 16; e += 128)
          dst[e] = src[e];
        fence_async_smem();
        wg_sync(wg);
      }
      bool fresh = true;
      wgmma_fence();
      if (i == 4)
        mma_seg<W_TRUNK, false, CC_STAGES>(acc, none, tile_c, ACT_W, ring,
                                           fresh, elected);
      else
        mma_seg<W_TRUNK, false, CC_STAGES>(acc, none, tile_h, W_TRUNK, ring,
                                           fresh, elected);
      mma_end(ring, elected);
      fence_acc(acc);
      if (i == 7) break;
      store_acc<W_TRUNK, ReluRoundF, true>(acc, act, 0, bias.b[i], fr, fq,
                                           ReluRoundF{});
      fence_async_smem();
      wg_sync(wg);
    }
    // layer 7: h[:, :128] as f32 (the rounded values) from the fragments;
    // rows past n are not stored
#pragma unroll
    for (int j = 0; j < OUT_W / 8; ++j) {
      const float2 b =
          __ldg(reinterpret_cast<const float2*>(bias.b[7] + 8 * j + 2 * fq));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = row0 + fr + 8 * h;
        const uint32_t p = ReluRoundF{}(acc[4 * j + 2 * h],
                                        acc[4 * j + 2 * h + 1], b);
        if (row < (size_t)n)
          *reinterpret_cast<float2*>(out + row * OUT_W + 8 * j + 2 * fq) =
              make_float2(lo_f(p), hi_f(p));
      }
    }
  }
}

int launch(const ChainOps& o, float* out, int n, const void* image,
           cudaStream_t stream) {
  // cp.async and cp.async.bulk take 16-byte aligned global addresses, the
  // epilogue reads the biases as float2
  if (image == nullptr || (reinterpret_cast<uintptr_t>(image) & 15) ||
      (reinterpret_cast<uintptr_t>(o.x) & 15))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  make_chain_plan(plan);
  Biases bias;
  for (int i = 0; i < 8; ++i) {
    if (reinterpret_cast<uintptr_t>(o.b[i]) & 7)
      return (int)cudaErrorInvalidValue;
    bias.b[i] = o.b[i];
  }
  cudaError_t err = cudaFuncSetAttribute(
      concat_hopper_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CC_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  const int grid = n_tiles < sms ? n_tiles : sms;   // persistent blocks
  concat_hopper_kernel<<<grid, H_THREADS, CC_SMEM, stream>>>(
      o.x, out, n, static_cast<const unsigned char*>(image), plan, bias);
  return (int)cudaGetLastError();
}

}  // namespace cc

}  // namespace

extern "C" {

// skip 0 none, 1 concat, 2 split.  ops: device pointers in the Pallas
// kernel's operand order: w0 b0 .. w7 b7 [w4 with a skip] x.  out: (n, 128)
// f32.  scratch: for concat, its weight image (ops/anatomy.py:chain_image,
// the bytes of nerf_anatomy_concat_plan); unused otherwise (the probes'
// launchers share one signature).  Returns 0 or the cudaError_t of the
// launch.
int nerf_anatomy_chain(int skip, const void* const* ops, float* out, int n,
                       void* scratch, void* stream) {
  if (n < 0 || skip < SKIP_NONE || skip > SKIP_SPLIT)
    return (int)cudaErrorInvalidValue;
  ChainOps o = {};
  for (int i = 0; i < 8; ++i) {
    o.w[i] = static_cast<const bf16*>(ops[2 * i]);
    o.b[i] = static_cast<const float*>(ops[2 * i + 1]);
  }
  int at = 16;
  if (skip != SKIP_NONE) o.w4 = static_cast<const bf16*>(ops[at++]);
  o.x = static_cast<const bf16*>(ops[at]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (skip == SKIP_CONCAT) return cc::launch(o, out, n, scratch, s);
  if (skip == SKIP_SPLIT) return launch<SKIP_SPLIT>(o, out, n, s);
  return launch<SKIP_NONE>(o, out, n, s);
}

// The concat kernel's block and plan, for the wrapper and for reports:
// info[0] points a block, [1] threads, [2] shared-memory bytes, [3] slabs
// in the weight ring, [4] slabs in the plan, [5] the image's bytes, [6] bytes
// a ring slab; off / bytes (hop::MAX_SLABS each): every slab's byte offset
// and size.
void nerf_anatomy_concat_plan(int* info, int* off, int* bytes) {
  hop::Plan plan;
  const int image_bytes = cc::make_chain_plan(plan);
  info[0] = hop::ROWS;
  info[1] = hop::H_THREADS;
  info[2] = cc::CC_SMEM;
  info[3] = cc::CC_STAGES;
  info[4] = plan.n_slabs;
  info[5] = image_bytes;
  info[6] = cc::CC_STAGE_BYTES;
  for (int s = 0; s < plan.n_slabs && s < hop::MAX_SLABS; ++s) {
    off[s] = plan.off[s];
    bytes[s] = plan.bytes[s];
  }
}

}  // extern "C"
