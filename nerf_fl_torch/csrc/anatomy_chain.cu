// Anatomy probes, chain family, for Hopper (sm_90a): a bare chain of eight
// 256 x 256 layers, and the skip connection at layer 4 done two ways.
//
// Replaces the Pallas TPU kernels of experiments/kernel_anatomy.py:
//   chain8_kernel (:77)   8 x (h @ W + b in f32, ReLU, round to bf16); the
//                         first 128 columns out as f32.  This is the ceiling
//                         of the gemm / load_slab blocks the fused kernels
//                         are built from: no encoders, no heads, no skip;
//   concat_kernel (:98)   the same chain, layer 4 as ONE product of the
//                         materialised 384-wide row [x[:, :128] | h] with w4;
//   split_kernel (:120)   the same, layer 4 as TWO products (x[:, :128] with
//                         w4[:128], h with w4[128:]) into one f32 accumulator,
//                         with no copy.
// One template over the skip.  (The TPU file runs chain8 under two grid
// semantics, "arbitrary" and "parallel"; a CUDA grid has no such switch.)
//
// What bounds it: 524,288 MACs a point (557,056 with the skip) against 1,024
// bytes a point: operations, by a factor of ~3.5 on an H100.  Built from the
// fused kernels' own blocks on their 64-point tile: h is overwritten in place
// by each layer (gemm's accumulators stay in registers until every warp has
// read its input), weights stream from L2 through the cp.async slab ring.
// The chain and the split variant fit two blocks on an SM; the concat variant
// pays for its 384-wide copy with 50 KB more shared memory and runs one.
//
// Numerics, as the Pallas kernels (and unlike the fused kernels' hidden
// layers): relu(y + b) in f32, then one rounding to bf16.
#include "fused_mlp_common.cuh"

namespace {

enum { SKIP_NONE = 0, SKIP_CONCAT = 1, SKIP_SPLIT = 2 };

constexpr int X_W = 256;          // input row
constexpr int OUT_W = 128;        // output row: h[:, :128]
constexpr int PAD = Cfg<bf16>::PAD;
constexpr int KS = Cfg<bf16>::KS;
constexpr int HLD = W_TRUNK + PAD;
constexpr int XLD = W_HALF + PAD;
constexpr int CLD = ACT_W + PAD;
constexpr int SLD = W_TRUNK + PAD;

struct ChainOps {
  const bf16* w[8];
  const float* b[8];
  const bf16* w4;                 // (384, 256), the skip layer's weight
  const bf16* x;
};

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

// `cols` bf16 columns (a multiple of 8) of 64 rows, shared to shared
__device__ __forceinline__ void copy_cols(bf16* dst, int ldd, const bf16* src,
                                          int lds, int cols) {
  const int cpr = cols / 8;
  for (int c = threadIdx.x; c < TILE_M * cpr; c += THREADS) {
    const int r = c / cpr, q = c % cpr;
    *reinterpret_cast<uint4*>(dst + r * ldd + q * 8) =
        *reinterpret_cast<const uint4*>(src + r * lds + q * 8);
  }
}

template <int SKIP> constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((size_t)TILE_M * HLD + 2 * KS * SLD +
                         (SKIP != SKIP_NONE ? TILE_M * XLD : 0) +
                         (SKIP == SKIP_CONCAT ? TILE_M * CLD : 0));
}

template <int SKIP>
__global__ void __launch_bounds__(THREADS, SKIP == SKIP_CONCAT ? 1 : 2)
anatomy_chain_kernel(ChainOps o, float* __restrict__ out, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h = reinterpret_cast<bf16*>(smem);
  bf16* slab = h + TILE_M * HLD;
  bf16* xs = slab + 2 * KS * SLD;       // x[:, :128], kept for the skip
  bf16* cat = xs + TILE_M * XLD;        // [x[:, :128] | h], concat only

  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * TILE_M;

  for (int c = tid; c < TILE_M * (X_W / 8); c += THREADS) {
    const int r = c / (X_W / 8), q = c % (X_W / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < (size_t)n)
      v = *reinterpret_cast<const uint4*>(o.x + (row0 + r) * X_W + q * 8);
    *reinterpret_cast<uint4*>(h + r * HLD + q * 8) = v;
    if (SKIP != SKIP_NONE && q < W_HALF / 8)
      *reinterpret_cast<uint4*>(xs + r * XLD + q * 8) = v;
  }
  __syncthreads();

  for (int i = 0; i < 8; ++i) {
    const ReluRound epi{h, HLD, o.b[i]};
    if (i == 4 && SKIP == SKIP_CONCAT) {
      copy_cols(cat, CLD, xs, XLD, W_HALF);
      copy_cols(cat + W_HALF, CLD, h, HLD, W_TRUNK);
      __syncthreads();
      gemm<bf16, 16>(cat, CLD, W_HALF + W_TRUNK, o.w4, slab, epi);
    } else if (i == 4 && SKIP == SKIP_SPLIT) {
      gemm_split(xs, XLD, W_HALF, o.w4, h, HLD, W_TRUNK,
                 o.w4 + (size_t)W_HALF * W_TRUNK, slab, epi);
    } else {
      gemm<bf16, 16>(h, HLD, W_TRUNK, o.w[i], slab, epi);
    }
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

}  // namespace

extern "C" {

// skip 0 none, 1 concat, 2 split.  ops: device pointers in the Pallas
// kernel's operand order: w0 b0 .. w7 b7 [w4 with a skip] x.  out: (n, 128)
// f32.  scratch is unused (the probes' launchers share one signature).
// Returns 0 or the cudaError_t of the launch.
int nerf_anatomy_chain(int skip, const void* const* ops, float* out, int n,
                       void* /*scratch*/, void* stream) {
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
  if (skip == SKIP_CONCAT) return launch<SKIP_CONCAT>(o, out, n, s);
  if (skip == SKIP_SPLIT) return launch<SKIP_SPLIT>(o, out, n, s);
  return launch<SKIP_NONE>(o, out, n, s);
}

}  // extern "C"
