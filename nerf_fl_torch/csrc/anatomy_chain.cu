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
// All three run on the Hopper block of fused_mlp_common.cuh, as the fused
// kernels do, as one template over the skip: persistent blocks of 128
// points, two consumer warpgroups of 64 rows and a producer thread that
// streams the probe's weight image (ops/anatomy.py:chain_image / chain8_image:
// the layers in consumption order, 32 KB slabs of 256 image rows x 64
// K-values) through an mbarrier ring with cp.async.bulk; wgmma m64n256k16
// with both operands in shared memory, K-major, 128-byte swizzle; epilogues
// on the accumulator fragments, biases read through the read-only path.
// Each warpgroup holds h in operand tiles 0..3 and overwrites it in place
// after each layer's products have completed.
//
// The skip at layer 4.  split keeps x[:, :128] in tiles 4..5 and contracts
// two segments into one accumulator, x's (K = 128) then h's (K = 256), as the
// fused forward's layer 4 runs over its P and H tiles: that order is the
// rows of w4c, so split streams exactly concat's image.  Held contiguously
// in the swizzled layout, [x[:, :128] | h] needs no copy at all, so concat's
// copy is a real one: at layer 4 each warpgroup copies its four h tiles
// (32 KB) behind the two x tiles of a separate 6-tile operand (tiles 4..9)
// and contracts K = 384 in one segment from there.
//
// The ring depth is a template parameter, and what the operand tiles leave
// of the 227 KB sets it: concat holds 10 tiles a warpgroup (80 KB) and a
// ring of two slabs; split 6 tiles (48 KB, the fused kernels' operand
// bytes) and chain8 4 (32 KB), each with the depth it ships with below.
//
// Numerics, as the Pallas kernels (and unlike the fused kernels' hidden
// layers): relu(y + b) in f32 with the f32 bias, then one rounding to bf16.
// Layer 7 computes all 256 columns, as the Pallas kernels do; its first 128
// go out as f32.
#include "fused_mlp_common.cuh"

namespace {

enum { SKIP_NONE = 0, SKIP_CONCAT = 1, SKIP_SPLIT = 2 };

constexpr int X_W = 256;          // input row
constexpr int OUT_W = 128;        // output row: h[:, :128]

struct ChainOps {                 // the weights come as the image
  const float* b[8];
  const bf16* x;
};

namespace cc {

using namespace hop;

constexpr int H_TILES = W_TRUNK / 64;         // h: tiles 0..3 of a warpgroup
constexpr int T_X = H_TILES;                  // x[:, :128] (split), or
                                              // [x[:, :128] | h] (concat)
constexpr int CC_STAGES = 2;                  // weight slabs in flight: concat
constexpr int CHAIN8_STAGES = 3;              //   chain8
constexpr int SPLIT_STAGES = 3;               //   split
constexpr int STAGE_BYTES_C = W_TRUNK * 128;  // 32 KB: 256 image rows

// operand tiles a warpgroup holds, the ring depth each probe ships with,
// and the shared memory of a block
__host__ __device__ constexpr int wg_tiles(int skip) {
  return H_TILES + (skip == SKIP_CONCAT ? ACT_W / 64
                    : skip == SKIP_SPLIT ? W_HALF / 64 : 0);
}
__host__ __device__ constexpr int ring_depth(int skip) {
  return skip == SKIP_CONCAT ? CC_STAGES
         : skip == SKIP_SPLIT ? SPLIT_STAGES : CHAIN8_STAGES;
}
__host__ __device__ constexpr int smem_bytes(int skip, int nst) {
  return 1024 + CONSUMERS * wg_tiles(skip) * TILE_BYTES +
         nst * STAGE_BYTES_C + 2 * nst * 8;
}
static_assert(smem_bytes(SKIP_NONE, CHAIN8_STAGES) <= 232448 &&
                  smem_bytes(SKIP_CONCAT, CC_STAGES) <= 232448 &&
                  smem_bytes(SKIP_SPLIT, SPLIT_STAGES) <= 232448,
              "over the 227 KB a block can have");

// The image's walk: layers 0-3, layer 4 (w4c's 384 input rows with a skip,
// ws[4]'s 256 without), layers 5-7, each cut into slabs of 64 input rows x
// 256 image rows (ops/anatomy.py:chain_image_plan is the same walk).
// Returns the image's size in bytes.
inline int make_chain_plan(Plan& p, int skip) {
  p = Plan{};
  int at = 0;
  for (int l = 0; l < 8; ++l)
    plan_seg(p, at, l == 4 && skip != SKIP_NONE ? ACT_W : W_TRUNK, W_TRUNK);
  return at;
}

struct Biases {
  const float* b[8];              // (256,) f32 each, in global memory
};

// This warpgroup's 64 rows of x -> h (tiles 0..3) and, with KEEP_X,
// x[:, :128] -> tiles T_X..T_X+1, 16 bytes a cp.async into the swizzled
// layout (a warp reads one 512-byte row); rows past n are zero.
template <bool KEEP_X>
__device__ __forceinline__ void load_rows(unsigned char* act,
                                          const bf16* __restrict__ x,
                                          size_t row0, int n, int t) {
  for (int i = t; i < WG_ROWS * (X_W / 8); i += 128) {
    const int r = i / (X_W / 8), c = 8 * (i % (X_W / 8));
    unsigned char* dst = act + act_off(0, r, c);
    unsigned char* keep = act + act_off(T_X, r, c);
    if (row0 + r < (size_t)n) {
      const bf16* src = x + (row0 + r) * X_W + c;
      cp_async16(dst, src);
      if (KEEP_X && c < W_HALF) cp_async16(keep, src);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      if (KEEP_X && c < W_HALF)
        *reinterpret_cast<uint4*>(keep) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

template <int SKIP, int NST>
__global__ void __launch_bounds__(H_THREADS, 1)
chain_hopper_kernel(const bf16* __restrict__ x, float* __restrict__ out,
                    int n, const unsigned char* __restrict__ image,
                    const __grid_constant__ Plan plan,
                    const __grid_constant__ Biases bias) {
  constexpr int WG_BYTES = wg_tiles(SKIP) * TILE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles sit on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = smem + CONSUMERS * WG_BYTES;
  const uint32_t full = smem_u32(stages + NST * STAGE_BYTES_C);
  const uint32_t empty = full + 8 * NST;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
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
      produce<NST>(image, plan, full, empty, smem_u32(stages), STAGE_BYTES_C,
                   n_tiles);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = tid & 127;
  const int fr = 16 * (t >> 5) + ((t & 31) >> 2), fq = t & 3;
  const bool elected = t == 0;
  unsigned char* act = smem + wg * WG_BYTES;
  const uint32_t tile_h = smem_u32(act);
  const uint32_t tile_x = tile_h + T_X * TILE_BYTES;
  Ring ring = {full, empty, smem_u32(stages), STAGE_BYTES_C, 0, 0, -1};
  float none[8];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * ROWS + wg * WG_ROWS;
    load_rows<SKIP != SKIP_NONE>(act, x, row0, n, t);
    // the next tile's rows on their way into L2 meanwhile (an x row is 512
    // bytes, as a packed f32 input row of next_rows)
    next_rows(reinterpret_cast<const float*>(x),
              row0 + (size_t)gridDim.x * ROWS, n, X_W * 2, t);
    fence_async_smem();
    wg_sync(wg);

    float acc[W_TRUNK / 2];
    for (int i = 0; i < 8; ++i) {
      if (SKIP == SKIP_CONCAT && i == 4) {
        // the concat: h's four tiles behind x[:, :128], a real 32 KB copy.
        // Tiles sit on 1024 bytes and the swizzle is a function of the
        // row, so a tile's bytes copy as they are.
        const uint4* src = reinterpret_cast<const uint4*>(act);
        uint4* dst = reinterpret_cast<uint4*>(act + (T_X + 2) * TILE_BYTES);
#pragma unroll 4
        for (int e = t; e < H_TILES * TILE_BYTES / 16; e += 128)
          dst[e] = src[e];
        fence_async_smem();
        wg_sync(wg);
      }
      bool fresh = true;
      wgmma_fence();
      if (SKIP == SKIP_CONCAT && i == 4) {
        mma_seg<W_TRUNK, false, NST>(acc, none, tile_x, ACT_W, ring, fresh,
                                     elected);
      } else {
        // split: x's two slabs, then h's four, into one accumulator; the
        // ring releases x's last slab once h's first products are issued
        if (SKIP == SKIP_SPLIT && i == 4)
          mma_seg<W_TRUNK, false, NST>(acc, none, tile_x, W_HALF, ring, fresh,
                                       elected);
        mma_seg<W_TRUNK, false, NST>(acc, none, tile_h, W_TRUNK, ring, fresh,
                                     elected);
      }
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

template <int SKIP>
int launch(const ChainOps& o, float* out, int n, const void* image,
           cudaStream_t stream) {
  constexpr int NST = ring_depth(SKIP);
  constexpr int SMEM = smem_bytes(SKIP, NST);
  // cp.async and cp.async.bulk take 16-byte aligned global addresses, the
  // epilogue reads the biases as float2
  if (image == nullptr || (reinterpret_cast<uintptr_t>(image) & 15) ||
      (reinterpret_cast<uintptr_t>(o.x) & 15))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  make_chain_plan(plan, SKIP);
  Biases bias;
  for (int i = 0; i < 8; ++i) {
    if (reinterpret_cast<uintptr_t>(o.b[i]) & 7)
      return (int)cudaErrorInvalidValue;
    bias.b[i] = o.b[i];
  }
  cudaError_t err = cudaFuncSetAttribute(
      chain_hopper_kernel<SKIP, NST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  const int grid = n_tiles < sms ? n_tiles : sms;   // persistent blocks
  chain_hopper_kernel<SKIP, NST><<<grid, H_THREADS, SMEM, stream>>>(
      o.x, out, n, static_cast<const unsigned char*>(image), plan, bias);
  return (int)cudaGetLastError();
}

}  // namespace cc

}  // namespace

extern "C" {

// skip 0 none (chain8), 1 concat, 2 split.  ops: device pointers in the
// Pallas kernel's operand order: w0 b0 .. w7 b7 [w4 with a skip] x.  out:
// (n, 128) f32.  scratch: the probe's weight image (ops/anatomy.py:
// chain8_image without a skip, chain_image with one: the bytes of
// nerf_anatomy_chain_plan), which the kernel streams in place of the w
// operands.  Returns 0 or the cudaError_t of the launch.
int nerf_anatomy_chain(int skip, const void* const* ops, float* out, int n,
                       void* scratch, void* stream) {
  if (n < 0 || skip < SKIP_NONE || skip > SKIP_SPLIT)
    return (int)cudaErrorInvalidValue;
  ChainOps o = {};
  for (int i = 0; i < 8; ++i)
    o.b[i] = static_cast<const float*>(ops[2 * i + 1]);
  o.x = static_cast<const bf16*>(ops[skip == SKIP_NONE ? 16 : 17]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (skip == SKIP_CONCAT)
    return cc::launch<SKIP_CONCAT>(o, out, n, scratch, s);
  if (skip == SKIP_SPLIT) return cc::launch<SKIP_SPLIT>(o, out, n, scratch, s);
  return cc::launch<SKIP_NONE>(o, out, n, scratch, s);
}

// A chain kernel's block and plan, for the wrapper and for reports:
// info[0] points a block, [1] threads, [2] shared-memory bytes, [3] slabs
// in the weight ring, [4] slabs in the plan, [5] the image's bytes, [6]
// bytes a ring slab; off / bytes (hop::MAX_SLABS each): every slab's byte
// offset and size.
void nerf_anatomy_chain_plan(int skip, int* info, int* off, int* bytes) {
  hop::Plan plan;
  const int image_bytes = cc::make_chain_plan(plan, skip);
  info[0] = hop::ROWS;
  info[1] = hop::H_THREADS;
  info[2] = cc::smem_bytes(skip, cc::ring_depth(skip));
  info[3] = cc::ring_depth(skip);
  info[4] = plan.n_slabs;
  info[5] = image_bytes;
  info[6] = cc::STAGE_BYTES_C;
  for (int s = 0; s < plan.n_slabs && s < hop::MAX_SLABS; ++s) {
    off[s] = plan.off[s];
    bytes[s] = plan.bytes[s];
  }
}

}  // extern "C"
