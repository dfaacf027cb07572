// Anatomy probes, net family, for Hopper (sm_90a): the NeRF-W MLP without
// its encoders, from pre-encoded bf16 inputs.
//
// Replaces the Pallas TPU kernels of experiments/kernel_anatomy2.py:
//   static_kernel (:100)  trunk of 8 at the padded shapes (128/256/384 ->
//                         256, skip concat at layer 4), fs2 (256 -> 384,
//                         f32), dir layer (384 -> 128), rgb head (128 -> 128)
//                         plus fs2[:, 256:];
//   full_kernel (:130)    the same plus the transient branch (384 -> 128,
//                         3 x 128 -> 128, head 128 -> 128) summed in;
//   consol_kernel (:207)  static_kernel reading its six middle trunk weights
//                         as column blocks of one (256, 1536) operand and
//                         its trunk biases out of one (1, 2048) row.
// One template over (transient).  The consolidated variant launches the
// static instantiation on an image cut from its stacked operands, whose
// bytes equal the static image's (ops/anatomy.py:net_image), so the two
// agree bit for bit.
//
// What bounds it: 688,128 MACs a point (802,816 with the transient branch)
// against 1,024 bytes a point (1,280): operations, by a factor of ~4.5 on an
// H100.  The probe exists to be set beside the fused forward kernel, so it
// runs on that kernel's block (the Hopper block of fused_mlp_common.cuh):
// persistent blocks of 128 points, two consumer warpgroups of 64 rows and a
// producer thread that streams the probe's weight image (ops/anatomy.py:
// net_image_plan, the same walk as make_net_plan below) through a ring of
// three 32 KB slabs with cp.async.bulk; wgmma from shared memory, K-major,
// 128-byte swizzle; epilogues on the accumulator fragments with the biases
// staged once in shared memory.  What differs from the fused kernel is what
// the probe leaves out (the encoders: its inputs arrive encoded) and the
// padded widths its file fixes (fs2 384 wide, heads 128 wide).
//
// fs2 is 384 wide, over wgmma's N of 256, and its f32 tail (columns
// 256..383) must wait in registers until the heads add into it.  So fs2 runs
// as three N = 128 products over h: the tail into the output fragments
// (out, 64 floats a thread, live to the end of the tile), then xf[:, :128]
// into the P tiles (pe is dead after layer 4), then xf[:, 128:] into H tiles
// 2-3 (h is dead after the third product).  dt then goes into H tiles 0-1,
// the dir layer contracts P, H2-3 and H0-1 and leaves hd in H0-1; the
// transient branch does the same with tt.  At most out[64] + acc[64] are
// live past the trunk, and nothing goes through global memory but the
// inputs, the weight slabs and the output.
//
// Numerics, as the Pallas kernels' dense (the fused kernel's own rounding):
// hidden layers round the f32 product to bf16, add the bias rounded to bf16,
// round, ReLU (HiddenF); fs2 and the heads add their f32 bias in f32; xf is
// fs2[:, :256] plus its bias rounded once (LinearF); the output is
// (hd @ wr + br) + fs2[:, 256:], then + (th @ wth + bth).
#include "fused_mlp_common.cuh"

namespace {
namespace net {

using namespace hop;

constexpr int NET_W = 128;                 // pe / dt / tt row, output row
constexpr int FS_W = W_TRUNK + NET_W;      // fs2 = [xf 0:256 | tail 256:384]
constexpr int T_X2 = T_H + 2;              // xf[:, 128:256]: H tiles 2-3
constexpr int NET_STAGE_BYTES = W_TRUNK * 128;   // 32 KB: 256 image rows

// output width of layer l (trunk 0..7, fs2, dir, rgb, t0..t3, t head: the
// header's L_* indices), and where its bias sits in shared memory
__host__ __device__ constexpr int net_n(int l) {
  return l < L_FS ? W_TRUNK : l == L_FS ? FS_W : W_HALF;
}
__host__ __device__ constexpr int net_bias_off(int l) {
  int at = 0;
  for (int i = 0; i < l; ++i) at += net_n(i);
  return at;
}
constexpr int NET_BIAS = net_bias_off(N_LAYERS);   // 3,328 floats
constexpr int NET_SMEM = 1024 + CONSUMERS * ACT_BYTES +
                         STAGES * NET_STAGE_BYTES + NET_BIAS * 4 +
                         2 * STAGES * 8;
static_assert(NET_SMEM <= 232448, "over the 227 KB a block can have");

// The image's walk: every layer cut into slabs of 64 contraction rows, in
// the order the kernel consumes them (a layer over [pe | h] or [xf | dt]
// reads its sources in its weight's row order).  Returns the image's size
// in bytes.
inline int make_net_plan(Plan& p, int transient) {
  p = Plan{};
  int at = 0;
  for (int l = 0; l < 8; ++l)
    plan_seg(p, at, l == 0 ? NET_W : l == 4 ? ACT_W : W_TRUNK, W_TRUNK);
  for (int s = 0; s < 3; ++s) plan_seg(p, at, W_TRUNK, W_HALF);   // fs2
  plan_seg(p, at, ACT_W, W_HALF);                                 // dir
  plan_seg(p, at, W_HALF, W_HALF);                                // rgb
  if (transient) {
    plan_seg(p, at, ACT_W, W_HALF);                               // t0
    for (int l = 0; l < 4; ++l) plan_seg(p, at, W_HALF, W_HALF);  // t1..t3, head
  }
  return at;
}

struct Biases {
  const float* b[N_LAYERS];      // f32, in global memory; L_* order
};

// This warpgroup's 64 rows of an (n, 128) bf16 input into the two tiles at
// tile0, 16 bytes a cp.async into the swizzled layout; rows past n are
// zero.  Each warp loads its own 16 rows (half a warp reads one 256-byte
// row), the rows its epilogues write and its part of a product reads, so a
// tile that the warpgroup's last product read can be refilled without a
// barrier, as the epilogues overwrite their input in place.
__device__ __forceinline__ void load_rows(unsigned char* act, int tile0,
                                          const bf16* __restrict__ src,
                                          size_t row0, int n, int t) {
  const int lane = t & 31, c = 8 * (lane & 15);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = 16 * (t >> 5) + 2 * k + (lane >> 4);
    unsigned char* dst = act + act_off(tile0, r, c);
    if (row0 + r < (size_t)n)
      cp_async16(dst, src + (row0 + r) * NET_W + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// Asks L2 for this warpgroup's 64 rows of an (n, 128) bf16 input (two
// threads a row, one 128-byte line each), so that load_rows finds them there.
__device__ __forceinline__ void prefetch_rows(const bf16* src, size_t row0,
                                              int n, int t) {
  const size_t row = row0 + (t >> 1);
  if (row < (size_t)n)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src + row * NET_W +
                                                     64 * (t & 1)));
}

// A 128-wide product over SRCS sources of `rows` contraction columns each
// (operand tiles at shared addresses src[..]), into acc
template <int SRCS>
__device__ __forceinline__ void product128(float (&acc)[W_HALF / 2],
                                           const uint32_t (&src)[SRCS],
                                           int rows, Ring& ring,
                                           bool elected) {
  float none[8];
  bool fresh = true;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < SRCS; ++s)
    mma_seg<W_HALF, false>(acc, none, src[s], rows, ring, fresh, elected);
  mma_end(ring, elected);
  fence_acc(acc);
}

// A 128-wide hidden layer's epilogue: HiddenF into H0-1, made visible to
// the next layer's products
__device__ __forceinline__ void store_hidden(const float (&acc)[W_HALF / 2],
                                             unsigned char* act,
                                             const float* bias, int r, int q,
                                             int wg) {
  store_acc<W_HALF>(acc, act, T_H, bias, r, q, HiddenF{});
  fence_async_smem();
  wg_sync(wg);
}

// A head's f32 sums into the output fragments: out = acc + bias, or with
// ADD out = (acc + bias) + out
template <bool ADD>
__device__ __forceinline__ void head_out(float (&out)[NET_W / 2],
                                         const float (&acc)[NET_W / 2],
                                         const float* bias, int q) {
#pragma unroll
  for (int j = 0; j < NET_W / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float y0 = acc[4 * j + 2 * h] + b.x;
      const float y1 = acc[4 * j + 2 * h + 1] + b.y;
      out[4 * j + 2 * h] = ADD ? y0 + out[4 * j + 2 * h] : y0;
      out[4 * j + 2 * h + 1] = ADD ? y1 + out[4 * j + 2 * h + 1] : y1;
    }
  }
}

template <bool TRANSIENT>
__global__ void __launch_bounds__(H_THREADS, 1)
net_hopper_kernel(const bf16* __restrict__ pe, const bf16* __restrict__ dt,
                  const bf16* __restrict__ tt, float* __restrict__ out,
                  int n, const unsigned char* __restrict__ image,
                  const __grid_constant__ Plan plan,
                  const __grid_constant__ Biases bias) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles sit on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = smem + CONSUMERS * ACT_BYTES;
  float* bias_s = reinterpret_cast<float*>(stages + STAGES * NET_STAGE_BYTES);
  const uint32_t full = smem_u32(bias_s + NET_BIAS);
  const uint32_t empty = full + 8 * STAGES;

  const int tid = threadIdx.x;
  // biases to shared memory once; hidden layers add theirs rounded
  for (int l = 0; l < (TRANSIENT ? N_LAYERS : L_T0); ++l) {
    const bool f32_bias = l == L_FS || l == L_RGB || l == L_TH;
    float* dst = bias_s + net_bias_off(l);
    for (int c = tid; c < net_n(l); c += H_THREADS) {
      const float v = bias.b[l][c];
      dst[c] = f32_bias ? v : to_f(__float2bfloat16_rn(v));
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
      produce(image, plan, full, empty, smem_u32(stages), NET_STAGE_BYTES,
              n_tiles);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = tid & 127;
  const int fr = 16 * (t >> 5) + ((t & 31) >> 2), fq = t & 3;
  const bool elected = t == 0;
  unsigned char* act = smem + wg * ACT_BYTES;
  const uint32_t tile_p = smem_u32(act) + T_P * TILE_BYTES;
  const uint32_t tile_h = smem_u32(act) + T_H * TILE_BYTES;
  const uint32_t tile_x2 = smem_u32(act) + T_X2 * TILE_BYTES;
  const float* bfs = bias_s + net_bias_off(L_FS);
  Ring ring = {full, empty, smem_u32(stages), NET_STAGE_BYTES, 0, 0, -1};
  float none[8];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * ROWS + wg * WG_ROWS;
    load_rows(act, T_P, pe, row0, n, t);
    // this tile's dt / tt and the next tile's pe on their way into L2
    prefetch_rows(dt, row0, n, t);
    if (TRANSIENT) prefetch_rows(tt, row0, n, t);
    prefetch_rows(pe, row0 + (size_t)gridDim.x * ROWS, n, t);
    fence_async_smem();
    wg_sync(wg);

    {
      // trunk: every layer overwrites H in place once its products are done
      float acc[W_TRUNK / 2];
      for (int i = 0; i < 8; ++i) {
        bool fresh = true;
        wgmma_fence();
        if (i == 0 || i == 4)
          mma_seg<W_TRUNK, false>(acc, none, tile_p, NET_W, ring, fresh,
                                  elected);
        if (i != 0)
          mma_seg<W_TRUNK, false>(acc, none, tile_h, W_TRUNK, ring, fresh,
                                  elected);
        mma_end(ring, elected);
        fence_acc(acc);
        store_acc<W_TRUNK>(acc, act, T_H, bias_s + net_bias_off(i), fr, fq,
                           HiddenF{});
        fence_async_smem();
        wg_sync(wg);
      }
    }
    // fs2 as three products over h: the f32 tail into the output
    // fragments, xf[:, :128] into P, xf[:, 128:] into H2-3
    const uint32_t h_src[1] = {tile_h}, xf_src[3] = {tile_p, tile_x2, tile_h};
    float o[NET_W / 2], acc[W_HALF / 2];
    product128(acc, h_src, W_TRUNK, ring, elected);
    head_out<false>(o, acc, bfs + W_TRUNK, fq);
    product128(acc, h_src, W_TRUNK, ring, elected);
    store_acc<W_HALF>(acc, act, T_P, bfs, fr, fq, LinearF{});
    product128(acc, h_src, W_TRUNK, ring, elected);
    store_acc<W_HALF>(acc, act, T_X2, bfs + W_HALF, fr, fq, LinearF{});
    // dt -> H0-1 (h is dead), then the dir layer over [xf | dt] -> H0-1
    load_rows(act, T_H, dt, row0, n, t);
    fence_async_smem();
    wg_sync(wg);
    product128(acc, xf_src, W_HALF, ring, elected);
    store_hidden(acc, act, bias_s + net_bias_off(L_DIR), fr, fq, wg);
    // rgb head: out = (hd @ wr + br) + fs2[:, 256:]
    product128(acc, h_src, W_HALF, ring, elected);
    head_out<true>(o, acc, bias_s + net_bias_off(L_RGB), fq);

    if (TRANSIENT) {
      // tt -> H0-1 (the rgb head has finished reading hd), then t0 over
      // [xf | tt], t1..t3 in place, and out += th @ wth + bth
      load_rows(act, T_H, tt, row0, n, t);
      fence_async_smem();
      wg_sync(wg);
      product128(acc, xf_src, W_HALF, ring, elected);
      store_hidden(acc, act, bias_s + net_bias_off(L_T0), fr, fq, wg);
      for (int l = L_T0 + 1; l < L_TH; ++l) {
        product128(acc, h_src, W_HALF, ring, elected);
        store_hidden(acc, act, bias_s + net_bias_off(l), fr, fq, wg);
      }
      product128(acc, h_src, W_HALF, ring, elected);
      head_out<true>(o, acc, bias_s + net_bias_off(L_TH), fq);
    }
    // rows past n are not stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = row0 + fr + 8 * h;
      if (row < (size_t)n) {
#pragma unroll
        for (int j = 0; j < NET_W / 8; ++j)
          *reinterpret_cast<float2*>(out + row * NET_W + 8 * j + 2 * fq) =
              make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <bool TRANSIENT>
int launch(const bf16* pe, const bf16* dt, const bf16* tt, float* out, int n,
           const void* image, const Biases& bias, cudaStream_t stream) {
  // cp.async and cp.async.bulk take 16-byte aligned global addresses (an
  // empty input's is null)
  const void* ptrs[4] = {image, pe, dt, TRANSIENT ? tt : pe};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  if (image == nullptr) return (int)cudaErrorInvalidValue;
  Plan plan;
  make_net_plan(plan, TRANSIENT);
  cudaError_t err = cudaFuncSetAttribute(
      net_hopper_kernel<TRANSIENT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, NET_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  const int grid = n_tiles < sms ? n_tiles : sms;   // persistent blocks
  net_hopper_kernel<TRANSIENT><<<grid, H_THREADS, NET_SMEM, stream>>>(
      pe, dt, tt, out, n, static_cast<const unsigned char*>(image), plan,
      bias);
  return (int)cudaGetLastError();
}

}  // namespace net
}  // namespace

extern "C" {

// variant 0 static, 1 full, 2 consolidated.  ops: device pointers in the
// Pallas kernel's operand order:
//   static: w0 b0 .. w7 b7 wfs bfs wd bd wr br pe dt               (24)
//   full:   .. br wt0 bt0 wtm0 wtm1 wtm2 btm0 btm1 btm2 wth bth pe dt tt (35)
//   consol: w0 w_mid w_skip b_all wfs bfs wd bd wr br pe dt        (12)
// The weights are read from scratch, the probe's weight image
// (ops/anatomy.py:net_image, the bytes of nerf_anatomy_net_plan), not from
// ops.  out: (n, 128) f32.  Returns 0 or the cudaError_t of the launch.
int nerf_anatomy_net(int variant, const void* const* ops, float* out, int n,
                     void* scratch, void* stream) {
  if (n < 0 || variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  auto B = [&](int i) { return static_cast<const float*>(ops[i]); };
  auto X = [&](int i) { return static_cast<const bf16*>(ops[i]); };
  net::Biases bias = {};
  int at;
  if (variant == 2) {
    for (int i = 0; i < 8; ++i) bias.b[i] = B(3) + W_TRUNK * i;
    at = 4;
  } else {
    for (int i = 0; i < 8; ++i) bias.b[i] = B(2 * i + 1);
    at = 16;
  }
  bias.b[L_FS] = B(at + 1);
  bias.b[L_DIR] = B(at + 3);
  bias.b[L_RGB] = B(at + 5);
  at += 6;
  if (variant == 1) {
    bias.b[L_T0] = B(at + 1);
    for (int k = 0; k < 3; ++k) bias.b[L_T0 + 1 + k] = B(at + 5 + k);
    bias.b[L_TH] = B(at + 9);
    at += 10;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return net::launch<true>(X(at), X(at + 1), X(at + 2), out, n, scratch,
                             bias, s);
  return net::launch<false>(X(at), X(at + 1), nullptr, out, n, scratch, bias,
                            s);
}

// The net kernel's block and plan, for the wrapper and for reports:
// info[0] points a block, [1] threads, [2] shared-memory bytes, [3] slabs
// in the weight ring, [4] slabs in the plan, [5] the image's bytes, [6] bytes
// a ring slab; off / bytes (hop::MAX_SLABS each): every slab's byte offset
// and size.
void nerf_anatomy_net_plan(int transient, int* info, int* off, int* bytes) {
  hop::Plan plan;
  const int image_bytes = net::make_net_plan(plan, transient);
  info[0] = hop::ROWS;
  info[1] = hop::H_THREADS;
  info[2] = net::NET_SMEM;
  info[3] = hop::STAGES;
  info[4] = plan.n_slabs;
  info[5] = image_bytes;
  info[6] = net::NET_STAGE_BYTES;
  for (int s = 0; s < plan.n_slabs && s < hop::MAX_SLABS; ++s) {
    off[s] = plan.off[s];
    bytes[s] = plan.bytes[s];
  }
}

}  // extern "C"
