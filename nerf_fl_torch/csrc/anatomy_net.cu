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
// One template over (transient); the consolidated variant is the same kernel
// given other pointers and a row stride of 1536, so it equals the static one
// bit for bit.
//
// What bounds it: 688,128 MACs a point (802,816 with the transient branch)
// against 1,024 bytes a point (1,280): operations, by a factor of ~4.5 on an
// H100.  The probe exists to be set beside the fused forward kernel, so it is
// built from that kernel's own blocks (gemm, load_slab, Hidden from
// fused_mlp_common.cuh) on the same 64-point tile with the same activation
// buffer [pe | h]; what differs is what the probe leaves out (the encoders)
// and the padded widths its file fixes (fs2 384 wide, heads 128 wide).  To
// keep two blocks on an SM, as the fused kernel has, the (64, 128) f32
// output tile lives in global memory rather than shared: the fs2 tail
// stores it, each head adds into it (the block's own rows, ordered by the
// barrier that ends every gemm).  fs2 runs as two products over the same
// input, columns 256..383 first, so that the slab ring stays 256 wide.
//
// Numerics, as the Pallas kernels: hidden layers round the f32 product to
// bf16, add the bias rounded to bf16, in bf16, then ReLU; fs2 and the heads
// add their f32 bias in f32; xf = fs2[:, :256] is rounded to bf16; the
// output is (hd @ wr + br) + fs2[:, 256:], then + (th @ wth + bth).
#include "fused_mlp_common.cuh"

namespace {

constexpr int NET_W = 128;       // pe / dt / tt row and output row
constexpr int FS_W = W_TRUNK + NET_W;   // fs2 = [xf 0:256 | tail 256:384]
constexpr int MID_LD = 6 * W_TRUNK;     // row stride of the stacked w_mid

struct NetOps {
  const bf16* w[8];              // trunk weights (first column of each)
  int ldw[8];                    // their row strides
  const float* b[8];
  const bf16 *wfs, *wd, *wr, *wt0, *wtm[3], *wth;
  const float *bfs, *bd, *br, *bt0, *btm[3], *bth;
  const bf16 *pe, *dt, *tt;
};

// xf = fs2[:, :256] = h @ wfs[:, :256] + b, rounded once
struct Xf {
  bf16* dst;
  int ld;
  const float* bias;
  __device__ void operator()(int r, int c, float v) const {
    dst[r * ld + c] = __float2bfloat16_rn(v + bias[c]);
  }
};

// f32 columns of the output tile in global memory: store (the fs2 tail) or
// add (a head); rows past the end of the input are not touched
template <bool ADD> struct OutTile {
  float* out;
  const float* bias;
  int rows;
  __device__ void operator()(int r, int c, float v) const {
    if (r >= rows) return;
    float y = v + bias[c];
    float* p = out + (size_t)r * NET_W + c;
    *p = ADD ? y + *p : y;
  }
};

// 64 rows of an (N, 128) bf16 input into columns [0, 128) of dst, zeros past
// the end
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          size_t row0, int n) {
  for (int c = threadIdx.x; c < TILE_M * (NET_W / 8); c += THREADS) {
    const int r = c / (NET_W / 8), q = c % (NET_W / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < (size_t)n)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * NET_W + q * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + q * 8) = v;
  }
}

constexpr int PAD = Cfg<bf16>::PAD;
constexpr int ALD = ACT_W + PAD;
constexpr int HLD = W_HALF + PAD;
constexpr size_t SMEM = sizeof(bf16) * ((size_t)TILE_M * ALD + TILE_M * HLD +
                                        2 * Cfg<bf16>::KS * (W_TRUNK + PAD));

template <bool TRANSIENT>
__global__ void __launch_bounds__(THREADS, 2)
anatomy_net_kernel(NetOps o, float* __restrict__ out, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);      // [pe 0:128 | h 128:384]
  bf16* hb = act + TILE_M * ALD;
  bf16* slab = hb + TILE_M * HLD;

  const size_t row0 = (size_t)blockIdx.x * TILE_M;
  const int rows = (size_t)n - row0 < TILE_M ? (int)(n - row0) : TILE_M;
  float* otile = out + row0 * NET_W;

  load_rows(act, ALD, o.pe, row0, n);
  __syncthreads();

  bf16* h = act + NET_W;
  gemm<bf16, 16>(act, ALD, NET_W, o.w[0], slab, Hidden<bf16>{h, ALD, o.b[0]},
                 o.ldw[0]);
  for (int i = 1; i < 8; ++i) {
    if (i == 4)
      gemm<bf16, 16>(act, ALD, NET_W + W_TRUNK, o.w[i], slab,
                     Hidden<bf16>{h, ALD, o.b[i]}, o.ldw[i]);
    else
      gemm<bf16, 16>(h, ALD, W_TRUNK, o.w[i], slab,
                     Hidden<bf16>{h, ALD, o.b[i]}, o.ldw[i]);
  }
  // fs2 (256 -> 384): the f32 tail to the output tile, then xf over [pe | h]
  gemm<bf16, 8>(h, ALD, W_TRUNK, o.wfs + W_TRUNK, slab,
                OutTile<false>{otile, o.bfs + W_TRUNK, rows}, FS_W);
  gemm<bf16, 16>(h, ALD, W_TRUNK, o.wfs, slab, Xf{act, ALD, o.bfs}, FS_W);

  load_rows(act + W_TRUNK, ALD, o.dt, row0, n);
  __syncthreads();
  gemm<bf16, 8>(act, ALD, ACT_W, o.wd, slab, Hidden<bf16>{hb, HLD, o.bd});
  gemm<bf16, 8>(hb, HLD, W_HALF, o.wr, slab, OutTile<true>{otile, o.br, rows});

  if (TRANSIENT) {
    load_rows(act + W_TRUNK, ALD, o.tt, row0, n);
    __syncthreads();
    gemm<bf16, 8>(act, ALD, ACT_W, o.wt0, slab,
                  Hidden<bf16>{hb, HLD, o.bt0});
    for (int k = 0; k < 3; ++k)
      gemm<bf16, 8>(hb, HLD, W_HALF, o.wtm[k], slab,
                    Hidden<bf16>{hb, HLD, o.btm[k]});
    gemm<bf16, 8>(hb, HLD, W_HALF, o.wth, slab,
                  OutTile<true>{otile, o.bth, rows});
  }
}

template <bool TRANSIENT>
int launch(const NetOps& o, float* out, int n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      anatomy_net_kernel<TRANSIENT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int grid = (n + TILE_M - 1) / TILE_M;
  anatomy_net_kernel<TRANSIENT><<<grid, THREADS, SMEM, stream>>>(o, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant 0 static, 1 full, 2 consolidated.  ops: device pointers in the
// Pallas kernel's operand order:
//   static: w0 b0 .. w7 b7 wfs bfs wd bd wr br pe dt               (24)
//   full:   .. br wt0 bt0 wtm0 wtm1 wtm2 btm0 btm1 btm2 wth bth pe dt tt (35)
//   consol: w0 w_mid w_skip b_all wfs bfs wd bd wr br pe dt        (12)
// out: (n, 128) f32.  scratch is unused (the probes' launchers share one
// signature).  Returns 0 or the cudaError_t of the launch.
int nerf_anatomy_net(int variant, const void* const* ops, float* out, int n,
                     void* /*scratch*/, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  auto W = [&](int i) { return static_cast<const bf16*>(ops[i]); };
  auto B = [&](int i) { return static_cast<const float*>(ops[i]); };
  NetOps o = {};
  int at;
  if (variant == 2) {
    const int mid[6] = {1, 2, 3, 5, 6, 7};
    o.w[0] = W(0);
    o.ldw[0] = W_TRUNK;
    o.w[4] = W(2);
    o.ldw[4] = W_TRUNK;
    for (int j = 0; j < 6; ++j) {
      o.w[mid[j]] = W(1) + W_TRUNK * j;
      o.ldw[mid[j]] = MID_LD;
    }
    for (int i = 0; i < 8; ++i) o.b[i] = B(3) + W_TRUNK * i;
    at = 4;
  } else if (variant == 0 || variant == 1) {
    for (int i = 0; i < 8; ++i) {
      o.w[i] = W(2 * i);
      o.ldw[i] = W_TRUNK;
      o.b[i] = B(2 * i + 1);
    }
    at = 16;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  o.wfs = W(at), o.bfs = B(at + 1);
  o.wd = W(at + 2), o.bd = B(at + 3);
  o.wr = W(at + 4), o.br = B(at + 5);
  at += 6;
  if (variant == 1) {
    o.wt0 = W(at), o.bt0 = B(at + 1);
    for (int k = 0; k < 3; ++k) o.wtm[k] = W(at + 2 + k), o.btm[k] = B(at + 5 + k);
    o.wth = W(at + 8), o.bth = B(at + 9);
    at += 10;
  }
  o.pe = W(at), o.dt = W(at + 1);
  if (variant == 1) o.tt = W(at + 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return variant == 1 ? launch<true>(o, out, n, s) : launch<false>(o, out, n, s);
}

}  // extern "C"
