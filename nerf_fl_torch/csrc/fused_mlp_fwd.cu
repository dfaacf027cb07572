// Fused positional encoding + NeRF-W MLP forward for Hopper (sm_90a).
//
// Replaces nerf_fl_tpu/ops/fused_mlp.py:_fwd_kernel (the Pallas TPU kernel
// behind _fused_fwd).  One block owns a tile of TILE_M = 64 sample points and
// runs, without leaving the SM:
//   PE(xyz) -> trunk 8 x 256 (skip at layer 4) -> fs2 = [xyz_final | sigma]
//   -> dir branch -> rgb head -> transient branch 4 x 128 -> transient heads.
// Input is the packed (N, 128) f32 row [xyz 0:3 | dir 3:6 | a | t]; output
// is (N, 16) f32 pre-activations: cols 0-2 static rgb, 3 static sigma,
// 4-6 transient rgb, 7 transient sigma, 8 beta, 9-15 zero.  (The TPU kernel
// writes all 128 lanes; here the 112 lanes that are always zero are never
// written, which saves 448 of the 1,024 HBM bytes a point costs.)
//
// What bounds it: at the render shape (4,194,304 points per launch) the work
// is 684,160 MACs per point with transient heads, 5.74 TFLOP per launch,
// against ~2.4 GB of HBM traffic: compute-bound by a factor of ~8 on an
// H100.  The design does three things about it:
//   * every matrix product runs on the tensor cores (WMMA m16n16k16, bf16 in,
//     f32 accumulate); the f32 variant is plain FMAs for exact comparisons,
//   * activations never leave shared memory: one 64 x 384 buffer holds the
//     skip concat [pe | h] and each layer overwrites its own input in place
//     (accumulators live in registers until every warp has read the input),
//   * the zero padding the TPU layout needs is cut down to the 16-column
//     granule of the tensor cores: layer 0 contracts 64 PE columns, not 128,
//     fs2 computes 256 + 16 columns, not 384, the heads 16 columns, not 128.
// Weights (~1.4 MB in bf16) do not fit in shared memory; each layer streams
// K-slabs of them from L2 through a double-buffered cp.async ring.
// wgmma, TMA and warp specialisation are left for later work.
//
// Numerics follow the TPU kernel exactly:
//   * hidden layers: f32 accumulate, round to the compute type, add the bias
//     rounded to the compute type, ReLU;
//   * fs2 and the heads stay f32 with f32 bias; xyz_final is rounded from
//     the f32 fs2; static sigma comes from the trunk output through fs2;
//   * PE trig is the Cody-Waite sin with rintf (round half to even, as
//     jnp.round) and the cos phase added after reduction.  Every step uses
//     __fmul_rn / __fadd_rn so that no multiply-add is contracted: build
//     without --use_fast_math.
#include "fused_mlp_common.cuh"

namespace {

// fs2 = h @ [W_xyz_final | w_sigma] + b in f32: xyz_final is rounded into
// dst, the 16-column sigma block adds into the f32 output tile.
template <typename T> struct Fs2 {
  T* dst;
  int ld;
  const float* bias;
  float* out;
  __device__ void operator()(int r, int c, float v) const {
    float y = v + bias[c];
    if (c < W_TRUNK)
      dst[r * ld + c] = to_t<T>(y);
    else
      out[r * OUT_LD + (c - W_TRUNK)] += y;
  }
};

// f32 head: adds into the output tile (heads write disjoint columns)
struct Head {
  const float* bias;
  float* out;
  __device__ void operator()(int r, int c, float v) const {
    out[r * OUT_LD + c] += v + bias[c];
  }
};

template <typename T>
constexpr size_t smem_bytes() {
  constexpr int PAD = Cfg<T>::PAD;
  return sizeof(T) * (size_t)TILE_M * (ACT_W + PAD)          // act
         + sizeof(T) * (size_t)TILE_M * (W_HALF + PAD)       // hb
         + sizeof(T) * 2 * (size_t)Cfg<T>::KS * (FS_OUT + PAD)  // slab
         + sizeof(float) * TILE_M * OUT_LD;                   // out
}

// bf16: 105 KB of shared memory, so two blocks fit on an SM
template <typename T>
__global__ void __launch_bounds__(THREADS,
                                  (std::is_same<T, bf16>::value ? 2 : 1))
fused_mlp_fwd_kernel(const float* __restrict__ inp, float* __restrict__ out,
                     int n, Net net, const float* __restrict__ sx,
                     const float* __restrict__ sd, int nfx, int nfd,
                     int a_dim, int t_dim, int k0, int kd, int kt,
                     int has_transient) {
  constexpr int PAD = Cfg<T>::PAD;
  constexpr int ALD = ACT_W + PAD;
  constexpr int HLD = W_HALF + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* act = reinterpret_cast<T*>(smem);
  T* hb = act + TILE_M * ALD;
  T* slab = hb + TILE_M * HLD;
  float* otile = reinterpret_cast<float*>(slab + 2 * Cfg<T>::KS * (FS_OUT + PAD));

  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * TILE_M;
  auto W = [&](int l) { return static_cast<const T*>(net.w[l]); };

  for (int e = tid; e < TILE_M * OUT_LD; e += THREADS) otile[e] = 0.0f;
  // PE(xyz) -> act[:, 0:k0]
  for (int e = tid; e < TILE_M * k0; e += THREADS) {
    const int r = e / k0, c = e % k0;
    float v = 0.0f;
    if (row0 + r < (size_t)n) v = pe_col(inp + (row0 + r) * IN_LD, c, nfx, sx);
    act[r * ALD + c] = to_t<T>(v);
  }
  __syncthreads();

  // trunk; h lives at act[:, k0:k0+256] so layer 4 reads [pe | h] whole
  T* h = act + k0;
  gemm<T, 16>(act, ALD, k0, W(0), slab, Hidden<T>{h, ALD, net.b[0]});
  for (int i = 1; i < 8; ++i) {
    if (i == 4)
      gemm<T, 16>(act, ALD, k0 + W_TRUNK, W(i), slab,
                  Hidden<T>{h, ALD, net.b[i]});
    else
      gemm<T, 16>(h, ALD, W_TRUNK, W(i), slab, Hidden<T>{h, ALD, net.b[i]});
  }
  // fs2: xyz_final -> act[:, 0:256], sigma -> otile
  gemm<T, FS_OUT / 16>(h, ALD, W_TRUNK, W(L_FS), slab,
                       Fs2<T>{act, ALD, net.b[L_FS], otile});

  // dir tail [PE(dir) | a | 0] -> act[:, 256:256+kd]
  const int dpe = 3 + 6 * nfd;
  for (int e = tid; e < TILE_M * kd; e += THREADS) {
    const int r = e / kd, c = e % kd;
    float v = 0.0f;
    if (row0 + r < (size_t)n) {
      const float* row = inp + (row0 + r) * IN_LD;
      if (c < dpe) v = pe_col(row + 3, c, nfd, sd);
      else if (c < dpe + a_dim) v = row[6 + c - dpe];
    }
    act[r * ALD + W_TRUNK + c] = to_t<T>(v);
  }
  __syncthreads();
  gemm<T, 8>(act, ALD, W_TRUNK + kd, W(L_DIR), slab,
             Hidden<T>{hb, HLD, net.b[L_DIR]});
  gemm<T, 1>(hb, HLD, W_HALF, W(L_RGB), slab, Head{net.b[L_RGB], otile});

  if (has_transient) {
    // [xyz_final | t | 0] for the first transient layer
    for (int e = tid; e < TILE_M * kt; e += THREADS) {
      const int r = e / kt, c = e % kt;
      float v = 0.0f;
      if (row0 + r < (size_t)n && c < t_dim)
        v = inp[(row0 + r) * IN_LD + 6 + a_dim + c];
      act[r * ALD + W_TRUNK + c] = to_t<T>(v);
    }
    __syncthreads();
    gemm<T, 8>(act, ALD, W_TRUNK + kt, W(L_T0), slab,
               Hidden<T>{hb, HLD, net.b[L_T0]});
    for (int l = L_T0 + 1; l < L_TH; ++l)
      gemm<T, 8>(hb, HLD, W_HALF, W(l), slab, Hidden<T>{hb, HLD, net.b[l]});
    gemm<T, 1>(hb, HLD, W_HALF, W(L_TH), slab, Head{net.b[L_TH], otile});
  }

  for (int e = tid; e < TILE_M * OUT_LD; e += THREADS) {
    const int r = e / OUT_LD;
    if (row0 + r < (size_t)n) out[row0 * OUT_LD + e] = otile[e];
  }
}

template <typename T>
int launch(const float* inp, float* out, int n, const void* const* w,
           const float* const* b, const float* sx, const float* sd, int nfx,
           int nfd, int a_dim, int t_dim, int has_transient,
           cudaStream_t stream) {
  const int k0 = (3 + 6 * nfx + 15) / 16 * 16;
  const int kd = (3 + 6 * nfd + a_dim + 15) / 16 * 16;
  const int kt = (t_dim + 15) / 16 * 16;
  if (n < 0 || k0 > 128 || kd > 128 || kt > 128 || nfx > 20 || nfd > 20)
    return (int)cudaErrorInvalidValue;
  const int n_w = has_transient ? N_LAYERS : L_T0;
  Net net = {};
  for (int l = 0; l < n_w; ++l) {
    net.w[l] = w[l];
    net.b[l] = b[l];
  }
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int grid = (n + TILE_M - 1) / TILE_M;
  fused_mlp_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      inp, out, n, net, sx, sd, nfx, nfd, a_dim, t_dim, k0, kd, kt,
      has_transient);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  w / b are host arrays of device
// pointers, in the layer order of nerf_fl_torch/ops/fused_mlp.py:pack_weights.
// Returns 0 or the cudaError_t of the launch.
int nerf_fused_mlp_fwd(int dtype, const float* inp, float* out, int n,
                       const void* const* w, const float* const* b,
                       const float* sx, const float* sd, int nfx, int nfd,
                       int a_dim, int t_dim, int has_transient, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<bf16>(inp, out, n, w, b, sx, sd, nfx, nfd, a_dim, t_dim,
                        has_transient, s);
  if (dtype == 0)
    return launch<float>(inp, out, n, w, b, sx, sd, nfx, nfd, a_dim, t_dim,
                         has_transient, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
