// Fused positional encoding + NeRF-W MLP forward for Hopper (sm_90a).
//
// Replaces nerf_fl_tpu/ops/fused_mlp.py:_fwd_kernel (the Pallas TPU kernel
// behind _fused_fwd).  A block runs, for a tile of points and without
// leaving the SM:
//   PE(xyz) -> trunk 8 x 256 (skip at layer 4) -> fs2 = [xyz_final | sigma]
//   -> dir branch -> rgb head -> transient branch 4 x 128 -> transient heads.
// Input is the packed (N, 128) f32 row [xyz 0:3 | dir 3:6 | a | t]; output
// is (N, 16) f32 pre-activations: cols 0-2 static rgb, 3 static sigma,
// 4-6 transient rgb, 7 transient sigma, 8 beta, 9-15 zero.  (The TPU kernel
// writes all 128 lanes; here the 112 lanes that are always zero are never
// written, which saves 448 of the 1,024 HBM bytes a point costs.)
//
// What bounds it: at the render shape (4,194,304 points a launch) the work
// is 684,160 MACs a point with transient heads, 5.74 TFLOP a launch, against
// ~2.4 GB of HBM traffic: bound by operations, by a factor of ~8 on an H100.
// The weights (~1.4 MB in bf16) fit no block's shared memory, so every tile
// streams them from L2, and each weight byte serves only as many MACs as the
// tile has rows; the products only reach the card's rate through wgmma.
//
// The bf16 kernel (the main paths') is built from the Hopper block of
// fused_mlp_common.cuh and does this about it:
//   * 128 points a block: two consumer warpgroups of 64 rows share every
//     weight slab that comes from L2.  A launch of n points moves
//     ceil(n / 128) x the weight image from L2 into shared memory: 1.41 MB
//     a tile, 46.2 GB at 4,194,304 points (64-row tiles would move twice
//     that).  Activations are the A operand from shared memory; neither
//     register-resident A nor a cluster's multicast load is used yet, both
//     would halve the L2 bytes again.
//   * wgmma (m64nNk16, bf16 in, f32 accumulate) with both operands read
//     from shared memory in the 128-byte-swizzled K-major layout.  A
//     warpgroup owns its 64 rows and a layer's whole width (128 accumulator
//     registers a thread at N = 256), so it alone reads its activations and
//     overwrites them in place after its products complete; the only
//     barrier inside a tile is over the warpgroup's 128 threads.
//   * a producer thread and a ring of three slabs tracked by mbarriers:
//     cp.async.bulk copies each 64-row weight slab from the image the
//     wrapper laid out as the kernel's shared-memory image (no tensor map),
//     a slab's "full" barrier counts the bytes, its "empty" barrier the two
//     warpgroups.  The ring runs across layers and tiles (blocks are
//     persistent), so the next layer's slabs arrive during an epilogue.
//     setmaxnreg moves the producer warpgroup's registers to the consumers.
//   * the epilogue stays in registers: round, rounded bias (staged once in
//     shared memory), ReLU on the accumulator fragments, then 32-bit stores
//     to the next layer's swizzled operand tile, which are free of bank
//     conflicts.  fs2's 16-column sigma block and both heads are N = 16
//     products whose eight accumulators a thread are the output tile.
//   * the encoders are bound by the latency of their input rows, not by
//     their sines (two warps a scheduler hide little): two threads share a
//     row and read its inputs once, and each tile asks L2 for the next
//     tile's rows (prefetch.global.L2) a whole tile ahead.
//   * padding is the tensor cores' 16-column granule: a slab whose last
//     rows are padding issues fewer k16 steps (dir tail 80 -> 5 steps, t
//     tail 16 -> 1), fs2 computes 256 + 16 columns, the heads 16.
// What bounds it now (nerf_fl_torch/experiments/fused_ablation.py): not the
// L2 (half the slab bytes changes nothing), the encoders ~10%, the
// epilogue's roundings ~1%; the rest is the products at about half the
// tensor cores' rate, because both warpgroups share every slab and so run
// their products, then their epilogues, at the same time.
// Block: 384 threads, 168 registers a thread at launch (232 for consumers
// after setmaxnreg), 216,880 bytes of shared memory (2 x 48 KB activations,
// 3 x 34 KB slabs, 13 KB biases and scale rows), one block an SM.
//
// The f32 kernel is the exact yardstick (plain FMAs on the CUDA cores, the
// header's gemm / load_slab, 64 points a block); it is on no main path.
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

// The f32 instance: full-precision FMAs on the CUDA cores through the
// header's gemm / load_slab, 64 points a block.  It is the exact yardstick
// and is on no main path.
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_fwd_f32_kernel(const float* __restrict__ inp, float* __restrict__ out,
                     int n, Net net, const float* __restrict__ sx,
                     const float* __restrict__ sd, int nfx, int nfd,
                     int a_dim, int t_dim, int k0, int kd, int kt,
                     int has_transient, unsigned long long* runs) {
  using T = float;
  count_run(runs);
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

// ----------------------------------------------------------------------
// The bf16 kernel.  Block = two consumer warpgroups (64 rows each) and a
// producer warpgroup of which one thread works.
// ----------------------------------------------------------------------
struct Biases {
  const float* b[N_LAYERS];
};

__global__ void __launch_bounds__(hop::H_THREADS, 1)
fused_mlp_fwd_bf16_kernel(const float* __restrict__ inp,
                          float* __restrict__ out, int n,
                          const unsigned char* __restrict__ image,
                          const __grid_constant__ hop::Plan plan,
                          const __grid_constant__ Biases bias,
                          const float* __restrict__ sx,
                          const float* __restrict__ sd, int nfx, int nfd,
                          int a_dim, int t_dim, int k0, int kd, int kt,
                          int has_transient, unsigned long long* runs) {
  using namespace hop;
  count_run(runs);
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles sit on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = smem + CONSUMERS * ACT_BYTES;
  float* bias_s = reinterpret_cast<float*>(stages + STAGES * STAGE_BYTES);
  float* sx_s = bias_s + BIAS_FLOATS;
  float* sd_s = sx_s + IN_LD;
  const uint32_t full = smem_u32(bias_s + CONST_FLOATS);
  const uint32_t empty = full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int n_layers = has_transient ? N_LAYERS : L_T0;
  for (int c = tid; c < IN_LD; c += H_THREADS) {
    sx_s[c] = sx[c];
    sd_s[c] = sd[c];
  }
  // biases to shared memory once; hidden layers add theirs rounded
  for (int l = 0; l < n_layers; ++l) {
    const bool f32_bias = l == L_FS || l == L_RGB || l == L_TH;
    float* dst = bias_s + bias_off(l);
    for (int c = tid; c < layer_n(l); c += H_THREADS) {
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
      produce(image, plan, full, empty, smem_u32(stages), STAGE_BYTES, n_tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = tid & 127;
    const int fr = 16 * (t >> 5) + ((t & 31) >> 2), fq = t & 3;
    const bool elected = t == 0;
    unsigned char* act = smem + wg * ACT_BYTES;
    const uint32_t act_s = smem_u32(act);
    const uint32_t tile_p = act_s + T_P * TILE_BYTES;
    const uint32_t tile_h = act_s + T_H * TILE_BYTES;
    Ring ring = {full, empty, smem_u32(stages), STAGE_BYTES, 0, 0, -1};
    float none[8];

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const size_t row0 = (size_t)tile * ROWS + wg * WG_ROWS;
      // PE(xyz) -> P
      encode_rows(act, T_P, inp, row0, n, 0, nfx, sx_s, 0, 0, k0, t);
      // the next tile's input rows on their way into L2 meanwhile
      next_rows(inp, row0 + (size_t)gridDim.x * ROWS, n,
                4 * (6 + a_dim + t_dim), t);
      fence_async_smem();
      wg_sync(wg);

      float out8[8];
      {
        float acc[W_TRUNK / 2];
        // trunk: every layer overwrites H in place once its products are done
        for (int i = 0; i < 8; ++i) {
          bool fresh = true;
          wgmma_fence();
          if (i == 0 || i == 4)
            mma_seg<W_TRUNK, false>(acc, none, tile_p, k0, ring, fresh,
                                    elected);
          if (i != 0)
            mma_seg<W_TRUNK, false>(acc, none, tile_h, W_TRUNK, ring, fresh,
                                    elected);
          mma_end(ring, elected);
          fence_acc(acc);
          store_acc<W_TRUNK>(acc, act, T_H, bias_s + bias_off(i), fr, fq,
                             HiddenF{});
          fence_async_smem();
          wg_sync(wg);
        }
        // fs2: xyz_final -> H (rounded from f32), the sigma block -> out8
        float sig[8];
        bool fresh = true;
        wgmma_fence();
        mma_seg<W_TRUNK, true>(acc, sig, tile_h, W_TRUNK, ring, fresh,
                               elected);
        mma_end(ring, elected);
        fence_acc(acc);
        fence_acc(sig);
        const float* bfs = bias_s + bias_off(L_FS);
        store_acc<W_TRUNK>(acc, act, T_H, bfs, fr, fq, LinearF{});
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(
              bfs + W_TRUNK + 8 * j + 2 * fq);
          out8[4 * j + 0] = sig[4 * j + 0] + b.x;
          out8[4 * j + 1] = sig[4 * j + 1] + b.y;
          out8[4 * j + 2] = sig[4 * j + 2] + b.x;
          out8[4 * j + 3] = sig[4 * j + 3] + b.y;
        }
      }
      // dir tail [PE(dir) | a | 0] -> P
      encode_rows(act, T_P, inp, row0, n, 3, nfd, sd_s, 6, a_dim, kd, t);
      fence_async_smem();
      wg_sync(wg);

      float acc[W_HALF / 2];
      float head[8];
      // dir layer [xyz_final | tail] -> hd in P; static rgb head
      {
        bool fresh = true;
        wgmma_fence();
        mma_seg<W_HALF, false>(acc, none, tile_h, W_TRUNK, ring, fresh,
                               elected);
        mma_seg<W_HALF, false>(acc, none, tile_p, kd, ring, fresh, elected);
        mma_end(ring, elected);
        fence_acc(acc);
        store_acc<W_HALF>(acc, act, T_P, bias_s + bias_off(L_DIR), fr, fq,
                          HiddenF{});
        fence_async_smem();
        wg_sync(wg);
        fresh = true;
        wgmma_fence();
        mma_seg<OUT_LD, false>(head, none, tile_p, W_HALF, ring, fresh,
                               elected);
        mma_end(ring, elected);
        fence_acc(head);
        const float* bh = bias_s + bias_off(L_RGB);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(bh + 8 * j + 2 * fq);
          out8[4 * j + 0] = (head[4 * j + 0] + b.x) + out8[4 * j + 0];
          out8[4 * j + 1] = (head[4 * j + 1] + b.y) + out8[4 * j + 1];
          out8[4 * j + 2] = (head[4 * j + 2] + b.x) + out8[4 * j + 2];
          out8[4 * j + 3] = (head[4 * j + 3] + b.y) + out8[4 * j + 3];
        }
      }
      if (has_transient) {
        // t tail -> P (the rgb head has finished reading hd)
        for (int p = t; p < WG_ROWS * (kt / 2); p += 128) {
          const int r = p / (kt / 2), c = 2 * (p % (kt / 2));
          float v[2] = {0.0f, 0.0f};
          if (row0 + r < (size_t)n) {
            const float* row = inp + (row0 + r) * IN_LD + 6 + a_dim;
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (c + i < t_dim) v[i] = row[c + i];
          }
          *reinterpret_cast<uint32_t*>(act + act_off(T_P, r, c)) =
              pack2(v[0], v[1]);
        }
        fence_async_smem();
        wg_sync(wg);
        for (int l = L_T0; l < L_TH; ++l) {
          bool fresh = true;
          wgmma_fence();
          if (l == L_T0) {
            mma_seg<W_HALF, false>(acc, none, tile_h, W_TRUNK, ring, fresh,
                                   elected);
            mma_seg<W_HALF, false>(acc, none, tile_p, kt, ring, fresh,
                                   elected);
          } else {
            mma_seg<W_HALF, false>(acc, none, tile_p, W_HALF, ring, fresh,
                                   elected);
          }
          mma_end(ring, elected);
          fence_acc(acc);
          store_acc<W_HALF>(acc, act, T_P, bias_s + bias_off(l), fr, fq,
                            HiddenF{});
          fence_async_smem();
          wg_sync(wg);
        }
        bool fresh = true;
        wgmma_fence();
        mma_seg<OUT_LD, false>(head, none, tile_p, W_HALF, ring, fresh,
                               elected);
        mma_end(ring, elected);
        fence_acc(head);
        const float* bh = bias_s + bias_off(L_TH);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(bh + 8 * j + 2 * fq);
          out8[4 * j + 0] = out8[4 * j + 0] + (head[4 * j + 0] + b.x);
          out8[4 * j + 1] = out8[4 * j + 1] + (head[4 * j + 1] + b.y);
          out8[4 * j + 2] = out8[4 * j + 2] + (head[4 * j + 2] + b.x);
          out8[4 * j + 3] = out8[4 * j + 3] + (head[4 * j + 3] + b.y);
        }
      }
      // rows past n are not stored
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = row0 + fr + 8 * h;
        if (row < (size_t)n) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<float2*>(out + row * OUT_LD + 8 * j + 2 * fq) =
                make_float2(out8[4 * j + 2 * h], out8[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

struct Dims {
  int k0, kd, kt;
};

bool dims(int n, int nfx, int nfd, int a_dim, int t_dim, Dims* d) {
  d->k0 = (3 + 6 * nfx + 15) / 16 * 16;
  d->kd = (3 + 6 * nfd + a_dim + 15) / 16 * 16;
  d->kt = (t_dim + 15) / 16 * 16;
  return n >= 0 && d->k0 <= 128 && d->kd <= 128 && d->kt <= 128 &&
         nfx <= 20 && nfd <= 20;
}

int launch_f32(const float* inp, float* out, int n, const void* const* w,
               const float* const* b, const float* sx, const float* sd,
               int nfx, int nfd, int a_dim, int t_dim, int has_transient,
               unsigned long long* runs, cudaStream_t stream) {
  Dims d;
  if (!dims(n, nfx, nfd, a_dim, t_dim, &d)) return (int)cudaErrorInvalidValue;
  const int n_w = has_transient ? N_LAYERS : L_T0;
  Net net = {};
  for (int l = 0; l < n_w; ++l) {
    net.w[l] = w[l];
    net.b[l] = b[l];
  }
  constexpr size_t smem = smem_bytes<float>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int grid = (n + TILE_M - 1) / TILE_M;
  fused_mlp_fwd_f32_kernel<<<grid, THREADS, smem, stream>>>(
      inp, out, n, net, sx, sd, nfx, nfd, a_dim, t_dim, d.k0, d.kd, d.kt,
      has_transient, runs);
  return (int)cudaGetLastError();
}

int launch_bf16(const float* inp, float* out, int n, const void* image,
                long long image_bytes, int grid, const float* const* b,
                const float* sx, const float* sd, int nfx, int nfd, int a_dim,
                int t_dim, int has_transient, unsigned long long* runs,
                cudaStream_t stream) {
  Dims d;
  if (!dims(n, nfx, nfd, a_dim, t_dim, &d)) return (int)cudaErrorInvalidValue;
  if (!has_transient) d.kt = 0;
  hop::Plan plan;
  // the wrapper's image must be the one this walk expects
  if (hop::make_plan(plan, d.k0, d.kd, d.kt, has_transient) != image_bytes ||
      plan.n_slabs > hop::MAX_SLABS)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + hop::ROWS - 1) / hop::ROWS;
  if (grid < (n_tiles ? 1 : 0) || grid > n_tiles)
    return (int)cudaErrorInvalidValue;
  Biases bias = {};
  for (int l = 0; l < (has_transient ? N_LAYERS : L_T0); ++l) bias.b[l] = b[l];
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      hop::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  fused_mlp_fwd_bf16_kernel<<<grid, hop::H_THREADS, hop::SMEM_BYTES, stream>>>(
      inp, out, n, static_cast<const unsigned char*>(image), plan, bias, sx,
      sd, nfx, nfd, a_dim, t_dim, d.k0, d.kd, d.kt, has_transient, runs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  w / b are host arrays of device
// pointers, in the layer order of nerf_fl_torch/ops/fused_mlp.py:pack_weights.
// bfloat16 reads its weights from `image` (image_bytes long; fused_mlp.py:
// weight_image) and runs `grid` persistent blocks (fused_mlp.py:fwd_grid);
// float32 ignores the three.  The kernel adds one to *runs each time it
// runs (a CUDA graph's replays included).  Returns 0 or the cudaError_t of
// the launch.
int nerf_fused_mlp_fwd(int dtype, const float* inp, float* out, int n,
                       const void* const* w, const float* const* b,
                       const void* image, long long image_bytes, int grid,
                       const float* sx, const float* sd, int nfx, int nfd,
                       int a_dim, int t_dim, int has_transient,
                       unsigned long long* runs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(inp, out, n, image, image_bytes, grid, b, sx, sd, nfx,
                       nfd, a_dim, t_dim, has_transient, runs, s);
  if (dtype == 0)
    return launch_f32(inp, out, n, w, b, sx, sd, nfx, nfd, a_dim, t_dim,
                      has_transient, runs, s);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 kernel's block, for reports: out[0] points a block, out[1]
// threads, out[2] shared-memory bytes, out[3] slabs in the weight ring.
void nerf_fused_mlp_fwd_info(int* out) {
  out[0] = hop::ROWS;
  out[1] = hop::H_THREADS;
  out[2] = hop::SMEM_BYTES;
  out[3] = hop::STAGES;
}

}  // extern "C"
