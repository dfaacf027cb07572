// Fused positional encoding + NeRF-W MLP forward for Hopper (sm_90a), and
// beside it the sigma-only f32 kernel of the render's test-time coarse
// pass (sigma_trunk_f32_kernel; its note is above it, further down).
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
// The f32 kernel (dtype float32: the CLIs' default --compute_dtype, on the
// train and render paths through --use_pallas auto) replaces _fwd_kernel at
// dtype=float32.  What bounds it: the same 1.37 MFLOP a point in f32.  On
// the CUDA cores (67 TFLOP/s) that is 15x the bf16 kernel's bound, so it
// runs on the tensor cores as 3xTF32: each operand x is split into hi =
// cvt.rna.tf32.f32(x) and lo = the rest, rounded the same way (x - hi - lo
// within 2^-22 |x|), and a product is hi*hi + lo*hi + hi*lo with f32
// accumulation (lo*lo, under 2^-22 of it, is left out): about 2^-21
// relative a product.  Three TF32 passes at 495 TFLOP/s bound it at the
// work's time at 165 TFLOP/s, 6x the bf16 kernel's.  A bf16x3 build (three
// bf16 terms by truncation, six passes: f32's 2^-24 at the same rate) was
// run on the card too: it agreed with the plain version no better, and was
// slower (twice the wgmma instructions, pieces of 64 columns).  Against
// the plain version, neither split decides a ReLU as the plain version
// does where a hidden pre-activation lies within f32 rounding of zero: the
// same products summed in float64 do not either (ops/f32_ties.py, which
// the checks use to match the plain backward to the kernel's side of such
// a unit).  It is built from the f32 block of
// fused_mlp_common.cuh (namespace tf):
//   * the hop ring and producer: one thread copies stages of 32
//     contraction values by one output piece (128 columns; fs2's last 144),
//     each the hi then the lo part of the B operand's 128-byte-swizzled
//     K-major image, which the wrapper splits and lays out
//     (fused_mlp.py:f32_weight_image), through three stages;
//   * A from registers (the RS form of wgmma m64nNk8 .tf32): the
//     activations stay f32 in shared memory in a private layout, where the
//     thread that holds an element in a product's accumulator fragments is
//     the one that gives it as A to the next layer.  A k8 step's A fragment
//     is one float4 (the image orders each 8 contraction values 0, 2, 4, 6,
//     1, 3, 5, 7 to match), split in registers;
//   * budget: a 64-row f32 tile of ACT_W = 384 columns is 96 KB, and hi +
//     lo copies of it as tf32 would be 192 KB of the block's 227 KB, so the
//     activations are stored once as f32 and split in registers, and a
//     block holds 64 points.  Shared memory 223,024 bytes: 96 KB
//     activations, 3 x 36 KB stages, 13 KB biases and scale rows, 1 KB
//     alignment; one block an SM;
//   * two consumer warpgroups on the same 64 rows split each layer's output
//     columns (tf::mma_seg; the f32 backward's block): a 256-wide layer's
//     pieces of 128 columns are a stage each, a 128-wide layer's halves of
//     64 share one stage; fs2's sigma block rides warpgroup 1's piece, and
//     the N = 16 heads are warpgroup 1's while warpgroup 0 passes their
//     stages.  A thread holds at most 64 accumulators beside its 32 A
//     registers, the next 32 contraction values' A values load while this
//     stage's products run, and one warpgroup's products run while the
//     other splits its operands, waits for its stage or stores its
//     epilogue.  Each warpgroup stores its share of a layer's output in
//     place, so a barrier over the 256 consumer threads sits between a
//     layer's products and its epilogue and between the epilogue and the
//     next products; the encoders write every other 8-column group each.
//     Every consumer warp waits for every stage in order and arrives once
//     to free it (tf::RELEASES, 8).  Block: 384 threads, setmaxnreg 40
//     for the producer warpgroup and 232 for the consumers, 168 registers
//     a thread at launch, no spill, no ptxas C7520.  The one-warpgroup
//     design it replaced (256 threads, 128 accumulators a thread at N =
//     256, 255 registers with 572 / 860 B of spill, its products
//     serialized by ptxas, C7520) took ~96.6 ms for the render chunk's
//     4,194,304 points on an H100 (700 W), this one ~54.5, against a
//     three-pass bound of 34.8;
//   * each weight byte from L2 serves 64 points, half the bf16 kernel's
//     reuse.
//
// Numerics follow the TPU kernel exactly (at f32 "round to the compute
// type" is the identity; the split products are the one difference):
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

// ----------------------------------------------------------------------
// The f32 kernels' common parts.  A block of either f32 kernel below is a
// producer warpgroup of which one thread works and two consumer warpgroups
// on the same 64 rows that split each layer's output columns.
// ----------------------------------------------------------------------
// The block's shared memory: activations, the weight ring's stages, the
// biases and the scale rows, then the ring's barriers.
struct TfBlock {
  float4* act;
  unsigned char* stages;
  float* bias_s;
  float* sx_s;
  float* sd_s;
  uint32_t full, empty;

  __device__ __forceinline__ tf::Ring ring() const {
    return {full, empty, hop::smem_u32(stages), tf::STAGE_BYTES, 0, 0, -1};
  }
};

// Carve the block's shared memory, load the scale rows (sd only with DIR)
// and the biases of layers [0, n_layers), and set up the ring's barriers.
template <bool DIR>
__device__ __forceinline__ TfBlock tf_block(unsigned char* smem_raw,
                                            const Biases& bias, int n_layers,
                                            const float* __restrict__ sx,
                                            const float* __restrict__ sd) {
  unsigned char* smem =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  TfBlock k;
  k.act = reinterpret_cast<float4*>(smem);
  k.stages = smem + tf::ACT_BYTES;
  k.bias_s =
      reinterpret_cast<float*>(k.stages + tf::STAGES * tf::STAGE_BYTES);
  k.sx_s = k.bias_s + hop::BIAS_FLOATS;
  k.sd_s = k.sx_s + IN_LD;
  k.full = hop::smem_u32(k.bias_s + hop::CONST_FLOATS);
  k.empty = k.full + 8 * tf::STAGES;

  const int tid = threadIdx.x;
  for (int c = tid; c < IN_LD; c += tf::THREADS) {
    k.sx_s[c] = sx[c];
    if (DIR) k.sd_s[c] = sd[c];
  }
  for (int l = 0; l < n_layers; ++l)
    for (int c = tid; c < hop::layer_n(l); c += tf::THREADS)
      k.bias_s[hop::bias_off(l) + c] = bias.b[l][c];
  if (tid == 0) {
    for (int s = 0; s < tf::STAGES; ++s) {
      hop::mbar_init(k.full + 8 * s, 1);
      hop::mbar_init(k.empty + 8 * s, tf::RELEASES);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    hop::fence_async_smem();
  }
  __syncthreads();
  return k;
}

// The trunk over P = PE(xyz): 8 x 256, the skip at layer SKIP (4; the IPE
// kernels' 5, mip-NeRF's [h | enc] after layer 4, packed as [enc | h]);
// every layer overwrites H in place once both warpgroups' products are
// done, and its output is whole before the next layer's products.
template <int SKIP = 4>
__device__ __forceinline__ void tf_trunk(
    float (&acc)[tf::share<W_TRUNK>()], float (&none)[8], float4* act,
    int k0, tf::Ring& ring, const float* bias_s, int fq, int t, int wg) {
  for (int i = 0; i < 8; ++i) {
    bool fresh = true;
    if (i == 0 || i == SKIP)
      tf::mma_seg<W_TRUNK>(acc, none, act, tf::G_P, k0, ring, fresh, t, wg);
    if (i != 0)
      tf::mma_seg<W_TRUNK>(acc, none, act, tf::G_H, W_TRUNK, ring, fresh, t,
                           wg);
    tf::consumer_sync();
    tf::store_hidden<W_TRUNK, false>(acc, act, tf::G_H,
                                     bias_s + hop::bias_off(i), fq, t,
                                     nullptr, wg);
    tf::consumer_sync();
  }
}

// ----------------------------------------------------------------------
// The f32 kernel, and its IPE instance (MIP): mip-NeRF's field.
//
// The IPE instance (fused_mlp_fwd_ipe_f32_kernel) runs mip-NeRF's MLP
// (Barron et al. 2021, google/mipnerf internal/models.py:MLP) at the same
// widths: its packed row is [mean 0:3 | dir 3:6 | var 6:9 | 0], a cone
// interval's Gaussian and the unit view direction; P takes the integrated
// positional encoding of the Gaussian (tf::encode_ipe: 6 n_freq columns,
// all sines first, each times its per-point attenuation), and the skip is
// mip-NeRF's, [h | enc] into layer 5 after layer 4's ReLU, which the
// packed weight holds as [enc | h], so that layer 5 reads P then H as
// layer 4 does here.  Density is fs2's sigma column, mip-NeRF's bottleneck
// its xyz_final, the condition layer the dir layer over [bottleneck |
// PE(dir)], the rgb head the same: no appearance and no transient branch.
// Everything else is the f32 kernel's code, so both levels of a mip-NeRF
// step run the same block, ring and products.  It adds one to ipe_runs as
// well as to runs, so the fused pair's count (kernel_runs) holds it.
//
// Warpgroup 1 holds the output: fs2's sigma block rides its piece and
// both heads are its products (tf::mma_seg), so out8 is whole in its
// registers and it stores the tile's rows; warpgroup 0's out8 is never
// read.
// ----------------------------------------------------------------------
template <bool MIP>
__device__ __forceinline__ void fwd_f32(const float* __restrict__ inp,
                                        float* __restrict__ out, int n,
                                        const unsigned char* __restrict__ image,
                                        const tf::Plan& plan,
                                        const Biases& bias,
                                        const float* __restrict__ sx,
                                        const float* __restrict__ sd, int nfx,
                                        int nfd, int a_dim, int t_dim, int k0,
                                        int kd, int kt, int has_transient) {
  using tf::G_H;
  using tf::G_P;
  extern __shared__ unsigned char smem_raw[];
  const int n_layers = has_transient ? N_LAYERS : L_T0;
  const TfBlock k = tf_block<true>(smem_raw, bias, n_layers, sx, sd);
  float4* act = k.act;
  const float* bias_s = k.bias_s;
  const float* sd_s = k.sd_s;

  const int n_tiles = (n + tf::ROWS - 1) / tf::ROWS;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (wg == tf::CONSUMERS) {
    // the producer warpgroup: its first thread streams the plan's stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == tf::CONSUMERS * 128)
      tf::produce(image, plan, k.full, k.empty, hop::smem_u32(k.stages),
                  tf::STAGE_BYTES, n_tiles);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = tid & 127;
  const int fr = 16 * (t >> 5) + ((t & 31) >> 2), fq = t & 3;
  tf::Ring ring = k.ring();
  float none[8];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * tf::ROWS;
    // the last tile's heads have read P
    tf::consumer_sync();
    // PE(xyz) (IPE(mean, var)) -> P
    if constexpr (MIP) {
      tf::encode_ipe(act, G_P, inp, row0, n, nfx, k0, t, wg);
      if (wg == 0)
        hop::next_rows(inp, row0 + (size_t)gridDim.x * tf::ROWS, n, 4 * 9,
                       t);
    } else {
      tf::encode(act, G_P, inp, row0, n, true, 0, nfx, k.sx_s, 0, 0, k0, t,
                 wg);
      if (wg == 0)
        hop::next_rows(inp, row0 + (size_t)gridDim.x * tf::ROWS, n,
                       4 * (6 + a_dim + t_dim), t);
    }
    tf::consumer_sync();

    float out8[8];
    {
      float acc[tf::share<W_TRUNK>()];
      tf_trunk<MIP ? 5 : 4>(acc, none, act, k0, ring, bias_s, fq, t, wg);
      // fs2: xyz_final -> H, the sigma block -> out8
      float sig[8];
      bool fresh = true;
      tf::mma_seg<W_TRUNK, true>(acc, sig, act, G_H, W_TRUNK, ring, fresh, t,
                                 wg);
      tf::consumer_sync();
      const float* bfs = bias_s + hop::bias_off(L_FS);
      tf::store_linear<W_TRUNK>(acc, act, G_H, bfs, fq, t, wg);
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
    tf::encode(act, G_P, inp, row0, n, true, 3, nfd, sd_s, 6, a_dim, kd, t,
               wg);
    tf::consumer_sync();

    float acc[tf::share<W_HALF>()];
    float head[8];
    // dir layer [xyz_final | tail] -> hd in P; static rgb head
    {
      bool fresh = true;
      tf::mma_seg<W_HALF>(acc, none, act, G_H, W_TRUNK, ring, fresh, t, wg);
      tf::mma_seg<W_HALF>(acc, none, act, G_P, kd, ring, fresh, t, wg);
      tf::consumer_sync();
      tf::store_hidden<W_HALF, false>(acc, act, G_P,
                                      bias_s + hop::bias_off(L_DIR), fq, t,
                                      nullptr, wg);
      tf::consumer_sync();
      fresh = true;
      tf::mma_seg<OUT_LD>(head, none, act, G_P, W_HALF, ring, fresh, t, wg);
      const float* bh = bias_s + hop::bias_off(L_RGB);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(bh + 8 * j + 2 * fq);
        out8[4 * j + 0] = (head[4 * j + 0] + b.x) + out8[4 * j + 0];
        out8[4 * j + 1] = (head[4 * j + 1] + b.y) + out8[4 * j + 1];
        out8[4 * j + 2] = (head[4 * j + 2] + b.x) + out8[4 * j + 2];
        out8[4 * j + 3] = (head[4 * j + 3] + b.y) + out8[4 * j + 3];
      }
    }
    if (!MIP && has_transient) {
      // t tail -> P, once the rgb head's products have read hd
      tf::consumer_sync();
      tf::encode(act, G_P, inp, row0, n, false, 0, 0, sd_s, 6 + a_dim, t_dim,
                 kt, t, wg);
      tf::consumer_sync();
      for (int l = L_T0; l < L_TH; ++l) {
        bool fresh = true;
        if (l == L_T0) {
          tf::mma_seg<W_HALF>(acc, none, act, G_H, W_TRUNK, ring, fresh, t,
                              wg);
          tf::mma_seg<W_HALF>(acc, none, act, G_P, kt, ring, fresh, t, wg);
        } else {
          tf::mma_seg<W_HALF>(acc, none, act, G_P, W_HALF, ring, fresh, t,
                              wg);
        }
        tf::consumer_sync();
        tf::store_hidden<W_HALF, false>(acc, act, G_P,
                                        bias_s + hop::bias_off(l), fq, t,
                                        nullptr, wg);
        tf::consumer_sync();
      }
      bool fresh = true;
      tf::mma_seg<OUT_LD>(head, none, act, G_P, W_HALF, ring, fresh, t, wg);
      const float* bh = bias_s + hop::bias_off(L_TH);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(bh + 8 * j + 2 * fq);
        out8[4 * j + 0] = out8[4 * j + 0] + (head[4 * j + 0] + b.x);
        out8[4 * j + 1] = out8[4 * j + 1] + (head[4 * j + 1] + b.y);
        out8[4 * j + 2] = out8[4 * j + 2] + (head[4 * j + 2] + b.x);
        out8[4 * j + 3] = out8[4 * j + 3] + (head[4 * j + 3] + b.y);
      }
    }
    // warpgroup 1's out8; rows past n are not stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = row0 + fr + 8 * h;
      if (wg == 1 && row < (size_t)n) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float2*>(out + row * OUT_LD + 8 * j + 2 * fq) =
              make_float2(out8[4 * j + 2 * h], out8[4 * j + 2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(tf::THREADS, 1)
fused_mlp_fwd_f32_kernel(const float* __restrict__ inp,
                         float* __restrict__ out, int n,
                         const unsigned char* __restrict__ image,
                         const __grid_constant__ tf::Plan plan,
                         const __grid_constant__ Biases bias,
                         const float* __restrict__ sx,
                         const float* __restrict__ sd, int nfx, int nfd,
                         int a_dim, int t_dim, int k0, int kd, int kt,
                         int has_transient, unsigned long long* runs) {
  count_run(runs);
  fwd_f32<false>(inp, out, n, image, plan, bias, sx, sd, nfx, nfd, a_dim,
                 t_dim, k0, kd, kt, has_transient);
}

__global__ void __launch_bounds__(tf::THREADS, 1)
fused_mlp_fwd_ipe_f32_kernel(const float* __restrict__ inp,
                             float* __restrict__ out, int n,
                             const unsigned char* __restrict__ image,
                             const __grid_constant__ tf::Plan plan,
                             const __grid_constant__ Biases bias,
                             const float* __restrict__ sd, int nfx, int nfd,
                             int k0, int kd, unsigned long long* runs,
                             unsigned long long* ipe_runs) {
  count_run(runs);
  count_run(ipe_runs);
  fwd_f32<true>(inp, out, n, image, plan, bias, sd, sd, nfx, nfd, 0, 0, k0,
                kd, 0, 0);
}

// ----------------------------------------------------------------------
// The sigma-only f32 kernel (sigma_trunk_f32_kernel): the render's
// test-time coarse pass, which needs the static sigma alone.
//
// It replaces no TPU kernel: the JAX package runs this pass on XLA's plain
// GEMMs (nerf_fl_tpu/render/renderer.py, sigma_only), as the port did
// (models/mlp.py:apply_nerf: CUDA-core f32 GEMMs and a bias-add and a ReLU
// kernel a layer over (points, 256) f32 tensors in device memory).  That
// pass took 382 of an f32 400 x 400 frame's 910 device ms (42%) on an
// H100.  What bounds it: PE(xyz) and the trunk, 491,264 MACs a point
// (0.98 MFLOP), against 12 bytes in and 4 out: bound by operations, 10.06
// TFLOP a 400 x 400 frame at 64 coarse samples, ~61 ms as three TF32
// passes at 495 TFLOP/s.
//
// It is the f32 kernel cut short, from the same tf block and with the same
// numerics, and it shares that kernel's prologue (tf_block) and trunk
// (tf_trunk): the producer, ring and stages (the image is
// fused_mlp.py:f32_sigma_image, the walk tf::make_sigma_plan: the trunk's
// stages, then fs2's 16-column sigma block alone as one (256, 16) segment),
// the two consumer warpgroups, A from registers, 3xTF32 products with f32
// accumulation, hidden layers relu(sum + bias), the sigma block an N = 16
// product (warpgroup 1's, which stores it) plus its f32 bias.  Its sigma is
// column 3 of the f32 kernel's output for the same points and weights, bit for
// bit: the same products in the same order on the same accumulator.  It leaves
// out xyz_final's 256 columns, the dir tail and layer, the rgb head and the
// transient branch (28% of the f32 kernel's work), and it reads the positions
// as they are, (N, 3) f32 (tf::encode<3>), not the packed 512-byte row, and
// writes one f32 pre-activation a point.  Its runs are counted in a slot of
// their own, so kernel_runs() still counts the fused pair alone.
// ----------------------------------------------------------------------
__global__ void __launch_bounds__(tf::THREADS, 1)
sigma_trunk_f32_kernel(const float* __restrict__ xyz,
                       float* __restrict__ out, int n,
                       const unsigned char* __restrict__ image,
                       const __grid_constant__ tf::Plan plan,
                       const __grid_constant__ Biases bias,
                       const float* __restrict__ sx, int nfx, int k0,
                       unsigned long long* runs) {
  count_run(runs);
  extern __shared__ unsigned char smem_raw[];
  const TfBlock k = tf_block<false>(smem_raw, bias, L_FS + 1, sx, nullptr);
  float4* act = k.act;

  const int n_tiles = (n + tf::ROWS - 1) / tf::ROWS;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (wg == tf::CONSUMERS) {
    // the producer warpgroup: its first thread streams the plan's stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == tf::CONSUMERS * 128)
      tf::produce(image, plan, k.full, k.empty, hop::smem_u32(k.stages),
                  tf::STAGE_BYTES, n_tiles);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = tid & 127;
  const int fr = 16 * (t >> 5) + ((t & 31) >> 2), fq = t & 3;
  tf::Ring ring = k.ring();
  float none[8];
  // static sigma is column 3 of the sigma block: the second value of the
  // column pair of the threads with fq == 1, in both of their rows
  const float b_sigma = k.bias_s[hop::bias_off(L_FS) + W_TRUNK + 3];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * tf::ROWS;
    // PE(xyz) -> P (the last tile read P at its skip layer, barriers ago)
    tf::encode<3>(act, tf::G_P, xyz, row0, n, true, 0, nfx, k.sx_s, 0, 0,
                  k0, t, wg);
    tf::consumer_sync();
    float acc[tf::share<W_TRUNK>()];
    tf_trunk(acc, none, act, k0, ring, k.bias_s, fq, t, wg);
    // fs2's sigma block alone
    float sig[8];
    bool fresh = true;
    tf::mma_seg<OUT_LD>(sig, none, act, tf::G_H, W_TRUNK, ring, fresh, t, wg);
    if (wg == 1 && fq == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = row0 + fr + 8 * h;
        if (row < (size_t)n) out[row] = sig[2 * h + 1] + b_sigma;
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

// ipe_runs non-null: the IPE instance (mip-NeRF's field), which also adds
// one to *ipe_runs: nfx IPE frequencies (k0 = 6 nfx rounded up to 16),
// no appearance, no transient branch, the skip at layer 5.
int launch_f32(const float* inp, float* out, int n, const void* image,
               long long image_bytes, int grid, const float* const* b,
               const float* sx, const float* sd, int nfx, int nfd, int a_dim,
               int t_dim, int has_transient, unsigned long long* runs,
               unsigned long long* ipe_runs, cudaStream_t stream) {
  const bool ipe = ipe_runs != nullptr;
  Dims d;
  if (!dims(n, nfx, nfd, a_dim, t_dim, &d) ||
      (ipe && (nfx < 1 || a_dim || t_dim || has_transient)))
    return (int)cudaErrorInvalidValue;
  if (ipe) d.k0 = (6 * nfx + 15) / 16 * 16;
  if (!has_transient) d.kt = 0;
  tf::Plan plan;
  // the wrapper's image must be the one this walk expects
  if (tf::make_plan(plan, d.k0, d.kd, d.kt, has_transient, ipe ? 5 : 4) !=
          image_bytes ||
      plan.n_stages > tf::MAX_PLAN)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + tf::ROWS - 1) / tf::ROWS;
  if (grid < (n_tiles ? 1 : 0) || grid > n_tiles)
    return (int)cudaErrorInvalidValue;
  Biases bias = {};
  for (int l = 0; l < (has_transient ? N_LAYERS : L_T0); ++l) bias.b[l] = b[l];
  cudaError_t err = cudaFuncSetAttribute(
      ipe ? (const void*)fused_mlp_fwd_ipe_f32_kernel
          : (const void*)fused_mlp_fwd_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, tf::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const unsigned char* img = static_cast<const unsigned char*>(image);
  if (ipe)
    fused_mlp_fwd_ipe_f32_kernel<<<grid, tf::THREADS, tf::SMEM_BYTES,
                                   stream>>>(inp, out, n, img, plan, bias, sd,
                                             nfx, nfd, d.k0, d.kd, runs,
                                             ipe_runs);
  else
    fused_mlp_fwd_f32_kernel<<<grid, tf::THREADS, tf::SMEM_BYTES, stream>>>(
        inp, out, n, img, plan, bias, sx, sd, nfx, nfd, a_dim, t_dim, d.k0,
        d.kd, d.kt, has_transient, runs);
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

int launch_sigma(const float* xyz, float* out, int n, const void* image,
                 long long image_bytes, int grid, const float* const* b,
                 const float* sx, int nfx, unsigned long long* runs,
                 cudaStream_t stream) {
  const int k0 = (3 + 6 * nfx + 15) / 16 * 16;
  if (n < 0 || k0 > 128 || nfx > 20) return (int)cudaErrorInvalidValue;
  tf::Plan plan;
  // the wrapper's image must be the one this walk expects
  if (tf::make_sigma_plan(plan, k0) != image_bytes ||
      plan.n_stages > tf::MAX_PLAN)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + tf::ROWS - 1) / tf::ROWS;
  if (grid < (n_tiles ? 1 : 0) || grid > n_tiles)
    return (int)cudaErrorInvalidValue;
  Biases bias = {};
  for (int l = 0; l <= L_FS; ++l) bias.b[l] = b[l];
  cudaError_t err = cudaFuncSetAttribute(
      sigma_trunk_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tf::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  sigma_trunk_f32_kernel<<<grid, tf::THREADS, tf::SMEM_BYTES, stream>>>(
      xyz, out, n, static_cast<const unsigned char*>(image), plan, bias, sx,
      nfx, k0, runs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  b is a host array of device
// pointers to the f32 biases, in the layer order of
// nerf_fl_torch/ops/fused_mlp.py:pack_weights.  The weights come from
// `image` (image_bytes long; fused_mlp.py:weight_image for bfloat16,
// f32_weight_image for float32), and `grid` persistent blocks run
// (fused_mlp.py:fwd_grid).  The kernel adds one to *runs each time it runs
// (a CUDA graph's replays included).  Returns 0 or the cudaError_t of the
// launch.
int nerf_fused_mlp_fwd(int dtype, const float* inp, float* out, int n,
                       const float* const* b, const void* image,
                       long long image_bytes, int grid, const float* sx,
                       const float* sd, int nfx, int nfd, int a_dim, int t_dim,
                       int has_transient, unsigned long long* runs,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(inp, out, n, image, image_bytes, grid, b, sx, sd, nfx,
                       nfd, a_dim, t_dim, has_transient, runs, s);
  if (dtype == 0)
    return launch_f32(inp, out, n, image, image_bytes, grid, b, sx, sd, nfx,
                      nfd, a_dim, t_dim, has_transient, runs, nullptr, s);
  return (int)cudaErrorInvalidValue;
}

// The IPE f32 kernel (mip-NeRF's field): packed (n, 128) f32 rows [mean |
// dir | var | 0] -> (n, 16) f32 pre-activations (rgb in 0..2, density in
// 3).  b: the f32 biases of pack_weights' first 11 layers (ipe=True); the
// weights come from `image` (fused_mlp.py:f32_weight_image of the IPE
// layout), and `grid` persistent blocks run.  nfx: IPE frequencies, nfd:
// the direction's.  The kernel adds one to *runs and to *ipe_runs each
// time it runs.  Returns 0 or the cudaError_t of the launch.
int nerf_fused_ipe_fwd(const float* inp, float* out, int n,
                       const float* const* b, const void* image,
                       long long image_bytes, int grid, const float* sd,
                       int nfx, int nfd, unsigned long long* runs,
                       unsigned long long* ipe_runs, void* stream) {
  return launch_f32(inp, out, n, image, image_bytes, grid, b, nullptr, sd, nfx,
                    nfd, 0, 0, 0, runs, ipe_runs,
                    static_cast<cudaStream_t>(stream));
}

// The sigma-only f32 kernel: (n, 3) f32 positions `xyz` -> (n,) f32 static
// sigma pre-activations.  b is a host array of device pointers to the f32
// biases of the trunk's eight layers and fs2 (pack_weights order); the
// weights come from `image` (image_bytes long; fused_mlp.py:
// f32_sigma_image), and `grid` persistent blocks run.  The kernel adds one
// to *runs each time it runs.  Returns 0 or the cudaError_t of the launch.
int nerf_fused_sigma_fwd(const float* xyz, float* out, int n,
                         const float* const* b, const void* image,
                         long long image_bytes, int grid, const float* sx,
                         int nfx, unsigned long long* runs, void* stream) {
  return launch_sigma(xyz, out, n, image, image_bytes, grid, b, sx, nfx, runs,
                      static_cast<cudaStream_t>(stream));
}

// The kernels' blocks, for reports: out[0] points a block, out[1]
// threads, out[2] shared-memory bytes, out[3] stages in the weight ring;
// bfloat16 in out[0..3], float32 in out[4..7]; out[8] / out[9] the
// consumer warpgroups, bfloat16 / float32.
void nerf_fused_mlp_fwd_info(int* out) {
  out[0] = hop::ROWS;
  out[1] = hop::H_THREADS;
  out[2] = hop::SMEM_BYTES;
  out[3] = hop::STAGES;
  out[4] = tf::ROWS;
  out[5] = tf::THREADS;
  out[6] = tf::SMEM_BYTES;
  out[7] = tf::STAGES;
  out[8] = hop::CONSUMERS;
  out[9] = tf::CONSUMERS;
}

}  // extern "C"
