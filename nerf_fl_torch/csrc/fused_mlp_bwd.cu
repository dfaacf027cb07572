// Fused positional encoding + NeRF-W MLP backward for Hopper (sm_90a).
//
// Replaces nerf_fl_tpu/ops/fused_mlp.py:_bwd_kernel (the Pallas TPU kernel
// behind _fused_bwd).  Given the packed (N, 128) f32 input, the packed
// weights and the (N, 16) f32 cotangent g of the pre-activations, it
// computes the f32 grads of every packed weight slab and bias and the
// (N, 128) f32 cotangent of the packed input:
//   1. recompute the forward (activations and ReLU masks);
//   2. backprop: transient heads -> transient 3..0, rgb head -> dir,
//      fs2 = [d_xyz_final | g], trunk 7..0 with the skip split at layer 4;
//      per layer the cotangent is ReLU-masked (compared in f32), its f32
//      column sums are db, dW = a_in^T g (f32 accumulation) and
//      d_a_in = g W^T is rounded to the compute type;
//   3. the PE chain rule into d_inp: dE = where(trig, cos, 1) * scale *
//      d_pe summed per input component; the appearance and transient
//      columns get their cotangents directly.
//
// What bounds it: recompute + dgrad + wgrad are 3x the forward's MACs
// (684,160 MAC a point with transient heads, 5.4e11 FLOP at the fine pass's
// 131,072 points) against ~0.14 GB of input, cotangent and d_inp: bound by
// operations.  On the TPU one sequential grid carried the dW sum in fast
// memory; here blocks run in no order and a block's 2.8 MB of f32 dW fits
// neither its registers nor its shared memory, so the sum over points is
// the part that has to be designed.
//
// The bf16 path (--compute_dtype bfloat16) is three launches built from
// the Hopper block of fused_mlp_common.cuh:
//   * fused_mlp_bwd_bf16_kernel: persistent blocks of 128 points (two
//     consumer warpgroups of 64 rows, a producer thread behind a three-slab
//     mbarrier ring, as the forward).  It recomputes the forward with the
//     forward kernel's own functions, so activations and ReLU masks are bit
//     for bit the forward's; a thread keeps the ReLU bits of its own
//     accumulator fragments (42 words a tile, in global memory, private to
//     the thread), because the dgrad's accumulators have the same fragment
//     layout.  dgrad is wgmma over tiles of W itself (the weight image holds
//     them beside the forward's W^T tiles: no transposed copy is made in
//     the kernel), the cotangent overwrites its own operand in place, masks,
//     rounding and the f32 column sums for db happen on the accumulator
//     fragments (warp shuffles, one partial row a warp).  Every layer's
//     input activations and masked, rounded cotangents leave through
//     cp.async.bulk stores as 8 KB operand tiles (64 points x 64 columns in
//     the 128-byte swizzle): about 97 tiles x 8 KB per 64 points, 1.6 GB at
//     131,072 points, written once.
//   * wgrad_kernel: dW_l = A_l^T G_l as split-K wgmma over those tiles,
//     both operands read MN-major through the descriptors' transpose bits
//     (a saved tile is K-major for the chain and MN-major here: the swizzle
//     is a function of the address alone).  A block owns 128 input rows of
//     one layer (64 a warpgroup) and all its output columns, one of
//     SPLITS = 16 ranges of the points, accumulators in registers throughout;
//     it writes its part of partial slab s once.  The operand tiles are read
//     once per 128 input rows: 2.5 GB at 131,072 points.
//   * reduce_dw / reduce_db: the 16 partial slabs and the per-warp db rows
//     summed in a fixed order.  No float atomics anywhere: two launches on
//     the same inputs give bitwise-equal results.
// Blocks: 384 threads, 168 registers a thread at launch (232 for consumers
// after setmaxnreg), one block an SM; shared memory 227,120 bytes (fused:
// 2 x 56 KB operand tiles, 3 x 32 KB slabs, 12 KB biases) and 230,464
// bytes (wgrad: 4 stages of 7 tiles).
// Ragged N: rows past N read zero input and zero g, so they add exact
// zeros to dW / db, and write no d_inp.
//
// The f32 path (the CLIs' default --compute_dtype) has the same three
// launches, built from the f32 block of fused_mlp_common.cuh (fused_mlp_fwd.cu
// says why: the products as 3xTF32, hi*hi + lo*hi + hi*lo with each operand
// split into tf32 hi and lo parts, about 2^-21 a product; the activations
// f32 in a thread-private layout, A from registers):
//   * fused_mlp_bwd_f32_kernel: persistent blocks of 64 points, a producer
//     thread behind a three-stage ring of the f32 backward image (hi and
//     lo parts), and two consumer warpgroups that split every product's
//     output columns (a 256-wide layer's 128-column pieces, a 128-wide
//     one's halves of 64), so that one's products run while the other
//     splits its operands or waits for its stage, a thread holds at most
//     64 accumulators, and the next 32 contraction values are loaded while
//     the products of these run (tf::mma_seg); the recompute runs
//     the f32 forward's functions, so activations and ReLU masks are bit
//     for bit the forward kernel's.  Its operands are saved as 16 KB slots of 64
//     points x 64 columns, copies of its private layout: about 97 slots x
//     16 KB per 64 points, 3.2 GB at 131,072 points.  Shared memory 214,832
//     bytes (96 KB activations, 4 KB heads' cotangent, 3 x 32 KB stages,
//     13 KB biases and scale rows), 384 threads, 168 registers a thread at
//     launch (232 for consumers after setmaxnreg);
//   * wgrad_f32_kernel: tf32 wgmma reads its operands K-major only, so each
//     block's 256 threads load a step's slots (32 points, 16-byte loads a
//     step ahead), split them and store the hi and lo K-major images of
//     both operands themselves, two buffers of 100 KB; the products are
//     the SS form, three passes; a block sums W_ROW_BLOCKS row blocks;
//   * reduce_dw_tree / reduce_db_runs / reduce_db_tree: the partial slabs
//     and the per-warp db rows summed in fixed binary trees (cascade), so
//     that a data-parallel rank's power-of-two share of a batch sums bit
//     for bit as one rank's whole batch does.
// Budget and bound are the forward's: the work at 165 TFLOP/s.
//
// mip-NeRF's field (fused_mlp_fwd.cu's IPE note) has an f32 instance of its
// own, fused_mlp_bwd_ipe_f32_kernel (bwd_f32<true>), behind the same wgrad
// kernel and reductions: its recompute takes the IPE and the skip at layer
// 5, and since the Gaussians are no parameters it writes no d_inp and
// leaves out the products that only feed it (tf::make_bwd_plan's
// no_d_inp walk).
#include "fused_mlp_common.cuh"

namespace {

// Per-layer shapes of the packed weights and where their grads live in a
// partial slab: dW (K x N) at off, db (N) at off + K * N.
struct Layout {
  int K[N_LAYERS];
  int N[N_LAYERS];
  long long off[N_LAYERS];
  long long stride;   // floats per partial slab
  int n_layers;
};

// skip: the trunk layer whose input is [encoding | hidden] (4; the IPE
// kernels' 5).
Layout make_layout(int k0, int kd, int kt, int has_transient, int skip = 4) {
  Layout L = {};
  const int shapes[N_LAYERS][2] = {
      {k0, W_TRUNK}, {W_TRUNK, W_TRUNK}, {W_TRUNK, W_TRUNK},
      {W_TRUNK, W_TRUNK}, {W_TRUNK, W_TRUNK}, {W_TRUNK, W_TRUNK},
      {W_TRUNK, W_TRUNK}, {W_TRUNK, W_TRUNK}, {W_TRUNK, FS_OUT},
      {W_TRUNK + kd, W_HALF}, {W_HALF, OUT_LD}, {W_TRUNK + kt, W_HALF},
      {W_HALF, W_HALF}, {W_HALF, W_HALF}, {W_HALF, W_HALF},
      {W_HALF, OUT_LD}};
  L.n_layers = has_transient ? N_LAYERS : L_T0;
  long long at = 0;
  for (int l = 0; l < L.n_layers; ++l) {
    L.K[l] = l == skip ? k0 + W_TRUNK : shapes[l][0];
    L.N[l] = shapes[l][1];
    L.off[l] = at;
    at += (long long)L.K[l] * L.N[l] + L.N[l];
  }
  L.stride = at;
  return L;
}

// ======================================================================
// The bf16 kernels, built from the Hopper block of fused_mlp_common.cuh.
// ======================================================================
namespace hb {

using namespace hop;

constexpr int B_TILES = 7;                   // P0 P1 | H0 .. H3 | GH
constexpr int T_G = 6;                       // the heads' cotangent
constexpr int B_ACT_BYTES = B_TILES * TILE_BYTES;      // 56 KB a warpgroup
constexpr int B_STAGE_BYTES = W_TRUNK * 128;           // 32 KB: 256 image rows
constexpr int MASK_WORDS = 8 * 4 + 2 + 4 * 2;          // ReLU bits a thread
constexpr int M_HD = 32, M_TH = 34;
constexpr int B_SMEM = 1024 + CONSUMERS * B_ACT_BYTES +
                       STAGES * B_STAGE_BYTES + CONST_FLOATS * 4 +
                       2 * STAGES * 8;
constexpr int SPLITS = 16;                   // wgrad: partial sums a layer

struct Biases {
  const float* b[N_LAYERS];
};

// A thread's ReLU bits live in global memory between the recompute and the
// backprop, word w of thread t at base[w * 128 + t]: private to the thread.
template <int W>
__device__ __forceinline__ void put_masks(uint32_t* base, int at,
                                          const uint32_t (&m)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) base[(at + w) * 128] = m[w];
}
template <int W>
__device__ __forceinline__ void get_masks(const uint32_t* base, int at,
                                          uint32_t (&m)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) m[w] = base[(at + w) * 128];
}

// Recompute, dgrad, PE chain rule.  Saves every layer's input activations
// and masked, rounded cotangents as 8 KB operand tiles for the wgrad kernel,
// and per-warp f32 column sums of the cotangents for db.
__global__ void __launch_bounds__(H_THREADS, 1)
fused_mlp_bwd_bf16_kernel(const float* __restrict__ inp,
                          const float* __restrict__ g,
                          float* __restrict__ d_inp, int n,
                          const unsigned char* __restrict__ image,
                          const __grid_constant__ Plan plan,
                          const __grid_constant__ Biases bias,
                          const float* __restrict__ sx,
                          const float* __restrict__ sd, int nfx, int nfd,
                          int a_dim, int t_dim, int k0, int kd, int kt,
                          int has_transient, unsigned char* scratch,
                          const __grid_constant__ TileMap tm,
                          uint32_t* masks, float* dbpart, int db_stride,
                          unsigned long long* runs) {
  count_run(runs);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = smem + CONSUMERS * B_ACT_BYTES;
  float* bias_s = reinterpret_cast<float*>(stages + STAGES * B_STAGE_BYTES);
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
      produce(image, plan, full, empty, smem_u32(stages), B_STAGE_BYTES,
              n_tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = tid & 127, lane = tid & 31, warp = t >> 5;
    const int fr = 16 * warp + (lane >> 2), fq = t & 3;
    const bool elected = t == 0;
    unsigned char* act = smem + wg * B_ACT_BYTES;
    const uint32_t act_s = smem_u32(act);
    const uint32_t tile_p = act_s + T_P * TILE_BYTES;
    const uint32_t tile_h = act_s + T_H * TILE_BYTES;
    const uint32_t tile_g = act_s + T_G * TILE_BYTES;
    Ring ring = {full, empty, smem_u32(stages), B_STAGE_BYTES, 0, 0, -1};
    const int dpe = 3 + 6 * nfd;
    const size_t n_rb = (size_t)n_tiles * CONSUMERS;
    uint32_t* my_masks =
        masks + (size_t)(blockIdx.x * CONSUMERS + wg) * MASK_WORDS * 128 + t;
    float none[8];

    // shared-memory stores -> visible to wgmma and to the bulk stores
    auto sync = [&]() {
      fence_async_smem();
      wg_sync(wg);
    };
    // after this, tiles handed to save() may be overwritten
    auto drain = [&]() {
      if (elected) bulk_wait_read();
      wg_sync(wg);
    };
    auto bf_at = [&](int tile0, int r, int c) {
      return to_f(*reinterpret_cast<const bf16*>(act + act_off(tile0, r, c)));
    };

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const size_t rb = (size_t)tile * CONSUMERS + wg;
      const size_t row0 = rb * WG_ROWS;
      float* dbrow = dbpart + (rb * 4 + warp) * (size_t)db_stride;
      auto save = [&](int id, int cols, int tile0) {
        if (elected)
          save_tiles(scratch, id, (cols + 63) / 64, n_rb, rb,
                     act_s + tile0 * TILE_BYTES);
      };

      // ------------------------------------------------ forward recompute
      drain();
      encode_rows(act, T_P, inp, row0, n, 0, nfx, sx_s, 0, 0, k0, t);
      // the next tile's input rows on their way into L2 meanwhile
      next_rows(inp, row0 + (size_t)gridDim.x * ROWS, n,
                4 * (6 + a_dim + t_dim), t);
      sync();
      save(tm.pe, k0, T_P);

      float acc[W_TRUNK / 2];
      float acc64[W_HALF / 2];
      uint32_t m4[4], m2[2];
      for (int i = 0; i < 8; ++i) {
        bool fresh = true;
        wgmma_fence();
        if (i == 0 || i == 4)
          mma_seg<W_TRUNK, false>(acc, none, tile_p, k0, ring, fresh, elected);
        if (i != 0)
          mma_seg<W_TRUNK, false>(acc, none, tile_h, W_TRUNK, ring, fresh,
                                  elected);
        mma_end(ring, elected);
        fence_acc(acc);
        drain();
        store_hidden_mask<W_TRUNK>(acc, act, T_H, bias_s + bias_off(i), fr, fq,
                                   m4);
        put_masks(my_masks, 4 * i, m4);
        sync();
        save(tm.h[i], W_TRUNK, T_H);
      }
      {
        bool fresh = true;
        wgmma_fence();
        mma_seg<W_TRUNK, false>(acc, none, tile_h, W_TRUNK, ring, fresh,
                                elected);
        mma_end(ring, elected);
        fence_acc(acc);
        drain();
        store_acc<W_TRUNK>(acc, act, T_H, bias_s + bias_off(L_FS), fr, fq,
                           LinearF{});
      }
      encode_rows(act, T_P, inp, row0, n, 3, nfd, sd_s, 6, a_dim, kd, t);
      sync();
      save(tm.xf, W_TRUNK, T_H);
      save(tm.dtail, kd, T_P);
      {
        bool fresh = true;
        wgmma_fence();
        mma_seg<W_HALF, false>(acc64, none, tile_h, W_TRUNK, ring, fresh,
                               elected);
        mma_seg<W_HALF, false>(acc64, none, tile_p, kd, ring, fresh, elected);
        mma_end(ring, elected);
        fence_acc(acc64);
        drain();
        store_hidden_mask<W_HALF>(acc64, act, T_P, bias_s + bias_off(L_DIR),
                                  fr, fq, m2);
        put_masks(my_masks, M_HD, m2);
        sync();
        save(tm.hd, W_HALF, T_P);
      }
      if (has_transient) {
        drain();
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
        sync();
        save(tm.ttail, kt, T_P);
        for (int l = L_T0; l < L_TH; ++l) {
          bool fresh = true;
          wgmma_fence();
          if (l == L_T0) {
            mma_seg<W_HALF, false>(acc64, none, tile_h, W_TRUNK, ring, fresh,
                                   elected);
            mma_seg<W_HALF, false>(acc64, none, tile_p, kt, ring, fresh,
                                   elected);
          } else {
            mma_seg<W_HALF, false>(acc64, none, tile_p, W_HALF, ring, fresh,
                                   elected);
          }
          mma_end(ring, elected);
          fence_acc(acc64);
          drain();
          store_hidden_mask<W_HALF>(acc64, act, T_P, bias_s + bias_off(l), fr,
                                    fq, m2);
          put_masks(my_masks, M_TH + 2 * (l - L_T0), m2);
          sync();
          save(tm.th[l - L_T0], W_HALF, T_P);
        }
      }

      // ------------------------------------------------------- backward
      drain();
      // the heads' cotangent, rounded: GH, columns 0..15
      for (int p = t; p < WG_ROWS * (OUT_LD / 2); p += 128) {
        const int r = p / (OUT_LD / 2), c = 2 * (p % (OUT_LD / 2));
        float2 v = make_float2(0.0f, 0.0f);
        if (row0 + r < (size_t)n)
          v = *reinterpret_cast<const float2*>(g + (row0 + r) * OUT_LD + c);
        *reinterpret_cast<uint32_t*>(act + act_off(T_G, r, c)) =
            pack2(v.x, v.y);
      }
      sync();
      save(tm.gh, OUT_LD, T_G);
      if (lane < OUT_LD) {
        // db of both heads and of fs2's sigma block: GH's column sums
        float s = 0.0f;
        for (int i = 0; i < 16; ++i) s += bf_at(T_G, 16 * warp + i, lane);
        dbrow[bias_off(L_RGB) + lane] = s;
        dbrow[bias_off(L_FS) + W_TRUNK + lane] = s;
        if (has_transient) dbrow[bias_off(L_TH) + lane] = s;
      }

      if (has_transient) {
        // heads -> t3 .. t0: each cotangent masked by its layer's ReLU
        for (int l = L_TH; l > L_T0; --l) {
          bool fresh = true;
          wgmma_fence();
          if (l == L_TH)
            mma_seg<W_HALF, false>(acc64, none, tile_g, OUT_LD, ring, fresh,
                                   elected);
          else
            mma_seg<W_HALF, false>(acc64, none, tile_p, W_HALF, ring, fresh,
                                   elected);
          mma_end(ring, elected);
          fence_acc(acc64);
          drain();
          get_masks(my_masks, M_TH + 2 * (l - 1 - L_T0), m2);
          store_cot<W_HALF, true, false, true>(acc64, act, T_P, m2,
                                               dbrow + bias_off(l - 1), fr, fq,
                                               lane);
          sync();
          save(tm.g[l - 1], W_HALF, T_P);
        }
        // t0: d_xyz_final (transient part) -> H, d_t -> d_inp
        bool fresh = true;
        wgmma_fence();
        mma_seg<W_TRUNK, false>(acc, none, tile_p, W_HALF, ring, fresh,
                                elected);
        mma_end(ring, elected);
        fence_acc(acc);
        store_cot<W_TRUNK, false, false, false>(acc, act, T_H, nullptr,
                                                nullptr, fr, fq, lane);
        fresh = true;
        wgmma_fence();
        mma_seg<W_HALF, false>(acc64, none, tile_p, W_HALF, ring, fresh,
                               elected);
        mma_end(ring, elected);
        fence_acc(acc64);
#pragma unroll
        for (int j = 0; j < W_HALF / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 8 * j + 2 * fq + (i & 1);
            const size_t row = row0 + fr + 8 * (i >> 1);
            if (c < t_dim && row < (size_t)n)
              d_inp[row * IN_LD + 6 + a_dim + c] =
                  to_f(__float2bfloat16_rn(acc64[4 * j + i]));
          }
        }
      }
      // rgb head -> hd's cotangent
      {
        bool fresh = true;
        wgmma_fence();
        mma_seg<W_HALF, false>(acc64, none, tile_g, OUT_LD, ring, fresh,
                               elected);
        mma_end(ring, elected);
        fence_acc(acc64);
        drain();
        get_masks(my_masks, M_HD, m2);
        store_cot<W_HALF, true, false, true>(acc64, act, T_P, m2,
                                             dbrow + bias_off(L_DIR), fr, fq,
                                             lane);
        sync();
        save(tm.g[L_DIR], W_HALF, T_P);
      }
      // dir: d_xyz_final (+ the transient part, one rounding) -> H is fs2's
      // cotangent; then d_tail -> P
      {
        bool fresh = true;
        wgmma_fence();
        mma_seg<W_TRUNK, false>(acc, none, tile_p, W_HALF, ring, fresh,
                                elected);
        mma_end(ring, elected);
        fence_acc(acc);
        if (has_transient)
          store_cot<W_TRUNK, false, true, true>(acc, act, T_H, nullptr,
                                                dbrow + bias_off(L_FS), fr, fq,
                                                lane);
        else
          store_cot<W_TRUNK, false, false, true>(acc, act, T_H, nullptr,
                                                 dbrow + bias_off(L_FS), fr,
                                                 fq, lane);
        fresh = true;
        wgmma_fence();
        mma_seg<W_HALF, false>(acc64, none, tile_p, W_HALF, ring, fresh,
                               elected);
        mma_end(ring, elected);
        fence_acc(acc64);
        drain();
        store_cot<W_HALF, false, false, false>(acc64, act, T_P, nullptr,
                                               nullptr, fr, fq, lane);
        sync();
        save(tm.g[L_FS], W_TRUNK, T_H);
      }
      // d_inp: dir through its PE, appearance directly
      for (int e = t; e < WG_ROWS * (3 + a_dim); e += 128) {
        const int r = e / (3 + a_dim), c = e % (3 + a_dim);
        const size_t row = row0 + r;
        if (row >= (size_t)n) continue;
        if (c < 3)
          d_inp[row * IN_LD + 3 + c] =
              pe_bwd_at(inp[row * IN_LD + 3 + c], c, nfd, sd_s,
                        [&](int col) { return bf_at(T_P, r, col); });
        else
          d_inp[row * IN_LD + 3 + c] = bf_at(T_P, r, dpe + c - 3);
      }
      // fs2 ([d_xyz_final | g]) and the trunk, 7 .. 1: cotangent in place
      for (int l = L_FS; l >= 1; --l) {
        bool fresh = true;
        if (l == 4) {
          // the pe rows of layer 4 first: d_pe's skip part -> P
          wgmma_fence();
          mma_seg<W_HALF, false>(acc64, none, tile_h, W_TRUNK, ring, fresh,
                                 elected);
          mma_end(ring, elected);
          fence_acc(acc64);
          store_cot<W_HALF, false, false, false>(acc64, act, T_P, nullptr,
                                                 nullptr, fr, fq, lane);
          fresh = true;
        }
        wgmma_fence();
        mma_seg<W_TRUNK, false>(acc, none, tile_h, W_TRUNK, ring, fresh,
                                elected);
        if (l == L_FS)
          mma_seg<W_TRUNK, false>(acc, none, tile_g, OUT_LD, ring, fresh,
                                  elected);
        mma_end(ring, elected);
        fence_acc(acc);
        drain();
        get_masks(my_masks, 4 * (l - 1), m4);
        store_cot<W_TRUNK, true, false, true>(acc, act, T_H, m4,
                                              dbrow + bias_off(l - 1), fr, fq,
                                              lane);
        sync();
        save(tm.g[l - 1], W_TRUNK, T_H);
      }
      // layer 0: d_pe = its cotangent + the skip part, one rounding -> P
      {
        bool fresh = true;
        wgmma_fence();
        mma_seg<W_HALF, false>(acc64, none, tile_h, W_TRUNK, ring, fresh,
                               elected);
        mma_end(ring, elected);
        fence_acc(acc64);
        store_cot<W_HALF, false, true, false>(acc64, act, T_P, nullptr,
                                              nullptr, fr, fq, lane);
        wg_sync(wg);
      }
      for (int e = t; e < WG_ROWS * 3; e += 128) {
        const int r = e / 3, c = e % 3;
        const size_t row = row0 + r;
        if (row < (size_t)n)
          d_inp[row * IN_LD + c] =
              pe_bwd_at(inp[row * IN_LD + c], c, nfx, sx_s,
                        [&](int col) { return bf_at(T_P, r, col); });
      }
    }
    if (elected) bulk_wait_read();
  }
}

// ---- wgrad: dW_l = A_l^T G_l over all points, split-K ----

constexpr int W_STAGES = 4;
constexpr int W_G_OFF = 0;                    // up to 4 cotangent tiles
constexpr int W_GH_OFF = 4 * TILE_BYTES;      // the heads' cotangent tile
constexpr int W_A_OFF = 5 * TILE_BYTES;       // one activation tile a warpgroup
constexpr int W_STAGE_BYTES = 7 * TILE_BYTES; // 56 KB
constexpr int W_SMEM = 1024 + W_STAGES * W_STAGE_BYTES + 2 * W_STAGES * 8;
constexpr int MAX_UNITS = 40;

// One block's work: the dW rows of up to two 64-row chunks of one layer's
// input (one a consumer warpgroup), all of the layer's output columns.
struct WUnit {
  int a_tile[2];    // activation tile id of each chunk, -1 for none
  int rows[2];      // real rows of each chunk
  int out_off[2];   // float offset of each chunk's first dW row in a slab
  int g_tile;       // first of the n_g cotangent tiles of 64 columns
  int n_g;          // 4 (N_out 256 or 272), 2 (128) or 0 (a head)
  int gh_tile;      // the heads' cotangent tile, or -1
  int n_out;        // dW's row stride
};
struct WPlan {
  int n_units;
  WUnit u[MAX_UNITS];
};

template <int N, bool GH>
__device__ __forceinline__ void wgrad_consume(
    const WUnit& u, int w, uint32_t full, uint32_t empty, uint32_t buf,
    int n_steps, float* out, int t) {
  constexpr int NA = N > 0 ? N / 2 : 1;
  float acc[NA];
  float sig[8];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) sig[i] = 0.0f;
  const bool work = u.a_tile[w] >= 0;
  const bool elected = t == 0;
  int stage = 0, pending = -1;
  uint32_t phase = 0;
  wgmma_fence();
  for (int s = 0; s < n_steps; ++s) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t base = buf + stage * W_STAGE_BYTES;
    const uint32_t a = base + W_A_OFF + w * TILE_BYTES;
    if (work) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // both operands MN-major: 16 points are two 8-row groups 1024 bytes
        // apart, 64-column tiles 8192 bytes apart
        const uint64_t da = sdesc(a + 2048 * kk, TILE_BYTES, 1024);
        if constexpr (N > 0)
          Wgmma<(N > 0 ? N : 16)>::template run<1, 1>(
              acc, da, sdesc(base + W_G_OFF + 2048 * kk, TILE_BYTES, 1024), 1);
        if constexpr (GH)
          Wgmma<16>::template run<1, 1>(
              sig, da, sdesc(base + W_GH_OFF + 2048 * kk, TILE_BYTES, 1024),
              1);
      }
    }
    wgmma_commit();
    if (pending >= 0) {
      wgmma_wait<1>();
      if (elected) mbar_arrive(empty + 8 * pending);
    }
    pending = stage;
    if (++stage == W_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  if (pending >= 0 && elected) mbar_arrive(empty + 8 * pending);
  fence_acc(acc);
  fence_acc(sig);
  if (!work) return;
  const int r = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
  float* dst = out + u.out_off[w];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r + 8 * h;
    if (m < u.rows[w]) {
      if constexpr (N > 0) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          *reinterpret_cast<float2*>(dst + (size_t)m * u.n_out + 8 * j + 2 * q) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      if constexpr (GH) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float2*>(dst + (size_t)m * u.n_out + N + 8 * j +
                                     2 * q) =
              make_float2(sig[4 * j + 2 * h], sig[4 * j + 2 * h + 1]);
      }
    }
  }
}

// grid (units, splits): block (u, s) sums unit u over the row blocks
// [s * per, (s + 1) * per) and writes its part of partial slab s.
__global__ void __launch_bounds__(H_THREADS, 1)
wgrad_kernel(const unsigned char* __restrict__ scratch,
             const __grid_constant__ WPlan wp, int n_rb, int per,
             float* __restrict__ partial, long long stride) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t buf = smem_u32(smem);
  const uint32_t full = buf + W_STAGES * W_STAGE_BYTES;
  const uint32_t empty = full + 8 * W_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_smem();
  }
  __syncthreads();
  const WUnit& u = wp.u[blockIdx.x];
  const int rb0 = blockIdx.y * per;
  const int n_steps = max(0, min(per, n_rb - rb0));
  const int wg = tid >> 7;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS * 128) {
      const int n_a = u.a_tile[1] >= 0 ? 2 : 1;
      const uint32_t bytes =
          (u.n_g + (u.gh_tile >= 0 ? 1 : 0) + n_a) * TILE_BYTES;
      int stage = 0;
      uint32_t phase = 1;
      for (int s = 0; s < n_steps; ++s) {
        const size_t rb = rb0 + s;
        auto src = [&](int tile) {
          return scratch + ((size_t)tile * n_rb + rb) * TILE_BYTES;
        };
        mbar_wait(empty + 8 * stage, phase);
        mbar_expect_tx(full + 8 * stage, bytes);
        const uint32_t base = buf + stage * W_STAGE_BYTES;
        for (int i = 0; i < u.n_g; ++i)
          bulk_g2s(base + W_G_OFF + i * TILE_BYTES, src(u.g_tile + i),
                   TILE_BYTES, full + 8 * stage);
        if (u.gh_tile >= 0)
          bulk_g2s(base + W_GH_OFF, src(u.gh_tile), TILE_BYTES,
                   full + 8 * stage);
        for (int i = 0; i < n_a; ++i)
          bulk_g2s(base + W_A_OFF + i * TILE_BYTES, src(u.a_tile[i]),
                   TILE_BYTES, full + 8 * stage);
        if (++stage == W_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float* out = partial + (size_t)blockIdx.y * stride;
    const int t = tid & 127;
    if (u.n_g == 4 && u.gh_tile >= 0)
      wgrad_consume<W_TRUNK, true>(u, wg, full, empty, buf, n_steps, out, t);
    else if (u.n_g == 4)
      wgrad_consume<W_TRUNK, false>(u, wg, full, empty, buf, n_steps, out, t);
    else if (u.n_g == 2)
      wgrad_consume<W_HALF, false>(u, wg, full, empty, buf, n_steps, out, t);
    else
      wgrad_consume<0, true>(u, wg, full, empty, buf, n_steps, out, t);
  }
}

// grads[e] = partial[0][e] + partial[1][e] + ..., in that order (the db
// entries are overwritten by reduce_db).
__global__ void reduce_dw(const float* __restrict__ partial,
                          float* __restrict__ grads, long long stride,
                          int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < stride; e += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int p = 0; p < splits; ++p) s += partial[(size_t)p * stride + e];
    grads[e] = s;
  }
}

// db: column c of the (rows, db_stride) per-warp sums.  Thread (seg, col)
// adds rows seg, seg + 32, ... in order; the 32 segments are then added in
// order.
struct DbMap {
  int n_layers;
  int col0[N_LAYERS + 1];      // first column of each layer's db
  long long dst[N_LAYERS];     // where that layer's db starts in grads
};

__global__ void reduce_db(const float* __restrict__ dbpart, int rows,
                          int db_stride, const __grid_constant__ DbMap map,
                          float* __restrict__ grads) {
  __shared__ float part[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x, seg = threadIdx.y;
  float s = 0.0f;
  if (col < db_stride)
    for (int r = seg; r < rows; r += 32)
      s += dbpart[(size_t)r * db_stride + col];
  part[seg][threadIdx.x] = s;
  __syncthreads();
  if (seg == 0 && col < db_stride) {
    float total = 0.0f;
    for (int i = 0; i < 32; ++i) total += part[i][threadIdx.x];
    int l = 0;
    while (col >= map.col0[l + 1]) ++l;
    grads[map.dst[l] + col - map.col0[l]] = total;
  }
}

}  // namespace hb

// ======================================================================
// The f32 kernels, built from the f32 block of fused_mlp_common.cuh.
// ======================================================================
namespace tb {

// Recompute, dgrad, PE chain rule, as fused_mlp_bwd_bf16_kernel with 64
// points a block in the f32 private layout, computed by two consumer
// warpgroups (tf::CONSUMERS) that split every product's output columns
// (tf::mma_seg): warpgroup wg writes its share of each layer's
// columns, its ReLU bits, cotangent masks and db column sums, so the
// activations, saved slots, dW and db are those of one warpgroup computing
// all columns, each column the same products in the same order.  A layer's
// output overwrites its input in place, so a barrier over the 256 consumer
// threads sits between a layer's products and its epilogue, and between
// the epilogue and the next layer's products.
// Saves every layer's input activations and masked cotangents as tile
// slots of 64 points x 64 columns (16 KB, the private layout's groups) for
// the wgrad kernel, and per-warp f32 column sums of the cotangents for db.
// MIP: the IPE instance (fused_mlp_bwd_ipe_f32_kernel), the backward of
// fused_mlp_fwd.cu's fused_mlp_fwd_ipe_f32_kernel: its recompute takes the
// IPE and the skip at layer 5, and it computes no input cotangent (the
// Gaussians are no parameters), so it leaves out the products that feed
// only d_inp (dir -> d_tail, the skip layer's and layer 0's encoding
// rows) and writes no d_inp.  The wgrad kernel and the reductions are the
// f32 backward's, on its saved slots.
template <bool MIP>
__device__ __forceinline__ void bwd_f32(const float* __restrict__ inp,
                                        const float* __restrict__ g,
                                        float* __restrict__ d_inp, int n,
                                        const unsigned char* __restrict__ image,
                                        const tf::Plan& plan,
                                        const hb::Biases& bias,
                                        const float* __restrict__ sx,
                                        const float* __restrict__ sd, int nfx,
                                        int nfd, int a_dim, int t_dim, int k0,
                                        int kd, int kt, int has_transient,
                                        unsigned char* scratch,
                                        const hop::TileMap& tm,
                                        uint32_t* masks, float* dbpart,
                                        int db_stride) {
  using tf::G_G;
  using tf::G_H;
  using tf::G_P;
  constexpr int SKIP = MIP ? 5 : 4;
  constexpr int C = tf::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  float4* act = reinterpret_cast<float4*>(smem);
  const float* act_f = reinterpret_cast<const float*>(smem);
  unsigned char* stages = smem + tf::ACT_BYTES + tf::G_BYTES;
  float* bias_s =
      reinterpret_cast<float*>(stages + tf::STAGES * tf::B_STAGE_BYTES);
  float* sx_s = bias_s + hop::BIAS_FLOATS;
  float* sd_s = sx_s + IN_LD;
  const uint32_t full = hop::smem_u32(bias_s + hop::CONST_FLOATS);
  const uint32_t empty = full + 8 * tf::STAGES;

  const int tid = threadIdx.x;
  const int n_layers = has_transient ? N_LAYERS : L_T0;
  for (int c = tid; c < IN_LD; c += tf::THREADS) {
    sx_s[c] = sx[c];
    sd_s[c] = sd[c];
  }
  for (int l = 0; l < n_layers; ++l)
    for (int c = tid; c < hop::layer_n(l); c += tf::THREADS)
      bias_s[hop::bias_off(l) + c] = bias.b[l][c];
  if (tid == 0) {
    for (int s = 0; s < tf::STAGES; ++s) {
      hop::mbar_init(full + 8 * s, 1);
      hop::mbar_init(empty + 8 * s, tf::RELEASES);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    hop::fence_async_smem();
  }
  __syncthreads();

  const int wg = tid >> 7;
  const int n_tiles = (n + tf::ROWS - 1) / tf::ROWS;
  if (wg == C) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == C * 128)
      tf::produce(image, plan, full, empty, hop::smem_u32(stages),
                  tf::B_STAGE_BYTES, n_tiles);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = tid & 127, lane = tid & 31, warp = t >> 5;
  const int fr = 16 * warp + (lane >> 2), fq = t & 3;
  const bool elected = t == 0;
  const uint32_t act_s = hop::smem_u32(smem);
  tf::Ring ring = {full, empty, hop::smem_u32(stages), tf::B_STAGE_BYTES, 0,
                   0, -1};
  const int dpe = 3 + 6 * nfd;
  const size_t n_rb = (size_t)n_tiles;
  // ReLU bits, each warpgroup's own words of a layer (hb::MASK_WORDS)
  uint32_t* my_masks = masks + (size_t)blockIdx.x * hb::MASK_WORDS * 128 + t;
  constexpr int W4 = W_TRUNK / 64 / C, W2 = W_HALF / 64 / C;
  float none[8];

  // shared-memory stores -> visible to the bulk stores and other threads
  auto sync = [&]() {
    hop::fence_async_smem();
    tf::consumer_sync();
  };
  // after this, regions handed to save() may be overwritten
  auto drain = [&]() {
    if (elected) hop::bulk_wait_read();
    tf::consumer_sync();
  };
  auto val = [&](int g0, int r, int c) { return act_f[tf::at(g0, r, c)]; };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t rb = (size_t)tile;
    const size_t row0 = rb * tf::ROWS;
    float* dbrow = dbpart + (rb * 4 + warp) * (size_t)db_stride;
    auto save = [&](int id, int cols, int g0) {
      if (elected)
        tf::save(scratch, id, cols, n_rb, rb, act_s + g0 * tf::GROUP_BYTES, wg);
    };

    // ------------------------------------------------ forward recompute
    drain();
    if constexpr (MIP) {
      tf::encode_ipe(act, G_P, inp, row0, n, nfx, k0, t, wg);
      if (wg == 0)
        hop::next_rows(inp, row0 + (size_t)gridDim.x * tf::ROWS, n, 4 * 9,
                       t);
    } else {
      tf::encode(act, G_P, inp, row0, n, true, 0, nfx, sx_s, 0, 0, k0, t, wg);
      if (wg == 0)
        hop::next_rows(inp, row0 + (size_t)gridDim.x * tf::ROWS, n,
                       4 * (6 + a_dim + t_dim), t);
    }
    sync();
    save(tm.pe, k0, G_P);

    float acc[W_TRUNK / 2 / C];
    float acc64[W_HALF / 2 / C];
    uint32_t m4[W4], m2[W2];
    for (int i = 0; i < 8; ++i) {
      bool fresh = true;
      if (i == 0 || i == SKIP)
        tf::mma_seg<W_TRUNK>(acc, none, act, G_P, k0, ring, fresh, t, wg);
      if (i != 0)
        tf::mma_seg<W_TRUNK>(acc, none, act, G_H, W_TRUNK, ring, fresh, t, wg);
      drain();
      tf::store_hidden<W_TRUNK, true>(acc, act, G_H, bias_s + hop::bias_off(i),
                                      fq, t, m4, wg);
      hb::put_masks(my_masks, 4 * i + W4 * wg, m4);
      sync();
      save(tm.h[i], W_TRUNK, G_H);
    }
    {
      bool fresh = true;
      tf::mma_seg<W_TRUNK>(acc, none, act, G_H, W_TRUNK, ring, fresh, t, wg);
      drain();
      tf::store_linear<W_TRUNK>(acc, act, G_H, bias_s + hop::bias_off(L_FS), fq,
                                t, wg);
    }
    tf::encode(act, G_P, inp, row0, n, true, 3, nfd, sd_s, 6, a_dim, kd, t, wg);
    sync();
    save(tm.xf, W_TRUNK, G_H);
    save(tm.dtail, kd, G_P);
    {
      bool fresh = true;
      tf::mma_seg<W_HALF>(acc64, none, act, G_H, W_TRUNK, ring, fresh, t, wg);
      tf::mma_seg<W_HALF>(acc64, none, act, G_P, kd, ring, fresh, t, wg);
      drain();
      tf::store_hidden<W_HALF, true>(acc64, act, G_P,
                                     bias_s + hop::bias_off(L_DIR), fq, t, m2,
                                     wg);
      hb::put_masks(my_masks, hb::M_HD + W2 * wg, m2);
      sync();
      save(tm.hd, W_HALF, G_P);
    }
    if (!MIP && has_transient) {
      drain();
      tf::encode(act, G_P, inp, row0, n, false, 0, 0, sd_s, 6 + a_dim, t_dim,
                 kt, t, wg);
      sync();
      save(tm.ttail, kt, G_P);
      for (int l = L_T0; l < L_TH; ++l) {
        bool fresh = true;
        if (l == L_T0) {
          tf::mma_seg<W_HALF>(acc64, none, act, G_H, W_TRUNK, ring, fresh, t,
                              wg);
          tf::mma_seg<W_HALF>(acc64, none, act, G_P, kt, ring, fresh, t, wg);
        } else {
          tf::mma_seg<W_HALF>(acc64, none, act, G_P, W_HALF, ring, fresh, t,
                              wg);
        }
        drain();
        tf::store_hidden<W_HALF, true>(acc64, act, G_P,
                                       bias_s + hop::bias_off(l), fq, t, m2,
                                       wg);
        hb::put_masks(my_masks, hb::M_TH + 2 * (l - L_T0) + W2 * wg, m2);
        sync();
        save(tm.th[l - L_T0], W_HALF, G_P);
      }
    }

    // ------------------------------------------------------- backward
    drain();
    // the heads' cotangent -> G: this thread's own two rows, warpgroup wg's
    // 8-column group
    {
      float2 v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = row0 + fr + 8 * h;
        v[h] = row < (size_t)n ? *reinterpret_cast<const float2*>(
                                     g + row * OUT_LD + 8 * wg + 2 * fq)
                               : make_float2(0.0f, 0.0f);
      }
      act[(G_G + wg) * tf::GROUP + t] =
          make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
    }
    sync();
    save(tm.gh, OUT_LD, G_G);
    if (wg == 0 && lane < OUT_LD) {
      // db of both heads and of fs2's sigma block: G's column sums
      float s = 0.0f;
      for (int i = 0; i < 16; ++i) s += val(G_G, 16 * warp + i, lane);
      dbrow[hop::bias_off(L_RGB) + lane] = s;
      dbrow[hop::bias_off(L_FS) + W_TRUNK + lane] = s;
      if (has_transient) dbrow[hop::bias_off(L_TH) + lane] = s;
    }

    if (!MIP && has_transient) {
      // heads -> t3 .. t0: each cotangent masked by its layer's ReLU
      for (int l = L_TH; l > L_T0; --l) {
        bool fresh = true;
        if (l == L_TH)
          tf::mma_seg<W_HALF>(acc64, none, act, G_G, OUT_LD, ring, fresh, t,
                              wg);
        else
          tf::mma_seg<W_HALF>(acc64, none, act, G_P, W_HALF, ring, fresh, t,
                              wg);
        drain();
        hb::get_masks(my_masks, hb::M_TH + 2 * (l - 1 - L_T0) + W2 * wg, m2);
        tf::store_cot<W_HALF, true, false, true>(acc64, act, G_P, m2,
                                                 dbrow + hop::bias_off(l - 1),
                                                 fq, t, lane, wg);
        sync();
        save(tm.g[l - 1], W_HALF, G_P);
      }
      // t0: d_xyz_final (transient part) -> H, d_t -> d_inp
      bool fresh = true;
      tf::mma_seg<W_TRUNK>(acc, none, act, G_P, W_HALF, ring, fresh, t, wg);
      tf::store_cot<W_TRUNK, false, false, false>(acc, act, G_H, nullptr,
                                                  nullptr, fq, t, lane, wg);
      fresh = true;
      tf::mma_seg<W_HALF>(acc64, none, act, G_P, W_HALF, ring, fresh, t, wg);
#pragma unroll
      for (int j = 0; j < W_HALF / C / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = W_HALF / C * wg + 8 * j + 2 * fq + (i & 1);
          const size_t row = row0 + fr + 8 * (i >> 1);
          if (c < t_dim && row < (size_t)n)
            d_inp[row * IN_LD + 6 + a_dim + c] = acc64[4 * j + i];
        }
      }
    }
    // rgb head -> hd's cotangent
    {
      bool fresh = true;
      tf::mma_seg<W_HALF>(acc64, none, act, G_G, OUT_LD, ring, fresh, t, wg);
      drain();
      hb::get_masks(my_masks, hb::M_HD + W2 * wg, m2);
      tf::store_cot<W_HALF, true, false, true>(acc64, act, G_P, m2,
                                               dbrow + hop::bias_off(L_DIR), fq,
                                               t, lane, wg);
      sync();
      save(tm.g[L_DIR], W_HALF, G_P);
    }
    // dir: d_xyz_final (+ the transient part) -> H is fs2's cotangent; then
    // d_tail -> P
    {
      bool fresh = true;
      tf::mma_seg<W_TRUNK>(acc, none, act, G_P, W_HALF, ring, fresh, t, wg);
      if (has_transient)
        tf::store_cot<W_TRUNK, false, true, true>(acc, act, G_H, nullptr,
                                                  dbrow + hop::bias_off(L_FS),
                                                  fq, t, lane, wg);
      else
        tf::store_cot<W_TRUNK, false, false, true>(acc, act, G_H, nullptr,
                                                   dbrow + hop::bias_off(L_FS),
                                                   fq, t, lane, wg);
      if constexpr (!MIP) {
        fresh = true;
        tf::mma_seg<W_HALF>(acc64, none, act, G_P, W_HALF, ring, fresh, t, wg);
      }
      drain();
      if constexpr (!MIP)
        tf::store_cot<W_HALF, false, false, false>(acc64, act, G_P, nullptr,
                                                   nullptr, fq, t, lane, wg);
      sync();
      save(tm.g[L_FS], W_TRUNK, G_H);
    }
    // d_inp: dir through its PE, appearance directly
    for (int e = tid; !MIP && e < tf::ROWS * (3 + a_dim); e += 128 * C) {
      const int r = e / (3 + a_dim), c = e % (3 + a_dim);
      const size_t row = row0 + r;
      if (row >= (size_t)n) continue;
      if (c < 3)
        d_inp[row * IN_LD + 3 + c] =
            hop::pe_bwd_at(inp[row * IN_LD + 3 + c], c, nfd, sd_s,
                           [&](int col) { return val(G_P, r, col); });
      else
        d_inp[row * IN_LD + 3 + c] = val(G_P, r, dpe + c - 3);
    }
    // fs2 ([d_xyz_final | g]) and the trunk, 7 .. 1: cotangent in place
    for (int l = L_FS; l >= 1; --l) {
      bool fresh = true;
      if (!MIP && l == 4) {
        // the pe rows of layer 4 first: d_pe's skip part -> P
        tf::mma_seg<W_HALF>(acc64, none, act, G_H, W_TRUNK, ring, fresh, t, wg);
        tf::store_cot<W_HALF, false, false, false>(acc64, act, G_P, nullptr,
                                                   nullptr, fq, t, lane, wg);
        fresh = true;
      }
      tf::mma_seg<W_TRUNK>(acc, none, act, G_H, W_TRUNK, ring, fresh, t, wg);
      if (l == L_FS)
        tf::mma_seg<W_TRUNK>(acc, none, act, G_G, OUT_LD, ring, fresh, t, wg);
      drain();
      hb::get_masks(my_masks, 4 * (l - 1) + W4 * wg, m4);
      tf::store_cot<W_TRUNK, true, false, true>(acc, act, G_H, m4,
                                                dbrow + hop::bias_off(l - 1),
                                                fq, t, lane, wg);
      sync();
      save(tm.g[l - 1], W_TRUNK, G_H);
    }
    // layer 0: d_pe = its cotangent + the skip part -> P
    if constexpr (!MIP) {
      bool fresh = true;
      tf::mma_seg<W_HALF>(acc64, none, act, G_H, W_TRUNK, ring, fresh, t, wg);
      tf::store_cot<W_HALF, false, true, false>(acc64, act, G_P, nullptr,
                                                nullptr, fq, t, lane, wg);
      tf::consumer_sync();
    }
    for (int e = tid; !MIP && e < tf::ROWS * 3; e += 128 * C) {
      const int r = e / 3, c = e % 3;
      const size_t row = row0 + r;
      if (row < (size_t)n)
        d_inp[row * IN_LD + c] =
            hop::pe_bwd_at(inp[row * IN_LD + c], c, nfx, sx_s,
                           [&](int col) { return val(G_P, r, col); });
    }
  }
  if (elected) hop::bulk_wait_read();
}

__global__ void __launch_bounds__(tf::THREADS, 1)
fused_mlp_bwd_f32_kernel(const float* __restrict__ inp,
                         const float* __restrict__ g,
                         float* __restrict__ d_inp, int n,
                         const unsigned char* __restrict__ image,
                         const __grid_constant__ tf::Plan plan,
                         const __grid_constant__ hb::Biases bias,
                         const float* __restrict__ sx,
                         const float* __restrict__ sd, int nfx, int nfd,
                         int a_dim, int t_dim, int k0, int kd, int kt,
                         int has_transient, unsigned char* scratch,
                         const __grid_constant__ hop::TileMap tm,
                         uint32_t* masks, float* dbpart, int db_stride,
                         unsigned long long* runs) {
  count_run(runs);
  bwd_f32<false>(inp, g, d_inp, n, image, plan, bias, sx, sd, nfx, nfd,
                 a_dim, t_dim, k0, kd, kt, has_transient, scratch, tm, masks,
                 dbpart, db_stride);
}

__global__ void __launch_bounds__(tf::THREADS, 1)
fused_mlp_bwd_ipe_f32_kernel(const float* __restrict__ inp,
                             const float* __restrict__ g, int n,
                             const unsigned char* __restrict__ image,
                             const __grid_constant__ tf::Plan plan,
                             const __grid_constant__ hb::Biases bias,
                             const float* __restrict__ sd, int nfx, int nfd,
                             int k0, int kd, unsigned char* scratch,
                             const __grid_constant__ hop::TileMap tm,
                             uint32_t* masks, float* dbpart, int db_stride,
                             unsigned long long* runs,
                             unsigned long long* ipe_runs) {
  count_run(runs);
  count_run(ipe_runs);
  bwd_f32<true>(inp, g, nullptr, n, image, plan, bias, sd, sd, nfx, nfd, 0,
                0, k0, kd, 0, 0, scratch, tm, masks, dbpart, db_stride);
}

// ---- wgrad: dW_l = A_l^T G_l over all points, split-K, 3xTF32 ----
// A block of two consumer warpgroups (no producer) takes a unit of
// make_wplan (up to two 64-row chunks of a layer's input, one a warpgroup,
// and all the layer's output columns) over a range of row blocks, 32
// points a step.  tf32 wgmma reads both operands K-major only, and the
// saved slots are in the fused kernel's private layout, so the threads
// themselves load a step's slots (16-byte loads, a step ahead, into
// registers), split them and store the hi and lo K-major images (rows:
// the chunks' input columns, the cotangent's output columns with the
// heads' block at row 256; 32 points a 128-byte row, swizzled); two
// buffers, so a step's stores overlap the previous step's products.
constexpr int W_A_ROWS = 128;                    // image rows of the chunks
constexpr int W_G_ROWS = W_TRUNK + OUT_LD;       // image rows of the cotangent
constexpr int W_HI = (W_A_ROWS + W_G_ROWS) * 128;   // hi images: 50 KB
constexpr int W_BUF = 2 * W_HI;                  // hi, then lo
constexpr int W_SMEM = 1024 + 2 * W_BUF;
constexpr int W_THREADS = 256;
// Row blocks (64 points each) a wgrad block sums.  A sum that stays in one
// wgmma accumulator for thousands of points drifts from the plain
// version's: with 4,416 points a block (16 splits of 70,001) one dW came
// out 1.35e-4 of its largest off on the card and the others up to 4e-5,
// against at most 1.1e-5 for the db sums, which are f32 adds
// (chip_smoke.py phase 5).  Shorter chains, and more partial slabs for
// reduce_dw to add in f32.
constexpr int W_ROW_BLOCKS = 16;

// Byte offset of (image row, contraction index k < 32) in a K-major
// 128-byte-swizzled image.
__device__ __forceinline__ uint32_t kmaj(int row, int k) {
  return row * 128 + ((((k >> 2) ^ (row & 7)) << 4) | ((k & 3) << 2));
}

// One float4 of a saved slot (thread tp < 64 of a 32-point half, group at
// image row row0) split into the hi and lo images at b: its points p and
// p + 8, columns row0 + 2 (tp % 4) and + 1.
__device__ __forceinline__ void put_split(unsigned char* b, int row0, int tp,
                                          float4 v) {
  const int p = 16 * (tp >> 5) + ((tp & 31) >> 2);
  const int c = row0 + 2 * (tp & 3);
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t hi, lo;
    tf::split(e[i], hi, lo);
    const uint32_t o = kmaj(c + (i & 1), p + 8 * (i >> 1));
    *reinterpret_cast<uint32_t*>(b + o) = hi;
    *reinterpret_cast<uint32_t*>(b + W_HI + o) = lo;
  }
}

template <int N, bool GH>
__device__ __forceinline__ void wgrad_f32(const hb::WUnit& u,
                                          const unsigned char* scratch,
                                          int n_rb, int rb0, int steps,
                                          unsigned char* smem, float* out) {
  constexpr int NA = N > 0 ? N / 2 : 1;
  constexpr int NG = N / 64;                     // cotangent slots
  constexpr int NV = 4 + 2 * NG + (GH ? 1 : 0);  // float4s a thread a step
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const bool work = u.a_tile[wg] >= 0;
  float acc[NA];
  float sig[8];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) sig[i] = 0.0f;
  float4 v[NV];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // item e < 512 of slot `slot` in step s: group e / 64, thread 64 z + e % 64
  auto src = [&](int slot, int s, int e) {
    const size_t rb = (size_t)rb0 + (s >> 1);
    return __ldg(reinterpret_cast<const float4*>(
                     scratch + ((size_t)slot * n_rb + rb) * tf::SLOT_BYTES) +
                 (e >> 6) * tf::GROUP + 64 * (s & 1) + (e & 63));
  };
  auto load = [&](int s) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = i * W_THREADS + tid;
        v[2 * c + i] = u.a_tile[c] >= 0 && (e >> 6) < (u.rows[c] + 7) / 8
                           ? src(u.a_tile[c], s, e)
                           : zero;
      }
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        v[4 + 2 * j + i] = src(u.g_tile + j, s, i * W_THREADS + tid);
    if constexpr (GH) v[NV - 1] = tid < 128 ? src(u.gh_tile, s, tid) : zero;
  };
  auto store = [&](unsigned char* b) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = i * W_THREADS + tid;
        put_split(b, 64 * c + 8 * (e >> 6), e & 63, v[2 * c + i]);
      }
    unsigned char* gb = b + W_A_ROWS * 128;
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = i * W_THREADS + tid;
        put_split(gb, 64 * j + 8 * (e >> 6), e & 63, v[4 + 2 * j + i]);
      }
    if constexpr (GH)
      if (tid < 128) put_split(gb, W_TRUNK + 8 * (tid >> 6), tid & 63,
                               v[NV - 1]);
  };

  const uint32_t base = hop::smem_u32(smem);
  if (steps > 0) load(0);
  for (int s = 0; s < steps; ++s) {
    // the products of step s - 2 have read this buffer in both warpgroups
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    store(smem + (s & 1) * W_BUF);
    hop::fence_async_smem();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (s + 1 < steps) load(s + 1);
    if (work) {
      const uint32_t a = base + (s & 1) * W_BUF + wg * 64 * 128;
      const uint32_t gb = base + (s & 1) * W_BUF + W_A_ROWS * 128;
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t ah = hop::kdesc(a + 32 * kk);
        const uint64_t al = hop::kdesc(a + W_HI + 32 * kk);
        if constexpr (N > 0) {
          const uint64_t bh = hop::kdesc(gb + 32 * kk);
          const uint64_t bl = hop::kdesc(gb + W_HI + 32 * kk);
          tf::WgmmaSS<(N > 0 ? N : 16)>::run(acc, ah, bh);
          tf::WgmmaSS<(N > 0 ? N : 16)>::run(acc, al, bh);
          tf::WgmmaSS<(N > 0 ? N : 16)>::run(acc, ah, bl);
        }
        if constexpr (GH) {
          const uint32_t o = W_TRUNK * 128 + 32 * kk;
          tf::WgmmaSS<16>::run(sig, ah, hop::kdesc(gb + o));
          tf::WgmmaSS<16>::run(sig, al, hop::kdesc(gb + o));
          tf::WgmmaSS<16>::run(sig, ah, hop::kdesc(gb + W_HI + o));
        }
      }
      hop::wgmma_commit();
    }
    hop::wgmma_wait<1>();
  }
  hop::wgmma_wait<0>();
  hop::fence_acc(acc);
  hop::fence_acc(sig);
  if (!work) return;
  const int r = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
  float* dst = out + u.out_off[wg];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r + 8 * h;
    if (m < u.rows[wg]) {
      if constexpr (N > 0) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          *reinterpret_cast<float2*>(dst + (size_t)m * u.n_out + 8 * j + 2 * q) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      if constexpr (GH) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float2*>(dst + (size_t)m * u.n_out + N + 8 * j +
                                     2 * q) =
              make_float2(sig[4 * j + 2 * h], sig[4 * j + 2 * h + 1]);
      }
    }
  }
}

// grid (units, splits): block (u, s) sums unit u over the row blocks
// [s * per, (s + 1) * per) and writes its part of partial slab s.
__global__ void __launch_bounds__(W_THREADS, 1)
wgrad_f32_kernel(const unsigned char* __restrict__ scratch,
                 const __grid_constant__ hb::WPlan wp, int n_rb, int per,
                 float* __restrict__ partial, long long stride) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const hb::WUnit& u = wp.u[blockIdx.x];
  const int rb0 = blockIdx.y * per;
  const int steps = 2 * max(0, min(per, n_rb - rb0));
  float* out = partial + (size_t)blockIdx.y * stride;
  if (u.n_g == 4 && u.gh_tile >= 0)
    wgrad_f32<W_TRUNK, true>(u, scratch, n_rb, rb0, steps, smem, out);
  else if (u.n_g == 4)
    wgrad_f32<W_TRUNK, false>(u, scratch, n_rb, rb0, steps, smem, out);
  else if (u.n_g == 2)
    wgrad_f32<W_HALF, false>(u, scratch, n_rb, rb0, steps, smem, out);
  else
    wgrad_f32<0, true>(u, scratch, n_rb, rb0, steps, smem, out);
}

// Sums in a fixed tree: cascade(n, v) adds v(0), v(1), ... as a binary
// counter adds ones, neighbours first, then neighbouring pairs, so the sum
// over an aligned run of 2^k values is a subtree of the whole sum.  A
// data-parallel rank whose row blocks are such a run (each rank a
// power-of-two share of a batch) sums its share as the same subtree of one
// rank's sum of the whole batch, where sums taken in order would part from
// it by one rounding at each step.
template <typename V>
__device__ __forceinline__ float cascade(int n, V v) {
  float stack[32];
  int depth = 0;
  for (int i = 0; i < n; ++i) {
    float x = v(i);
    for (int c = i; c & 1; c >>= 1) x = stack[--depth] + x;
    stack[depth++] = x;
  }
  float s = 0.0f;
  if (depth > 0) s = stack[--depth];
  while (depth > 0) s = stack[--depth] + s;
  return s;
}

// grads[e] = the cascade over the partial slabs p = 0, 1, ... of
// partial[p][e] (the db entries are overwritten by reduce_db_tree).
__global__ void reduce_dw_tree(const float* __restrict__ partial,
                               float* __restrict__ grads, long long stride,
                               int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < stride; e += (long long)gridDim.x * blockDim.x)
    grads[e] = cascade(
        splits, [&](int p) { return partial[(size_t)p * stride + e]; });
}

// db in two levels: block (x, run) sums rows [run * DB_RUN, +DB_RUN) of
// the per-warp db rows for its columns, then each column's runs in order.
constexpr int DB_RUN = 256;

__global__ void reduce_db_runs(const float* __restrict__ dbpart, int rows,
                               int db_stride, float* __restrict__ runs) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= db_stride) return;
  const int r0 = blockIdx.y * DB_RUN;
  runs[(size_t)blockIdx.y * db_stride + col] =
      cascade(min(DB_RUN, rows - r0), [&](int i) {
        return dbpart[(size_t)(r0 + i) * db_stride + col];
      });
}

__global__ void reduce_db_tree(const float* __restrict__ runs, int n_runs,
                               int db_stride,
                               const __grid_constant__ hb::DbMap map,
                               float* __restrict__ grads) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= db_stride) return;
  const float total = cascade(n_runs, [&](int i) {
    return runs[(size_t)i * db_stride + col];
  });
  int l = 0;
  while (col >= map.col0[l + 1]) ++l;
  grads[map.dst[l] + col - map.col0[l]] = total;
}

}  // namespace tb

struct Dims {
  int k0, kd, kt;
};

// Padded widths, or false if the kernels do not take these shapes.
bool dims(int n, int nfx, int nfd, int a_dim, int t_dim, int has_transient,
          Dims* d) {
  d->k0 = (3 + 6 * nfx + 15) / 16 * 16;
  d->kd = (3 + 6 * nfd + a_dim + 15) / 16 * 16;
  d->kt = has_transient ? (t_dim + 15) / 16 * 16 : 0;
  return n >= 0 && nfx >= 0 && nfd >= 0 && a_dim >= 0 && t_dim >= 0 &&
         d->k0 <= 128 && d->kd <= 128 && d->kt <= 128 && nfx <= 20 &&
         nfd <= 20 && 6 + a_dim + (has_transient ? t_dim : 0) <= IN_LD;
}

// ---- workspace arithmetic and the three launches ----

struct Work {
  int n_tiles, n_rb, splits, per, db_stride, db_runs;
  long long tile_bytes, mask_bytes;
};

// f32: 64-point tiles of one warpgroup and 16 KB slots; bf16: 128-point
// tiles of two 64-point row blocks and 8 KB tiles.
Work work_of(int n, int grid, const hop::TileMap& tm, int has_transient,
             bool f32) {
  Work w;
  const int rows = f32 ? tf::ROWS : hop::ROWS;
  const int consumers = f32 ? 1 : hop::CONSUMERS;
  w.n_tiles = (n + rows - 1) / rows;
  w.n_rb = w.n_tiles * consumers;
  if (f32) {
    w.per = tb::W_ROW_BLOCKS;
    w.splits = w.n_rb > 0 ? (w.n_rb + w.per - 1) / w.per : 1;
  } else {
    w.splits = w.n_rb < hb::SPLITS ? (w.n_rb > 0 ? w.n_rb : 1) : hb::SPLITS;
    w.per = (w.n_rb + w.splits - 1) / w.splits;
  }
  w.db_stride = hop::bias_off(has_transient ? N_LAYERS : L_T0);
  w.db_runs = f32 ? (w.n_rb * 4 + tb::DB_RUN - 1) / tb::DB_RUN : 0;
  w.tile_bytes = (long long)tm.total * w.n_rb *
                 (f32 ? tf::SLOT_BYTES : hop::TILE_BYTES);
  w.mask_bytes =
      (long long)grid * consumers * hb::MASK_WORDS * 128 * 4;
  return w;
}

// the wgrad's units: every layer's input cut into 64-row chunks, two a unit
hb::WPlan make_wplan(const hop::TileMap& tm, const Layout& L, int k0, int kd,
                     int kt, int has_transient, int skip = 4) {
  hb::WPlan wp = {};
  struct Chunk { int tile, rows, row0; };
  Chunk ch[8];
  int n_ch = 0;
  auto chunks = [&](int tile0, int cols, int row0) {
    for (int j = 0; j * 64 < cols; ++j)
      ch[n_ch++] = Chunk{tile0 + j, cols - 64 * j < 64 ? cols - 64 * j : 64,
                         row0 + 64 * j};
  };
  auto emit = [&](int l, int g_tile, int n_g, int gh_tile) {
    for (int c = 0; c < n_ch; c += 2) {
      hb::WUnit u = {};
      for (int i = 0; i < 2; ++i) {
        const bool have = c + i < n_ch;
        u.a_tile[i] = have ? ch[c + i].tile : -1;
        u.rows[i] = have ? ch[c + i].rows : 0;
        u.out_off[i] = have ? (int)(L.off[l] + (long long)ch[c + i].row0 * L.N[l]) : 0;
      }
      u.g_tile = g_tile;
      u.n_g = n_g;
      u.gh_tile = gh_tile;
      u.n_out = L.N[l];
      if (wp.n_units < hb::MAX_UNITS) wp.u[wp.n_units] = u;
      ++wp.n_units;
    }
    n_ch = 0;
  };
  for (int l = 0; l < 8; ++l) {
    if (l == 0 || l == skip) chunks(tm.pe, k0, 0);
    if (l != 0) chunks(tm.h[l - 1], W_TRUNK, l == skip ? k0 : 0);
    emit(l, tm.g[l], 4, -1);
  }
  chunks(tm.h[7], W_TRUNK, 0);
  emit(L_FS, tm.g[L_FS], 4, tm.gh);
  chunks(tm.xf, W_TRUNK, 0);
  chunks(tm.dtail, kd, W_TRUNK);
  emit(L_DIR, tm.g[L_DIR], 2, -1);
  chunks(tm.hd, W_HALF, 0);
  emit(L_RGB, 0, 0, tm.gh);
  if (has_transient) {
    chunks(tm.xf, W_TRUNK, 0);
    chunks(tm.ttail, kt, W_TRUNK);
    emit(L_T0, tm.g[L_T0], 2, -1);
    for (int l = L_T0 + 1; l < L_TH; ++l) {
      chunks(tm.th[l - L_T0 - 1], W_HALF, 0);
      emit(l, tm.g[l], 2, -1);
    }
    chunks(tm.th[3], W_HALF, 0);
    emit(L_TH, 0, 0, tm.gh);
  }
  return wp;
}

// The f32 reductions: the partial dW slabs and the per-warp db rows summed
// in fixed trees, so that a data-parallel rank's share sums as the whole
// does.
int reduce_f32(int n, const Work& w, const Layout& L, const hb::DbMap& map,
               float* dw_part, float* db_part, float* grads,
               cudaStream_t stream) {
  long long blocks = (L.stride + 255) / 256;
  const int dw_grid = (int)(blocks < 1024 ? blocks : 1024);
  float* runs = db_part + (long long)w.n_rb * 4 * w.db_stride;
  const int db_runs = n > 0 ? w.db_runs : 0;
  tb::reduce_dw_tree<<<dw_grid, 256, 0, stream>>>(dw_part, grads, L.stride,
                                                   n > 0 ? w.splits : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (db_runs > 0) {
    tb::reduce_db_runs<<<dim3((w.db_stride + 127) / 128, db_runs), 128, 0,
                         stream>>>(db_part, w.n_rb * 4, w.db_stride, runs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  tb::reduce_db_tree<<<(w.db_stride + 127) / 128, 128, 0, stream>>>(
      runs, db_runs, w.db_stride, map, grads);
  return (int)cudaGetLastError();
}

// One launch's shapes.  ipe: the IPE instance (mip-NeRF's field), f32
// only: nfx IPE frequencies (k0 = 6 nfx rounded up to 16), no appearance,
// no transient branch, the skip at layer 5.
struct Shapes {
  Dims d;
  int skip;
  Layout L;
  hop::TileMap tm;
};

// false if the kernels do not take these shapes
bool shapes(int n, int nfx, int nfd, int a_dim, int t_dim, int has_transient,
            bool ipe, Shapes* s) {
  if (!dims(n, nfx, nfd, a_dim, t_dim, has_transient, &s->d) ||
      (ipe && (nfx < 1 || a_dim || t_dim || has_transient)))
    return false;
  if (ipe) s->d.k0 = (6 * nfx + 15) / 16 * 16;
  s->skip = ipe ? 5 : 4;
  s->L = make_layout(s->d.k0, s->d.kd, s->d.kt, has_transient, s->skip);
  s->tm = hop::make_tile_map(s->d.k0, s->d.kd, s->d.kt, has_transient);
  return true;
}

// Workspace sizes (nerf_fused_mlp_bwd_sizes' out[0..2]).
int sizes(bool f32, int n, int grid, int nfx, int nfd, int a_dim, int t_dim,
          int has_transient, bool ipe, long long* out) {
  Shapes s;
  if (grid < 0 || (ipe && !f32) ||
      !shapes(n, nfx, nfd, a_dim, t_dim, has_transient, ipe, &s))
    return (int)cudaErrorInvalidValue;
  out[2] = s.L.stride;
  // tiles of saved operands and ReLU bits; dW partial slabs and db rows
  const Work w = work_of(n, grid, s.tm, has_transient, f32);
  out[0] = w.tile_bytes + w.mask_bytes;
  out[1] = (long long)w.splits * s.L.stride +
           ((long long)w.n_rb * 4 + w.db_runs) * w.db_stride;
  return 0;
}

// ipe_runs non-null: the IPE instance (f32 only; no d_inp), whose fused
// kernel also adds one to *ipe_runs.
int launch(bool f32, const float* inp, const float* g, float* d_inp, int n,
           const void* image, long long image_bytes, int grid,
           const float* const* b, const float* sx, const float* sd, int nfx,
           int nfd, int a_dim, int t_dim, int has_transient, void* scratch,
           float* partial, float* grads, unsigned long long* runs,
           unsigned long long* ipe_runs, cudaStream_t stream) {
  const bool ipe = ipe_runs != nullptr;
  Shapes s;
  if ((ipe && !f32) ||
      !shapes(n, nfx, nfd, a_dim, t_dim, has_transient, ipe, &s))
    return (int)cudaErrorInvalidValue;
  const Dims& d = s.d;
  const Layout& L = s.L;
  const hop::TileMap& tm = s.tm;
  const Work w = work_of(n, grid, tm, has_transient, f32);
  // the wrapper's image must be the one this walk expects
  hop::Plan plan = {};
  tf::Plan plan32 = {};
  const int plan_bytes =
      f32 ? tf::make_bwd_plan(plan32, d.k0, d.kd, d.kt, has_transient,
                              s.skip, ipe)
          : hop::make_bwd_plan(plan, d.k0, d.kd, d.kt, has_transient);
  if (plan_bytes != image_bytes || plan.n_slabs > hop::MAX_SLABS ||
      plan32.n_stages > tf::MAX_PLAN)
    return (int)cudaErrorInvalidValue;
  if (grid < (w.n_tiles ? 1 : 0) || grid > w.n_tiles)
    return (int)cudaErrorInvalidValue;
  const hb::WPlan wp =
      make_wplan(tm, L, d.k0, d.kd, d.kt, has_transient, s.skip);
  if (wp.n_units > hb::MAX_UNITS) return (int)cudaErrorInvalidValue;
  hb::Biases bias = {};
  hb::DbMap map = {};
  map.n_layers = L.n_layers;
  for (int l = 0; l < L.n_layers; ++l) {
    bias.b[l] = b[l];
    map.col0[l] = hop::bias_off(l);
    map.dst[l] = L.off[l] + (long long)L.K[l] * L.N[l];
  }
  map.col0[L.n_layers] = w.db_stride;
  unsigned char* tiles = static_cast<unsigned char*>(scratch);
  uint32_t* masks = reinterpret_cast<uint32_t*>(tiles + w.tile_bytes);
  float* dw_part = partial;
  float* db_part = partial + (long long)w.splits * L.stride;
  const unsigned char* img = static_cast<const unsigned char*>(image);
  cudaError_t err;
  if (f32) {
    err = cudaFuncSetAttribute(
        ipe ? (const void*)tb::fused_mlp_bwd_ipe_f32_kernel
            : (const void*)tb::fused_mlp_bwd_f32_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tf::B_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(tb::wgrad_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tb::W_SMEM);
  } else {
    err = cudaFuncSetAttribute(hb::fused_mlp_bwd_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               hb::B_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(hb::wgrad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               hb::W_SMEM);
  }
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    if (ipe)
      tb::fused_mlp_bwd_ipe_f32_kernel<<<grid, tf::THREADS, tf::B_SMEM,
                                         stream>>>(
          inp, g, n, img, plan32, bias, sd, nfx, nfd, d.k0, d.kd, tiles, tm,
          masks, db_part, w.db_stride, runs, ipe_runs);
    else if (f32)
      tb::fused_mlp_bwd_f32_kernel<<<grid, tf::THREADS, tf::B_SMEM,
                                     stream>>>(
          inp, g, d_inp, n, img, plan32, bias, sx, sd, nfx, nfd, a_dim, t_dim,
          d.k0, d.kd, d.kt, has_transient, tiles, tm, masks, db_part,
          w.db_stride, runs);
    else
      hb::fused_mlp_bwd_bf16_kernel<<<grid, hop::H_THREADS, hb::B_SMEM,
                                      stream>>>(
          inp, g, d_inp, n, img, plan, bias, sx, sd, nfx, nfd, a_dim, t_dim,
          d.k0, d.kd, d.kt, has_transient, tiles, tm, masks, db_part,
          w.db_stride, runs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (f32)
      tb::wgrad_f32_kernel<<<dim3(wp.n_units, w.splits), tb::W_THREADS,
                             tb::W_SMEM, stream>>>(tiles, wp, w.n_rb, w.per,
                                                   dw_part, L.stride);
    else
      hb::wgrad_kernel<<<dim3(wp.n_units, w.splits), hop::H_THREADS,
                         hb::W_SMEM, stream>>>(tiles, wp, w.n_rb, w.per,
                                               dw_part, L.stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (L.stride + 255) / 256;
  const int dw_grid = (int)(blocks < 1024 ? blocks : 1024);
  if (f32) return reduce_f32(n, w, L, map, dw_part, db_part, grads, stream);
  hb::reduce_dw<<<dw_grid, 256, 0, stream>>>(dw_part, grads, L.stride,
                                             n > 0 ? w.splits : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hb::reduce_db<<<(w.db_stride + 31) / 32, dim3(32, 32), 0, stream>>>(
      db_part, n > 0 ? w.n_rb * 4 : 0, w.db_stride, map, grads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Workspace sizes for one launch: out[0] scratch bytes, out[1] partial
// floats, out[2] grad floats (every layer's dW then db, in the layer order
// of nerf_fl_torch/ops/fused_mlp.py:pack_weights).  grid: the launch's
// persistent blocks.  Returns 0, or cudaErrorInvalidValue for shapes the
// kernels do not take.
int nerf_fused_mlp_bwd_sizes(int dtype, int n, int grid, int nfx, int nfd,
                             int a_dim, int t_dim, int has_transient,
                             long long* out) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return sizes(dtype == 0, n, grid, nfx, nfd, a_dim, t_dim, has_transient,
               false, out);
}

// dtype: 0 = float32, 1 = bfloat16.  b is a host array of device pointers
// to the f32 biases, in the layer order of pack_weights.  The weights come
// from `image` (fused_mlp.py:weight_image with backward=True for bfloat16,
// f32_weight_image with backward=True for float32), and `grid` persistent
// blocks run.  scratch / partial are workspaces of the sizes above; grads
// receives the summed f32 grads.  Only d_inp's live columns are written:
// the caller zeroes it.  The fused kernel (not the wgrad or the
// reductions) adds one to *runs each time it runs, a CUDA graph's replays
// included.  Returns 0 or the cudaError_t of the first failed launch.
int nerf_fused_mlp_bwd(int dtype, const float* inp, const float* g,
                       float* d_inp, int n, const float* const* b,
                       const void* image, long long image_bytes, int grid,
                       const float* sx, const float* sd, int nfx, int nfd,
                       int a_dim, int t_dim, int has_transient, void* scratch,
                       float* partial, float* grads, unsigned long long* runs,
                       void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return launch(dtype == 0, inp, g, d_inp, n, image, image_bytes, grid, b, sx,
                sd, nfx, nfd, a_dim, t_dim, has_transient, scratch, partial,
                grads, runs, nullptr, static_cast<cudaStream_t>(stream));
}

// The IPE backward's workspace sizes (nerf_fused_mlp_bwd_sizes' out[0..2])
// for nfx IPE and nfd direction frequencies.  Returns 0, or
// cudaErrorInvalidValue for shapes it does not take.
int nerf_fused_ipe_bwd_sizes(int n, int grid, int nfx, int nfd,
                             long long* out) {
  return sizes(true, n, grid, nfx, nfd, 0, 0, 0, true, out);
}

// The IPE backward (mip-NeRF's field, fused_mlp_bwd_ipe_f32_kernel, the
// f32 wgrad and reductions): the packed (n, 128) rows [mean | dir | var |
// 0] and the (n, 16) f32 cotangent g -> every layer's dW then db into
// grads, in pack_weights' layer order of the IPE layout (11 layers, the
// skip layer 5's input rows [enc | h]).  No input cotangent.  b: the f32
// biases; image: fused_mlp.py:f32_weight_image(backward=True) of the IPE
// layout.  The fused kernel adds one to *runs and to *ipe_runs each time
// it runs.  Returns 0 or the cudaError_t of the first failed launch.
int nerf_fused_ipe_bwd(const float* inp, const float* g, int n,
                       const float* const* b, const void* image,
                       long long image_bytes, int grid, const float* sd,
                       int nfx, int nfd, void* scratch, float* partial,
                       float* grads, unsigned long long* runs,
                       unsigned long long* ipe_runs, void* stream) {
  return launch(true, inp, g, nullptr, n, image, image_bytes, grid, b,
                nullptr, sd, nfx, nfd, 0, 0, 0, scratch, partial, grads, runs,
                ipe_runs, static_cast<cudaStream_t>(stream));
}

// The kernels' blocks, for reports: out[0] points a block, out[1] threads
// of the fused kernel, out[2] / out[3] shared-memory bytes of the fused and
// the wgrad kernel, out[4] the wgrad's splits of the points (bfloat16) or
// its 64-point row blocks a split (float32); bfloat16 in out[0..4],
// float32 in out[5..9]; out[10] / out[11] the fused kernel's consumer
// warpgroups, bfloat16 / float32.
void nerf_fused_mlp_bwd_info(int* out) {
  out[0] = hop::ROWS;
  out[1] = hop::H_THREADS;
  out[2] = hb::B_SMEM;
  out[3] = hb::W_SMEM;
  out[4] = hb::SPLITS;
  out[5] = tf::ROWS;
  out[6] = tf::THREADS;
  out[7] = tf::B_SMEM;
  out[8] = tb::W_SMEM;
  out[9] = tb::W_ROW_BLOCKS;
  out[10] = hop::CONSUMERS;
  out[11] = tf::CONSUMERS;
}

}  // extern "C"
