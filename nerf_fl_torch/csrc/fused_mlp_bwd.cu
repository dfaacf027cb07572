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
// The bf16 path (the train step's) is three launches built from the Hopper
// block of fused_mlp_common.cuh:
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
// The f32 path keeps the first design, which is exact (full-precision FMAs,
// no TF32; every "round to the compute type" is the identity) and on no
// main path: 64-point tiles, activations in a per-block global scratch,
// one f32 partial slab per persistent block (N_PART), summed in block order
// by reduce_partials.
#include "fused_mlp_common.cuh"

namespace {

constexpr int N_PART = 132;    // partial slabs: the H100 SXM's SM count
constexpr int BUF_W = FS_OUT;  // second buffer: fs2's cotangent is widest

// Per-layer shapes of the packed weights and where their grads live in a
// partial slab: dW (K x N) at off, db (N) at off + K * N.
struct Layout {
  int K[N_LAYERS];
  int N[N_LAYERS];
  long long off[N_LAYERS];
  long long stride;   // floats per partial slab
  int n_layers;
};

Layout make_layout(int k0, int kd, int kt, int has_transient) {
  Layout L = {};
  const int shapes[N_LAYERS][2] = {
      {k0, W_TRUNK}, {W_TRUNK, W_TRUNK}, {W_TRUNK, W_TRUNK},
      {W_TRUNK, W_TRUNK}, {k0 + W_TRUNK, W_TRUNK}, {W_TRUNK, W_TRUNK},
      {W_TRUNK, W_TRUNK}, {W_TRUNK, W_TRUNK}, {W_TRUNK, FS_OUT},
      {W_TRUNK + kd, W_HALF}, {W_HALF, OUT_LD}, {W_TRUNK + kt, W_HALF},
      {W_HALF, W_HALF}, {W_HALF, W_HALF}, {W_HALF, W_HALF},
      {W_HALF, OUT_LD}};
  L.n_layers = has_transient ? N_LAYERS : L_T0;
  long long at = 0;
  for (int l = 0; l < L.n_layers; ++l) {
    L.K[l] = shapes[l][0];
    L.N[l] = shapes[l][1];
    L.off[l] = at;
    at += (long long)L.K[l] * L.N[l] + L.N[l];
  }
  L.stride = at;
  return L;
}

// Segments of a block's activation scratch, each TILE_M x width row-major
// (ld = width).  Offsets in units of TILE_M elements.
struct Segs {
  int pe, h[8], xf, dtail, hd, tt, th[4], dpes, ddt, dtt, total;
};

__host__ __device__ Segs make_segs(int k0, int kd, int kt) {
  Segs s;
  int at = 0;
  s.pe = at;    at += k0;
  for (int i = 0; i < 8; ++i) { s.h[i] = at; at += W_TRUNK; }
  s.xf = at;    at += W_TRUNK;
  s.dtail = at; at += kd;
  s.hd = at;    at += W_HALF;
  s.tt = at;    at += kt;
  for (int i = 0; i < 4; ++i) { s.th[i] = at; at += W_HALF; }
  s.dpes = at;  at += k0;
  s.ddt = at;   at += kd;
  s.dtt = at;   at += kt;
  s.total = at;
  return s;
}

// A layer input as the wgrad reads it: columns [0, split) from p0 (ld
// ld0), the rest from p1 (ld ld1): [pe | h3], [xyz_final | tail].
template <typename T> struct AIn {
  const T* p0;
  int ld0;
  int split;
  const T* p1;
  int ld1;
};
template <typename T> __device__ AIn<T> a_one(const T* p, int ld) {
  return AIn<T>{p, ld, 1 << 30, p, ld};
}

// Rows [0, K) x columns [n0, n0 + cols) of the (K, N) row-major W into a
// slab of K rows, ld KS_T + PAD_T (the slab is W^T in col-major order).
template <typename T>
__device__ __forceinline__ void load_slab_t(T* slab, const T* W, int N, int K,
                                            int n0, int cols) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int SLD = Cfg<T>::KS_T + Cfg<T>::PAD_T;
  const int cpr = cols / EPC;
  const int total = K * cpr;
  for (int c = threadIdx.x; c < total; c += THREADS) {
    const int r = c / cpr, q = c % cpr;
    cp_async16(slab + r * SLD + q * EPC, W + (size_t)r * N + n0 + q * EPC);
  }
}

// dgrad: C (TILE_M x 16*nf) = G (TILE_M x N, shared, ld ldg) @ W^T with W
// (16*nf x N) row-major in global memory, then epi(row, col, value) once
// per element.  N is a multiple of 16, nf <= NFMAX.  slab holds
// 2 x 16*nf x (KS_T + PAD_T) elements.  (f32 only: FMAs on the CUDA cores.)
template <typename T, int NFMAX, typename Epi>
__device__ void gemm_t(const T* G, int ldg, int N, const T* W, int nf,
                       T* slab, Epi epi) {
  constexpr int KS = Cfg<T>::KS_T;
  constexpr int SLD = KS + Cfg<T>::PAD_T;
  const int K = 16 * nf;
  const int nslab = (N + KS - 1) / KS;
  const int tid = threadIdx.x;

  load_slab_t<T>(slab, W, N, K, 0, min(KS, N));
  cp_async_commit();

  // f32: thread owns rows 4*rg..4*rg+3 and columns cg + 16*j
  const int cg = tid & 15, rg = tid >> 4;
  float acc[4][NFMAX];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NFMAX; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < nslab; ++s) {
    const int n0 = s * KS;
    if (s + 1 < nslab)
      load_slab_t<T>(slab + ((s + 1) & 1) * K * SLD, W, N, K, n0 + KS,
                     min(KS, N - n0 - KS));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* cur = slab + (s & 1) * K * SLD;
    const int cols = min(KS, N - n0);
    for (int kk = 0; kk < cols; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = G[(rg * 4 + i) * ldg + n0 + kk];
#pragma unroll
      for (int j = 0; j < NFMAX; ++j) {
        if (j < nf) {
          const float b = cur[(cg + 16 * j) * SLD + kk];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NFMAX; ++j)
      if (j < nf) epi(rg * 4 + i, cg + 16 * j, acc[i][j]);
  __syncthreads();
}

// dgrad epilogue: the value rounded to the compute type; columns below
// split go to lo (optionally rounded again after adding the compute-type
// value at add, as a bf16 add), the rest to hi.
template <typename T> struct Split {
  T* lo;
  int ld_lo;
  int split;
  T* hi;
  int ld_hi;
  const T* add;
  int ld_add;
  __device__ void operator()(int r, int c, float v) const {
    T y = to_t<T>(v);
    if (c < split) {
      if (add) y = to_t<T>(to_f(y) + to_f(add[r * ld_add + c]));
      lo[r * ld_lo + c] = y;
    } else {
      hi[r * ld_hi + c - split] = y;
    }
  }
};
template <typename T> __device__ Split<T> store_to(T* dst, int ld) {
  return Split<T>{dst, ld, 1 << 30, dst, ld, nullptr, 0};
}

// Mask the cotangent G (TILE_M x N) by act > 0 (f32 compare; no mask when
// act is null) in place and add its f32 column sums to db, in row order.
// Rows go in batches of MB whose loads are all issued before any store:
// the compiler may not move a load of act past a store to G.
template <typename T>
__device__ void mask_db(T* G, int ldg, int N, const T* act, int lda,
                        float* db) {
  constexpr int MB = 16;
  for (int c = threadIdx.x; c < N; c += THREADS) {
    float s = 0.0f;
    for (int r0 = 0; r0 < TILE_M; r0 += MB) {
      T v[MB];
      bool keep[MB];
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        v[i] = G[(r0 + i) * ldg + c];
        keep[i] = act == nullptr || to_f(act[(r0 + i) * lda + c]) > 0.0f;
      }
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        if (!keep[i]) {
          v[i] = to_t<T>(0.0f);
          G[(r0 + i) * ldg + c] = v[i];
        }
        s += to_f(v[i]);
      }
    }
    db[c] += s;
  }
  __syncthreads();
}

// wgrad: dW (K x N, ld N, f32 global) += a_in^T (K x TILE_M) @ G (TILE_M x
// N, shared).  Each output element is owned by one thread, so the
// read-modify-write needs no synchronisation.  (f32 only.)
template <typename T>
__device__ void wgrad(float* dW, int K, int N, AIn<T> a, const T* G,
                      int ldg) {
  for (int e = threadIdx.x; e < K * N; e += THREADS) {
    const int k = e / N, c = e % N;
    const T* ap = k < a.split ? a.p0 + k : a.p1 + (k - a.split);
    const int lda = k < a.split ? a.ld0 : a.ld1;
    float acc = dW[e];
    for (int m = 0; m < TILE_M; ++m)
      acc = fmaf(to_f(ap[m * lda]), to_f(G[m * ldg + c]), acc);
    dW[e] = acc;
  }
}

// Copy a TILE_M x width tile from shared (ld ls) to the scratch (ld width)
// in 16-byte pieces (every row start is 16-byte aligned).
template <typename T>
__device__ void save(T* dst, const T* src, int ls, int width) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = width / EPC;
  for (int e = threadIdx.x; e < TILE_M * cpr; e += THREADS) {
    const int r = e / cpr, q = e % cpr;
    *reinterpret_cast<uint4*>(dst + r * width + q * EPC) =
        *reinterpret_cast<const uint4*>(src + r * ls + q * EPC);
  }
}

// fs2's first 256 columns + bias, rounded: xyz_final (the sigma block is
// not needed here).
template <typename T> struct XyzFinal {
  T* dst;
  int ld;
  const float* bias;
  __device__ void operator()(int r, int c, float v) const {
    if (c < W_TRUNK) dst[r * ld + c] = to_t<T>(v + bias[c]);
  }
};

// d_inp[c] for an input component: sum over its PE columns of
// where(trig, cos, 1) * scale * d_pe times the column's coefficient (1 on
// the identity column, 2^k on frequency k), in column order.
template <typename T>
__device__ float pe_bwd(float x, int comp, int n_freq, const float* scale,
                        const T* d) {
  float acc = __fmul_rn(scale[comp], to_f(d[comp]));
  for (int k = 0; k < n_freq; ++k) {
    const float f = (float)(1 << k);
    const float arg = __fmul_rn(x, f);
    const int cs = 3 + 6 * k + comp, cc = cs + 3;
    // d sin = cos (+1/4 turn), d cos = -sin (+1/2 turn)
    const float ds = __fmul_rn(__fmul_rn(sin_cw(arg, 0.25f), scale[cs]),
                               to_f(d[cs]));
    const float dc = __fmul_rn(__fmul_rn(sin_cw(arg, 0.5f), scale[cc]),
                               to_f(d[cc]));
    acc = __fadd_rn(acc, __fmul_rn(ds, f));
    acc = __fadd_rn(acc, __fmul_rn(dc, f));
  }
  return acc;
}

// Row strides of the shared buffers: P0 (forward activations, then
// cotangents), P1 (hidden outputs, then cotangents), GH (head cotangent).
template <typename T> struct Ld {
  static constexpr int P0 = ACT_W + Cfg<T>::PAD;
  static constexpr int P1 = BUF_W + Cfg<T>::PAD;
  static constexpr int GH = OUT_LD + Cfg<T>::PAD;
};

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// P0, P1, GH, then the slab region: the forward's weight slab, the dgrad's
// transposed slab or the per-warp epilogue scratch, whichever is largest.
template <typename T>
constexpr size_t bwd_smem_bytes() {
  constexpr size_t fwd_slab =
      sizeof(T) * 2 * (size_t)Cfg<T>::KS * (FS_OUT + Cfg<T>::PAD);
  constexpr size_t t_slab = sizeof(T) * 2 * (size_t)ACT_W *
                            (Cfg<T>::KS_T + Cfg<T>::PAD_T);
  constexpr size_t epi = sizeof(float) * WARPS * 256;
  return sizeof(T) * (size_t)TILE_M * (Ld<T>::P0 + Ld<T>::P1 + Ld<T>::GH) +
         cmax(cmax(fwd_slab, t_slab), epi);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_bwd_kernel(const float* __restrict__ inp,
                     const float* __restrict__ g, float* __restrict__ d_inp,
                     int n, Net net, const float* __restrict__ sx,
                     const float* __restrict__ sd, int nfx, int nfd,
                     int a_dim, int t_dim, int k0, int kd, int kt,
                     int has_transient, T* scratch_all, float* partial_all,
                     Layout L, unsigned long long* runs) {
  count_run(runs);
  constexpr int ALD = Ld<T>::P0;
  constexpr int BLD = Ld<T>::P1;
  constexpr int GLD = Ld<T>::GH;
  extern __shared__ __align__(128) unsigned char smem[];
  T* P0 = reinterpret_cast<T*>(smem);   // fwd: act; bwd: cotangents
  T* P1 = P0 + TILE_M * ALD;            // fwd: hb;  bwd: cotangents
  T* GH = P1 + TILE_M * BLD;            // the heads' cotangent, rounded
  T* slab = GH + TILE_M * GLD;

  const int tid = threadIdx.x;
  const Segs S = make_segs(k0, kd, kt);
  T* scr = scratch_all + (size_t)blockIdx.x * TILE_M * S.total;
  float* part = partial_all + (size_t)blockIdx.x * L.stride;
  auto seg = [&](int off) { return scr + (size_t)off * TILE_M; };
  auto W = [&](int l) { return static_cast<const T*>(net.w[l]); };
  auto dW = [&](int l) { return part + L.off[l]; };
  auto db = [&](int l) { return part + L.off[l] + (long long)L.K[l] * L.N[l]; };

  for (long long e = tid; e < L.stride; e += THREADS) part[e] = 0.0f;
  __syncthreads();

  const int n_tiles = (n + TILE_M - 1) / TILE_M;
  const int dpe = 3 + 6 * nfd;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * TILE_M;

    // ---- forward recompute (the forward kernel's code) ----
    T* act = P0;
    T* hb = P1;
    for (int e = tid; e < TILE_M * k0; e += THREADS) {
      const int r = e / k0, c = e % k0;
      float v = 0.0f;
      if (row0 + r < (size_t)n) v = pe_col(inp + (row0 + r) * IN_LD, c, nfx, sx);
      act[r * ALD + c] = to_t<T>(v);
      seg(S.pe)[e] = to_t<T>(v);
    }
    __syncthreads();
    T* h = act + k0;
    for (int i = 0; i < 8; ++i) {
      if (i == 0)
        gemm<T, 16>(act, ALD, k0, W(0), slab, Hidden<T>{h, ALD, net.b[0]});
      else if (i == 4)
        gemm<T, 16>(act, ALD, k0 + W_TRUNK, W(i), slab,
                    Hidden<T>{h, ALD, net.b[i]});
      else
        gemm<T, 16>(h, ALD, W_TRUNK, W(i), slab, Hidden<T>{h, ALD, net.b[i]});
      save(seg(S.h[i]), h, ALD, W_TRUNK);
    }
    gemm<T, FS_OUT / 16>(h, ALD, W_TRUNK, W(L_FS), slab,
                         XyzFinal<T>{act, ALD, net.b[L_FS]});
    save(seg(S.xf), act, ALD, W_TRUNK);
    for (int e = tid; e < TILE_M * kd; e += THREADS) {
      const int r = e / kd, c = e % kd;
      float v = 0.0f;
      if (row0 + r < (size_t)n) {
        const float* row = inp + (row0 + r) * IN_LD;
        if (c < dpe) v = pe_col(row + 3, c, nfd, sd);
        else if (c < dpe + a_dim) v = row[6 + c - dpe];
      }
      act[r * ALD + W_TRUNK + c] = to_t<T>(v);
      seg(S.dtail)[e] = to_t<T>(v);
    }
    __syncthreads();
    gemm<T, 8>(act, ALD, W_TRUNK + kd, W(L_DIR), slab,
               Hidden<T>{hb, BLD, net.b[L_DIR]});
    save(seg(S.hd), hb, BLD, W_HALF);
    if (has_transient) {
      for (int e = tid; e < TILE_M * kt; e += THREADS) {
        const int r = e / kt, c = e % kt;
        float v = 0.0f;
        if (row0 + r < (size_t)n && c < t_dim)
          v = inp[(row0 + r) * IN_LD + 6 + a_dim + c];
        act[r * ALD + W_TRUNK + c] = to_t<T>(v);
        seg(S.tt)[e] = to_t<T>(v);
      }
      __syncthreads();
      gemm<T, 8>(act, ALD, W_TRUNK + kt, W(L_T0), slab,
                 Hidden<T>{hb, BLD, net.b[L_T0]});
      save(seg(S.th[0]), hb, BLD, W_HALF);
      for (int j = 1; j < 4; ++j) {
        gemm<T, 8>(hb, BLD, W_HALF, W(L_T0 + j), slab,
                   Hidden<T>{hb, BLD, net.b[L_T0 + j]});
        save(seg(S.th[j]), hb, BLD, W_HALF);
      }
    }
    // the heads' cotangent, rounded to the compute type
    for (int e = tid; e < TILE_M * OUT_LD; e += THREADS) {
      const int r = e / OUT_LD, c = e % OUT_LD;
      float v = 0.0f;
      if (row0 + r < (size_t)n) v = g[(row0 + r) * OUT_LD + c];
      GH[r * GLD + c] = to_t<T>(v);
    }
    __syncthreads();

    // ---- backward ----
    // transient: heads -> t3 .. t0; d_xyz_final lands in P1
    if (has_transient) {
      mask_db<T>(GH, GLD, OUT_LD, nullptr, 0, db(L_TH));
      wgrad<T>(dW(L_TH), W_HALF, OUT_LD, a_one<T>(seg(S.th[3]), W_HALF), GH,
               GLD);
      gemm_t<T, 8>(GH, GLD, OUT_LD, W(L_TH), 8, slab, store_to<T>(P1, BLD));
      T* cur = P1;
      int lc = BLD;
      for (int j = 3; j >= 1; --j) {
        T* nxt = cur == P1 ? P0 : P1;
        const int ln = cur == P1 ? ALD : BLD;
        mask_db<T>(cur, lc, W_HALF, seg(S.th[j]), W_HALF, db(L_T0 + j));
        wgrad<T>(dW(L_T0 + j), W_HALF, W_HALF,
                 a_one<T>(seg(S.th[j - 1]), W_HALF), cur, lc);
        gemm_t<T, 8>(cur, lc, W_HALF, W(L_T0 + j), 8, slab,
                     store_to<T>(nxt, ln));
        cur = nxt;
        lc = ln;
      }
      // cur == P0
      mask_db<T>(P0, ALD, W_HALF, seg(S.th[0]), W_HALF, db(L_T0));
      wgrad<T>(dW(L_T0), W_TRUNK + kt, W_HALF,
               AIn<T>{seg(S.xf), W_TRUNK, W_TRUNK, seg(S.tt), kt}, P0, ALD);
      gemm_t<T, 24>(P0, ALD, W_HALF, W(L_T0), (W_TRUNK + kt) / 16, slab,
                    Split<T>{P1, BLD, W_TRUNK, seg(S.dtt), kt, nullptr, 0});
    }
    // static: rgb head -> dir; d_xyz_final (merged with the transient's in
    // one rounding) lands in P1, d_dtail in the scratch
    mask_db<T>(GH, GLD, OUT_LD, nullptr, 0, db(L_RGB));
    wgrad<T>(dW(L_RGB), W_HALF, OUT_LD, a_one<T>(seg(S.hd), W_HALF), GH, GLD);
    gemm_t<T, 8>(GH, GLD, OUT_LD, W(L_RGB), 8, slab, store_to<T>(P0, ALD));
    mask_db<T>(P0, ALD, W_HALF, seg(S.hd), W_HALF, db(L_DIR));
    wgrad<T>(dW(L_DIR), W_TRUNK + kd, W_HALF,
             AIn<T>{seg(S.xf), W_TRUNK, W_TRUNK, seg(S.dtail), kd}, P0, ALD);
    gemm_t<T, 24>(P0, ALD, W_HALF, W(L_DIR), (W_TRUNK + kd) / 16, slab,
                  Split<T>{P1, BLD, W_TRUNK, seg(S.ddt), kd,
                           has_transient ? P1 : nullptr, BLD});
    // fs2: cotangent [d_xyz_final | g], no ReLU
    for (int e = tid; e < TILE_M * OUT_LD; e += THREADS) {
      const int r = e / OUT_LD, c = e % OUT_LD;
      P1[r * BLD + W_TRUNK + c] = GH[r * GLD + c];
    }
    __syncthreads();
    mask_db<T>(P1, BLD, FS_OUT, nullptr, 0, db(L_FS));
    wgrad<T>(dW(L_FS), W_TRUNK, FS_OUT, a_one<T>(seg(S.h[7]), W_TRUNK), P1,
             BLD);
    gemm_t<T, 16>(P1, BLD, FS_OUT, W(L_FS), 16, slab, store_to<T>(P0, ALD));
    // trunk 7 .. 0, the skip split at 4; d_pe lands in P0
    T* cur = P0;
    int lc = ALD;
    for (int i = 7; i >= 0; --i) {
      T* nxt = cur == P1 ? P0 : P1;
      const int ln = cur == P1 ? ALD : BLD;
      mask_db<T>(cur, lc, W_TRUNK, seg(S.h[i]), W_TRUNK, db(i));
      if (i == 0) {
        wgrad<T>(dW(0), k0, W_TRUNK, a_one<T>(seg(S.pe), k0), cur, lc);
        gemm_t<T, 8>(cur, lc, W_TRUNK, W(0), k0 / 16, slab,
                     Split<T>{nxt, ln, 1 << 30, nxt, ln, seg(S.dpes), k0});
      } else if (i == 4) {
        wgrad<T>(dW(4), k0 + W_TRUNK, W_TRUNK,
                 AIn<T>{seg(S.pe), k0, k0, seg(S.h[3]), W_TRUNK}, cur, lc);
        gemm_t<T, 24>(cur, lc, W_TRUNK, W(4), (k0 + W_TRUNK) / 16, slab,
                      Split<T>{seg(S.dpes), k0, k0, nxt, ln, nullptr, 0});
      } else {
        wgrad<T>(dW(i), W_TRUNK, W_TRUNK, a_one<T>(seg(S.h[i - 1]), W_TRUNK),
                 cur, lc);
        gemm_t<T, 16>(cur, lc, W_TRUNK, W(i), 16, slab, store_to<T>(nxt, ln));
      }
      cur = nxt;
      lc = ln;
    }
    // ---- PE chain rule -> d_inp ----
    const T* d_pe = cur;
    const T* ddt = seg(S.ddt);
    const T* dtt = seg(S.dtt);
    for (int e = tid; e < TILE_M * IN_LD; e += THREADS) {
      const int r = e / IN_LD, c = e % IN_LD;
      if (row0 + r >= (size_t)n) continue;
      const float* row = inp + (row0 + r) * IN_LD;
      float v = 0.0f;
      if (c < 3)
        v = pe_bwd(row[c], c, nfx, sx, d_pe + r * lc);
      else if (c < 6)
        v = pe_bwd(row[c], c - 3, nfd, sd, ddt + r * kd);
      else if (c < 6 + a_dim)
        v = to_f(ddt[r * kd + dpe + c - 6]);
      else if (has_transient && c < 6 + a_dim + t_dim)
        v = to_f(dtt[r * kt + c - 6 - a_dim]);
      d_inp[(row0 + r) * IN_LD + c] = v;
    }
    __syncthreads();
  }
}

// grads[e] = sum over blocks p = 0, 1, ... of partial[p][e], in that order.
__global__ void reduce_partials(const float* __restrict__ partial,
                                float* __restrict__ grads, long long stride,
                                int n_part) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < stride; e += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int p = 0; p < n_part; ++p) s += partial[(size_t)p * stride + e];
    grads[e] = s;
  }
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

struct Dims {
  int k0, kd, kt, n_part;
};

// Padded widths and the number of partial slabs, or false if the kernel
// does not take these shapes.
bool dims(int n, int nfx, int nfd, int a_dim, int t_dim, int has_transient,
          Dims* d) {
  d->k0 = (3 + 6 * nfx + 15) / 16 * 16;
  d->kd = (3 + 6 * nfd + a_dim + 15) / 16 * 16;
  d->kt = has_transient ? (t_dim + 15) / 16 * 16 : 0;
  const int n_tiles = (n + TILE_M - 1) / TILE_M;
  d->n_part = n_tiles < N_PART ? n_tiles : N_PART;
  return n >= 0 && nfx >= 0 && nfd >= 0 && a_dim >= 0 && t_dim >= 0 &&
         d->k0 <= 128 && d->kd <= 128 && d->kt <= 128 && nfx <= 20 &&
         nfd <= 20 && 6 + a_dim + (has_transient ? t_dim : 0) <= IN_LD;
}

int launch_f32(const float* inp, const float* g, float* d_inp, int n,
               const void* const* w, const float* const* b, const float* sx,
               const float* sd, int nfx, int nfd, int a_dim, int t_dim,
               int has_transient, void* scratch, float* partial, float* grads,
               unsigned long long* runs, cudaStream_t stream) {
  using T = float;
  Dims d;
  if (!dims(n, nfx, nfd, a_dim, t_dim, has_transient, &d))
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(d.k0, d.kd, d.kt, has_transient);
  Net net = {};
  for (int l = 0; l < L.n_layers; ++l) {
    net.w[l] = w[l];
    net.b[l] = b[l];
  }
  constexpr size_t smem = bwd_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (d.n_part > 0) {
    fused_mlp_bwd_kernel<T><<<d.n_part, THREADS, smem, stream>>>(
        inp, g, d_inp, n, net, sx, sd, nfx, nfd, a_dim, t_dim, d.k0, d.kd,
        d.kt, has_transient, static_cast<T*>(scratch), partial, L, runs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (L.stride + 255) / 256;
  reduce_partials<<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
      partial, grads, L.stride, d.n_part);
  return (int)cudaGetLastError();
}

// ---- bf16: workspace arithmetic and the three launches ----

struct Work {
  int n_tiles, n_rb, splits, per, db_stride;
  long long tile_bytes, mask_bytes;
};

Work work_of(int n, int grid, const hop::TileMap& tm, int has_transient) {
  Work w;
  w.n_tiles = (n + hop::ROWS - 1) / hop::ROWS;
  w.n_rb = w.n_tiles * hop::CONSUMERS;
  w.splits = w.n_rb < hb::SPLITS ? (w.n_rb > 0 ? w.n_rb : 1) : hb::SPLITS;
  w.per = (w.n_rb + w.splits - 1) / w.splits;
  w.db_stride = hop::bias_off(has_transient ? N_LAYERS : L_T0);
  w.tile_bytes = (long long)tm.total * w.n_rb * hop::TILE_BYTES;
  w.mask_bytes = (long long)grid * hop::CONSUMERS * hb::MASK_WORDS * 128 * 4;
  return w;
}

// the wgrad's units: every layer's input cut into 64-row chunks, two a unit
hb::WPlan make_wplan(const hop::TileMap& tm, const Layout& L, int k0, int kd,
                     int kt, int has_transient) {
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
    if (l == 0 || l == 4) chunks(tm.pe, k0, 0);
    if (l != 0) chunks(tm.h[l - 1], W_TRUNK, l == 4 ? k0 : 0);
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

int launch_bf16(const float* inp, const float* g, float* d_inp, int n,
                const void* image, long long image_bytes, int grid,
                const float* const* b, const float* sx, const float* sd,
                int nfx, int nfd, int a_dim, int t_dim, int has_transient,
                void* scratch, float* partial, float* grads,
                unsigned long long* runs, cudaStream_t stream) {
  Dims d;
  if (!dims(n, nfx, nfd, a_dim, t_dim, has_transient, &d))
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(d.k0, d.kd, d.kt, has_transient);
  const hop::TileMap tm = hop::make_tile_map(d.k0, d.kd, d.kt, has_transient);
  const Work w = work_of(n, grid, tm, has_transient);
  hop::Plan plan;
  // the wrapper's image must be the one this walk expects
  if (hop::make_bwd_plan(plan, d.k0, d.kd, d.kt, has_transient) !=
          image_bytes ||
      plan.n_slabs > hop::MAX_SLABS)
    return (int)cudaErrorInvalidValue;
  if (grid < (w.n_tiles ? 1 : 0) || grid > w.n_tiles)
    return (int)cudaErrorInvalidValue;
  const hb::WPlan wp = make_wplan(tm, L, d.k0, d.kd, d.kt, has_transient);
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
  cudaError_t err = cudaFuncSetAttribute(
      hb::fused_mlp_bwd_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, hb::B_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(hb::wgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             hb::W_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    hb::fused_mlp_bwd_bf16_kernel<<<grid, hop::H_THREADS, hb::B_SMEM, stream>>>(
        inp, g, d_inp, n, static_cast<const unsigned char*>(image), plan,
        bias, sx, sd, nfx, nfd, a_dim, t_dim, d.k0, d.kd, d.kt, has_transient,
        tiles, tm, masks, db_part, w.db_stride, runs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    hb::wgrad_kernel<<<dim3(wp.n_units, w.splits), hop::H_THREADS, hb::W_SMEM,
                       stream>>>(tiles, wp, w.n_rb, w.per, dw_part, L.stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (L.stride + 255) / 256;
  hb::reduce_dw<<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
      dw_part, grads, L.stride, n > 0 ? w.splits : 0);
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
// of nerf_fl_torch/ops/fused_mlp.py:pack_weights).  grid: the persistent
// blocks of the bfloat16 launch (float32 ignores it).  Returns 0, or
// cudaErrorInvalidValue for shapes the kernel does not take.
int nerf_fused_mlp_bwd_sizes(int dtype, int n, int grid, int nfx, int nfd,
                             int a_dim, int t_dim, int has_transient,
                             long long* out) {
  Dims d;
  if ((dtype != 0 && dtype != 1) || grid < 0 ||
      !dims(n, nfx, nfd, a_dim, t_dim, has_transient, &d))
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(d.k0, d.kd, d.kt, has_transient);
  out[2] = L.stride;
  if (dtype == 1) {
    // tiles of saved operands and ReLU bits; dW partial slabs and db rows
    const hop::TileMap tm = hop::make_tile_map(d.k0, d.kd, d.kt, has_transient);
    const Work w = work_of(n, grid, tm, has_transient);
    out[0] = w.tile_bytes + w.mask_bytes;
    out[1] = (long long)w.splits * L.stride +
             (long long)w.n_rb * 4 * w.db_stride;
    return 0;
  }
  const Segs S = make_segs(d.k0, d.kd, d.kt);
  out[0] = (long long)d.n_part * TILE_M * S.total * 4;
  out[1] = (long long)d.n_part * L.stride;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  w / b are host arrays of device
// pointers, in the layer order of pack_weights.  bfloat16 reads its weights
// from `image` (fused_mlp.py:weight_image with backward=True) and runs
// `grid` persistent blocks; float32 ignores the three.  scratch / partial
// are workspaces of the sizes above; grads receives the summed f32 grads.
// bfloat16 writes only d_inp's live columns: the caller zeroes it.  The
// fused kernel (not the wgrad or the reductions) adds one to *runs each
// time it runs, a CUDA graph's replays included.  Returns 0 or the
// cudaError_t of the first failed launch.
int nerf_fused_mlp_bwd(int dtype, const float* inp, const float* g,
                       float* d_inp, int n, const void* const* w,
                       const float* const* b, const void* image,
                       long long image_bytes, int grid, const float* sx,
                       const float* sd, int nfx, int nfd, int a_dim,
                       int t_dim, int has_transient, void* scratch,
                       float* partial, float* grads, unsigned long long* runs,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(inp, g, d_inp, n, image, image_bytes, grid, b, sx, sd,
                       nfx, nfd, a_dim, t_dim, has_transient, scratch, partial,
                       grads, runs, s);
  if (dtype == 0)
    return launch_f32(inp, g, d_inp, n, w, b, sx, sd, nfx, nfd, a_dim, t_dim,
                      has_transient, scratch, partial, grads, runs, s);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 kernels' block, for reports: out[0] points a block, out[1]
// threads, out[2] / out[3] shared-memory bytes of the fused and the wgrad
// kernel, out[4] the wgrad's splits of the points.
void nerf_fused_mlp_bwd_info(int* out) {
  out[0] = hop::ROWS;
  out[1] = hop::H_THREADS;
  out[2] = hb::B_SMEM;
  out[3] = hb::W_SMEM;
  out[4] = hb::SPLITS;
}

}  // extern "C"
