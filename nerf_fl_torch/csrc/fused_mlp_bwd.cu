// Fused positional encoding + NeRF-W MLP backward for Hopper (sm_90a).
//
// Replaces nerf_fl_tpu/ops/fused_mlp.py:_bwd_kernel (the Pallas TPU kernel
// behind _fused_bwd).  Given the packed (N, 128) f32 input, the packed
// weights and the (N, 16) f32 cotangent g of the pre-activations, it
// computes the f32 grads of every packed weight slab and bias and the
// (N, 128) f32 cotangent of the packed input.  One block owns a tile of
// TILE_M = 64 points at a time and, for each tile:
//   1. recomputes the forward with the forward kernel's own code
//      (fused_mlp_common.cuh), so activations and ReLU masks agree bit for
//      bit with what the forward produced;
//   2. backprops: transient heads -> transient 3..0, rgb head -> dir,
//      fs2 = [d_xyz_final | g], trunk 7..0 with the skip split at layer 4;
//      per layer the cotangent is ReLU-masked (compared in f32), its f32
//      column sums go to db, dW += a_in^T g (f32 accumulation) and
//      d_a_in = g W^T is rounded to the compute type;
//   3. runs the PE chain rule into d_inp: dE = where(trig, cos, 1) * scale
//      * d_pe summed per input component; the appearance and transient
//      columns get their cotangents directly.
//
// Design for this card, not the TPU's:
//   * Activations do not fit in shared memory (about 3,100 values a point:
//     pe, eight trunk outputs, xyz_final, the dir and t tails, hd, four
//     transient outputs; ~400 KB in bf16 for a 64-point tile against 227 KB
//     a block).  The forward writes them to a per-block scratch in global
//     memory (~0.4 MB in bf16, written and re-read by the same SM, so it
//     stays in L2); shared memory holds the two cotangent buffers being
//     read and written, the head cotangent and the weight slabs.
//   * No float atomics, deterministic: blocks run in no order, so each of
//     a fixed number of persistent blocks (N_PART, near the SM count, not
//     set by N) owns tiles blockIdx.x, blockIdx.x + gridDim.x, ... and
//     accumulates its f32 dW/db in its own partial slab in global memory,
//     in tile order.  A second kernel sums the partial slabs in block
//     order.  Two launches on the same inputs give bitwise-equal results.
//   * dgrad reads each (K, N_out) row-major weight slab as its transpose:
//     column strips of W stream through a double-buffered cp.async ring and
//     feed col-major WMMA fragments; no transposed copy is made.
//   * wgrad contracts over the tile's 64 points: each warp loads an f32
//     accumulator fragment of its partial slab, adds a_in^T g with WMMA
//     (a_in read col-major from the scratch), and stores it back.
//   * Ragged N: rows past N read zero input and zero g, so they add exact
//     zeros to dW/db, and write no d_inp.
// The f32 instance does full-precision FMAs (no TF32); there every
// "round to the compute type" is the identity.
//
// What bounds it: one launch is the forward recompute + dgrad + wgrad,
// 3x the forward's MACs: 684,160 MAC/point with transient heads, 5.4e11
// FLOP at the fine pass's 131,072 points, against ~0.14 GB of input,
// cotangent and d_inp traffic: bound by operations.  This first version is
// simple rather than fast: each 64-point tile reads and writes its block's
// whole 2.8 MB f32 partial slab, the forward recompute runs at one block
// per SM (255 registers), and the activations go through L2; a longer
// wgrad contraction, wgmma and TMA come later.
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
// 2 x 16*nf x (KS_T + PAD_T) elements and, on the bf16 path, the per-warp
// epilogue scratch.
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

  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int NJ = (NFMAX + 1) / 2;
    const int warp = tid >> 5, lane = tid & 31;
    const int mi = warp & 3, nj0 = warp >> 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.0f);

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
      for (int kk = 0; kk < cols; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, G + mi * 16 * ldg + n0 + kk, ldg);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int nj = nj0 + 2 * j;
          if (nj < nf) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
                b;
            wmma::load_matrix_sync(b, cur + nj * 16 * SLD + kk, SLD);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
      }
      __syncthreads();
    }
    float* scratch = reinterpret_cast<float*>(slab) + warp * 256;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nj = nj0 + 2 * j;
      if (nj < nf) {
        wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          epi(mi * 16 + (e >> 4), nj * 16 + (e & 15), scratch[e]);
        __syncwarp();
      }
    }
  } else {
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
  }
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
// N, shared).  Each output element is owned by one warp (bf16) or thread
// (f32), so the read-modify-write needs no synchronisation.  On the bf16
// path a warp takes up to WG fragments of one 16-row strip of dW at a
// time: their accumulator loads are in flight together, and each a_in^T
// fragment feeds WG products.
template <typename T>
__device__ void wgrad(float* dW, int K, int N, AIn<T> a, const T* G,
                      int ldg) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int WG = 8;
    const int warp = threadIdx.x >> 5;
    const int KF = K / 16, NF = N / 16, NG = (NF + WG - 1) / WG;
    for (int f = warp; f < KF * NG; f += WARPS) {
      const int k = (f / NG) * 16, nf0 = (f % NG) * WG;
      const int cnt = min(WG, NF - nf0);
      const T* ap = k < a.split ? a.p0 + k : a.p1 + (k - a.split);
      const int lda = k < a.split ? a.ld0 : a.ld1;
      float* dst = dW + (size_t)k * N + nf0 * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WG];
#pragma unroll
      for (int j = 0; j < WG; ++j)
        if (j < cnt)
          wmma::load_matrix_sync(acc[j], dst + j * 16, N,
                                 wmma::mem_row_major);
#pragma unroll
      for (int m = 0; m < TILE_M; m += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, ap + (size_t)m * lda, lda);
#pragma unroll
        for (int j = 0; j < WG; ++j) {
          if (j < cnt) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(fb, G + m * ldg + (nf0 + j) * 16, ldg);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < WG; ++j)
        if (j < cnt)
          wmma::store_matrix_sync(dst + j * 16, acc[j], N,
                                  wmma::mem_row_major);
    }
  } else {
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
                     Layout L) {
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

template <typename T>
int launch(const float* inp, const float* g, float* d_inp, int n,
           const void* const* w, const float* const* b, const float* sx,
           const float* sd, int nfx, int nfd, int a_dim, int t_dim,
           int has_transient, void* scratch, float* partial, float* grads,
           cudaStream_t stream) {
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
        d.kt, has_transient, static_cast<T*>(scratch), partial, L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (L.stride + 255) / 256;
  reduce_partials<<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
      partial, grads, L.stride, d.n_part);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Workspace sizes for one launch: out[0] scratch bytes, out[1] partial
// floats, out[2] grad floats (every layer's dW then db, in the layer order
// of nerf_fl_torch/ops/fused_mlp.py:pack_weights).  Returns 0, or
// cudaErrorInvalidValue for shapes the kernel does not take.
int nerf_fused_mlp_bwd_sizes(int dtype, int n, int nfx, int nfd, int a_dim,
                             int t_dim, int has_transient, long long* out) {
  Dims d;
  if ((dtype != 0 && dtype != 1) ||
      !dims(n, nfx, nfd, a_dim, t_dim, has_transient, &d))
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(d.k0, d.kd, d.kt, has_transient);
  const Segs S = make_segs(d.k0, d.kd, d.kt);
  const long long elem = dtype == 1 ? 2 : 4;
  out[0] = (long long)d.n_part * TILE_M * S.total * elem;
  out[1] = (long long)d.n_part * L.stride;
  out[2] = L.stride;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  w / b are host arrays of device
// pointers, in the layer order of pack_weights.  scratch / partial are
// workspaces of the sizes above; grads receives the summed f32 grads.
// Returns 0 or the cudaError_t of the first failed launch.
int nerf_fused_mlp_bwd(int dtype, const float* inp, const float* g,
                       float* d_inp, int n, const void* const* w,
                       const float* const* b, const float* sx,
                       const float* sd, int nfx, int nfd, int a_dim,
                       int t_dim, int has_transient, void* scratch,
                       float* partial, float* grads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<bf16>(inp, g, d_inp, n, w, b, sx, sd, nfx, nfd, a_dim,
                        t_dim, has_transient, scratch, partial, grads, s);
  if (dtype == 0)
    return launch<float>(inp, g, d_inp, n, w, b, sx, sd, nfx, nfd, a_dim,
                         t_dim, has_transient, scratch, partial, grads, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
