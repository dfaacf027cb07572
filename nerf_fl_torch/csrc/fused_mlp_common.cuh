// Shared pieces of the fused PE + NeRF-W MLP kernels (fused_mlp_fwd.cu,
// fused_mlp_bwd.cu) and of the anatomy probes built from the same blocks
// (anatomy_net.cu, anatomy_chain.cu, anatomy_pe.cu): tile shape, compute-type traits, the Cody-Waite PE,
// the cp.async weight-slab loader and the forward matrix product with its
// hidden-layer epilogue.  The backward kernel recomputes the forward with
// this same code, so its activations (and ReLU masks) are bit for bit the
// forward kernel's.
//
// Numerics (both kernels): PE steps use __fmul_rn / __fadd_rn so that no
// multiply-add is contracted; build without --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TILE_M = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int IN_LD = 128;     // packed input row
constexpr int OUT_LD = 16;     // packed output row
constexpr int W_TRUNK = 256;
constexpr int W_HALF = 128;
constexpr int ACT_W = 384;     // widest layer input: [pe | h] or [xyz_final | tail]
constexpr int FS_OUT = W_TRUNK + 16;
constexpr int N_LAYERS = 16;   // trunk 0..7, fs2, dir, rgb, t0..t3, t heads

// Cody-Waite constants, as in nerf_fl_torch/core/encoding.py
constexpr float INV_2PI = 0.15915494309189535f;
constexpr float TWO_PI_HI = 6.28125f;
constexpr float TWO_PI_LO = 0.0019353071795864769f;
__constant__ float SIN2PI[6] = {6.2831834654095857f, -41.341480259587343f,
                                81.597655247118169f, -76.594899673933057f,
                                41.269796373562237f, -12.37227202917199f};

struct Net {
  const void* w[N_LAYERS];   // (K_pad, N_out) row-major, compute type
  const float* b[N_LAYERS];  // (N_out,) f32
};

enum { L_FS = 8, L_DIR = 9, L_RGB = 10, L_T0 = 11, L_TH = 15 };

template <typename T> struct Cfg;
// KS / PAD: the forward product's weight slab (KS rows of W, row padding);
// KS_T / PAD_T: the backward's transposed slab (KS_T columns of W).
template <> struct Cfg<bf16> {
  static constexpr int KS = 32;              // slab rows
  static constexpr int PAD = 8;              // 16 bytes of row padding
  static constexpr int KS_T = 32;
  static constexpr int PAD_T = 8;
};
template <> struct Cfg<float> {
  static constexpr int KS = 16;
  static constexpr int PAD = 4;
  static constexpr int KS_T = 8;
  static constexpr int PAD_T = 0;
};

template <typename T> __device__ __forceinline__ T to_t(float v);
template <> __device__ __forceinline__ bf16 to_t<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float to_t<float>(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// sin(x + 2 pi q) by Cody-Waite reduction and an odd polynomial in turns.
__device__ __forceinline__ float sin_cw(float x, float q) {
  float n = rintf(__fmul_rn(x, INV_2PI));
  float r = __fsub_rn(x, __fmul_rn(n, TWO_PI_HI));
  r = __fsub_rn(r, __fmul_rn(n, TWO_PI_LO));
  float u = __fadd_rn(__fmul_rn(r, INV_2PI), q);
  u = __fsub_rn(u, rintf(u));
  float u2 = __fmul_rn(u, u);
  float p = SIN2PI[5];
#pragma unroll
  for (int k = 4; k >= 0; --k) p = __fadd_rn(__fmul_rn(p, u2), SIN2PI[k]);
  return __fmul_rn(p, u);
}

// Column c of the positional encoding [x, sin(f0 x), cos(f0 x), ...] of the
// three values at v, times the per-column scale (BARF weight; 0 on padding).
__device__ __forceinline__ float pe_col(const float* v, int c, int n_freq,
                                        const float* scale) {
  float e;
  if (c < 3) {
    e = v[c];
  } else if (c < 3 + 6 * n_freq) {
    int k = (c - 3) / 6, j = (c - 3) % 6;
    float arg = __fmul_rn(v[j % 3], (float)(1 << k));   // exact: 2^k
    e = sin_cw(arg, j >= 3 ? 0.25f : 0.0f);
  } else {
    e = 0.0f;
  }
  return __fmul_rn(e, scale[c]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [k0, k0 + rows) of the (K, NOUT) weight W into a slab of ld NOUT+PAD.
// ldw is W's row stride in elements: NOUT for a weight of its own, more for
// a column block of a wider stacked operand (then W points at the block's
// first column, a multiple of 16 bytes in).
template <typename T, int NOUT>
__device__ __forceinline__ void load_slab(T* slab, const T* W, int k0,
                                          int rows, int ldw = NOUT) {
  constexpr int EPC = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int CPR = NOUT / EPC;              // chunks per row
  constexpr int SLD = NOUT + Cfg<T>::PAD;
  const int total = rows * CPR;
  for (int c = threadIdx.x; c < total; c += THREADS) {
    int r = c / CPR, q = c % CPR;
    cp_async16(slab + r * SLD + q * EPC, W + (size_t)(k0 + r) * ldw + q * EPC);
  }
}

// C (TILE_M x 16*NF) = A (TILE_M x K, shared, ld lda) @ W (K x 16*NF,
// global), then epi(row, col, value) once per element.  A may be
// overwritten by epi: every warp finishes reading A before any epi runs.
// K is a multiple of 16.  slab holds 2 x KS x (16*NF + PAD) elements; on
// the bf16 path it doubles as the per-warp epilogue scratch.  ldw: W's row
// stride, as in load_slab.
template <typename T, int NF, typename Epi>
__device__ void gemm(const T* A, int lda, int K, const T* W, T* slab,
                     Epi epi, int ldw = 16 * NF) {
  constexpr int NOUT = 16 * NF;
  constexpr int KS = Cfg<T>::KS;
  constexpr int SLD = NOUT + Cfg<T>::PAD;
  const int nslab = (K + KS - 1) / KS;
  const int tid = threadIdx.x;

  load_slab<T, NOUT>(slab, W, 0, min(KS, K), ldw);
  cp_async_commit();

  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int NJ = (NF + 1) / 2;
    const int warp = tid >> 5, lane = tid & 31;
    const int mi = warp & 3, nj0 = warp >> 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.0f);

    for (int s = 0; s < nslab; ++s) {
      const int k0 = s * KS;
      if (s + 1 < nslab)
        load_slab<T, NOUT>(slab + ((s + 1) & 1) * KS * SLD, W, k0 + KS,
                           min(KS, K - k0 - KS), ldw);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* cur = slab + (s & 1) * KS * SLD;
      const int rows = min(KS, K - k0);
      for (int kk = 0; kk < rows; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + mi * 16 * lda + k0 + kk, lda);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int nj = nj0 + 2 * j;
          if (nj < NF) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                b;
            wmma::load_matrix_sync(b, cur + kk * SLD + nj * 16, SLD);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
      }
      __syncthreads();
    }
    // epilogue through a 16 x 16 f32 scratch per warp (aliases the slab,
    // which every warp has finished reading)
    float* scratch = reinterpret_cast<float*>(slab) + warp * 256;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nj = nj0 + 2 * j;
      if (nj < NF) {
        wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          epi(mi * 16 + (e >> 4), nj * 16 + (e & 15), scratch[e]);
        __syncwarp();
      }
    }
  } else {
    // f32: full-precision FMAs on the CUDA cores, no TF32.  Thread owns
    // rows 4*rg..4*rg+3 and columns cg + 16*j.
    const int cg = tid & 15, rg = tid >> 4;
    float acc[4][NF];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) acc[i][j] = 0.0f;

    for (int s = 0; s < nslab; ++s) {
      const int k0 = s * KS;
      if (s + 1 < nslab)
        load_slab<T, NOUT>(slab + ((s + 1) & 1) * KS * SLD, W, k0 + KS,
                           min(KS, K - k0 - KS), ldw);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* cur = slab + (s & 1) * KS * SLD;
      const int rows = min(KS, K - k0);
      for (int kk = 0; kk < rows; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(rg * 4 + i) * lda + k0 + kk];
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const float b = cur[kk * SLD + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) epi(rg * 4 + i, cg + 16 * j, acc[i][j]);
  }
  __syncthreads();
}

// hidden layer epilogue: round, add the rounded bias, ReLU
template <typename T> struct Hidden {
  T* dst;
  int ld;
  const float* bias;
  __device__ void operator()(int r, int c, float v) const {
    float y = to_f(to_t<T>(v));
    float b = to_f(to_t<T>(bias[c]));
    float h = to_f(to_t<T>(y + b));
    dst[r * ld + c] = to_t<T>(fmaxf(h, 0.0f));
  }
};

}  // namespace
