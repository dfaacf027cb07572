// Shared pieces of the fused PE + NeRF-W MLP kernels (fused_mlp_fwd.cu,
// fused_mlp_bwd.cu) and of the anatomy probes (anatomy_net.cu,
// anatomy_chain.cu, anatomy_pe.cu): the Cody-Waite PE and two blocks to
// build a kernel from, one for each compute type.
//
// The Hopper block (namespace hop, bf16): 128 points a block as two
// consumer warpgroups of 64 rows; wgmma with both operands in shared memory
// in the 128-byte-swizzled layout; weight slabs copied by one producer
// thread with cp.async.bulk from an image that is already the operand's
// shared-memory image, through a ring tracked by mbarriers that runs across
// layers and tiles; setmaxnreg; epilogues on the accumulator fragments.
// Both bf16 fused kernels are built from it, and the backward recomputes
// the forward with these same functions, so its activations (and ReLU
// masks) are bit for bit the forward kernel's.  The chain probes
// (anatomy_chain.cu: chain8, concat, split) are built from it too, each
// with the ring depth its operand tiles leave room for: the ring depth is a
// template parameter whose default is the fused kernels'; so are the net
// probes (anatomy_net.cu), with the fused kernels' three; and the two
// PE-matmul probes (anatomy_pe.cu: pe_mm, pe_mm_bf16), whose small weight
// stays resident and needs no ring.
//
// The f32 Hopper block (namespace tf): the same producer, ring and
// mbarriers, f32 products on the tensor cores as three TF32 passes
// (3xTF32), A from registers, and two consumer warpgroups on the same 64
// rows that split each layer's output columns.  Both f32 fused kernels,
// the sigma-only kernel and the IPE instances (mip-NeRF's field:
// tf::encode_ipe, the skip at layer 5) are built from it;
// fused_mlp_fwd.cu says why it is laid out as it is.
//
// Numerics (all kernels): PE steps use __fmul_rn / __fadd_rn so that no
// multiply-add is contracted; build without --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
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

enum { L_FS = 8, L_DIR = 9, L_RGB = 10, L_T0 = 11, L_TH = 15 };

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// One added to *runs by the first thread of the grid each time a kernel
// runs: the fused kernels' count on the device, which sees a CUDA graph's
// replays as well as direct launches.
__device__ __forceinline__ void count_run(unsigned long long* runs) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&
      threadIdx.y == 0)
    atomicAdd(runs, 1ULL);
}

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

// ======================================================================
// The Hopper block (bf16 only): wgmma from shared memory behind an
// asynchronous weight ring.  See the opening comment for the design.
// ======================================================================
namespace hop {

constexpr int ROWS = 128;                   // points a block holds at a time
constexpr int WG_ROWS = 64;                 // rows of one consumer warpgroup
constexpr int CONSUMERS = ROWS / WG_ROWS;   // consumer warpgroups
constexpr int H_THREADS = 128 * (CONSUMERS + 1);   // + the producer's
constexpr int TILE_BYTES = WG_ROWS * 128;   // a 64 x 64 bf16 operand tile
constexpr int N_TILES = 6;                  // activations: P0 P1 | H0 .. H3
constexpr int T_P = 0;                      // pe, the dir / t tails, 128-wide hiddens
constexpr int T_H = 2;                      // trunk hidden, then xyz_final
constexpr int ACT_BYTES = N_TILES * TILE_BYTES;    // 48 KB a warpgroup
constexpr int STAGES = 3;                   // weight slabs in flight
constexpr int STAGE_BYTES = FS_OUT * 128;   // the tallest slab: fs2's 272 rows
constexpr int MAX_SLABS = 128;
constexpr int BIAS_FLOATS = 3008;
constexpr int SCALE_FLOATS = 2 * IN_LD;     // the xyz and dir scale rows
constexpr int CONST_FLOATS = BIAS_FLOATS + SCALE_FLOATS;
constexpr int SMEM_BYTES = 1024 + CONSUMERS * ACT_BYTES +
                           STAGES * STAGE_BYTES + CONST_FLOATS * 4 +
                           2 * STAGES * 8;

// output width of each packed layer, and where its bias sits in shared memory
__host__ __device__ constexpr int layer_n(int l) {
  return l < L_FS ? W_TRUNK
         : l == L_FS ? FS_OUT
         : (l == L_RGB || l == L_TH) ? OUT_LD : W_HALF;
}
__host__ __device__ constexpr int bias_off(int l) {
  int at = 0;
  for (int i = 0; i < l; ++i) at += layer_n(i);
  return at;
}
static_assert(bias_off(N_LAYERS) <= BIAS_FLOATS, "bias table too small");

// The weight image: every layer's weight cut into slabs of 64 input rows,
// each slab stored as the B operand's shared-memory image (N_out rows of
// 64 K-values = 128 bytes, 16-byte chunk c of row n at chunk c ^ (n % 8)),
// in the order the kernel consumes them.  nerf_fl_torch/ops/fused_mlp.py:
// weight_image lays it out; this is the same walk.
struct Plan {
  int n_slabs;
  int off[MAX_SLABS];     // byte offset of the slab in the image
  int bytes[MAX_SLABS];
};

// One slab of `height` image rows per 64 contraction values.
inline void plan_seg(Plan& p, int& at, int rows, int height) {
  for (int r = 0; r < rows; r += 64) {
    if (p.n_slabs < MAX_SLABS) {
      p.off[p.n_slabs] = at;
      p.bytes[p.n_slabs] = height * 128;
    }
    at += height * 128;
    ++p.n_slabs;
  }
}

// Forward order.  Returns the image's size in bytes.
inline int make_plan(Plan& p, int k0, int kd, int kt, int has_transient) {
  p = Plan{};
  int at = 0;
  plan_seg(p, at, k0, W_TRUNK);
  for (int l = 1; l < 8; ++l) {
    if (l == 4) plan_seg(p, at, k0, W_TRUNK);
    plan_seg(p, at, W_TRUNK, W_TRUNK);
  }
  plan_seg(p, at, W_TRUNK, FS_OUT);
  plan_seg(p, at, W_TRUNK, W_HALF);
  plan_seg(p, at, kd, W_HALF);
  plan_seg(p, at, W_HALF, OUT_LD);
  if (has_transient) {
    plan_seg(p, at, W_TRUNK, W_HALF);
    plan_seg(p, at, kt, W_HALF);
    for (int l = 0; l < 3; ++l) plan_seg(p, at, W_HALF, W_HALF);
    plan_seg(p, at, W_HALF, OUT_LD);
  }
  return at;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and the bulk copy ----
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spins until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16) from global to shared; completion counts on bar
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// bytes from shared to global, tracked by the issuing thread's bulk groups
__device__ __forceinline__ void bulk_s2g(void* dst, uint32_t src,
                                         uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until this thread's bulk stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ordinary shared-memory stores made visible to the asynchronous proxy
// (wgmma's operand reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier over one consumer warpgroup (id 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// ---- wgmma ----
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from reading accumulators before the wait above them
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset, stride byte offset (both in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}
// K-major tile: rows of 64 K-values (128 bytes), 8-row groups 1024 bytes
// apart; a k16 step advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) {
  return sdesc(addr, 16, 1024);
}

// D (64 x N, f32, this warpgroup's registers) = or += A (64 x 16) B (16 x N),
// both from shared memory; TA / TB = 1 reads that operand MN-major.  Thread t
// of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and, for
// each 8-column block j, columns 8 j + 2 (t % 4) (+ 1): d[4 j + 0, 1] in the
// first row, d[4 j + 2, 3] in the second.
template <int N> struct Wgmma;
template <> struct Wgmma<256> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <> struct Wgmma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <> struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <> struct Wgmma<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// The consumer's view of the weight ring.
struct Ring {
  uint32_t full, empty, buf;   // shared addresses: barriers 8 bytes a stage
  uint32_t stride;             // bytes a stage
  int stage;
  uint32_t phase;
  int pending;                 // stage whose products are not yet released
};

// One segment of a layer's contraction: `rows` input columns (a multiple
// of 16) that start at the operand tile at a_tile, one weight slab per 64.
// SIG also multiplies into fs2's 16-column block (the slab's rows 256..271).
template <int N, bool SIG, int NST = STAGES>
__device__ __forceinline__ void mma_seg(float (&acc)[N / 2], float (&sig)[8],
                                        uint32_t a_tile, int rows, Ring& r,
                                        bool& fresh, bool elected) {
  for (int k0 = 0; k0 < rows; k0 += 64, a_tile += TILE_BYTES) {
    mbar_wait(r.full + 8 * r.stage, r.phase);
    const uint32_t b = r.buf + r.stage * r.stride;
    const int steps = min(64, rows - k0) / 16;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < steps) {
        const int sd = fresh ? 0 : 1;
        Wgmma<N>::template run<0, 0>(acc, kdesc(a_tile + 32 * kk),
                                     kdesc(b + 32 * kk), sd);
        if constexpr (SIG)
          Wgmma<16>::template run<0, 0>(
              sig, kdesc(a_tile + 32 * kk),
              kdesc(b + W_TRUNK * 128 + 32 * kk), sd);
        fresh = false;
      }
    }
    wgmma_commit();
    if (r.pending >= 0) {
      wgmma_wait<1>();
      if (elected) mbar_arrive(r.empty + 8 * r.pending);
    }
    r.pending = r.stage;
    if (++r.stage == NST) {
      r.stage = 0;
      r.phase ^= 1;
    }
  }
}

// Waits for the layer's products and releases its last slab.
__device__ __forceinline__ void mma_end(Ring& r, bool elected) {
  wgmma_wait<0>();
  if (elected) mbar_arrive(r.empty + 8 * r.pending);
  r.pending = -1;
}

// The producer: one thread streams the plan's slabs through the ring, once
// per tile of this block, and runs ahead of the consumers by NST slabs
// across layer and tile boundaries.
template <int NST = STAGES>
__device__ __forceinline__ void produce(const unsigned char* image,
                                        const Plan& plan, uint32_t full,
                                        uint32_t empty, uint32_t buf,
                                        uint32_t stride, int n_tiles) {
  int stage = 0;
  uint32_t phase = 1;          // a fresh "empty" barrier lets parity 1 pass
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int s = 0; s < plan.n_slabs; ++s) {
      mbar_wait(empty + 8 * stage, phase);
      mbar_expect_tx(full + 8 * stage, plan.bytes[s]);
      bulk_g2s(buf + stage * stride, image + plan.off[s], plan.bytes[s],
               full + 8 * stage);
      if (++stage == NST) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // a in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of element (r, c) of a warpgroup's activations: tile c / 64,
// row r of 128 bytes, 16-byte chunk swizzled by the row.
__device__ __forceinline__ int act_off(int tile0, int r, int c) {
  return (tile0 + (c >> 6)) * TILE_BYTES + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// Two bf16 values of a packed pair as f32 (exact).
__device__ __forceinline__ float lo_f(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float hi_f(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// The accumulator fragments of a 64 x N product -> bf16 activations at
// tiles tile0.., each pair of neighbouring columns f(sum0, sum1, bias pair)
// packed.  r / q: this thread's fragment row and column-pair index (see
// Wgmma).  The 32-bit stores of a warp fall in 32 different banks.  LDG:
// the bias is in global memory and read through the read-only path.
template <int N, typename F, bool LDG = false>
__device__ __forceinline__ void store_acc(const float (&acc)[N / 2],
                                          unsigned char* act, int tile0,
                                          const float* bias, int r, int q,
                                          F f) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2* bp = reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
    const float2 b = LDG ? __ldg(bp) : *bp;
    unsigned char* p = act + act_off(tile0, r, 8 * j) + q * 4;
    *reinterpret_cast<uint32_t*>(p) = f(acc[4 * j], acc[4 * j + 1], b);
    *reinterpret_cast<uint32_t*>(p + 8 * 128) =
        f(acc[4 * j + 2], acc[4 * j + 3], b);
  }
}

// hidden layer: round the sums, add the (already rounded) bias, round, ReLU;
// two columns at a time on packed bf16 (the same roundings as Hidden)
struct HiddenF {
  __device__ __forceinline__ uint32_t operator()(float v0, float v1,
                                                 float2 b) const {
    const uint32_t y = pack2(v0, v1);
    __nv_bfloat162 h = __floats2bfloat162_rn(lo_f(y) + b.x, hi_f(y) + b.y);
    h = __hmax2(h, __float2bfloat162_rn(0.0f));
    return *reinterpret_cast<uint32_t*>(&h);
  }
};
// fs2's xyz_final: f32 sum + f32 bias, rounded once
struct LinearF {
  __device__ __forceinline__ uint32_t operator()(float v0, float v1,
                                                 float2 b) const {
    return pack2(v0 + b.x, v1 + b.y);
  }
};
// the anatomy probes' hidden layer: relu(sum + f32 bias) in f32, rounded
// once (the Pallas probes' numerics, unlike HiddenF's three roundings)
struct ReluRoundF {
  __device__ __forceinline__ uint32_t operator()(float v0, float v1,
                                                 float2 b) const {
    return pack2(fmaxf(v0 + b.x, 0.0f), fmaxf(v1 + b.y, 0.0f));
  }
};

// [v | sin(2^k v), cos(2^k v) for k < n_freq | extra | 0] times the scale
// row, for this warpgroup's 64 rows -> columns [0, width) of the tiles at
// tile0: the values of tf::pe_at.  Two threads share a row: each reads the
// row's three inputs once (one round trip to memory, which next_rows has
// already brought into L2), then takes every second frequency (six
// independent sin_cw each) and every second column past the trig columns.
// v: the three floats at column src of the packed input row; extra:
// n_extra columns copied from column extra_src (the appearance embedding);
// rows past n are zero.
__device__ __forceinline__ void encode_rows(unsigned char* act, int tile0,
                                            const float* __restrict__ inp,
                                            size_t row0, int n, int src,
                                            int n_freq, const float* scale,
                                            int extra_src, int n_extra,
                                            int width, int t) {
  auto put = [&](int r, int c, float v) {
    *reinterpret_cast<bf16*>(act + act_off(tile0, r, c)) =
        __float2bfloat16_rn(v);
  };
  const int r = t >> 1, half = t & 1;
  const bool live = row0 + r < (size_t)n;
  const float* p = inp + (row0 + r) * IN_LD;
  float v[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    v[0] = p[src];
    v[1] = p[src + 1];
    v[2] = p[src + 2];
  }
  // everything past the trig columns
  const int first = 3 + 6 * n_freq;
  for (int i = half; i < width - first; i += 2)
    put(r, first + i, live && i < n_extra ? p[extra_src + i] : 0.0f);
  if (half == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) put(r, j, __fmul_rn(v[j], scale[j]));
  }
  for (int k = half; k < n_freq; k += 2) {
    const float f = (float)(1 << k);   // exact: 2^k
    const int c0 = 3 + 6 * k;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float arg = __fmul_rn(v[j], f);
      const float sn = __fmul_rn(sin_cw(arg, 0.0f), scale[c0 + j]);
      const float cs = __fmul_rn(sin_cw(arg, 0.25f), scale[c0 + 3 + j]);
      put(r, c0 + j, live ? sn : 0.0f);
      put(r, c0 + 3 + j, live ? cs : 0.0f);
    }
  }
}

// Asks L2 for the first `bytes` of this warpgroup's 64 packed input rows
// of a later tile (two threads a row, 128-byte lines), so that encode_rows
// finds them there.
__device__ __forceinline__ void next_rows(const float* inp, size_t row0, int n,
                                          int bytes, int t) {
  const size_t row = row0 + (t >> 1);
  if (row >= (size_t)n) return;
  const char* p = reinterpret_cast<const char*>(inp + row * IN_LD);
  for (int at = 128 * (t & 1); at < bytes; at += 256)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + at));
}

// ---- pieces of the backward kernels ----

// Backward order: the forward recompute (fs2 without its sigma block, no
// heads), then the dgrad slabs: rows of W itself (input rows, padded to
// 128 or 256) by 64 output columns, in the order fused_mlp_bwd.cu consumes
// them.  Returns the image's size in bytes
// (nerf_fl_torch/ops/fused_mlp.py:bwd_image_plan is the same walk).
inline int make_bwd_plan(Plan& p, int k0, int kd, int kt, int has_transient) {
  p = Plan{};
  int at = 0;
  plan_seg(p, at, k0, W_TRUNK);
  for (int l = 1; l < 8; ++l) {
    if (l == 4) plan_seg(p, at, k0, W_TRUNK);
    plan_seg(p, at, W_TRUNK, W_TRUNK);
  }
  plan_seg(p, at, W_TRUNK, W_TRUNK);          // xyz_final
  plan_seg(p, at, W_TRUNK, W_HALF);           // dir
  plan_seg(p, at, kd, W_HALF);
  if (has_transient) {
    plan_seg(p, at, W_TRUNK, W_HALF);
    plan_seg(p, at, kt, W_HALF);
    for (int l = 0; l < 3; ++l) plan_seg(p, at, W_HALF, W_HALF);
    // dgrad, contraction over each layer's output columns
    plan_seg(p, at, OUT_LD, W_HALF);          // t heads
    for (int l = 0; l < 3; ++l) plan_seg(p, at, W_HALF, W_HALF);   // t3..t1
    plan_seg(p, at, W_HALF, W_TRUNK);         // t0 -> d_xyz_final
    plan_seg(p, at, W_HALF, W_HALF);          // t0 -> d_t
  }
  plan_seg(p, at, OUT_LD, W_HALF);            // rgb head
  plan_seg(p, at, W_HALF, W_TRUNK);           // dir -> d_xyz_final
  plan_seg(p, at, W_HALF, W_HALF);            // dir -> d_tail
  plan_seg(p, at, FS_OUT, W_TRUNK);           // fs2
  for (int l = 7; l >= 1; --l) {
    if (l == 4) plan_seg(p, at, W_TRUNK, W_HALF);   // layer 4 -> d_pe
    plan_seg(p, at, W_TRUNK, W_TRUNK);
  }
  plan_seg(p, at, W_TRUNK, W_HALF);           // layer 0 -> d_pe
  return at;
}

// Where each saved tile lives in the scratch: tile id i of 64-point row
// block rb is the 8 KB at ((i * n_rb) + rb) * TILE_BYTES.  Activations are
// the wgrad's A operands, cotangents (masked, rounded) its B operands.
struct TileMap {
  int pe, h[8], xf, dtail, hd, ttail, th[4];   // activations
  int g[N_LAYERS], gh;                          // cotangents; gh: the heads'
  int total;
};

inline TileMap make_tile_map(int k0, int kd, int kt, int has_transient) {
  TileMap m = {};
  int at = 0;
  auto take = [&](int cols) { int t = at; at += (cols + 63) / 64; return t; };
  m.pe = take(k0);
  for (int i = 0; i < 8; ++i) m.h[i] = take(W_TRUNK);
  m.xf = take(W_TRUNK);
  m.dtail = take(kd);
  m.hd = take(W_HALF);
  if (has_transient) {
    m.ttail = take(kt);
    for (int i = 0; i < 4; ++i) m.th[i] = take(W_HALF);
  }
  m.gh = take(OUT_LD);
  for (int l = 0; l <= L_FS; ++l) m.g[l] = take(W_TRUNK);
  m.g[L_DIR] = take(W_HALF);
  m.g[L_RGB] = m.gh;
  if (has_transient) {
    for (int l = L_T0; l < L_TH; ++l) m.g[l] = take(W_HALF);
    m.g[L_TH] = m.gh;
  }
  m.total = at;
  return m;
}

// n tiles from this warpgroup's shared memory to the scratch (one thread)
__device__ __forceinline__ void save_tiles(unsigned char* scratch, int tile,
                                           int n, size_t n_rb, size_t rb,
                                           uint32_t src) {
  for (int i = 0; i < n; ++i)
    bulk_s2g(scratch + ((size_t)(tile + i) * n_rb + rb) * TILE_BYTES,
             src + i * TILE_BYTES, TILE_BYTES);
  bulk_commit();
}

// Hidden epilogue that also returns the ReLU mask: bit i of m is set where
// the stored value of acc[i] is positive.
template <int N>
__device__ __forceinline__ void store_hidden_mask(const float (&acc)[N / 2],
                                                  unsigned char* act,
                                                  int tile0, const float* bias,
                                                  int r, int q,
                                                  uint32_t (&m)[N / 64]) {
#pragma unroll
  for (int w = 0; w < N / 64; ++w) m[w] = 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
    const uint32_t p0 = HiddenF{}(acc[4 * j], acc[4 * j + 1], b);
    const uint32_t p1 = HiddenF{}(acc[4 * j + 2], acc[4 * j + 3], b);
    // after the ReLU a value is positive exactly when it is not zero
    const uint32_t bits = ((p0 & 0x7fffu) ? 1u : 0u) |
                          ((p0 & 0x7fff0000u) ? 2u : 0u) |
                          ((p1 & 0x7fffu) ? 4u : 0u) |
                          ((p1 & 0x7fff0000u) ? 8u : 0u);
    m[(4 * j) / 32] |= bits << ((4 * j) % 32);
    unsigned char* p = act + act_off(tile0, r, 8 * j) + q * 4;
    *reinterpret_cast<uint32_t*>(p) = p0;
    *reinterpret_cast<uint32_t*>(p + 8 * 128) = p1;
  }
}

// dgrad epilogue: the sum rounded to bf16; ADD: plus the bf16 value already
// at the destination, rounded again (a bf16 add); MASK: zero where the
// forward activation was not positive (bits of m, as store_hidden_mask
// made them); stored as the next operand.  DB: the f32 column sums of the
// stored values over this warp's 16 rows go to db[column] (lanes 0..3).
template <int N, bool MASK, bool ADD, bool DB>
__device__ __forceinline__ void store_cot(const float (&acc)[N / 2],
                                          unsigned char* act, int tile0,
                                          const uint32_t* m, float* db, int r,
                                          int q, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    unsigned char* p = act + act_off(tile0, r, 8 * j) + q * 4;
    uint32_t p0 = pack2(acc[4 * j], acc[4 * j + 1]);
    uint32_t p1 = pack2(acc[4 * j + 2], acc[4 * j + 3]);
    if constexpr (ADD) {
      const uint32_t o0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t o1 = *reinterpret_cast<const uint32_t*>(p + 8 * 128);
      p0 = pack2(lo_f(p0) + lo_f(o0), hi_f(p0) + hi_f(o0));
      p1 = pack2(lo_f(p1) + lo_f(o1), hi_f(p1) + hi_f(o1));
    }
    if constexpr (MASK) {
      const uint32_t bits = m[(4 * j) / 32] >> ((4 * j) % 32);
      p0 &= ((bits & 1u) ? 0xffffu : 0u) | ((bits & 2u) ? 0xffff0000u : 0u);
      p1 &= ((bits & 4u) ? 0xffffu : 0u) | ((bits & 8u) ? 0xffff0000u : 0u);
    }
    *reinterpret_cast<uint32_t*>(p) = p0;
    *reinterpret_cast<uint32_t*>(p + 8 * 128) = p1;
    if constexpr (DB) {
      float s0 = lo_f(p0) + lo_f(p1), s1 = hi_f(p0) + hi_f(p1);
#pragma unroll
      for (int d = 4; d < 32; d <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, d);
        s1 += __shfl_xor_sync(0xffffffffu, s1, d);
      }
      if (lane < 4)
        *reinterpret_cast<float2*>(db + 8 * j + 2 * q) = make_float2(s0, s1);
    }
  }
}

// d_inp[comp] for an input component from its PE columns' cotangents, read
// through d(column): sum of where(trig, cos, 1) * scale * d times the
// column's coefficient (1 on the identity column, 2^k on frequency k), in
// column order.
template <typename D>
__device__ __forceinline__ float pe_bwd_at(float x, int comp, int n_freq,
                                           const float* scale, D d) {
  float acc = __fmul_rn(scale[comp], d(comp));
  for (int k = 0; k < n_freq; ++k) {
    const float f = (float)(1 << k);
    const float arg = __fmul_rn(x, f);
    const int cs = 3 + 6 * k + comp, cc = cs + 3;
    // d sin = cos (+1/4 turn), d cos = -sin (+1/2 turn)
    const float ds = __fmul_rn(__fmul_rn(sin_cw(arg, 0.25f), scale[cs]), d(cs));
    const float dc = __fmul_rn(__fmul_rn(sin_cw(arg, 0.5f), scale[cc]), d(cc));
    acc = __fadd_rn(acc, __fmul_rn(ds, f));
    acc = __fadd_rn(acc, __fmul_rn(dc, f));
  }
  return acc;
}

}  // namespace hop

// ======================================================================
// The f32 Hopper block: products of f32 operands as 3xTF32 wgmma behind the
// hop ring.  The design and its budget are in fused_mlp_fwd.cu's note.
// ======================================================================
namespace tf {

using hop::Ring;

constexpr int ROWS = 64;                  // points a block
constexpr int CONSUMERS = 2;              // consumer warpgroups, all ROWS each
constexpr int THREADS = 128 * (CONSUMERS + 1);   // and the producer's
constexpr int RELEASES = 4 * CONSUMERS;   // arrivals that free a stage, a warp's
constexpr int GROUP = 128;                // float4s of an 8-column group, one a consumer thread
constexpr int GROUP_BYTES = GROUP * 16;   // 2 KB
constexpr int SLOT_BYTES = 8 * GROUP_BYTES;   // a saved tile: 64 points x 64 columns
constexpr int G_P = 0;                    // region P: 16 groups, 128 columns
constexpr int G_H = 16;                   // region H: 32 groups, 256 columns
constexpr int G_G = 48;                   // region G (backward): the heads' cotangent
constexpr int ACT_BYTES = 48 * GROUP_BYTES;     // P and H: 96 KB
constexpr int G_BYTES = 2 * GROUP_BYTES;        // G: 4 KB
constexpr int KC = 32;                    // contraction values a stage: a 128-byte tf32 row
constexpr int PIECE = W_HALF;             // output columns a stage (fs2's last: 144)
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 2 * (PIECE + OUT_LD) * 128;   // hi + lo of 144 rows
constexpr int B_STAGE_BYTES = 2 * PIECE * 128;            // the backward's: 128 rows
constexpr int MAX_PLAN = 384;
constexpr int SMEM_BYTES = 1024 + ACT_BYTES + STAGES * STAGE_BYTES +
                           hop::CONST_FLOATS * 4 + 2 * STAGES * 8;
constexpr int B_SMEM = 1024 + ACT_BYTES + G_BYTES + STAGES * B_STAGE_BYTES +
                       hop::CONST_FLOATS * 4 + 2 * STAGES * 8;
static_assert(SMEM_BYTES <= 232448 && B_SMEM <= 232448, "shared memory");

// The f32 weight image: every layer segment cut into stages of KC
// contraction values by one output piece (pieces: 128 columns, the last up
// to 144), each stage the hi then the lo part (split) of the B operand's
// shared-memory image: `rows` rows of KC tf32 values (128 bytes), 16-byte
// chunk c of row i at chunk c ^ (i % 8).  Within each 8 contraction values
// the order is 0, 2, 4, 6, 1, 3, 5, 7, the A fragments' (mma_seg).
// nerf_fl_torch/ops/fused_mlp.py:f32_image_plan is the same walk.
struct Plan {
  int n_stages;
  unsigned short rows[MAX_PLAN];   // image rows of a part of each stage
};

inline void plan_seg(Plan& p, int& at, int k, int n) {
  const int pieces = n <= PIECE + OUT_LD ? 1 : n / PIECE;
  for (int c = 0; c < k; c += KC)
    for (int h = 0; h < pieces; ++h) {
      const int rows = h < pieces - 1 ? PIECE : n - PIECE * (pieces - 1);
      if (p.n_stages < MAX_PLAN) p.rows[p.n_stages] = (unsigned short)rows;
      ++p.n_stages;
      at += 2 * rows * 128;
    }
}

// Forward order (hop::make_plan's walk).  Returns the image's bytes.
// skip: the trunk layer that takes the encoding again beside the hidden
// state (4, nerf_pl's; 5, mip-NeRF's: the IPE kernels').
inline int make_plan(Plan& p, int k0, int kd, int kt, int has_transient,
                     int skip = 4) {
  p = Plan{};
  int at = 0;
  plan_seg(p, at, k0, W_TRUNK);
  for (int l = 1; l < 8; ++l) {
    if (l == skip) plan_seg(p, at, k0, W_TRUNK);
    plan_seg(p, at, W_TRUNK, W_TRUNK);
  }
  plan_seg(p, at, W_TRUNK, FS_OUT);
  plan_seg(p, at, W_TRUNK, W_HALF);
  plan_seg(p, at, kd, W_HALF);
  plan_seg(p, at, W_HALF, OUT_LD);
  if (has_transient) {
    plan_seg(p, at, W_TRUNK, W_HALF);
    plan_seg(p, at, kt, W_HALF);
    for (int l = 0; l < 3; ++l) plan_seg(p, at, W_HALF, W_HALF);
    plan_seg(p, at, W_HALF, OUT_LD);
  }
  return at;
}

// Backward order (hop::make_bwd_plan's walk): the recompute, then the
// dgrad stages, tiles of W itself (image rows are input rows, contraction
// over output columns).  skip as make_plan's; no_d_inp: the IPE kernels',
// which take no input cotangent and so leave out the stages that only feed
// it (dir -> d_tail, the skip layer's and layer 0's encoding rows).
inline int make_bwd_plan(Plan& p, int k0, int kd, int kt, int has_transient,
                         int skip = 4, bool no_d_inp = false) {
  p = Plan{};
  int at = 0;
  plan_seg(p, at, k0, W_TRUNK);
  for (int l = 1; l < 8; ++l) {
    if (l == skip) plan_seg(p, at, k0, W_TRUNK);
    plan_seg(p, at, W_TRUNK, W_TRUNK);
  }
  plan_seg(p, at, W_TRUNK, W_TRUNK);          // xyz_final
  plan_seg(p, at, W_TRUNK, W_HALF);           // dir
  plan_seg(p, at, kd, W_HALF);
  if (has_transient) {
    plan_seg(p, at, W_TRUNK, W_HALF);
    plan_seg(p, at, kt, W_HALF);
    for (int l = 0; l < 3; ++l) plan_seg(p, at, W_HALF, W_HALF);
    plan_seg(p, at, OUT_LD, W_HALF);          // t heads
    for (int l = 0; l < 3; ++l) plan_seg(p, at, W_HALF, W_HALF);   // t3..t1
    plan_seg(p, at, W_HALF, W_TRUNK);         // t0 -> d_xyz_final
    plan_seg(p, at, W_HALF, W_HALF);          // t0 -> d_t
  }
  plan_seg(p, at, OUT_LD, W_HALF);            // rgb head
  plan_seg(p, at, W_HALF, W_TRUNK);           // dir -> d_xyz_final
  if (!no_d_inp) plan_seg(p, at, W_HALF, W_HALF);   // dir -> d_tail
  plan_seg(p, at, FS_OUT, W_TRUNK);           // fs2
  for (int l = 7; l >= 1; --l) {
    if (l == skip && !no_d_inp)
      plan_seg(p, at, W_TRUNK, W_HALF);       // the skip layer -> d_pe
    plan_seg(p, at, W_TRUNK, W_TRUNK);
  }
  if (!no_d_inp) plan_seg(p, at, W_TRUNK, W_HALF);  // layer 0 -> d_pe
  return at;
}

// The sigma-only forward's walk (fused_mlp_fwd.cu:sigma_trunk_f32_kernel):
// make_plan's trunk, then fs2's sigma block alone as one (256, 16)
// segment.  Returns the image's bytes.
inline int make_sigma_plan(Plan& p, int k0) {
  p = Plan{};
  int at = 0;
  plan_seg(p, at, k0, W_TRUNK);
  for (int l = 1; l < 8; ++l) {
    if (l == 4) plan_seg(p, at, k0, W_TRUNK);
    plan_seg(p, at, W_TRUNK, W_TRUNK);
  }
  plan_seg(p, at, W_TRUNK, OUT_LD);
  return at;
}

// ---- the 3xTF32 split ----
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo + e, |e| <= 2^-22 |x|: hi is x rounded to tf32 (to nearest,
// ties away from zero), lo the rest rounded the same way
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// ---- wgmma, tf32 in, f32 accumulate ----
// D (64 x N) += A (64 x 8) B (8 x N), A from registers, B K-major from
// shared memory.  Thread t of the warpgroup gives A's rows 16 (t / 32) +
// (t % 32) / 4 (a[0], a[2]) and + 8 (a[1], a[3]) at contraction index t % 4
// (a[0], a[1]) and t % 4 + 4 (a[2], a[3]); D's fragments as hop::Wgmma's.
template <int N> struct Wgmma32;
template <> struct Wgmma32<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma32<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma32<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
// D (64 x N) += A (64 x 8) B (8 x N), both K-major from shared memory (the
// wgrad's).
template <int N> struct WgmmaSS;
template <> struct WgmmaSS<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct WgmmaSS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct WgmmaSS<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---- the private layout of activations and cotangents ----
// Element (r, c) of a 64-row region that starts at 8-column group g0 is
// held by the consumer thread t = 32 (r / 16) + 4 (r % 8) + (c % 8) / 2
// that computes it in a product's fragments (hop::Wgmma): float4
// (g0 + c / 8) * GROUP + t, component 2 ((r / 8) % 2) + c % 2.  A thread's
// float4 of group j is so its accumulators 4 j .. 4 j + 3, and, split, its
// A fragment of the contraction values 8 j .. 8 j + 7 in the image's order
// (Wgmma32).  Thread t of each of the CONSUMERS warpgroups holds the same
// rows, and warpgroup w computes and writes the column groups of its share
// of each layer's output (w N / CONSUMERS ..), so a product reads every
// warpgroup's writes: a barrier over the consumers between layers.
__device__ __forceinline__ int at(int g0, int r, int c) {
  return ((g0 + (c >> 3)) * GROUP + 32 * (r >> 4) + 4 * (r & 7) +
          ((c & 7) >> 1)) * 4 + 2 * ((r >> 3) & 1) + (c & 1);
}

// barrier over the consumer warpgroups
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
}

// A float4 of the private layout as hi and lo A fragments.
__device__ __forceinline__ void split_a(const float4 v, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(v.x, hi[0], lo[0]);
  split(v.z, hi[1], lo[1]);
  split(v.y, hi[2], lo[2]);
  split(v.w, hi[3], lo[3]);
}

// Accumulators a thread holds of an N-column product: its warpgroup's
// share, or all 16 columns of a head (warpgroup 1 computes those).
template <int N> __host__ __device__ constexpr int share() {
  return N == OUT_LD ? OUT_LD / 2 : N / 2 / CONSUMERS;
}

// One segment of a layer's contraction: `cols` input columns (a multiple
// of 16) of the private region g0, KC a stage; each stage holds one output
// piece of the layer's N columns (256: two pieces of 128), hi rows then lo
// rows.  Three passes a k8 step: hi x hi, lo x hi, hi x lo.  A stage's
// products all issue whatever its real columns (the image and the A
// fragments are zero past them): no wgmma sits behind a branch, which
// ptxas would answer by serializing them.
// Warpgroup wg computes its share of the N columns: piece wg of a 256-wide
// layer (a stage of its own) or rows 64 wg .. of a 128-wide layer's one stage,
// 64 accumulators a thread at most.  A 16-column product (N = OUT_LD: the
// heads, the sigma kernel's sigma block) is warpgroup 1's whole, while
// warpgroup 0 passes its stages.  SIG (fs2): piece 1 has 16 more rows, the
// sigma block, which warpgroup 1 multiplies into sig beside its piece;
// warpgroup 0 issues the same products on rows of its own stage and never reads
// that sig, so that which products a stage issues does not depend on the
// warpgroup.  The next KC columns' A values are loaded while this KC's products
// run, and split once they are done.  Every warp waits for every stage of the
// ring in order and then arrives on its "empty" barrier once (RELEASES): a
// stage it reads after its own products, the other warpgroup's piece of a
// 256-wide layer as soon as it has seen it land (warpgroup 1 before its own
// piece, warpgroup 0 after releasing its own).  A parity wait is only sound on
// a stage whose previous fill the waiter has seen land (copies may land out of
// order) and whose next fill cannot land before the waiter has seen this one; a
// warp that skipped stages, or a stage released for a warpgroup by one of its
// warps, breaks one or the other.  With three stages a warpgroup holds one at a
// time, one in use by each warpgroup and one landing: keeping a second in
// flight (wait<1>) starves the other warpgroup of stages.
template <int N, bool SIG = false>
__device__ __forceinline__ void mma_seg(float (&acc)[share<N>()],
                                        float (&sig)[8], const float4* act,
                                        int g0, int cols, Ring& r,
                                        bool& fresh, int t, int wg) {
  static_assert(N == W_TRUNK || N == W_HALF || N == OUT_LD, "widths");
  static_assert(!SIG || N == W_TRUNK, "the sigma block rides fs2");
  constexpr int PIECES = N == W_TRUNK ? 2 : 1;
  constexpr int NP = 2 * share<N>();
  float(&d)[NP / 2] = acc;
  const uint32_t rows = N == W_HALF ? wg * NP * 128 : 0;
  // image rows of a part of this warpgroup's stage
  const uint32_t height =
      N == OUT_LD ? OUT_LD : PIECE + (SIG && wg == 1 ? OUT_LD : 0);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 v[4];
  uint32_t ah[4][4], al[4][4];
  // the A values of the KC columns at k0 (zeros past cols)
  auto load = [&](int k0) {
    const int steps = min(KC, cols - k0) / 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      v[kk] = kk < steps ? act[(g0 + k0 / 8 + kk) * GROUP + t] : zero;
  };
  const bool lead = (t & 31) == 0;
  // the ring's next stage, once it has landed
  auto take = [&]() {
    hop::mbar_wait(r.full + 8 * r.stage, r.phase);
    const int s = r.stage;
    if (++r.stage == STAGES) {
      r.stage = 0;
      r.phase ^= 1;
    }
    return s;
  };
  // the other warpgroup's piece: seen to land, then passed
  auto pass = [&]() {
    const int s = take();
    if (lead) hop::mbar_arrive(r.empty + 8 * s);
  };
  if (N == OUT_LD && wg == 0) {   // warpgroup 1's product
    for (int k0 = 0; k0 < cols; k0 += KC) pass();
    return;
  }
  load(0);
  for (int k0 = 0; k0 < cols; k0 += KC) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split_a(v[kk], ah[kk], al[kk]);
    if (PIECES == 2 && wg == 1) pass();   // piece 0: warpgroup 0's
    const int s = take();
    const uint32_t hi = r.buf + s * r.stride + rows;
    const uint32_t lo = hi + height * 128;
    const int sd = fresh ? 0 : 1;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma32<NP>::run(d, ah[kk], hop::kdesc(hi + 32 * kk),
                       kk == 0 ? sd : 1);
      Wgmma32<NP>::run(d, al[kk], hop::kdesc(hi + 32 * kk), 1);
      Wgmma32<NP>::run(d, ah[kk], hop::kdesc(lo + 32 * kk), 1);
      if constexpr (SIG) {
        const uint32_t b = hi + NP * 128 + 32 * kk;
        Wgmma32<16>::run(sig, ah[kk], hop::kdesc(b), kk == 0 ? sd : 1);
        Wgmma32<16>::run(sig, al[kk], hop::kdesc(b), 1);
        Wgmma32<16>::run(sig, ah[kk], hop::kdesc(b + height * 128), 1);
      }
    }
    hop::wgmma_commit();
    fresh = false;
    if (k0 + KC < cols) load(k0 + KC);
    // this warp's products are done
    hop::wgmma_wait<0>();
    if (lead) hop::mbar_arrive(r.empty + 8 * s);
    if (PIECES == 2 && wg == 0) pass();   // piece 1: warpgroup 1's
  }
  hop::fence_acc(acc);
  if constexpr (SIG) hop::fence_acc(sig);
}

// The producer: one thread streams the plan's stages through the ring once
// per tile of this block, running ahead of the consumers by STAGES.
__device__ __forceinline__ void produce(const unsigned char* image,
                                        const Plan& plan, uint32_t full,
                                        uint32_t empty, uint32_t buf,
                                        uint32_t stride, int n_tiles) {
  int stage = 0;
  uint32_t phase = 1;          // a fresh "empty" barrier lets parity 1 pass
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const unsigned char* src = image;
    for (int s = 0; s < plan.n_stages; ++s) {
      const uint32_t bytes = 2u * 128u * plan.rows[s];
      hop::mbar_wait(empty + 8 * stage, phase);
      hop::mbar_expect_tx(full + 8 * stage, bytes);
      hop::bulk_g2s(buf + stage * stride, src, bytes, full + 8 * stage);
      src += bytes;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// Column c < 3 + 6 n_freq of the positional encoding of (x0, x1, x2) times
// the column's scale: the values of hop::encode_rows, in f32.
__device__ __forceinline__ float pe_at(float x0, float x1, float x2, int c,
                                       const float* scale) {
  float e;
  if (c < 3) {
    e = c == 0 ? x0 : (c == 1 ? x1 : x2);
  } else {
    const int k = (c - 3) / 6, j = (c - 3) % 6, m = j % 3;
    const float x = m == 0 ? x0 : (m == 1 ? x1 : x2);
    e = sin_cw(__fmul_rn(x, (float)(1 << k)), j >= 3 ? 0.25f : 0.0f);
  }
  return __fmul_rn(e, scale[c]);
}

// Columns [0, width) of this thread's rows (16 w + g and + 8) into its
// private region g0: with pe, the encoding of the three values at column
// src (pe_at), then n_extra columns copied from column extra_src; without,
// the copied columns alone; zeros past them and in rows past n.  LD: the
// input's row stride in floats (the packed row's, or 3 for bare positions).
// Warpgroup wg writes every CONSUMERS-th 8-column group from its wg-th.
template <int LD = IN_LD>
__device__ __forceinline__ void encode(float4* act, int g0,
                                       const float* __restrict__ inp,
                                       size_t row0, int n, bool pe, int src,
                                       int n_freq, const float* scale,
                                       int extra_src, int n_extra, int width,
                                       int t, int wg) {
  const int r = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
  const int first = pe ? 3 + 6 * n_freq : 0;
  float x[2][3];
  const float* p[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = row0 + r + 8 * h;
    live[h] = row < (size_t)n;
    p[h] = inp + (live[h] ? row : 0) * LD;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      x[h][k] = live[h] && pe ? p[h][src + k] : 0.0f;
  }
  for (int j = wg; j < width / 8; j += CONSUMERS) {
    float o[4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e;
        float v = 0.0f;
        if (live[h]) {
          if (c < first)
            v = pe_at(x[h][0], x[h][1], x[h][2], c, scale);
          else if (c < first + n_extra)
            v = p[h][extra_src + c - first];
        }
        o[2 * h + e] = v;
      }
    act[(g0 + j) * GROUP + t] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Columns [0, width) of the integrated positional encoding (mip-NeRF's
// IPE) of this thread's rows (16 w + g and + 8) into its private region g0.
// Column c < 3 n_freq is sin(2^l m_k) exp(-4^l v_k / 2) with l = c / 3 and
// k = c % 3, column c + 3 n_freq the same with the cosine (a quarter turn
// added after reduction, as pe_at's); m = columns 0..2 of the packed row
// (the Gaussian's mean), v = columns 6..8 (its diagonal variance).  Zeros
// past 6 n_freq and in rows past n.  2^l m and -4^l v / 2 are exact, so
// each value is one sin_cw and one expf, rounded once by the product.
// Warpgroup wg writes every CONSUMERS-th 8-column group from its wg-th.
__device__ __forceinline__ void encode_ipe(float4* act, int g0,
                                           const float* __restrict__ inp,
                                           size_t row0, int n, int n_freq,
                                           int width, int t, int wg) {
  const int r = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
  const int half = 3 * n_freq;
  float m[2][3], v[2][3];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = row0 + r + 8 * h;
    live[h] = row < (size_t)n;
    const float* p = inp + (live[h] ? row : 0) * IN_LD;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m[h][k] = live[h] ? p[k] : 0.0f;
      v[h][k] = live[h] ? p[6 + k] : 0.0f;
    }
  }
  for (int j = wg; j < width / 8; j += CONSUMERS) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * q + e;
      const bool cosine = c >= half;
      const int cc = cosine ? c - half : c;
      const int l = cc / 3, k = cc % 3;
      const float f = (float)(1 << l);                 // exact: 2^l
      const float a = -0.5f * (float)(1 << l) * (float)(1 << l);   // -4^l / 2
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float val = 0.0f;
        if (live[h] && c < 2 * half) {
          const float mk = k == 0 ? m[h][0] : (k == 1 ? m[h][1] : m[h][2]);
          const float vk = k == 0 ? v[h][0] : (k == 1 ? v[h][1] : v[h][2]);
          val = __fmul_rn(sin_cw(__fmul_rn(mk, f), cosine ? 0.25f : 0.0f),
                          expf(__fmul_rn(vk, a)));
        }
        o[2 * h + e] = val;
      }
    }
    act[(g0 + j) * GROUP + t] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Hidden layer epilogue: relu(sum + bias) in f32 into region g0; with M
// also the ReLU bits (hop::store_hidden_mask's packing: bit i of word
// 4 j / 32, at 4 j % 32 + i, for accumulator 4 j + i, set where the stored
// value is positive).  acc is warpgroup wg's share of the N columns
// (mma_seg's), stored as those columns.
template <int N, bool M>
__device__ __forceinline__ void store_hidden(const float (&acc)[share<N>()],
                                             float4* act, int g0,
                                             const float* bias, int q, int t,
                                             uint32_t* m, int wg) {
  constexpr int NC = N / CONSUMERS;
  const int c0 = wg * NC;
  g0 += c0 / 8;
  bias += c0;
  if (M)
#pragma unroll
    for (int w = 0; w < NC / 64; ++w) m[w] = 0;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
    const float4 o = make_float4(
        fmaxf(acc[4 * j] + b.x, 0.0f), fmaxf(acc[4 * j + 1] + b.y, 0.0f),
        fmaxf(acc[4 * j + 2] + b.x, 0.0f), fmaxf(acc[4 * j + 3] + b.y, 0.0f));
    act[(g0 + j) * GROUP + t] = o;
    if (M)
      m[(4 * j) / 32] |= ((o.x > 0.0f ? 1u : 0u) | (o.y > 0.0f ? 2u : 0u) |
                          (o.z > 0.0f ? 4u : 0u) | (o.w > 0.0f ? 8u : 0u))
                         << ((4 * j) % 32);
  }
}

// fs2's xyz_final: sum + bias in f32 into region g0 (store_hidden's share)
template <int N>
__device__ __forceinline__ void store_linear(const float (&acc)[share<N>()],
                                             float4* act, int g0,
                                             const float* bias, int q, int t,
                                             int wg) {
  constexpr int NC = N / CONSUMERS;
  const int c0 = wg * NC;
  g0 += c0 / 8;
  bias += c0;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
    act[(g0 + j) * GROUP + t] =
        make_float4(acc[4 * j] + b.x, acc[4 * j + 1] + b.y,
                    acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
  }
}

// dgrad epilogue (hop::store_cot's, in f32): ADD, plus the value already
// there; MASK, zero where the forward activation was not positive (bits of
// m, as store_hidden made them); DB, the column sums of the stored values
// over this warp's 16 rows to db[column] (lanes 0..3).  acc: store_hidden's
// share (db is the layer's whole row).
template <int N, bool MASK, bool ADD, bool DB>
__device__ __forceinline__ void store_cot(const float (&acc)[share<N>()],
                                          float4* act, int g0,
                                          const uint32_t* m, float* db, int q,
                                          int t, int lane, int wg) {
  constexpr int NC = N / CONSUMERS;
  const int c0 = wg * NC;
  g0 += c0 / 8;
  if constexpr (DB) db += c0;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    float4* p = act + (g0 + j) * GROUP + t;
    float4 v = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                           acc[4 * j + 3]);
    if constexpr (ADD) {
      const float4 o = *p;
      v = make_float4(v.x + o.x, v.y + o.y, v.z + o.z, v.w + o.w);
    }
    if constexpr (MASK) {
      const uint32_t bits = m[(4 * j) / 32] >> ((4 * j) % 32);
      v = make_float4(bits & 1u ? v.x : 0.0f, bits & 2u ? v.y : 0.0f,
                      bits & 4u ? v.z : 0.0f, bits & 8u ? v.w : 0.0f);
    }
    *p = v;
    if constexpr (DB) {
      float s0 = v.x + v.z, s1 = v.y + v.w;
#pragma unroll
      for (int d = 4; d < 32; d <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, d);
        s1 += __shfl_xor_sync(0xffffffffu, s1, d);
      }
      if (lane < 4)
        *reinterpret_cast<float2*>(db + 8 * j + 2 * q) = make_float2(s0, s1);
    }
  }
}

// The first ceil(cols / 8) groups of the private region at src (a shared
// address) to tile slots tile, tile + 1, ... of row block rb in the
// scratch: slot i of rb at ((i * n_rb) + rb) * SLOT_BYTES.  One thread of
// each consumer warpgroup: warpgroup wg's takes every CONSUMERS-th slot.
__device__ __forceinline__ void save(unsigned char* scratch, int tile,
                                     int cols, size_t n_rb, size_t rb,
                                     uint32_t src, int wg) {
  const int groups = (cols + 7) / 8;
  for (int i = wg; 8 * i < groups; i += CONSUMERS)
    hop::bulk_s2g(scratch + ((size_t)(tile + i) * n_rb + rb) * SLOT_BYTES,
                  src + i * SLOT_BYTES,
                  (groups - 8 * i < 8 ? groups - 8 * i : 8) * GROUP_BYTES);
  hop::bulk_commit();
}

}  // namespace tf

}  // namespace
