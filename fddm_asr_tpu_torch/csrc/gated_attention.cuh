// Shared pieces of the gated-attention kernels (gated_attention.cu, the
// forward; gated_attention_bwd.cu, the backward): tile sizes, the masked-key
// score, the list of a batch row's key tiles that hold a kept key, the bf16
// tensor-core helpers (A fragments, wgmma), the 128-byte swizzled tile
// layout, mbarriers, TMA and its tensor maps, and the 3xTF32 pieces of the
// float32 kernels (the split, tf32 wgmma, the swizzled f32 layout, the
// fragment permutation, the warpgroup roles and their setmaxnreg budgets).
// The fused int8 matmul (int8_matmul_fused.cu) and the fused conv
// (conv_ln_gelu.cu) take the Hopper part: mbarriers, TMA, the swizzled
// descriptors and the s8, bf16 and tf32 m64n256 wgmma; the fused conv's
// float32 kernel also the split and the swizzled f32 layout.
//
// Fragment layouts of mma.m16n8k16, which are wgmma's per warp (below)
// (g = lane / 4, t = lane % 4):
//   A [16 x 16], row-major: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same
//     cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B [16 x 8], "col": b0 (rows 2t, 2t+1 of column g), b1 (rows 2t+8, 2t+9);
//   C [16 x 8] f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the accumulator of a product over 16 columns (two n8 tiles) is, once
// packed to bf16, the A fragment of the next product over those columns:
// the kernels chain S -> P -> P.V (and dS -> dS.K) without shared memory.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>
#include <cstdio>

namespace fddm {

constexpr int DH = 64;   // head dim (the only one WavLM uses)
constexpr int BQ = 64;   // queries per tile
constexpr int BK = 64;   // keys per tile
constexpr float NEG = -FLT_MAX;  // the masked-key score (f32-min)

typedef __nv_bfloat16 bf16;

static_assert(BK == DH && BQ == DH, "the bf16 tiles' rows are 64 elements, 128 bytes");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent bf16 (4-byte aligned) as one register; 0 when the row is past L.
__device__ __forceinline__ uint32_t load_pair(const bf16* p, bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// The A fragments of 16 rows x 64 head dims of a head-packed matrix (rows r0
// and r1 = r0 + 8 of the thread, each a pointer to the row's head slice).
__device__ __forceinline__ void load_a_fragments(uint32_t a[4][4], const bf16* row0,
                                                 const bf16* row1, bool valid0, bool valid1,
                                                 int t) {
  #pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + 2 * t;
    a[ks][0] = load_pair(row0 + c, valid0);
    a[ks][1] = load_pair(row1 + c, valid1);
    a[ks][2] = load_pair(row0 + c + 8, valid0);
    a[ks][3] = load_pair(row1 + c + 8, valid1);
  }
}

// keep flag of key kj of batch row b: 1 kept, 0 masked, -1 beyond L
__device__ __forceinline__ float keep_flag(const uint8_t* mask, int b, int kj, int L) {
  return kj >= L ? -1.f : (mask == nullptr || mask[(size_t)b * L + kj]) ? 1.f : 0.f;
}

// Warp 0: the indices i < n whose flags[i] is set, in order, into list[0..m)
// and m into *n_out.
__device__ __forceinline__ void compact_flags(const uint8_t* flags, int n, uint16_t* list,
                                              int* n_out) {
  const int lane = threadIdx.x & 31;
  int m = 0;
  for (int base = 0; base < n; base += 32) {
    const bool set = base + lane < n && flags[base + lane];
    const uint32_t vote = __ballot_sync(0xffffffffu, set);
    if (set) list[m + __popc(vote & ((1u << lane) - 1))] = (uint16_t)(base + lane);
    m += __popc(vote);
  }
  if (lane == 0) *n_out = m;
}

// The key tiles (64 keys) of a batch row that hold a kept key: a flag byte
// a tile in any_kept[nsteps], then the tiles in order in live[0..n) and n in
// *nlive (warp 0 writes those).  Every one of the block's kThreads threads
// calls it, 16 threads a tile; read the list after a __syncthreads().
template <int kThreads>
__device__ __forceinline__ void list_live_tiles(const uint8_t* mask_b, int L, int nsteps,
                                                uint8_t* any_kept, uint16_t* live,
                                                int* nlive) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < nsteps * 16; base += kThreads) {
    const int i = base + threadIdx.x;
    const int c0 = (i >> 4) * BK + (i & 15) * 4;
    bool any = false;
    if (i < nsteps * 16) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) any |= c0 + e < L && mask_b[c0 + e] != 0;
    }
    const uint32_t vote = __ballot_sync(0xffffffffu, any);
    if ((lane & 15) == 0 && i < nsteps * 16)
      any_kept[i >> 4] = ((vote >> (lane & 16)) & 0xffffu) != 0;
  }
  __syncthreads();
  if (threadIdx.x < 32) compact_flags(any_kept, nsteps, live, nlive);
}

// ------------------------------------------------------------------ Hopper
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Every tile of the ring has 128-byte rows (64 bf16) under the 128-byte
// swizzle that TMA writes and wgmma's descriptors read: the 16-byte chunk c
// of row r sits at chunk c ^ (r % 8), the pattern repeating every 1024 bytes.
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * DH + ((chunk ^ (row & 7)) << 3);
}

// mbarriers (shared::cta)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at (c0, c1, c2) of a 3-d tensor map into shared memory; its
// bytes count towards the mbarrier's expected transaction count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// TMA: the box at (c0, c1) of a 2-d tensor map, likewise.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma (sm_90a): a warpgroup's [64 x 64] f32 accumulator is, per warp, the
// mma.sync C layout of its 16 rows over 8 tiles of 8 columns (d[j][e]), and
// the register A operand is the mma.sync A fragment of those 16 rows.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void reg_fence(float d[8][4]) {
  #pragma unroll
  for (int j = 0; j < 8; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Descriptor of a 128B-swizzled bf16 tile in shared memory (128-byte rows,
// 8-row groups 1024 bytes apart; `lbo` is the byte stride between swizzle
// atoms along M/N, used by MN-major operands only).
__device__ __forceinline__ uint64_t sw128_desc(const void* smem_ptr, uint32_t lbo) {
  return (uint64_t)((smem_addr(smem_ptr) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d[64 x 64] (+)= a[64 x 16] (registers) . B[16 x 64] (descriptor); kTransB
// says B is stored MN-major ([k][n], n contiguous) rather than K-major.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float d[8][4], const uint32_t a[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB),
        "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both from descriptors (A K-major;
// kTransB as above).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float d[8][4], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

// The int8 product of int8_matmul_fused.cu: d[64 x 256] (+)= A[64 x 32] .
// B[32 x 256], s8 x s8 -> s32, both operands K-major from descriptors (the
// only layout integer wgmma takes).  The s32 accumulator has the f32 one's
// layout: d[j][e] is column tile j (8 columns), rows g / g + 8 of the warp's 16.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int d[32][4], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
#define FDDM_D4(j) "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p;\n}\n"
      : FDDM_D4(0), FDDM_D4(1), FDDM_D4(2), FDDM_D4(3), FDDM_D4(4), FDDM_D4(5), FDDM_D4(6),
        FDDM_D4(7), FDDM_D4(8), FDDM_D4(9), FDDM_D4(10), FDDM_D4(11), FDDM_D4(12),
        FDDM_D4(13), FDDM_D4(14), FDDM_D4(15), FDDM_D4(16), FDDM_D4(17), FDDM_D4(18),
        FDDM_D4(19), FDDM_D4(20), FDDM_D4(21), FDDM_D4(22), FDDM_D4(23), FDDM_D4(24),
        FDDM_D4(25), FDDM_D4(26), FDDM_D4(27), FDDM_D4(28), FDDM_D4(29), FDDM_D4(30),
        FDDM_D4(31)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
#undef FDDM_D4
}

// The conv product of conv_ln_gelu.cu: d[64 x 256] (+)= A[64 x 16] . B[16 x
// 256], bf16 x bf16 -> f32, both from descriptors: A K-major, B as kTransB
// says (1: MN-major, [k][n] with n contiguous).  d[j][e] is column tile j
// (8 columns), rows g / g + 8 of the warp's 16, as in the s8 product.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16_bf16(float d[32][4], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
#define FDDM_F4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : FDDM_F4(0), FDDM_F4(1), FDDM_F4(2), FDDM_F4(3), FDDM_F4(4), FDDM_F4(5), FDDM_F4(6),
        FDDM_F4(7), FDDM_F4(8), FDDM_F4(9), FDDM_F4(10), FDDM_F4(11), FDDM_F4(12),
        FDDM_F4(13), FDDM_F4(14), FDDM_F4(15), FDDM_F4(16), FDDM_F4(17), FDDM_F4(18),
        FDDM_F4(19), FDDM_F4(20), FDDM_F4(21), FDDM_F4(22), FDDM_F4(23), FDDM_F4(24),
        FDDM_F4(25), FDDM_F4(26), FDDM_F4(27), FDDM_F4(28), FDDM_F4(29), FDDM_F4(30),
        FDDM_F4(31)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
#undef FDDM_F4
}

// As reg_fence, for the f32 accumulator of wgmma_m64n256k16_bf16.
__device__ __forceinline__ void reg_fence_n256(float d[32][4]) {
  #pragma unroll
  for (int j = 0; j < 32; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// As reg_fence, for the s32 accumulator of wgmma_m64n256k32_s8.
__device__ __forceinline__ void reg_fence(int d[32][4]) {
  #pragma unroll
  for (int j = 0; j < 32; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
}

// ------------------------------------------------------- float32: 3xTF32
// The float32 kernels (the forward's gated_attention_tf32x3_kernel, the
// backward's bwd_dq_tf32x3_kernel, bwd_dkv_tf32x3_kernel and
// bwd_dbias_tf32x3_kernel) run 3xTF32 on wgmma.  Each f32 operand x is split
// into two tf32 values, hi = rna(x) and lo = rna(x - hi), and each product is
// hi.hi + hi.lo + lo.hi in f32 (the dropped lo.lo is below 2^-22 of it).  tf32
// wgmma (m64nNk8) reads only K-major operands, and TMA cannot transpose; so a
// block is three warpgroups: two consumers run the products and the softmax,
// and a producer (lane 0 of warp 8 issuing TMA, warps 9-11 splitting and
// transposing) prepares every step's operands in shared memory.

constexpr int TF_HALF = BK * 128;    // [64 rows][32 f32]: one 128-byte swizzle column
constexpr int TF_TILE = 2 * TF_HALF;  // a [64][64] f32 tile as two 32-column halves
constexpr int TF_CONSUMER_WARPS = 8;  // warps 0-7; warps 8-11 are the producer's
constexpr int TF_THREADS = (TF_CONSUMER_WARPS + 4) * 32;
constexpr int TF_SPLIT_THREADS = 96;  // warps 9-11 split and transpose; warp 8 loads
// setmaxnreg: __launch_bounds__(TF_THREADS, 1) gives each thread at most
// 168 registers; the producer's warpgroup frees 128 x (168 - 40), which the
// consumers' increase takes whole (an increase the pool cannot cover never
// returns, so the launchers refuse a build of another register count).
constexpr int TF_LAUNCH_REGS = 65536 / TF_THREADS / 8 * 8;
constexpr int TF_PRODUCER_REGS = 40;
constexpr int TF_CONSUMER_REGS = 232;
static_assert(128 * TF_PRODUCER_REGS + TF_CONSUMER_WARPS * 32 * TF_CONSUMER_REGS ==
                  TF_LAUNCH_REGS * TF_THREADS,
              "the consumers take exactly what the producer frees");

// tf32 of x, rounded to nearest with ties away from zero (cvt.rna): the 13
// low mantissa bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d[64 x 64] (+)= a[64 x 8] (registers, tf32) . B[8 x 64] (descriptor, K-major
// tf32).  The register A fragment of 16 rows x 8 columns: a0 (row g, col t),
// a1 (row g + 8, col t), a2 (row g, col t + 4), a3 (row g + 8, col t + 4).
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float d[8][4], const uint32_t a[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The fused conv's float32 product: d[64 x 256] (+)= a[64 x 8] (registers,
// tf32, the fragment above) . B[8 x 256] (descriptor, K-major tf32); d as in
// wgmma_m64n256k16_bf16.
__device__ __forceinline__ void wgmma_m64n256k8_tf32(float d[32][4], const uint32_t a[4],
                                                     uint64_t desc_b, int scale_d) {
#define FDDM_F4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : FDDM_F4(0), FDDM_F4(1), FDDM_F4(2), FDDM_F4(3), FDDM_F4(4), FDDM_F4(5), FDDM_F4(6),
        FDDM_F4(7), FDDM_F4(8), FDDM_F4(9), FDDM_F4(10), FDDM_F4(11), FDDM_F4(12),
        FDDM_F4(13), FDDM_F4(14), FDDM_F4(15), FDDM_F4(16), FDDM_F4(17), FDDM_F4(18),
        FDDM_F4(19), FDDM_F4(20), FDDM_F4(21), FDDM_F4(22), FDDM_F4(23), FDDM_F4(24),
        FDDM_F4(25), FDDM_F4(26), FDDM_F4(27), FDDM_F4(28), FDDM_F4(29), FDDM_F4(30),
        FDDM_F4(31)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
#undef FDDM_F4
}

// Descriptor offset (16-byte units) of k-slice ks (8 columns, 32 bytes) of
// a tile stored as 32-column swizzle halves of kHalf bytes each.
template <int kHalf = TF_HALF>
__device__ __forceinline__ uint32_t tf_slice(int ks) {
  return (uint32_t)(((ks >> 2) * kHalf + (ks & 3) * 32) >> 4);
}

// Byte offset of element (row r, column c < 32) in a 128-byte-swizzled
// [rows][32 f32] half: the 16-byte chunk c / 4 of row r sits at chunk
// (c / 4) ^ (r % 8).
__device__ __forceinline__ int tf_sw(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// Split a landed f32 tile of kBytes (by default [64 x 64], two swizzled
// 32-column halves) in place: hi over the f32 values, lo `lo_off` bytes
// further on.  An elementwise map, so the swizzled layout carries over.
template <int kBytes = TF_TILE>
__device__ __forceinline__ void tf_split_tile(uint8_t* tile, int lo_off, int tid, int nthreads) {
  #pragma unroll 2
  for (int c = tid; c < kBytes / 16; c += nthreads) {
    const float4 x = reinterpret_cast<const float4*>(tile)[c];
    uint4 hi, lo;
    tf32_split(x.x, hi.x, lo.x);
    tf32_split(x.y, hi.y, lo.y);
    tf32_split(x.z, hi.z, lo.z);
    tf32_split(x.w, hi.w, lo.w);
    reinterpret_cast<uint4*>(tile)[c] = hi;
    reinterpret_cast<uint4*>(tile + lo_off)[c] = lo;
  }
}

// An accumulator's columns are the next product's reduction (k) index.  The
// thread holds columns 2t and 2t + 1 of each group of 8 (d[j][0..1] row g,
// d[j][2..3] row g + 8), which an A fragment reads as columns t and t + 4;
// so the producer stores the k index of that product's B operand with each
// group of 8 in the order 0 2 4 6 1 3 5 7 (`tf_pos`: index -> position), and
// column tile j of the accumulator is then, as it stands, the hi and lo A
// fragments of k-slice j (a0..a3 = d0, d2, d1, d3).
__device__ __forceinline__ int tf_pos(int r) {
  return (r & ~7) | ((r >> 1) & 3) | ((r & 1) << 2);
}
__device__ __forceinline__ void tf_fragments(const float d[4], uint32_t hi[4], uint32_t lo[4]) {
  tf32_split(d[0], hi[0], lo[0]);
  tf32_split(d[2], hi[1], lo[1]);
  tf32_split(d[1], hi[2], lo[2]);
  tf32_split(d[3], hi[3], lo[3]);
}

// The launchers' check, once a process per kernel: setmaxnreg's budgets
// balance only at TF_LAUNCH_REGS registers a thread.  cudaSuccess, or the
// error to return (a line on stderr says why).
template <typename Kernel>
inline cudaError_t tf_check_regs(Kernel kernel, const char* name, bool* checked) {
  if (*checked) return cudaSuccess;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != TF_LAUNCH_REGS) {
    fprintf(stderr, "%s was built with %d registers a thread; its setmaxnreg budgets (%d / %d) "
            "need %d\n", name, attr.numRegs, TF_PRODUCER_REGS, TF_CONSUMER_REGS, TF_LAUNCH_REGS);
    return cudaErrorLaunchOutOfResources;
  }
  *checked = true;
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query (the library links no libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a bf16 (or `type`) [d2][d1][d0] tensor (d0 contiguous,
// rows of row_bytes) in boxes of box0 x box1 x 1, 128-byte swizzled (box0
// elements at most 128 bytes), zero outside.
inline bool encode_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
               uint64_t row_bytes, uint32_t box0, uint32_t box1,
               CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * d1};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A tensor map over a bf16 (or `type`) view [d2][d1][d0] with explicit byte
// strides between rows (s1) and between planes (s2), both multiples of 16
// (rows may overlap: s1 below d0's bytes); d0 is contiguous.  Boxes of box0
// x box1 x 1, 128-byte swizzled, zero outside.
inline bool encode_3d_strided(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                              uint64_t d2, uint64_t s1, uint64_t s2, uint32_t box0,
                              uint32_t box1,
                              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A tensor map over a [d1][d0] matrix of f32 or uint8 elements (d0 contiguous;
// a row a multiple of 16 bytes) in boxes of box0 x 1, unswizzled, zero outside.
inline bool encode_rows(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                        uint64_t d0, uint64_t d1, uint32_t box0) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const uint64_t elem = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 1;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {d0 * elem};
  const cuuint32_t box[2] = {box0, 1};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map over an int8 [d1][d0] matrix (d0 contiguous, a row a
// multiple of 16 bytes) in boxes of 128 bytes x box1 rows, 128-byte
// swizzled: the K-major operand tiles of an s8 wgmma.  Zero outside.
inline bool encode_s8_sw128(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                            uint32_t box1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {d0};
  const cuuint32_t box[2] = {128, box1};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace fddm
