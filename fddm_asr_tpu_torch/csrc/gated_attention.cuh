// Shared pieces of the gated-attention kernels (gated_attention.cu, the
// forward; gated_attention_bwd.cu, the backward): tile sizes, the masked-key
// score, the bf16 tensor-core helpers (mma.sync m16n8k16, ldmatrix, wgmma),
// the 128-byte swizzled tile layout, mbarriers, TMA and its tensor maps.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
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

namespace fddm {

constexpr int DH = 64;   // head dim (the only one WavLM uses)
constexpr int BQ = 64;   // queries per tile
constexpr int BK = 64;   // keys per tile
constexpr float NEG = -FLT_MAX;  // the masked-key score (f32-min)

// float32 kernels: 256 threads, each a 4x4 register micro-tile
constexpr int F32_THREADS = 256;
constexpr int PAD = 68;  // smem row stride (floats): 16-byte aligned, fewer bank conflicts

typedef __nv_bfloat16 bf16;

// bf16 kernels: four warps of 16 rows each on the tensor cores
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int KSTR = DH + 8;  // smem row stride (bf16): 144 bytes, so the 32-bit
                              // fragment reads of 8 rows x 4 threads and
                              // ldmatrix's 8 row reads are conflict-free
static_assert(BK == DH && BQ == DH, "all tiles share one smem row stride");

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

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

// A [64 x 64] tile of a row-major bf16 matrix (row stride ld) into smem
// (row stride KSTR); zero outside rows_valid x cols_valid.  16-byte loads
// where `vec` says rows are 16-byte aligned, elementwise otherwise.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, size_t ld,
                                          int rows_valid, int cols_valid, bool vec) {
  for (int i = threadIdx.x; i < 64 * 8; i += MMA_THREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      const bf16* p = src + (size_t)r * ld + c;
      if (vec && c + 8 <= cols_valid) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        __align__(16) bf16 e[8];
        #pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = c + j < cols_valid ? p[j] : __float2bfloat16(0.f);
        val = *reinterpret_cast<const uint4*>(e);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * KSTR + c) = val;
  }
}

// A [64 x 64] tile of a row-major f32 matrix into smem, transposed or not:
// dst[c * PAD + r] (transposed) or dst[r * stride + c]; zero past rows_valid.
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              size_t ld, int rows_valid, bool transpose,
                                              int stride) {
  for (int i = threadIdx.x; i < 64 * 64; i += F32_THREADS) {
    const int r = i / 64, c = i % 64;
    const float x = r < rows_valid ? src[(size_t)r * ld + c] : 0.f;
    if (transpose) dst[c * PAD + r] = x;
    else dst[r * stride + c] = x;
  }
}

// keep flag of key kj of batch row b: 1 kept, 0 masked, -1 beyond L
__device__ __forceinline__ float keep_flag(const uint8_t* mask, int b, int kj, int L) {
  return kj >= L ? -1.f : (mask == nullptr || mask[(size_t)b * L + kj]) ? 1.f : 0.f;
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

// A tensor map over a bf16 [d2][d1][d0] tensor (d0 contiguous, rows of
// row_bytes) in boxes of box0 x box1 x 1, 128-byte swizzled, zero outside.
inline bool encode_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
               uint64_t row_bytes, uint32_t box0, uint32_t box1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * d1};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
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

}  // namespace fddm
