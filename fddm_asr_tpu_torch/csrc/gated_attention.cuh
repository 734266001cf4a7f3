// Shared pieces of the gated-attention kernels (gated_attention.cu, the
// forward; gated_attention_bwd.cu, the backward): tile sizes, the masked-key
// score, and the bf16 tensor-core helpers (mma.sync m16n8k16, ldmatrix).
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

}  // namespace fddm
