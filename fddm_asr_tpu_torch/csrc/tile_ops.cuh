// Tile helpers of conv_ln_gelu.cu: 16-byte asynchronous copies into shared
// memory (cp.async, zero-filled where the source is out of range), their
// commit/wait groups, and ldmatrix.x4 loads of mma.sync fragments.
//
// ldmatrix reads 8x8 matrices of 16-bit elements whose rows are 16 bytes in
// shared memory; lanes 8j..8j+7 give the row addresses of matrix j, and
// lane l receives from each matrix the 32-bit word (row l/4, word l%4), or
// with .trans the two 16-bit elements (rows 2(l%4), 2(l%4)+1 of column l/4).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace fddm {

// Copy 16 bytes global -> shared; with `valid` false nothing is read and the
// 16 bytes are zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem_src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row_ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row_ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

}  // namespace fddm
