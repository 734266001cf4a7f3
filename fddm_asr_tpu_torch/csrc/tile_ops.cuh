// Tile helper of gated_attention_bwd.cu: ldmatrix.x4.trans loads of
// mma.sync fragments.
//
// ldmatrix reads 8x8 matrices of 16-bit elements whose rows are 16 bytes in
// shared memory; lanes 8j..8j+7 give the row addresses of matrix j, and
// with .trans lane l receives from each matrix the two 16-bit elements
// (rows 2(l%4), 2(l%4)+1 of column l/4).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace fddm {

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row_ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

}  // namespace fddm
