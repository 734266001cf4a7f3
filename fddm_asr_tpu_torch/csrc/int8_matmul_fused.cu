// Fused dynamic-int8 dense layer for Hopper (sm_90a).
//
//   sx[m]    = max(max_k |x[m, k]|, eps) * (1 / 127)              (f32)
//   xq[m, k] = clip(round_half_even(x[m, k] / sx[m]), -127, 127)   (int8)
//   out[m, n] = (float(sum_k xq[m, k] * wq[n, k]) * sx[m]) * sw[n] + bias[n]
//
// Replaces the TPU kernel `_fused_kernel` of fddm_asr_tpu/ops/quant.py
// (reached through `int8_matmul_fused`): the activations are quantized per
// row inside the kernel, so xq and sx never travel through device memory;
// the weights arrive quantized per output channel (wq [N, K] int8, the
// nn.Linear layout, K contiguous; sw [N] f32), as on the TPU, where the
// weight quantization stays outside the kernel too.
//
// The TPU runs a sequential (M, N) grid with N innermost and quantizes a row
// block once at j == 0 into VMEM scratch.  Hopper blocks run in no order, so
// the sequential N axis becomes a loop inside the block: a block owns BM
// rows (64 with ring stages of 128 bytes of K, or, where K is too long for
// that beside the weight ring in the 227 KB a block may use, 32 with stages
// of 64 bytes), reads them twice from device memory or L2 (row amax, then
// quantize: the scale needs the whole row before any product; four rows at
// a time per warp, so that their loads overlap; the divide is a reciprocal
// and two exact-residual corrections, see div_rn), keeps xq [BM, K] and sx
// [BM] in shared memory and sweeps every N tile of 256 columns against
// them.  Weight tiles [256 x BK bytes] come through a three-stage cp.async
// ring, the copies of the stage after next started between the mma groups
// of the current one; the product runs on the tensor cores with mma.sync
// m16n8k32 (s8 x s8 -> s32), fragments through ldmatrix; eight warps, 2
// along M x 4 along N, each a (BM/2) x 64 tile.  The integer sum is exact;
// the epilogue multiplies and adds in separately rounded f32 steps
// (__fmul_rn, __fadd_rn: never contracted into an FMA), so f32 outputs are
// those of the plain PyTorch version bit for bit.
//
// What bounds it: at M = 8192, K = 1024, N = 4096 (bf16 in and out) 2 M K N
// = 68.7 G integer operations against 88 MB moved: operations, 0.035 ms at
// the card's dense int8 peak.  This design does not reach for that.  The
// eight warps of a block run in step between two barriers, so whatever one
// of them waits for nobody hides: mma.sync starts about one m16n8k32 every
// eight cycles per scheduler (half the card's int8 rate), the quantize
// phase and the epilogue run with the tensor cores idle, every block
// streams the whole of wq from L2 (M / BM times in all), and a long K
// (4096) leaves room for only 32 rows a block, in two waves.
// Warp-specialised loading (TMA), wgmma and a split of K or N across a
// cluster are the next steps.  Measured times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "tile_ops.cuh"

namespace {

using namespace fddm;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int BN = 256;       // output columns per N tile
constexpr int STAGES = 3;
constexpr int PAD = 16;       // row strides BK + 16 (ring) and K + 16 (xq; K padded to BK):
                              // ldmatrix's 8 rows then hit 8 distinct 16-byte lanes
constexpr int ROWS_AT_ONCE = 4;  // rows a warp quantizes together
constexpr int SMEM_LIMIT = 232448;

// Shared memory of a block of `bm` rows with ring stages of `bk` bytes.
constexpr size_t smem_bytes(int bm, int bk, int K) {
  return (size_t)bm * ((K + bk - 1) / bk * bk + PAD) + (size_t)STAGES * BN * (bk + PAD)
         + bm * sizeof(float);
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 consecutive elements of a row as f32 (the row is 16-byte aligned, c % 16 == 0).
__device__ __forceinline__ void load16(float v[16], const float* p) {
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(float v[16], const bf16* p) {
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[8 * i + 2 * j] = f.x; v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// x / scale, correctly rounded (what `/` and __fdiv_rn give), from `inv` =
// __frcp_rn(scale): a product and two residual corrections, each residual
// exact in the FMA.  The first correction leaves a faithful quotient, and by
// Markstein's theorem one more from a faithful quotient with the correctly
// rounded reciprocal is the correctly rounded quotient (no over- or
// underflow here: |x / scale| <= 127 up to rounding, scale >= 7.8e-11).  A
// fifth of the instructions of the general divide, which has to handle
// every exponent range.
__device__ __forceinline__ float div_rn(float x, float scale, float inv) {
  float q = x * inv;
  q = fmaf(fmaf(-q, scale, x), inv, q);
  return fmaf(fmaf(-q, scale, x), inv, q);
}

// Four values to int8: clip(round_half_even(x / scale), -127, 127), packed.
__device__ __forceinline__ uint32_t quantize4(const float* v, float scale, float inv) {
  uint32_t packed = 0;
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = max(-127, min(127, __float2int_rn(div_rn(v[i], scale, inv))));
    packed |= (static_cast<uint32_t>(q) & 0xffu) << (8 * i);
  }
  return packed;
}

__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// MT: m16 tiles per warp along M; the block owns BM = 32 * MT rows.
// BK: bytes of K per ring stage (BK / 32 k32 steps).
template <int MT, int BK, typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_fused_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ wq,
                         const float* __restrict__ sw, const float* __restrict__ bias,
                         TOut* __restrict__ out, int M, int K, int N, float eps) {
  constexpr int BM = 32 * MT;
  constexpr int WS = BK + PAD;
  extern __shared__ uint4 smem16[];
  const int Kp = (K + BK - 1) / BK * BK;  // K padded to whole ring stages, zero-filled
  const int XS = Kp + PAD;
  int8_t* xq = reinterpret_cast<int8_t*>(smem16);     // [BM][XS]
  int8_t* ring = xq + (size_t)BM * XS;                // [STAGES][BN][WS]
  float* sx = reinterpret_cast<float*>(ring + STAGES * BN * WS);  // [BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int KC = Kp / BK;                      // ring stages per N tile
  const int total = ((N + BN - 1) / BN) * KC;  // stages in all

  // The loader walks the stages in order and keeps its place (N tile, K
  // offset, ring slot) in registers: each stage a thread copies the same
  // 16-byte chunk of PASSES tile rows, one row per piece.  No division or
  // fresh address arithmetic in the loop, and the pieces are started between
  // the mma groups of the stage being multiplied: between two barriers the
  // warps run in step, so a stall of one unit (the copies queue in the
  // load/store unit) is hidden only by work for another in the same warp.
  constexpr int ROWS_PER_PASS = THREADS / (BK / 16);  // tile rows one pass of the block covers
  constexpr int PASSES = BN / ROWS_PER_PASS;
  constexpr int KSTEPS = BK / 32;
  static_assert(PASSES % KSTEPS == 0, "the copies of a stage divide evenly over its k32 steps");
  const int ld_row = tid / (BK / 16), ld_kb = (tid % (BK / 16)) * 16;
  const int8_t* const ld_base = wq + (size_t)ld_row * K + ld_kb;  // + (n0 * K + k0) per stage
  int8_t* const ld_dst0 = ring + ld_row * WS + ld_kb;             // + slot * BN * WS
  const size_t pass_stride = (size_t)ROWS_PER_PASS * K;
  int ld_n0 = 0, ld_k0 = 0, ld_slot = 0;
  const int8_t* ld_src = ld_base;  // of the stage being copied
  int8_t* ld_dst = ld_dst0;
  bool ld_k_ok = ld_kb < K;
  auto load_piece = [&](int j) {   // one row of the stage being copied
    if (ld_n0 < N) {
      const bool valid = ld_k_ok && ld_n0 + ld_row + j * ROWS_PER_PASS < N;
      cp_async16(ld_dst + j * ROWS_PER_PASS * WS, valid ? ld_src + j * pass_stride : wq, valid);
    }
  };
  auto load_commit = [&]() {       // close the stage's group and move to the next stage
    cp_async_commit();  // one group per stage, empty past the end, so the counts stay level
    if (ld_n0 < N) {
      ld_k0 += BK;
      if (ld_k0 >= Kp) { ld_k0 = 0; ld_n0 += BN; }
      ld_slot = ld_slot + 1 == STAGES ? 0 : ld_slot + 1;
      ld_src = ld_base + (size_t)ld_n0 * K + ld_k0;
      ld_dst = ld_dst0 + ld_slot * (BN * WS);
      ld_k_ok = ld_k0 + ld_kb < K;
    }
  };

  // the first weight tiles travel while the rows are quantized
  #pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    #pragma unroll
    for (int j = 0; j < PASSES; ++j) load_piece(j);
    load_commit();
  }

  // quantize the block's rows: a warp takes four rows at a time and makes
  // two passes over them (amax, then quantize), the four rows' loads in
  // flight together.  A row past M repeats row M - 1; it is never stored.
  for (int r0 = warp * ROWS_AT_ONCE; r0 < BM; r0 += (THREADS / 32) * ROWS_AT_ONCE) {
    const TIn* src[ROWS_AT_ONCE];
    float amax[ROWS_AT_ONCE], scale[ROWS_AT_ONCE], inv[ROWS_AT_ONCE];
    #pragma unroll
    for (int u = 0; u < ROWS_AT_ONCE; ++u) {
      src[u] = x + (size_t)min(m0 + r0 + u, M - 1) * K;
      amax[u] = 0.f;
    }
    for (int c = lane * 16; c < K; c += 32 * 16) {
      #pragma unroll
      for (int u = 0; u < ROWS_AT_ONCE; ++u) {
        float v[16];
        load16(v, src[u] + c);
        #pragma unroll
        for (int i = 0; i < 16; ++i) amax[u] = fmaxf(amax[u], fabsf(v[i]));
      }
    }
    #pragma unroll
    for (int u = 0; u < ROWS_AT_ONCE; ++u) {
      #pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax[u] = fmaxf(amax[u], __shfl_xor_sync(0xffffffffu, amax[u], off));
      scale[u] = __fmul_rn(fmaxf(amax[u], eps), static_cast<float>(1.0 / 127.0));
      inv[u] = __frcp_rn(scale[u]);
      if (lane == 0) sx[r0 + u] = scale[u];
    }
    for (int c = lane * 16; c < Kp; c += 32 * 16) {
      #pragma unroll
      for (int u = 0; u < ROWS_AT_ONCE; ++u) {
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (c < K) {
          float v[16];
          load16(v, src[u] + c);
          q = make_uint4(quantize4(v, scale[u], inv[u]), quantize4(v + 4, scale[u], inv[u]),
                         quantize4(v + 8, scale[u], inv[u]),
                         quantize4(v + 12, scale[u], inv[u]));
        }
        *reinterpret_cast<uint4*>(xq + (size_t)(r0 + u) * XS + c) = q;
      }
    }
  }

  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix row addresses of this lane: A (rows +8 for matrices 1 and 3,
  // k +16 bytes for 2 and 3), B (k +16 bytes for 1 and 3, n +8 for 2 and 3)
  const int8_t* a_lane = xq + (size_t)(warp_m * 16 * MT + (lane & 7) + ((lane >> 3) & 1) * 8) * XS
                         + (lane >> 4) * 16;
  const int b_lane = (warp_n * 64 + (lane & 7) + (lane >> 4) * 8) * WS + ((lane >> 3) & 1) * 16;

  int acc[MT][8][4];
  #pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    #pragma unroll
    for (int p = 0; p < 8; ++p)
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][p][e] = 0;

  const bool pair_ok = (N & 1) == 0;
  int kc = 0, n0 = 0, slot = 0;  // the stage being multiplied
  float swv[8][2], bv[8][2];     // sw and bias at the thread's 16 columns of the N tile
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage s have landed
    __syncthreads();              // everyone's have; stage s - 1 (and xq, sx) is done with
    if (kc == 0) {  // a new N tile: its scales and bias travel while it is multiplied
      #pragma unroll
      for (int p = 0; p < 8; ++p)
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + warp_n * 64 + p * 8 + 2 * t + e;
          swv[p][e] = c < N ? sw[c] : 0.f;
          bv[p][e] = (bias != nullptr && c < N) ? bias[c] : 0.f;
        }
    }
    const int8_t* wt = ring + slot * (BN * WS);
    #pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      // a share of stage s + STAGES - 1's copies, into the slot stage s - 1 used
      #pragma unroll
      for (int j = 0; j < PASSES / KSTEPS; ++j) load_piece(ks * (PASSES / KSTEPS) + j);
      uint32_t a[MT][4];
      #pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], a_lane + (size_t)mt * 16 * XS + kc * BK + ks * 32);
      #pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t b[4];
        ldmatrix_x4(b, wt + b_lane + pp * 16 * WS + ks * 32);
        #pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_s8(acc[mt][2 * pp], a[mt], b[0], b[1]);
          mma_s8(acc[mt][2 * pp + 1], a[mt], b[2], b[3]);
        }
      }
    }
    load_commit();
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    if (++kc == KC) {  // the N tile is complete: dequantize, add the bias, store
      #pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        #pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp_m * 16 * MT + mt * 16 + g + half * 8;
          const int row = m0 + r;
          const float srow = sx[r];
          #pragma unroll
          for (int p = 0; p < 8; ++p) {
            const int col = n0 + warp_n * 64 + p * 8 + 2 * t;
            float y[2];
            #pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = __fmul_rn(__fmul_rn(static_cast<float>(acc[mt][p][2 * half + e]), srow),
                                  swv[p][e]);
              if (bias != nullptr) v = __fadd_rn(v, bv[p][e]);
              y[e] = v;
              acc[mt][p][2 * half + e] = 0;
            }
            if (row < M) {
              TOut* o = out + (size_t)row * N + col;
              if (pair_ok && col < N) {
                store_pair(o, y[0], y[1]);
              } else {
                if (col < N) store_one(o, y[0]);
                if (col + 1 < N) store_one(o + 1, y[1]);
              }
            }
          }
        }
      }
      kc = 0;
      n0 += BN;
    }
  }
  cp_async_wait<0>();
}

template <int MT, int BK, typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* wq, const void* sw, const void* bias, void* out,
                   int M, int K, int N, float eps, cudaStream_t stream) {
  constexpr int BM = 32 * MT;
  const size_t smem = smem_bytes(BM, BK, K);
  auto kernel = int8_matmul_fused_kernel<MT, BK, TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<TOut*>(out), M, K, N, eps);
  return cudaGetLastError();
}

template <int MT, int BK>
cudaError_t launch_types(int in_dtype, int out_dtype, const void* x, const void* wq,
                         const void* sw, const void* bias, void* out, int M, int K, int N,
                         float eps, cudaStream_t s) {
  if (in_dtype == 0 && out_dtype == 0)
    return launch<MT, BK, float, float>(x, wq, sw, bias, out, M, K, N, eps, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<MT, BK, float, bf16>(x, wq, sw, bias, out, M, K, N, eps, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<MT, BK, bf16, float>(x, wq, sw, bias, out, M, K, N, eps, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<MT, BK, bf16, bf16>(x, wq, sw, bias, out, M, K, N, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [M, K] (in_dtype: 0 = float32, 1 = bfloat16), wq [N, K] int8, sw [N] f32,
// bias [N] f32 or null, out [M, N] (out_dtype likewise).  K must be a
// multiple of 16 (16-byte rows) and short enough for 32 rows of xq beside
// the weight ring in shared memory (K <= 5312; up to K = 1792 a block takes
// 64 rows).  Pointers 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 = launched).
int fddm_int8_matmul_fused(const void* x, const void* wq, const void* sw, const void* bias,
                           void* out, int M, int K, int N, int in_dtype, int out_dtype,
                           float eps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes(64, 128, K) <= SMEM_LIMIT)
    return (int)launch_types<2, 128>(in_dtype, out_dtype, x, wq, sw, bias, out, M, K, N, eps, s);
  if (smem_bytes(32, 64, K) <= SMEM_LIMIT)
    return (int)launch_types<1, 64>(in_dtype, out_dtype, x, wq, sw, bias, out, M, K, N, eps, s);
  return (int)cudaErrorInvalidConfiguration;
}

}  // extern "C"
