// Fused VALID conv1d + bias + LayerNorm(channels) + GELU for Hopper (sm_90a):
// one layer of the WavLM feature extractor ("layer"-norm variant) with one
// read of its input and one write of its output.
//
//   y[b, t, :]   = sum_j x[b, t*s + j, :] . w[j, :, :] + cb            (f32)
//   out[b, t, :] = gelu(layer_norm(y[b, t, :]) * ln_scale + ln_bias)    (f32, then cast)
//
// Replaces the TPU kernel made by `_make_kernel` in
// fddm_asr_tpu/ops/conv_frontend.py (reached through `conv_ln_gelu_pallas`).
// x is channels-last [B, T, Cin], so the patch of output row t is the
// contiguous span of k*Cin elements that starts at input row t*s: the conv
// is a product [rows, k*Cin] x [k*Cin, Cout] whose A operand has row stride
// s*Cin.  The TPU's reshape gather, its 32-row tile from the next block,
// its zero-padded phantom tile and the reframing of the waveform layer are
// Mosaic's needs and are not carried over; a row past the end is masked.
// Any k and s are taken (not only k - s <= s).
//
// LayerNorm needs the whole row of Cout channels, so one block owns every
// channel (up to 512) of its rows and keeps the f32 accumulators in
// registers across the block; mean and the two-pass variance are reduced
// over the warps that share a row through shared memory.  GELU is erff (the
// TPU's polynomial exists only because Mosaic has no erf) or the tanh form.
//   * bfloat16 (the main path): 64 rows a block, 16 warps (2 along rows x 8
//     along channels, each 32 x 64), mma.sync m16n8k16 with f32 accumulate;
//     x patches [64 x 32] and weights [32 x 512] come through a three-stage
//     cp.async ring, fragments through ldmatrix (transposed for the weights).
//   * float32: exact f32 scalar FMAs, 32 rows a block, 256 threads each an
//     8 x 8 register tile, synchronous loads.
//
// What bounds it: layer 1 of WavLM-large at 8 x 20 s (rows = 255992, k*Cin =
// 1536, Cout = 512, bf16) is 403 GFLOP against 0.79 GB moved: operations,
// 0.41 ms at the card's dense bf16 peak.  This design stays well short of
// it: every block streams the whole weight matrix from L2 (rows / 64 times
// in all), and mma.sync reads 6 bytes of shared memory per lane and product.
// Measured times stand in PERF.md.

#include "gated_attention.cuh"
#include "tile_ops.cuh"

namespace {

using namespace fddm;

constexpr int MAX_COUT = 512;

__device__ __forceinline__ float gelu(float v, bool tanh_form) {
  if (tanh_form) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// Element offset of the patch of global output row R (= b * T_out + t), or -1 past the end.
__device__ __forceinline__ long long patch_offset(int R, int rows, int T, int T_out, int Cin,
                                                  int stride) {
  if (R >= rows) return -1;
  const int b = R / T_out, t = R % T_out;
  return ((long long)b * T + (long long)t * stride) * Cin;
}

// ---------------------------------------------------------------- bfloat16
constexpr int H_THREADS = 512;
constexpr int H_BM = 64;
constexpr int H_BK = 32;                 // patch elements per ring stage (two k16 steps)
constexpr int H_STAGES = 3;
constexpr int H_AS = H_BK + 8;           // A row stride (bf16): 80 bytes, ldmatrix conflict-free
constexpr int H_WS = MAX_COUT + 8;       // W row stride (bf16): 1040 bytes, likewise
constexpr int H_WARPS_N = 8;
constexpr size_t H_SMEM_BYTES =
    (size_t)H_STAGES * (H_BM * H_AS + H_BK * H_WS) * sizeof(bf16)   // the rings
    + H_BM * H_WARPS_N * sizeof(float)                              // row partials
    + H_BM * sizeof(long long);                                     // patch offsets

__global__ void __launch_bounds__(H_THREADS, 1)
conv_ln_gelu_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const float* __restrict__ cb, const float* __restrict__ ln_scale,
                         const float* __restrict__ ln_bias, bf16* __restrict__ out,
                         int rows, int T, int T_out, int Cin, int Cout, int K, int stride,
                         float eps, int tanh_form) {
  extern __shared__ uint4 smem16[];
  bf16* a_ring = reinterpret_cast<bf16*>(smem16);               // [STAGES][BM][AS]
  bf16* w_ring = a_ring + H_STAGES * H_BM * H_AS;               // [STAGES][BK][WS]
  float* red = reinterpret_cast<float*>(w_ring + H_STAGES * H_BK * H_WS);  // [BM][8]
  long long* rowoff = reinterpret_cast<long long*>(red + H_BM * H_WARPS_N);  // [BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 3, warp_n = warp & 7;
  const int R0 = blockIdx.x * H_BM;

  if (tid < H_BM) rowoff[tid] = patch_offset(R0 + tid, rows, T, T_out, Cin, stride);
  __syncthreads();

  const int total = (K + H_BK - 1) / H_BK;
  auto load_stage = [&](int s) {
    if (s < total) {
      const int k0 = s * H_BK;
      bf16* a_slot = a_ring + (s % H_STAGES) * H_BM * H_AS;
      bf16* w_slot = w_ring + (s % H_STAGES) * H_BK * H_WS;
      if (tid < H_BM * (H_BK / 8)) {  // 64 rows x 4 chunks of 8 elements
        const int m = tid >> 2, kk = k0 + (tid & 3) * 8;
        const bool valid = rowoff[m] >= 0 && kk < K;
        cp_async16(a_slot + m * H_AS + (tid & 3) * 8, valid ? x + rowoff[m] + kk : x, valid);
      }
      #pragma unroll
      for (int j = 0; j < H_BK * (MAX_COUT / 8) / H_THREADS; ++j) {  // 32 rows x 64 chunks
        const int id = tid + j * H_THREADS;
        const int kr = id >> 6, col = (id & 63) * 8;
        const bool valid = k0 + kr < K && col < Cout;
        cp_async16(w_slot + kr * H_WS + col,
                   valid ? w + (size_t)(k0 + kr) * Cout + col : w, valid);
      }
    }
    cp_async_commit();  // one group per stage, empty past the end
  };
  #pragma unroll
  for (int s = 0; s < H_STAGES - 1; ++s) load_stage(s);

  float acc[2][8][4];
  #pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    #pragma unroll
    for (int p = 0; p < 8; ++p)
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][p][e] = 0.f;

  // ldmatrix row addresses of this lane: A rows +8 for matrices 1 and 3,
  // k +8 for 2 and 3; W (transposed) k rows +8 for 1 and 3, channels +8 for 2 and 3
  const int a_lane = (warp_m * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) * H_AS + (lane >> 4) * 8;
  const int w_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * H_WS + warp_n * 64 + (lane >> 4) * 8;

  for (int s = 0; s < total; ++s) {
    cp_async_wait<H_STAGES - 2>();
    __syncthreads();  // stage s has landed for everyone; stage s - 1 is done with
    load_stage(s + H_STAGES - 1);
    const bf16* a_slot = a_ring + (s % H_STAGES) * H_BM * H_AS;
    const bf16* w_slot = w_ring + (s % H_STAGES) * H_BK * H_WS;
    #pragma unroll
    for (int ks = 0; ks < H_BK / 16; ++ks) {
      uint32_t a[2][4];
      #pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], a_slot + a_lane + mt * 16 * H_AS + ks * 16);
      #pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w_slot + w_lane + ks * 16 * H_WS + pp * 16);
        #pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * pp], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * pp + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the thread holds rows r(mt, half) = warp_m*32 + mt*16 + g + half*8 at
  // channels warp_n*64 + p*8 + 2t + (e & 1)
  const int c_base = warp_n * 64 + 2 * t;
  float mean[2][2], rstd[2][2];
  #pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // 0: conv bias and row mean; 1: variance about it
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    #pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      #pragma unroll
      for (int p = 0; p < 8; ++p)
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c_base + p * 8 + (e & 1);
          if (c < Cout) {
            if (pass == 0) {
              if (cb != nullptr) acc[mt][p][e] += cb[c];
              part[mt][e >> 1] += acc[mt][p][e];
            } else {
              const float d = acc[mt][p][e] - mean[mt][e >> 1];
              part[mt][e >> 1] += d * d;
            }
          }
        }
    __syncthreads();  // the previous pass's readers of `red` are done
    #pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      #pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = part[mt][half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) red[(warp_m * 32 + mt * 16 + g + half * 8) * H_WARPS_N + warp_n] = v;
      }
    __syncthreads();
    #pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      #pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* rp = red + (warp_m * 32 + mt * 16 + g + half * 8) * H_WARPS_N;
        float v = 0.f;
        #pragma unroll
        for (int i = 0; i < H_WARPS_N; ++i) v += rp[i];
        v /= (float)Cout;
        if (pass == 0) mean[mt][half] = v;
        else rstd[mt][half] = rsqrtf(v + eps);
      }
  }

  #pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    #pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int R = R0 + warp_m * 32 + mt * 16 + g + half * 8;
      if (R >= rows) continue;
      bf16* o = out + (size_t)R * Cout;
      #pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int c = c_base + p * 8;
        if (c >= Cout) continue;  // Cout % 8 == 0: the pair is in or out together
        float y[2];
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float n = (acc[mt][p][2 * half + e] - mean[mt][half]) * rstd[mt][half];
          y[e] = gelu(n * ln_scale[c + e] + ln_bias[c + e], tanh_form != 0);
        }
        *reinterpret_cast<uint32_t*>(o + c) = pack_bf16(y[0], y[1]);
      }
    }
}

// ----------------------------------------------------------------- float32
constexpr int S_THREADS = 256;
constexpr int S_BM = 32;
constexpr int S_BK = 16;
constexpr int S_AS = S_BM + 4;  // A^T row stride (floats), 16-byte aligned

__global__ void __launch_bounds__(S_THREADS)
conv_ln_gelu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ cb, const float* __restrict__ ln_scale,
                        const float* __restrict__ ln_bias, float* __restrict__ out,
                        int rows, int T, int T_out, int Cin, int Cout, int K, int stride,
                        float eps, int tanh_form) {
  __shared__ __align__(16) float At[S_BK * S_AS];      // At[k][m]
  __shared__ __align__(16) float Ws[S_BK * MAX_COUT];  // Ws[k][c]
  __shared__ float red[S_BM * 2];
  __shared__ long long rowoff[S_BM];

  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = tid >> 6;   // rows 8 rg .. 8 rg + 7
  const int cg = tid & 63;   // channels 4 cg .. + 3 and 256 + 4 cg .. + 3
  const int R0 = blockIdx.x * S_BM;

  if (tid < S_BM) rowoff[tid] = patch_offset(R0 + tid, rows, T, T_out, Cin, stride);

  float acc[8][8];
  #pragma unroll
  for (int i = 0; i < 8; ++i)
    #pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += S_BK) {
    __syncthreads();  // rowoff is written; the previous step's readers are done
    {
      const int m = tid >> 3, kq = (tid & 7) * 2;
      #pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kk = k0 + kq + i;
        At[(kq + i) * S_AS + m] = (rowoff[m] >= 0 && kk < K) ? x[rowoff[m] + kk] : 0.f;
      }
    }
    #pragma unroll
    for (int j = 0; j < S_BK * (MAX_COUT / 4) / S_THREADS; ++j) {
      const int id = tid + j * S_THREADS;
      const int kr = id >> 7, col = (id & 127) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + kr < K && col < Cout)
        v = *reinterpret_cast<const float4*>(w + (size_t)(k0 + kr) * Cout + col);
      *reinterpret_cast<float4*>(&Ws[kr * MAX_COUT + col]) = v;
    }
    __syncthreads();
    #pragma unroll
    for (int k = 0; k < S_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&At[k * S_AS + 8 * rg]);
      const float4 a1 = *reinterpret_cast<const float4*>(&At[k * S_AS + 8 * rg + 4]);
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[k * MAX_COUT + 4 * cg]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Ws[k * MAX_COUT + 256 + 4 * cg]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      #pragma unroll
      for (int i = 0; i < 8; ++i)
        #pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }

  // channel of acc[.][j]
  int ch[8];
  #pragma unroll
  for (int j = 0; j < 8; ++j) ch[j] = (j < 4 ? 4 * cg : 256 + 4 * cg - 4) + j;

  float mean[8], rstd[8];
  #pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // 0: conv bias and row mean; 1: variance about it
    float part[8];
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      part[i] = 0.f;
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (ch[j] < Cout) {
          if (pass == 0) {
            if (cb != nullptr) acc[i][j] += cb[ch[j]];
            part[i] += acc[i][j];
          } else {
            const float d = acc[i][j] - mean[i];
            part[i] += d * d;
          }
        }
      }
      #pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
    }
    __syncthreads();  // the previous pass's readers of `red` are done
    if (lane == 0) {
      #pragma unroll
      for (int i = 0; i < 8; ++i) red[(8 * rg + i) * 2 + (cg >> 5)] = part[i];
    }
    __syncthreads();
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = (red[(8 * rg + i) * 2] + red[(8 * rg + i) * 2 + 1]) / (float)Cout;
      if (pass == 0) mean[i] = v;
      else rstd[i] = rsqrtf(v + eps);
    }
  }

  #pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int R = R0 + 8 * rg + i;
    if (R >= rows) continue;
    float* o = out + (size_t)R * Cout;
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (ch[j] >= Cout) continue;
      const float n = (acc[i][j] - mean[i]) * rstd[i];
      o[ch[j]] = gelu(n * ln_scale[ch[j]] + ln_bias[ch[j]], tanh_form != 0);
    }
  }
}

}  // namespace

extern "C" {

// x [B, T, Cin] channels-last, w [k*Cin, Cout] (row j*Cin + ci), both of
// dtype (0 = float32, 1 = bfloat16); cb [Cout] f32 or null, ln_scale and
// ln_bias [Cout] f32; out [B, T_out, Cout] of dtype, T_out = (T - k) / s + 1
// >= 1.  Cin and Cout multiples of 8, Cout <= 512.  Pointers 16-byte
// aligned.  Returns cudaGetLastError() after the launch (0 = launched).
int fddm_conv_ln_gelu(const void* x, const void* w, const void* cb, const void* ln_scale,
                      const void* ln_bias, void* out, int B, int T, int Cin, int Cout,
                      int ksize, int stride, int dtype, int tanh_form, float eps,
                      void* stream) {
  if (B <= 0 || T < ksize || ksize <= 0 || stride <= 0) return (int)cudaErrorInvalidValue;
  if (Cin <= 0 || Cin % 8 != 0 || Cout <= 0 || Cout % 8 != 0 || Cout > MAX_COUT)
    return (int)cudaErrorInvalidValue;
  const int T_out = (T - ksize) / stride + 1;
  const long long rows_ll = (long long)B * T_out;
  const long long K_ll = (long long)ksize * Cin;
  if (rows_ll > 0x7fffffffLL - 64 || K_ll > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int rows = (int)rows_ll, K = (int)K_ll;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cbf = static_cast<const float*>(cb);
  const float* lsf = static_cast<const float*>(ln_scale);
  const float* lbf = static_cast<const float*>(ln_bias);
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(conv_ln_gelu_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)H_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    conv_ln_gelu_bf16_kernel<<<(rows + H_BM - 1) / H_BM, H_THREADS, H_SMEM_BYTES, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), cbf, lsf, lbf,
        static_cast<bf16*>(out), rows, T, T_out, Cin, Cout, K, stride, eps, tanh_form);
  } else if (dtype == 0) {
    conv_ln_gelu_f32_kernel<<<(rows + S_BM - 1) / S_BM, S_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), cbf, lsf, lbf,
        static_cast<float*>(out), rows, T, T_out, Cin, Cout, K, stride, eps, tanh_form);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
