// WavLM gated relative-position-bias attention for Hopper (sm_90a).
//
//   out[b, q, h*64:(h+1)*64] = softmax_k(q.k / sqrt(64) + gate[b,h,q] * bias[h,q,k],
//                                        masked keys -> f32-min) . v
//
// Replaces three TPU kernels of fddm_asr_tpu/ops/flash_attention.py:
//   * `_kernel_packed`          (resident-K, dispatched for L <= 4096),
//   * `_kernel_packed_flash`    (k-blocked running softmax, L > 4096), and
//   * `_kernel_packed_fwd_lse`  (the training forward: the same output plus
//                                the row logsumexp the backward needs).
// One online-softmax (k-looped) design covers every L, so it computes the
// first two functions; given an `lse` pointer it also writes
// lse[b, h, q] = m + log(l) (f32) from the running max and sum it already
// holds at the end of the key loop, which is the third.  At a row whose
// keys are all masked m is f32-min and m + log(l) rounds to f32-min too
// (the backward, gated_attention_bwd.cu, relies on that).  It loops over
// exactly the L real keys; at a row whose keys are
// all masked it therefore averages v over the L real keys, as the XLA
// reference `wavlm_gated_attention_xla` does (the TPU kernels average over
// their 128-padded key count instead).
//
// Layout: q/k/v/out are head-packed [B, L, H*64] (the projections' natural
// output), bias is the shared [H, L, L] position bias, gate [B, H, L] f32,
// mask [B, L] uint8 (1 = keep) or null.  bias has q's dtype.  Scores,
// running max/sum and the accumulator are f32.  The running max starts at
// f32-min, not -inf, so the first correction exp(m_prev - m_new) underflows
// to exactly 0 instead of giving NaN.  P is rounded to v's dtype before
// P.V, as on the TPU.  Keys past L score -inf (excluded); masked keys
// score f32-min (kept, at equal weight when a whole row is masked).
//
// What bounds it: at the main-path shape (B=8, L=1024, H=16, bf16) one call
// moves ~101 MB (q/k/v/out plus the bias read once) and does ~34 GFLOP of
// products, so on an H100 the bound is ~30-35 us, bytes and tensor-core
// operations nearly level.  The bias is the only input shared across the
// batch: blocks are ordered batch-fastest (gridDim.x = B) so the B blocks
// that read one [64, 64] bias tile run together and B-1 of them find it in
// L2.  Each block owns 64 queries of one (batch, head) and walks the keys
// in 64-key steps with K, V and bias tiles staged in shared memory.
//   * bfloat16 (the main path): four warps, 16 query rows each, run both
//     products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//     accumulate); Q stays in registers, P goes from the score accumulator
//     straight into the A operand of P.V, V's B operand comes through
//     ldmatrix.trans.  Loads are synchronous (no cp.async/TMA pipeline, no
//     wgmma), so it still runs well short of the bound.
//   * float32: exact f32, so no tensor cores: 256 threads, each a 4x4
//     register micro-tile of scalar FMAs.
// Their measured times stand in PERF.md.

#include "gated_attention.cuh"

namespace {

using namespace fddm;

// Shared memory (floats): Qt [DH][PAD], Kt [DH][PAD], V [BK][DH],
// BP [BQ][PAD] (bias tile, then reused for P^T [BK][PAD]), keep [BK].
constexpr int F32_SMEM_FLOATS = DH * PAD + DH * PAD + BK * DH + BQ * PAD + BK;
constexpr size_t F32_SMEM_BYTES = F32_SMEM_FLOATS * sizeof(float);

__global__ void __launch_bounds__(F32_THREADS, 2)
gated_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ gate,
                           const uint8_t* __restrict__ mask, float* __restrict__ out,
                           float* __restrict__ lse, int L, int H, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                // [DH][PAD]   Qt[d][r]
  float* Kt = Qt + DH * PAD;       // [DH][PAD]   Kt[d][c]
  float* Vs = Kt + DH * PAD;       // [BK][DH]    Vs[c][d]
  float* BP = Vs + BK * DH;        // [BQ][PAD]   bias[r][c], then P^T[c][r]
  float* keep = BP + BQ * PAD;     // [BK]        1 keep, 0 masked, -1 beyond L

  const int b = blockIdx.x;        // batch fastest: bias tiles reused from L2
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * BQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;         // rows 4rg..4rg+3 of the tile
  const int cg = tid & 15;         // score cols / output dims 4cg..4cg+3
  const size_t HD = (size_t)H * DH;

  // Q tile -> Qt (zero rows beyond L; they are never stored)
  for (int i = tid; i < BQ * DH; i += F32_THREADS) {
    const int r = i / DH, d = i % DH;
    const int qi = q0 + r;
    Qt[d * PAD + r] = qi < L ? q[((size_t)b * L + qi) * HD + h * DH + d] : 0.f;
  }

  float gate_r[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    gate_r[i] = qi < L ? gate[((size_t)b * H + h) * L + qi] : 0.f;
  }

  float m[4], l[4], acc[4][4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
    #pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const float* bias_h = bias + (size_t)h * L * L;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // previous step's readers of Kt/Vs/BP are done
    for (int i = tid; i < BK * DH; i += F32_THREADS) {
      const int c = i / DH, d = i % DH;
      const int kj = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kj < L) {
        const size_t off = ((size_t)b * L + kj) * HD + h * DH + d;
        kv = k[off];
        vv = v[off];
      }
      Kt[d * PAD + c] = kv;
      Vs[c * DH + d] = vv;
    }
    for (int i = tid; i < BQ * BK; i += F32_THREADS) {
      const int r = i / BK, c = i % BK;
      const int qi = q0 + r, kj = k0 + c;
      BP[r * PAD + c] = (qi < L && kj < L) ? bias_h[(size_t)qi * L + kj] : 0.f;
    }
    if (tid < BK) {
      const int kj = k0 + tid;
      keep[tid] = kj >= L ? -1.f : (mask == nullptr || mask[(size_t)b * L + kj]) ? 1.f : 0.f;
    }
    __syncthreads();

    // S = Q K^T on the thread's 4x4 micro-tile
    float s[4][4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * PAD + 4 * rg]);
      const float4 kb = *reinterpret_cast<const float4*>(&Kt[d * PAD + 4 * cg]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kvv[4] = {kb.x, kb.y, kb.z, kb.w};
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kvv[j], s[i][j]);
    }

    // scale + gated bias + mask; out-of-range keys are excluded outright
    float rmax[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      rmax[i] = -INFINITY;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * cg + j;
        const float kp = keep[c];
        float sv = s[i][j] * scale + gate_r[i] * BP[(4 * rg + i) * PAD + c];
        sv = kp > 0.f ? sv : (kp == 0.f ? NEG : -INFINITY);
        s[i][j] = sv;
        rmax[i] = fmaxf(rmax[i], sv);
      }
    }
    // the 16 threads sharing a row group are one half-warp
    #pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], off));

    float p[4][4], rsum[4], corr[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], rmax[i]);
      corr[i] = expf(m[i] - m_new);
      rsum[i] = 0.f;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);  // exp(-inf) = 0 beyond L
        rsum[i] += p[i][j];
      }
      m[i] = m_new;
    }
    #pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], off);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = l[i] * corr[i] + rsum[i];
      #pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr[i];
    }

    __syncthreads();  // every thread has read its bias values
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j)  // P stored transposed
        BP[(4 * cg + j) * PAD + 4 * rg + i] = p[i][j];
    __syncthreads();

    // acc += P V
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&BP[c * PAD + 4 * rg]);
      const float4 vb = *reinterpret_cast<const float4*>(&Vs[c * DH + 4 * cg]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float vvv[4] = {vb.x, vb.y, vb.z, vb.w};
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vvv[j], acc[i][j]);
    }
  }

  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    if (qi >= L) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* o = out + ((size_t)b * L + qi) * HD + h * DH + 4 * cg;
    #pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = acc[i][j] * inv;
    if (lse != nullptr && cg == 0)  // the 16 threads of a row group hold the same m, l
      lse[((size_t)b * H + h) * L + qi] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------- bfloat16

__global__ void __launch_bounds__(MMA_THREADS)
gated_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ bias,
                            const float* __restrict__ gate,
                            const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                            float* __restrict__ lse, int L, int H, float scale) {
  __shared__ __align__(16) bf16 Ks[BK * KSTR];   // [key][d]
  __shared__ __align__(16) bf16 Vs[BK * KSTR];   // [key][d]
  __shared__ __align__(16) bf16 Bs[BQ * KSTR];   // [query][key]
  __shared__ float keep[BK];                     // 1 keep, 0 masked, -1 beyond L

  const int b = blockIdx.x;        // batch fastest: bias tiles reused from L2
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const size_t HD = (size_t)H * DH;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // the thread's two rows in the tile
  const int r0 = q0 + lr0, r1 = q0 + lr1;

  // Q as mma A fragments, 4 slices of 16 head dims, kept in registers
  uint32_t qa[4][4];
  load_a_fragments(qa, q + ((size_t)b * L + r0) * HD + h * DH,
                   q + ((size_t)b * L + r1) * HD + h * DH, r0 < L, r1 < L, t);
  const float gate0 = r0 < L ? gate[((size_t)b * H + h) * L + r0] : 0.f;
  const float gate1 = r1 < L ? gate[((size_t)b * H + h) * L + r1] : 0.f;

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[8][4];  // 8 tiles of 8 head dims, mma C layout
  #pragma unroll
  for (int n = 0; n < 8; ++n)
    #pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const bf16* k_bh = k + (size_t)b * L * HD + h * DH;
  const bf16* v_bh = v + (size_t)b * L * HD + h * DH;
  const bf16* bias_q = bias + (size_t)h * L * L + (size_t)q0 * L;
  const bool bias_vec = (L & 7) == 0;
  const uint32_t* Ks32 = reinterpret_cast<const uint32_t*>(Ks);
  const uint32_t* Bs32 = reinterpret_cast<const uint32_t*>(Bs);
  constexpr int KSTR32 = KSTR / 2;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // previous step's readers of Ks/Vs/Bs/keep are done
    load_tile(Ks, k_bh + (size_t)k0 * HD, HD, L - k0, DH, true);
    load_tile(Vs, v_bh + (size_t)k0 * HD, HD, L - k0, DH, true);
    load_tile(Bs, bias_q + k0, L, L - q0, L - k0, bias_vec);
    if (threadIdx.x < BK) {
      const int kj = k0 + threadIdx.x;
      keep[threadIdx.x] = kj >= L ? -1.f
                          : (mask == nullptr || mask[(size_t)b * L + kj]) ? 1.f : 0.f;
    }
    __syncthreads();

    // S = Q K^T: 8 tiles of 8 keys, each over 4 slices of 16 head dims
    float s[8][4];
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t* krow = Ks32 + (j * 8 + g) * KSTR32;
      #pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_bf16(s[j], qa[ks], krow[ks * 8 + t], krow[ks * 8 + 4 + t]);
    }

    // scale + gated bias + mask; the thread holds rows lr0 (e = 0, 1) and
    // lr1 (e = 2, 3) at key columns 8j + 2t + (e & 1)
    float rmax[2] = {-INFINITY, -INFINITY};
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 b0 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Bs32 + lr0 * KSTR32 + (c >> 1)));
      const float2 b1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Bs32 + lr1 * KSTR32 + (c >> 1)));
      const float bv[4] = {b0.x, b0.y, b1.x, b1.y};
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kp = keep[c + (e & 1)];
        float sv = s[j][e] * scale + (e < 2 ? gate0 : gate1) * bv[e];
        sv = kp > 0.f ? sv : (kp == 0.f ? NEG : -INFINITY);
        s[j][e] = sv;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], sv);
      }
    }
    // the 4 threads of a row group hold one row between them
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 1));
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 2));
    }
    float m_new[2], corr[2], rsum[2] = {0.f, 0.f};
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m[i], rmax[i]);
      corr[i] = expf(m[i] - m_new[i]);
      m[i] = m_new[i];
    }
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_new[e >> 1]);  // exp(-inf) = 0 beyond L
        rsum[e >> 1] += s[j][e];
      }
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l[i] = l[i] * corr[i] + rsum[i];
    }
    #pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P (rounded to bf16) goes from the score tiles straight into
    // A fragments, 16 keys at a time; V's B fragments through ldmatrix.trans
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = Vs + (kk * 16 + (lane & 15)) * KSTR;
      #pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t vb0, vb1;
        ldmatrix_x2_trans(vb0, vb1, vrow + n * 8);
        mma_bf16(o[n], pa, vb0, vb1);
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  if (lse != nullptr && t == 0) {  // the 4 threads of a row group hold the same m, l
    float* lse_bh = lse + ((size_t)b * H + h) * L;
    if (r0 < L) lse_bh[r0] = m[0] + logf(fmaxf(l[0], 1e-30f));
    if (r1 < L) lse_bh[r1] = m[1] + logf(fmaxf(l[1], 1e-30f));
  }
  #pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = h * DH + n * 8 + 2 * t;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * L + r0) * HD + c) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * L + r1) * HD + c) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  mask may be null (all keys kept); lse
// ([B, H, L] f32) may be null (the inference path).  Pointers must be
// 16-byte aligned.  Returns cudaGetLastError() after the launch (0 =
// launched).
int fddm_gated_attention(const void* q, const void* k, const void* v,
                         const void* bias, const void* gate, const void* mask,
                         void* out, void* lse, int B, int L, int H, int dtype,
                         void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if ((L + BQ - 1) / BQ > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, H, (L + BQ - 1) / BQ);
  const float scale = 0.125f;  // 1 / sqrt(64)
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == 0) {
    cudaError_t err = cudaFuncSetAttribute(gated_attention_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)F32_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    gated_attention_f32_kernel<<<grid, F32_THREADS, F32_SMEM_BYTES, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<const float*>(gate), m, static_cast<float*>(out),
        static_cast<float*>(lse), L, H, scale);
  } else if (dtype == 1) {
    gated_attention_bf16_kernel<<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(bias), static_cast<const float*>(gate), m,
        static_cast<bf16*>(out), static_cast<float*>(lse), L, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
