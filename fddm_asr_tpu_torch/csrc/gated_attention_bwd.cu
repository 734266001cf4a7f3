// Backward of the WavLM gated relative-position-bias attention for Hopper (sm_90a).
//
// With S = q.k^T / sqrt(64) + gate[b,h,q] * bias[h,q,k] (f32, as the forward
// in gated_attention.cu computes it), P = exp(S - lse) recomputed from the
// forward's row logsumexp, delta = rowsum(dO * O) (computed by the caller):
//
//   dP = dO V^T,  dS = P * (dP - delta)                        (f32)
//   dQ = scale * dS K,  dgate = rowsum(dS * bias)               kernel A (dq)
//   dK = scale * dS^T Q,  dV = P^T dO,  dbias = sum_b dS * gate kernel B (dkv)
//
// Replaces the two backward TPU kernels of fddm_asr_tpu/ops/flash_attention.py:
//   * `_kernel_packed_bwd_dq`   -> kernel A, one block per (64-query tile,
//     head, batch row) that walks every key, as the forward does;
//   * `_kernel_packed_bwd_dkv`  -> kernel B, one block per (64-key tile,
//     head) that walks batch rows (outer) and query tiles (inner).
//
// The TPU kernel B accumulates dbias across the batch in an output block
// that stays resident over an innermost sequential batch grid axis.  Hopper
// blocks run in no order, so that does not carry over.  Here a block owns
// its dbias columns [h, :, key tile] outright: dK/dV of one batch row stay in
// registers across the query loop and are written when the row is done,
// while dbias is read, added to and written back in f32 in device memory
// for each (batch row, query tile) -- no two blocks touch one element, so no
// atomics are needed and the sum is the same from run to run.
//
// Masking, to be the exact gradient of the port's forward (which scores
// masked keys f32-min and excludes keys past L):
//   * masked keys get dS = 0 (their score is a constant), and P = 0 --
//     except at a row whose keys are all masked, where the forward averages
//     v over the L real keys: there lse = f32-min, so exp(f32-min - lse) = 1
//     and P = 1/L (the `inv_L` factor) feeds dV;
//   * keys past L and query rows past L (lse taken as +inf) get P = dS = 0.
// (The TPU kernels differ at all-masked rows: their P there is 1, not 1/Lk,
// and dS is not zeroed.)
//
// Numerics: S is recomputed with the forward's own arithmetic (the f32
// product scaled, then the gated bias added), so P <= 1 up to rounding.
//   * bfloat16 (the training path): four warps of 16 rows on the tensor
//     cores (mma.sync m16n8k16, bf16 in, f32 accumulate).  dS and P are
//     rounded to bf16 as the A operands of the second products, as the TPU
//     kernels round them; delta, dgate and dbias stay f32.
//   * float32: exact f32 FMAs, 256 threads of 4x4 register micro-tiles.
//
// What bounds it: at the training shape (B=8, L=1024, H=16, bf16, every key
// kept) kernel A moves ~118 MB (q, k, v, dO, dq and the bias once) and does
// 6*64 flops per (query, kept key) pair and head, ~52 GFLOP; kernel B moves
// ~200 MB (the same plus dk, dv and the 64 MB f32 dbias) for 8*64 flops per
// pair, ~69 GFLOP.  So both sit near the balance of bytes and tensor-core
// operations, ~35-50 us (A) and ~60-70 us (B).  This first design runs far
// from that: synchronous loads (no cp.async/TMA pipeline, no wgmma), and
// kernel B's dbias read-modify-write, 2*B passes over its f32 slab for each
// block (staged through smem so they go out as coalesced 16-byte rows).
// Measured times stand in PERF.md.

#include "gated_attention.cuh"

namespace {

using namespace fddm;

// ---------------------------------------------------------------- float32

// kernel A: Qt, Dt (dO^T), Kt, Vt [DH][PAD] ([d][row]); Ks [BK][DH];
// BP [BQ][PAD] (bias tile, then dS^T); keep [BK]
constexpr int DQ_F32_SMEM_FLOATS = 4 * DH * PAD + BK * DH + BQ * PAD + BK;
constexpr size_t DQ_F32_SMEM_BYTES = DQ_F32_SMEM_FLOATS * sizeof(float);

__global__ void __launch_bounds__(F32_THREADS)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  const float* __restrict__ gate, const uint8_t* __restrict__ mask,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const float* __restrict__ dout, float* __restrict__ dq,
                  float* __restrict__ dgate, int L, int H, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;
  float* Dt = Qt + DH * PAD;
  float* Kt = Dt + DH * PAD;
  float* Vt = Kt + DH * PAD;
  float* Ks = Vt + DH * PAD;
  float* BP = Ks + BK * DH;
  float* keep = BP + BQ * PAD;

  const int b = blockIdx.x;  // batch fastest: bias tiles reused from L2
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * BQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;   // query rows 4rg..4rg+3
  const int cg = tid & 15;   // key cols / head dims 4cg..4cg+3
  const size_t HD = (size_t)H * DH;
  const size_t qrow = ((size_t)b * L + q0) * HD + h * DH;

  load_tile_f32(Qt, q + qrow, HD, L - q0, true, 0);
  load_tile_f32(Dt, dout + qrow, HD, L - q0, true, 0);
  float gate_r[4], lse_r[4], delta_r[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    const size_t idx = ((size_t)b * H + h) * L + qi;
    gate_r[i] = qi < L ? gate[idx] : 0.f;
    lse_r[i] = qi < L ? lse[idx] : 0.f;
    delta_r[i] = qi < L ? delta[idx] : 0.f;
  }

  float acc[4][4], dg[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    dg[i] = 0.f;
    #pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const float* bias_h = bias + (size_t)h * L * L;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // previous step's readers are done
    const size_t krow = ((size_t)b * L + k0) * HD + h * DH;
    load_tile_f32(Kt, k + krow, HD, L - k0, true, 0);
    load_tile_f32(Vt, v + krow, HD, L - k0, true, 0);
    load_tile_f32(Ks, k + krow, HD, L - k0, false, DH);
    for (int i = tid; i < BQ * BK; i += F32_THREADS) {
      const int r = i / BK, c = i % BK;
      const int qi = q0 + r, kj = k0 + c;
      BP[r * PAD + c] = (qi < L && kj < L) ? bias_h[(size_t)qi * L + kj] : 0.f;
    }
    if (tid < BK) keep[tid] = keep_flag(mask, b, k0 + tid, L);
    __syncthreads();

    // S = Q K^T and dP = dO V^T on the thread's 4x4 micro-tile
    float s[4][4], dp[4][4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * PAD + 4 * rg]);
      const float4 da = *reinterpret_cast<const float4*>(&Dt[d * PAD + 4 * rg]);
      const float4 kb = *reinterpret_cast<const float4*>(&Kt[d * PAD + 4 * cg]);
      const float4 vb = *reinterpret_cast<const float4*>(&Vt[d * PAD + 4 * cg]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w}, dv[4] = {da.x, da.y, da.z, da.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w}, vv[4] = {vb.x, vb.y, vb.z, vb.w};
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
        }
    }

    // dS = P (dP - delta) at kept keys, 0 elsewhere; dgate += dS * bias
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * cg + j;
        const float bv = BP[(4 * rg + i) * PAD + c];
        float ds = 0.f;
        if (keep[c] > 0.f) {
          const float sv = s[i][j] * scale + gate_r[i] * bv;
          ds = expf(sv - lse_r[i]) * (dp[i][j] - delta_r[i]);
        }
        dg[i] = fmaf(ds, bv, dg[i]);
        s[i][j] = ds;
      }
    __syncthreads();  // every thread has read its bias values
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) BP[(4 * cg + j) * PAD + 4 * rg + i] = s[i][j];  // dS^T
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 sa = *reinterpret_cast<const float4*>(&BP[c * PAD + 4 * rg]);
      const float4 kb = *reinterpret_cast<const float4*>(&Ks[c * DH + 4 * cg]);
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w}, kv[4] = {kb.x, kb.y, kb.z, kb.w};
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  // the 16 threads sharing a row group are one half-warp
  #pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    #pragma unroll
    for (int i = 0; i < 4; ++i) dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], off);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    if (qi >= L) continue;
    float* o = dq + ((size_t)b * L + qi) * HD + h * DH + 4 * cg;
    #pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = acc[i][j] * scale;
    if (cg == 0) dgate[((size_t)b * H + h) * L + qi] = dg[i];
  }
}

// kernel B: Kt, Vt, Qt, Dt [DH][PAD] ([d][row]); Qs, Ds [BQ][DH]; Pm, Sm
// [BQ][PAD] ([query][key]: the bias tile, then P; dS); lse, delta, gate
// [BQ]; keep [BK]
constexpr int DKV_F32_SMEM_FLOATS = 4 * DH * PAD + 2 * BQ * DH + 2 * BQ * PAD + 3 * BQ + BK;
constexpr size_t DKV_F32_SMEM_BYTES = DKV_F32_SMEM_FLOATS * sizeof(float);

__global__ void __launch_bounds__(F32_THREADS)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ gate, const uint8_t* __restrict__ mask,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const float* __restrict__ dout, float* __restrict__ dk,
                   float* __restrict__ dv, float* __restrict__ dbias, int B, int L, int H,
                   float scale, float inv_L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Kt = smem;
  float* Vt = Kt + DH * PAD;
  float* Qt = Vt + DH * PAD;
  float* Dt = Qt + DH * PAD;
  float* Qs = Dt + DH * PAD;
  float* Ds = Qs + BQ * DH;
  float* Pm = Ds + BQ * DH;
  float* Sm = Pm + BQ * PAD;
  float* lse_s = Sm + BQ * PAD;
  float* delta_s = lse_s + BQ;
  float* gate_s = delta_s + BQ;
  float* keep = gate_s + BQ;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;   // keys 4rg..4rg+3
  const int cg = tid & 15;   // queries / head dims 4cg..4cg+3
  const size_t HD = (size_t)H * DH;
  const float* bias_h = bias + (size_t)h * L * L;

  for (int b = 0; b < B; ++b) {
    __syncthreads();  // the previous batch row's readers are done
    const size_t krow = ((size_t)b * L + k0) * HD + h * DH;
    load_tile_f32(Kt, k + krow, HD, L - k0, true, 0);
    load_tile_f32(Vt, v + krow, HD, L - k0, true, 0);
    if (tid < BK) keep[tid] = keep_flag(mask, b, k0 + tid, L);
    float gk[4][4], gv[4][4];  // dK, dV accumulators (key 4rg+i, dim 4cg+j)
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) gk[i][j] = gv[i][j] = 0.f;

    for (int q0 = 0; q0 < L; q0 += BQ) {
      __syncthreads();  // previous step's readers are done
      const size_t qrow = ((size_t)b * L + q0) * HD + h * DH;
      load_tile_f32(Qt, q + qrow, HD, L - q0, true, 0);
      load_tile_f32(Dt, dout + qrow, HD, L - q0, true, 0);
      load_tile_f32(Qs, q + qrow, HD, L - q0, false, DH);
      load_tile_f32(Ds, dout + qrow, HD, L - q0, false, DH);
      for (int i = tid; i < BQ * BK; i += F32_THREADS) {
        const int r = i / BK, c = i % BK;
        const int qi = q0 + r, kj = k0 + c;
        Pm[r * PAD + c] = (qi < L && kj < L) ? bias_h[(size_t)qi * L + kj] : 0.f;
      }
      if (tid < BQ) {
        const int qi = q0 + tid;
        const size_t idx = ((size_t)b * H + h) * L + qi;
        lse_s[tid] = qi < L ? lse[idx] : INFINITY;  // rows past L: P = 0
        delta_s[tid] = qi < L ? delta[idx] : 0.f;
        gate_s[tid] = qi < L ? gate[idx] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T (key 4rg+i, query 4cg+j)
      float s[4][4], dp[4][4];
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * PAD + 4 * rg]);
        const float4 va = *reinterpret_cast<const float4*>(&Vt[d * PAD + 4 * rg]);
        const float4 qb = *reinterpret_cast<const float4*>(&Qt[d * PAD + 4 * cg]);
        const float4 db = *reinterpret_cast<const float4*>(&Dt[d * PAD + 4 * cg]);
        const float kv[4] = {ka.x, ka.y, ka.z, ka.w}, vv[4] = {va.x, va.y, va.z, va.w};
        const float qv[4] = {qb.x, qb.y, qb.z, qb.w}, dv_[4] = {db.x, db.y, db.z, db.w};
        #pragma unroll
        for (int i = 0; i < 4; ++i)
          #pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dv_[j], dp[i][j]);
          }
      }

      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float kp = keep[4 * rg + i];
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * cg + j;
          const float bv = Pm[r * PAD + 4 * rg + i];
          float p = 0.f, ds = 0.f;
          if (kp > 0.f) {
            const float sv = s[i][j] * scale + gate_s[r] * bv;
            p = expf(sv - lse_s[r]);
            ds = p * (dp[i][j] - delta_s[r]);
          } else if (kp == 0.f) {
            p = expf(NEG - lse_s[r]) * inv_L;  // 1/L at an all-masked row, else 0
          }
          s[i][j] = p;
          dp[i][j] = ds;
        }
      }
      // dbias[h, q, k] (+)= dS * gate: this block alone owns these columns
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * cg + j;
        if (q0 + r >= L) continue;
        float* dst = dbias + ((size_t)h * L + q0 + r) * L + k0 + 4 * rg;
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k0 + 4 * rg + i >= L) continue;
          const float val = dp[i][j] * gate_s[r];
          dst[i] = b == 0 ? val : dst[i] + val;
        }
      }
      __syncthreads();  // every thread has read its bias values
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          Pm[(4 * cg + j) * PAD + 4 * rg + i] = s[i][j];
          Sm[(4 * cg + j) * PAD + 4 * rg + i] = dp[i][j];
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float4 pa = *reinterpret_cast<const float4*>(&Pm[r * PAD + 4 * rg]);
        const float4 sa = *reinterpret_cast<const float4*>(&Sm[r * PAD + 4 * rg]);
        const float4 db = *reinterpret_cast<const float4*>(&Ds[r * DH + 4 * cg]);
        const float4 qb = *reinterpret_cast<const float4*>(&Qs[r * DH + 4 * cg]);
        const float pv[4] = {pa.x, pa.y, pa.z, pa.w}, sv[4] = {sa.x, sa.y, sa.z, sa.w};
        const float dv_[4] = {db.x, db.y, db.z, db.w}, qv[4] = {qb.x, qb.y, qb.z, qb.w};
        #pragma unroll
        for (int i = 0; i < 4; ++i)
          #pragma unroll
          for (int j = 0; j < 4; ++j) {
            gv[i][j] = fmaf(pv[i], dv_[j], gv[i][j]);
            gk[i][j] = fmaf(sv[i], qv[j], gk[i][j]);
          }
      }
    }

    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + 4 * rg + i;
      if (kj >= L) continue;
      const size_t off = ((size_t)b * L + kj) * HD + h * DH + 4 * cg;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        dk[off + j] = gk[i][j] * scale;
        dv[off + j] = gv[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------- bfloat16

// kernel A: Q and dO stay in registers as A fragments; K, V, bias tiles in smem.
__global__ void __launch_bounds__(MMA_THREADS)
bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ bias,
                   const float* __restrict__ gate, const uint8_t* __restrict__ mask,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const bf16* __restrict__ dout, bf16* __restrict__ dq,
                   float* __restrict__ dgate, int L, int H, float scale) {
  __shared__ __align__(16) bf16 Ks[BK * KSTR];   // [key][d]
  __shared__ __align__(16) bf16 Vs[BK * KSTR];   // [key][d]
  __shared__ __align__(16) bf16 Bs[BQ * KSTR];   // [query][key]
  __shared__ float keep[BK];

  const int b = blockIdx.x;  // batch fastest: bias tiles reused from L2
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t HD = (size_t)H * DH;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int r0 = q0 + lr0, r1 = q0 + lr1;

  uint32_t qa[4][4], da[4][4];
  load_a_fragments(qa, q + ((size_t)b * L + r0) * HD + h * DH,
                   q + ((size_t)b * L + r1) * HD + h * DH, r0 < L, r1 < L, t);
  load_a_fragments(da, dout + ((size_t)b * L + r0) * HD + h * DH,
                   dout + ((size_t)b * L + r1) * HD + h * DH, r0 < L, r1 < L, t);
  float gate_r[2], lse_r[2], delta_r[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i == 0 ? r0 : r1;
    const size_t idx = ((size_t)b * H + h) * L + r;
    gate_r[i] = r < L ? gate[idx] : 0.f;
    lse_r[i] = r < L ? lse[idx] : 0.f;
    delta_r[i] = r < L ? delta[idx] : 0.f;
  }

  float acc[8][4];  // dQ: 8 tiles of 8 head dims, mma C layout
  #pragma unroll
  for (int n = 0; n < 8; ++n)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float dg[2] = {0.f, 0.f};

  const bf16* k_bh = k + (size_t)b * L * HD + h * DH;
  const bf16* v_bh = v + (size_t)b * L * HD + h * DH;
  const bf16* bias_q = bias + (size_t)h * L * L + (size_t)q0 * L;
  const bool bias_vec = (L & 7) == 0;
  const uint32_t* Ks32 = reinterpret_cast<const uint32_t*>(Ks);
  const uint32_t* Vs32 = reinterpret_cast<const uint32_t*>(Vs);
  const uint32_t* Bs32 = reinterpret_cast<const uint32_t*>(Bs);
  constexpr int KSTR32 = KSTR / 2;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    load_tile(Ks, k_bh + (size_t)k0 * HD, HD, L - k0, DH, true);
    load_tile(Vs, v_bh + (size_t)k0 * HD, HD, L - k0, DH, true);
    load_tile(Bs, bias_q + k0, L, L - q0, L - k0, bias_vec);
    if (threadIdx.x < BK) keep[threadIdx.x] = keep_flag(mask, b, k0 + threadIdx.x, L);
    __syncthreads();

    // S = Q K^T, dP = dO V^T: 8 tiles of 8 keys over 4 slices of 16 head dims
    float s[8][4], dp[8][4];
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const uint32_t* krow = Ks32 + (j * 8 + g) * KSTR32;
      const uint32_t* vrow = Vs32 + (j * 8 + g) * KSTR32;
      #pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        mma_bf16(s[j], qa[ks], krow[ks * 8 + t], krow[ks * 8 + 4 + t]);
        mma_bf16(dp[j], da[ks], vrow[ks * 8 + t], vrow[ks * 8 + 4 + t]);
      }
    }

    // dS = P (dP - delta) at kept keys (rows lr0: e = 0, 1; lr1: e = 2, 3;
    // key columns 8j + 2t + (e & 1)), 0 elsewhere; dgate += dS * bias
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
        const int i = e >> 1;
        float ds = 0.f;
        if (keep[c + (e & 1)] > 0.f) {
          const float sv = s[j][e] * scale + gate_r[i] * bv[e];
          ds = expf(sv - lse_r[i]) * (dp[j][e] - delta_r[i]);
        }
        dg[i] = fmaf(ds, bv[e], dg[i]);
        s[j][e] = ds;
      }
    }

    // dQ += dS K: dS (rounded to bf16) from the accumulators straight into A
    // fragments, 16 keys at a time; K's B fragments through ldmatrix.trans
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t sa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* krow = Ks + (kk * 16 + (lane & 15)) * KSTR;
      #pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t kb0, kb1;
        ldmatrix_x2_trans(kb0, kb1, krow + n * 8);
        mma_bf16(acc[n], sa, kb0, kb1);
      }
    }
  }

  #pragma unroll
  for (int i = 0; i < 2; ++i) {  // the 4 threads of a row group share a row
    dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], 1);
    dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], 2);
  }
  #pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = h * DH + n * 8 + 2 * t;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(dq + ((size_t)b * L + r0) * HD + c) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(dq + ((size_t)b * L + r1) * HD + c) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
  if (t == 0) {
    float* dg_bh = dgate + ((size_t)b * H + h) * L;
    if (r0 < L) dg_bh[r0] = dg[0];
    if (r1 < L) dg_bh[r1] = dg[1];
  }
}

// kernel B: each warp owns 16 of the block's 64 keys; their K and V rows of
// the current batch row stay in registers as A fragments; Q, dO and bias
// tiles of each query step in smem.  Products run transposed (rows = keys).
// The step's dS * gate tile is staged in smem so that the read-modify-write
// of dbias goes out as coalesced 16-byte rows.
constexpr int TSTR = BK + 4;  // Ts row stride (floats): 16-byte aligned rows
__global__ void __launch_bounds__(MMA_THREADS)
bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ bias,
                    const float* __restrict__ gate, const uint8_t* __restrict__ mask,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const bf16* __restrict__ dout, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, float* __restrict__ dbias, int B, int L, int H,
                    float scale, float inv_L) {
  __shared__ __align__(16) bf16 Qs[BQ * KSTR];   // [query][d]
  __shared__ __align__(16) bf16 Ds[BQ * KSTR];   // [query][d] (dO)
  __shared__ __align__(16) bf16 Bs[BQ * KSTR];   // [query][key]
  __shared__ __align__(16) float Ts[BQ * TSTR];  // dS * gate of the step, [query][key]
  __shared__ float lse_s[BQ], delta_s[BQ], gate_s[BQ];

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t HD = (size_t)H * DH;
  const int lk0 = warp * 16 + g, lk1 = lk0 + 8;  // the thread's two keys in the tile
  const int kr0 = k0 + lk0, kr1 = k0 + lk1;
  const bool bias_vec = (L & 7) == 0;
  const bool dbias_vec = (L & 3) == 0;  // dbias rows 16-byte aligned
  const uint32_t* Qs32 = reinterpret_cast<const uint32_t*>(Qs);
  const uint32_t* Ds32 = reinterpret_cast<const uint32_t*>(Ds);
  constexpr int KSTR32 = KSTR / 2;
  const bf16* bias_k = bias + (size_t)h * L * L + k0;

  for (int b = 0; b < B; ++b) {
    uint32_t ka[4][4], va[4][4];
    load_a_fragments(ka, k + ((size_t)b * L + kr0) * HD + h * DH,
                     k + ((size_t)b * L + kr1) * HD + h * DH, kr0 < L, kr1 < L, t);
    load_a_fragments(va, v + ((size_t)b * L + kr0) * HD + h * DH,
                     v + ((size_t)b * L + kr1) * HD + h * DH, kr0 < L, kr1 < L, t);
    const float keep_r[2] = {keep_flag(mask, b, kr0, L), keep_flag(mask, b, kr1, L)};
    float gk[8][4], gv[8][4];  // dK, dV: 8 tiles of 8 head dims, mma C layout
    #pragma unroll
    for (int n = 0; n < 8; ++n)
      #pragma unroll
      for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;
    const bf16* q_b = q + (size_t)b * L * HD + h * DH;
    const bf16* d_b = dout + (size_t)b * L * HD + h * DH;

    for (int q0 = 0; q0 < L; q0 += BQ) {
      __syncthreads();  // previous step's readers are done
      load_tile(Qs, q_b + (size_t)q0 * HD, HD, L - q0, DH, true);
      load_tile(Ds, d_b + (size_t)q0 * HD, HD, L - q0, DH, true);
      load_tile(Bs, bias_k + (size_t)q0 * L, L, L - q0, L - k0, bias_vec);
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        const size_t idx = ((size_t)b * H + h) * L + qi;
        lse_s[threadIdx.x] = qi < L ? lse[idx] : INFINITY;  // rows past L: P = 0
        delta_s[threadIdx.x] = qi < L ? delta[idx] : 0.f;
        gate_s[threadIdx.x] = qi < L ? gate[idx] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T, dP^T = V dO^T: 8 tiles of 8 queries over 4 slices of 16 dims
      float s[8][4], dp[8][4];
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        #pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        const uint32_t* qrow = Qs32 + (j * 8 + g) * KSTR32;
        const uint32_t* drow = Ds32 + (j * 8 + g) * KSTR32;
        #pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          mma_bf16(s[j], ka[ks], qrow[ks * 8 + t], qrow[ks * 8 + 4 + t]);
          mma_bf16(dp[j], va[ks], drow[ks * 8 + t], drow[ks * 8 + 4 + t]);
        }
      }

      // element (key lk0: e = 0, 1; lk1: e = 2, 3; query 8j + 2t + (e & 1)):
      // P into s, dS into dp; dbias (+)= dS * gate, this block's columns only
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = j * 8 + 2 * t + (e & 1);
          const int lk = e < 2 ? lk0 : lk1;
          const float kp = keep_r[e >> 1];
          const float bv = __bfloat162float(Bs[r * KSTR + lk]);
          float p = 0.f, ds = 0.f;
          if (kp > 0.f) {
            const float sv = s[j][e] * scale + gate_s[r] * bv;
            p = expf(sv - lse_s[r]);
            ds = p * (dp[j][e] - delta_s[r]);
          } else if (kp == 0.f) {
            p = expf(NEG - lse_s[r]) * inv_L;  // 1/L at an all-masked row, else 0
          }
          s[j][e] = p;
          dp[j][e] = ds;
          Ts[r * TSTR + lk] = ds * gate_s[r];
        }
      }
      __syncthreads();  // the whole dS * gate tile is in Ts
      // dbias (+)= that tile: this block alone owns these columns; 16-byte
      // coalesced rows where L allows, elementwise at the ragged edge
      for (int i = threadIdx.x; i < BQ * (BK / 4); i += MMA_THREADS) {
        const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
        if (q0 + r >= L) continue;
        float* dst = dbias + ((size_t)h * L + q0 + r) * L + k0 + c;
        const float4 val = *reinterpret_cast<const float4*>(&Ts[r * TSTR + c]);
        if (dbias_vec && k0 + c + 4 <= L) {
          float4 acc = val;
          if (b > 0) {
            const float4 old = *reinterpret_cast<const float4*>(dst);
            acc = make_float4(old.x + val.x, old.y + val.y, old.z + val.z, old.w + val.w);
          }
          *reinterpret_cast<float4*>(dst) = acc;
        } else {
          const float v4[4] = {val.x, val.y, val.z, val.w};
          for (int u = 0; u < 4 && k0 + c + u < L; ++u) dst[u] = b == 0 ? v4[u] : dst[u] + v4[u];
        }
      }

      // dV += P^T dO and dK += dS^T Q: P and dS (rounded to bf16) from the
      // accumulators into A fragments, 16 queries at a time; dO's and Q's B
      // fragments through ldmatrix.trans
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
        const int row = (kk * 16 + (lane & 15)) * KSTR;
        #pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, Ds + row + n * 8);
          mma_bf16(gv[n], pa, b0, b1);
          ldmatrix_x2_trans(b0, b1, Qs + row + n * 8);
          mma_bf16(gk[n], sa, b0, b1);
        }
      }
    }

    #pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = h * DH + n * 8 + 2 * t;
      if (kr0 < L) {
        const size_t off = ((size_t)b * L + kr0) * HD + c;
        *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(gk[n][0] * scale, gk[n][1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(gv[n][0], gv[n][1]);
      }
      if (kr1 < L) {
        const size_t off = ((size_t)b * L + kr1) * HD + c;
        *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(gk[n][2] * scale, gk[n][3] * scale);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(gv[n][2], gv[n][3]);
      }
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q/k/v/bias/dout and the outputs dq, dk,
// dv); gate, lse, delta ([B, H, L]), dgate ([B, H, L]) and dbias ([H, L, L])
// are float32.  mask may be null (all keys kept).  Pointers must be 16-byte
// aligned.  Each returns cudaGetLastError() after the launch (0 = launched).
int fddm_gated_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* bias, const void* gate, const void* mask,
                                const void* lse, const void* delta, const void* dout,
                                void* dq, void* dgate, int B, int L, int H, int dtype,
                                void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if ((L + BQ - 1) / BQ > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, H, (L + BQ - 1) / BQ);
  const float scale = 0.125f;  // 1 / sqrt(64)
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* g = static_cast<const float*>(gate);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)DQ_F32_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    bwd_dq_f32_kernel<<<grid, F32_THREADS, DQ_F32_SMEM_BYTES, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias), g, m, ls, dl,
        static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dgate),
        L, H, scale);
  } else if (dtype == 1) {
    bwd_dq_bf16_kernel<<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(bias), g, m, ls, dl, static_cast<const bf16*>(dout),
        static_cast<bf16*>(dq), static_cast<float*>(dgate), L, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dbias is written whole (no zeroing needed) in float32.
int fddm_gated_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* bias, const void* gate, const void* mask,
                                 const void* lse, const void* delta, const void* dout,
                                 void* dk, void* dv, void* dbias, int B, int L, int H,
                                 int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if ((L + BK - 1) / BK > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + BK - 1) / BK, H);
  const float scale = 0.125f;
  const float inv_L = 1.f / (float)L;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* g = static_cast<const float*>(gate);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* db = static_cast<float*>(dbias);
  if (dtype == 0) {
    cudaError_t err = cudaFuncSetAttribute(bwd_dkv_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)DKV_F32_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    bwd_dkv_f32_kernel<<<grid, F32_THREADS, DKV_F32_SMEM_BYTES, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias), g, m, ls, dl,
        static_cast<const float*>(dout), static_cast<float*>(dk), static_cast<float*>(dv), db,
        B, L, H, scale, inv_L);
  } else if (dtype == 1) {
    bwd_dkv_bf16_kernel<<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(bias), g, m, ls, dl, static_cast<const bf16*>(dout),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), db, B, L, H, scale, inv_L);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
