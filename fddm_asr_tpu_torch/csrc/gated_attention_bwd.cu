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
//   * `_kernel_packed_bwd_dkv`  -> kernel B, which for bfloat16 is two
//     kernels launched back to back by one call:
//       (a) dK, dV: one block per (128-key tile, head, batch row) that walks
//           the query tiles and writes each dK/dV element once;
//       (b) dbias: one block per (64-key tile, 128-query tile, head) whose
//           innermost loop is the batch; it recomputes S and dP for each
//           batch row and sums dS * gate in f32 registers, then writes each
//           dbias element once.
//     (float32: one kernel per (64-key tile, head) walking batch rows and
//     query tiles, which reads, adds to and writes back its f32 dbias
//     columns in device memory for each (batch row, query tile).)
//
// The TPU kernel B accumulates dbias across the batch in an output block
// that stays resident over an innermost sequential batch grid axis.  Hopper
// blocks run in no order, so that does not carry over; (b) takes the batch
// into the block instead.  No two blocks write one element and every sum
// runs in a fixed order: no atomics, and the outputs are the same bit for
// bit from run to run.
//
// Masking, to be the exact gradient of the port's forward (which scores
// masked keys f32-min and excludes keys past L):
//   * masked keys get dS = 0 (their score is a constant), and P = 0 --
//     except at a row whose keys are all masked, where the forward averages
//     v over the L real keys: there lse = f32-min, so exp(f32-min - lse) = 1
//     and P = 1/L (the `inv_L` factor) feeds dV;
//   * keys past L and query rows past L get P = dS = 0 (or, in kernel B's
//     bf16 kernels, a finite value that meets a zero row of dO and Q or a
//     gate of 0, or lands in a row that is never stored).
// (The TPU kernels differ at all-masked rows: their P there is 1, not 1/Lk,
// and dS is not zeroed.)
//
// Numerics: S is recomputed with the forward's own arithmetic (the f32
// product scaled, then the gated bias added), so P <= 1 up to rounding.
//   * bfloat16 (the training path): on the tensor cores, bf16 in and f32
//     accumulate (kernel A: four warps of 16 rows on mma.sync m16n8k16;
//     kernel B: wgmma).  dS and P are rounded to bf16 as the A operands of
//     the second products, as the TPU kernels round them; delta, dgate and
//     dbias stay f32.
//   * float32: exact f32 FMAs, 256 threads of 4x4 register micro-tiles.
//
// What bounds it, at the fine-tune shape (B=32, L=1024, H=16, bf16, 999 of
// 1024 keys kept): kernel A moves ~380 MB (0.11 ms) and does 6*64 flops per
// (query, kept key) pair and head, ~0.20 ms of tensor-core time; kernel B
// must do 8*64 (q.k, dO.v, P^T.dO, dS^T.q), ~0.27 ms, and move ~510 MB (0.15
// ms; the 64 MB f32 dbias written once).  B's design adds 4*64 flops a pair
// in (b), which recomputes S and dP (the least time of (a) + (b) ~0.41 ms),
// and trades for it the ~4 GB of f32 dbias traffic a launch of a design that
// sums dbias in device memory.  Besides the products, each of (a) and (b)
// takes one exponential and some five to ten FP32 instructions per (batch
// row, query, key): 0.5 G of each, near 0.15 ms on the SFU alone.  Both also
// stream their tiles from L2 again and again (about 2 GB each a launch).
//
// bfloat16 kernel B, what each part of the design is for:
//   * (a): two warpgroups of 64 keys, one block an SM (222 registers).  The
//     warp's K and V rows stay in registers as wgmma A operands; Q, dO, the
//     bias [64 queries][128 keys] and lse/delta/gate of each 64-query step
//     come by TMA into a four-stage full/empty mbarrier ring, issued by one
//     thread of warp 0 two steps ahead.  All four products on wgmma
//     m64n64k16 with A from registers, run transposed so that the
//     accumulators are rows of keys: S^T = K Q^T and dP^T = V dO^T, then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T packed to bf16 from the
//     accumulators.  A step is four commit groups: P^T is computed while
//     dP^T runs and dS^T while dV runs; dK is waited for at the next step's
//     S^T.  The bias is read transposed (ldmatrix.trans of the [query][key]
//     tile gives it in the S^T accumulator layout).
//   * (b): four warpgroups of 64 queries x 64 keys, one block of 128 x 128
//     an SM (the larger tile reads a third fewer bytes from L2 than 128 x
//     64).  Per batch row Q, dO, K and V [128 rows][64], the 128 queries'
//     lse/delta/gate and the 128 keys' mask bytes come by TMA into a
//     two-stage ring; a warp frees a stage as soon as its two products are
//     done.  The block's bias tile is loaded once.  The grid runs heads
//     slowest, so the blocks in flight share a head's tiles in L2.  Where
//     every key of a warpgroup is kept, the update is branch-free: P (dP
//     gate - delta gate), with the constants folded into FMAs.
//   * every tile has 128-byte rows under the 128-byte swizzle (what TMA
//     writes and wgmma's descriptors read); rows that TMA cannot address
//     (not 16-byte aligned: the bias and the f32 rows where L % 8 != 0, and
//     in (b) also where L % 16 != 0) are loaded elementwise by warp 0's
//     lanes or by each thread.
// Measured times stand in PERF.md.

#include "gated_attention.cuh"
#include "tile_ops.cuh"

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

// ---------------------------------------------------- bfloat16 kernel B (B5)
// Two kernels, launched back to back by one call: (a) dK and dV, (b) dbias.

constexpr int TILE_BYTES = 64 * DH * 2;  // a [64 rows][64] bf16 tile: 8 KB, 128-byte rows
constexpr int DKV_KEYS = 128;            // keys of a block of (a): two warpgroups of 64
constexpr int DKV_THREADS = 256;
constexpr int DKV_STAGES = 4;
// a stage is freed one step after it is read (dV/dK are waited for at the
// next step), so warp 0 loads DKV_STAGES - 2 steps ahead
constexpr int DKV_AHEAD = DKV_STAGES - 2;
// (a)'s shared memory: the ring, a stage holding Q and dO [64 queries][64]
// and the bias [2][64 queries][64 keys]; lse, delta and gate of each stage's
// 64 queries (f32); the mbarriers
constexpr int DKV_STAGE_BYTES = 4 * TILE_BYTES;
constexpr int DKV_VEC = 3 * BQ;
constexpr size_t DKV_SMEM_BYTES =
    DKV_STAGES * (DKV_STAGE_BYTES + DKV_VEC * 4) + 2 * DKV_STAGES * 8 + 1024;
constexpr int DB_TILE = 128;  // (b): 128 queries x 128 keys a block, four warpgroups of 64 x 64
constexpr int DB_THREADS = 512;
constexpr int DB_STAGES = 2;
// (b)'s shared memory: the ring, a stage holding Q, dO, K and V, each [128
// rows][64] as two 64-row tiles; the block's bias as [2 key halves][128
// queries][64 keys]; per stage lse, delta and gate of the 128 queries (f32)
// and the mask bytes of the 128 keys; the mbarriers.
constexpr int DB_STAGE_BYTES = 8 * TILE_BYTES;
constexpr int DB_ROWS_BYTES = 3 * DB_TILE * 4 + DB_TILE;
constexpr size_t DB_SMEM_BYTES = DB_STAGES * (DB_STAGE_BYTES + DB_ROWS_BYTES) + 4 * TILE_BYTES +
                                 (2 * DB_STAGES + 1) * 8 + 1024;

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// The 64 x 64 tiles of the bias [q0.., k0..] into swizzled shared memory (one
// per 64 rows of `rows`, one per 64 keys of `halves`), elementwise by the
// warp's lanes: for bias rows that TMA cannot address (L % 8 != 0).
__device__ __forceinline__ void bias_tiles_by_lanes(bf16* dst, const bf16* bias_h, int L, int q0,
                                                    int k0, int rows, int halves, int lane) {
  for (int i = lane; i < rows * halves * 64; i += 32) {
    const int tile = i >> 12, r = (i >> 6) & 63, c = i & 63;
    const int qi = q0 + (tile % (rows / 64)) * 64 + r, kj = k0 + (tile / (rows / 64)) * 64 + c;
    dst[tile * 64 * DH + sw128(r, c >> 3) + (c & 7)] =
        qi < L && kj < L ? bias_h[(size_t)qi * L + kj] : __float2bfloat16(0.f);
  }
}

struct DkvMaps {  // (a)'s tensor maps; bias and the f32 rows only when L % 8 == 0
  CUtensorMap q, dout, bias, lse, delta, gate;
};

// (a): warp 0 fills the ring stage of query step j: Q and dO rows q0..q0+63
// of (b, h), the bias [q0.., k0..k0+127] as two [64 x 64] tiles, and lse,
// delta, gate of the 64 queries; by TMA (one lane), or, where the rows of the
// bias and of the f32 vectors are not 16-byte aligned, those elementwise by
// the warp's lanes.  Zeros past L; a bias tile wholly past L is skipped (its
// keys are never used).
__device__ __forceinline__ void dkv_produce(uint8_t* stage, float* vec, uint64_t* full, int j,
                                            const DkvMaps& tm, bool tma_rows,
                                            const bf16* bias_h, const float* lse_bh,
                                            const float* delta_bh, const float* gate_bh, int L,
                                            int k0, int h, int b, int H, int lane) {
  const int q0 = j * BQ;
  bf16* Bs = reinterpret_cast<bf16*>(stage + 2 * TILE_BYTES);
  const bool second = k0 + 64 < L;  // the second bias tile has keys below L
  if (!tma_rows) {
    bias_tiles_by_lanes(Bs, bias_h, L, q0, k0, 64, 2, lane);
    for (int i = lane; i < DKV_VEC; i += 32) {
      const int which = i >> 6, r = i & 63;
      const float* src = which == 0 ? lse_bh : which == 1 ? delta_bh : gate_bh;
      vec[i] = q0 + r < L ? src[q0 + r] : 0.f;
    }
    __syncwarp();  // the lanes' stores precede lane 0's arrive (a release)
  }
  if (lane == 0) {
    const uint32_t bytes = 2 * TILE_BYTES +
                           (tma_rows ? (second ? 2 : 1) * TILE_BYTES + DKV_VEC * 4 : 0);
    mbar_arrive_expect_tx(full, bytes);
    tma_load_3d(stage, &tm.q, full, h * DH, q0, b);
    tma_load_3d(stage + TILE_BYTES, &tm.dout, full, h * DH, q0, b);
    if (tma_rows) {
      tma_load_3d(Bs, &tm.bias, full, k0, q0, h);
      if (second) tma_load_3d(Bs + 64 * DH, &tm.bias, full, k0 + 64, q0, h);
      tma_load_2d(vec, &tm.lse, full, q0, b * H + h);
      tma_load_2d(vec + BQ, &tm.delta, full, q0, b * H + h);
      tma_load_2d(vec + 2 * BQ, &tm.gate, full, q0, b * H + h);
    }
  }
}

// (a) dK and dV: one block per (128-key tile, head, batch row), each
// warpgroup 64 keys whose K and V rows stay in registers as wgmma A operands.
// Products run transposed (rows = keys, columns = the step's 64 queries),
// all four on wgmma with A from registers: S^T = K Q^T and dP^T = V dO^T (Q
// and dO K-major), dV += P^T dO and dK += dS^T Q (dO and Q MN-major).  A step
// runs in four commit groups so that P is computed while dP^T runs and dS
// while dV runs; dK, and the last dV, are waited for at the next step's S^T,
// and the step's stage freed then.
__global__ void __launch_bounds__(DKV_THREADS, 1)
bwd_dkv_bf16_kernel(const __grid_constant__ DkvMaps tm, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ bias,
                    const float* __restrict__ gate, const uint8_t* __restrict__ mask,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H, float scale,
                    float inv_L, int tma_rows) {
  extern __shared__ uint8_t dkv_smem_raw[];
  uint8_t* smem = align1024(dkv_smem_raw);
  float* vecs = reinterpret_cast<float*>(smem + DKV_STAGES * DKV_STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(vecs + DKV_STAGES * DKV_VEC);
  uint64_t* empty = full + DKV_STAGES;  // full[s]: the step's tiles landed; empty[s]: all read

  const int k0 = blockIdx.x * DKV_KEYS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const size_t HD = (size_t)H * DH;
  const int lk0 = warp * 16 + g, lk1 = lk0 + 8;  // the thread's two keys in the block
  const int kr0 = k0 + lk0, kr1 = k0 + lk1;
  const bf16* bias_h = bias + (size_t)h * L * L;
  const size_t bh = ((size_t)b * H + h) * L;
  const int nsteps = (L + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int st = 0; st < DKV_STAGES; ++st) {
      mbar_init(&full[st], 1);                  // the producer's arrive + the bytes
      mbar_init(&empty[st], DKV_THREADS / 32);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int jn = 0; jn < DKV_AHEAD && jn < nsteps; ++jn)
      dkv_produce(smem + jn * DKV_STAGE_BYTES, vecs + jn * DKV_VEC, &full[jn], jn, tm, tma_rows,
                  bias_h, lse + bh, delta + bh, gate + bh, L, k0, h, b, H, lane);
  // the warp's 16 keys of K and V as A fragments (zero past L)
  uint32_t ka[4][4], va[4][4];
  load_a_fragments(ka, k + ((size_t)b * L + kr0) * HD + h * DH,
                   k + ((size_t)b * L + kr1) * HD + h * DH, kr0 < L, kr1 < L, t);
  load_a_fragments(va, v + ((size_t)b * L + kr0) * HD + h * DH,
                   v + ((size_t)b * L + kr1) * HD + h * DH, kr0 < L, kr1 < L, t);
  const float keep_r[2] = {keep_flag(mask, b, kr0, L), keep_flag(mask, b, kr1, L)};
  const float sl2 = scale * LOG2E;
  float gk[8][4], gv[8][4];  // dK, dV: 8 tiles of 8 head dims, accumulator layout
  float s[8][4], dp[8][4];   // S^T then P^T, dP^T then dS^T: 8 tiles of 8 queries
  #pragma unroll
  for (int n = 0; n < 8; ++n)
    #pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = s[n][e] = dp[n][e] = 0.f;
  // ldmatrix.trans of the bias [query][key] gives it in the S^T accumulator
  // layout: matrix m = lane / 8 covers queries 8 (m / 2) + 0..7 of a 16-query
  // pair of tiles and the key chunk of lk0 (m even) or lk1 (m odd)
  const int bias_chunk = (warp & 3) * 2 + ((lane >> 3) & 1);
  const int bias_row = ((lane >> 4) & 1) * 8 + (lane & 7);

  for (int j = 0; j < nsteps; ++j) {
    // warp 0 loads step j + DKV_AHEAD into the stage that step j - 2 used,
    // once every warp has released it (a warp releases step j - 2 during
    // step j - 1)
    if (warp == 0 && j + DKV_AHEAD < nsteps) {
      const int jn = j + DKV_AHEAD;
      if (jn >= DKV_STAGES) mbar_wait(&empty[jn % DKV_STAGES], (jn / DKV_STAGES - 1) & 1);
      dkv_produce(smem + (jn % DKV_STAGES) * DKV_STAGE_BYTES, vecs + (jn % DKV_STAGES) * DKV_VEC,
                  &full[jn % DKV_STAGES], jn, tm, tma_rows, bias_h, lse + bh, delta + bh,
                  gate + bh, L, k0, h, b, H, lane);
    }
    const uint8_t* stage = smem + (j % DKV_STAGES) * DKV_STAGE_BYTES;
    const bf16* Qs = reinterpret_cast<const bf16*>(stage);
    const bf16* Ds = Qs + 64 * DH;
    const bf16* Bt = Ds + 64 * DH + wg * 64 * DH;  // this warpgroup's 64-key bias tile
    const float* vec = vecs + (j % DKV_STAGES) * DKV_VEC;
    mbar_wait(&full[j % DKV_STAGES], (j / DKV_STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, two groups; Q and dO [query][d] are
    // K-major B operands, 16 head dims = 32 bytes along each row
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
    #pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n64k16_rs<0>(s, ka[ks], sw128_desc(Qs, 16) + 2 * ks, ks > 0);
    wgmma_commit();
    #pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n64k16_rs<0>(dp, va[ks], sw128_desc(Ds, 16) + 2 * ks, ks > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T, and the last step's dV and dK
    reg_fence(s);
    reg_fence(gv);
    reg_fence(gk);
    if (j > 0) {  // this warp is done with step j - 1's stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(j - 1) % DKV_STAGES]);
    }

    // P^T (key lk0: e = 0, 1; lk1: e = 2, 3; query 8jj + 2t + (e & 1)) in
    // place, in the log2 domain: P = 2^(S scale log2e + gate log2e bias - lse
    // log2e); 0 at masked keys and keys past L, 1/L at an all-masked row
    #pragma unroll
    for (int pr = 0; pr < 4; ++pr) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, Bt + sw128(16 * pr + bias_row, bias_chunk));
      #pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jj = 2 * pr + half;
        const int c = jj * 8 + 2 * t;
        const float2 ls = *reinterpret_cast<const float2*>(vec + c);
        const float2 ga = *reinterpret_cast<const float2*>(vec + 2 * BQ + c);
        const float2 b0 = unpack_bf16(bb[2 * half]), b1 = unpack_bf16(bb[2 * half + 1]);
        const float bv[4] = {b0.x, b0.y, b1.x, b1.y};
        const float gl[2] = {ga.x * LOG2E, ga.y * LOG2E};
        const float ll[2] = {ls.x * LOG2E, ls.y * LOG2E};
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kp = keep_r[e >> 1];
          float p = ex2(fmaf(s[jj][e], sl2, fmaf(gl[e & 1], bv[e], -ll[e & 1])));
          if (kp <= 0.f)  // a masked key, or one past L
            p = kp == 0.f && (e & 1 ? ls.y : ls.x) == NEG ? inv_L : 0.f;
          s[jj][e] = p;
        }
      }
    }
    // dV += P^T dO: P^T, rounded to bf16, is the A operand, 16 queries a
    // k-slice; dO [query][d] is MN-major, 16 queries = 2048 bytes
    uint32_t pa[4][4];
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    reg_fence(gv);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs<1>(gv, pa[kk], sw128_desc(Ds, 1024) + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T
    reg_fence(dp);

    // dS^T = P^T (dP^T - delta) at kept keys, in place; then dK += dS^T Q
    #pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 de = *reinterpret_cast<const float2*>(vec + BQ + jj * 8 + 2 * t);
      #pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[jj][e] = keep_r[e >> 1] > 0.f ? s[jj][e] * (dp[jj][e] - (e & 1 ? de.y : de.x)) : 0.f;
    }
    uint32_t sa[4][4];
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sa[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      sa[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      sa[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      sa[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    reg_fence(gk);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs<1>(gk, sa[kk], sw128_desc(Qs, 1024) + 128 * kk, 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(gv);
  reg_fence(gk);

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

struct DbiasMaps {  // (b)'s tensor maps; bias, rows and mask only when L % 16 == 0
  CUtensorMap q, dout, k, v, bias, lse, delta, gate, mask;
};

// (b): one lane fills the ring stage of batch row b: Q and dO rows
// q0..q0+127 and K and V rows k0..k0+127 of (b, h), as 64-row tiles, and,
// with `rows`, lse, delta and gate of the 128 queries and the mask bytes of
// the 128 keys, by TMA (a tile wholly past L is skipped: its rows are never
// stored); zeros past L.
__device__ __forceinline__ void dbias_produce(uint8_t* stage, float* vec, uint64_t* full, int b,
                                              const DbiasMaps& tm, bool rows, bool mask_rows,
                                              int L, int q0, int k0, int h, int H) {
  const int qtiles = q0 + 64 < L ? 2 : 1, ktiles = k0 + 64 < L ? 2 : 1;
  mbar_arrive_expect_tx(full, 2 * (qtiles + ktiles) * TILE_BYTES +
                                  (rows ? 3 * qtiles * 64 * 4 : 0) + (mask_rows ? DB_TILE : 0));
  for (int i = 0; i < qtiles; ++i) {
    tma_load_3d(stage + i * TILE_BYTES, &tm.q, full, h * DH, q0 + 64 * i, b);
    tma_load_3d(stage + (2 + i) * TILE_BYTES, &tm.dout, full, h * DH, q0 + 64 * i, b);
    if (rows) {
      tma_load_2d(vec + 64 * i, &tm.lse, full, q0 + 64 * i, b * H + h);
      tma_load_2d(vec + DB_TILE + 64 * i, &tm.delta, full, q0 + 64 * i, b * H + h);
      tma_load_2d(vec + 2 * DB_TILE + 64 * i, &tm.gate, full, q0 + 64 * i, b * H + h);
    }
  }
  for (int i = 0; i < ktiles; ++i) {
    tma_load_3d(stage + (4 + i) * TILE_BYTES, &tm.k, full, h * DH, k0 + 64 * i, b);
    tma_load_3d(stage + (6 + i) * TILE_BYTES, &tm.v, full, h * DH, k0 + 64 * i, b);
  }
  if (mask_rows) tma_load_2d(vec + 3 * DB_TILE, &tm.mask, full, k0, b);
}

// (b) dbias = sum_b dS * gate: one block per (128-key tile, 128-query tile,
// head), each warpgroup 64 queries x 64 keys; the batch is the block's loop,
// S = Q K^T and dP = dO V^T are recomputed on wgmma for each batch row (all
// four operands K-major in shared memory, which a warp frees as soon as its
// products are done), and the sum stays in registers (f32) until each
// element is written once.  Where L % 16 == 0 the per-query values and the
// mask come through the ring too; otherwise each thread loads its own.
__global__ void __launch_bounds__(DB_THREADS, 1)
bwd_dbias_bf16_kernel(const __grid_constant__ DbiasMaps tm, const bf16* __restrict__ bias,
                      const float* __restrict__ gate, const uint8_t* __restrict__ mask,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dbias, int B, int L, int H, float scale, int rows) {
  extern __shared__ uint8_t db_smem_raw[];
  uint8_t* smem = align1024(db_smem_raw);
  bf16* Bt = reinterpret_cast<bf16*>(smem + DB_STAGES * DB_STAGE_BYTES);
  float* vecs = reinterpret_cast<float*>(Bt + 2 * DB_TILE * DH);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(vecs) +
                                               DB_STAGES * DB_ROWS_BYTES);
  uint64_t* empty = full + DB_STAGES;
  uint64_t* bias_full = empty + DB_STAGES;

  const int k0 = blockIdx.x * DB_TILE;
  const int q0 = blockIdx.y * DB_TILE;
  const int h = blockIdx.z;  // slowest: the blocks running together share a head's tiles in L2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int qh = wg & 1, kh = wg >> 1;  // the warpgroup's 64 queries and 64 keys
  const int lr0 = qh * 64 + (warp & 3) * 16 + g;  // the thread's two queries in the block
  const int r0 = q0 + lr0, r1 = r0 + 8;
  const int kw = k0 + kh * 64;  // the warpgroup's first key
  const bool mask_rows = rows && mask != nullptr;
  constexpr int VEC_FLOATS = DB_ROWS_BYTES / 4;

  if (threadIdx.x == 0) {
    for (int st = 0; st < DB_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], DB_THREADS / 32);
    }
    mbar_init(bias_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    // the block's bias, the same for every batch row: [128 queries][128 keys]
    if (rows) {
      if (lane == 0) {
        const int qtiles = q0 + 64 < L ? 2 : 1, ktiles = k0 + 64 < L ? 2 : 1;
        mbar_arrive_expect_tx(bias_full, qtiles * ktiles * TILE_BYTES);
        for (int j = 0; j < ktiles; ++j)
          for (int i = 0; i < qtiles; ++i)
            tma_load_3d(Bt + (2 * j + i) * 64 * DH, &tm.bias, bias_full, k0 + 64 * j,
                        q0 + 64 * i, h);
      }
    } else {
      bias_tiles_by_lanes(Bt, bias + (size_t)h * L * L, L, q0, k0, DB_TILE, 2, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(bias_full);
    }
    if (lane == 0)
      for (int bn = 0; bn < DB_STAGES - 1 && bn < B; ++bn)
        dbias_produce(smem + bn * DB_STAGE_BYTES, vecs + bn * VEC_FLOATS, &full[bn], bn, tm,
                      rows, mask_rows, L, q0, k0, h, H);
  }
  // the thread's two bias rows (their row % 8 is g): 32-bit word (jj ^ g) * 4 + t
  // holds keys 8jj + 2t, 8jj + 2t + 1
  const uint32_t* bias_r0 =
      reinterpret_cast<const uint32_t*>(Bt + kh * DB_TILE * DH) + lr0 * (DH / 2);
  const uint32_t* bias_r1 = bias_r0 + 8 * (DH / 2);
  const float sl2 = scale * LOG2E;
  float acc[8][4];  // dbias of (row r0: e = 0, 1; r1: e = 2, 3; key 8jj + 2t + (e & 1))
  float s[8][4], dp[8][4];  // S, dP
  #pragma unroll
  for (int jj = 0; jj < 8; ++jj)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[jj][e] = s[jj][e] = dp[jj][e] = 0.f;
  mbar_wait(bias_full, 0);

  for (int b = 0; b < B; ++b) {
    // warp 0 loads batch row b + DB_STAGES - 1 into the stage that row b - 1
    // used, once every warp is done with its products there
    if (warp == 0 && lane == 0 && b + DB_STAGES - 1 < B) {
      const int bn = b + DB_STAGES - 1;
      if (bn >= DB_STAGES) mbar_wait(&empty[bn % DB_STAGES], (bn / DB_STAGES - 1) & 1);
      dbias_produce(smem + (bn % DB_STAGES) * DB_STAGE_BYTES, vecs + (bn % DB_STAGES) * VEC_FLOATS,
                    &full[bn % DB_STAGES], bn, tm, rows, mask_rows, L, q0, k0, h, H);
    }
    const uint8_t* stage = smem + (b % DB_STAGES) * DB_STAGE_BYTES;
    const float* vec = vecs + (b % DB_STAGES) * VEC_FLOATS;
    const size_t bh = ((size_t)b * H + h) * L;
    const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * L;
    float ls[2], de[2], ga[2];
    bool keep_lo, keep_hi;
    if (!rows) {  // fetched before the wait
      ls[0] = r0 < L ? lse[bh + r0] : INFINITY;
      ls[1] = r1 < L ? lse[bh + r1] : INFINITY;
      de[0] = r0 < L ? delta[bh + r0] : 0.f;
      de[1] = r1 < L ? delta[bh + r1] : 0.f;
      ga[0] = r0 < L ? gate[bh + r0] : 0.f;
      ga[1] = r1 < L ? gate[bh + r1] : 0.f;
      keep_lo = kw + lane < L && (mask_b == nullptr || mask_b[kw + lane]);
      keep_hi = kw + 32 + lane < L && (mask_b == nullptr || mask_b[kw + 32 + lane]);
    }
    mbar_wait(&full[b % DB_STAGES], (b / DB_STAGES) & 1);
    if (rows) {  // from the stage; zeros past L (P there is garbage times gate 0, never stored)
      ls[0] = vec[lr0];
      ls[1] = vec[lr0 + 8];
      de[0] = vec[DB_TILE + lr0];
      de[1] = vec[DB_TILE + lr0 + 8];
      ga[0] = vec[2 * DB_TILE + lr0];
      ga[1] = vec[2 * DB_TILE + lr0 + 8];
      const uint8_t* mask_s = reinterpret_cast<const uint8_t*>(vec + 3 * DB_TILE) + kh * 64;
      keep_lo = kw + lane < L && (!mask_rows || mask_s[lane]);
      keep_hi = kw + 32 + lane < L && (!mask_rows || mask_s[32 + lane]);
    }
    const uint32_t lo = __ballot_sync(0xffffffffu, keep_lo);
    const uint32_t hi = __ballot_sync(0xffffffffu, keep_hi);

    // S = Q K^T, dP = dO V^T: the warpgroup's 64 rows of Q and dO against its
    // 64 keys, 16 head dims (32 bytes of each row) a slice
    {
      const uint64_t desc_q = sw128_desc(stage + qh * TILE_BYTES, 16);
      const uint64_t desc_d = sw128_desc(stage + (2 + qh) * TILE_BYTES, 16);
      const uint64_t desc_k = sw128_desc(stage + (4 + kh) * TILE_BYTES, 16);
      const uint64_t desc_v = sw128_desc(stage + (6 + kh) * TILE_BYTES, 16);
      reg_fence(s);
      reg_fence(dp);
      wgmma_fence();
      #pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_m64n64k16_ss<0>(s, desc_q + 2 * ks, desc_k + 2 * ks, ks > 0);
      #pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_m64n64k16_ss<0>(dp, desc_d + 2 * ks, desc_v + 2 * ks, ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
    }
    __syncwarp();  // this warp is done with the stage
    if (lane == 0) mbar_arrive(&empty[b % DB_STAGES]);

    // dbias += dS * gate = P (dP gate - delta gate) at kept keys, in the log2
    // domain: P = 2^(S scale log2e + gate log2e bias - lse log2e).  Rows past
    // L have gate 0 (and, loaded by the thread, lse +inf).
    const float gl[2] = {ga[0] * LOG2E, ga[1] * LOG2E};
    const float ll[2] = {ls[0] * LOG2E, ls[1] * LOG2E};
    const float dg[2] = {de[0] * ga[0], de[1] * ga[1]};
    if ((lo & hi) == 0xffffffffu) {  // every key of the warpgroup kept: no per-key test
      #pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        #pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 bv = unpack_bf16((i ? bias_r1 : bias_r0)[((jj ^ g) << 2) + t]);
          #pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * i + c;
            const float p = ex2(fmaf(s[jj][e], sl2, fmaf(gl[i], c ? bv.y : bv.x, -ll[i])));
            acc[jj][e] = fmaf(p, fmaf(dp[jj][e], ga[i], -dg[i]), acc[jj][e]);
          }
        }
      }
    } else {
      // bit 8 (jj % 4) + c of this word: key 8jj + 2t + c
      const uint32_t kept[2] = {lo >> (2 * t), hi >> (2 * t)};
      #pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        #pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 bv = unpack_bf16((i ? bias_r1 : bias_r0)[((jj ^ g) << 2) + t]);
          #pragma unroll
          for (int c = 0; c < 2; ++c) {
            if ((kept[jj >> 2] >> (8 * (jj & 3) + c)) & 1) {
              const int e = 2 * i + c;
              const float p = ex2(fmaf(s[jj][e], sl2, fmaf(gl[i], c ? bv.y : bv.x, -ll[i])));
              acc[jj][e] = fmaf(p, fmaf(dp[jj][e], ga[i], -dg[i]), acc[jj][e]);
            }
          }
        }
      }
    }
  }

  float* dbias_h = dbias + (size_t)h * L * L;
  const bool pair_ok = (L & 1) == 0;  // 8-byte aligned pairs
  #pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = kw + jj * 8 + 2 * t;
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? r1 : r0;
      if (r >= L || c >= L) continue;
      float* dst = dbias_h + (size_t)r * L + c;
      if (pair_ok) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[jj][2 * i], acc[jj][2 * i + 1]);
      } else {
        dst[0] = acc[jj][2 * i];
        if (c + 1 < L) dst[1] = acc[jj][2 * i + 1];
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
    if ((L + DKV_KEYS - 1) / DKV_KEYS > 65535 || B > 65535)
      return (int)cudaErrorInvalidConfiguration;
    // q, k, v, dout as [B][L][H*64] in 64-row tiles; the bias [H][L][L] in
    // 64 x 64 tiles, lse, delta, gate as [B*H][L] rows of 64 and the mask as
    // [B][L] rows of 128 bytes where their rows are 16-byte aligned: L % 8 ==
    // 0 for (a), L % 16 == 0 for (b) (the kernels load them elementwise
    // otherwise)
    const uint64_t HD = (uint64_t)H * DH;
    const bool tma_rows = (L & 7) == 0, rows16 = (L & 15) == 0;
    DkvMaps ma = {};
    DbiasMaps mb = {};
    bool ok = encode_3d(&ma.q, q, HD, L, B, HD * 2, DH, 64) &&
              encode_3d(&ma.dout, dout, HD, L, B, HD * 2, DH, 64) &&
              encode_3d(&mb.k, k, HD, L, B, HD * 2, DH, 64) &&
              encode_3d(&mb.v, v, HD, L, B, HD * 2, DH, 64);
    if (ok && tma_rows)
      ok = encode_3d(&ma.bias, bias, L, L, H, (uint64_t)L * 2, 64, 64) &&
           encode_rows(&ma.lse, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lse, L, (uint64_t)B * H, BQ) &&
           encode_rows(&ma.delta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, delta, L, (uint64_t)B * H, BQ) &&
           encode_rows(&ma.gate, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, gate, L, (uint64_t)B * H, BQ);
    if (ok && rows16 && mask != nullptr)
      ok = encode_rows(&mb.mask, CU_TENSOR_MAP_DATA_TYPE_UINT8, mask, L, B, DB_TILE);
    if (!ok) return (int)cudaErrorInvalidValue;
    mb.q = ma.q;
    mb.dout = ma.dout;
    mb.bias = ma.bias;
    mb.lse = ma.lse;
    mb.delta = ma.delta;
    mb.gate = ma.gate;
    cudaError_t err = cudaFuncSetAttribute(bwd_dkv_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)DKV_SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dbias_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DB_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_a((L + DKV_KEYS - 1) / DKV_KEYS, H, B);
    bwd_dkv_bf16_kernel<<<grid_a, DKV_THREADS, DKV_SMEM_BYTES, s>>>(
        ma, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(bias), g, m, ls, dl, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), L, H, scale, inv_L, tma_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_b((L + DB_TILE - 1) / DB_TILE, (L + DB_TILE - 1) / DB_TILE, H);
    bwd_dbias_bf16_kernel<<<grid_b, DB_THREADS, DB_SMEM_BYTES, s>>>(
        mb, static_cast<const bf16*>(bias), g, m, ls, dl, db, B, L, H, scale, rows16);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
