// WavLM gated relative-position-bias attention for Hopper (sm_90a).
//
//   out[b, q, h*64:(h+1)*64] = softmax_k(q.k / sqrt(64) + gate[b,h,q] * bias[h,q,k],
//                                        masked keys -> f32-min) . v
//
// Replaces four TPU kernels of fddm_asr_tpu/ops/flash_attention.py:
//   * `_kernel_packed`          (:164, resident K, dispatched for L <= 4096),
//   * `_kernel_packed_flash`    (:255, k-blocked running softmax, L > 4096),
//   * `_kernel_packed_fwd_lse`  (:412, the training forward: the same output
//                                plus the row logsumexp the backward needs),
//   * `_kernel`                 (:80, per head on [B, H, L, dh]; reached here
//                                through a view of [B, L, H, dh] operands).
// One online-softmax (k-looped) design covers every L; given an `lse`
// pointer it also writes lse[b, h, q] = m + log(l) (f32, natural log) from
// the running max and sum it holds at the end of the key loop.  It loops
// over exactly the L real keys; at a row whose keys are all masked it
// therefore averages v over the L real keys, as the XLA reference
// `wavlm_gated_attention_xla` does (the TPU kernels average over their
// 128-padded key count instead), and its lse is exactly f32-min there
// (gated_attention_bwd.cu relies on that).
//
// Layout: q/k/v/out are head-packed [B, L, H*64] (the projections' natural
// output), bias is the shared [H, L, L] position bias, gate [B, H, L] f32,
// mask [B, L] uint8 (1 = keep) or null.  bias has q's dtype.  Scores,
// running max/sum and the accumulator are f32; P is rounded to v's dtype
// before P.V, as on the TPU.  Keys past L score -inf (excluded); masked keys
// score f32-min (kept, at equal weight when a whole row is masked).
//
// What bounds it, at the main-path shape (B=8, L=1024, H=16, bf16): one call
// moves ~101 MB (q/k/v/out, the bias read once), 0.030 ms at 3.35 TB/s, and
// does ~34 GFLOP of products, 0.035 ms at 989 TFLOP/s.  The softmax has
// floors of its own on the same scale: 134 M exponentials at the SFU's 16 a
// clock per SM (~0.03 ms), and some eight FP32/ALU instructions per score.
// And from L2 a block streams its (b, h)'s whole K and V and its 128 bias
// rows: 32 KB a 64-key step, ~537 MB a call.
//
// bfloat16 (the main path), what each part of the design is for:
//   * a block owns 128 queries of one (b, h): two warpgroups of 64 rows, two
//     blocks an SM.  128 rows rather than 64 halve the K/V traffic per query;
//     the grid is batch-fastest (gridDim.x = B), so the B blocks that read
//     one bias tile run together and B-1 of them find it in L2.
//   * a three-stage ring in dynamic shared memory: K and V [64 keys][64]
//     and the bias [128 queries][64 keys] arrive by TMA (3-d tensor maps,
//     zero past L), issued by one thread of warp 0 one step ahead, each
//     stage with a full and an empty mbarrier instead of a block barrier, so
//     the warps and the two blocks drift apart and one's softmax overlaps
//     another's products.  Bias rows that are not 16-byte aligned (L % 8 !=
//     0) are not addressable by TMA; warp 0 then loads the bias elementwise.
//   * every tile has 128-byte rows under the 128-byte swizzle: what wgmma's
//     descriptors read, and the bias, read in the accumulator layout, is
//     read without bank conflicts.
//   * both products on wgmma m64n64k16 with A from registers: Q stays in
//     registers; S's accumulator, packed to bf16, is P.V's A operand; K
//     (K-major) and V (MN-major, the transpose bit) come from the ring.  P.V
//     is waited for at the next step's S, so it overlaps the loop's top.
//   * the softmax runs in the log2 domain: scale and gates carry log2 e, so
//     each score is one FFMA and each exponential one ex2.approx.  Keep flags
//     come from a ballot over the mask bytes; a step whose keys are all kept
//     skips the masking.
//   * float32: exact f32, so no tensor cores: 64-query blocks of 256
//     threads, each a 4x4 register micro-tile of scalar FMAs, synchronous
//     loads.
// Their measured times, and the designs tried and dropped, stand in PERF.md.

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

constexpr int FWD_BQ = 128;                 // queries per block: 8 warps x 16 rows
constexpr int FWD_THREADS = 256;            // two warpgroups of 64 rows
constexpr int FWD_STAGES = 3;               // ring depth
constexpr int KV_TILE_BYTES = BK * DH * 2;  // K or V tile [64 keys][64 dims]
constexpr int BIAS_TILE_BYTES = FWD_BQ * BK * 2;  // bias tile [128 queries][64 keys]
constexpr int FWD_STAGE_BYTES = 2 * KV_TILE_BYTES + BIAS_TILE_BYTES;
// the ring, its 2 x FWD_STAGES mbarriers, and slack to align the ring to 1024 bytes
constexpr size_t FWD_SMEM_BYTES = FWD_STAGES * FWD_STAGE_BYTES + 2 * FWD_STAGES * 8 + 1024;
static_assert(FWD_STAGE_BYTES % 1024 == 0, "stages keep the 1024-byte swizzle alignment");
// Warp 0 fills the ring stage of key step `step`: K and V [64 keys][64 dims]
// by TMA, the bias [128 queries][64 keys] by TMA too or, when its rows are
// not 16-byte aligned (L % 8 != 0, which TMA cannot address), elementwise by
// the warp's 32 lanes.  Rows and keys past L arrive as zeros.
__device__ __forceinline__ void fwd_produce(uint8_t* stage, uint64_t* full, int step,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            const CUtensorMap* tm_bias, bool bias_tma,
                                            const bf16* bias_q, int L, int q0, int h, int b,
                                            int lane) {
  if (!bias_tma) {
    bf16* Bs = reinterpret_cast<bf16*>(stage + 2 * KV_TILE_BYTES);
    const int k0 = step * BK;
    for (int i = lane; i < FWD_BQ * BK; i += 32) {
      const int r = i >> 6, c = i & 63;
      Bs[sw128(r, c >> 3) + (c & 7)] = (q0 + r < L && k0 + c < L)
                                           ? bias_q[(size_t)r * L + k0 + c]
                                           : __float2bfloat16(0.f);
    }
    __syncwarp();  // the lanes' stores precede lane 0's arrive (a release)
  }
  if (lane == 0) {
    mbar_arrive_expect_tx(full, bias_tma ? FWD_STAGE_BYTES : 2 * KV_TILE_BYTES);
    tma_load_3d(stage, tm_k, full, h * DH, step * BK, b);
    tma_load_3d(stage + KV_TILE_BYTES, tm_v, full, h * DH, step * BK, b);
    if (bias_tma) tma_load_3d(stage + 2 * KV_TILE_BYTES, tm_bias, full, step * BK, q0, h);
  }
}

// Scores of one 64-key step in the log2 domain, in place:
//   s = acc * scale*log2e + gate*log2e * bias,  masked keys NEG, keys past L -inf
// bias_r0/r1: the thread's two bias rows (swizzled, their row % 8 is g);
// kept: the thread's keep bits, bit 8j + e for key column 8j + 2t + e;
// nvalid: keys of the step below L.  Accumulates the thread's row maxima.
template <bool kFull>
__device__ __forceinline__ void fwd_scores(float s[8][4], const uint32_t* bias_r0,
                                           const uint32_t* bias_r1, int g, int t, float sl2,
                                           const float gl[2], uint64_t kept, int nvalid,
                                           float rmax[2]) {
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int w = ((j ^ g) << 2) + t;  // 32-bit word of key columns 8j + 2t, 8j + 2t + 1
    const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias_r0 + w));
    const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias_r1 + w));
    const float bv[4] = {b0.x, b0.y, b1.x, b1.y};
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sv = fmaf(s[j][e], sl2, gl[e >> 1] * bv[e]);
      if (!kFull) {
        const bool keep = (kept >> (8 * j + (e & 1))) & 1;
        sv = keep ? sv : (8 * j + 2 * t + (e & 1) < nvalid ? NEG : -INFINITY);
      }
      s[j][e] = sv;
      rmax[e >> 1] = fmaxf(rmax[e >> 1], sv);
    }
  }
}

__global__ void __launch_bounds__(FWD_THREADS, 2)
gated_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_bias,
                            const bf16* __restrict__ q, const bf16* __restrict__ bias,
                            const float* __restrict__ gate, const uint8_t* __restrict__ mask,
                            bf16* __restrict__ out, float* __restrict__ lse, int L, int H,
                            float scale, int bias_tma) {
  extern __shared__ uint8_t fwd_smem_raw[];
  uint8_t* smem = fwd_smem_raw + ((1024 - (smem_addr(fwd_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + FWD_STAGES * FWD_STAGE_BYTES);
  uint64_t* empty = full + FWD_STAGES;  // full[s]: step's tiles landed; empty[s]: all read

  const int b = blockIdx.x;        // batch fastest: bias tiles reused from L2
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * FWD_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group / column pair
  const size_t HD = (size_t)H * DH;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // the thread's two rows in the block
  const int r0 = q0 + lr0, r1 = q0 + lr1;
  const bf16* bias_q = bias + (size_t)h * L * L + (size_t)q0 * L;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * L;
  const int nsteps = (L + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < FWD_STAGES; ++st) {
      mbar_init(&full[st], 1);                   // the producer's arrive + the bytes
      mbar_init(&empty[st], FWD_THREADS / 32);   // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    fwd_produce(smem, &full[0], 0, &tm_k, &tm_v, &tm_bias, bias_tma, bias_q, L, q0, h, b, lane);

  // Q as A fragments, 4 slices of 16 head dims, kept in registers
  uint32_t qa[4][4];
  load_a_fragments(qa, q + ((size_t)b * L + r0) * HD + h * DH,
                   q + ((size_t)b * L + r1) * HD + h * DH, r0 < L, r1 < L, t);
  // log2 domain: exp(x) = 2^(x log2 e), so scale and gates carry log2 e
  const float sl2 = scale * LOG2E;
  const float gl[2] = {r0 < L ? gate[((size_t)b * H + h) * L + r0] * LOG2E : 0.f,
                       r1 < L ? gate[((size_t)b * H + h) * L + r1] * LOG2E : 0.f};

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // running max (log2 units) and sum
  float o[8][4];  // O: 8 tiles of 8 head dims, accumulator layout
  float s[8][4];  // S, then P: 8 tiles of 8 keys
  #pragma unroll
  for (int n = 0; n < 8; ++n)
    #pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = s[n][e] = 0.f;

  for (int j = 0; j < nsteps; ++j) {
    // warp 0 loads step j + 1 into the stage that step j - 2 used, once
    // every warp has released it (a warp releases step j - 2 during step j - 1)
    if (warp == 0 && j + 1 < nsteps) {
      const int jn = j + 1;
      if (jn >= FWD_STAGES) mbar_wait(&empty[jn % FWD_STAGES], (jn / FWD_STAGES - 1) & 1);
      fwd_produce(smem + (jn % FWD_STAGES) * FWD_STAGE_BYTES, &full[jn % FWD_STAGES], jn,
                  &tm_k, &tm_v, &tm_bias, bias_tma, bias_q, L, q0, h, b, lane);
    }
    const uint8_t* stage = smem + (j % FWD_STAGES) * FWD_STAGE_BYTES;
    const uint32_t* Bs32 = reinterpret_cast<const uint32_t*>(stage + 2 * KV_TILE_BYTES);
    const int k0 = j * BK;
    // keep flags of the step's 64 keys (read before the product, used after)
    const bool keep_lo = k0 + lane < L && (mask_b == nullptr || mask_b[k0 + lane]);
    const bool keep_hi = k0 + 32 + lane < L && (mask_b == nullptr || mask_b[k0 + 32 + lane]);

    mbar_wait(&full[j % FWD_STAGES], (j / FWD_STAGES) & 1);
    // S = Q K^T; K [key][d] is K-major, 16 head dims = 32 bytes along each row
    const uint64_t dk = sw128_desc(stage, 16);
    reg_fence(s);
    wgmma_fence();
    #pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_m64n64k16_rs<0>(s, qa[ks], dk + 2 * ks, ks > 0);
    wgmma_commit();
    wgmma_wait<0>();  // this S, and P.V of step j - 1
    reg_fence(s);
    reg_fence(o);
    if (j > 0) {  // this warp is done with step j - 1's tiles
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(j - 1) % FWD_STAGES]);
    }

    const uint32_t lo = __ballot_sync(0xffffffffu, keep_lo);
    const uint32_t hi = __ballot_sync(0xffffffffu, keep_hi);
    float rmax[2] = {-INFINITY, -INFINITY};
    const uint32_t* bias_r0 = Bs32 + lr0 * (DH / 2);
    const uint32_t* bias_r1 = Bs32 + lr1 * (DH / 2);
    if ((lo & hi) == 0xffffffffu) {  // every key kept (and so below L)
      fwd_scores<true>(s, bias_r0, bias_r1, g, t, sl2, gl, 0, BK, rmax);
    } else {
      const uint64_t kept = ((uint64_t)hi << 32 | lo) >> (2 * t);
      fwd_scores<false>(s, bias_r0, bias_r1, g, t, sl2, gl, kept, L - k0, rmax);
    }
    // the 4 threads of a row group hold one row between them
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 1));
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 2));
    }
    // m starts at NEG, not -inf, so the first correction 2^(NEG - m_new) is
    // exactly 0 (or 1 while every key so far is masked) and never NaN
    float m_new[2], corr[2], rsum[2] = {0.f, 0.f};
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m[i], rmax[i]);
      corr[i] = ex2(m[i] - m_new[i]);
      m[i] = m_new[i];
    }
    #pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[jj][e] = ex2(s[jj][e] - m_new[e >> 1]);  // 2^-inf = 0 past L
        rsum[e >> 1] += s[jj][e];
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

    // O += P V, P rounded to bf16: the S accumulator of 16 keys, packed, is
    // the A operand of that slice of P.V.  V [key][d] is MN-major; 16 keys =
    // two 8-row groups = 2048 bytes.  Waited for at the next step's S.
    uint32_t pa[4][4];
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    const uint64_t dv = sw128_desc(stage + KV_TILE_BYTES, 1024);
    reg_fence(o);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(o, pa[kk], dv + 128 * kk, 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(o);

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  if (lse != nullptr && t == 0) {  // the 4 threads of a row group hold the same m, l
    // natural-log units; exactly NEG at a row whose keys are all masked
    // (NEG * ln 2 would not be, and the backward relies on it)
    float* lse_bh = lse + ((size_t)b * H + h) * L;
    if (r0 < L) lse_bh[r0] = m[0] == NEG ? NEG : fmaf(m[0], LN2, logf(fmaxf(l[0], 1e-30f)));
    if (r1 < L) lse_bh[r1] = m[1] == NEG ? NEG : fmaf(m[1], LN2, logf(fmaxf(l[1], 1e-30f)));
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
    // K and V as [B][L][H*64], the bias as [H][L][L]; the bias only when its
    // rows are 16-byte aligned (the kernel loads it elementwise otherwise)
    CUtensorMap tm_k, tm_v, tm_bias = {};
    const uint64_t HD = (uint64_t)H * DH;
    const bool bias_tma = (L & 7) == 0;
    if (!encode_3d(&tm_k, k, HD, L, B, HD * 2, DH, BK) ||
        !encode_3d(&tm_v, v, HD, L, B, HD * 2, DH, BK) ||
        (bias_tma && !encode_3d(&tm_bias, bias, L, L, H, (uint64_t)L * 2, BK, FWD_BQ)))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(gated_attention_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)FWD_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 bf16_grid(B, H, (L + FWD_BQ - 1) / FWD_BQ);
    gated_attention_bf16_kernel<<<bf16_grid, FWD_THREADS, FWD_SMEM_BYTES, s>>>(
        tm_k, tm_v, tm_bias, static_cast<const bf16*>(q), static_cast<const bf16*>(bias),
        static_cast<const float*>(gate), m, static_cast<bf16*>(out), static_cast<float*>(lse),
        L, H, scale, bias_tma);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
