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
//
// float32 (full precision: inference.py --dtype float32, the server, a
// float32 fine-tune as B3), 3xTF32 on the tensor cores:
//   * each f32 operand x is split into tf32 hi = rna(x) and lo = rna(x - hi);
//     a product is hi.hi + hi.lo + lo.hi with f32 sums (the lo.lo term is
//     below 2^-22 of it), so S = Q K^T and O = P V keep f32 accuracy; the
//     row max, the exponentials and the running sums are f32 as in bf16.
//   * tf32 wgmma (m64n64k8) reads only K-major operands: fine for K in
//     S = Q K^T, but O = P V needs V^T with keys contiguous, and TMA cannot
//     transpose.  So a block is three warpgroups: two consumers of 64 query
//     rows (Q's hi and lo as register A fragments; P's hi and lo from S's
//     accumulator) and a producer whose lane 0 of warp 8 loads K, V and the
//     bias by TMA while warps 9-11 split K in place and write V^T's hi and lo
//     with each group of 8 keys permuted (0 2 4 6 1 3 5 7), so that S's
//     accumulator is P.V's A fragment without a shuffle.  setmaxnreg gives
//     the consumers 232 registers, the producer 40.
//   * f32 doubles every tile: a stage of 64 keys holds K, K lo, V, V^T hi,
//     V^T lo (16 KB each) and the [128 queries][64 keys] bias (32 KB), 112
//     KB, so the ring has two stages (224 KB of the 227 KB a block may use),
//     one block an SM.  A stage is freed when P.V is waited for, at the end
//     of its step, so the producer always has a whole step to fill the other.
//     Rows of 32 f32 are 128 bytes: each tile is two swizzle columns, TMA
//     boxes 32 wide.  Bias rows TMA cannot address (L % 4 != 0) are written
//     by the split warps elementwise.
//   * the block lists the key steps of its batch row that hold a kept key
//     and walks only those (exact: a masked key weighs 0 once a row has a
//     kept key; a row with none walks every step).
//   What bounds it at B=8, L=1024 with phase 2's ragged masks: three times
//   the products, 64.5 GFLOP on 495 TFLOP/s of dense tf32, 0.130 ms, over
//   ~201 MB of q/k/v/out and bias (0.060 ms).  The split costs shared-memory
//   bandwidth rather than tensor time: per step some 96 KB of split traffic
//   beside the 192 KB that the wgmmas read, on the same 128 bytes a clock.
// Their measured times, and the designs tried and dropped, stand in PERF.md.

#include "gated_attention.cuh"

namespace {

using namespace fddm;

// ------------------------------------------------------------------ float32
//
// 3xTF32 on wgmma (the split, the warpgroup roles and setmaxnreg: see
// gated_attention.cuh).  One warpgroup of the block prepares every key
// step's operands in shared memory while the other two run the products and
// the softmax.

constexpr int TF_BQ = 128;                 // queries per block: two warpgroups of 64 rows
constexpr int TF_STAGES = 2;
constexpr int TF_BIAS_HALF = TF_BQ * 128;  // the bias [128 queries][32 keys]
// A stage: K (TMA, then its hi in place), K lo, V as TMA lands it, V^T hi,
// V^T lo, the bias [128 queries][64 keys] as two 32-key halves.
constexpr int TF_K = 0, TF_KLO = TF_TILE, TF_V = 2 * TF_TILE, TF_VTHI = 3 * TF_TILE,
              TF_VTLO = 4 * TF_TILE, TF_BIAS = 5 * TF_TILE;
constexpr int TF_STAGE_BYTES = 5 * TF_TILE + 2 * TF_BIAS_HALF;  // 112 KB
constexpr int TF_LIST_MAX = 640;  // key steps a block lists (L <= 40960); past that it walks all
static_assert(TF_STAGE_BYTES % 1024 == 0, "stages keep the 1024-byte swizzle alignment");

// The ring, 3 x TF_STAGES mbarriers, the count (16 bytes), list (uint16) and
// flags (a byte each) of the key steps walked, and slack to align the ring.
inline size_t tf_smem_bytes(int listed_steps) {
  return (size_t)TF_STAGES * TF_STAGE_BYTES + 3 * TF_STAGES * 8 + 16 +
         (size_t)listed_steps * 3 + 1024;
}

// The producer's split warps prepare a landed stage: K's hi in place and its
// lo beside it (an elementwise map, so the swizzled layout carries over);
// V^T hi and lo from V, [64 dims][64 key positions] K-major, with the keys
// of each group of 8 stored in the order 0 2 4 6 1 3 5 7, so that P.V's A
// fragment is S's accumulator as it stands (a0..a3 = s0, s2, s1, s3: the
// thread holds keys 2t and 2t + 1 of a group, which A reads as columns t and
// t + 4); and, where TMA cannot address the bias rows (L % 4 != 0), the bias
// by elements.  `tid` 0..95, `wl` the warp 0..2.
__device__ __forceinline__ void tf_prepare(uint8_t* stage, int tid, int wl, int lane,
                                           const float* bias_q, bool bias_tma, int L, int q0,
                                           int k0) {
  tf_split_tile(stage + TF_K, TF_KLO - TF_K, tid, TF_SPLIT_THREADS);
  // a warp takes a (32 keys, 4 dims) unit: conflict-free 16-byte reads along keys,
  // and each dim's 32 keys one 128-byte row of V^T
  for (int it = wl; it < 32; it += 3) {
    const int r = (it & 1) * 32 + lane;  // key
    const int cd = it >> 1;              // dims 4 cd .. 4 cd + 3
    const float4 x = *reinterpret_cast<const float4*>(stage + TF_V + (cd >> 3) * TF_HALF +
                                                      tf_sw(r, (cd & 7) * 4));
    const int p = tf_pos(r);  // the key's position
    const int base = (p >> 5) * TF_HALF;
    const float xs[4] = {x.x, x.y, x.z, x.w};
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = base + tf_sw(4 * cd + e, p & 31);
      uint32_t hi, lo;
      tf32_split(xs[e], hi, lo);
      *reinterpret_cast<uint32_t*>(stage + TF_VTHI + off) = hi;
      *reinterpret_cast<uint32_t*>(stage + TF_VTLO + off) = lo;
    }
  }
  if (!bias_tma) {
    for (int i = tid; i < TF_BQ * BK; i += TF_SPLIT_THREADS) {
      const int r = i >> 6, c = i & 63;
      *reinterpret_cast<float*>(stage + TF_BIAS + (c >> 5) * TF_BIAS_HALF + tf_sw(r, c & 31)) =
          (q0 + r < L && k0 + c < L) ? bias_q[(size_t)r * L + k0 + c] : 0.f;
    }
  }
}

// Scores of one 64-key step in the log2 domain, in place, as fwd_scores
// below but with the f32 bias: bias_r0/r1 the thread's two bias rows in the
// stage (row % 8 = g), each key half a [128][32] swizzled block.
template <bool kFull>
__device__ __forceinline__ void tf_scores(float s[8][4], const uint8_t* bias_r0,
                                          const uint8_t* bias_r1, int g, int t, float sl2,
                                          const float gl[2], uint64_t kept, int nvalid,
                                          float rmax[2]) {
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    // key columns 8j + 2t, 8j + 2t + 1: chunk 2 (j % 4) + t / 2 of half j / 4
    const int off = (j >> 2) * TF_BIAS_HALF + ((((j & 3) * 2 + (t >> 1)) ^ g) << 4) + (t & 1) * 8;
    const float2 b0 = *reinterpret_cast<const float2*>(bias_r0 + off);
    const float2 b1 = *reinterpret_cast<const float2*>(bias_r1 + off);
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

__global__ void __launch_bounds__(TF_THREADS, 1)
gated_attention_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_bias,
                              const float* __restrict__ q, const float* __restrict__ bias,
                              const float* __restrict__ gate, const uint8_t* __restrict__ mask,
                              float* __restrict__ out, float* __restrict__ lse, int L, int H,
                              float scale, int bias_tma) {
  extern __shared__ uint8_t tf_smem_raw[];
  uint8_t* smem = tf_smem_raw + ((1024 - (smem_addr(tf_smem_raw) & 1023)) & 1023);
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + TF_STAGES * TF_STAGE_BYTES);
  uint64_t* ready = landed + TF_STAGES;  // landed: the TMA bytes; ready: split warps done
  uint64_t* empty = ready + TF_STAGES;   // empty: the consumer warps are done with it
  int* nlive_s = reinterpret_cast<int*>(empty + TF_STAGES);
  uint16_t* live = reinterpret_cast<uint16_t*>(nlive_s + 4);  // the key steps walked, in order

  const int b = blockIdx.x;  // batch fastest: bias tiles reused from L2
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * TF_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t HD = (size_t)H * DH;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * L;
  const int nsteps = (L + BK - 1) / BK;
  const bool listed = mask_b != nullptr && nsteps <= TF_LIST_MAX;

  if (threadIdx.x == 0) {
    for (int st = 0; st < TF_STAGES; ++st) {
      mbar_init(&landed[st], 1);                // the loader's arrive + the bytes
      mbar_init(&ready[st], TF_SPLIT_THREADS);  // every split thread
      mbar_init(&empty[st], TF_CONSUMER_WARPS);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (listed) {
    // The key steps of this batch row that hold a kept key.  A masked key
    // weighs exactly 0 once the row has a kept key, so skipping the others
    // is exact; a row with none walks every step.
    list_live_tiles<TF_THREADS>(mask_b, L, nsteps, reinterpret_cast<uint8_t*>(live + nsteps),
                                live, nlive_s);
  }
  __syncthreads();
  const int nlive = listed ? *nlive_s : 0;
  const bool use_list = nlive > 0;
  const int nvisit = use_list ? nlive : nsteps;

  if (warp >= TF_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TF_PRODUCER_REGS));
    if (warp == TF_CONSUMER_WARPS) {
      // one lane loads: K and V [64 keys][64 dims] and the bias [128 queries]
      // [64 keys] of a step, each as two 32-column halves (a 128-byte
      // swizzled box is 32 f32 wide), a stage as soon as the consumers free it
      if (lane == 0) {
        for (int i = 0; i < nvisit; ++i) {
          const int st = i % TF_STAGES;
          if (i >= TF_STAGES) mbar_wait(&empty[st], (i / TF_STAGES - 1) & 1);
          uint8_t* stage = smem + st * TF_STAGE_BYTES;
          const int k0 = (use_list ? live[i] : i) * BK;
          mbar_arrive_expect_tx(&landed[st], bias_tma ? 2 * TF_TILE + 2 * TF_BIAS_HALF
                                                      : 2 * TF_TILE);
          #pragma unroll
          for (int a = 0; a < 2; ++a) {
            tma_load_3d(stage + TF_K + a * TF_HALF, &tm_k, &landed[st], h * DH + 32 * a, k0, b);
            tma_load_3d(stage + TF_V + a * TF_HALF, &tm_v, &landed[st], h * DH + 32 * a, k0, b);
            if (bias_tma)
              tma_load_3d(stage + TF_BIAS + a * TF_BIAS_HALF, &tm_bias, &landed[st],
                          k0 + 32 * a, q0, h);
          }
        }
      }
    } else {
      const int wl = warp - TF_CONSUMER_WARPS - 1;
      const int tid = wl * 32 + lane;
      const float* bias_q = bias + ((size_t)h * L + q0) * L;
      for (int i = 0; i < nvisit; ++i) {
        const int st = i % TF_STAGES;
        mbar_wait(&landed[st], (i / TF_STAGES) & 1);
        tf_prepare(smem + st * TF_STAGE_BYTES, tid, wl, lane, bias_q, bias_tma, L, q0,
                   (use_list ? live[i] : i) * BK);
        // the generic stores above are read by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&ready[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TF_CONSUMER_REGS));
  const int g = lane >> 2, t = lane & 3;  // fragment row group / column
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // the thread's two rows in the block
  const int r0 = q0 + lr0, r1 = q0 + lr1;

  // Q as tf32 hi and lo A fragments, 8 slices of 8 head dims, kept in registers
  uint32_t qh[8][4], ql[8][4];
  {
    const float* q0p = q + ((size_t)b * L + r0) * HD + h * DH;
    const float* q1p = q + ((size_t)b * L + r1) * HD + h * DH;
    #pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int c = 8 * ks + t;
      tf32_split(r0 < L ? q0p[c] : 0.f, qh[ks][0], ql[ks][0]);
      tf32_split(r1 < L ? q1p[c] : 0.f, qh[ks][1], ql[ks][1]);
      tf32_split(r0 < L ? q0p[c + 4] : 0.f, qh[ks][2], ql[ks][2]);
      tf32_split(r1 < L ? q1p[c + 4] : 0.f, qh[ks][3], ql[ks][3]);
    }
  }
  // log2 domain: exp(x) = 2^(x log2 e), so scale and gates carry log2 e
  const float sl2 = scale * LOG2E;
  const float gl[2] = {r0 < L ? gate[((size_t)b * H + h) * L + r0] * LOG2E : 0.f,
                       r1 < L ? gate[((size_t)b * H + h) * L + r1] * LOG2E : 0.f};

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // running max (log2 units) and sum
  float o[8][4];   // O: 8 tiles of 8 head dims, accumulator layout
  float pv[8][4];  // a step's P V, the same layout
  float s[8][4];   // S, then P: 8 tiles of 8 keys
  #pragma unroll
  for (int n = 0; n < 8; ++n)
    #pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = pv[n][e] = s[n][e] = 0.f;

  for (int i = 0; i < nvisit; ++i) {
    const int st = i % TF_STAGES;
    const uint8_t* stage = smem + st * TF_STAGE_BYTES;
    const int k0 = (use_list ? live[i] : i) * BK;
    // keep flags of the step's 64 keys (read before the product, used after)
    const bool keep_lo = k0 + lane < L && (mask_b == nullptr || mask_b[k0 + lane]);
    const bool keep_hi = k0 + 32 + lane < L && (mask_b == nullptr || mask_b[k0 + 32 + lane]);

    mbar_wait(&landed[st], (i / TF_STAGES) & 1);
    mbar_wait(&ready[st], (i / TF_STAGES) & 1);
    // S = Q K^T in 3xTF32; K [key][d] is K-major
    const uint64_t dkh = sw128_desc(stage + TF_K, 16), dkl = sw128_desc(stage + TF_KLO, 16);
    reg_fence(s);
    wgmma_fence();
    #pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      wgmma_m64n64k8_tf32(s, ql[ks], dkh + tf_slice(ks), ks > 0);
      wgmma_m64n64k8_tf32(s, qh[ks], dkl + tf_slice(ks), 1);
      wgmma_m64n64k8_tf32(s, qh[ks], dkh + tf_slice(ks), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    const uint32_t lo = __ballot_sync(0xffffffffu, keep_lo);
    const uint32_t hi = __ballot_sync(0xffffffffu, keep_hi);
    float rmax[2] = {-INFINITY, -INFINITY};
    const uint8_t* bias_r0 = stage + TF_BIAS + lr0 * 128;
    const uint8_t* bias_r1 = stage + TF_BIAS + lr1 * 128;
    if ((lo & hi) == 0xffffffffu) {  // every key kept (and so below L)
      tf_scores<true>(s, bias_r0, bias_r1, g, t, sl2, gl, 0, BK, rmax);
    } else {
      const uint64_t kept = ((uint64_t)hi << 32 | lo) >> (2 * t);
      tf_scores<false>(s, bias_r0, bias_r1, g, t, sl2, gl, kept, L - k0, rmax);
    }
    // the 4 threads of a row group hold one row between them
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
    }
    // m starts at NEG, not -inf, so the first correction 2^(NEG - m_new) is
    // exactly 0 (or 1 while every key so far is masked) and never NaN
    float m_new[2], corr[2], rsum[2] = {0.f, 0.f};
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], rmax[r]);
      corr[r] = ex2(m[r] - m_new[r]);
      m[r] = m_new[r];
    }
    // P, and its hi and lo as P.V's A fragments (see tf_prepare for the order)
    uint32_t ph[8][4], pl[8][4];
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - m_new[e >> 1]);  // 2^-inf = 0 past L
        rsum[e >> 1] += s[j][e];
      }
      tf_fragments(s[j], ph[j], pl[j]);
    }
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l[r] = l[r] * corr[r] + rsum[r];
    }

    // P V of this step in 3xTF32 (V^T [d][key position] is K-major), in an
    // accumulator of its own: the tensor cores' f32 sums truncate, so a sum
    // carried over every step would lose more the longer L (5e-5 at L =
    // 4224 on an H100); O takes each step's sum by a rounded f32 FMA.
    const uint64_t dvh = sw128_desc(stage + TF_VTHI, 16), dvl = sw128_desc(stage + TF_VTLO, 16);
    reg_fence(pv);
    wgmma_fence();
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      wgmma_m64n64k8_tf32(pv, pl[j], dvh + tf_slice(j), j > 0);
      wgmma_m64n64k8_tf32(pv, ph[j], dvl + tf_slice(j), 1);
      wgmma_m64n64k8_tf32(pv, ph[j], dvh + tf_slice(j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(pv);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    #pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] = fmaf(o[n][0], corr[0], pv[n][0]);
      o[n][1] = fmaf(o[n][1], corr[0], pv[n][1]);
      o[n][2] = fmaf(o[n][2], corr[1], pv[n][2]);
      o[n][3] = fmaf(o[n][3], corr[1], pv[n][3]);
    }
  }

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  if (lse != nullptr && t == 0) {  // the 4 threads of a row group hold the same m, l
    // natural-log units; exactly NEG at a row whose keys are all masked
    float* lse_bh = lse + ((size_t)b * H + h) * L;
    if (r0 < L) lse_bh[r0] = m[0] == NEG ? NEG : fmaf(m[0], LN2, logf(fmaxf(l[0], 1e-30f)));
    if (r1 < L) lse_bh[r1] = m[1] == NEG ? NEG : fmaf(m[1], LN2, logf(fmaxf(l[1], 1e-30f)));
  }
  #pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = h * DH + n * 8 + 2 * t;
    if (r0 < L)
      *reinterpret_cast<float2*>(out + ((size_t)b * L + r0) * HD + c) =
          make_float2(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < L)
      *reinterpret_cast<float2*>(out + ((size_t)b * L + r1) * HD + c) =
          make_float2(o[n][2] * inv1, o[n][3] * inv1);
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
  const float scale = 0.125f;  // 1 / sqrt(64)
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == 0) {
    // K and V as [B][L][H*64] f32, the bias as [H][L][L], in 32-column
    // boxes; the bias only when its rows are 16-byte aligned (L % 4 == 0)
    CUtensorMap tm_k, tm_v, tm_bias = {};
    const uint64_t HD = (uint64_t)H * DH;
    const bool bias_tma = (L & 3) == 0;
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (!encode_3d(&tm_k, k, HD, L, B, HD * 4, 32, BK, f32) ||
        !encode_3d(&tm_v, v, HD, L, B, HD * 4, 32, BK, f32) ||
        (bias_tma && !encode_3d(&tm_bias, bias, L, L, H, (uint64_t)L * 4, 32, TF_BQ, f32)))
      return (int)cudaErrorInvalidValue;
    static bool checked = false;  // the register count, once a process
    cudaError_t err = tf_check_regs(gated_attention_tf32x3_kernel,
                                    "gated_attention_tf32x3_kernel", &checked);
    if (err != cudaSuccess) return (int)err;
    const int nsteps = (L + BK - 1) / BK;
    const size_t smem = tf_smem_bytes(m != nullptr && nsteps <= TF_LIST_MAX ? nsteps : 0);
    err = cudaFuncSetAttribute(gated_attention_tf32x3_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 tf_grid(B, H, (L + TF_BQ - 1) / TF_BQ);
    gated_attention_tf32x3_kernel<<<tf_grid, TF_THREADS, smem, s>>>(
        tm_k, tm_v, tm_bias, static_cast<const float*>(q), static_cast<const float*>(bias),
        static_cast<const float*>(gate), m, static_cast<float*>(out), static_cast<float*>(lse),
        L, H, scale, bias_tma);
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
