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
//   * `_kernel_packed_bwd_dq`   -> kernel A, one block per (batch row,
//     head, 128-query tile) that walks the keys, as the forward does, only
//     the 64-key tiles holding a kept key (bfloat16: 64 keys a step;
//     float32, 3xTF32: 32);
//   * `_kernel_packed_bwd_dkv`  -> kernel B, two kernels launched back to
//     back by one call:
//       (a) dK, dV: one block per (key tile, head, batch row) that walks
//           the query tiles and writes each dK/dV element once;
//       (b) dbias: one block per (key tile, query tile, head) whose
//           innermost loop is the batch; it recomputes S and dP for each
//           batch row and sums dS * gate in f32 registers, then writes each
//           dbias element once.
//     (bfloat16: 128-key tiles in (a), 128 x 128 in (b); float32, 3xTF32:
//     64-key tiles and 32-query steps in (a), 64 x 64 in (b).)
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
//   * keys past L and query rows past L get P = dS = 0 (or, in the bf16
//     kernels, a finite value that meets a zero row of dO and Q or a gate of
//     0, or lands in a row that is never stored).
// (The TPU kernels differ at all-masked rows: their P there is 1, not 1/Lk,
// and dS is not zeroed.)
//
// Numerics: S is recomputed with the forward's own arithmetic (the f32
// product scaled, then the gated bias added), so P <= 1 up to rounding.
//   * bfloat16 (the training path): on the tensor cores (wgmma), bf16 in
//     and f32 accumulate.  dS and P are rounded to bf16 as the A operands of
//     the second products, as the TPU kernels round them; delta, dgate and
//     dbias stay f32.
//   * float32: kernels A and B in 3xTF32 on the tensor cores (each
//     operand split into tf32 hi and lo, each product hi.hi + hi.lo + lo.hi
//     with f32 sums; P, dS, delta and the gate f32), their designs below the
//     bfloat16 kernels.  Kernel A is bound by its tensor work: 3 x 6 x 64
//     flops per kept (query, key) pair and head on 495 TFLOP/s of tf32.
//
// What bounds it, at the fine-tune shape (B=32, L=1024, H=16, bf16, 999 of
// 1024 keys kept): kernel A moves ~380 MB (0.11 ms) and does 6*64 flops per
// (query, kept key) pair and head, ~0.20 ms of tensor-core time, beside one
// exponential and some eight FP32 instructions per (batch row, query, key)
// (0.5 G of each: ~0.13 ms on the SFU alone); kernel B
// must do 8*64 (q.k, dO.v, P^T.dO, dS^T.q), ~0.27 ms, and move ~510 MB (0.15
// ms; the 64 MB f32 dbias written once).  B's design adds 4*64 flops a pair
// in (b), which recomputes S and dP (the least time of (a) + (b) ~0.41 ms),
// and trades for it the ~4 GB of f32 dbias traffic a launch of a design that
// sums dbias in device memory.  Besides the products, each of (a) and (b)
// takes one exponential and some five to ten FP32 instructions per (batch
// row, query, key): 0.5 G of each, near 0.15 ms on the SFU alone.  Both also
// stream their tiles from L2 again and again (about 2 GB each a launch).
//
// bfloat16 kernel A, what each part of the design is for:
//   * two warpgroups of 64 queries, one block an SM (Q, dO, S, dP, dQ and
//     the packed dS live in registers at once).  128-query blocks rather
//     than 64 halve the K and V bytes streamed from L2 per query; the grid is
//     batch-fastest, so the B blocks that read one bias tile run together.
//   * K, V [64 keys][64] and the bias [128 queries][64 keys] of each key
//     tile, and its 64 mask bytes, come by TMA into a four-stage full/empty
//     mbarrier ring, issued by one thread of warp 0 two tiles ahead: no
//     block barrier in the loop, so the two warpgroups drift apart and one's
//     softmax overlaps the other's products.
//   * all three products on wgmma m64n64k16 with A from registers (Q, dO,
//     then dS packed from S's accumulator); K is read K-major for S and
//     MN-major (the descriptor's transpose bit) for dQ, with no ldmatrix.
//     A tile is three commit groups: P is computed while dP runs, and dQ is
//     waited for at the next tile's S.  The tile's bias words are read from
//     shared memory once and kept in registers for the dS pass.
//   * the softmax arithmetic in the log2 domain: scale, gate and lse carry
//     log2 e, so each P is two FMAs and one ex2.approx.  A tile whose keys
//     are all kept takes a path without per-key tests; the others select,
//     and a tile with no kept key is not visited at all (the block lists its
//     batch row's live tiles first), which is exact since dS = 0 there.
//   * dgate sums in f32 registers per row and across the quad by shuffles;
//     each dQ and dgate element is written once by one block.
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
//
// In A and B every tile has 128-byte rows under the 128-byte swizzle (what
// TMA writes and wgmma's descriptors read); rows that TMA cannot address
// (not 16-byte aligned: the bias and (a)'s f32 rows where L % 8 != 0, A's
// mask row and (b)'s rows where L % 16 != 0) are loaded elementwise by warp
// 0's lanes or by each thread.
// Measured times stand in PERF.md.

#include "gated_attention.cuh"
#include "tile_ops.cuh"

namespace {

using namespace fddm;

// ---------------------------------------------------------------- bfloat16
// Shared by the bf16 kernels A and B.

constexpr int TILE_BYTES = 64 * DH * 2;  // a [64 rows][64] bf16 tile: 8 KB, 128-byte rows

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

// ---------------------------------------------------- bfloat16 kernel A (B4)

constexpr int DQ_BQ = 128;  // queries of a block: two warpgroups of 64
constexpr int DQ_THREADS = 256;
constexpr int DQ_STAGES = 4;
// a stage is freed one step after it is read (dQ += dS K is waited for at
// the next step), so warp 0 loads DQ_STAGES - 2 steps ahead
constexpr int DQ_AHEAD = DQ_STAGES - 2;
// a stage: K and V [64 keys][64] and the bias [128 queries][64 keys]
constexpr int DQ_STAGE_BYTES = 2 * TILE_BYTES + DQ_BQ * BK * 2;
constexpr int DQ_MASK_SLOT = 128;  // a stage's 64 mask bytes, in 128-byte aligned slots
static_assert(DQ_STAGE_BYTES % 1024 == 0, "stages keep the 1024-byte swizzle alignment");

// A block's dynamic shared memory: the ring, the mask slots, the 2 x
// DQ_STAGES mbarriers, the count (16 bytes) and list (uint16) of the key
// tiles it walks, a flag byte per key tile, and slack to align the ring to
// 1024 bytes.
inline size_t dq_smem_bytes(int nsteps) {
  return (size_t)DQ_STAGES * (DQ_STAGE_BYTES + DQ_MASK_SLOT) + 2 * DQ_STAGES * 8 + 16 +
         (size_t)nsteps * 3 + 1024;
}

struct DqMaps {  // kernel A's tensor maps; bias only when L % 8 == 0, mask when L % 16 == 0
  CUtensorMap k, v, bias, mask;
};

// Warp 0 fills the ring stage of key tile `tile`: K and V [64 keys][64 dims]
// of (b, h) and the bias [128 queries][64 keys] by TMA, and the tile's 64
// mask bytes into `mslot` by TMA too; where the bias rows or the mask row are
// not 16-byte aligned (L % 8 != 0, L % 16 != 0), those elementwise by the
// warp's lanes.  Zeros past L, so a key past L reads as masked.
__device__ __forceinline__ void dq_produce(uint8_t* stage, uint8_t* mslot, uint64_t* full,
                                           int tile, const DqMaps& tm, bool bias_tma,
                                           bool mask_tma, const bf16* bias_h,
                                           const uint8_t* mask_b, int L, int q0, int h, int b,
                                           int lane) {
  const int k0 = tile * BK;
  const bool mask_lanes = mask_b != nullptr && !mask_tma;
  if (!bias_tma || mask_lanes) {
    if (!bias_tma)
      bias_tiles_by_lanes(reinterpret_cast<bf16*>(stage + 2 * TILE_BYTES), bias_h, L, q0, k0,
                          DQ_BQ, 1, lane);
    if (mask_lanes)
      for (int c = lane; c < BK; c += 32) mslot[c] = k0 + c < L ? mask_b[k0 + c] : 0;
    __syncwarp();  // the lanes' stores precede lane 0's arrive (a release)
  }
  if (lane == 0) {
    mbar_arrive_expect_tx(full, 2 * TILE_BYTES + (bias_tma ? DQ_BQ * BK * 2 : 0) +
                                    (mask_tma ? BK : 0));
    tma_load_3d(stage, &tm.k, full, h * DH, k0, b);
    tma_load_3d(stage + TILE_BYTES, &tm.v, full, h * DH, k0, b);
    if (bias_tma) tma_load_3d(stage + 2 * TILE_BYTES, &tm.bias, full, k0, q0, h);
    if (mask_tma) tma_load_2d(mslot, &tm.mask, full, k0, b);
  }
}

// P of one key tile in the log2 domain, in place over S's accumulator:
//   P = 2^(s scale log2e + gate log2e bias - lse log2e)
// bias_r0/r1: the thread's two bias rows (swizzled; their row % 8 is g); bw
// keeps the thread's bias words for the dS pass (bw[j][i]: row i, key
// columns 8j + 2t, 8j + 2t + 1).  Without kFull, keys whose bit of `kept`
// is clear (bit 8j + e for key column 8j + 2t + e) get P = 0 by a select: a
// multiply by the flag would give inf * 0 = NaN at a row whose keys are all
// masked (lse = f32-min).
template <bool kFull>
__device__ __forceinline__ void dq_probs(float s[8][4], const uint32_t* bias_r0,
                                         const uint32_t* bias_r1, uint32_t bw[8][2], int g,
                                         int t, float sl2, const float gl[2], const float nll[2],
                                         uint64_t kept) {
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int w = ((j ^ g) << 2) + t;  // 32-bit word of key columns 8j + 2t, 8j + 2t + 1
    bw[j][0] = bias_r0[w];
    bw[j][1] = bias_r1[w];
    const float2 b0 = unpack_bf16(bw[j][0]), b1 = unpack_bf16(bw[j][1]);
    const float bv[4] = {b0.x, b0.y, b1.x, b1.y};
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[j][e], sl2, fmaf(gl[e >> 1], bv[e], nll[e >> 1])));
      s[j][e] = (kFull || ((kept >> (8 * j + (e & 1))) & 1)) ? p : 0.f;
    }
  }
}

// Kernel A, dQ and dgate: one block per (batch row, head, 128-query tile),
// each warpgroup 64 queries whose Q and dO rows stay in registers as wgmma A
// operands, walking the key tiles of its batch row that hold a kept key.
// Three products a tile, all on wgmma with A from registers: S = Q K^T and
// dP = dO V^T (K and V K-major), then dQ += dS K (K MN-major, the transpose
// bit) with dS packed to bf16 from the accumulator.  P is computed while dP
// runs; dQ is waited for at the next tile's S, and the tile's stage freed
// then.
__global__ void __launch_bounds__(DQ_THREADS, 1)
bwd_dq_bf16_kernel(const __grid_constant__ DqMaps tm, const bf16* __restrict__ q,
                   const bf16* __restrict__ bias, const float* __restrict__ gate,
                   const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                   const float* __restrict__ delta, const bf16* __restrict__ dout,
                   bf16* __restrict__ dq, float* __restrict__ dgate, int L, int H, float scale,
                   int bias_tma, int mask_tma) {
  extern __shared__ uint8_t dq_smem_raw[];
  const int nsteps = (L + BK - 1) / BK;
  uint8_t* smem = align1024(dq_smem_raw);
  uint8_t* mslots = smem + DQ_STAGES * DQ_STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(mslots + DQ_STAGES * DQ_MASK_SLOT);
  uint64_t* empty = full + DQ_STAGES;  // full[s]: the tile's loads landed; empty[s]: all read
  int* nlive_s = reinterpret_cast<int*>(empty + DQ_STAGES);
  uint16_t* live = reinterpret_cast<uint16_t*>(nlive_s + 4);  // the key tiles walked, in order
  uint8_t* any_kept = reinterpret_cast<uint8_t*>(live + nsteps);

  const int b = blockIdx.x;  // batch fastest: the blocks in flight share a head's bias tiles in L2
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * DQ_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group / column pair
  const size_t HD = (size_t)H * DH;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // the thread's two rows in the block
  const int r0 = q0 + lr0, r1 = q0 + lr1;
  const bf16* bias_h = bias + (size_t)h * L * L;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * L;

  if (threadIdx.x == 0) {
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(&full[st], 1);                 // the producer's arrive + the bytes
      mbar_init(&empty[st], DQ_THREADS / 32);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (mask_b != nullptr) {
    // the key tiles of this batch row that hold a kept key: the others are
    // skipped, which is exact (dS = 0 on all their keys)
    list_live_tiles<DQ_THREADS>(mask_b, L, nsteps, any_kept, live, nlive_s);
  }
  __syncthreads();
  const int nlive = mask_b == nullptr ? nsteps : *nlive_s;
  if (warp == 0)
    for (int jn = 0; jn < DQ_AHEAD && jn < nlive; ++jn)
      dq_produce(smem + jn * DQ_STAGE_BYTES, mslots + jn * DQ_MASK_SLOT, &full[jn],
                 mask_b == nullptr ? jn : live[jn], tm, bias_tma, mask_tma, bias_h, mask_b, L,
                 q0, h, b, lane);

  // Q and dO as A fragments, 4 slices of 16 head dims each, kept in registers
  uint32_t qa[4][4], da[4][4];
  load_a_fragments(qa, q + ((size_t)b * L + r0) * HD + h * DH,
                   q + ((size_t)b * L + r1) * HD + h * DH, r0 < L, r1 < L, t);
  load_a_fragments(da, dout + ((size_t)b * L + r0) * HD + h * DH,
                   dout + ((size_t)b * L + r1) * HD + h * DH, r0 < L, r1 < L, t);
  // per row, log2 e folded in: gate log2e, -lse log2e; and delta.  Rows past
  // L: zeros, so P = 1 meets dP = delta = 0 there (and is never stored).
  const size_t bh = ((size_t)b * H + h) * L;
  const float sl2 = scale * LOG2E;
  float gl[2], nll[2], de[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r1 : r0;
    gl[i] = r < L ? gate[bh + r] * LOG2E : 0.f;
    nll[i] = r < L ? -lse[bh + r] * LOG2E : 0.f;
    de[i] = r < L ? delta[bh + r] : 0.f;
  }

  float acc[8][4];          // dQ: 8 tiles of 8 head dims, accumulator layout
  float s[8][4], dp[8][4];  // S, then P, then dS; dP: 8 tiles of 8 keys
  #pragma unroll
  for (int n = 0; n < 8; ++n)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = s[n][e] = dp[n][e] = 0.f;
  float dg[2] = {0.f, 0.f};  // dgate of rows r0, r1 (this thread's key columns)

  for (int it = 0; it < nlive; ++it) {
    // warp 0 loads step it + DQ_AHEAD into the stage that step it - 2 used,
    // once every warp has released it (a warp releases step it - 2 during
    // step it - 1)
    if (warp == 0 && it + DQ_AHEAD < nlive) {
      const int jn = it + DQ_AHEAD;
      if (jn >= DQ_STAGES) mbar_wait(&empty[jn % DQ_STAGES], (jn / DQ_STAGES - 1) & 1);
      dq_produce(smem + (jn % DQ_STAGES) * DQ_STAGE_BYTES, mslots + (jn % DQ_STAGES) * DQ_MASK_SLOT,
                 &full[jn % DQ_STAGES], mask_b == nullptr ? jn : live[jn], tm, bias_tma, mask_tma,
                 bias_h, mask_b, L, q0, h, b, lane);
    }
    const int st = it % DQ_STAGES;
    const uint8_t* stage = smem + st * DQ_STAGE_BYTES;
    const int k0 = (mask_b == nullptr ? it : live[it]) * BK;
    mbar_wait(&full[st], (it / DQ_STAGES) & 1);

    // S = Q K^T and dP = dO V^T, two groups; K and V [key][d] are K-major
    // B operands, 16 head dims = 32 bytes along each row
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
    #pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n64k16_rs<0>(s, qa[ks], sw128_desc(stage, 16) + 2 * ks, ks > 0);
    wgmma_commit();
    #pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n64k16_rs<0>(dp, da[ks], sw128_desc(stage + TILE_BYTES, 16) + 2 * ks, ks > 0);
    wgmma_commit();
    // keep flags of the tile's 64 keys, from the stage's mask bytes
    bool keep_lo, keep_hi;
    if (mask_b == nullptr) {
      keep_lo = k0 + lane < L;
      keep_hi = k0 + 32 + lane < L;
    } else {
      const uint8_t* ms = mslots + st * DQ_MASK_SLOT;
      keep_lo = ms[lane] != 0;
      keep_hi = ms[32 + lane] != 0;
    }
    const uint32_t lo = __ballot_sync(0xffffffffu, keep_lo);
    const uint32_t hi = __ballot_sync(0xffffffffu, keep_hi);
    wgmma_wait<1>();  // S, and dQ of the previous step
    reg_fence(s);
    reg_fence(acc);
    if (it > 0) {  // this warp is done with step it - 1's stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % DQ_STAGES]);
    }

    // P in place while dP runs (rows lr0: e = 0, 1; lr1: e = 2, 3; key
    // columns 8j + 2t + (e & 1))
    const uint32_t* Bs32 = reinterpret_cast<const uint32_t*>(stage + 2 * TILE_BYTES);
    uint32_t bw[8][2];  // read once from the stage, kept for the dS pass
    if ((lo & hi) == 0xffffffffu)  // every key kept (and so below L): no per-key select
      dq_probs<true>(s, Bs32 + lr0 * (DH / 2), Bs32 + lr1 * (DH / 2), bw, g, t, sl2, gl, nll, 0);
    else
      dq_probs<false>(s, Bs32 + lr0 * (DH / 2), Bs32 + lr1 * (DH / 2), bw, g, t, sl2, gl, nll,
                      ((uint64_t)hi << 32 | lo) >> (2 * t));
    wgmma_wait<0>();  // dP
    reg_fence(dp);

    // dS = P (dP - delta) in place (0 where P is); dgate += dS bias
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b0 = unpack_bf16(bw[j][0]), b1 = unpack_bf16(bw[j][1]);
      const float bv[4] = {b0.x, b0.y, b1.x, b1.y};
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ds = s[j][e] * (dp[j][e] - de[e >> 1]);
        dg[e >> 1] = fmaf(ds, bv[e], dg[e >> 1]);
        s[j][e] = ds;
      }
    }
    // dQ += dS K: dS, rounded to bf16, is the A operand, 16 keys a k-slice;
    // K [key][d] is MN-major, 16 keys = two 8-row groups = 2048 bytes.
    // Waited for at the next step's S.
    uint32_t sa[4][4];
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      sa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      sa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    reg_fence(acc);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs<1>(acc, sa[kk], sw128_desc(stage, 1024) + 128 * kk, 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(acc);

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
    float* dg_bh = dgate + bh;
    if (r0 < L) dg_bh[r0] = dg[0];
    if (r1 < L) dg_bh[r1] = dg[1];
  }
}

// ---------------------------------------------------- bfloat16 kernel B (B5)
// Two kernels, launched back to back by one call: (a) dK and dV, (b) dbias.

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

// ------------------------------------------------------ float32 kernel B (B5)
// 3xTF32 on wgmma (the split, the warpgroup roles and setmaxnreg: see
// gated_attention.cuh), two kernels launched back to back by one call, as
// in bfloat16: (a) dK and dV, (b) dbias.  In both, consumer warpgroup w
// takes the block's steps i = w mod 2, each in a stage of its own (stage w),
// and keeps its own f32 sums; at the end consumer 1 hands its sums to
// consumer 0 through shared memory, which adds them and writes each output
// element once: a fixed order, no atomics.
//
// What bounds it, at B=8, L=1024, H=16 with ragged masks: the four products
// are 43 GFLOP over the kept (query, key) pairs, 129 GFLOP as 3xTF32, 0.26
// ms at 495 TFLOP/s of dense tf32; (b)'s recomputation of S and dP adds
// half as much again (0.39 ms in all); the bytes, q, k, v, dO, dk, dv and
// the f32 bias and dbias once each, ~330 MB, 0.10 ms.

// d[64 x 32] (+)= A[64 x 8] . B[8 x 32], tf32, both K-major from descriptors.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float d[4][4], uint64_t desc_a,
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 32] (+)= a[64 x 8] (registers, tf32; the fragment of
// wgmma_m64n64k8_tf32) . B[8 x 32] (descriptor, K-major tf32).
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float d[4][4], const uint32_t a[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void reg_fence_n32(float d[4][4]) {
  #pragma unroll
  for (int j = 0; j < 4; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// The consumer warps' end: consumer 1 stores its sums (n floats a thread)
// into `xfer`, consumer 0 waits for them (a named barrier of the 256
// consumer threads) and adds them to its own.  Returns false in consumer 1.
template <int N>
__device__ __forceinline__ bool tf_combine(float* sums, float* xfer, int w, int tw) {
  if (w == 1) {
    #pragma unroll
    for (int i = 0; i < N; ++i) xfer[i * 128 + tw] = sums[i];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(TF_CONSUMER_WARPS * 32) : "memory");
  if (w == 1) return false;
  #pragma unroll
  for (int i = 0; i < N; ++i) sums[i] += xfer[i * 128 + tw];
  return true;
}

// ---- (a) dK, dV
//
// One block per (64-key tile, head, batch row): the grid grows with the
// batch.  K and V of the tile stay in shared memory for the block (hi and
// lo, the A operands of the first two products); the block walks the
// queries in steps of 32.  Four products a step, transposed so that the
// accumulators are rows of keys: S^T = K Q^T and dP^T = V dO^T (Q and dO as
// stored, K-major along the head dim: m64n32k8 with both operands in shared
// memory), then dV += P^T dO and dK += dS^T Q with P^T and dS^T split from
// the accumulators into register A fragments (m64n64k8); their B operands
// must be K-major along the queries, which tf32 wgmma cannot read by a
// transpose bit, so the producer's split warps write each step's dO^T and
// Q^T, hi and lo, with the queries of each group of 8 permuted (tf_pos).
// Each step's dV and dK products go to an accumulator of their own, added
// to the running sums by f32 adds: the tensor cores' f32 sums truncate, so
// one carried over every step would lose more the longer L.
//
// Shared memory: the resident K, K lo, V, V lo (64 KB), and two stages of
// 73 KB, each Q and dO [32 queries][64 dims] (TMA, split in place) and their
// lo, Q^T and dO^T hi and lo [64 dims][32 query positions], the bias [32
// queries][64 keys] (TMA, or elementwise where its rows are not 16-byte
// aligned, L % 4 != 0), lse, delta and gate of the 32 queries: 210 KB, one
// block an SM.  32-query steps, because a 64-query stage (145 KB) would
// leave room for one.  Registers: dK and dV 64 a thread, S^T and dP^T 32,
// the step's accumulator 32 and its A fragments 32.  Per step, shared
// memory carries ~190 KB of wgmma operand reads (the first two products
// read K and V from it at m64n32) and ~80 KB of the split's traffic, some
// 2100 clocks at 128 bytes a clock, beside 72 tf32 wgmma instructions'
// 1536 tensor clocks: what bounds it is shared memory bandwidth, with both
// consumers' steps in turn on the tensor cores.
//
// A tile of 64 keys with no kept key in a row that keeps some has dK = dV =
// 0 and writes zeros without a product.  An all-masked row takes the full
// path, with P = 1/L on every key below L and dS = 0.

constexpr int KV_TF_BQ = 32;                    // queries a step
constexpr int KV_TF_QHALF = KV_TF_BQ * 128;     // [32 queries][32 f32]: 4 KB
// the resident tiles, each [64 keys][64 dims] as two 8 KB halves
constexpr int KV_TF_K = 0, KV_TF_KLO = TF_TILE, KV_TF_V = 2 * TF_TILE, KV_TF_VLO = 3 * TF_TILE;
constexpr int KV_TF_RESIDENT = 4 * TF_TILE;     // 64 KB
// a stage: Q and dO as two 4 KB halves each (hi in place) and their lo; Q^T
// and dO^T hi and lo, 8 KB each; the bias as two 4 KB halves; the vectors
constexpr int KS_Q = 0, KS_DO = 16384, KS_QT = 32768, KS_DOT = 49152, KS_BIAS = 65536,
              KS_VEC = 73728;
constexpr int KS_LO = 8192;                      // a tile's lo, after its hi
constexpr int KV_TF_STAGE = KS_VEC + 1024;       // 73 KB
constexpr size_t KV_TF_SMEM = KV_TF_RESIDENT + 2 * KV_TF_STAGE + 8 * 8 + 1024;
static_assert(KV_TF_STAGE % 1024 == 0, "stages keep the 1024-byte swizzle alignment");

struct KvTfMaps {  // (a)'s tensor maps; the bias only when L % 4 == 0
  CUtensorMap k, v, q, dout, bias;
};

// Lane 0 of warp 8 loads query step i into a stage: Q and dO rows
// q0..q0+31 of (b, h) as two 32-dim halves, and where its rows are 16-byte
// aligned the bias [q0.., k0..k0+63] as two 32-key halves (a half wholly
// past L is skipped: its keys are never kept); zeros past L.
__device__ __forceinline__ void kv_tf_load(uint8_t* stage, uint64_t* landed, int i,
                                           const KvTfMaps& tm, bool bias_tma, int L, int k0,
                                           int h, int b) {
  const int q0 = i * KV_TF_BQ;
  const int bias_halves = bias_tma ? (k0 + 32 < L ? 2 : 1) : 0;
  mbar_arrive_expect_tx(landed, (4 + bias_halves) * KV_TF_QHALF);
  #pragma unroll
  for (int a = 0; a < 2; ++a) {
    tma_load_3d(stage + KS_Q + a * KV_TF_QHALF, &tm.q, landed, h * DH + 32 * a, q0, b);
    tma_load_3d(stage + KS_DO + a * KV_TF_QHALF, &tm.dout, landed, h * DH + 32 * a, q0, b);
    if (a < bias_halves)
      tma_load_3d(stage + KS_BIAS + a * KV_TF_QHALF, &tm.bias, landed, k0 + 32 * a, q0, h);
  }
}

// The split warps prepare a landed stage: Q and dO split in place (hi) and
// beside (lo), and from them Q^T and dO^T hi and lo [64 dims][32 query
// positions] (tf_pos); the bias elementwise where TMA could not load it.  A
// warp takes a unit of 32 queries x 4 dims: 16-byte reads along the
// queries, and each dim's 32 queries one 128-byte row of the transpose.
__device__ __forceinline__ void kv_tf_prepare(uint8_t* stage, int tid, int wl, int lane,
                                              const float* bias_h, bool bias_tma, int L, int q0,
                                              int k0) {
  for (int u = wl; u < 32; u += 3) {
    uint8_t* x = stage + (u < 16 ? KS_Q : KS_DO);
    uint8_t* xt = stage + (u < 16 ? KS_QT : KS_DOT);
    const int cd = u & 15;  // dims 4 cd .. 4 cd + 3
    const int off = (cd >> 3) * KV_TF_QHALF + tf_sw(lane, (cd & 7) * 4);
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    uint32_t hi[4], lo[4];
    tf32_split(v.x, hi[0], lo[0]);
    tf32_split(v.y, hi[1], lo[1]);
    tf32_split(v.z, hi[2], lo[2]);
    tf32_split(v.w, hi[3], lo[3]);
    *reinterpret_cast<uint4*>(x + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(x + KS_LO + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    const int p = tf_pos(lane);  // the query's position
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int offt = tf_sw(4 * cd + e, p);
      *reinterpret_cast<uint32_t*>(xt + offt) = hi[e];
      *reinterpret_cast<uint32_t*>(xt + KS_LO + offt) = lo[e];
    }
  }
  if (!bias_tma) {
    for (int i = tid; i < KV_TF_BQ * BK; i += TF_SPLIT_THREADS) {
      const int r = i >> 6, c = i & 63;
      *reinterpret_cast<float*>(stage + KS_BIAS + (c >> 5) * KV_TF_QHALF + tf_sw(r, c & 31)) =
          (q0 + r < L && k0 + c < L) ? bias_h[(size_t)(q0 + r) * L + k0 + c] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(TF_THREADS, 1)
bwd_dkv_tf32x3_kernel(const __grid_constant__ KvTfMaps tm, const float* __restrict__ bias,
                      const float* __restrict__ gate, const uint8_t* __restrict__ mask,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int L, int H,
                      float scale, float inv_L, int bias_tma) {
  extern __shared__ uint8_t kvtf_smem_raw[];
  uint8_t* smem = align1024(kvtf_smem_raw);
  uint8_t* stages = smem + KV_TF_RESIDENT;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stages + 2 * KV_TF_STAGE);
  uint64_t* landed = kv_full + 1;  // landed: the TMA bytes; ready: the split warps done;
  uint64_t* ready = landed + 2;    // empty: the stage's consumer done with it
  uint64_t* empty = ready + 2;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t HD = (size_t)H * DH;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * L;
  const int nsteps = (L + KV_TF_BQ - 1) / KV_TF_BQ;

  // A tile with no kept key, in a row that keeps some: P = dS = 0 on it
  int tile_kept = 1, row_kept = 1;
  if (mask_b != nullptr) {
    tile_kept = row_kept = 0;
    for (int i = threadIdx.x; i < L; i += TF_THREADS) {
      const int m = mask_b[i] != 0;
      row_kept |= m;
      tile_kept |= m & (i >= k0 && i < k0 + BK);
    }
    row_kept = __syncthreads_or(row_kept);
    tile_kept = __syncthreads_or(tile_kept);
  }
  if (!tile_kept && row_kept) {
    for (int i = threadIdx.x; i < BK * DH / 4; i += TF_THREADS) {
      const int r = i >> 4, c = (i & 15) * 4;
      if (k0 + r < L) {
        const size_t off = ((size_t)b * L + k0 + r) * HD + h * DH + c;
        *reinterpret_cast<float4*>(dk + off) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + off) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(&landed[st], 1);                 // the loader's arrive + the bytes
      mbar_init(&ready[st], TF_SPLIT_THREADS);   // every split thread
      mbar_init(&empty[st], 4);                  // one arrive per warp of its consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == TF_CONSUMER_WARPS && lane == 0) {
    // K and V [64 keys][64 dims], then the first step of each stage
    mbar_arrive_expect_tx(kv_full, 2 * TF_TILE);
    #pragma unroll
    for (int a = 0; a < 2; ++a) {
      tma_load_3d(smem + KV_TF_K + a * TF_HALF, &tm.k, kv_full, h * DH + 32 * a, k0, b);
      tma_load_3d(smem + KV_TF_V + a * TF_HALF, &tm.v, kv_full, h * DH + 32 * a, k0, b);
    }
    for (int i = 0; i < 2 && i < nsteps; ++i)
      kv_tf_load(stages + i * KV_TF_STAGE, &landed[i], i, tm, bias_tma, L, k0, h, b);
  }
  // every thread takes part in splitting K and V in place
  mbar_wait(kv_full, 0);
  tf_split_tile(smem + KV_TF_K, TF_TILE, threadIdx.x, TF_THREADS);
  tf_split_tile(smem + KV_TF_V, TF_TILE, threadIdx.x, TF_THREADS);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // read by wgmma
  __syncthreads();

  if (warp >= TF_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TF_PRODUCER_REGS));
    if (warp == TF_CONSUMER_WARPS) {
      if (lane == 0) {
        for (int i = 2; i < nsteps; ++i) {  // a stage as soon as its consumer frees it
          const int st = i & 1;
          mbar_wait(&empty[st], ((i >> 1) - 1) & 1);
          kv_tf_load(stages + st * KV_TF_STAGE, &landed[st], i, tm, bias_tma, L, k0, h, b);
        }
      }
    } else {
      const int wl = warp - TF_CONSUMER_WARPS - 1;
      const size_t bh = ((size_t)b * H + h) * L;
      const float* bias_h = bias + (size_t)h * L * L;
      const int tid = wl * 32 + lane;
      const float* src = (tid < 32 ? lse : tid < 64 ? delta : gate) + bh;
      for (int i = 0; i < nsteps; ++i) {
        const int st = i & 1, q0 = i * KV_TF_BQ;
        // lse, delta or gate of one of the step's queries (TF_SPLIT_THREADS =
        // 3 x 32), fetched while the stage lands; lse +inf past L, so P = 0
        const int q = q0 + lane;
        const float x = q < L ? src[q] : (tid < 32 ? INFINITY : 0.f);
        mbar_wait(&landed[st], (i >> 1) & 1);
        uint8_t* stage = stages + st * KV_TF_STAGE;
        kv_tf_prepare(stage, tid, wl, lane, bias_h, bias_tma, L, q0, k0);
        reinterpret_cast<float*>(stage + KS_VEC)[tid] = x;
        // the generic stores above are read by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&ready[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TF_CONSUMER_REGS));
  const int w = warp >> 2, wl = warp & 3;  // the consumer warpgroup, its warp
  const int g = lane >> 2, t = lane & 3;   // fragment row group / column
  const int lk0 = wl * 16 + g, lk1 = lk0 + 8;  // the thread's two keys in the tile
  const int kr0 = k0 + lk0, kr1 = k0 + lk1;
  const float keep_r[2] = {keep_flag(mask, b, kr0, L), keep_flag(mask, b, kr1, L)};
  const float sl2 = scale * LOG2E;
  uint8_t* stage = stages + w * KV_TF_STAGE;
  const float* vec = reinterpret_cast<const float*>(stage + KS_VEC);
  const uint64_t dkh = sw128_desc(smem + KV_TF_K, 16), dkl = sw128_desc(smem + KV_TF_KLO, 16);
  const uint64_t dvh = sw128_desc(smem + KV_TF_V, 16), dvl = sw128_desc(smem + KV_TF_VLO, 16);
  const uint64_t dqh = sw128_desc(stage + KS_Q, 16), dql = sw128_desc(stage + KS_Q + KS_LO, 16);
  const uint64_t ddh = sw128_desc(stage + KS_DO, 16), ddl = sw128_desc(stage + KS_DO + KS_LO, 16);
  const uint64_t dqth = sw128_desc(stage + KS_QT, 16);
  const uint64_t dqtl = sw128_desc(stage + KS_QT + KS_LO, 16);
  const uint64_t ddth = sw128_desc(stage + KS_DOT, 16);
  const uint64_t ddtl = sw128_desc(stage + KS_DOT + KS_LO, 16);

  float sums[2][8][4];  // dK, dV: 8 tiles of 8 head dims, accumulator layout
  float acc[8][4];      // a step's dV, then dK
  float s[4][4], dp[4][4];  // S^T then P^T, dP^T then dS^T: 4 tiles of 8 queries
  #pragma unroll
  for (int n = 0; n < 8; ++n)
    #pragma unroll
    for (int e = 0; e < 4; ++e) sums[0][n][e] = sums[1][n][e] = acc[n][e] = 0.f;
  #pragma unroll
  for (int j = 0; j < 4; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;

  for (int i = w; i < nsteps; i += 2) {
    const uint32_t parity = (i >> 1) & 1;
    mbar_wait(&landed[w], parity);
    mbar_wait(&ready[w], parity);
    // S^T = K Q^T and dP^T = V dO^T in 3xTF32, two commit groups
    reg_fence_n32(s);
    reg_fence_n32(dp);
    wgmma_fence();
    #pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint32_t ka = tf_slice(ks), qb = tf_slice<KV_TF_QHALF>(ks);
      wgmma_m64n32k8_tf32_ss(s, dkh + ka, dql + qb, ks > 0);
      wgmma_m64n32k8_tf32_ss(s, dkl + ka, dqh + qb, 1);
      wgmma_m64n32k8_tf32_ss(s, dkh + ka, dqh + qb, 1);
    }
    wgmma_commit();
    #pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint32_t ka = tf_slice(ks), qb = tf_slice<KV_TF_QHALF>(ks);
      wgmma_m64n32k8_tf32_ss(dp, dvh + ka, ddl + qb, ks > 0);
      wgmma_m64n32k8_tf32_ss(dp, dvl + ka, ddh + qb, 1);
      wgmma_m64n32k8_tf32_ss(dp, dvh + ka, ddh + qb, 1);
    }
    wgmma_commit();
    // while they run: the bias at the thread's (key, query) pairs (key lk0:
    // e = 0, 1; lk1: e = 2, 3; query 8j + 2t + (e & 1)) and the queries'
    // lse, delta, gate
    float bv[4][4];
    float2 ls[4], de[4], ga[4];
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = 8 * j + 2 * t;
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lk = e < 2 ? lk0 : lk1;
        bv[j][e] = *reinterpret_cast<const float*>(stage + KS_BIAS + (lk >> 5) * KV_TF_QHALF +
                                                   tf_sw(qc + (e & 1), lk & 31));
      }
      ls[j] = *reinterpret_cast<const float2*>(vec + qc);
      de[j] = *reinterpret_cast<const float2*>(vec + KV_TF_BQ + qc);
      ga[j] = *reinterpret_cast<const float2*>(vec + 2 * KV_TF_BQ + qc);
    }
    wgmma_wait<1>();  // S^T
    reg_fence_n32(s);
    // P^T in place, in the log2 domain: P = 2^(S scale log2e + gate log2e
    // bias - lse log2e); 0 at masked keys and keys past L, 1/L at an
    // all-masked row (lse = f32-min); 0 at queries past L (lse = +inf)
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = e & 1 ? ls[j].y : ls[j].x;
        const float gl = (e & 1 ? ga[j].y : ga[j].x) * LOG2E;
        const float kp = keep_r[e >> 1];
        float p = ex2(fmaf(s[j][e], sl2, fmaf(gl, bv[j][e], -l * LOG2E)));
        if (kp <= 0.f) p = kp == 0.f && l == NEG ? inv_L : 0.f;
        s[j][e] = p;
      }
    wgmma_wait<0>();  // dP^T
    reg_fence_n32(dp);
    // dS^T = P^T (dP^T - delta) at kept keys, in place
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = keep_r[e >> 1] > 0.f ? s[j][e] * (dp[j][e] - (e & 1 ? de[j].y : de[j].x))
                                        : 0.f;
    // dV += P^T dO: P^T's hi and lo from its accumulator (tf_fragments), dO^T
    // [d][query position] K-major; the step's sum in an accumulator of its own
    uint32_t fh[4][4], fl[4][4];
    #pragma unroll
    for (int j = 0; j < 4; ++j) tf_fragments(s[j], fh[j], fl[j]);
    reg_fence(acc);
    wgmma_fence();
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_m64n64k8_tf32(acc, fl[j], ddth + tf_slice(j), j > 0);
      wgmma_m64n64k8_tf32(acc, fh[j], ddtl + tf_slice(j), 1);
      wgmma_m64n64k8_tf32(acc, fh[j], ddth + tf_slice(j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    #pragma unroll
    for (int n = 0; n < 8; ++n)
      #pragma unroll
      for (int e = 0; e < 4; ++e) sums[1][n][e] += acc[n][e];
    // dK += dS^T Q, likewise with Q^T
    #pragma unroll
    for (int j = 0; j < 4; ++j) tf_fragments(dp[j], fh[j], fl[j]);
    reg_fence(acc);
    wgmma_fence();
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_m64n64k8_tf32(acc, fl[j], dqth + tf_slice(j), j > 0);
      wgmma_m64n64k8_tf32(acc, fh[j], dqtl + tf_slice(j), 1);
      wgmma_m64n64k8_tf32(acc, fh[j], dqth + tf_slice(j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[w]);  // this warp is done with the stage
    #pragma unroll
    for (int n = 0; n < 8; ++n)
      #pragma unroll
      for (int e = 0; e < 4; ++e) sums[0][n][e] += acc[n][e];
  }

  // consumer 1's sums through its own stage: every load into it has been read
  if (!tf_combine<64>(&sums[0][0][0], reinterpret_cast<float*>(stages + KV_TF_STAGE), w,
                      wl * 32 + lane))
    return;
  #pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = h * DH + n * 8 + 2 * t;
    if (kr0 < L) {
      const size_t off = ((size_t)b * L + kr0) * HD + c;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(sums[0][n][0] * scale, sums[0][n][1] * scale);
      *reinterpret_cast<float2*>(dv + off) = make_float2(sums[1][n][0], sums[1][n][1]);
    }
    if (kr1 < L) {
      const size_t off = ((size_t)b * L + kr1) * HD + c;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(sums[0][n][2] * scale, sums[0][n][3] * scale);
      *reinterpret_cast<float2*>(dv + off) = make_float2(sums[1][n][2], sums[1][n][3]);
    }
  }
}

// ---- (b) dbias
//
// One block per (64-key tile, 64-query tile, head) whose loop is the batch:
// only the rows that keep a key of the tile (the others add dS = 0), listed
// in the block's prologue.  Per row it recomputes S = Q K^T and dP = dO V^T
// (m64n64k8, both operands in TMA's layout, no transpose), and sums dS gate
// = P (dP gate - delta gate) in f32 registers; each dbias element is written
// once.  Q and dO land as f32 and each consumer splits its A fragments in
// registers (64 a thread); K and V are split in place by the producer.
//
// Shared memory: the block's bias [64 queries][64 keys] (16 KB), two stages
// of 97 KB (Q, dO, K, K lo, V, V lo and the 64 queries' lse, delta, gate
// and the 64 keys' keep bytes) and the row list: 216 KB at B = 2048, one
// block an SM.  Per row 48 tf32 wgmma instructions (1536 tensor clocks)
// read 96 KB of B operands and 64 KB of A fragments from shared memory.

constexpr int DS_Q = 0, DS_DO = TF_TILE, DS_K = 2 * TF_TILE, DS_V = 4 * TF_TILE,
              DS_VEC = 6 * TF_TILE;  // K's and V's lo TF_TILE after their hi
constexpr int DB_TF_STAGE = DS_VEC + 1024;  // 97 KB
constexpr int DB_TF_LIST_MAX = 2048;        // batch rows a block lists; past that it walks all
static_assert(DB_TF_STAGE % 1024 == 0, "stages keep the 1024-byte swizzle alignment");

// the bias, two stages, 8 mbarriers, the list's count (16 bytes), the list
// (uint16) and a flag byte a row, and slack to align to 1024 bytes
inline size_t db_tf_smem_bytes(int listed_rows) {
  return (size_t)TF_TILE + 2 * DB_TF_STAGE + 8 * 8 + 16 + (size_t)listed_rows * 3 + 1024;
}

struct DbTfMaps {  // (b)'s tensor maps, 64-row boxes; the bias only when L % 4 == 0
  CUtensorMap q, dout, k, v, bias;
};

// The rows of a [B][L] mask whose keys k0..k0+63 hold a kept one (a batch
// row contributes nothing to those keys' dbias otherwise): a flag byte a row
// in flags[B], then the rows in order in list[0..n) and n in *n_out (warp 0
// writes those).  Every one of the block's kThreads threads calls it, a
// warp a row at a time; read the list after a __syncthreads().
template <int kThreads>
__device__ __forceinline__ void list_kept_rows(const uint8_t* mask, int B, int L, int k0,
                                               uint8_t* flags, uint16_t* list, int* n_out) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < B; b += kThreads / 32) {
    const uint8_t* m = mask + (size_t)b * L;
    const int c = k0 + 2 * lane;
    const bool any = (c < L && m[c] != 0) || (c + 1 < L && m[c + 1] != 0);
    const bool row = __any_sync(0xffffffffu, any);
    if (lane == 0) flags[b] = row;
  }
  __syncthreads();
  if (threadIdx.x < 32) compact_flags(flags, B, list, n_out);
}

// A consumer warp's A fragments of 16 rows (r0, r0 + 8 the thread's) x 64
// dims, split into tf32 hi and lo, from a landed f32 [64 rows][64] tile (two
// swizzled 32-column halves); k-slice ks is dims 8 ks .. 8 ks + 7.
__device__ __forceinline__ void tf_a_fragments(uint32_t hi[8][4], uint32_t lo[8][4],
                                               const uint8_t* tile, int r0, int t) {
  #pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const uint8_t* half = tile + (ks >> 2) * TF_HALF;
    const int c = (ks & 3) * 8 + t;
    tf32_split(*reinterpret_cast<const float*>(half + tf_sw(r0, c)), hi[ks][0], lo[ks][0]);
    tf32_split(*reinterpret_cast<const float*>(half + tf_sw(r0 + 8, c)), hi[ks][1], lo[ks][1]);
    tf32_split(*reinterpret_cast<const float*>(half + tf_sw(r0, c + 4)), hi[ks][2], lo[ks][2]);
    tf32_split(*reinterpret_cast<const float*>(half + tf_sw(r0 + 8, c + 4)), hi[ks][3],
               lo[ks][3]);
  }
}

__global__ void __launch_bounds__(TF_THREADS, 1)
bwd_dbias_tf32x3_kernel(const __grid_constant__ DbTfMaps tm, const float* __restrict__ bias,
                        const float* __restrict__ gate, const uint8_t* __restrict__ mask,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dbias, int B, int L, int H, float scale,
                        int bias_tma) {
  extern __shared__ uint8_t dbtf_smem_raw[];
  uint8_t* smem = align1024(dbtf_smem_raw);  // the bias [64 queries][64 keys] first
  uint8_t* stages = smem + TF_TILE;
  uint64_t* bias_full = reinterpret_cast<uint64_t*>(stages + 2 * DB_TF_STAGE);
  uint64_t* landed = bias_full + 1;
  uint64_t* ready = landed + 2;
  uint64_t* empty = ready + 2;
  int* nlist_s = reinterpret_cast<int*>(empty + 2);
  uint16_t* list = reinterpret_cast<uint16_t*>(nlist_s + 4);  // the batch rows walked

  const int k0 = blockIdx.x * BK;
  const int q0 = blockIdx.y * BQ;
  const int h = blockIdx.z;  // slowest: the blocks running together share a head's tiles in L2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool listed = mask != nullptr && B <= DB_TF_LIST_MAX;

  if (threadIdx.x == 0) {
    mbar_init(bias_full, bias_tma ? 1 : TF_SPLIT_THREADS);
    for (int st = 0; st < 2; ++st) {
      mbar_init(&landed[st], 1);
      mbar_init(&ready[st], TF_SPLIT_THREADS);
      mbar_init(&empty[st], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (listed) list_kept_rows<TF_THREADS>(mask, B, L, k0, reinterpret_cast<uint8_t*>(list + B),
                                         list, nlist_s);
  __syncthreads();
  const int nrows = listed ? *nlist_s : B;

  if (warp >= TF_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TF_PRODUCER_REGS));
    if (warp == TF_CONSUMER_WARPS) {
      if (lane == 0) {
        if (bias_tma) {  // the block's bias: [64 queries][32 keys] halves, one wholly past L skipped
          const int halves = k0 + 32 < L ? 2 : 1;
          mbar_arrive_expect_tx(bias_full, halves * TF_HALF);
          for (int a = 0; a < halves; ++a)
            tma_load_3d(smem + a * TF_HALF, &tm.bias, bias_full, k0 + 32 * a, q0, h);
        }
        for (int i = 0; i < nrows; ++i) {  // a stage as soon as its consumer frees it
          const int st = i & 1, b = listed ? list[i] : i;
          if (i >= 2) mbar_wait(&empty[st], ((i >> 1) - 1) & 1);
          uint8_t* stage = stages + st * DB_TF_STAGE;
          mbar_arrive_expect_tx(&landed[st], 4 * TF_TILE);
          #pragma unroll
          for (int a = 0; a < 2; ++a) {
            tma_load_3d(stage + DS_Q + a * TF_HALF, &tm.q, &landed[st], h * DH + 32 * a, q0, b);
            tma_load_3d(stage + DS_DO + a * TF_HALF, &tm.dout, &landed[st], h * DH + 32 * a, q0,
                        b);
            tma_load_3d(stage + DS_K + a * TF_HALF, &tm.k, &landed[st], h * DH + 32 * a, k0, b);
            tma_load_3d(stage + DS_V + a * TF_HALF, &tm.v, &landed[st], h * DH + 32 * a, k0, b);
          }
        }
      }
    } else {
      const int tid = (warp - TF_CONSUMER_WARPS - 1) * 32 + lane;
      if (!bias_tma) {
        const float* bias_h = bias + (size_t)h * L * L;
        for (int i = tid; i < BQ * BK; i += TF_SPLIT_THREADS) {
          const int r = i >> 6, c = i & 63;
          *reinterpret_cast<float*>(smem + (c >> 5) * TF_HALF + tf_sw(r, c & 31)) =
              (q0 + r < L && k0 + c < L) ? bias_h[(size_t)(q0 + r) * L + k0 + c] : 0.f;
        }
        mbar_arrive(bias_full);
      }
      for (int i = 0; i < nrows; ++i) {
        const int st = i & 1, b = listed ? list[i] : i;
        uint8_t* stage = stages + st * DB_TF_STAGE;
        // fetched while the stage lands: lse (+inf past L, so P = 0 there),
        // delta, gate of the 64 queries, two values a thread (3 x 64 =
        // 2 x TF_SPLIT_THREADS), and the keep byte of each of the 64 keys
        // (0 past L)
        const size_t bh = ((size_t)b * H + h) * L;
        float x[2];
        #pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = tid + u * TF_SPLIT_THREADS, which = j >> 6, q = q0 + (j & 63);
          const float* src = which == 0 ? lse : which == 1 ? delta : gate;
          x[u] = q < L ? src[bh + q] : (which == 0 ? INFINITY : 0.f);
        }
        const int kj = k0 + tid;
        const bool kept = tid < BK && kj < L && (mask == nullptr || mask[(size_t)b * L + kj] != 0);
        mbar_wait(&landed[st], (i >> 1) & 1);
        tf_split_tile(stage + DS_K, TF_TILE, tid, TF_SPLIT_THREADS);
        tf_split_tile(stage + DS_V, TF_TILE, tid, TF_SPLIT_THREADS);
        float* vec = reinterpret_cast<float*>(stage + DS_VEC);
        vec[tid] = x[0];
        vec[tid + TF_SPLIT_THREADS] = x[1];
        if (tid < BK) reinterpret_cast<uint8_t*>(vec + 3 * BQ)[tid] = kept;
        // the generic stores above are read by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&ready[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TF_CONSUMER_REGS));
  const int w = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = wl * 16 + g, lr1 = lr0 + 8;  // the thread's two queries in the tile
  const float sl2 = scale * LOG2E;
  uint8_t* stage = stages + w * DB_TF_STAGE;
  const float* vec = reinterpret_cast<const float*>(stage + DS_VEC);
  const uint8_t* keep = reinterpret_cast<const uint8_t*>(vec + 3 * BQ);
  const uint64_t dkh = sw128_desc(stage + DS_K, 16), dkl = sw128_desc(stage + DS_K + TF_TILE, 16);
  const uint64_t dvh = sw128_desc(stage + DS_V, 16), dvl = sw128_desc(stage + DS_V + TF_TILE, 16);

  float acc[8][4];          // dbias of (query lr0: e = 0, 1; lr1: e = 2, 3; key 8j + 2t + (e & 1))
  float s[8][4], dp[8][4];  // S then P, dP
  uint32_t ah[8][4], al[8][4];  // Q's, then dO's A fragments
  #pragma unroll
  for (int j = 0; j < 8; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = s[j][e] = dp[j][e] = 0.f;
  mbar_wait(bias_full, 0);

  for (int i = w; i < nrows; i += 2) {
    const uint32_t parity = (i >> 1) & 1;
    mbar_wait(&landed[w], parity);
    mbar_wait(&ready[w], parity);
    // S = Q K^T in 3xTF32, Q's fragments split in registers
    tf_a_fragments(ah, al, stage + DS_Q, lr0, t);
    reg_fence(s);
    wgmma_fence();
    #pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      wgmma_m64n64k8_tf32(s, al[ks], dkh + tf_slice(ks), ks > 0);
      wgmma_m64n64k8_tf32(s, ah[ks], dkl + tf_slice(ks), 1);
      wgmma_m64n64k8_tf32(s, ah[ks], dkh + tf_slice(ks), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    // dP = dO V^T, and P while it runs
    tf_a_fragments(ah, al, stage + DS_DO, lr0, t);
    reg_fence(dp);
    wgmma_fence();
    #pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      wgmma_m64n64k8_tf32(dp, al[ks], dvh + tf_slice(ks), ks > 0);
      wgmma_m64n64k8_tf32(dp, ah[ks], dvl + tf_slice(ks), 1);
      wgmma_m64n64k8_tf32(dp, ah[ks], dvh + tf_slice(ks), 1);
    }
    wgmma_commit();
    const float ll[2] = {vec[lr0] * LOG2E, vec[lr1] * LOG2E};
    const float de[2] = {vec[BQ + lr0], vec[BQ + lr1]};
    const float ga[2] = {vec[2 * BQ + lr0], vec[2 * BQ + lr1]};
    const float gl[2] = {ga[0] * LOG2E, ga[1] * LOG2E};
    // keep bits: bit 8 (j % 4) + c of kept[j / 4] is key 8j + 2t + c
    const uint32_t lo = __ballot_sync(0xffffffffu, keep[lane] != 0);
    const uint32_t hi = __ballot_sync(0xffffffffu, keep[32 + lane] != 0);
    const uint32_t kept[2] = {lo >> (2 * t), hi >> (2 * t)};
    // P in place, in the log2 domain; 0 where the key is not kept
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float bv = *reinterpret_cast<const float*>(
            smem + (j >> 2) * TF_HALF + tf_sw(r ? lr1 : lr0, ((8 * j + 2 * t) & 31) + (e & 1)));
        const float p = ex2(fmaf(s[j][e], sl2, fmaf(gl[r], bv, -ll[r])));
        s[j][e] = (kept[j >> 2] >> (8 * (j & 3) + (e & 1))) & 1 ? p : 0.f;
      }
    wgmma_wait<0>();  // dP
    reg_fence(dp);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[w]);  // this warp is done with the stage
    // dbias += dS gate = P (dP gate - delta gate)
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        acc[j][e] = fmaf(s[j][e], fmaf(dp[j][e], ga[r], -de[r] * ga[r]), acc[j][e]);
      }
  }

  // consumer 1's sums through its own stage: every load into it has been read
  if (!tf_combine<32>(&acc[0][0], reinterpret_cast<float*>(stages + DB_TF_STAGE), w,
                      wl * 32 + lane))
    return;
  float* dbias_h = dbias + (size_t)h * L * L;
  const bool pair_ok = (L & 1) == 0;  // 8-byte aligned pairs
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = k0 + j * 8 + 2 * t;
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + (r ? lr1 : lr0);
      if (q >= L || c >= L) continue;
      float* dst = dbias_h + (size_t)q * L + c;
      if (pair_ok) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        dst[0] = acc[j][2 * r];
        if (c + 1 < L) dst[1] = acc[j][2 * r + 1];
      }
    }
  }
}

// ------------------------------------------------------ float32 kernel A (B4)
// 3xTF32 on wgmma (the split, the warpgroup roles and setmaxnreg: see
// gated_attention.cuh), built as the forward's gated_attention_tf32x3_kernel
// is: one block per (batch row, head, 128-query tile), batch fastest, two
// consumer warpgroups of 64 queries and a producer warpgroup.  The block
// lists its batch row's 64-key tiles that hold a kept key and walks each as
// two 32-key steps (exact: dS = 0 at every masked key; a row with no kept
// key walks none, and its dq and dgate are 0).  Three products a step:
//   S = Q K^T and dP = dO V^T on m64n32k8, A from registers (Q's and dO's
//     hi and lo, resident), B K and V as TMA lands them (K-major along the
//     head dim), split in place;
//   P = 2^(S scale log2e + gate log2e bias - lse log2e), one ex2; dS = P
//     (dP - delta) at kept keys, 0 elsewhere by a select; dgate += dS bias;
//   dQ += dS K: dS's hi and lo A fragments straight from its accumulator
//     (tf_fragments), B K^T hi and lo [64 dims][32 key positions], which the
//     producer's split warps write with each group of 8 keys permuted
//     (tf_pos), as the forward writes V^T.  The step's product goes to an
//     accumulator of its own, in two 32-dim halves (m64n32k8), each added to
//     the running dQ by f32 adds: the tensor cores' f32 sums truncate.
// dQ scale and dgate (summed across the quad by shuffles) are stored once
// at the end: no atomics, a fixed order of sums.
//
// The budget.  Shared memory: a stage holds K, K lo, V, V lo ([32 keys]
// [64], 8 KB each), K^T hi and lo (8 KB each) and the bias [128 queries][32
// keys] (16 KB): 64 KB, three stages (192 KB), one block an SM.  A 64-key
// stage (128 KB) would leave room for one.  Registers, of the consumers'
// 232: Q and dO hi and lo 128, S and dP 16 each, the running dQ 32, dS's
// fragments 32 (over S and dP, which are dead by then), the step's dQ half
// 16, the bias values 16 and some 15 scalars: ~210-225 at the peak.  A
// whole 64-dim step accumulator (32) passes 232: built, it spilled 200 bytes
// and ran 5 % slower.  As built, ptxas reports 168 registers (the launch
// count setmaxnreg needs), 24 bytes of spill stores and 40 of loads, and
// the SASS holds 72 HGMMA.64x32x8.F32.TF32 and no other HGMMA.
//
// What bounds it, at B=8, L=1024, H=16 with phase 5's ragged masks: the
// three products are 6 x 64 flops per (query, key) pair over the kept
// pairs, ~0.0973 TFLOP as 3xTF32 = 0.1956 ms at 495 TFLOP/s of dense tf32;
// the bytes (q, k, v, dO, dq once each and the f32 bias) ~200 MB, 0.06 ms.
// Per 32-key step a block issues 144 m64n32k8 (2 x 1152 tensor clocks at
// 16 a wgmma) and reads ~144 KB of B operands from shared memory, beside the
// split's ~56 KB and TMA's 32 KB (~1800 clocks at 128 bytes a clock).
// Measured times stand in PERF.md.

constexpr int DQ_TF_BQ = 128;                // queries a block: two consumer warpgroups of 64
constexpr int DQ_TF_BK = 32;                 // keys a step
constexpr int DQ_TF_STAGES = 3;
constexpr int DQ_TF_KHALF = DQ_TF_BK * 128;  // [32 keys][32 f32]: 4 KB
// a stage: K and V [32 keys][64 dims] as two 4 KB halves each (TMA, then
// their hi in place) with their lo DQS_LO further on; K^T hi, then lo, [64
// dims][32 key positions]; the bias [128 queries][32 keys]
constexpr int DQS_K = 0, DQS_V = 16384, DQS_KT = 32768, DQS_BIAS = 49152;
constexpr int DQS_LO = 8192;
constexpr int DQ_TF_STAGE = DQS_BIAS + DQ_TF_BQ * 128;  // 64 KB
constexpr int DQ_TF_LIST_MAX = 2048;  // 64-key tiles a block lists (L <= 131072); else it walks all
static_assert(DQ_TF_STAGE % 1024 == 0, "stages keep the 1024-byte swizzle alignment");

// The ring, 3 x DQ_TF_STAGES mbarriers, the count (16 bytes), list (uint16)
// and flags (a byte each) of the 64-key tiles listed, and slack to align.
inline size_t dq_tf_smem_bytes(int listed_tiles) {
  return (size_t)DQ_TF_STAGES * DQ_TF_STAGE + 3 * DQ_TF_STAGES * 8 + 16 +
         (size_t)listed_tiles * 3 + 1024;
}

struct DqTfMaps {  // kernel A's tensor maps; the bias only when L % 4 == 0
  CUtensorMap k, v, bias;
};

// The first key of step i: half i % 2 of the 64-key tile live[i / 2] (or of
// tile i / 2 when the block walks every step).
__device__ __forceinline__ int dq_tf_k0(int i, bool use_list, const uint16_t* live) {
  return (use_list ? live[i >> 1] : i >> 1) * BK + (i & 1) * DQ_TF_BK;
}

// The split warps prepare a landed stage: K's hi in place, its lo beside,
// and both into K^T [64 dims][32 key positions] (tf_pos), a warp a unit of
// 32 keys x 4 dims (conflict-free 16-byte reads along the keys, and each
// dim's 32 keys one 128-byte row of K^T); V's hi in place and lo beside; the
// bias by elements where TMA cannot address its rows (L % 4 != 0).
__device__ __forceinline__ void dq_tf_prepare(uint8_t* stage, int tid, int wl, int lane,
                                              const float* bias_q, bool bias_tma, int L, int q0,
                                              int k0) {
  const int p = tf_pos(lane);  // the key's position
  for (int u = wl; u < 16; u += 3) {  // dims 4 u .. 4 u + 3
    const int off = (u >> 3) * DQ_TF_KHALF + tf_sw(lane, (u & 7) * 4);
    const float4 x = *reinterpret_cast<const float4*>(stage + DQS_K + off);
    uint32_t hi[4], lo[4];
    tf32_split(x.x, hi[0], lo[0]);
    tf32_split(x.y, hi[1], lo[1]);
    tf32_split(x.z, hi[2], lo[2]);
    tf32_split(x.w, hi[3], lo[3]);
    *reinterpret_cast<uint4*>(stage + DQS_K + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(stage + DQS_K + DQS_LO + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int offt = tf_sw(4 * u + e, p);
      *reinterpret_cast<uint32_t*>(stage + DQS_KT + offt) = hi[e];
      *reinterpret_cast<uint32_t*>(stage + DQS_KT + DQS_LO + offt) = lo[e];
    }
  }
  tf_split_tile<2 * DQ_TF_KHALF>(stage + DQS_V, DQS_LO, tid, TF_SPLIT_THREADS);
  if (!bias_tma) {
    for (int i = tid; i < DQ_TF_BQ * DQ_TF_BK; i += TF_SPLIT_THREADS) {
      const int r = i >> 5, c = i & 31;
      *reinterpret_cast<float*>(stage + DQS_BIAS + tf_sw(r, c)) =
          (q0 + r < L && k0 + c < L) ? bias_q[(size_t)r * L + k0 + c] : 0.f;
    }
  }
}

// A consumer thread's tf32 hi and lo A fragments of its two rows' 64 head
// dims (8 slices of 8), from a head-packed f32 matrix; zeros past L.
__device__ __forceinline__ void tf_row_fragments(uint32_t hi[8][4], uint32_t lo[8][4],
                                                 const float* row0, const float* row1,
                                                 bool valid0, bool valid1, int t) {
  #pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int c = 8 * ks + t;
    tf32_split(valid0 ? row0[c] : 0.f, hi[ks][0], lo[ks][0]);
    tf32_split(valid1 ? row1[c] : 0.f, hi[ks][1], lo[ks][1]);
    tf32_split(valid0 ? row0[c + 4] : 0.f, hi[ks][2], lo[ks][2]);
    tf32_split(valid1 ? row1[c + 4] : 0.f, hi[ks][3], lo[ks][3]);
  }
}

__global__ void __launch_bounds__(TF_THREADS, 1)
bwd_dq_tf32x3_kernel(const __grid_constant__ DqTfMaps tm, const float* __restrict__ q,
                     const float* __restrict__ bias, const float* __restrict__ gate,
                     const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ dout,
                     float* __restrict__ dq, float* __restrict__ dgate, int L, int H,
                     float scale, int bias_tma) {
  extern __shared__ uint8_t dqtf_smem_raw[];
  uint8_t* smem = align1024(dqtf_smem_raw);
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + DQ_TF_STAGES * DQ_TF_STAGE);
  uint64_t* ready = landed + DQ_TF_STAGES;  // landed: the TMA bytes; ready: split warps done
  uint64_t* empty = ready + DQ_TF_STAGES;   // empty: the consumer warps are done with it
  int* nlive_s = reinterpret_cast<int*>(empty + DQ_TF_STAGES);
  uint16_t* live = reinterpret_cast<uint16_t*>(nlive_s + 4);  // the 64-key tiles walked

  const int b = blockIdx.x;  // batch fastest: bias tiles reused from L2
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * DQ_TF_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t HD = (size_t)H * DH;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * L;
  const int ntiles = (L + BK - 1) / BK;
  const bool listed = mask_b != nullptr && ntiles <= DQ_TF_LIST_MAX;

  if (threadIdx.x == 0) {
    for (int st = 0; st < DQ_TF_STAGES; ++st) {
      mbar_init(&landed[st], 1);                 // the loader's arrive + the bytes
      mbar_init(&ready[st], TF_SPLIT_THREADS);   // every split thread
      mbar_init(&empty[st], TF_CONSUMER_WARPS);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (listed)
    list_live_tiles<TF_THREADS>(mask_b, L, ntiles, reinterpret_cast<uint8_t*>(live + ntiles),
                                live, nlive_s);
  __syncthreads();
  // the 32-key steps walked: both halves of each listed tile but a half
  // wholly past L (only the last tile can have one), or every step
  int nvisit = (L + DQ_TF_BK - 1) / DQ_TF_BK;
  if (listed) {
    const int nlive = *nlive_s;
    nvisit = 2 * nlive - (nlive > 0 && live[nlive - 1] * BK + DQ_TF_BK >= L ? 1 : 0);
  }

  if (warp >= TF_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TF_PRODUCER_REGS));
    if (warp == TF_CONSUMER_WARPS) {
      // one lane loads: K and V [32 keys][64 dims] as two 32-dim halves and
      // the bias [128 queries][32 keys], a stage as soon as the consumers free it
      if (lane == 0) {
        for (int i = 0; i < nvisit; ++i) {
          const int st = i % DQ_TF_STAGES;
          if (i >= DQ_TF_STAGES) mbar_wait(&empty[st], (i / DQ_TF_STAGES - 1) & 1);
          uint8_t* stage = smem + st * DQ_TF_STAGE;
          const int k0 = dq_tf_k0(i, listed, live);
          mbar_arrive_expect_tx(&landed[st],
                                4 * DQ_TF_KHALF + (bias_tma ? DQ_TF_BQ * 128 : 0));
          #pragma unroll
          for (int a = 0; a < 2; ++a) {
            tma_load_3d(stage + DQS_K + a * DQ_TF_KHALF, &tm.k, &landed[st], h * DH + 32 * a,
                        k0, b);
            tma_load_3d(stage + DQS_V + a * DQ_TF_KHALF, &tm.v, &landed[st], h * DH + 32 * a,
                        k0, b);
          }
          if (bias_tma) tma_load_3d(stage + DQS_BIAS, &tm.bias, &landed[st], k0, q0, h);
        }
      }
    } else {
      const int wl = warp - TF_CONSUMER_WARPS - 1;
      const int tid = wl * 32 + lane;
      const float* bias_q = bias + ((size_t)h * L + q0) * L;
      for (int i = 0; i < nvisit; ++i) {
        const int st = i % DQ_TF_STAGES;
        mbar_wait(&landed[st], (i / DQ_TF_STAGES) & 1);
        dq_tf_prepare(smem + st * DQ_TF_STAGE, tid, wl, lane, bias_q, bias_tma, L, q0,
                      dq_tf_k0(i, listed, live));
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

  // Q and dO as tf32 hi and lo A fragments, kept in registers
  uint32_t qh[8][4], ql[8][4], oh[8][4], ol[8][4];
  tf_row_fragments(qh, ql, q + ((size_t)b * L + r0) * HD + h * DH,
                   q + ((size_t)b * L + r1) * HD + h * DH, r0 < L, r1 < L, t);
  tf_row_fragments(oh, ol, dout + ((size_t)b * L + r0) * HD + h * DH,
                   dout + ((size_t)b * L + r1) * HD + h * DH, r0 < L, r1 < L, t);
  // per row, log2 e folded in: gate log2e, -lse log2e; and delta.  Rows
  // past L: zeros, so P = 1 meets dP = delta = 0 there (and is never stored).
  const size_t bh = ((size_t)b * H + h) * L;
  const float sl2 = scale * LOG2E;
  float gl[2], nll[2], de[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r1 : r0;
    gl[i] = r < L ? gate[bh + r] * LOG2E : 0.f;
    nll[i] = r < L ? -lse[bh + r] * LOG2E : 0.f;
    de[i] = r < L ? delta[bh + r] : 0.f;
  }

  float acc[8][4];  // dQ: 8 tiles of 8 head dims, accumulator layout
  float s[4][4], dp[4][4];  // S, then P, then dS; dP: 4 tiles of 8 keys
  float part[4][4];  // a step's dQ, 32 dims at a time
  #pragma unroll
  for (int n = 0; n < 8; ++n)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  #pragma unroll
  for (int j = 0; j < 4; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = part[j][e] = 0.f;
  float dg[2] = {0.f, 0.f};  // dgate of rows r0, r1 (this thread's key columns)

  for (int i = 0; i < nvisit; ++i) {
    const int st = i % DQ_TF_STAGES;
    const uint8_t* stage = smem + st * DQ_TF_STAGE;
    const int k0 = dq_tf_k0(i, listed, live);
    // keep flag of the step's key k0 + lane (read before the products, used after)
    const bool keep = k0 + lane < L && (mask_b == nullptr || mask_b[k0 + lane]);
    mbar_wait(&landed[st], (i / DQ_TF_STAGES) & 1);
    mbar_wait(&ready[st], (i / DQ_TF_STAGES) & 1);

    // S = Q K^T and dP = dO V^T in 3xTF32, two commit groups; K and V [key][d]
    // are K-major
    const uint64_t dkh = sw128_desc(stage + DQS_K, 16);
    const uint64_t dkl = sw128_desc(stage + DQS_K + DQS_LO, 16);
    const uint64_t dvh = sw128_desc(stage + DQS_V, 16);
    const uint64_t dvl = sw128_desc(stage + DQS_V + DQS_LO, 16);
    reg_fence_n32(s);
    reg_fence_n32(dp);
    wgmma_fence();
    #pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint32_t kb = tf_slice<DQ_TF_KHALF>(ks);
      wgmma_m64n32k8_tf32(s, ql[ks], dkh + kb, ks > 0);
      wgmma_m64n32k8_tf32(s, qh[ks], dkl + kb, 1);
      wgmma_m64n32k8_tf32(s, qh[ks], dkh + kb, 1);
    }
    wgmma_commit();
    #pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint32_t kb = tf_slice<DQ_TF_KHALF>(ks);
      wgmma_m64n32k8_tf32(dp, ol[ks], dvh + kb, ks > 0);
      wgmma_m64n32k8_tf32(dp, oh[ks], dvl + kb, 1);
      wgmma_m64n32k8_tf32(dp, oh[ks], dvh + kb, 1);
    }
    wgmma_commit();
    // while they run: the bias at the thread's (row, key) pairs (rows lr0:
    // e = 0, 1; lr1: e = 2, 3; key 8j + 2t + (e & 1), chunk 2j + t / 2 of
    // the swizzled row) and the keep bits (bit 8j + (e & 1) of `kept`)
    float bv[4][4];
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int off = DQS_BIAS + ((((2 * j + (t >> 1)) ^ g) & 7) << 4) + (t & 1) * 8;
      const float2 b0 = *reinterpret_cast<const float2*>(stage + off + lr0 * 128);
      const float2 b1 = *reinterpret_cast<const float2*>(stage + off + lr1 * 128);
      bv[j][0] = b0.x;
      bv[j][1] = b0.y;
      bv[j][2] = b1.x;
      bv[j][3] = b1.y;
    }
    const uint32_t kept = __ballot_sync(0xffffffffu, keep) >> (2 * t);
    wgmma_wait<1>();  // S
    reg_fence_n32(s);
    // P in place, in the log2 domain
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = ex2(fmaf(s[j][e], sl2, fmaf(gl[e >> 1], bv[j][e], nll[e >> 1])));
    wgmma_wait<0>();  // dP
    reg_fence_n32(dp);
    // dS = P (dP - delta) at kept keys, 0 elsewhere by a select (P is inf at
    // a row whose keys are all masked, lse = f32-min, when the block walks
    // every step); dgate += dS bias; dS's hi and lo as the next A fragments
    uint32_t fh[4][4], fl[4][4];
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ds = (kept >> (8 * j + (e & 1))) & 1 ? s[j][e] * (dp[j][e] - de[e >> 1])
                                                         : 0.f;
        dg[e >> 1] = fmaf(ds, bv[j][e], dg[e >> 1]);
        s[j][e] = ds;
      }
      tf_fragments(s[j], fh[j], fl[j]);
    }
    // dQ += dS K: K^T [d][key position] is K-major; the step's product in an
    // accumulator of its own, 32 dims at a time, added by f32 adds
    #pragma unroll
    for (int hd = 0; hd < 2; ++hd) {
      const uint64_t dth = sw128_desc(stage + DQS_KT + hd * 32 * 128, 16);
      const uint64_t dtl = sw128_desc(stage + DQS_KT + DQS_LO + hd * 32 * 128, 16);
      reg_fence_n32(part);
      wgmma_fence();
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_m64n32k8_tf32(part, fl[j], dth + tf_slice(j), j > 0);
        wgmma_m64n32k8_tf32(part, fh[j], dtl + tf_slice(j), 1);
        wgmma_m64n32k8_tf32(part, fh[j], dth + tf_slice(j), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence_n32(part);
      #pragma unroll
      for (int n = 0; n < 4; ++n)
        #pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * hd + n][e] += part[n][e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
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
      *reinterpret_cast<float2*>(dq + ((size_t)b * L + r0) * HD + c) =
          make_float2(acc[n][0] * scale, acc[n][1] * scale);
    if (r1 < L)
      *reinterpret_cast<float2*>(dq + ((size_t)b * L + r1) * HD + c) =
          make_float2(acc[n][2] * scale, acc[n][3] * scale);
  }
  if (t == 0) {
    if (r0 < L) dgate[bh + r0] = dg[0];
    if (r1 < L) dgate[bh + r1] = dg[1];
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
  const float scale = 0.125f;  // 1 / sqrt(64)
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* g = static_cast<const float*>(gate);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    // K and V as [B][L][H*64] f32 in boxes of 32 dims x 32 keys; the bias
    // [H][L][L] in boxes of 32 keys x 128 queries where its rows are 16-byte
    // aligned, L % 4 == 0 (the kernel loads it elementwise otherwise)
    const uint64_t HD = (uint64_t)H * DH;
    const bool bias_tma = (L & 3) == 0;
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    DqTfMaps tm = {};
    bool ok = encode_3d(&tm.k, k, HD, L, B, HD * 4, 32, DQ_TF_BK, f32) &&
              encode_3d(&tm.v, v, HD, L, B, HD * 4, 32, DQ_TF_BK, f32);
    if (ok && bias_tma)
      ok = encode_3d(&tm.bias, bias, L, L, H, (uint64_t)L * 4, 32, DQ_TF_BQ, f32);
    if (!ok) return (int)cudaErrorInvalidValue;
    static bool checked = false;  // the register count, once a process
    cudaError_t err = tf_check_regs(bwd_dq_tf32x3_kernel, "bwd_dq_tf32x3_kernel", &checked);
    const int ntiles = (L + BK - 1) / BK;
    const size_t smem = dq_tf_smem_bytes(m != nullptr && ntiles <= DQ_TF_LIST_MAX ? ntiles : 0);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dq_tf32x3_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 tf_grid(B, H, (L + DQ_TF_BQ - 1) / DQ_TF_BQ);
    bwd_dq_tf32x3_kernel<<<tf_grid, TF_THREADS, smem, s>>>(
        tm, static_cast<const float*>(q), static_cast<const float*>(bias), g, m, ls, dl,
        static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dgate), L,
        H, scale, bias_tma);
  } else if (dtype == 1) {
    // K and V as [B][L][H*64] in 64-key tiles; the bias [H][L][L] in tiles of
    // 128 queries x 64 keys where its rows are 16-byte aligned (L % 8 == 0)
    // and the mask [B][L] in rows of 64 bytes where L % 16 == 0 (the kernel
    // loads them elementwise otherwise)
    const uint64_t HD = (uint64_t)H * DH;
    const bool bias_tma = (L & 7) == 0, mask_tma = mask != nullptr && (L & 15) == 0;
    DqMaps tm = {};
    bool ok = encode_3d(&tm.k, k, HD, L, B, HD * 2, DH, BK) &&
              encode_3d(&tm.v, v, HD, L, B, HD * 2, DH, BK);
    if (ok && bias_tma) ok = encode_3d(&tm.bias, bias, L, L, H, (uint64_t)L * 2, BK, DQ_BQ);
    if (ok && mask_tma)
      ok = encode_rows(&tm.mask, CU_TENSOR_MAP_DATA_TYPE_UINT8, mask, L, B, BK);
    if (!ok) return (int)cudaErrorInvalidValue;
    const size_t smem = dq_smem_bytes((L + BK - 1) / BK);
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dq_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 bf16_grid(B, H, (L + DQ_BQ - 1) / DQ_BQ);
    bwd_dq_bf16_kernel<<<bf16_grid, DQ_THREADS, smem, s>>>(
        tm, static_cast<const bf16*>(q), static_cast<const bf16*>(bias), g, m, ls, dl,
        static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<float*>(dgate), L,
        H, scale, bias_tma, mask_tma);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dbias is written whole (no zeroing needed), f32 in both types.
int fddm_gated_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* bias, const void* gate, const void* mask,
                                 const void* lse, const void* delta, const void* dout,
                                 void* dk, void* dv, void* dbias, int B, int L, int H,
                                 int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if ((L + BK - 1) / BK > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 0.125f;
  const float inv_L = 1.f / (float)L;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* g = static_cast<const float*>(gate);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* db = static_cast<float*>(dbias);
  if (dtype == 0) {
    if (B > 65535) return (int)cudaErrorInvalidConfiguration;
    // q, k, v, dout as [B][L][H*64] f32 in boxes 32 dims wide: 64 rows ((a)'s
    // K and V, (b)'s four) or 32 ((a)'s Q and dO); the bias [H][L][L] in
    // boxes of 32 keys x 32 queries ((a)) or 64 ((b)) where its rows are
    // 16-byte aligned, L % 4 == 0 (the kernels load it elementwise otherwise)
    const uint64_t HD = (uint64_t)H * DH;
    const bool bias_tma = (L & 3) == 0;
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    KvTfMaps ma = {};
    DbTfMaps mb = {};
    bool ok = encode_3d(&ma.k, k, HD, L, B, HD * 4, 32, BK, f32) &&
              encode_3d(&ma.v, v, HD, L, B, HD * 4, 32, BK, f32) &&
              encode_3d(&ma.q, q, HD, L, B, HD * 4, 32, KV_TF_BQ, f32) &&
              encode_3d(&ma.dout, dout, HD, L, B, HD * 4, 32, KV_TF_BQ, f32) &&
              encode_3d(&mb.q, q, HD, L, B, HD * 4, 32, BQ, f32) &&
              encode_3d(&mb.dout, dout, HD, L, B, HD * 4, 32, BQ, f32);
    if (ok && bias_tma)
      ok = encode_3d(&ma.bias, bias, L, L, H, (uint64_t)L * 4, 32, KV_TF_BQ, f32) &&
           encode_3d(&mb.bias, bias, L, L, H, (uint64_t)L * 4, 32, BQ, f32);
    if (!ok) return (int)cudaErrorInvalidValue;
    mb.k = ma.k;
    mb.v = ma.v;
    static bool checked_a = false, checked_b = false;  // the register counts, once a process
    cudaError_t err = tf_check_regs(bwd_dkv_tf32x3_kernel, "bwd_dkv_tf32x3_kernel", &checked_a);
    if (err == cudaSuccess)
      err = tf_check_regs(bwd_dbias_tf32x3_kernel, "bwd_dbias_tf32x3_kernel", &checked_b);
    const size_t smem_b = db_tf_smem_bytes(m != nullptr && B <= DB_TF_LIST_MAX ? B : 0);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dkv_tf32x3_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KV_TF_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dbias_tf32x3_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_a((L + BK - 1) / BK, H, B);
    bwd_dkv_tf32x3_kernel<<<grid_a, TF_THREADS, KV_TF_SMEM, s>>>(
        ma, static_cast<const float*>(bias), g, m, ls, dl, static_cast<float*>(dk),
        static_cast<float*>(dv), L, H, scale, inv_L, bias_tma);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_b((L + BK - 1) / BK, (L + BQ - 1) / BQ, H);
    bwd_dbias_tf32x3_kernel<<<grid_b, TF_THREADS, smem_b, s>>>(
        mb, static_cast<const float*>(bias), g, m, ls, dl, db, B, L, H, scale, bias_tma);
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
