// Fused VALID conv1d + bias + LayerNorm(channels) + GELU for Hopper (sm_90a):
// one layer of the WavLM feature extractor ("layer"-norm variant) with one
// read of its input and one write of its output.
//
//   y[b, t, :]   = sum_j x[b, t*s + j, :] . w[j, :, :] + cb            (f32)
//   out[b, t, :] = gelu(layer_norm(y[b, t, :]) * ln_scale + ln_bias)    (f32, then cast)
//
// Replaces the TPU kernel `kernel` of fddm_asr_tpu/ops/conv_frontend.py:108,
// made by `_make_kernel` (:98) and reached through `conv_ln_gelu_pallas`.
// x is channels-last [B, T, Cin], so tap j of output row t is input row
// t*s + j: the conv is a product [rows, k*Cin] x [k*Cin, Cout] whose A row t
// is the contiguous span of k*Cin elements at x + (b*T + t*s)*Cin.  The
// TPU's reshape gather, its 32-row tile from the next block, its
// zero-padded phantom tile and the reframing of the waveform layer are
// Mosaic's needs and are not carried over.  Any s and any k are taken (not
// only k - s <= s); the bfloat16 kernel takes k <= MAX_TAPS.
//
// What bounds it: layer 1 of WavLM-large at 8 x 20 s (rows = 255992, k*Cin =
// 1536, Cout = 512) is 403 GFLOP against 0.79 GB moved in bf16: operations,
// 0.41 ms at the card's dense bf16 peak; so are layers 2-6.  In float32 the
// same products take 6.0096 ms at the f32 FMA peak (67 TFLOP/s) and 2.4402 ms
// as 3xTF32 (three times the products at the dense tf32 495 TFLOP/s).  Both
// kernels answer with the Hopper GEMM shape:
//   * a persistent grid of 2-CTA clusters, one CTA an SM (twelve warps).  A
//     cluster owns tiles of 128 output rows of one batch row (so TMA's bounds
//     mask the end of each utterance), the two CTAs 256 channels each: per
//     row the pair holds all 512 channels, and each CTA streams only its half
//     of the weight.  One lane of warp 8, the producer, feeds a ring through
//     full/empty mbarriers; the tiles are 128-byte swizzled and zero outside
//     (a ragged tile's rows, the K and Cout tails add nothing).  Warps 0-3
//     and 4-7 are two consumer warpgroups of 64 rows, the f32 accumulator
//     [64 x 256] in registers (setmaxnreg 40 / 232).  The producer runs on
//     into the next tile while the consumers finish this one.
//   * bfloat16: a stage is one (tap, 64-channel chunk) of the K loop: the
//     patch rows [128 x 64] by TMA from tap j's own tensor map (x + j*Cin
//     viewed as [B][T_out][Cin] with rows s*Cin apart) and the weight [64 x
//     256] from w viewed as [k][Cin][Cout]; wgmma m64n256k16, A K-major and
//     the weight MN-major from the same swizzled descriptors; four stages.
//   * float32, 3xTF32: each f32 operand v is split into tf32 hi = rna(v) and
//     lo = rna(v - hi), and each product is lo.hi + hi.lo + hi.hi with f32
//     sums (the dropped lo.lo is below 2^-22 of it).  tf32 wgmma reads only
//     K-major operands and TMA cannot transpose, so the weight is prepared
//     once per version of it, outside the kernel (ops/conv_frontend.py
//     `kernel_weight_tf32`): K-major [Cout][k*Cin], split, as [2][Cout][k*Cin]
//     (hi, lo), with its tensor map encoded once and kept by the caller.  The
//     patches come raw by TMA from one map over the overlapping view
//     [B][T_out][k*Cin] (rows s*Cin apart: no limit on k), 32 K columns (one
//     128-byte swizzle row) a stage, and the consumers split them in
//     registers into A fragments: wgmma m64n256k8 with A from registers, 12
//     a stage.  Shared memory: a stage is the patches [128][32] (16 KB) and
//     the weight's hi and lo [256][32] (32 KB each), 80 KB; two stages (160
//     KB) beside the staging rows (18 KB), the LayerNorm vectors (3 KB), the
//     exchange and the mbarriers: 187,552 of the 232,448 bytes a block may
//     use (a third stage does not fit).  The accumulator runs through the
//     whole K loop undrained: a second [64 x 256] one to drain into would
//     not fit beside it in 232 registers, and the truncation of the tensor
//     cores' f32 sums (576 of them a row at layer 1) stays inside the JAX
//     package's 2e-4 / 1e-3 (measured at layer 1's full shape, PERF.md).
//   * LayerNorm spans the cluster: each warp sums its 16 rows over its 256
//     channels (conv bias added, channels past Cout left out), stores the
//     sums into the peer CTA's shared memory (mapa, st.shared::cluster) and
//     arrives on the peer warp's mbarrier (release.cluster); it waits on
//     its own (acquire.cluster) for the peer's.  Twice: the mean, then the
//     squared deviations about it (the two-pass variance).  A barrier a
//     warp and a pass, so the exchange never waits on a whole CTA.
//   * The epilogue (normalize, scale, shift, GELU: erff, or the tanh form by
//     tanh.approx in bf16 and tanhf in f32) stages each warp's rows in shared
//     memory, 128 bytes of a row at a time, and stores whole 16-byte pieces,
//     masked by row and Cout.
// What holds the bf16 kernel above the bound (at layer 1 on an H100, about
// 1.6x): the larger part is the products' own rate, which the weight's and
// the patches' L2 traffic does not set (loading half of either barely moves
// it); the smaller part is the epilogue, which runs with the tensor cores
// idle (the accumulator fills the consumers' registers, so the next tile's
// products cannot start under it).  The float32 kernel runs at about 1.25-1.35x
// its 3xTF32 bound at layer 1 on an H100 (3.0-3.3 ms against 2.44): the same
// idle epilogue, and each consumer warpgroup loading and splitting a stage's
// A fragments between its products (the other warpgroup's products run
// meanwhile).  The measured times of both kernels stand in PERF.md.

#include <cstdio>
#include <cstring>

#include "gated_attention.cuh"

namespace {

using namespace fddm;

constexpr int MAX_COUT = 512;
constexpr int MAX_TAPS = 16;  // the bf16 kernel's tensor maps in its parameters (128 bytes each)

constexpr int TILE_M = 128;         // output rows of a tile: two warpgroups of 64
constexpr int HALF_N = 256;         // channels of a CTA: one wgmma n256
constexpr int CONSUMER_WARPS = 8;   // warps 0-7, two warpgroups; warps 8-11 the producer's
constexpr int THREADS = (CONSUMER_WARPS + 4) * 32;
// setmaxnreg: __launch_bounds__(THREADS, 1) gives each of the 384 threads at
// most LAUNCH_REGS = 168 registers; the producer's warpgroup frees 128 x
// (168 - 40), which the consumers' increase takes whole.  An increase the
// freed registers cannot cover never returns, so the launcher refuses a
// build whose register count is not LAUNCH_REGS.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int REG_POOL = 128 * PRODUCER_REGS + CONSUMER_WARPS * 32 * CONSUMER_REGS;
static_assert(REG_POOL == LAUNCH_REGS * THREADS,
              "the consumers take exactly what the producer frees");
constexpr int STAGING_ROW = 144;  // a staging row: 128 bytes of output + 16 of padding
constexpr int STAGING_BYTES = 16 * STAGING_ROW;   // a consumer warp's 16 rows
constexpr int XCHG_FLOATS = 2 * 16;               // a warp's row sums from the peer: [pass][8][2]

// The shared memory of a kernel whose ring has `stages` stages of
// `stage_bytes`: the ring, the staging buffers, the CTA's conv bias /
// ln_scale / ln_bias, the exchanged sums, the ring's and the exchange's
// mbarriers, and slack to align the ring to 1024 bytes.
constexpr size_t smem_bytes(int stages, int stage_bytes) {
  return (size_t)stages * stage_bytes + CONSUMER_WARPS * STAGING_BYTES + 3 * HALF_N * 4 +
         CONSUMER_WARPS * XCHG_FLOATS * 4 + (2 * stages + 2 * CONSUMER_WARPS) * 8 + 1024;
}

// bfloat16: a stage is the patch rows [128][64] of one tap and the weight
// [64 k][256 channels] as four 64-channel swizzle atom columns.
constexpr int CHUNK = 64;  // input channels a ring stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int A_BYTES = TILE_M * CHUNK * 2;
constexpr int W_GROUP_BYTES = CHUNK * 64 * 2;
constexpr int W_BYTES = (HALF_N / 64) * W_GROUP_BYTES;
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
constexpr size_t SMEM_BYTES = smem_bytes(STAGES, STAGE_BYTES);
static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "tiles keep the 1024-byte swizzle alignment");
static_assert(SMEM_BYTES <= 232448, "fits an SM's shared memory");

// float32: a stage is 32 columns of K (= j*Cin + ci) of the patch rows
// [128][32] and of the weight's hi and lo [256][32].
constexpr int F_CHUNK = 32;  // one 128-byte swizzle row of f32
constexpr int F_STAGES = 2;
constexpr int F_A_BYTES = TILE_M * F_CHUNK * 4;
constexpr int F_W_BYTES = HALF_N * F_CHUNK * 4;
constexpr int F_STAGE_BYTES = F_A_BYTES + 2 * F_W_BYTES;  // 80 KB
constexpr size_t F_SMEM_BYTES = smem_bytes(F_STAGES, F_STAGE_BYTES);
static_assert(F_A_BYTES % 1024 == 0 && F_STAGE_BYTES % 1024 == 0,
              "tiles keep the 1024-byte swizzle alignment");
static_assert(F_SMEM_BYTES <= 232448, "fits an SM's shared memory");

// The bf16 kernel's tensor maps, a __grid_constant__ parameter: tap j's
// patch rows and the weight.
struct ConvMaps {
  CUtensorMap x[MAX_TAPS];  // x + j*Cin as [B][T_out][Cin], rows s*Cin and batch rows T*Cin apart
  CUtensorMap w;            // w as [k][Cin][Cout]
};

// The f32 kernel's: the patches and the weight's hi and lo.
struct ConvMapsF32 {
  CUtensorMap x;  // x as [B][T_out][k*Cin], rows s*Cin (overlapping) and batch rows T*Cin apart
  CUtensorMap w;  // the split weight as [2][Cout][k*Cin]
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of both CTAs: release what came before, acquire the peer's.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p`'s counterpart in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// Two floats into the peer's shared memory, then one arrive on the peer's
// mbarrier that releases them at cluster scope.
__device__ __forceinline__ void send_to_peer(uint32_t dst, float a, float b, uint32_t bar) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
               "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%3];\n"
               :: "r"(dst), "f"(a), "f"(b), "r"(bar) : "memory");
}

// mbar_wait with acquire at cluster scope: what the peer released is visible.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// GELU of the epilogue: erff, or the tanh form.  In bf16 the tanh form is
// five FP32 operations and one tanh.approx (MUFU), 0.5 v (1 + tanh(u)) with
// u = sqrt(2 / pi) (v + 0.044715 v^3); in f32 it is tanhf, whose error stays
// far inside the f32 tolerance.
template <typename OutT, bool kTanh>
__device__ __forceinline__ float gelu(float v) {
  if (kTanh) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    if (sizeof(OutT) == 4) return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    const float u = v * fmaf(c * 0.044715f, v * v, c);
    const float h = 0.5f * v;
    return fmaf(h, tanh_approx(u), h);
  }
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// Two adjacent outputs into a staging row.
__device__ __forceinline__ void stage_pair(uint8_t* p, float a, float b, bf16*) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void stage_pair(uint8_t* p, float a, float b, float*) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// What the consumers of both kernels share after the K loop: the cluster's
// LayerNorm exchange and the staged epilogue.  Made once a thread.
struct Epilogue {
  const float* vec;     // [3][HALF_N]: the CTA's conv bias, ln_scale, ln_bias (0 past Cout)
  float* my_sums;       // the warp's [pass][8][2] row sums, written by the peer
  uint64_t* xbar;       // the warp's [pass] mbarriers
  uint8_t* stage_buf;   // the warp's staging rows
  uint32_t peer_sums, peer_bar;
  int lane, g, t4, lr0, n0, valid_j, Cout, T_out;
  float inv_cout, eps;

  __device__ Epilogue(uint8_t* staging, float* vec_, float* xchg, uint64_t* xbar_all, int warp,
                      int lane_, uint32_t rank, int Cout_, int T_out_, float eps_)
      : vec(vec_), my_sums(xchg + warp * XCHG_FLOATS), xbar(xbar_all + 2 * warp),
        stage_buf(staging + warp * STAGING_BYTES), lane(lane_), g(lane_ >> 2), t4(lane_ & 3),
        lr0((warp >> 2) * 64 + (warp & 3) * 16), n0((int)rank * HALF_N),
        valid_j(min(HALF_N / 8, max(0, (Cout_ - (int)rank * HALF_N) / 8))), Cout(Cout_),
        T_out(T_out_), inv_cout(1.f / (float)Cout_), eps(eps_) {
    const uint32_t peer = rank ^ 1u;
    peer_sums = peer_addr(my_sums, peer) + 8 * g;  // this lane's pair, pass 0
    peer_bar = peer_addr(xbar, peer);
  }

  // Row sums over the CTA's channels -> the whole row's, through the peer:
  // lanes t = 0 send rows g and g + 8 and take the peer's, then share them
  // with their quad.  own + peer in one order in both CTAs.
  __device__ __forceinline__ void row_totals(int pass, uint32_t parity, float& s0, float& s1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (t4 == 0) {
      send_to_peer(peer_sums + pass * 64, s0, s1, peer_bar + pass * 8);
      mbar_wait_cluster(&xbar[pass], parity);
      const float2 p = *reinterpret_cast<const float2*>(my_sums + pass * 16 + 2 * g);
      s0 += p.x;
      s1 += p.y;
    }
    s0 = __shfl_sync(0xffffffffu, s0, lane & ~3);
    s1 = __shfl_sync(0xffffffffu, s1, lane & ~3);
  }

  // The warp's 16 rows of the tile at (b, t0): conv bias, LayerNorm,
  // scale, shift, GELU, stored.  `parity`: the tile's count in this CTA, mod 2.
  template <typename OutT, bool kTanh>
  __device__ __forceinline__ void run(float (&acc)[32][4], OutT* out, int b, int t0,
                                      uint32_t parity) {
    float s0 = 0.f, s1 = 0.f;  // pass 0: conv bias, then the mean
    #pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 c = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * t4);
      acc[j][0] += c.x; acc[j][1] += c.y; acc[j][2] += c.x; acc[j][3] += c.y;
      if (j < valid_j) {
        s0 += acc[j][0] + acc[j][1];
        s1 += acc[j][2] + acc[j][3];
      }
    }
    row_totals(0, parity, s0, s1);
    const float mean0 = s0 * inv_cout, mean1 = s1 * inv_cout;
    float q0 = 0.f, q1 = 0.f;  // pass 1: squared deviations about the mean
    #pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc[j][0] -= mean0; acc[j][1] -= mean0; acc[j][2] -= mean1; acc[j][3] -= mean1;
      if (j < valid_j) {
        q0 += acc[j][0] * acc[j][0] + acc[j][1] * acc[j][1];
        q1 += acc[j][2] * acc[j][2] + acc[j][3] * acc[j][3];
      }
    }
    row_totals(1, parity, q0, q1);
    const float rstd0 = rsqrtf(q0 * inv_cout + eps), rstd1 = rsqrtf(q1 * inv_cout + eps);

    // normalize, scale, shift, GELU; a staging row (128 bytes: 64 bf16 or 32
    // f32 channels) at a time, stored as whole 16-byte pieces of rows
    constexpr int PASS_CH = 128 / (int)sizeof(OutT);
    constexpr int PIECE = 16 / (int)sizeof(OutT);
    const int rows_left = T_out - t0;
    OutT* out_tile = out + ((size_t)b * T_out + t0) * Cout;
    #pragma unroll
    for (int ch = 0; ch < HALF_N / PASS_CH; ++ch) {
      if (n0 + ch * PASS_CH >= Cout) break;
      #pragma unroll
      for (int jj = 0; jj < PASS_CH / 8; ++jj) {
        const int j = ch * (PASS_CH / 8) + jj;
        const float2 sc = *reinterpret_cast<const float2*>(vec + HALF_N + 8 * j + 2 * t4);
        const float2 sh = *reinterpret_cast<const float2*>(vec + 2 * HALF_N + 8 * j + 2 * t4);
        const int col = (8 * jj + 2 * t4) * (int)sizeof(OutT);
        stage_pair(stage_buf + g * STAGING_ROW + col,
                   gelu<OutT, kTanh>(fmaf(acc[j][0] * rstd0, sc.x, sh.x)),
                   gelu<OutT, kTanh>(fmaf(acc[j][1] * rstd0, sc.y, sh.y)), out);
        stage_pair(stage_buf + (g + 8) * STAGING_ROW + col,
                   gelu<OutT, kTanh>(fmaf(acc[j][2] * rstd1, sc.x, sh.x)),
                   gelu<OutT, kTanh>(fmaf(acc[j][3] * rstd1, sc.y, sh.y)), out);
      }
      __syncwarp();
      // 16 rows x 8 pieces: lane takes piece lane % 8 of rows lane / 8 + 4 r
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = lr0 + lane / 8 + 4 * r, c = n0 + ch * PASS_CH + (lane % 8) * PIECE;
        if (row < rows_left && c < Cout)
          *reinterpret_cast<uint4*>(out_tile + (size_t)row * Cout + c) =
              *reinterpret_cast<const uint4*>(stage_buf + (lane / 8 + 4 * r) * STAGING_ROW +
                                              (lane % 8) * 16);
      }
      __syncwarp();
    }
  }
};

// The prologue both kernels share: the ring's and the exchange's mbarriers,
// the CTA's vectors (0 past Cout), then a cluster barrier, so that both
// CTAs' mbarriers exist before either arrives on the peer's.
__device__ __forceinline__ void conv_prologue(uint64_t* full, uint64_t* empty, uint64_t* xbar,
                                              int stages, float* vec, const float* cb,
                                              const float* ln_scale, const float* ln_bias,
                                              int n0, int Cout) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);                // the producer's arrive + the bytes
      mbar_init(&empty[st], CONSUMER_WARPS);  // one arrive per consumer warp
    }
    for (int i = 0; i < 2 * CONSUMER_WARPS; ++i) mbar_init(&xbar[i], 8);  // the peer warp's 8 senders
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < HALF_N; i += THREADS) {
    const int c = n0 + i;
    const bool ok = c < Cout;
    vec[i] = ok && cb != nullptr ? cb[c] : 0.f;
    vec[HALF_N + i] = ok ? ln_scale[c] : 0.f;
    vec[2 * HALF_N + i] = ok ? ln_bias[c] : 0.f;
  }
  cluster_sync();
}

// ---------------------------------------------------------------- bfloat16
template <bool kTanh>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
conv_ln_gelu_bf16_kernel(const __grid_constant__ ConvMaps maps, const float* __restrict__ cb,
                         const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                         bf16* __restrict__ out, int B, int T_out, int Cin, int Cout, int ksize,
                         float eps) {
  extern __shared__ uint8_t smem_raw[];
  // the same offset in every CTA (the dynamic base is), so mapa finds the peer's arrays
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* staging = smem + STAGES * STAGE_BYTES;  // [CONSUMER_WARPS][16][STAGING_ROW]
  float* vec = reinterpret_cast<float*>(staging + CONSUMER_WARPS * STAGING_BYTES);  // [3][HALF_N]
  float* xchg = vec + 3 * HALF_N;  // [CONSUMER_WARPS][pass][8][2], written by the peer
  uint64_t* full = reinterpret_cast<uint64_t*>(xchg + CONSUMER_WARPS * XCHG_FLOATS);
  uint64_t* empty = full + STAGES;  // full[s]: the stage's tiles landed; empty[s]: all read
  uint64_t* xbar = empty + STAGES;  // [warp][pass]: the peer warp's row sums arrived

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank();
  const int n0 = (int)rank * HALF_N;  // the CTA's first channel
  const int clusters = gridDim.x / 2, cluster = blockIdx.x / 2;
  const int row_tiles = (T_out + TILE_M - 1) / TILE_M, tiles = B * row_tiles;
  const int chunks = (Cin + CHUNK - 1) / CHUNK, k_stages = ksize * chunks;

  conv_prologue(full, empty, xbar, STAGES, vec, cb, ln_scale, ln_bias, n0, Cout);

  if (warp >= CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      int it = 0;
      for (int tile = cluster; tile < tiles; tile += clusters) {
        const int b = tile / row_tiles, t0 = (tile - b * row_tiles) * TILE_M;
        for (int j = 0; j < ksize; ++j) {
          for (int c = 0; c < chunks; ++c, ++it) {
            const int st = it % STAGES;
            if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
            uint8_t* stage = smem + st * STAGE_BYTES;
            mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
            tma_load_3d(stage, &maps.x[j], &full[st], c * CHUNK, t0, b);
            #pragma unroll
            for (int g = 0; g < HALF_N / 64; ++g)
              tma_load_3d(stage + A_BYTES + g * W_GROUP_BYTES, &maps.w, &full[st],
                          n0 + g * 64, c * CHUNK, j);
          }
        }
      }
    }
    __syncwarp();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

    // Warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile, the warp 16 of
    // those; the thread holds rows g and g + 8 of the warp's at the CTA's
    // channels 8j + 2t and 8j + 2t + 1 (j = 0..31).
    const int wg = warp >> 2;
    Epilogue epi(staging, vec, xchg, xbar, warp, lane, rank, Cout, T_out, eps);
    float acc[32][4];
    #pragma unroll
    for (int j = 0; j < 32; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    int it = 0, i = 0;
    for (int tile = cluster; tile < tiles; tile += clusters, ++i) {
      const int b = tile / row_tiles, t0 = (tile - b * row_tiles) * TILE_M;
      for (int kb = 0; kb < k_stages; ++kb, ++it) {
        const int st = it % STAGES;
        mbar_wait(&full[st], (it / STAGES) & 1);
        const uint8_t* stage = smem + st * STAGE_BYTES;
        // A: K-major 128-byte rows, k16 = 32 bytes steps the descriptor by 2.
        // W: MN-major, four 64-channel atoms W_GROUP_BYTES apart (the
        // leading byte offset), 8-row groups 1024 bytes apart; k16 = 16 rows
        // = 2048 bytes steps it by 128.
        const uint64_t da = sw128_desc(stage + wg * 64 * 128, 16);
        const uint64_t db = sw128_desc(stage + A_BYTES, W_GROUP_BYTES);
        reg_fence_n256(acc);
        wgmma_fence();
        #pragma unroll
        for (int ks = 0; ks < CHUNK / 16; ++ks)
          wgmma_m64n256k16_bf16<1>(acc, da + 2 * ks, db + 128 * ks, kb > 0 || ks > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        reg_fence_n256(acc);
        if (kb > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }
      wgmma_wait<0>();
      reg_fence_n256(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      epi.run<bf16, kTanh>(acc, out, b, t0, i & 1);
    }
  }
  // no CTA leaves while its peer may still write into its shared memory
  cluster_sync();
}

// ----------------------------------------------------------------- float32
template <bool kTanh>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
conv_ln_gelu_tf32x3_kernel(const __grid_constant__ ConvMapsF32 maps, const float* __restrict__ cb,
                           const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                           float* __restrict__ out, int B, int T_out, int K, int Cout,
                           float eps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* staging = smem + F_STAGES * F_STAGE_BYTES;
  float* vec = reinterpret_cast<float*>(staging + CONSUMER_WARPS * STAGING_BYTES);
  float* xchg = vec + 3 * HALF_N;
  uint64_t* full = reinterpret_cast<uint64_t*>(xchg + CONSUMER_WARPS * XCHG_FLOATS);
  uint64_t* empty = full + F_STAGES;
  uint64_t* xbar = empty + F_STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank();
  const int n0 = (int)rank * HALF_N;
  const int clusters = gridDim.x / 2, cluster = blockIdx.x / 2;
  const int row_tiles = (T_out + TILE_M - 1) / TILE_M, tiles = B * row_tiles;
  const int k_stages = (K + F_CHUNK - 1) / F_CHUNK;

  conv_prologue(full, empty, xbar, F_STAGES, vec, cb, ln_scale, ln_bias, n0, Cout);

  if (warp >= CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      int it = 0;
      for (int tile = cluster; tile < tiles; tile += clusters) {
        const int b = tile / row_tiles, t0 = (tile - b * row_tiles) * TILE_M;
        for (int kb = 0; kb < k_stages; ++kb, ++it) {
          const int st = it % F_STAGES;
          if (it >= F_STAGES) mbar_wait(&empty[st], (it / F_STAGES - 1) & 1);
          uint8_t* stage = smem + st * F_STAGE_BYTES;
          mbar_arrive_expect_tx(&full[st], F_STAGE_BYTES);
          tma_load_3d(stage, &maps.x, &full[st], kb * F_CHUNK, t0, b);
          tma_load_3d(stage + F_A_BYTES, &maps.w, &full[st], kb * F_CHUNK, n0, 0);
          tma_load_3d(stage + F_A_BYTES + F_W_BYTES, &maps.w, &full[st], kb * F_CHUNK, n0, 1);
        }
      }
    }
    __syncwarp();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

    // The thread's rows of the tile: r0 and r0 + 8, as in the bf16 kernel.
    Epilogue epi(staging, vec, xchg, xbar, warp, lane, rank, Cout, T_out, eps);
    const int r0 = epi.lr0 + epi.g, t = epi.t4;
    float acc[32][4];
    #pragma unroll
    for (int j = 0; j < 32; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    int it = 0, i = 0;
    for (int tile = cluster; tile < tiles; tile += clusters, ++i) {
      const int b = tile / row_tiles, t0 = (tile - b * row_tiles) * TILE_M;
      for (int kb = 0; kb < k_stages; ++kb, ++it) {
        const int st = it % F_STAGES;
        mbar_wait(&full[st], (it / F_STAGES) & 1);
        const uint8_t* stage = smem + st * F_STAGE_BYTES;
        // the patches' four k-slices as tf32 hi and lo A fragments: rows r0
        // and r0 + 8, columns 8 ks + t and 8 ks + t + 4 (conflict-free: the
        // swizzle puts the 8 rows of a load in 8 different bank groups)
        uint32_t ah[4][4], al[4][4];
        #pragma unroll
        for (int ks = 0; ks < F_CHUNK / 8; ++ks) {
          const int c = 8 * ks + t;
          tf32_split(*reinterpret_cast<const float*>(stage + tf_sw(r0, c)), ah[ks][0], al[ks][0]);
          tf32_split(*reinterpret_cast<const float*>(stage + tf_sw(r0 + 8, c)), ah[ks][1],
                     al[ks][1]);
          tf32_split(*reinterpret_cast<const float*>(stage + tf_sw(r0, c + 4)), ah[ks][2],
                     al[ks][2]);
          tf32_split(*reinterpret_cast<const float*>(stage + tf_sw(r0 + 8, c + 4)), ah[ks][3],
                     al[ks][3]);
        }
        // the weight's hi and lo [256 channels][32 k], K-major 128-byte rows:
        // a k8 slice (32 bytes) steps the descriptor by 2
        const uint64_t dwh = sw128_desc(stage + F_A_BYTES, 16);
        const uint64_t dwl = sw128_desc(stage + F_A_BYTES + F_W_BYTES, 16);
        reg_fence_n256(acc);
        wgmma_fence();
        #pragma unroll
        for (int ks = 0; ks < F_CHUNK / 8; ++ks) {  // the small terms first
          wgmma_m64n256k8_tf32(acc, al[ks], dwh + 2 * ks, kb > 0 || ks > 0);
          wgmma_m64n256k8_tf32(acc, ah[ks], dwl + 2 * ks, 1);
          wgmma_m64n256k8_tf32(acc, ah[ks], dwh + 2 * ks, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();  // the fragments' registers and the stage are free again
        reg_fence_n256(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
      epi.run<float, kTanh>(acc, out, b, t0, i & 1);
    }
  }
  cluster_sync();
}

// The launch of a cluster kernel: per device, the shared-memory opt-in, the
// register check and the clusters that fit at once (`fit`, the kernel's
// own); a persistent grid of at most that many clusters, on the caller's
// stream.
constexpr int MAX_DEVICES = 64;

template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int* fit, size_t smem, int tiles, cudaStream_t stream,
                            Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (fit[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    // setmaxnreg's budgets balance only at LAUNCH_REGS registers a thread:
    // with fewer, the consumers' increase would wait forever
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * THREADS != REG_POOL) {
      fprintf(stderr,
              "conv_ln_gelu: the kernel was built with %d registers a thread; its "
              "setmaxnreg budgets (%d / %d) need %d\n",
              attr.numRegs, PRODUCER_REGS, CONSUMER_REGS, LAUNCH_REGS);
      return cudaErrorLaunchOutOfResources;
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(2);
    config.blockDim = dim3(THREADS);
    config.dynamicSmemBytes = smem;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel),
                                         &config);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    fit[dev] = clusters;
  }
  const int grid = 2 * (tiles < fit[dev] ? tiles : fit[dev]);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <bool kTanh>
cudaError_t launch_bf16(const ConvMaps& maps, const float* cb, const float* ln_scale,
                        const float* ln_bias, bf16* out, int B, int T_out, int Cin, int Cout,
                        int ksize, float eps, cudaStream_t stream) {
  static int fit[MAX_DEVICES] = {};
  return launch_clusters(conv_ln_gelu_bf16_kernel<kTanh>, fit, SMEM_BYTES,
                         B * ((T_out + TILE_M - 1) / TILE_M), stream, maps, cb, ln_scale,
                         ln_bias, out, B, T_out, Cin, Cout, ksize, eps);
}

template <bool kTanh>
cudaError_t launch_f32(const ConvMapsF32& maps, const float* cb, const float* ln_scale,
                       const float* ln_bias, float* out, int B, int T_out, int K, int Cout,
                       float eps, cudaStream_t stream) {
  static int fit[MAX_DEVICES] = {};
  return launch_clusters(conv_ln_gelu_tf32x3_kernel<kTanh>, fit, F_SMEM_BYTES,
                         B * ((T_out + TILE_M - 1) / TILE_M), stream, maps, cb, ln_scale,
                         ln_bias, out, B, T_out, K, Cout, eps);
}

// The checks both entry points make; T_out, or 0 if the shape is refused.
int out_rows(int B, int T, int Cin, int Cout, int ksize, int stride) {
  if (B <= 0 || T < ksize || ksize <= 0 || stride <= 0) return 0;
  if (Cin <= 0 || Cin % 8 != 0 || Cout <= 0 || Cout % 8 != 0 || Cout > MAX_COUT) return 0;
  const int T_out = (T - ksize) / stride + 1;
  if ((long long)B * T_out > 0x7fffffffLL - 64 || (long long)ksize * Cin > 0x7fffffffLL) return 0;
  return T_out;
}

}  // namespace

extern "C" {

// bfloat16: x [B, T, Cin] channels-last, w [k*Cin, Cout] (row j*Cin + ci);
// cb [Cout] f32 or null, ln_scale and ln_bias [Cout] f32; out [B, T_out,
// Cout] bf16, T_out = (T - k) / s + 1 >= 1.  Cin and Cout multiples of 8,
// Cout <= 512, k <= MAX_TAPS.  Pointers 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 = launched), or the error that
// kept it from launching.
int fddm_conv_ln_gelu_bf16(const void* x, const void* w, const void* cb, const void* ln_scale,
                           const void* ln_bias, void* out, int B, int T, int Cin, int Cout,
                           int ksize, int stride, int tanh_form, float eps, void* stream) {
  const int T_out = out_rows(B, T, Cin, Cout, ksize, stride);
  if (T_out == 0 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  ConvMaps maps;
  memset(&maps, 0, sizeof(maps));
  // tap j: x[b, t*s + j, :] at x + j*Cin + b*T*Cin + t*s*Cin.  Offset and
  // strides are multiples of 16 bytes (Cin % 8 == 0); the last element,
  // x[B-1, (T_out-1)*s + j, Cin-1], lies inside x as (T_out-1)*s + k <= T.
  for (int j = 0; j < ksize; ++j) {
    if (!encode_3d_strided(&maps.x[j], static_cast<const bf16*>(x) + (long long)j * Cin, Cin,
                           T_out, B, (uint64_t)stride * Cin * 2, (uint64_t)T * Cin * 2, CHUNK,
                           TILE_M))
      return (int)cudaErrorInvalidValue;
  }
  if (!encode_3d_strided(&maps.w, w, Cout, Cin, ksize, (uint64_t)Cout * 2,
                         (uint64_t)Cin * Cout * 2, 64, CHUNK))
    return (int)cudaErrorInvalidValue;
  const float* cbf = static_cast<const float*>(cb);
  const float* lsf = static_cast<const float*>(ln_scale);
  const float* lbf = static_cast<const float*>(ln_bias);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(tanh_form ? launch_bf16<true>(maps, cbf, lsf, lbf, o, B, T_out, Cin, Cout, ksize,
                                             eps, s)
                         : launch_bf16<false>(maps, cbf, lsf, lbf, o, B, T_out, Cin, Cout, ksize,
                                              eps, s));
}

// The tensor map of the float32 kernel's weight, encoded into `map` (host
// memory, room for one CUtensorMap): w_split [2][Cout][K] f32, the tf32 hi
// and lo of the weight K-major (row n: channel n's K = k*Cin values, j*Cin +
// ci), 16-byte aligned, K a multiple of 4.  It depends on nothing but the
// pointer and the sizes, so the caller keeps it for as long as it keeps the
// operand.  The stream is not used.  Returns 0, or cudaErrorInvalidValue.
int fddm_conv_ln_gelu_tf32_weight_map(const void* w_split, int Cout, int K, void* map,
                                      void* /*stream*/) {
  if (Cout <= 0 || Cout > MAX_COUT || K <= 0 || K % 4 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  if (!encode_3d_strided(&m, w_split, K, Cout, 2, (uint64_t)K * 4, (uint64_t)Cout * K * 4,
                         F_CHUNK, HALF_N, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return (int)cudaErrorInvalidValue;
  memcpy(map, &m, sizeof(m));
  return 0;
}

// float32: x [B, T, Cin] channels-last; `w_map` the weight's map
// (fddm_conv_ln_gelu_tf32_weight_map, over k*Cin columns and Cout rows); cb,
// ln_scale, ln_bias as in bfloat16; out [B, T_out, Cout] f32.  Any k.
// Returns as the bfloat16 entry point.
int fddm_conv_ln_gelu_f32(const void* x, const void* w_map, const void* cb, const void* ln_scale,
                          const void* ln_bias, void* out, int B, int T, int Cin, int Cout,
                          int ksize, int stride, int tanh_form, float eps, void* stream) {
  const int T_out = out_rows(B, T, Cin, Cout, ksize, stride);
  if (T_out == 0) return (int)cudaErrorInvalidValue;
  const int K = ksize * Cin;
  ConvMapsF32 maps;
  memcpy(&maps.w, w_map, sizeof(CUtensorMap));
  // output row t of batch row b: the K = k*Cin values at x + (b*T + t*s)*Cin.
  // Strides are multiples of 32 bytes (Cin % 8 == 0); the last element,
  // x[B-1, (T_out-1)*s + k - 1, Cin-1], lies inside x as (T_out-1)*s + k <= T.
  if (!encode_3d_strided(&maps.x, x, K, T_out, B, (uint64_t)stride * Cin * 4,
                         (uint64_t)T * Cin * 4, F_CHUNK, TILE_M, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return (int)cudaErrorInvalidValue;
  const float* cbf = static_cast<const float*>(cb);
  const float* lsf = static_cast<const float*>(ln_scale);
  const float* lbf = static_cast<const float*>(ln_bias);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(tanh_form ? launch_f32<true>(maps, cbf, lsf, lbf, o, B, T_out, K, Cout, eps, s)
                         : launch_f32<false>(maps, cbf, lsf, lbf, o, B, T_out, K, Cout, eps, s));
}

}  // extern "C"
