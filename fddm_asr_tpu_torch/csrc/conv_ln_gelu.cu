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
// t*s + j: the conv is a sum over taps of products [rows, Cin] x [Cin, Cout]
// whose A operand has row stride s*Cin.  The TPU's reshape gather, its
// 32-row tile from the next block, its zero-padded phantom tile and the
// reframing of the waveform layer are Mosaic's needs and are not carried
// over.  Any s and any k are taken (not only k - s <= s); the bfloat16 kernel
// takes k <= MAX_TAPS.
//
// What bounds it: layer 1 of WavLM-large at 8 x 20 s (rows = 255992, k*Cin =
// 1536, Cout = 512, bf16) is 403 GFLOP against 0.79 GB moved: operations,
// 0.41 ms at the card's dense bf16 peak; so are layers 2-6.  The design
// answers with the Hopper GEMM shape:
//   * bfloat16 (the main path): a persistent grid of 2-CTA clusters, one CTA
//     an SM (twelve warps).  A cluster owns tiles of 128 output rows of one
//     batch row (so TMA's bounds mask the end of each utterance), the two
//     CTAs 256 channels each: per row the pair holds all 512 channels, and
//     each CTA streams only its half of the weight.  One lane of warp 8, the
//     producer, feeds a four-stage ring through full/empty mbarriers; a
//     stage is one (tap, 64-channel chunk) of the K loop: the patch rows
//     [128 x 64] by TMA from tap j's own tensor map (x + j*Cin viewed as
//     [B][T_out][Cin] with rows s*Cin apart: no im2col, no overlapping
//     rows) and the weight [64 x 256] from w viewed as
//     [k][Cin][Cout], both 128-byte swizzled and zero outside (a ragged
//     tile's rows, Cin and Cout tails add nothing).  Warps 0-3 and 4-7 are
//     two consumer warpgroups of 64 rows: wgmma m64n256k16, A K-major and the
//     weight MN-major from the same swizzled descriptors, the f32
//     accumulator in registers (setmaxnreg 40 / 232).  The producer runs on
//     into the next tile while the consumers finish this one.
//   * LayerNorm spans the cluster: each warp sums its 16 rows over its 256
//     channels (conv bias added, channels past Cout left out), stores the
//     sums into the peer CTA's shared memory (mapa, st.shared::cluster) and
//     arrives on the peer warp's mbarrier (release.cluster); it waits on
//     its own (acquire.cluster) for the peer's.  Twice: the mean, then the
//     squared deviations about it (the two-pass variance).  A barrier a
//     warp and a pass, so the exchange never waits on a whole CTA.
//   * The epilogue (normalize, scale, shift, GELU: erff, or tanh by
//     tanh.approx) stages each warp's rows in shared memory and stores
//     whole 16-byte pieces, masked by row and Cout.
//   * float32: exact f32 scalar FMAs, 32 rows a block, 256 threads each an
//     8 x 8 register tile, synchronous loads.
// What holds the bf16 kernel above the bound (at layer 1 on an H100, about
// 1.6x): the larger part is the products' own rate, which the weight's and
// the patches' L2 traffic does not set (loading half of either barely moves
// it); the smaller part is the epilogue, which runs with the tensor cores
// idle (the accumulator fills the consumers' registers, so the next tile's
// products cannot start under it).  The measured times stand in PERF.md.

#include <cstdio>
#include <cstring>

#include "gated_attention.cuh"

namespace {

using namespace fddm;

constexpr int MAX_COUT = 512;
constexpr int MAX_TAPS = 16;  // tensor maps in the kernel's parameters (128 bytes each)

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
constexpr int TILE_M = 128;         // output rows of a tile: two warpgroups of 64
constexpr int HALF_N = 256;         // channels of a CTA: one wgmma n256
constexpr int CHUNK = 64;           // input channels a ring stage: one 128-byte swizzle row
constexpr int STAGES = 4;
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
constexpr int A_BYTES = TILE_M * CHUNK * 2;       // patch rows [128][64]
constexpr int W_GROUP_BYTES = CHUNK * 64 * 2;     // weight [64 k][64 channels]: one swizzle atom column
constexpr int W_BYTES = (HALF_N / 64) * W_GROUP_BYTES;
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
constexpr int STAGING_ROW = 144;  // a staging row: 128 bytes of output + 16 of padding
constexpr int STAGING_BYTES = 16 * STAGING_ROW;   // a consumer warp's 16 rows
constexpr int XCHG_FLOATS = 2 * 16;               // a warp's row sums from the peer: [pass][8][2]
// the ring, the staging buffers, the CTA's conv bias / ln_scale / ln_bias,
// the exchanged sums, the ring's and the exchange's mbarriers, and slack to
// align the ring to 1024 bytes
constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES + CONSUMER_WARPS * STAGING_BYTES +
                              3 * HALF_N * 4 + CONSUMER_WARPS * XCHG_FLOATS * 4 +
                              (2 * STAGES + 2 * CONSUMER_WARPS) * 8 + 1024;
static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "tiles keep the 1024-byte swizzle alignment");
static_assert(SMEM_BYTES <= 232448, "fits an SM's shared memory");

// The kernel's tensor maps, a __grid_constant__ parameter: tap j's patch rows
// and the weight.
struct ConvMaps {
  CUtensorMap x[MAX_TAPS];  // x + j*Cin as [B][T_out][Cin], rows s*Cin and batch rows T*Cin apart
  CUtensorMap w;            // w as [k][Cin][Cout]
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

// gelu() of the bf16 kernel's epilogue: the tanh form in five FP32
// operations and one tanh.approx (MUFU), 0.5 v (1 + tanh(u)) with
// u = sqrt(2 / pi) (v + 0.044715 v^3); or erff.
template <bool kTanh>
__device__ __forceinline__ float gelu_bf16_path(float v) {
  if (kTanh) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    const float u = v * fmaf(c * 0.044715f, v * v, c);
    const float h = 0.5f * v;
    return fmaf(h, tanh_approx(u), h);
  }
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

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

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);                // the producer's arrive + the bytes
      mbar_init(&empty[st], CONSUMER_WARPS);  // one arrive per consumer warp
    }
    for (int i = 0; i < 2 * CONSUMER_WARPS; ++i) mbar_init(&xbar[i], 8);  // the peer warp's 8 senders
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < HALF_N; i += THREADS) {  // zero past Cout
    const int c = n0 + i;
    const bool ok = c < Cout;
    vec[i] = ok && cb != nullptr ? cb[c] : 0.f;
    vec[HALF_N + i] = ok ? ln_scale[c] : 0.f;
    vec[2 * HALF_N + i] = ok ? ln_bias[c] : 0.f;
  }
  cluster_sync();  // both CTAs' mbarriers exist before either arrives on the peer's

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
    // those (from lr0); the thread holds rows lr0 + g and lr0 + g + 8 at the
    // CTA's channels 8j + 2t and 8j + 2t + 1 (j = 0..31).
    const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
    const int lr0 = wg * 64 + (warp & 3) * 16;
    const int valid_j = min(HALF_N / 8, max(0, (Cout - n0) / 8));  // column tiles below Cout
    uint8_t* stage_buf = staging + warp * STAGING_BYTES;
    float* my_sums = xchg + warp * XCHG_FLOATS;
    const uint32_t peer = rank ^ 1u;
    const uint32_t peer_sums = peer_addr(my_sums, peer) + 8 * g;  // this lane's pair, pass 0
    const uint32_t peer_bar = peer_addr(&xbar[2 * warp], peer);
    const float inv_cout = 1.f / (float)Cout;
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

      // Row sums over the CTA's channels -> the whole row's, through the
      // peer: lanes t = 0 send rows g and g + 8 and take the peer's, then
      // share them with their quad.  own + peer in one order in both CTAs.
      auto row_totals = [&](int pass, float& s0, float& s1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        if (t4 == 0) {
          send_to_peer(peer_sums + pass * 64, s0, s1, peer_bar + pass * 8);
          mbar_wait_cluster(&xbar[2 * warp + pass], i & 1);
          const float2 p = *reinterpret_cast<const float2*>(my_sums + pass * 16 + 2 * g);
          s0 += p.x;
          s1 += p.y;
        }
        s0 = __shfl_sync(0xffffffffu, s0, lane & ~3);
        s1 = __shfl_sync(0xffffffffu, s1, lane & ~3);
      };

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
      row_totals(0, s0, s1);
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
      row_totals(1, q0, q1);
      const float rstd0 = rsqrtf(q0 * inv_cout + eps), rstd1 = rsqrtf(q1 * inv_cout + eps);

      // normalize, scale, shift, GELU; 64 channels at a time through the
      // warp's staging rows, stored as whole 16-byte pieces of rows
      const int rows_left = T_out - t0;
      bf16* out_tile = out + ((size_t)b * T_out + t0) * Cout;
      #pragma unroll
      for (int ch = 0; ch < HALF_N / 64; ++ch) {
        if (n0 + ch * 64 >= Cout) break;
        #pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = ch * 8 + jj;
          const float2 sc = *reinterpret_cast<const float2*>(vec + HALF_N + 8 * j + 2 * t4);
          const float2 sh = *reinterpret_cast<const float2*>(vec + 2 * HALF_N + 8 * j + 2 * t4);
          const float y0 = gelu_bf16_path<kTanh>(fmaf(acc[j][0] * rstd0, sc.x, sh.x));
          const float y1 = gelu_bf16_path<kTanh>(fmaf(acc[j][1] * rstd0, sc.y, sh.y));
          const float y2 = gelu_bf16_path<kTanh>(fmaf(acc[j][2] * rstd1, sc.x, sh.x));
          const float y3 = gelu_bf16_path<kTanh>(fmaf(acc[j][3] * rstd1, sc.y, sh.y));
          *reinterpret_cast<uint32_t*>(stage_buf + g * STAGING_ROW + (8 * jj + 2 * t4) * 2) =
              pack_bf16(y0, y1);
          *reinterpret_cast<uint32_t*>(stage_buf + (g + 8) * STAGING_ROW + (8 * jj + 2 * t4) * 2) =
              pack_bf16(y2, y3);
        }
        __syncwarp();
        // 16 rows x 8 pieces: lane takes piece lane % 8 of rows lane / 8 + 4 r
        #pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = lr0 + lane / 8 + 4 * r, c = n0 + ch * 64 + (lane % 8) * 8;
          if (row < rows_left && c < Cout)
            *reinterpret_cast<uint4*>(out_tile + (size_t)row * Cout + c) =
                *reinterpret_cast<const uint4*>(stage_buf + (lane / 8 + 4 * r) * STAGING_ROW +
                                                (lane % 8) * 16);
        }
        __syncwarp();
      }
    }
  }
  // no CTA leaves while its peer may still write into its shared memory
  cluster_sync();
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


// The bf16 kernel's launch: per device, the shared-memory opt-in, the
// register check and the clusters that fit at once; a persistent grid of at
// most that many clusters, on the caller's stream.
template <bool kTanh>
cudaError_t launch_bf16(const ConvMaps& maps, const float* cb, const float* ln_scale,
                        const float* ln_bias, bf16* out, int B, int T_out, int Cin, int Cout,
                        int ksize, float eps, cudaStream_t stream) {
  auto kernel = conv_ln_gelu_bf16_kernel<kTanh>;
  constexpr int MAX_DEVICES = 64;
  static int fit[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (fit[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
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
    config.dynamicSmemBytes = SMEM_BYTES;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel),
                                         &config);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    fit[dev] = clusters;
  }
  const int tiles = B * ((T_out + TILE_M - 1) / TILE_M);
  const int grid = 2 * (tiles < fit[dev] ? tiles : fit[dev]);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(maps, cb, ln_scale, ln_bias, out, B, T_out, Cin,
                                                Cout, ksize, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, T, Cin] channels-last, w [k*Cin, Cout] (row j*Cin + ci), both of
// dtype (0 = float32, 1 = bfloat16); cb [Cout] f32 or null, ln_scale and
// ln_bias [Cout] f32; out [B, T_out, Cout] of dtype, T_out = (T - k) / s + 1
// >= 1.  Cin and Cout multiples of 8, Cout <= 512.  Pointers 16-byte
// aligned.  k <= MAX_TAPS in bfloat16.  Returns cudaGetLastError() after
// the launch (0 = launched), or the error that kept it from launching.
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
    if (ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
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
    bf16* o = static_cast<bf16*>(out);
    return (int)(tanh_form ? launch_bf16<true>(maps, cbf, lsf, lbf, o, B, T_out, Cin, Cout,
                                               ksize, eps, s)
                           : launch_bf16<false>(maps, cbf, lsf, lbf, o, B, T_out, Cin, Cout,
                                                ksize, eps, s));
  }
  if (dtype == 0) {
    conv_ln_gelu_f32_kernel<<<(rows + S_BM - 1) / S_BM, S_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), cbf, lsf, lbf,
        static_cast<float*>(out), rows, T, T_out, Cin, Cout, K, stride, eps, tanh_form);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
