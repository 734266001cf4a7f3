// Fused dynamic-int8 dense layer for Hopper (sm_90a).
//
//   sx[m]    = max(max_k |x[m, k]|, eps) * (1 / 127)              (f32)
//   xq[m, k] = clip(round_half_even(x[m, k] / sx[m]), -127, 127)   (int8)
//   out[m, n] = (float(sum_k xq[m, k] * wq[n, k]) * sx[m]) * sw[n] + bias[n]
//
// Replaces the TPU kernel `_fused_kernel` of fddm_asr_tpu/ops/quant.py
// (reached through `int8_matmul_fused`).  The weights arrive quantized per
// output channel (wq [N, K] int8, the nn.Linear layout, K contiguous; sw [N]
// f32), as on the TPU, where the weight quantization stays outside the
// kernel too.  The TPU quantizes a row block once, at j == 0, into VMEM
// scratch and sweeps N against it; here each row is quantized once too, but
// into a device workspace (xq [M, K] int8, sx [M] f32, allocated by the
// caller), so that the product's tiles need not hold the whole of K and the
// weight is reused across a 2-D tile loop.
//
// One launch in two phases, on a persistent grid of at most one block an SM
// (twelve warps), launched cooperatively so that every block is resident (a
// block waits on rows that other blocks quantize):
//   1. quantize, all twelve warps.  Warp w of the grid takes the w-th of W
//      runs of consecutive row groups (four rows a group where K <= 1024 in
//      bf16, else one).  A lane loads its chunks of the group's rows into
//      64 registers, all loads in flight at once, so a row is read once up
//      to K = 4096 in bf16 (2048 in f32; longer rows are read twice); amax
//      on packed bf16 pairs; the divide is a reciprocal and two
//      exact-residual corrections (div_rn), the round half to even an f32
//      add of 1.5 x 2^23.  At the end of its run's share of a row tile a
//      warp makes its stores visible to the async proxy (TMA reads them)
//      and adds its row count to the tile's counter with a release.
//   2. product.  Output tiles of 128 rows x 256 columns, in groups of 8 row
//      tiles with the row fastest (so the blocks running at once share
//      weight tiles in L2), tile t to block t mod G.  Warps 8-11 hand their
//      registers to warps 0-7 (setmaxnreg 40 / 232).  One lane of warp 8,
//      the producer, loads a tile's sw and bias (1-d TMA, two tiles'
//      worth of buffers) and acquires the row tile's counter before the
//      tile's first stage, then feeds a four-stage ring: xq [128 rows
//      x 128 bytes] and wq [256 rows x 128 bytes] by TMA, 128-byte
//      swizzled, zero outside M, N and K (so a K tail adds nothing to the
//      integer sums), with a full and an empty mbarrier per stage.  Warps
//      0-3 and 4-7 are two consumer warpgroups of 64 rows each: wgmma
//      m64n256k32 s8 x s8 -> s32, the accumulator in registers, one stage's
//      products in flight while the next stage is waited for; the row
//      scales are loaded under the products.  The epilogue multiplies and
//      adds in separately rounded f32 steps (__fmul_rn, __fadd_rn: never
//      contracted into an FMA), so f32 outputs are those of the plain
//      PyTorch version bit for bit, stages them per warp in shared memory
//      and stores whole 16-byte pieces of rows, while the producer already
//      fills the ring with the next tile.
// The counters live in a buffer the caller keeps per device and stream
// (zeroed once): the last block to finish sets the ones this call used back
// to 0, so no call needs a memset.  The tensor maps of wq, sw and bias are
// encoded once per weight (fddm_int8_matmul_fused_weight_maps) and kept by
// the caller; a call encodes only the workspace's.
//
// What bounds it: at M = 8192, K = 1024, N = 4096 (bf16 in and out) 2 M K N
// = 68.7 G integer operations against 88 MB moved: operations, 0.035 ms at
// the card's dense int8 peak; at K = N = 1024 the 16 MB of x and 16 MB of
// out set it (bytes).  What holds it above that: the quantize phase (x in,
// xq out and back through L2) runs before the products, the epilogue's
// conversions run with the tensor cores idle, and the operand stream of
// 128 x 256 tiles asks more of L2 than the peak rate would.  Measured
// times, and the designs tried and dropped, stand in PERF.md.

#include <cstdio>
#include <cstring>

#include "gated_attention.cuh"

namespace {

using fddm::bf16;

constexpr int TILE_M = 128;        // rows of an output tile (two warpgroups of 64)
constexpr int TILE_N = 256;        // columns: one wgmma n256
constexpr int STAGE_K = 128;       // bytes of K per ring stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMER_WARPS = 8;  // warps 0-7, two warpgroups; warps 8-11 the producer's
constexpr int THREADS = (CONSUMER_WARPS + 4) * 32;
// setmaxnreg: __launch_bounds__(THREADS, 1) lets ptxas give each of the 384
// threads at most LAUNCH_REGS = 168 registers; the producer's warpgroup
// frees 128 x (168 - 40), which the consumers' increase takes whole.  An
// increase the freed registers cannot cover never returns, so launch()
// refuses a build whose register count is not LAUNCH_REGS.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int REG_POOL = 128 * PRODUCER_REGS + CONSUMER_WARPS * 32 * CONSUMER_REGS;
static_assert(REG_POOL == LAUNCH_REGS * THREADS,
              "the consumers take exactly what the producer frees");
constexpr int GROUP_M = 8;         // row tiles per raster group
constexpr int A_BYTES = TILE_M * STAGE_K;
constexpr int B_BYTES = TILE_N * STAGE_K;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGING_ROW = 144;   // a staging row: 128 bytes of output + 16 of padding
constexpr int STAGING_BYTES = 16 * STAGING_ROW;  // a consumer warp's 16 rows
constexpr int VEC_BYTES = TILE_N * 4;            // a tile's sw or bias (f32)
// the ring, the consumer warps' staging buffers, sw and bias of two tiles,
// 2 x STAGES + 4 mbarriers, and slack to align the ring to 1024 bytes
constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES + CONSUMER_WARPS * STAGING_BYTES +
                              4 * VEC_BYTES + (2 * STAGES + 4) * 8 + 1024;
static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "tiles keep the 1024-byte swizzle alignment");
static_assert((CONSUMER_WARPS * STAGING_BYTES) % 128 == 0, "TMA writes sw and bias 128-aligned");

// A lane's chunk of a row: 16 elements, 16 * sizeof(T) bytes as 16-byte words.
template <typename T>
struct Chunk { uint4 w[sizeof(T)]; };

template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& r, const T* p) {
  #pragma unroll
  for (int i = 0; i < (int)sizeof(T); ++i) r.w[i] = reinterpret_cast<const uint4*>(p)[i];
}

__device__ __forceinline__ void to_floats(const Chunk<float>& r, float v[16]) {
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[4 * i] = __uint_as_float(r.w[i].x); v[4 * i + 1] = __uint_as_float(r.w[i].y);
    v[4 * i + 2] = __uint_as_float(r.w[i].z); v[4 * i + 3] = __uint_as_float(r.w[i].w);
  }
}

__device__ __forceinline__ void to_floats(const Chunk<bf16>& r, float v[16]) {
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.w[i]);
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
// The rounding is an f32 add of 1.5 * 2^23, where the ulp is 1: the sum is
// the clipped quotient rounded half to even, held in the low mantissa bits
// (two's complement in the low byte), which a byte permute packs.  FP32
// adds rather than float-to-int conversions, which issue at an eighth of
// their rate.  A NaN quotient gives 0 (as a conversion would).
__device__ __forceinline__ uint32_t quantize4(const float* v, float scale, float inv) {
  uint32_t b[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = div_rn(v[i], scale, inv);
    const float c = q == q ? fminf(fmaxf(q, -127.f), 127.f) : 0.f;
    b[i] = __float_as_uint(__fadd_rn(c, 12582912.f));
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// max |v| over a lane's chunk (exact: a max of magnitudes rounds nothing)
__device__ __forceinline__ float chunk_absmax(const Chunk<float>& r) {
  float m = 0.f;
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    m = fmaxf(fmaxf(fmaxf(m, fabsf(__uint_as_float(r.w[i].x))), fabsf(__uint_as_float(r.w[i].y))),
              fmaxf(fabsf(__uint_as_float(r.w[i].z)), fabsf(__uint_as_float(r.w[i].w))));
  return m;
}

__device__ __forceinline__ float chunk_absmax(const Chunk<bf16>& r) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.w);
  __nv_bfloat162 m = __habs2(h[0]);
  #pragma unroll
  for (int i = 1; i < 8; ++i) m = __hmax2(m, __habs2(h[i]));
  const float2 f = __bfloat1622float2(m);
  return fmaxf(f.x, f.y);
}

__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// TMA: the box at c0 of a 1-d tensor map, its bytes counted on the mbarrier.
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(fddm::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(fddm::smem_addr(bar)), "r"(c0)
      : "memory");
}

// Output tile t -> (row tile, column tile): groups of GROUP_M row tiles, the
// row fastest within a group, so that consecutive tiles share a weight tile.
__device__ __forceinline__ void tile_coords(int t, int row_tiles, int col_tiles, int& m,
                                            int& n) {
  const int group = t / (GROUP_M * col_tiles);
  const int first = group * GROUP_M;
  const int rows = min(row_tiles - first, GROUP_M);
  const int r = t - group * GROUP_M * col_tiles;
  m = first + r % rows;
  n = r / rows;
}

// Spin until row tile m's counter reads `rows` (acquire), then order the
// async proxy's coming reads of xq after it.
__device__ __forceinline__ void wait_rows(const unsigned* counter, unsigned rows) {
  unsigned seen;
  while (true) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    if (seen >= rows) break;
    __nanosleep(64);
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Phase 1 for one warp: rows r0 .. r0 + ROWS - 1 of x into xq and sx.  A
// lane holds CH chunks of each row in registers (64 registers in all), all
// loads in flight at once: where the row fits (K <= 512 CH) it is read
// once, amax and quantize from the registers; a longer row is read in
// slices, twice.  A row past M
// repeats row M - 1 in the loads and is never stored.
template <typename TIn, int ROWS, int CH>
__device__ __forceinline__ void quantize_rows(const TIn* __restrict__ x, int8_t* xq, float* sx,
                                              int r0, int M, int K, float eps, int lane) {
  constexpr int SLICE = CH * 512;
  const TIn* src[ROWS];
  Chunk<TIn> raw[ROWS][CH];
  float amax[ROWS], scale[ROWS], inv[ROWS];
  #pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    src[u] = x + (size_t)min(r0 + u, M - 1) * K;
    amax[u] = 0.f;
  }
  auto load_slice = [&](int s) {
    #pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = s + i * 512 + lane * 16;
      #pragma unroll
      for (int u = 0; u < ROWS; ++u)
        if (c < K) load_chunk(raw[u][i], src[u] + c);
    }
  };
  for (int s = 0; s < K; s += SLICE) {
    load_slice(s);
    #pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (s + i * 512 + lane * 16 >= K) continue;
      #pragma unroll
      for (int u = 0; u < ROWS; ++u) amax[u] = fmaxf(amax[u], chunk_absmax(raw[u][i]));
    }
  }
  #pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax[u] = fmaxf(amax[u], __shfl_xor_sync(0xffffffffu, amax[u], off));
    scale[u] = __fmul_rn(fmaxf(amax[u], eps), static_cast<float>(1.0 / 127.0));
    inv[u] = __frcp_rn(scale[u]);
    if (lane == 0 && r0 + u < M) sx[r0 + u] = scale[u];
  }
  const bool held = K <= SLICE;  // the one slice is still in the registers
  for (int s = 0; s < K; s += SLICE) {
    if (!held) load_slice(s);
    #pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = s + i * 512 + lane * 16;
      if (c >= K) continue;
      #pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        float v[16];
        to_floats(raw[u][i], v);
        const uint4 q = make_uint4(
            quantize4(v, scale[u], inv[u]), quantize4(v + 4, scale[u], inv[u]),
            quantize4(v + 8, scale[u], inv[u]), quantize4(v + 12, scale[u], inv[u]));
        if (r0 + u < M) *reinterpret_cast<uint4*>(xq + (size_t)(r0 + u) * K + c) = q;
      }
    }
  }
}

// Count `rows` quantized rows into row tile `tile`: this lane's stores
// before the async proxy's reads (TMA) and before lane 0's release.
__device__ __forceinline__ void publish(unsigned* arrived, int tile, int rows, int lane) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __threadfence();
  __syncwarp();
  if (lane == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
                 :: "l"(arrived + tile), "r"(rows) : "memory");
}

// Phase 1 for the block's warps: warp w of the grid takes the w-th of W
// runs of consecutive row groups of ROWS rows (their lengths differ by one
// at most), and publishes each row tile's share once (a run meets one or
// two row tiles).
template <typename TIn, int ROWS, int CH>
__device__ __forceinline__ void quantize_share(const TIn* __restrict__ x, int8_t* xq, float* sx,
                                               unsigned* arrived, int M, int K, float eps,
                                               int warp, int lane) {
  static_assert(TILE_M % ROWS == 0, "a row group lies in one row tile");
  constexpr int WARPS = THREADS / 32;
  const long long groups = (M + ROWS - 1) / ROWS, warps = gridDim.x * WARPS;
  const long long w = blockIdx.x * WARPS + warp;
  const int g0 = (int)(w * groups / warps), g1 = (int)((w + 1) * groups / warps);
  int tile = -1, rows = 0;
  for (int grp = g0; grp < g1; ++grp) {
    const int r0 = grp * ROWS;
    if (r0 / TILE_M != tile) {
      if (rows > 0) publish(arrived, tile, rows, lane);
      tile = r0 / TILE_M;
      rows = 0;
    }
    quantize_rows<TIn, ROWS, CH>(x, xq, sx, r0, M, K, eps, lane);
    rows += min(ROWS, M - r0);
  }
  if (rows > 0) publish(arrived, tile, rows, lane);
}

// The epilogue of one warp: its 16 rows (row0 = the first, in the output;
// the thread's two row scales s0, s1) x the tile's 256 columns from col0,
// sw and bias from shared memory.  (f32(acc) * sx) * sw + bias in
// separately rounded steps, then through the warp's staging buffer (16 rows
// of 128 bytes, padded to 144 so that the fragment writes hit distinct
// banks) in chunks of 128 bytes of columns, each chunk stored as whole
// 16-byte pieces of rows (rows past M and columns past N left out).
template <typename TOut>
__device__ __forceinline__ void store_tile(const int (&acc)[32][4], uint8_t* stage_buf,
                                           const float* vec_sw, const float* vec_bias,
                                           float s0, float s1, TOut* __restrict__ out,
                                           int row0, int col0, int M, int N, int lane) {
  constexpr int CHUNK = 128 / sizeof(TOut);  // columns a chunk: 64 bf16 or 32 f32
  constexpr int PER = 16 / sizeof(TOut);     // columns a 16-byte piece
  const int g = lane >> 2, t4 = lane & 3;
  const bool vec_ok = (N % PER) == 0;  // rows start on 16-byte boundaries
  #pragma unroll
  for (int ch = 0; ch < TILE_N / CHUNK; ++ch) {
    #pragma unroll
    for (int jj = 0; jj < CHUNK / 8; ++jj) {
      const int j = ch * (CHUNK / 8) + jj;
      const float2 w = *reinterpret_cast<const float2*>(vec_sw + 8 * j + 2 * t4);
      const float2 b = vec_bias != nullptr
                           ? *reinterpret_cast<const float2*>(vec_bias + 8 * j + 2 * t4)
                           : make_float2(0.f, 0.f);
      float y[4];
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = __fmul_rn(__fmul_rn(static_cast<float>(acc[j][e]), e < 2 ? s0 : s1),
                            (e & 1) ? w.y : w.x);
        if (vec_bias != nullptr) v = __fadd_rn(v, (e & 1) ? b.y : b.x);
        y[e] = v;
      }
      TOut* r_lo = reinterpret_cast<TOut*>(stage_buf + g * STAGING_ROW);
      TOut* r_hi = reinterpret_cast<TOut*>(stage_buf + (g + 8) * STAGING_ROW);
      store_pair(r_lo + 8 * jj + 2 * t4, y[0], y[1]);
      store_pair(r_hi + 8 * jj + 2 * t4, y[2], y[3]);
    }
    __syncwarp();
    // 16 rows x 8 pieces: lane takes piece lane % 8 of rows lane / 8 + 4i
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lane / 8 + 4 * i, piece = lane % 8;
      const int row = row0 + r, c = col0 + ch * CHUNK + piece * PER;
      if (row < M && c < N) {
        const uint8_t* src = stage_buf + r * STAGING_ROW + piece * 16;
        TOut* dst = out + (size_t)row * N + c;
        if (vec_ok && c + PER <= N) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < PER && c + e < N; ++e) dst[e] = reinterpret_cast<const TOut*>(src)[e];
        }
      }
    }
    __syncwarp();
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_fused_kernel(const __grid_constant__ CUtensorMap tm_xq,
                         const __grid_constant__ CUtensorMap tm_wq,
                         const __grid_constant__ CUtensorMap tm_sw,
                         const __grid_constant__ CUtensorMap tm_bias, int has_bias,
                         const TIn* __restrict__ x, int8_t* xq, float* sx, unsigned* sync,
                         TOut* __restrict__ out, int M, int K, int N, float eps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (fddm::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* staging = smem + STAGES * STAGE_BYTES;  // [CONSUMER_WARPS][16][STAGING_ROW]
  float* vec = reinterpret_cast<float*>(staging + CONSUMER_WARPS * STAGING_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(vec + 4 * TILE_N);  // vec: [2 tiles][sw, bias][256]
  uint64_t* empty = full + STAGES;  // full[s]: the stage's tiles landed; empty[s]: all read
  uint64_t* vfull = empty + STAGES;  // the same for a tile's sw and bias, by tile parity
  uint64_t* vempty = vfull + 2;
  unsigned* done = sync;            // blocks finished
  unsigned* arrived = sync + 1;     // rows quantized, per row tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_tiles = (M + TILE_M - 1) / TILE_M, col_tiles = (N + TILE_N - 1) / TILE_N;
  const int tiles = row_tiles * col_tiles;
  const int k_stages = (K + STAGE_K - 1) / STAGE_K;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      fddm::mbar_init(&full[st], 1);                // the producer's arrive + the bytes
      fddm::mbar_init(&empty[st], CONSUMER_WARPS);  // one arrive per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      fddm::mbar_init(&vfull[b], 1);
      fddm::mbar_init(&vempty[b], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- phase 1: quantize, all twelve warps.  64 registers of a row
  // group's chunks a lane: four rows a group where they fit (K <= 1024 in
  // bf16, 512 in f32), else one.
  constexpr int HELD = 256 / (16 * (int)sizeof(TIn));  // chunks: 8 bf16, 4 f32
  if (K <= (HELD / 4) * 512)
    quantize_share<TIn, 4, HELD / 4>(x, xq, sx, arrived, M, K, eps, warp, lane);
  else
    quantize_share<TIn, 1, HELD>(x, xq, sx, arrived, M, K, eps, warp, lane);

  // ---- phase 2: the product
  if (warp >= CONSUMER_WARPS) {
    // The producer's warpgroup gives its registers to the consumers (faster
    // on the card than without); one lane of warp 8 issues every load.  A tile's sw and bias go out first,
    // then each stage's weight tile; its rows' tile waits for the row
    // tile's counter (first stage of a tile only).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      int it = 0, i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        int m, n;
        tile_coords(t, row_tiles, col_tiles, m, n);
        const int vb = i & 1;
        if (i >= 2) fddm::mbar_wait(&vempty[vb], ((i >> 1) - 1) & 1);
        fddm::mbar_arrive_expect_tx(&vfull[vb], (has_bias ? 2 : 1) * VEC_BYTES);
        tma_load_1d(vec + vb * 2 * TILE_N, &tm_sw, &vfull[vb], n * TILE_N);
        if (has_bias) tma_load_1d(vec + (vb * 2 + 1) * TILE_N, &tm_bias, &vfull[vb], n * TILE_N);
        for (int kb = 0; kb < k_stages; ++kb, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) fddm::mbar_wait(&empty[st], (it / STAGES - 1) & 1);
          uint8_t* stage = smem + st * STAGE_BYTES;
          // the acquire comes before the arrive (a release), so the
          // consumers' reads of sx after the full barrier are ordered after
          // the quantizing warps' release
          if (kb == 0) wait_rows(arrived + m, min(TILE_M, M - m * TILE_M));
          fddm::mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
          fddm::tma_load_2d(stage + A_BYTES, &tm_wq, &full[st], kb * STAGE_K, n * TILE_N);
          fddm::tma_load_2d(stage, &tm_xq, &full[st], kb * STAGE_K, m * TILE_M);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

    // Warpgroup wg owns rows 64 wg .. 64 wg + 63
    // of the tile, the warp 16 of those; the thread holds rows g and g + 8
    // of them at columns 8j + 2t and 8j + 2t + 1 (j = 0..31).
    const int wg = warp >> 2;
    const int lr = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    uint8_t* stage_buf = staging + warp * STAGING_BYTES;
    int acc[32][4];
    #pragma unroll
    for (int j = 0; j < 32; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    int it = 0, i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      int m, n;
      tile_coords(t, row_tiles, col_tiles, m, n);
      float s0 = 0.f, s1 = 0.f;
      for (int kb = 0; kb < k_stages; ++kb, ++it) {
        const int st = it % STAGES;
        fddm::mbar_wait(&full[st], (it / STAGES) & 1);
        if (kb == 0) {  // the row tile is quantized: its scales travel under the products
          const int r = m * TILE_M + lr;
          s0 = r < M ? __ldcg(sx + r) : 0.f;
          s1 = r + 8 < M ? __ldcg(sx + r + 8) : 0.f;
        }
        const uint8_t* stage = smem + st * STAGE_BYTES;
        // K-major 128-byte rows: k32 (32 bytes) steps the descriptor by 2
        const uint64_t da = fddm::sw128_desc(stage + wg * 64 * STAGE_K, 16);
        const uint64_t db = fddm::sw128_desc(stage + A_BYTES, 16);
        fddm::reg_fence(acc);
        fddm::wgmma_fence();
        #pragma unroll
        for (int ks = 0; ks < STAGE_K / 32; ++ks)
          fddm::wgmma_m64n256k32_s8(acc, da + 2 * ks, db + 2 * ks, kb > 0 || ks > 0);
        fddm::wgmma_commit();
        fddm::wgmma_wait<1>();  // the previous stage's products are done
        fddm::reg_fence(acc);
        if (kb > 0) {
          __syncwarp();
          if (lane == 0) fddm::mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }
      fddm::wgmma_wait<0>();
      fddm::reg_fence(acc);
      __syncwarp();
      if (lane == 0) fddm::mbar_arrive(&empty[(it - 1) % STAGES]);

      const int vb = i & 1;
      fddm::mbar_wait(&vfull[vb], (i >> 1) & 1);
      const float* vec_sw = vec + vb * 2 * TILE_N;
      store_tile(acc, stage_buf, vec_sw, has_bias ? vec_sw + TILE_N : nullptr, s0, s1, out,
                 m * TILE_M + wg * 64 + (warp & 3) * 16, n * TILE_N, M, N, lane);
      __syncwarp();
      if (lane == 0) fddm::mbar_arrive(&vempty[vb]);
    }

    // the last block to finish sets this call's counters back to 0 for the
    // next (its producer is done with them: it acquired every row tile
    // before the loads its consumers have now used)
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_WARPS * 32) : "memory");
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(done, 1u) == gridDim.x - 1) {
        __threadfence();
        for (int r = 0; r < row_tiles; ++r) arrived[r] = 0;
        *done = 0;
      }
    }
  }
}

// A tensor map over an f32 vector of n elements in boxes of TILE_N, zero past n.
bool encode_vec(CUtensorMap* map, const void* base, int n) {
  const fddm::EncodeTiledFn fn = fddm::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t unused[1] = {16};  // a rank-1 map has no stride
  const cuuint32_t box[1] = {TILE_N};
  const cuuint32_t unit[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims, unused,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename TIn, typename TOut>
cudaError_t launch(const CUtensorMap (&maps)[4], int has_bias, const void* x, void* xq,
                   void* sx, void* sync, void* out, int M, int K, int N, float eps,
                   cudaStream_t stream) {
  auto kernel = int8_matmul_fused_kernel<TIn, TOut>;
  // per device: the shared-memory opt-in, the register check, the SM count
  // and blocks an SM
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {}, per_sm[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
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
              "int8_matmul_fused: the kernel was built with %d registers a thread; its "
              "setmaxnreg budgets (%d / %d) need %d\n",
              attr.numRegs, PRODUCER_REGS, CONSUMER_REGS, LAUNCH_REGS);
      return cudaErrorLaunchOutOfResources;
    }
    int count = 0, occupancy = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kernel, THREADS,
                                                        SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (occupancy < 1) return cudaErrorInvalidConfiguration;
    per_sm[dev] = occupancy;
    sms[dev] = count;
  }
  const int tiles = ((M + TILE_M - 1) / TILE_M) * ((N + TILE_N - 1) / TILE_N);
  const int grid = tiles < sms[dev] * per_sm[dev] ? tiles : sms[dev] * per_sm[dev];
  const TIn* x_ = static_cast<const TIn*>(x);
  int8_t* xq_ = static_cast<int8_t*>(xq);
  float* sx_ = static_cast<float*>(sx);
  unsigned* sync_ = static_cast<unsigned*>(sync);
  TOut* out_ = static_cast<TOut*>(out);
  void* args[] = {const_cast<CUtensorMap*>(&maps[0]), const_cast<CUtensorMap*>(&maps[1]),
                  const_cast<CUtensorMap*>(&maps[2]), const_cast<CUtensorMap*>(&maps[3]),
                  &has_bias, &x_, &xq_, &sx_, &sync_, &out_, &M, &K, &N, &eps};
  // cooperative: every block resident at once, or the launch is refused
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(THREADS), args, SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tensor maps of a weight, encoded into `maps` (host memory, room for
// three CUtensorMap): wq [N, K] int8, sw [N] f32 and bias [N] f32 (or null:
// its map is left zero).  They depend on nothing but these pointers and
// sizes, so the caller keeps them for as long as it keeps the weight.  The
// stream is not used.  Returns 0, or cudaErrorInvalidValue.
int fddm_int8_matmul_fused_weight_maps(const void* wq, const void* sw, const void* bias,
                                       int K, int N, void* maps, void* /*stream*/) {
  if (K <= 0 || N <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap m[3] = {};
  if (!fddm::encode_s8_sw128(&m[0], wq, K, N, TILE_N) || !encode_vec(&m[1], sw, N) ||
      (bias != nullptr && !encode_vec(&m[2], bias, N)))
    return (int)cudaErrorInvalidValue;
  memcpy(maps, m, sizeof(m));
  return 0;
}

// x [M, K] (in_dtype: 0 = float32, 1 = bfloat16) times the weight whose maps
// `weight_maps` holds (fddm_int8_matmul_fused_weight_maps; has_bias: its
// bias map is set), out [M, N] (out_dtype likewise); the workspace xq
// [M, K] int8 and sx [M] f32; sync [1 + ceil(M / 128)] u32, all 0 before the
// call and left so (kept by the caller across calls on one stream).  K must
// be a multiple of 16 (16-byte rows); pointers 16-byte aligned.  Returns the
// launch's error (0 = launched).
int fddm_int8_matmul_fused(const void* x, const void* weight_maps, int has_bias, void* out,
                           void* xq, void* sx, void* sync, int M, int K, int N,
                           int in_dtype, int out_dtype, float eps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];  // xq, then the weight's wq, sw, bias
  if (!fddm::encode_s8_sw128(&maps[0], xq, K, M, TILE_M)) return (int)cudaErrorInvalidValue;
  memcpy(&maps[1], weight_maps, 3 * sizeof(CUtensorMap));
  has_bias = has_bias != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return (int)launch<float, float>(maps, has_bias, x, xq, sx, sync, out, M, K, N, eps, s);
  if (in_dtype == 0 && out_dtype == 1)
    return (int)launch<float, bf16>(maps, has_bias, x, xq, sx, sync, out, M, K, N, eps, s);
  if (in_dtype == 1 && out_dtype == 0)
    return (int)launch<bf16, float>(maps, has_bias, x, xq, sx, sync, out, M, K, N, eps, s);
  if (in_dtype == 1 && out_dtype == 1)
    return (int)launch<bf16, bf16>(maps, has_bias, x, xq, sx, sync, out, M, K, N, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
