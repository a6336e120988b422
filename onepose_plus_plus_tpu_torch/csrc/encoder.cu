// K1: one LoFTR linear-attention encoder layer (x attends to source), at
// C = 256 with 8 heads and bf16 operands (both coarse transformers of the
// configurations' bf16 paths).
//
// Replaces onepose_plus_plus_tpu/ops/pallas_encoder.py::fused_encoder_layer
// (_kv_stats_kernel + _apply_kernel). The TPU kernel carries the K'^T[V|1]
// sum across its sequential grid; Hopper blocks run in no order, so the
// layer is three launches:
//   1. a stats kernel: one block per (source tile, batch) projects K and V,
//      applies elu+1 and the masks, and writes that tile's per-head K'^T V and
//      sum K' ([hd + 1, C] partials: only the head-diagonal blocks).
//   2. a reduce kernel: sums the partials over tiles in a fixed order
//      (deterministic, no atomics).
//   3. an apply kernel: one block per (x tile, batch) runs the rest of the
//      layer in shared memory: Q projection, elu+1, msg = num / (den + 1e-6),
//      merge, LayerNorm, FFN over concat(x, msg) with ReLU, LayerNorm, residual.
// Every projection and FFN product is computed in the kernels' own bodies.
// x and source are f32; the operand type (bf16 here) is the type of the
// weights and of every product operand: as in the TPU kernel, each activation
// that enters a product (x, source, K', V, Q', K'^T[V|1], msg, LN1 out, FFN
// hidden) is rounded to it, products accumulate in f32, and the residual adds
// the f32 x. The output is f32.
//
// Bound: operations (20 C^2 per x row, 4 C^2 per source row; x in and y out
// are a third of that time in bytes at the tensor cores' rate).
//
// bf16 operands (C = 256, 8 heads: both coarse transformers): the tensor
// cores, by wgmma (wgmma.cuh). One warpgroup per block and 64 rows per tile.
// Activations live in shared memory as bf16 tiles in wgmma's unswizzled
// K-major core-matrix layout, which is also the layout the accumulator
// fragments write without bank conflicts (a quad holds 16 contiguous bytes of
// a row, eight quads a 128-byte core matrix). The weights are packed once on
// the host side into 32 KB chunks [256 out, 64 in] that are byte images of
// that layout, in the order the kernel consumes them, so a chunk arrives by
// one bulk copy (cp.async.bulk + mbarrier, no tensor map) into a ring of
// three or four stages, and a chunk's products stay in flight while the next
// chunk's are started. The tile's f32 rows arrive by a bulk copy too (an SM's
// own loads fetch 64 KB several times slower) and are rounded to bf16 from
// shared memory; the apply kernel stages them once more, during its last
// products, for the residual. The accumulators of one product (64 x 256 f32,
// 128 registers a thread) never leave registers: elu+1, the masks, the
// normalisation, ReLU and both LayerNorms (row sums by two quad shuffles) run
// on the fragments, written without branches, because a block has one warp
// per scheduler and only instruction-level parallelism hides latency. The
// attention product is per head Q'_h [64, 32] x [KV_h | sum K'_h | 0]
// (n = 40), so numerator and normaliser come from one product as on the TPU.
// The stats kernel stores K' and V transposed ([channel, source row]) so that
// K'^T V is a K-major product too: per pair of heads one m64 n64 product over
// the tile's 64 rows (its two head-diagonal 32 x 32 blocks are kept), and
// sum K' as a product with ones.
// What is left on the table: every 64-row tile streams all its weights from
// L2 (1 MB an apply tile), a block's products, epilogues and memory phases do
// not overlap (one block per SM, 224 KB of shared memory), and the partials
// make a round trip through device memory.
//
// f32 operands at this width, and both operand types at every other width,
// run the tensor-core chains of encoder_tcw_tf32.cu (split TF32) and
// encoder_tcw.cu (bf16).
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr float EPS = 1e-6f;
constexpr float LN_EPS = 1e-5f;
using opp::MAX_DEVICES;
using opp::raise_smem_limit;

// ---------------------------------------------------------------- bf16, wgmma

namespace tc {

namespace wg = opp::wg;

constexpr int C = 256, HD = 32, NH = 8;
constexpr int TM = 64;                          // rows of x or source per block
constexpr uint32_t A_LBO = 128, A_SBO = 4096;   // activation tile [64, 256]
constexpr uint32_t B_LBO = 128, B_SBO = 1024;   // weight chunk [256, 64]; K'^T and V^T tiles [256, 64]
constexpr uint32_t KV_SBO = 512;                // per-head [40, 32] block of K'^T[V|1]
constexpr uint32_t TILE_BYTES = TM * C * 2;     // 32768
constexpr uint32_t CHUNK_BYTES = C * 64 * 2;    // 32768
constexpr int KV_N = 40;                        // 32 value columns, the normaliser, 7 of padding
constexpr uint32_t KV_HEAD_BYTES = KV_N * HD * 2;       // 2560
constexpr uint32_t KV_BYTES = NH * KV_HEAD_BYTES;       // 20480
constexpr int APPLY_CHUNKS = 32, STATS_CHUNKS = 8;
constexpr int N_PART = (HD + 1) * C;            // one tile's partial: [hd + 1, C] f32

constexpr int APPLY_STAGES = 3, STATS_STAGES = 4;  // what fits beside the activation tiles

constexpr size_t APPLY_SMEM = 4 * TILE_BYTES + APPLY_STAGES * CHUNK_BYTES + 64;
constexpr size_t STATS_SMEM = 3 * TILE_BYTES + 1024 + STATS_STAGES * CHUNK_BYTES + 64;

// With -DOPP_K1_CLOCKS one block of each tensor-core kernel records clock64() at
// its phase boundaries (scripts/torch_k1_clocks.py builds that variant and prints
// the split): the only view inside the kernel where no kernel profiler runs.
#ifdef OPP_K1_CLOCKS
__device__ long long k1_clocks[32];  // apply kernel 0..12, stats kernel 16..24
#define OPP_TICK(i) \
  if (blockIdx.x == 40 && blockIdx.y == gridDim.y / 2 && threadIdx.x == 0) k1_clocks[i] = clock64()
#else
#define OPP_TICK(i)
#endif

// elu(x) + 1 of a value that is rounded to bf16 next, as 2^(min(x, 0) log2 e) +
// max(x, 0): exact x + 1 for x > 0, and within a few ulp of f32 below, far
// inside half a bf16 step. No comparison and no branch (expf has both, and
// the plain ex2.approx a denormal path), so a thread's 128 independent
// evaluations interleave: a block has one warp per scheduler and nothing else
// hides their latency.
__device__ __forceinline__ float elu_p1_fast(float x) {
  return wg::ex2_fast(fminf(x, 0.f) * 1.4426950408889634f) + fmaxf(x, 0.f);
}

// The ring of weight chunks: chunk c lands in stage c % NST; thread 0 starts the copies.
template <int NST, uint32_t CHUNK = CHUNK_BYTES>
struct Ring {
  uint32_t buf;              // shared address of stage 0
  unsigned char* buf_ptr;
  uint64_t* full;            // one mbarrier per stage
  const unsigned char* src;  // packed chunks in device memory, in order of use
  int n_chunks;
  int use;                   // next chunk to be multiplied

  __device__ __forceinline__ void fetch(int c) const {
    const int st = c % NST;
    wg::mbar_expect_tx(full + st, CHUNK);
    wg::bulk_load(buf_ptr + (size_t)st * CHUNK, src + (size_t)c * CHUNK, CHUNK, full + st);
  }
  // thread 0, before the block's first barrier: arm the barriers
  __device__ __forceinline__ void init() const {
    for (int i = 0; i < NST; ++i) wg::mbar_init(full + i, 1);
  }
};

// acc (+)= A[64, 256] * W^T for the ring's next four chunks (W [256 out, 256 in]).
template <int NST>
__device__ __forceinline__ void gemm_k256(float (&acc)[128], uint32_t a_addr, Ring<NST>& ring,
                                          bool accumulate) {
  // a chunk's products stay in flight while the next chunk's are started; a
  // stage is refilled once the chunk after it has been started (wait<1>) and
  // every warp has seen that
  const auto refill = [&](int done) {
    __syncthreads();
    if (threadIdx.x == 0 && done + NST < ring.n_chunks) ring.fetch(done + NST);
  };
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const int c = ring.use, st = c % NST;
    wg::mbar_wait(ring.full + st, (c / NST) & 1);
    const uint32_t b_addr = ring.buf + st * CHUNK_BYTES;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_n256(acc, wg::desc(a_addr + (q * 8 + kk * 2) * A_LBO, A_LBO, A_SBO),
                   wg::desc(b_addr + kk * 2 * B_LBO, B_LBO, B_SBO),
                   (accumulate || q > 0 || kk > 0) ? 1 : 0);
    wg::commit();
    if (q > 0) {
      wg::wait<1>();
      refill(c - 1);
    }
    ring.use = c + 1;
  }
  wg::wait<0>();
  refill(ring.use - 1);
  wg::fence_regs(acc);
}

// Accumulator fragments [64 rows, 256 columns] -> the transposed bf16 tile
// [256, 64] (K'^T, V^T). Lanes g and g ^ 1 hold neighbouring rows: they swap
// one value of each column pair, so that every thread stores two neighbouring
// rows of one column as one 4-byte word (32 banks a warp, no conflict).
template <typename F>
__device__ __forceinline__ void store_transposed(const float (&acc)[128], unsigned char* tile,
                                                 int r0, int g, int t, F value) {
  const bool odd = g & 1;
  // tile row d = 8 j + 2 t + odd (a channel), tile columns s, s + 1 (source rows)
  const int s = r0 & ~1;
  unsigned char* base = tile + (s >> 3) * B_LBO + (s & 7) * 2 + (2 * t + (odd ? 1 : 0)) * 16;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float v0 = value(acc[4 * j + 2 * half], half);      // column 8 j + 2 t
      const float v1 = value(acc[4 * j + 2 * half + 1], half);  // column 8 j + 2 t + 1
      const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
      *reinterpret_cast<__nv_bfloat162*>(base + j * B_SBO + half * B_LBO) =
          odd ? __floats2bfloat162_rn(got, v1) : __floats2bfloat162_rn(v0, got);
    }
}

// A tile's f32 rows reach shared memory by one bulk copy, not by the threads'
// loads: an SM keeps too few loads in flight to fetch 64 KB at the rate the
// copy engine does, and a block's first product waits for its tile. The rows
// [row0, row0 + 64) of src [n_rows, 256] that exist are contiguous; one thread
// calls this, and `bar` completes when they have landed in `stage`.
constexpr uint32_t ROW_BYTES = C * 4;

__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int row0, int n_rows,
                                           unsigned char* stage, uint64_t* bar) {
  const uint32_t bytes = min(TM, n_rows - row0) * ROW_BYTES;
  wg::mbar_expect_tx(bar, bytes);
  wg::bulk_load(stage, src + (size_t)row0 * C, bytes, bar);
}

// The staged f32 rows [64, 256], rounded to bf16, into an activation tile;
// rows from n_valid on are zeros. A lane moves four values at a time (16 bytes
// in, 8 out). Its place is chosen so that neither side has a bank conflict
// although both layouts have rows a multiple of 128 bytes apart: the eight
// lanes of a quarter warp read eight different 16-byte columns (of four rows),
// and the sixteen lanes of a half warp write the sixteen 8-byte slots of
// 128 bytes (eight rows of a core matrix, two slots each).
__device__ __forceinline__ void convert_rows(const unsigned char* stage, int n_valid,
                                             unsigned char* tile) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = lane & 7, h = (lane >> 3) & 1, q = lane >> 4;
  const int ro = ((i >> 1) ^ (2 * (w & 1) + q)) + 4 * h;  // row within its group of eight
#pragma unroll
  for (int it = 0; it < 32; ++it) {
    const int rg = it >> 2, m = (2 * it + (w >> 1)) & 7;  // row group, block of 32 columns
    const int row = rg * 8 + ro, k = 4 * (i + 8 * m);
    uint2 packed = make_uint2(0u, 0u);
    if (row < n_valid) {
      const float4 a = *reinterpret_cast<const float4*>(stage + row * ROW_BYTES + k * 4);
      __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w)};
      packed = *reinterpret_cast<const uint2*>(pair);
    }
    *reinterpret_cast<uint2*>(tile + rg * A_SBO + (k >> 3) * A_LBO + ro * 16 + (k & 7) * 2) = packed;
  }
}

// Where this thread's column pair (2 t, 2 t + 1) of `row` lies in an activation
// tile's first 8-column group; group kg is kg * A_LBO bytes further.
__device__ __forceinline__ unsigned char* row_base(unsigned char* tile, int row, int t) {
  return tile + (row >> 3) * A_SBO + (row & 7) * 16 + 4 * t;
}
// columns 8 kg + 2 t and 8 kg + 2 t + 1 of that row
__device__ __forceinline__ void store_pair(unsigned char* base, int kg, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(base + kg * A_LBO) = __floats2bfloat162_rn(a, b);
}

// LayerNorm over the 256 columns of each row, on the accumulator fragments:
// this thread holds 64 values of row g and 64 of row g + 8; its quad holds
// the rest.
__device__ __forceinline__ void layernorm_frag(float (&acc)[128], const float* __restrict__ scale,
                                               const float* __restrict__ bias, int t) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    s0 += acc[4 * j] + acc[4 * j + 1];
    s1 += acc[4 * j + 2] + acc[4 * j + 3];
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  const float m0 = s0 / C, m1 = s1 / C;
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float a = acc[4 * j] - m0, b = acc[4 * j + 1] - m0;
    const float c = acc[4 * j + 2] - m1, d = acc[4 * j + 3] - m1;
    v0 += a * a + b * b;
    v1 += c * c + d * d;
  }
  v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
  v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
  v0 += __shfl_xor_sync(0xffffffffu, v0, 2);
  v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
  const float r0 = rsqrtf(v0 / C + LN_EPS), r1 = rsqrtf(v1 / C + LN_EPS);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + 8 * j + 2 * t));
    const float2 bi = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
    acc[4 * j] = (acc[4 * j] - m0) * r0 * sc.x + bi.x;
    acc[4 * j + 1] = (acc[4 * j + 1] - m0) * r0 * sc.y + bi.y;
    acc[4 * j + 2] = (acc[4 * j + 2] - m1) * r1 * sc.x + bi.x;
    acc[4 * j + 3] = (acc[4 * j + 3] - m1) * r1 * sc.y + bi.y;
  }
}

// One block per (64-row source tile, batch element): part[b, tile] = this
// tile's [hd + 1, C] partial of K'^T V (rows 0..hd-1) and sum K' (row hd).
__global__ void __launch_bounds__(128, 1)
kv_partial_tc_kernel(const float* __restrict__ src, const unsigned char* __restrict__ wkv,
                     const float* __restrict__ smask, float* __restrict__ part, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xs = smem;                    // source tile
  unsigned char* kt = xs + TILE_BYTES;         // K'^T [256 channels, 64 rows]
  unsigned char* vt = kt + TILE_BYTES;         // V^T
  unsigned char* ones = vt + TILE_BYTES;       // [8, 64] of 1.0
  unsigned char* stage = kt;                   // the f32 source rows first: kt and vt
  unsigned char* ringb = ones + 1024;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ringb + STATS_STAGES * CHUNK_BYTES);
  uint64_t* srcbar = bars + STATS_STAGES;
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int s0 = tile * TM;

  OPP_TICK(16);
  Ring<STATS_STAGES> ring{wg::smem_u32(ringb), ringb, bars, wkv, STATS_CHUNKS, 0};
  if (tid == 0) {
    ring.init();
    wg::mbar_init(srcbar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  OPP_TICK(17);
  if (tid == 0) {
    stage_rows(src + (size_t)b * S * C, s0, S, stage, srcbar);
    for (int c = 0; c < STATS_STAGES; ++c) ring.fetch(c);
  }
  OPP_TICK(18);
  wg::mbar_wait(srcbar, 0);
  for (int i = tid; i < 256; i += 128) reinterpret_cast<uint32_t*>(ones)[i] = 0x3F803F80u;
  convert_rows(stage, S - s0, xs);
  wg::fence_proxy_async();
  __syncthreads();

  const int r0 = 16 * w + g, r1 = r0 + 8;
  float acc[128];
  OPP_TICK(19);
  // K' = (elu(src Wk) + 1) * mask, rows past S dropped (elu(0) + 1 = 1 otherwise)
  gemm_k256(acc, wg::smem_u32(xs), ring, false);
  OPP_TICK(20);
  {
    float m[2] = {s0 + r0 < S ? 1.f : 0.f, s0 + r1 < S ? 1.f : 0.f};
    if (smask != nullptr) {
      if (s0 + r0 < S) m[0] = smask[(size_t)b * S + s0 + r0];
      if (s0 + r1 < S) m[1] = smask[(size_t)b * S + s0 + r1];
    }
    store_transposed(acc, kt, r0, g, t,
                     [&](float v, int half) { return elu_p1_fast(v) * (half ? m[1] : m[0]); });
  }
  OPP_TICK(21);
  gemm_k256(acc, wg::smem_u32(xs), ring, false);
  OPP_TICK(22);
  store_transposed(acc, vt, r0, g, t, [](float v, int) { return v; });
  wg::fence_proxy_async();
  __syncthreads();
  OPP_TICK(23);

  // per pair of heads p: [64 channels d, 64 channels e] = K'^T V over the 64
  // rows; the two head-diagonal 32 x 32 blocks are the heads' K'^T V
  float* out = part + ((size_t)b * gridDim.x + tile) * N_PART;
#pragma unroll 1
  for (int p = 0; p < 4; ++p) {
    float kv[32], ks[4];
    const uint32_t a_addr = wg::smem_u32(kt) + p * 8 * B_SBO;
    const uint32_t b_addr = wg::smem_u32(vt) + p * 8 * B_SBO;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = wg::desc(a_addr + kk * 2 * B_LBO, B_LBO, B_SBO);
      wg::mma_n64(kv, da, wg::desc(b_addr + kk * 2 * B_LBO, B_LBO, B_SBO), kk > 0);
      wg::mma_n8(ks, da, wg::desc(wg::smem_u32(ones) + kk * 2 * B_LBO, B_LBO, B_SBO), kk > 0);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(kv);
    wg::fence_regs(ks);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((j >> 2) != (w >> 1)) continue;  // the other head of the pair
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = (8 * j + 2 * t + (i & 1)) & 31;
        const int d = 64 * p + ((i & 2) ? r1 : r0);
        out[(size_t)e * C + d] = kv[4 * j + i];
      }
    }
    if (t == 0) {
      out[(size_t)HD * C + 64 * p + r0] = ks[0];
      out[(size_t)HD * C + 64 * p + r1] = ks[2];
    }
  }
  OPP_TICK(24);
}

// kvimg[b]: per head the [40, 32] bf16 block [KV_h^T ; sum K'_h ; 0] in the
// apply kernel's B-operand layout, each entry the sum of the tiles' partials
// in tile order, rounded to bf16.
__global__ void kv_reduce_tc_kernel(const float* __restrict__ part,
                                    __nv_bfloat16* __restrict__ kvimg, int n_tiles) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // bf16 element of the image
  const int b = blockIdx.y;
  if (idx >= NH * KV_N * HD) return;
  const int h = idx / (KV_N * HD), rem = idx % (KV_N * HD);
  const int eg = rem / 256, dg = (rem % 256) / 64, er = (rem % 64) / 8, dr = rem % 8;
  const int e = eg * 8 + er, d = dg * 8 + dr;
  float a = 0.f;
  if (e <= HD) {
    const float* p = part + (size_t)b * n_tiles * N_PART + (size_t)e * C + h * HD + d;
    for (int tl = 0; tl < n_tiles; ++tl) a += p[(size_t)tl * N_PART];
  }
  kvimg[(size_t)b * (NH * KV_N * HD) + idx] = __float2bfloat16_rn(a);
}

// One block per (64-row x tile, batch element): the rest of the layer.
__global__ void __launch_bounds__(128, 1)
apply_tc_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ kvimg,
                const unsigned char* __restrict__ wpack, const float* __restrict__ ln1s,
                const float* __restrict__ ln1b, const float* __restrict__ ln2s,
                const float* __restrict__ ln2b, const float* __restrict__ qmask,
                float* __restrict__ y, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xs = smem;                  // x tile
  unsigned char* act = xs + TILE_BYTES;      // Q', then the LN1 output
  unsigned char* hid0 = act + TILE_BYTES;    // msg, then FFN hidden columns 0..255
  unsigned char* hid1 = hid0 + TILE_BYTES;   // FFN hidden columns 256..511
  unsigned char* stage = act;                // the f32 x rows first: act and hid0
  unsigned char* kvb = hid1;                 // K'^T[V|1], until the attention is done
  unsigned char* ringb = hid1 + TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ringb + APPLY_STAGES * CHUNK_BYTES);
  uint64_t* kvbar = bars + APPLY_STAGES;
  uint64_t* xbar = kvbar + 1;
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int l0 = tile * TM;
  const int r0 = 16 * w + g, r1 = r0 + 8;
  unsigned char *act0 = row_base(act, r0, t), *act1 = row_base(act, r1, t);

  OPP_TICK(0);
  Ring<APPLY_STAGES> ring{wg::smem_u32(ringb), ringb, bars, wpack, APPLY_CHUNKS, 0};
  if (tid == 0) {
    ring.init();
    wg::mbar_init(kvbar, 1);
    wg::mbar_init(xbar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  OPP_TICK(1);
  const float* xb = x + (size_t)b * L * C;
  if (tid == 0) {
    stage_rows(xb, l0, L, stage, xbar);
    for (int c = 0; c < APPLY_STAGES; ++c) ring.fetch(c);
    wg::mbar_expect_tx(kvbar, KV_BYTES);
    wg::bulk_load(kvb, kvimg + (size_t)b * (NH * KV_N * HD), KV_BYTES, kvbar);
  }
  OPP_TICK(2);
  wg::mbar_wait(xbar, 0);
  convert_rows(stage, L - l0, xs);
  wg::fence_proxy_async();
  __syncthreads();
  OPP_TICK(3);

  float acc[128];
  // Q' = (elu(x Wq) + 1) * mask
  gemm_k256(acc, wg::smem_u32(xs), ring, false);
  OPP_TICK(4);
  {
    float m0 = 1.f, m1 = 1.f;
    if (qmask != nullptr) {
      m0 = l0 + r0 < L ? qmask[(size_t)b * L + l0 + r0] : 0.f;
      m1 = l0 + r1 < L ? qmask[(size_t)b * L + l0 + r1] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      store_pair(act0, j, elu_p1_fast(acc[4 * j]) * m0, elu_p1_fast(acc[4 * j + 1]) * m0);
      store_pair(act1, j, elu_p1_fast(acc[4 * j + 2]) * m1, elu_p1_fast(acc[4 * j + 3]) * m1);
    }
  }
  wg::fence_proxy_async();
  __syncthreads();
  wg::mbar_wait(kvbar, 0);
  OPP_TICK(5);

  // msg_h = Q'_h KV_h / (Q'_h sum K'_h + 1e-6): columns 0..31 of the head's
  // product are the numerator, column 32 the normaliser; four heads at a time.
  // One reciprocal per row and head, then products: 16 divisions with their
  // slow-path branch would serialise
#pragma unroll 1
  for (int grp = 0; grp < 2; ++grp) {
    float sc[4][20];
    wg::fence();
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const int h = 4 * grp + hh;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wg::mma_n40(sc[hh],
                    wg::desc(wg::smem_u32(act) + (h * 4 + kk * 2) * A_LBO, A_LBO, A_SBO),
                    wg::desc(wg::smem_u32(kvb) + h * KV_HEAD_BYTES + kk * 2 * B_LBO, B_LBO, KV_SBO),
                    kk);
    }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      wg::fence_regs(sc[hh]);
      const int h = 4 * grp + hh;
      // column 32 of the row lives in the quad's first thread
      const float i0 = 1.f / (__shfl_sync(0xffffffffu, sc[hh][16], lane & ~3) + EPS);
      const float i1 = 1.f / (__shfl_sync(0xffffffffu, sc[hh][18], lane & ~3) + EPS);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // the head's columns start at group 4 h
        store_pair(row_base(hid0, r0, t), 4 * h + j, sc[hh][4 * j] * i0, sc[hh][4 * j + 1] * i0);
        store_pair(row_base(hid0, r1, t), 4 * h + j, sc[hh][4 * j + 2] * i1, sc[hh][4 * j + 3] * i1);
      }
    }
  }
  wg::fence_proxy_async();
  __syncthreads();
  OPP_TICK(6);

  // merge + LayerNorm 1 (into act: Q' is dead)
  gemm_k256(acc, wg::smem_u32(hid0), ring, false);
  OPP_TICK(7);
  layernorm_frag(acc, ln1s, ln1b, t);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    store_pair(act0, j, acc[4 * j], acc[4 * j + 1]);
    store_pair(act1, j, acc[4 * j + 2], acc[4 * j + 3]);
  }
  wg::fence_proxy_async();
  __syncthreads();
  OPP_TICK(8);

  // FFN hidden = relu(concat(x, h1) W0), 256 columns at a time
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    gemm_k256(acc, wg::smem_u32(xs), ring, false);
    gemm_k256(acc, wg::smem_u32(act), ring, true);
    unsigned char* hid = half == 0 ? hid0 : hid1;
    unsigned char *h0 = row_base(hid, r0, t), *h1 = row_base(hid, r1, t);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      store_pair(h0, j, fmaxf(acc[4 * j], 0.f), fmaxf(acc[4 * j + 1], 0.f));
      store_pair(h1, j, fmaxf(acc[4 * j + 2], 0.f), fmaxf(acc[4 * j + 3], 0.f));
    }
  }
  wg::fence_proxy_async();
  __syncthreads();

  OPP_TICK(9);
  // xs and act are dead: the f32 x rows come again, contiguous, for the residual
  const int rows = min(TM, L - l0);
  if (tid == 0) stage_rows(xb, l0, L, xs, xbar);
  // FFN out + LayerNorm 2 + residual on the f32 x
  gemm_k256(acc, wg::smem_u32(hid0), ring, false);
  gemm_k256(acc, wg::smem_u32(hid1), ring, true);
  OPP_TICK(10);
  layernorm_frag(acc, ln2s, ln2b, t);
  OPP_TICK(11);
  wg::mbar_wait(xbar, 1);
  const bool ok0 = r0 < rows, ok1 = r1 < rows;
  const float* x0 = reinterpret_cast<const float*>(xs) + r0 * C + 2 * t;
  const float* x1 = reinterpret_cast<const float*>(xs) + r1 * C + 2 * t;
  float* y0 = y + ((size_t)b * L + l0 + r0) * C + 2 * t;
  float* y1 = y + ((size_t)b * L + l0 + r1) * C + 2 * t;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (ok0) {
      const float2 xv = *reinterpret_cast<const float2*>(x0 + 8 * j);
      *reinterpret_cast<float2*>(y0 + 8 * j) = make_float2(xv.x + acc[4 * j], xv.y + acc[4 * j + 1]);
    }
    if (ok1) {
      const float2 xv = *reinterpret_cast<const float2*>(x1 + 8 * j);
      *reinterpret_cast<float2*>(y1 + 8 * j) =
          make_float2(xv.x + acc[4 * j + 2], xv.y + acc[4 * j + 3]);
    }
  }
  OPP_TICK(12);
}

int launch(const float* x, const float* src, const void* wkv, const void* wapply,
           const float* ln1s, const float* ln1b, const float* ln2s, const float* ln2b,
           const float* qmask, const float* smask, float* part, void* kvimg, float* y, int B,
           int L, int S, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const int n_s = (S + TM - 1) / TM;
  static int have_stats[MAX_DEVICES], have_apply[MAX_DEVICES];
  raise_smem_limit(kv_partial_tc_kernel, STATS_SMEM, have_stats);
  raise_smem_limit(apply_tc_kernel, APPLY_SMEM, have_apply);
  kv_partial_tc_kernel<<<dim3(n_s, B), 128, STATS_SMEM, stream>>>(
      src, static_cast<const unsigned char*>(wkv), smask, part, S);
  kv_reduce_tc_kernel<<<dim3((NH * KV_N * HD + 255) / 256, B), 256, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(kvimg), n_s);
  apply_tc_kernel<<<dim3((L + TM - 1) / TM, B), 128, APPLY_SMEM, stream>>>(
      x, static_cast<const __nv_bfloat16*>(kvimg), static_cast<const unsigned char*>(wapply),
      ln1s, ln1b, ln2s, ln2b, qmask, y, L);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// bf16 operands on the tensor cores, C = 256 and 8 heads. wkv: 8 packed
// chunks (Wk, Wv), wapply: 32 (Wq, Wmerge, W0 by output half and input half,
// W1), each chunk [256 out, 64 in] bf16 in the core-matrix layout. part is
// [B, tiles, 33, 256] f32 with tiles = opp_encoder_tc_source_tiles(S), kvimg
// [B, 8 * 40 * 32] bf16.
extern "C" int opp_encoder_layer_tc(const float* x, const float* src, const void* wkv,
                                    const void* wapply, const float* ln1s, const float* ln1b,
                                    const float* ln2s, const float* ln2b, const float* qmask,
                                    const float* smask, float* part, void* kvimg, float* y,
                                    int B, int L, int S, void* stream) {
  return tc::launch(x, src, wkv, wapply, ln1s, ln1b, ln2s, ln2b, qmask, smask, part, kvimg, y,
                    B, L, S, static_cast<cudaStream_t>(stream));
}

extern "C" int opp_encoder_tc_source_tiles(int S) { return (S + tc::TM - 1) / tc::TM; }

#ifdef OPP_K1_CLOCKS
// The phase clocks of the last launch (32 values), to host memory.
extern "C" int opp_encoder_tc_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, tc::k1_clocks, 32 * sizeof(long long));
}
#endif
