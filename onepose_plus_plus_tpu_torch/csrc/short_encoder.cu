// K7: one LoFTR encoder layer over many short sequences, each x [L, C]
// attending to its own source [S, C], linear attention in quadratic form.
//
// Replaces experiments/pallas_short_encoder.py::fused_short_encoder_layer
// (_short_kernel). Per sequence and head h (hd = C / nhead dims):
//   A_h = elu1(Q)_h elu1(K)_h^T  [L, S],  z = rowsum(A_h),
//   msg_h = (A_h V_h) / (z + 1e-6),
// then merge, LayerNorm, the FFN over concat(x, h1) with ReLU, LayerNorm and
// the f32 residual x + h2. There is no length-1 shortcut: with S = 1 the
// message is v * a / (a + 1e-6), as in the TPU kernel.
//
// T (float or bf16) is the type of the weights and of every product operand:
// x (as the FFN's input), source, Q', K', A, V, the per-head message, h1 and
// the FFN hidden are rounded to T, products accumulate in f32, z sums the f32
// A, and the LayerNorms and the residual stay f32. The output is f32.
//
// The TPU kernel's Mosaic workarounds (head-row expansion and collapse by 0/1
// matmuls, iota block masks, M padded to a multiple of 8) have no place here.
// Bound: operations (8 C^2 multiply-adds an x row and 2 C^2 a source row in
// the projections and the FFN, 2 L S C a sequence in the attention: 67.4
// GFLOP at [8192, 25, 128] self, 0.068 ms at the bf16 tensor cores' 989
// TFLOP/s). Two designs:
//
// bf16 operands at C = 128 with 8 heads, L and S up to 128 (the fine
// transformer's width; namespace tc): the tensor cores, by wgmma (wgmma.cuh).
// A tile holds G whole sequences, G = min(128 / L, 128 / S): their G L x rows
// and G S source rows, each padded with zero rows to 128 (5 sequences, 2 %
// padding, at L = S = 25). Two consumer warpgroups take the tile's two m64
// halves and share one ring of weight chunks. What bounds this design next is
// the weights: 320 KiB of bf16 (10 C^2 * 2 bytes) that every tile streams
// from L2, one block an SM. At 64-row tiles that would be 4096 tiles and
// ~1.3 GB of L2 reads a call at [8192, 25], ~0.25 ms at 5-6 TB/s, several
// times the bound; at 128-row tiles it is 1639 tiles and 0.54 GB, ~0.1 ms.
// So: 128 rows (two warpgroups on one stream), persistent blocks (the ring
// runs on from one tile into the next, so a tile's first chunks arrive while
// the last one finishes; the next tile's rows are prefetched into L2 by one
// bulk prefetch, and the residual's x is loaded while the last products
// run), the weights packed once per layer into 20 chunks
// [128 out, 64 in] that are byte images of the unswizzled K-major layout, one
// cp.async.bulk each on a four-stage mbarrier ring. Activations live in shared
// memory as bf16 tiles [128, 128] in the same layout (five: x, source / msg,
// K' / hidden, V / hidden, Q' / h1); accumulators and every epilogue (elu+1 by
// ex2.approx without a branch, the LayerNorms by quad shuffles, ReLU, the
// residual) stay in registers. The per-(sequence, head) attention (2.4 % of
// the operations; on the CUDA cores ~15x dearer an operation) runs as
// block-diagonal products on the tensor cores: per head one m64n128k16 product
// Q'_h K'_h^T over the whole tile, zeroed outside each row's own sequence
// (source columns [seq S, seq S + S)), its f32 row sums z, then the masked
// scores rounded to bf16 as the register A of eight m64n16k16 products with
// V_h read MN-major from the V tile; two heads at a time, so that one wait
// covers both heads' products. No atomics: bitwise repeatable.
//
// Every other case (f32 operands, another width): one block of C threads
// (thread c owns output column c) takes G whole sequences (G * max(L, S) ~ 32
// rows, any M; the last block takes what is left), stages x and source in
// shared memory, and runs every stage of the layer in FP32 FMAs on the CUDA
// cores before writing y once. K' is kept transposed per head ([hd, S]) so
// that one warp computes a score row with one lane per source row and no bank
// conflicts. The weights are read through L1/L2 by every block, one coalesced
// row of W per four FMAs of each staged row; bound by the CUDA cores' f32 rate.
#include <algorithm>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TARGET_ROWS = 32;  // x or source rows a block aims to hold
constexpr float EPS = 1e-6f;
constexpr float LN_EPS = 1e-5f;
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use on sm_90

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

int group_size(int L, int S) { return std::max(1, TARGET_ROWS / std::max(L, S)); }

// floats of shared memory for G sequences: x, Q'/msg/FFN out and merge/h1
// ([G L, C] each), scores A [G H L S] and their row sums [G H L], and one
// region holding source, K'^T and V ([G S, C] each) or later the FFN hidden
// ([G L, 2C]).
size_t smem_floats(int G, int L, int S, int C, int nhead) {
  const size_t x_side = (size_t)3 * G * L * C;
  const size_t scores = round4(G * nhead * L * S) + round4(G * nhead * L);
  const size_t region = std::max((size_t)3 * G * S * C, (size_t)2 * G * L * C);
  return x_side + scores + region;
}

template <typename T, int R, typename Epi>
__device__ __forceinline__ void project_tile(const float* a, const float* b, int ld, int K,
                                             const T* __restrict__ W, int ldw, int col, int r0,
                                             Epi& epi) {
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  opp::mac_rows<T, R>(a + r0 * ld, ld, K, W, ldw, col, acc);
  if (b != nullptr) opp::mac_rows<T, R>(b + r0 * ld, ld, K, W + (size_t)K * ldw, ldw, col, acc);
#pragma unroll
  for (int r = 0; r < R; ++r) epi(r0 + r, acc[r]);
}

// epi(r, sum_k in[r, k] * W[k, col]) for every row r < rows, where in[r] is
// a[r] (K columns), followed by b[r] (K more, against W's next K rows) when b
// is given. Rows go in tiles of 16, 8, 4, 2, 1: no padded rows.
template <typename T, typename Epi>
__device__ void project(const float* a, const float* b, int ld, int rows, int K,
                        const T* __restrict__ W, int ldw, int col, Epi epi) {
  int r = 0;
  for (; r + 16 <= rows; r += 16) project_tile<T, 16>(a, b, ld, K, W, ldw, col, r, epi);
  if (r + 8 <= rows) {
    project_tile<T, 8>(a, b, ld, K, W, ldw, col, r, epi);
    r += 8;
  }
  if (r + 4 <= rows) {
    project_tile<T, 4>(a, b, ld, K, W, ldw, col, r, epi);
    r += 4;
  }
  if (r + 2 <= rows) {
    project_tile<T, 2>(a, b, ld, K, W, ldw, col, r, epi);
    r += 2;
  }
  if (r < rows) project_tile<T, 1>(a, b, ld, K, W, ldw, col, r, epi);
}

// One block of C threads (thread c owns output column c) per G sequences.
template <typename T>
__global__ void short_encoder_kernel(const float* __restrict__ x, const float* __restrict__ src,
                                     const T* __restrict__ wq, const T* __restrict__ wk,
                                     const T* __restrict__ wv, const T* __restrict__ wm,
                                     const T* __restrict__ w0, const T* __restrict__ w1,
                                     const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                                     const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                                     float* __restrict__ y, int M, int L, int S, int C, int nhead,
                                     int G) {
  extern __shared__ __align__(16) float smem[];
  const int c = threadIdx.x, hd = C / nhead;
  const int m0 = blockIdx.x * G;
  const int g_n = min(G, M - m0);  // sequences of this block
  const int rx = g_n * L, rs = g_n * S;
  float* xs = smem;                                        // [G L, C] x rounded to T
  float* qs = xs + G * L * C;                              // Q', then msg, then FFN out
  float* hs = qs + G * L * C;                              // merge out, then h1
  float* as = hs + G * L * C;                              // [G, H, L, S] scores
  float* zs = as + round4(G * nhead * L * S);              // [G, H, L] their row sums
  float* ss = zs + round4(G * nhead * L);                  // [G S, C] source rounded to T
  float* kts = ss + G * S * C;                             // [G, H, hd, S] K' transposed
  float* vs = kts + G * S * C;                             // [G S, C] V
  float* hid = ss;                                         // [G L, 2C] FFN hidden, later

  const float* xg = x + (size_t)m0 * L * C;
  const float* sg = src + (size_t)m0 * S * C;
  for (int r = 0; r < rx; ++r) xs[r * C + c] = opp::round_to<T>(xg[(size_t)r * C + c]);
  for (int r = 0; r < rs; ++r) ss[r * C + c] = opp::round_to<T>(sg[(size_t)r * C + c]);
  __syncthreads();

  project<T>(ss, nullptr, C, rs, C, wk, C, c, [&](int r, float v) {
    kts[((r / S) * C + c) * S + r % S] = opp::round_to<T>(opp::elu_p1(v));
  });
  project<T>(ss, nullptr, C, rs, C, wv, C, c,
             [&](int r, float v) { vs[r * C + c] = opp::round_to<T>(v); });
  project<T>(xs, nullptr, C, rx, C, wq, C, c,
             [&](int r, float v) { qs[r * C + c] = opp::round_to<T>(opp::elu_p1(v)); });
  __syncthreads();

  // scores: one warp per (sequence, head, query row), one lane per source row
  {
    const int lane = c & 31, warp = c >> 5, nwarps = blockDim.x >> 5;
    for (int i = warp; i < g_n * nhead * L; i += nwarps) {
      const int l = i % L, gh = i / L, g = gh / nhead, h = gh % nhead;
      const float* q = qs + (g * L + l) * C + h * hd;
      const float* kt = kts + (size_t)gh * hd * S;
      float z = 0.f;
      for (int s = lane; s < S; s += 32) {
        float a = 0.f;
        for (int d = 0; d < hd; ++d) a = fmaf(q[d], kt[d * S + s], a);
        as[(size_t)i * S + s] = a;
        z += a;
      }
      z = opp::warp_sum(z);
      if (lane == 0) zs[i] = z;
    }
  }
  __syncthreads();

  // message: thread c = (head h, value dim), every query row (over Q', now dead)
  {
    const int h = c / hd;
    for (int r = 0; r < rx; ++r) {
      const int g = r / L, i = (g * nhead + h) * L + r % L;
      const float* arow = as + (size_t)i * S;
      const float* v = vs + g * S * C + c;
      float num = 0.f;
      for (int s = 0; s < S; ++s) num = fmaf(opp::round_to<T>(arow[s]), v[s * C], num);
      qs[r * C + c] = opp::round_to<T>(num / (zs[i] + EPS));
    }
  }
  __syncthreads();

  // merge + LayerNorm 1 (h1 rounded to T: it is only a product operand)
  project<T>(qs, nullptr, C, rx, C, wm, C, c, [&](int r, float v) { hs[r * C + c] = v; });
  __syncthreads();
  opp::layernorm_rows<T>(hs, rx, C, ln1s, ln1b, LN_EPS);
  __syncthreads();

  // FFN hidden relu(concat(x, h1) @ W0), columns c and c + C (source side is dead)
  for (int half = 0; half < 2; ++half) {
    const int j = c + half * C;
    project<T>(xs, hs, C, rx, C, w0, 2 * C, j, [&](int r, float v) {
      hid[r * 2 * C + j] = opp::round_to<T>(fmaxf(v, 0.f));
    });
  }
  __syncthreads();

  // FFN out + LayerNorm 2 (f32), then the f32 residual
  project<T>(hid, nullptr, 2 * C, rx, 2 * C, w1, C, c, [&](int r, float v) { qs[r * C + c] = v; });
  __syncthreads();
  opp::layernorm_rows<float>(qs, rx, C, ln2s, ln2b, LN_EPS);
  __syncthreads();
  float* yg = y + (size_t)m0 * L * C;
  for (int r = 0; r < rx; ++r) yg[(size_t)r * C + c] = xg[(size_t)r * C + c] + qs[r * C + c];
}

template <typename T>
int launch_short_encoder(const float* x, const float* src, const void* wq, const void* wk,
                         const void* wv, const void* wm, const void* w0, const void* w1,
                         const float* ln1s, const float* ln1b, const float* ln2s,
                         const float* ln2b, float* y, int M, int L, int S, int C, int nhead,
                         cudaStream_t stream) {
  if (C % 32 != 0 || C > 1024 || nhead <= 0 || C % nhead != 0 || M <= 0 || L <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = group_size(L, S);
  const size_t smem = smem_floats(G, L, S, C, nhead) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(short_encoder_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  short_encoder_kernel<T><<<(M + G - 1) / G, C, smem, stream>>>(
      x, src, static_cast<const T*>(wq), static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<const T*>(wm), static_cast<const T*>(w0), static_cast<const T*>(w1), ln1s,
      ln1b, ln2s, ln2b, y, M, L, S, C, nhead, G);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16, wgmma

namespace tc {

namespace wg = opp::wg;

constexpr int C = 128, NH = 8;  // 8 heads of 16 channels
constexpr int TM = 128;                          // tile rows: two m64 halves, one a warpgroup
constexpr int NT = 256;                          // two consumer warpgroups
constexpr uint32_t A_LBO = 128, A_SBO = 2048;    // activation tile [128 rows, 128 channels] bf16
constexpr uint32_t B_LBO = 128, B_SBO = 1024;    // weight chunk [128 out, 64 in] bf16
constexpr uint32_t TILE_BYTES = TM * C * 2;      // 32768
constexpr uint32_t HALF_BYTES = TILE_BYTES / 2;  // a warpgroup's 64 rows
constexpr uint32_t COL64 = 64 / 8 * A_LBO;       // 1024: 64 channels further along a tile
constexpr uint32_t CHUNK_BYTES = C * 64 * 2;     // 16384
constexpr int CHUNKS = 20;  // K, V, Q, merge: 2 each; FFN hidden: 2 halves x 4; FFN out: 4
constexpr int NST = 4;      // ring stages beside five activation tiles
constexpr size_t SMEM = 5 * TILE_BYTES + NST * CHUNK_BYTES + 64;
static_assert(SMEM <= MAX_SMEM, "five tiles and the ring fit a block");

// With -DOPP_K7_CLOCKS block 0 adds, tile by tile, the cycles of each phase
// (scripts/torch_k7_clocks.py builds that variant and prints the split).
#ifdef OPP_K7_CLOCKS
__device__ long long k7_clocks[8];
#define K7_TICK(i)                                          \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                \
    const long long now = clock64();                        \
    k7_clocks[i] += now - k7_t;                             \
    k7_t = now;                                             \
  }
#else
#define K7_TICK(i)
#endif

// elu(x) + 1 of a value rounded to bf16 next, without a branch (encoder.cu's tc::elu_p1_fast)
__device__ __forceinline__ float elu_p1_fast(float x) {
  return wg::ex2_fast(fminf(x, 0.f) * 1.4426950408889634f) + fmaxf(x, 0.f);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The ring of weight chunks: chunk c (counted over the block's tiles) is the
// layer's chunk c % CHUNKS and lands in stage c % NST; thread 0 starts the copies.
struct Ring {
  uint32_t buf;
  unsigned char* buf_ptr;
  uint64_t* full;            // one mbarrier per stage
  const unsigned char* src;  // the 20 packed chunks, in order of use
  int n_chunks;              // chunks of all this block's tiles
  int use;                   // next chunk to be multiplied

  __device__ __forceinline__ void fetch(int c) const {
    const int st = c % NST;
    wg::mbar_expect_tx(full + st, CHUNK_BYTES);
    wg::bulk_load(buf_ptr + (size_t)st * CHUNK_BYTES, src + (size_t)(c % CHUNKS) * CHUNK_BYTES,
                  CHUNK_BYTES, full + st);
  }
};

// acc = A W^T over the ring's next NCH chunks: a[q] is the shared address of
// chunk q's 64 input columns of this warpgroup's 64 rows. Both warpgroups
// multiply every chunk; a chunk's products stay in flight while the next
// chunk's are started, and its stage is refilled once both warpgroups are
// done with it. Ends with a block barrier after the last read of the A tiles.
template <int NCH>
__device__ __forceinline__ void gemm(float (&acc)[64], const uint32_t (&a)[NCH], Ring& ring) {
  const auto refill = [&](int done) {
    __syncthreads();
    if (threadIdx.x == 0 && done + NST < ring.n_chunks) ring.fetch(done + NST);
  };
#pragma unroll
  for (int q = 0; q < NCH; ++q) {
    const int c = ring.use, st = c % NST;
    wg::mbar_wait(ring.full + st, (c / NST) & 1);
    const uint32_t b = ring.buf + st * CHUNK_BYTES;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_n128(acc, wg::desc(a[q] + kk * 2 * A_LBO, A_LBO, A_SBO),
                   wg::desc(b + kk * 2 * B_LBO, B_LBO, B_SBO), (q > 0 || kk > 0) ? 1 : 0);
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

// Rows [0, n) of src [.., 128] f32, rounded to bf16, into an activation tile;
// rows from n on are zeros. A thread issues its 16 loads (16 bytes each)
// before its stores. Warp-iteration u = warp + 8 it takes row group u / 8 and
// columns 16 (u % 8) ... + 15: lane (row % 8 = lane & 7, float4 lane >> 3), so
// a warp reads 64 contiguous bytes of each of 8 rows and writes two whole
// core matrices (256 contiguous bytes, no bank conflict).
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int n, unsigned char* tile) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 v[16];
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int u = w + 8 * it, row = 8 * (u >> 3) + (lane & 7), k4 = 4 * (u & 7) + (lane >> 3);
    v[it] = row < n ? __ldg(reinterpret_cast<const float4*>(src + (size_t)row * C) + k4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int u = w + 8 * it, row = 8 * (u >> 3) + (lane & 7);
    const int k = 16 * (u & 7) + 4 * (lane >> 3);
    const uint2 packed = make_uint2(bf16_pair(v[it].x, v[it].y), bf16_pair(v[it].z, v[it].w));
    *reinterpret_cast<uint2*>(tile + (row >> 3) * A_SBO + (k >> 3) * A_LBO + (row & 7) * 16 +
                              (k & 7) * 2) = packed;
  }
}

// Where this thread's column pair (2 t, 2 t + 1) of tile row `row` lies in an
// activation tile's first 8-column group; group kg is kg * A_LBO bytes further.
__device__ __forceinline__ unsigned char* row_base(unsigned char* tile, int row, int t) {
  return tile + (row >> 3) * A_SBO + (row & 7) * 16 + 4 * t;
}
__device__ __forceinline__ void store_pair(unsigned char* base, int kg, float a, float b) {
  *reinterpret_cast<uint32_t*>(base + kg * A_LBO) = bf16_pair(a, b);
}
// Accumulator fragments [64, 128] into an activation tile as value(v) (bf16),
// rows r0 and r0 + 8 of the tile.
template <typename F>
__device__ __forceinline__ void store_tile(const float (&acc)[64], unsigned char* tile, int r0, int t,
                                           F value) {
  unsigned char *p0 = row_base(tile, r0, t), *p1 = row_base(tile, r0 + 8, t);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    store_pair(p0, j, value(acc[4 * j]), value(acc[4 * j + 1]));
    store_pair(p1, j, value(acc[4 * j + 2]), value(acc[4 * j + 3]));
  }
}

// LayerNorm over the 128 columns of each row, on the fragments: this thread
// holds 32 values of row g and 32 of row g + 8; its quad holds the rest.
__device__ __forceinline__ void layernorm_frag(float (&acc)[64], const float* __restrict__ scale,
                                               const float* __restrict__ bias, int t) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
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
  for (int j = 0; j < 16; ++j) {
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
  for (int j = 0; j < 16; ++j) {
    const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + 8 * j + 2 * t));
    const float2 bi = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
    acc[4 * j] = (acc[4 * j] - m0) * r0 * sc.x + bi.x;
    acc[4 * j + 1] = (acc[4 * j + 1] - m0) * r0 * sc.y + bi.y;
    acc[4 * j + 2] = (acc[4 * j + 2] - m1) * r1 * sc.x + bi.x;
    acc[4 * j + 3] = (acc[4 * j + 3] - m1) * r1 * sc.y + bi.y;
  }
}

// Persistent blocks; tile i holds sequences [G i, G i + G) of x (their G L
// rows, then zero rows up to 128) and of the source (G S rows). self: the
// source is x (one tile for both).
__global__ void __launch_bounds__(NT, 1)
short_encoder_tc_kernel(const float* __restrict__ x, const float* __restrict__ src,
                        const unsigned char* __restrict__ wpack, const float* __restrict__ ln1s,
                        const float* __restrict__ ln1b, const float* __restrict__ ln2s,
                        const float* __restrict__ ln2b, float* __restrict__ y, int M, int L,
                        int S, int G, int self) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xs = smem;                        // x rounded to bf16
  unsigned char* ss = xs + TILE_BYTES;             // source rounded to bf16 (cross), then msg
  unsigned char* kt = ss + TILE_BYTES;             // K', then FFN hidden columns 0..127
  unsigned char* vt = kt + TILE_BYTES;             // V, then FFN hidden columns 128..255
  unsigned char* qt = vt + TILE_BYTES;             // Q', then the LN1 output h1
  unsigned char* ringb = qt + TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ringb + NST * CHUNK_BYTES);
  unsigned char* srct = self ? xs : ss;
  const int tid = threadIdx.x, lane = tid & 31, wgi = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wgi + 16 * ((tid >> 5) & 3) + g, r1 = r0 + 8;  // this thread's tile rows
  const int seq0 = r0 / L, seq1 = r1 / L;  // their sequences within a tile, if they are x rows
  const uint32_t half = wgi * HALF_BYTES;
  const int n_tiles = (M + G - 1) / G;
#ifdef OPP_K7_CLOCKS
  long long k7_t = clock64();
#endif

  Ring ring{wg::smem_u32(ringb), ringb, bars, wpack,
            CHUNKS * ((n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x), 0};
  if (tid == 0) {
    for (int i = 0; i < NST; ++i) wg::mbar_init(bars + i, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < NST && c < ring.n_chunks; ++c) ring.fetch(c);

  const uint32_t xa = wg::smem_u32(xs) + half, sa = wg::smem_u32(srct) + half;
  const uint32_t ma = wg::smem_u32(ss) + half, qa = wg::smem_u32(qt) + half;
  const uint32_t ka = wg::smem_u32(kt) + half, va = wg::smem_u32(vt) + half;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * G, g_n = min(G, M - m0), rx = g_n * L;
    load_rows(x + (size_t)m0 * L * C, rx, xs);
    if (!self) load_rows(src + (size_t)m0 * S * C, g_n * S, ss);
    // the next tile's rows start for L2 now: its loads then wait on L2, not on device memory
    const int m1 = m0 + gridDim.x * G;
    if (tid == 0 && m1 < M) {
      const int g1 = min(G, M - m1);
      wg::bulk_prefetch_l2(x + (size_t)m1 * L * C, g1 * L * C * 4);
      if (!self) wg::bulk_prefetch_l2(src + (size_t)m1 * S * C, g1 * S * C * 4);
    }
    wg::fence_proxy_async();
    __syncthreads();
    K7_TICK(0);

    float acc[64];
    // K' = elu(src Wk) + 1 and V = src Wv over every source row (padding rows
    // are zeros; the attention masks their columns)
    gemm<2>(acc, {sa, sa + COL64}, ring);
    store_tile(acc, kt, r0, t, [](float v) { return elu_p1_fast(v); });
    gemm<2>(acc, {sa, sa + COL64}, ring);
    store_tile(acc, vt, r0, t, [](float v) { return v; });
    // Q' = elu(x Wq) + 1
    gemm<2>(acc, {xa, xa + COL64}, ring);
    store_tile(acc, qt, r0, t, [](float v) { return elu_p1_fast(v); });
    wg::fence_proxy_async();
    __syncthreads();
    K7_TICK(1);

    // Attention, block-diagonal over the tile: per head h, s = Q'_h K'_h^T
    // [64 rows, 128 source rows] on the tensor cores, zero outside the row's
    // own sequence (source rows [seq S, seq S + S)); z = its f32 row sums;
    // msg_h = bf16(s) V_h / (z + 1e-6), s from registers as the A operand and
    // V_h read MN-major from the V tile. Two heads at a time, so that one
    // wait covers two products. Into ss: the source tile is read.
    {
      const bool ok0 = r0 < rx, ok1 = r1 < rx;
      const int lo0 = ok0 ? seq0 * S : 0, hi0 = ok0 ? lo0 + S : 0;
      const int lo1 = ok1 ? seq1 * S : 0, hi1 = ok1 ? lo1 + S : 0;
      unsigned char *m0p = row_base(ss, r0, t), *m1p = row_base(ss, r1, t);
      const uint32_t k_base = wg::smem_u32(kt), v_base = wg::smem_u32(vt);
      // zero the scores outside each row's sequence; their row sums
      const auto mask = [&](float(&sc)[64], float& z0, float& z1) {
        z0 = z1 = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c0 = 8 * j + 2 * t;
          sc[4 * j] = c0 >= lo0 && c0 < hi0 ? sc[4 * j] : 0.f;
          sc[4 * j + 1] = c0 + 1 >= lo0 && c0 + 1 < hi0 ? sc[4 * j + 1] : 0.f;
          sc[4 * j + 2] = c0 >= lo1 && c0 < hi1 ? sc[4 * j + 2] : 0.f;
          sc[4 * j + 3] = c0 + 1 >= lo1 && c0 + 1 < hi1 ? sc[4 * j + 3] : 0.f;
          z0 += sc[4 * j] + sc[4 * j + 1];
          z1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        z0 += __shfl_xor_sync(0xffffffffu, z0, 1);
        z1 += __shfl_xor_sync(0xffffffffu, z1, 1);
        z0 += __shfl_xor_sync(0xffffffffu, z0, 2);
        z1 += __shfl_xor_sync(0xffffffffu, z1, 2);
      };
      const auto pack = [](const float(&sc)[64], uint32_t(&af)[8][4]) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) af[kk][q] = bf16_pair(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
      };
      const auto store_msg = [&](const float(&o)[8], int h, float z0, float z1) {
        const float i0 = 1.f / (z0 + EPS), i1 = 1.f / (z1 + EPS);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          store_pair(m0p, 2 * h + j, o[4 * j] * i0, o[4 * j + 1] * i0);
          store_pair(m1p, 2 * h + j, o[4 * j + 2] * i1, o[4 * j + 3] * i1);
        }
      };
#pragma unroll 1
      for (int h = 0; h < NH; h += 2) {
        float sa[64], sb[64];
        wg::fence();
        wg::mma_n128(sa, wg::desc(qa + 2 * h * A_LBO, A_LBO, A_SBO),
                     wg::desc(k_base + 2 * h * A_LBO, A_LBO, A_SBO), 0);
        wg::mma_n128(sb, wg::desc(qa + 2 * (h + 1) * A_LBO, A_LBO, A_SBO),
                     wg::desc(k_base + 2 * (h + 1) * A_LBO, A_LBO, A_SBO), 0);
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(sa);
        wg::fence_regs(sb);
        float za0, za1, zb0, zb1;
        mask(sa, za0, za1);
        mask(sb, zb0, zb1);
        uint32_t afa[8][4], afb[8][4];
        pack(sa, afa);
        pack(sb, afb);
        float oa[8], ob[8];
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {  // V tile MN-major: LBO along its rows, SBO along its channels
          wg::mma_rs_n16_tb(oa, afa[kk], wg::desc(v_base + kk * 2 * A_SBO + 2 * h * A_LBO, A_SBO, A_LBO),
                            kk > 0 ? 1 : 0);
          wg::mma_rs_n16_tb(ob, afb[kk],
                            wg::desc(v_base + kk * 2 * A_SBO + 2 * (h + 1) * A_LBO, A_SBO, A_LBO),
                            kk > 0 ? 1 : 0);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(oa);
        wg::fence_regs(ob);
        store_msg(oa, h, za0, za1);
        store_msg(ob, h + 1, zb0, zb1);
      }
    }
    wg::fence_proxy_async();
    __syncthreads();
    K7_TICK(2);

    // merge + LayerNorm 1 -> h1 (bf16) over Q'
    gemm<2>(acc, {ma, ma + COL64}, ring);
    layernorm_frag(acc, ln1s, ln1b, t);
    store_tile(acc, qt, r0, t, [](float v) { return v; });
    wg::fence_proxy_async();
    __syncthreads();
    K7_TICK(3);

    // FFN hidden = relu(concat(x, h1) W0), 128 columns at a time, over K' and V
    gemm<4>(acc, {xa, xa + COL64, qa, qa + COL64}, ring);
    store_tile(acc, kt, r0, t, [](float v) { return fmaxf(v, 0.f); });
    wg::fence_proxy_async();
    gemm<4>(acc, {xa, xa + COL64, qa, qa + COL64}, ring);
    store_tile(acc, vt, r0, t, [](float v) { return fmaxf(v, 0.f); });
    wg::fence_proxy_async();
    __syncthreads();
    K7_TICK(4);

    // FFN out + LayerNorm 2 + the f32 residual, whose x values are loaded
    // (from L2) while the products run
    const size_t row0 = (size_t)m0 * L;
    float2 xres[2][16];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh ? r1 : r0;
      const float2* xr = reinterpret_cast<const float2*>(x + (row0 + r) * C + 2 * t);
#pragma unroll
      for (int j = 0; j < 16; ++j) xres[hh][j] = r < rx ? __ldg(xr + 4 * j) : make_float2(0.f, 0.f);
    }
    gemm<4>(acc, {ka, ka + COL64, va, va + COL64}, ring);
    layernorm_frag(acc, ln2s, ln2b, t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh ? r1 : r0;
      if (r >= rx) continue;
      float2* yr = reinterpret_cast<float2*>(y + (row0 + r) * C + 2 * t);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        yr[4 * j] = make_float2(xres[hh][j].x + acc[4 * j + 2 * hh], xres[hh][j].y + acc[4 * j + 2 * hh + 1]);
    }
    K7_TICK(5);
  }
}

int launch(const float* x, const float* src, const void* wpack, const float* ln1s,
           const float* ln1b, const float* ln2s, const float* ln2b, float* y, int M, int L, int S,
           int G, int self, cudaStream_t stream) {
  if (M <= 0 || L <= 0 || S <= 0 || G <= 0 || G * L > TM || G * S > TM || (self && L != S))
    return (int)cudaErrorInvalidValue;
  static int have[opp::MAX_DEVICES], sms[opp::MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  int n_sm = dev < opp::MAX_DEVICES ? sms[dev] : 0;
  if (n_sm == 0) {
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (dev < opp::MAX_DEVICES) sms[dev] = n_sm;
  }
  opp::raise_smem_limit(short_encoder_tc_kernel, SMEM, have);
  const int n_tiles = (M + G - 1) / G;
  short_encoder_tc_kernel<<<std::min(n_tiles, n_sm), NT, SMEM, stream>>>(
      x, src, static_cast<const unsigned char*>(wpack), ln1s, ln1b, ln2s, ln2b, y, M, L, S, G,
      self);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

#define OPP_SHORT_ENCODER_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const float* x, const float* src, const void* wq, const void* wk,      \
                      const void* wv, const void* wm, const void* w0, const void* w1,        \
                      const float* ln1s, const float* ln1b, const float* ln2s,               \
                      const float* ln2b, float* y, int M, int L, int S, int C, int nhead,    \
                      void* stream) {                                                        \
    return launch_short_encoder<T>(x, src, wq, wk, wv, wm, w0, w1, ln1s, ln1b, ln2s, ln2b, y, \
                                   M, L, S, C, nhead, static_cast<cudaStream_t>(stream));    \
  }

OPP_SHORT_ENCODER_ENTRY(opp_short_encoder_f32, float)
OPP_SHORT_ENCODER_ENTRY(opp_short_encoder_bf16, __nv_bfloat16)

// Shared memory (bytes) one block of the layer needs; above 232448 it does
// not launch.
extern "C" int opp_short_encoder_smem_bytes(int L, int S, int C, int nhead) {
  return (int)(smem_floats(group_size(L, S), L, S, C, nhead) * sizeof(float));
}

// bf16 operands on the tensor cores, C = 128 and 8 heads, L and S up to 128:
// wpack the 20 packed chunks (Wk, Wv, Wq, Wmerge by 64 input columns; W0 by
// output half, then W1; each [128 out, 64 in] bf16 in the core-matrix layout);
// G whole sequences a 128-row tile (G L <= 128, G S <= 128); self: src is x.
extern "C" int opp_short_encoder_tc(const float* x, const float* src, const void* wpack,
                                    const float* ln1s, const float* ln1b, const float* ln2s,
                                    const float* ln2b, float* y, int M, int L, int S, int G,
                                    int self, void* stream) {
  return tc::launch(x, src, wpack, ln1s, ln1b, ln2s, ln2b, y, M, L, S, G, self,
                    static_cast<cudaStream_t>(stream));
}

#ifdef OPP_K7_CLOCKS
// The phase cycles block 0 added over its tiles since the last reset (8 values).
extern "C" int opp_short_encoder_tc_clocks(long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, tc::k7_clocks, 8 * sizeof(long long));
  if (e == cudaSuccess && reset) {
    const long long zero[8] = {};
    e = cudaMemcpyToSymbol(tc::k7_clocks, zero, sizeof(zero));
  }
  return (int)e;
}
#endif
