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
// matmuls, iota block masks, M padded to a multiple of 8) have no place here:
// one block takes G whole sequences (G * max(L, S) ~ 32 rows, any M; the last
// block takes what is left), stages x and source in shared memory, and runs
// every stage of the layer on them before writing y once. K' is kept
// transposed per head ([hd, S]) so that one warp computes a score row with
// one lane per source row and no bank conflicts.
//
// Bound: FP32 FMA throughput of the CUDA cores (8 C^2 multiply-adds per x row
// and 2 C^2 per source row in the projections and the FFN, L * S * C per
// sequence in the attention); the bf16 weights (10 C^2 * 2 bytes, 320 KiB at
// C = 128, more than one block's shared memory) are read through L1/L2 by
// every block, one coalesced row of W per four FMAs of each staged row.
// Tensor cores (mma/wgmma) and TMA are later work.
#include <algorithm>

#include "common.cuh"

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
