// K1: one LoFTR linear-attention encoder layer (x attends to source).
//
// Replaces onepose_plus_plus_tpu/ops/pallas_encoder.py::fused_encoder_layer
// (_kv_stats_kernel + _apply_kernel). The TPU kernel carries the K'^T[V|1]
// sum across its sequential grid; Hopper blocks run in no order, so the
// layer is three launches:
//   1. kv_partial_kernel: one block per (source tile, batch) projects K and V,
//      applies elu+1 and the masks, and writes that tile's per-head K'^T V and
//      sum K' ([hd + 1, C] partials: only the head-diagonal blocks).
//   2. kv_reduce_kernel: sums the partials over tiles in a fixed order
//      (deterministic, no atomics) into kv [B, C, hd + 1].
//   3. apply_kernel: one block per (x tile, batch) runs the rest of the layer
//      in shared memory: Q projection, elu+1, msg = num / (den + 1e-6), merge,
//      LayerNorm, FFN over concat(x, msg) with ReLU, LayerNorm, residual.
// Every projection and FFN product is computed in the kernels' own bodies.
// x and source are f32; T (float or bf16) is the type of the weights and of
// every product operand: as in the TPU kernel, each activation that enters a
// product (x, source, K', V, Q', K'^T[V|1], msg, LN1 out, FFN hidden) is
// rounded to T, products accumulate in f32, and the residual adds the f32 x.
// The output is f32.
//
// Bound: FP32 FMA throughput of the CUDA cores (~8 C^2 multiply-adds per x row
// plus 2 C^2 per source row); weights stream from L2 (each block rereads them).
// Design: one thread per channel, TILE rows per block, operands staged in
// shared memory and read as float4 broadcasts so one shared load feeds four
// FMAs. Tensor cores (wgmma) are later work.
#include "common.cuh"

namespace {

constexpr int TS = 32;  // source rows per stats block
constexpr int TL = 16;  // x rows per apply block
constexpr float EPS = 1e-6f;
constexpr float LN_EPS = 1e-5f;

// acc[r] = sum_k in[r, k] * W[k, col] for the R rows staged in `in` (row
// stride `ld`, K columns), W row-major [K, ldw].
template <typename T, int R>
__device__ __forceinline__ void matvec_rows(const float* __restrict__ in, int ld, int K,
                                            const T* __restrict__ W, int ldw, int col,
                                            float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  opp::mac_rows<T, R>(in, ld, K, W, ldw, col, acc);
}

template <typename T>
__global__ void kv_partial_kernel(const float* __restrict__ src, const T* __restrict__ wk,
                                  const T* __restrict__ wv, const float* __restrict__ smask,
                                  float* __restrict__ part, int S, int C, int hd) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;         // [TS, C] source tile
  float* ks = xs + TS * C;  // [TS, C] masked K'
  float* vs = ks + TS * C;  // [TS, C] V
  const int tile = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int s0 = tile * TS;
  const int rows = min(TS, S - s0);
  const float* srcb = src + ((size_t)b * S + s0) * C;
  for (int r = 0; r < TS; ++r)
    xs[r * C + c] = r < rows ? opp::round_to<T>(srcb[(size_t)r * C + c]) : 0.f;
  __syncthreads();

  float acc[TS];
  matvec_rows<T, TS>(xs, C, C, wk, C, c, acc);
#pragma unroll
  for (int r = 0; r < TS; ++r) {
    float m = r < rows ? 1.f : 0.f;  // rows past S add nothing (elu(0)+1 = 1 otherwise)
    if (smask != nullptr && r < rows) m *= smask[(size_t)b * S + s0 + r];
    ks[r * C + c] = opp::round_to<T>(opp::elu_p1(acc[r]) * m);
  }
  matvec_rows<T, TS>(xs, C, C, wv, C, c, acc);
#pragma unroll
  for (int r = 0; r < TS; ++r) vs[r * C + c] = opp::round_to<T>(acc[r]);
  __syncthreads();

  // thread c = (head h, dim d): KV[h][d][e] for every e of its head, and sum K'
  const int h0 = (c / hd) * hd;
  const int n_el = (hd + 1) * C;
  float* out = part + ((size_t)b * gridDim.x + tile) * n_el;
  float ksum = 0.f;
  for (int r = 0; r < TS; ++r) ksum += ks[r * C + c];
  for (int e = 0; e < hd; ++e) {
    float a = 0.f;
    for (int r = 0; r < TS; ++r) a = fmaf(ks[r * C + c], vs[r * C + h0 + e], a);
    out[(size_t)e * C + c] = a;
  }
  out[(size_t)hd * C + c] = ksum;
}

// kv[b, c, e] = sum over tiles of part[b, tile, e, c] (tiles in order).
__global__ void kv_reduce_kernel(const float* __restrict__ part, float* __restrict__ kv,
                                 int n_tiles, int C, int hd) {
  const int n_el = (hd + 1) * C;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= n_el) return;
  const float* p = part + (size_t)b * n_tiles * n_el + i;
  float a = 0.f;
  for (int t = 0; t < n_tiles; ++t) a += p[(size_t)t * n_el];
  const int e = i / C, c = i % C;
  kv[(size_t)b * n_el + (size_t)c * (hd + 1) + e] = a;
}

template <typename T>
__global__ void apply_kernel(const float* __restrict__ x, const float* __restrict__ kv,
                             const T* __restrict__ wq, const T* __restrict__ wm,
                             const T* __restrict__ w0, const T* __restrict__ w1,
                             const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                             const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                             const float* __restrict__ qmask, float* __restrict__ y, int L,
                             int C, int hd) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // [TL, C]  x tile, rounded to T
  float* qs = xs + TL * C;       // [TL, C]  Q', then merge output / LN1
  float* ms = qs + TL * C;       // [TL, C]  msg, then FFN output / LN2
  float* as = ms + TL * C;       // [TL, 2C] FFN hidden
  float* kvs = as + TL * 2 * C;  // [C, hd + 1] per-head K'^T V | sum K'
  const int tile = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int l0 = tile * TL;
  const int rows = min(TL, L - l0);
  const float* xb = x + ((size_t)b * L + l0) * C;
  for (int r = 0; r < TL; ++r)
    xs[r * C + c] = r < rows ? opp::round_to<T>(xb[(size_t)r * C + c]) : 0.f;
  const int n_el = (hd + 1) * C;
  for (int i = c; i < n_el; i += C) kvs[i] = opp::round_to<T>(kv[(size_t)b * n_el + i]);
  __syncthreads();

  float acc[TL];
  // Q projection, feature map, query mask
  matvec_rows<T, TL>(xs, C, C, wq, C, c, acc);
#pragma unroll
  for (int r = 0; r < TL; ++r) {
    float q = opp::elu_p1(acc[r]);
    if (qmask != nullptr) q *= r < rows ? qmask[(size_t)b * L + l0 + r] : 0.f;
    qs[r * C + c] = opp::round_to<T>(q);
  }
  __syncthreads();

  // attention: thread c = (head h, value dim e)
  {
    const int h0 = (c / hd) * hd, e = c % hd;
    for (int r = 0; r < TL; ++r) {
      float num = 0.f, den = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float q = qs[r * C + h0 + d];
        const float* kvrow = kvs + (h0 + d) * (hd + 1);
        num = fmaf(q, kvrow[e], num);
        den = fmaf(q, kvrow[hd], den);
      }
      ms[r * C + c] = opp::round_to<T>(num / (den + EPS));
    }
  }
  __syncthreads();

  // merge + LayerNorm 1 (into qs, free since the attention pass)
  matvec_rows<T, TL>(ms, C, C, wm, C, c, acc);
#pragma unroll
  for (int r = 0; r < TL; ++r) qs[r * C + c] = acc[r];
  __syncthreads();
  opp::layernorm_rows<T>(qs, TL, C, ln1s, ln1b, LN_EPS);
  __syncthreads();

  // FFN hidden: relu(concat(x, h1) @ W0), columns c and c + C
  for (int half = 0; half < 2; ++half) {
    const int j = c + half * C;
    float acc2[TL];
    matvec_rows<T, TL>(xs, C, C, w0, 2 * C, j, acc);
    matvec_rows<T, TL>(qs, C, C, w0 + (size_t)C * 2 * C, 2 * C, j, acc2);
#pragma unroll
    for (int r = 0; r < TL; ++r) as[r * 2 * C + j] = opp::round_to<T>(fmaxf(acc[r] + acc2[r], 0.f));
  }
  __syncthreads();

  // FFN out + LayerNorm 2 (into ms, free since the merge)
  matvec_rows<T, TL>(as, 2 * C, 2 * C, w1, C, c, acc);
#pragma unroll
  for (int r = 0; r < TL; ++r) ms[r * C + c] = acc[r];
  __syncthreads();
  opp::layernorm_rows<float>(ms, TL, C, ln2s, ln2b, LN_EPS);
  __syncthreads();

  float* yb = y + ((size_t)b * L + l0) * C;
  for (int r = 0; r < rows; ++r) yb[(size_t)r * C + c] = xb[(size_t)r * C + c] + ms[r * C + c];
}

template <typename T>
int launch_encoder_layer(const float* x, const float* src, const void* wq, const void* wk,
                         const void* wv, const void* wm, const void* w0, const void* w1,
                         const float* ln1s, const float* ln1b, const float* ln2s,
                         const float* ln2b, const float* qmask, const float* smask, float* part,
                         float* kv, float* y, int B, int L, int S, int C, int nhead,
                         cudaStream_t stream) {
  if (C % 32 != 0 || C > 256 || nhead <= 0 || C % nhead != 0 || B <= 0 || L <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int hd = C / nhead;
  const int n_s = (S + TS - 1) / TS;
  const size_t smem_a = (size_t)3 * TS * C * sizeof(float);
  const size_t smem_b = ((size_t)TL * 5 * C + (size_t)C * (hd + 1)) * sizeof(float);
  cudaFuncSetAttribute(kv_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_a);
  cudaFuncSetAttribute(apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_b);
  kv_partial_kernel<T><<<dim3(n_s, B), C, smem_a, stream>>>(
      src, static_cast<const T*>(wk), static_cast<const T*>(wv), smask,
      part, S, C, hd);
  const int n_el = (hd + 1) * C;
  kv_reduce_kernel<<<dim3((n_el + 255) / 256, B), 256, 0, stream>>>(part, kv, n_s, C, hd);
  apply_kernel<T><<<dim3((L + TL - 1) / TL, B), C, smem_b, stream>>>(
      x, kv, static_cast<const T*>(wq), static_cast<const T*>(wm),
      static_cast<const T*>(w0), static_cast<const T*>(w1), ln1s, ln1b, ln2s, ln2b, qmask, y, L,
      C, hd);
  return (int)cudaGetLastError();
}

}  // namespace

#define OPP_ENCODER_ENTRY(NAME, T)                                                           \
  extern "C" int NAME(const float* x, const float* src, const void* wq, const void* wk,     \
                      const void* wv, const void* wm, const void* w0, const void* w1,       \
                      const float* ln1s, const float* ln1b, const float* ln2s,              \
                      const float* ln2b, const float* qmask, const float* smask,            \
                      float* part, float* kv, float* y, int B, int L, int S, int C,         \
                      int nhead, void* stream) {                                            \
    return launch_encoder_layer<T>(x, src, wq, wk, wv, wm, w0, w1, ln1s, ln1b, ln2s, ln2b, \
                                   qmask, smask, part, kv, y, B, L, S, C, nhead,            \
                                   static_cast<cudaStream_t>(stream));                      \
  }

OPP_ENCODER_ENTRY(opp_encoder_layer_f32, float)
OPP_ENCODER_ENTRY(opp_encoder_layer_bf16, __nv_bfloat16)

// Number of source tiles of the partial buffer: part is [B, tiles, hd + 1, C].
extern "C" int opp_encoder_source_tiles(int S) { return (S + TS - 1) / TS; }
