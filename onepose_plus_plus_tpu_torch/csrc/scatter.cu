// K4: the fine-window gather's VJP, a deterministic scatter-add of window
// gradients back onto the [B, H, W, C] map.
//
// Replaces onepose_plus_plus_tpu/ops/pallas_gather.py::scatter_rows_mxu (the
// backward of take_rows_mxu_grad). It is the transpose of the port's K3
// (gather.cu), not of the TPU's one-hot matmul over space-to-depth rows:
//   out[b, r, c, :] = sum over slots k whose window holds pixel (r, c) of
//                     grad[b, k, (r - stride*ci + W/2) * W + (c - stride*cj + W/2), :]
// for cell_ids[b, k] = ci * wc + cj. Taps outside the map, and out-of-range
// or negative ids, contribute nothing.
//
// Collisions are the norm (stride-4 windows of width 5 overlap by one row or
// column, and GT-padded slots repeat predicted cells), and the sum must be
// the same bit for bit from run to run, so there are no atomics. The wrapper
// sorts the slots by cell id (stable) and hands over per-cell slot ranges;
// one thread per (pixel, 16-byte channel vector) visits the at most
// ceil(W/stride)^2 cells whose windows hold its pixel, in (row, column)
// order, and each cell's slots in ascending slot order, accumulating in f32
// and writing once in the map's dtype.
//
// Bound: device-memory bandwidth (one write of the map, one read of every
// gradient tap, the index ranges stay in L1/L2). Neighbouring threads own
// neighbouring 16-byte vectors of a pixel, so loads and stores coalesce.
#include "common.cuh"

namespace {

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void add(const uint4& u, float* acc) {
    const float4 v = *reinterpret_cast<const float4*>(&u);
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  __device__ static uint4 pack(const float* acc) {
    float4 v = make_float4(acc[0], acc[1], acc[2], acc[3]);
    return *reinterpret_cast<const uint4*>(&v);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void add(const uint4& u, float* acc) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
  __device__ static uint4 pack(const float* acc) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    return u;
  }
};

// cells c with stride*c - half <= x <= stride*c + half, clipped to [0, n)
__device__ __forceinline__ void cell_range(int x, int half, int stride, int n, int& lo, int& hi) {
  lo = x - half <= 0 ? 0 : (x - half + stride - 1) / stride;
  hi = min(n - 1, (x + half) / stride);
}

template <typename T>
__global__ void window_scatter_kernel(const T* __restrict__ grad, const int* __restrict__ order,
                                      const int* __restrict__ cell_start, T* __restrict__ out,
                                      int H, int W, int C, int hc, int wc, int K, int stride,
                                      int window) {
  constexpr int VEC = Vec<T>::N;
  const int nv = C / VEC;
  const int b = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)H * W * nv) return;
  const int v = (int)(i % nv);
  const int pix = (int)(i / nv);
  const int r = pix / W, c = pix % W;
  const int half = window / 2, taps = window * window;
  const int n_cells = hc * wc;
  const int* starts = cell_start + (size_t)b * (n_cells + 1);
  const int* ord = order + (size_t)b * K;
  const uint4* g = reinterpret_cast<const uint4*>(grad + (size_t)b * K * taps * C);

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  int ci_lo, ci_hi, cj_lo, cj_hi;
  cell_range(r, half, stride, hc, ci_lo, ci_hi);
  cell_range(c, half, stride, wc, cj_lo, cj_hi);
  for (int ci = ci_lo; ci <= ci_hi; ++ci) {
    const int tr = r - (stride * ci - half);
    for (int cj = cj_lo; cj <= cj_hi; ++cj) {
      const int t = tr * window + (c - (stride * cj - half));
      const int cell = ci * wc + cj;
      for (int s = starts[cell]; s < starts[cell + 1]; ++s) {
        const int slot = ord[s];
        Vec<T>::add(g[((size_t)slot * taps + t) * nv + v], acc);
      }
    }
  }
  reinterpret_cast<uint4*>(out + (size_t)b * H * W * C)[(size_t)pix * nv + v] = Vec<T>::pack(acc);
}

template <typename T>
int launch_window_scatter(const void* grad, const int* order, const int* cell_start, void* out,
                          int B, int H, int W, int C, int hc, int wc, int K, int stride,
                          int window, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  if (B <= 0 || K <= 0 || C % VEC != 0 || window <= 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)H * W * (C / VEC);
  const int threads = 256;
  window_scatter_kernel<T><<<dim3((unsigned)((n + threads - 1) / threads), B), threads, 0,
                             stream>>>(static_cast<const T*>(grad), order, cell_start,
                                       static_cast<T*>(out), H, W, C, hc, wc, K, stride, window);
  return (int)cudaGetLastError();
}

}  // namespace

#define OPP_SCATTER_ENTRY(NAME, T)                                                           \
  extern "C" int NAME(const void* grad, const int* order, const int* cell_start, void* out, \
                      int B, int H, int W, int C, int hc, int wc, int K, int stride,        \
                      int window, void* stream) {                                           \
    return launch_window_scatter<T>(grad, order, cell_start, out, B, H, W, C, hc, wc, K,    \
                                    stride, window, static_cast<cudaStream_t>(stream));     \
  }

OPP_SCATTER_ENTRY(opp_window_scatter_f32, float)
OPP_SCATTER_ENTRY(opp_window_scatter_bf16, __nv_bfloat16)
