// K3: direct 5x5 (W x W) window gather from the fine feature map.
//
// Replaces onepose_plus_plus_tpu/ops/pallas_gather.py::take_rows_mxu as used by
// ops/window_gather.py::gather_windows_aligned. The TPU needed a space-to-depth
// layout and one-hot matmuls to gather on its matrix unit; here each block
// copies the W*W taps of one window straight from the NHWC map:
//   out[b, k, dr * W + dc, :] = feat[b, stride*ci - W/2 + dr, stride*cj - W/2 + dc, :]
// for cell_ids[b, k] = ci * wc + cj; taps outside the map, and every tap of an
// out-of-range id, are zero. Exact (a copy) for any T.
//
// Bound: device-memory bandwidth (one read of the selected taps, one write of
// the [B, K, W*W, C] output). Design: one block per window, 16-byte vector
// copies with neighbouring threads on neighbouring addresses.
#include "common.cuh"

namespace {

template <typename T>
__global__ void window_gather_kernel(const T* __restrict__ feat, const int* __restrict__ ids,
                                     T* __restrict__ out, int H, int W, int C, int hc, int wc,
                                     int K, int stride, int window) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  const int k = blockIdx.x, b = blockIdx.y;
  const int id = ids[(size_t)b * K + k];
  const bool ok = id >= 0 && id < hc * wc;
  const int ci = ok ? id / wc : 0, cj = ok ? id % wc : 0;
  const int half = window / 2;
  const int nv = C / VEC;  // vectors per tap
  const int taps = window * window;
  const uint4* src = reinterpret_cast<const uint4*>(feat + (size_t)b * H * W * C);
  uint4* dst = reinterpret_cast<uint4*>(out + ((size_t)b * K + k) * taps * C);
  for (int i = threadIdx.x; i < taps * nv; i += blockDim.x) {
    const int t = i / nv, v = i % nv;
    const int r = ci * stride - half + t / window;
    const int c = cj * stride - half + t % window;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (ok && r >= 0 && r < H && c >= 0 && c < W) val = src[((size_t)r * W + c) * nv + v];
    dst[i] = val;
  }
}

template <typename T>
int launch_window_gather(const void* feat, const int* ids, void* out, int B, int H, int W,
                         int C, int hc, int wc, int K, int stride, int window,
                         cudaStream_t stream) {
  if (B <= 0 || K <= 0 || C % (16 / (int)sizeof(T)) != 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  window_gather_kernel<T><<<dim3(K, B), 128, 0, stream>>>(static_cast<const T*>(feat), ids,
                                                          static_cast<T*>(out), H, W, C, hc, wc,
                                                          K, stride, window);
  return (int)cudaGetLastError();
}

}  // namespace

#define OPP_GATHER_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const void* feat, const int* ids, void* out, int B, int H, int W,      \
                      int C, int hc, int wc, int K, int stride, int window, void* stream) { \
    return launch_window_gather<T>(feat, ids, out, B, H, W, C, hc, wc, K, stride, window,   \
                                   static_cast<cudaStream_t>(stream));                      \
  }

OPP_GATHER_ENTRY(opp_window_gather_f32, float)
OPP_GATHER_ENTRY(opp_window_gather_bf16, __nv_bfloat16)
