// K3: direct 5x5 (W x W) window gather from the fine feature map.
//
// Replaces onepose_plus_plus_tpu/ops/pallas_gather.py::take_rows_mxu as used by
// ops/window_gather.py::gather_windows_aligned. The TPU needed a space-to-depth
// layout and one-hot matmuls to gather on its matrix unit; here the W*W taps
// of each window are copied straight from the NHWC map:
//   out[b, k, dr * W + dc, :] = feat[b, stride*ci - W/2 + dr, stride*cj - W/2 + dc, :]
// for cell_ids[b, k] = ci * wc + cj; taps outside the map, and every tap of an
// out-of-range id, are zero. Exact (a copy) for any element type: the kernel
// moves 16-byte vectors and never looks at the values.
//
// Bound: device-memory bandwidth (one read of the selected taps, one write of
// the [B, K, W*W, C] output; 105 MB in bf16 at the query step's [16, 512]
// windows of C = 128, 0.03 ms at 3.35 TB/s). The first design gave each window
// a block of 128 threads with one load in flight each, a division and a
// remainder per vector and a last pass on 16 of its threads: 39 % of the bound.
// Now one warp copies one window, 13 vectors a lane in flight (416 a warp
// pass: a bf16 window at C = 128 is 400, an f32 one two passes), all of a
// lane's loads issued before its stores. Neighbouring lanes hold neighbouring
// vectors of a tap, and the taps of a window row are neighbouring pixels, so
// loads and stores coalesce; the stores stream past L1 and L2 (st.global.cs),
// the output being read only by the next kernel. A vector's tap and its tap's
// row are a shift and a multiply (no division), and eight windows share a
// block, so a few blocks an SM keep ~150 KB in flight.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;          // windows a block, one warp each
constexpr int UNROLL = 13;        // 16-byte vectors in flight a lane
constexpr int MAGIC_SHIFT = 20;   // tap / window as (tap * magic) >> 20, exact for window <= 63
constexpr int MAX_WINDOW = 63;

// nv: 16-byte vectors a pixel; nv_shift = log2(nv) where nv is a power of two, else -1.
__global__ void __launch_bounds__(WARPS * 32)
window_gather_kernel(const uint4* __restrict__ feat, const int* __restrict__ ids,
                     uint4* __restrict__ out, int n_win, int H, int W, int nv, int nv_shift,
                     int hc, int wc, int K, int stride, int window, int magic) {
  const int lane = threadIdx.x & 31;
  const int wi = blockIdx.x * WARPS + (threadIdx.x >> 5);  // window (b, k), flat
  if (wi >= n_win) return;
  const int b = wi / K;
  const int id = __ldg(ids + wi);
  const bool ok = id >= 0 && id < hc * wc;
  const int ci = ok ? id / wc : 0, cj = ok ? id - (id / wc) * wc : 0;
  const int r0 = ci * stride - window / 2, c0 = cj * stride - window / 2;
  const int total = window * window * nv;
  const uint4* src = feat + (size_t)b * H * W * nv;
  uint4* dst = out + (size_t)wi * total;
  for (int base = 0; base < total; base += 32 * UNROLL) {
    uint4 val[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + lane + 32 * u;
      const int t = nv_shift >= 0 ? i >> nv_shift : i / nv;  // tap
      const int v = i - t * nv;                               // vector within the tap
      const int dr = (t * magic) >> MAGIC_SHIFT, dc = t - dr * window;
      const int r = r0 + dr, c = c0 + dc;
      val[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok && i < total && (unsigned)r < (unsigned)H && (unsigned)c < (unsigned)W)
        val[u] = __ldg(src + ((size_t)r * W + c) * nv + v);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + lane + 32 * u;
      if (i < total) __stcs(dst + i, val[u]);
    }
  }
}

int launch_window_gather(const void* feat, const int* ids, void* out, int B, int H, int W,
                         int row_bytes, int hc, int wc, int K, int stride, int window,
                         cudaStream_t stream) {
  if (B <= 0 || K <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 || window <= 0 ||
      window > MAX_WINDOW)
    return (int)cudaErrorInvalidValue;
  const int nv = row_bytes / 16;
  const int nv_shift = (nv & (nv - 1)) == 0 ? __builtin_ctz(nv) : -1;
  const int magic = ((1 << MAGIC_SHIFT) + window - 1) / window;
  const int n_win = B * K;
  window_gather_kernel<<<(n_win + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      static_cast<const uint4*>(feat), ids, static_cast<uint4*>(out), n_win, H, W, nv, nv_shift,
      hc, wc, K, stride, window, magic);
  return (int)cudaGetLastError();
}

}  // namespace

#define OPP_GATHER_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const void* feat, const int* ids, void* out, int B, int H, int W,      \
                      int C, int hc, int wc, int K, int stride, int window, void* stream) { \
    return launch_window_gather(feat, ids, out, B, H, W, C * (int)sizeof(T), hc, wc, K,     \
                                stride, window, static_cast<cudaStream_t>(stream));          \
  }

OPP_GATHER_ENTRY(opp_window_gather_f32, float)
OPP_GATHER_ENTRY(opp_window_gather_bf16, __nv_bfloat16)
