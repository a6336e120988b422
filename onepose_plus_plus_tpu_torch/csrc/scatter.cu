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
// the same bit for bit from run to run, so there are no atomics. Two launches:
//   1. scatter_index_kernel orders the slots by cell id, stably, and finds
//      each cell's range of ordered slots. It is a counting sort by brute
//      force: one thread per slot counts the slots that sort before it (its
//      place in `order`), one thread per cell counts the slots of smaller
//      cells (`cell_start`); every block stages the ids in shared memory and
//      reads them as broadcasts. K * (K + cells) comparisons (6.5 M a batch
//      element at the train shape) spread over the whole card take a few
//      microseconds, where a library sort, searchsorted and their casts took
//      eight launches.
//   2. window_scatter_kernel: one block per (map row, batch element). The
//      block loads the cell_start entries of the one or two cell rows whose
//      windows reach its map row into shared memory, and each pixel column's
//      cell-column range once; a thread owns one 16-byte channel vector and
//      walks the row's pixels, so no division is left in its loop. It visits
//      the at most ceil(W/stride)^2 cells of its pixel in (row, column) order
//      and each cell's slots in ascending slot order, accumulates in f32 and
//      writes once in the map's dtype; a pixel under no window costs two
//      shared-memory reads and a 16-byte store of zeros.
//
// Bound: device-memory bandwidth (one write of the map, one read of every
// gradient tap; the index arrays are a few KB). Neighbouring threads own
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

constexpr int IDX_THREADS = 256;
constexpr int IDX_CHUNK = 2048;  // ids staged in shared memory at a time

// order[b, :]: the slots in a stable order of their key (the cell id, or
// n_cells for an id outside the grid); cell_start[b, c], c in [0, n_cells]:
// the number of slots whose key is below c. Thread i < K is slot i, thread
// K + c is cell c.
__global__ void scatter_index_kernel(const int* __restrict__ ids, int* __restrict__ order,
                                     int* __restrict__ cell_start, int K, int n_cells) {
  __shared__ __align__(16) int keys[IDX_CHUNK];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int* idb = ids + (size_t)b * K;
  const bool is_slot = i < K;
  const bool is_cell = !is_slot && i - K <= n_cells;
  int my_key = i - K;
  if (is_slot) {
    const int id = idb[i];
    my_key = (id >= 0 && id < n_cells) ? id : n_cells;
  }
  // a slot also comes after the equal keys of smaller slot index; a cell does not
  const int ties_below = is_slot ? i : 0;
  int count = 0;
  for (int base = 0; base < K; base += IDX_CHUNK) {
    const int len = min(IDX_CHUNK, K - base);
    const int padded = (len + 3) & ~3;
    __syncthreads();
    for (int j = threadIdx.x; j < padded; j += blockDim.x) {
      int key = 0x7fffffff;  // padding sorts after everything
      if (j < len) {
        const int id = idb[base + j];
        key = (id >= 0 && id < n_cells) ? id : n_cells;
      }
      keys[j] = key;
    }
    __syncthreads();
    if (is_slot || is_cell) {
      const int lim = ties_below - base;
      for (int j = 0; j < padded; j += 4) {
        const int4 q = *reinterpret_cast<const int4*>(keys + j);
        count += (q.x < my_key) | ((q.x == my_key) & (j < lim));
        count += (q.y < my_key) | ((q.y == my_key) & (j + 1 < lim));
        count += (q.z < my_key) | ((q.z == my_key) & (j + 2 < lim));
        count += (q.w < my_key) | ((q.w == my_key) & (j + 3 < lim));
      }
    }
  }
  if (is_slot) order[(size_t)b * K + count] = i;
  else if (is_cell) cell_start[(size_t)b * (n_cells + 1) + my_key] = count;
}

template <typename T>
__global__ void window_scatter_kernel(const T* __restrict__ grad, const int* __restrict__ order,
                                      const int* __restrict__ cell_start, T* __restrict__ out,
                                      int H, int W, int C, int hc, int wc, int K, int stride,
                                      int window) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ int sm[];
  const int nv = C / VEC;
  const int r = blockIdx.x, b = blockIdx.y;
  const int half = window / 2, taps = window * window;
  const int* starts = cell_start + (size_t)b * (hc * wc + 1);
  const int* ord = order + (size_t)b * K;
  const uint4* g = reinterpret_cast<const uint4*>(grad + (size_t)b * K * taps * C);
  uint4* o = reinterpret_cast<uint4*>(out + ((size_t)b * H + r) * W * C);

  int ci_lo, ci_hi;
  cell_range(r, half, stride, hc, ci_lo, ci_hi);
  const int n_ci = max(0, ci_hi - ci_lo + 1);
  int2* cols = reinterpret_cast<int2*>(sm);  // [W] cell columns whose windows hold pixel column c
  int* st = sm + 2 * W;                      // [n_ci, wc + 1] cell_start of the cell rows in reach
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    int lo, hi;
    cell_range(c, half, stride, wc, lo, hi);
    cols[c] = make_int2(lo, hi);
  }
  for (int i = threadIdx.x; i < n_ci * (wc + 1); i += blockDim.x) {
    const int rr = i / (wc + 1);
    st[i] = starts[(ci_lo + rr) * wc + (i - rr * (wc + 1))];
  }
  __syncthreads();

  // blockDim.x is a multiple of nv: this thread owns channel vector v of
  // every (blockDim.x / nv)-th pixel of the row
  const int v = threadIdx.x % nv;
  const int step = blockDim.x / nv;
  for (int c = threadIdx.x / nv; c < W; c += step) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    const int2 cj = cols[c];
    for (int a = 0; a < n_ci; ++a) {
      const int tr = r - (stride * (ci_lo + a) - half);
      const int* row = st + a * (wc + 1);
      for (int j = cj.x; j <= cj.y; ++j) {
        const int t = tr * window + (c - (stride * j - half));
        for (int s = row[j]; s < row[j + 1]; ++s) {
          const int slot = ord[s];
          Vec<T>::add(g[((size_t)slot * taps + t) * nv + v], acc);
        }
      }
    }
    o[(size_t)c * nv + v] = Vec<T>::pack(acc);
  }
}

int launch_scatter_index(const int* ids, int* order, int* cell_start, int B, int K, int n_cells,
                         cudaStream_t stream) {
  if (B <= 0 || K <= 0 || n_cells <= 0) return (int)cudaErrorInvalidValue;
  const int n = K + n_cells + 1;
  scatter_index_kernel<<<dim3((n + IDX_THREADS - 1) / IDX_THREADS, B), IDX_THREADS, 0, stream>>>(
      ids, order, cell_start, K, n_cells);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_window_scatter(const void* grad, const int* ids, int* order, int* cell_start,
                          void* out, int B, int H, int W, int C, int hc, int wc, int K,
                          int stride, int window, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  if (B <= 0 || K <= 0 || C % VEC != 0 || C / VEC > 1024 || window <= 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  const int rc = launch_scatter_index(ids, order, cell_start, B, K, hc * wc, stream);
  if (rc != 0) return rc;
  const int nv = C / VEC;
  const int threads = nv * (nv >= 256 ? 1 : 256 / nv);
  const int rows_in_reach = 2 * (window / 2) / stride + 1;
  const size_t smem = ((size_t)2 * W + (size_t)rows_in_reach * (wc + 1)) * sizeof(int);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(window_scatter_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  window_scatter_kernel<T><<<dim3(H, B), threads, smem, stream>>>(
      static_cast<const T*>(grad), order, cell_start, static_cast<T*>(out), H, W, C, hc, wc, K,
      stride, window);
  return (int)cudaGetLastError();
}

}  // namespace

// The index launch alone: order [B, K] and cell_start [B, n_cells + 1] of ids [B, K].
extern "C" int opp_window_scatter_index(const int* ids, int* order, int* cell_start, int B, int K,
                                        int n_cells, void* stream) {
  return launch_scatter_index(ids, order, cell_start, B, K, n_cells,
                              static_cast<cudaStream_t>(stream));
}

// Both launches; order and cell_start are scratch the caller allocates.
#define OPP_SCATTER_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* grad, const int* ids, int* order, int* cell_start,        \
                      void* out, int B, int H, int W, int C, int hc, int wc, int K,         \
                      int stride, int window, void* stream) {                               \
    return launch_window_scatter<T>(grad, ids, order, cell_start, out, B, H, W, C, hc, wc, \
                                    K, stride, window, static_cast<cudaStream_t>(stream)); \
  }

OPP_SCATTER_ENTRY(opp_window_scatter_f32, float)
OPP_SCATTER_ENTRY(opp_window_scatter_bf16, __nv_bfloat16)
