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
//      cell-column range once; a thread owns one channel vector and walks the
//      row's pixels, so no division is left in its loop. It visits the at
//      most ceil(W/stride)^2 cells of its pixel in (row, column) order and
//      each cell's slots in ascending slot order, accumulates in f32 and
//      writes once in the map's dtype; a pixel under no window costs two
//      shared-memory reads and a store of zeros.
//
// Bound: device-memory bandwidth (one write of the map, one read of every
// gradient tap; the index arrays are a few KB). Neighbouring threads own
// neighbouring vectors of a pixel, so loads and stores coalesce. The vector
// is the widest of 16, 8, 4 or 2 bytes that divides a pixel's bytes and both
// base pointers (the wrapper picks it), so any C runs: the main path's f32
// pixels of 128 channels take 16-byte vectors, a bf16 pixel of 33 channels
// 2-byte ones. Whatever the vector, the sums are f32 in the same order.
#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ void from_f32(float x, float& y) { y = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16& y) { y = __float2bfloat16_rn(x); }

// N elements of T in one vector V (uint4, uint2, unsigned int or unsigned short).
template <typename T, typename V>
struct Vec {
  static constexpr int N = (int)(sizeof(V) / sizeof(T));
  static_assert(N >= 1 && sizeof(V) % sizeof(T) == 0, "a vector holds whole elements");
  __device__ static void add(const V& u, float* acc) {
    const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] += opp::to_f32(x[e]);
  }
  __device__ static V pack(const float* acc) {
    V u;
    T* x = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int e = 0; e < N; ++e) from_f32(acc[e], x[e]);
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

// MANY: a pixel has more vectors than the block has threads (nv > 1024), so
// a thread loops over several; otherwise it owns exactly one.
template <typename T, typename V, bool MANY>
__global__ void window_scatter_kernel(const T* __restrict__ grad, const int* __restrict__ order,
                                      const int* __restrict__ cell_start, T* __restrict__ out,
                                      int H, int W, int C, int hc, int wc, int K, int stride,
                                      int window) {
  constexpr int VEC = Vec<T, V>::N;
  extern __shared__ int sm[];
  const int nv = C / VEC;
  const int r = blockIdx.x, b = blockIdx.y;
  const int half = window / 2, taps = window * window;
  const int* starts = cell_start + (size_t)b * (hc * wc + 1);
  const int* ord = order + (size_t)b * K;
  const V* g = reinterpret_cast<const V*>(grad + (size_t)b * K * taps * C);
  V* o = reinterpret_cast<V*>(out + ((size_t)b * H + r) * W * C);

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

  // blockDim.x is a multiple of nl = min(nv, blockDim.x): this thread owns
  // channel vector v0 (and v0 + nl, ... where MANY) of every
  // (blockDim.x / nl)-th pixel of the row
  const int nl = MANY ? (int)blockDim.x : nv;
  const int v0 = threadIdx.x % nl;
  const int step = blockDim.x / nl;
  for (int c = threadIdx.x / nl; c < W; c += step) {
    const int2 cj = cols[c];
    const auto sum_vector = [&](int v) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      for (int a = 0; a < n_ci; ++a) {
        const int tr = r - (stride * (ci_lo + a) - half);
        const int* row = st + a * (wc + 1);
        for (int j = cj.x; j <= cj.y; ++j) {
          const int t = tr * window + (c - (stride * j - half));
          for (int s = row[j]; s < row[j + 1]; ++s) {
            const int slot = ord[s];
            Vec<T, V>::add(g[((size_t)slot * taps + t) * nv + v], acc);
          }
        }
      }
      o[(size_t)c * nv + v] = Vec<T, V>::pack(acc);
    };
    if constexpr (MANY) {
      for (int v = v0; v < nv; v += nl) sum_vector(v);
    } else {
      sum_vector(v0);
    }
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

template <typename T, typename V>
int launch_scatter_vec(const void* grad, const int* order, const int* cell_start, void* out,
                       int B, int H, int W, int C, int hc, int wc, int K, int stride, int window,
                       cudaStream_t stream) {
  constexpr int VEC = Vec<T, V>::N;
  if (C % VEC != 0 || reinterpret_cast<uintptr_t>(grad) % sizeof(V) != 0 ||
      reinterpret_cast<uintptr_t>(out) % sizeof(V) != 0)
    return (int)cudaErrorMisalignedAddress;
  const int nv = C / VEC;
  const int rows_in_reach = 2 * (window / 2) / stride + 1;
  const size_t smem = ((size_t)2 * W + (size_t)rows_in_reach * (wc + 1)) * sizeof(int);
  const auto launch = [&](auto kernel, int threads) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kernel<<<dim3(H, B), threads, smem, stream>>>(static_cast<const T*>(grad), order, cell_start,
                                                  static_cast<T*>(out), H, W, C, hc, wc, K,
                                                  stride, window);
  };
  if (nv > 1024)
    launch(window_scatter_kernel<T, V, true>, 1024);
  else
    launch(window_scatter_kernel<T, V, false>, nv * (nv >= 256 ? 1 : 256 / nv));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_window_scatter(const void* grad, const int* ids, int* order, int* cell_start,
                          void* out, int B, int H, int W, int C, int hc, int wc, int K,
                          int stride, int window, int vec_bytes, cudaStream_t stream) {
  if (B <= 0 || K <= 0 || C <= 0 || window <= 0 || stride <= 0) return (int)cudaErrorInvalidValue;
  if (vec_bytes != 16 && vec_bytes != 8 && vec_bytes != 4 && (vec_bytes != 2 || sizeof(T) > 2))
    return (int)cudaErrorInvalidValue;
  const int rc = launch_scatter_index(ids, order, cell_start, B, K, hc * wc, stream);
  if (rc != 0) return rc;
  switch (vec_bytes) {
    case 16:
      return launch_scatter_vec<T, uint4>(grad, order, cell_start, out, B, H, W, C, hc, wc, K,
                                          stride, window, stream);
    case 8:
      return launch_scatter_vec<T, uint2>(grad, order, cell_start, out, B, H, W, C, hc, wc, K,
                                          stride, window, stream);
    case 4:
      return launch_scatter_vec<T, unsigned int>(grad, order, cell_start, out, B, H, W, C, hc,
                                                 wc, K, stride, window, stream);
    default:  // 2 bytes: bf16 only
      if constexpr (sizeof(T) <= 2)
        return launch_scatter_vec<T, unsigned short>(grad, order, cell_start, out, B, H, W, C, hc,
                                                     wc, K, stride, window, stream);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The index launch alone: order [B, K] and cell_start [B, n_cells + 1] of ids [B, K].
extern "C" int opp_window_scatter_index(const int* ids, int* order, int* cell_start, int B, int K,
                                        int n_cells, void* stream) {
  return launch_scatter_index(ids, order, cell_start, B, K, n_cells,
                              static_cast<cudaStream_t>(stream));
}

// Both launches; order and cell_start are scratch the caller allocates.
// vec_bytes: 16, 8, 4 or 2, dividing C * sizeof(T) and both data pointers
// (ops/cuda_gather.py picks the widest).
#define OPP_SCATTER_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const void* grad, const int* ids, int* order, int* cell_start,          \
                      void* out, int B, int H, int W, int C, int hc, int wc, int K,           \
                      int stride, int window, int vec_bytes, void* stream) {                  \
    return launch_window_scatter<T>(grad, ids, order, cell_start, out, B, H, W, C, hc, wc,   \
                                    K, stride, window, vec_bytes,                           \
                                    static_cast<cudaStream_t>(stream));                     \
  }

OPP_SCATTER_ENTRY(opp_window_scatter_f32, float)
OPP_SCATTER_ENTRY(opp_window_scatter_bf16, __nv_bfloat16)
