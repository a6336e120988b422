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
// the same bit for bit from run to run, so no float is summed by atomics.
// Two launches:
//   1. scatter_index_kernel orders the slots by cell id, stably, and finds
//      each cell's range of ordered slots: a slot's place is the number of
//      slots that sort before it, counted by brute force over the ids staged
//      in shared memory (eight lanes a slot); a cell's start is the number of
//      slots of smaller cells, one block of 256 cells counting the keys below
//      its first cell and taking a prefix sum of its histogram of the rest.
//      A library sort, searchsorted and their casts took eight launches.
//   2. window_sum_kernel, the span sum. Blocks own a map row (cut into
//      pieces where a row has more than SUM_THREADS * SUM_CHUNKS chunks) and
//      stage in shared memory the cell_start entries of the one or two cell
//      rows whose windows reach it, each pixel column's cell-column range and
//      whether any slot's window holds it, and (where they fit) the ordered
//      slots of those cells, one run of `order`. A thread owns aligned 16-byte
//      chunks of the map row, a span of W * P bytes for a pixel of P bytes,
//      so every store is 16 bytes (a row's partial first and last chunks
//      store their own 2-byte halves) whatever P is. A window's tap row is one
//      span of window * P bytes of grad lying over pixels stride*cj - W/2 ...
//      of the map row, so a chunk's bytes in it come from one or two aligned
//      16-byte loads and a funnel shift (span.cuh, as K6 copies), and an
//      element adds only where its pixel lies inside that window (a select,
//      not an add of zero). Every element sums in f32, visiting the cells in
//      (row, column) order and each cell's slots in ascending slot order, and
//      is written once in the map's dtype; a chunk under no window stores
//      zeros. The chunk's pixel columns come from a multiply-high by
//      ceil(2^64 / P), so nothing in the loop divides.
//
// Bound: device-memory bandwidth (one write of the map, one read of every
// gradient tap and of the index arrays). The first port moved the widest
// vector dividing a pixel's bytes, so a bf16 pixel of 33 channels took 2
// bytes a load and a store (12 % of the bound); the span sum moves 16 bytes a
// lane at any pixel. What held it back next was how many blocks an SM keeps:
// four slots' loads issued before their adds, or an L2 prefetch of the
// block's tap rows, cost registers or L2 room; capped at 40 registers (six
// blocks an SM) and one load a slot it reads the f32 pixel of 128 channels,
// the training path's, as fast as a kernel of one thread a 16-byte vector of
// a pixel did, which it replaces. Neighbouring threads own neighbouring
// chunks, so loads and stores coalesce.
#include <cstdint>

#include <cuda_bf16.h>

#include "span.cuh"

namespace {

// cells c whose window (columns stride*c - half ... stride*c - half + window - 1)
// holds x, clipped to [0, n)
__device__ __forceinline__ void cell_range(int x, int half, int window, int stride, int n,
                                           int& lo, int& hi) {
  const int below = x + half - window + 1;  // stride * c >= below
  lo = below <= 0 ? 0 : (below + stride - 1) / stride;
  hi = min(n - 1, (x + half) / stride);
}

// The block's shared tables: cols [W] (each pixel column's cell-column range),
// st [n_ci, wc + 1] (cell_start of the cell rows in reach of map row r, from
// cell row ci_lo on), the ordered slots of those cells, which are the one run
// order[s_first, s_first + s_count), into `staged` where s_count <= slot_cap,
// and busy [W] (whether any slot's window holds the pixel column). The slot
// of rank s is slots[s - s_first].
struct RowTables {
  const int2* cols;
  const int* st;
  const int* slots;
  const unsigned char* busy;
  int ci_lo, n_ci, s_first;
};

__device__ __forceinline__ RowTables stage_row(int* sm, const int* __restrict__ starts,
                                               const int* __restrict__ ord, int r, int W, int hc,
                                               int wc, int stride, int window, int rows_in_reach,
                                               int slot_cap) {
  const int half = window / 2;
  int ci_lo, ci_hi;
  cell_range(r, half, window, stride, hc, ci_lo, ci_hi);
  const int n_ci = max(0, ci_hi - ci_lo + 1);
  int2* cols = reinterpret_cast<int2*>(sm);
  int* st = sm + 2 * W;
  int* staged = st + rows_in_reach * (wc + 1);
  unsigned char* busy = reinterpret_cast<unsigned char*>(staged + slot_cap);
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    int lo, hi;
    cell_range(c, half, window, stride, wc, lo, hi);
    cols[c] = make_int2(lo, hi);
  }
  for (int i = threadIdx.x; i < n_ci * (wc + 1); i += blockDim.x) {
    const int rr = i / (wc + 1);
    st[i] = starts[(ci_lo + rr) * wc + (i - rr * (wc + 1))];
  }
  const int s_first = n_ci > 0 ? starts[ci_lo * wc] : 0;
  const int s_count = n_ci > 0 ? starts[(ci_hi + 1) * wc] - s_first : 0;
  const bool in_smem = s_count <= slot_cap;
  if (in_smem)
    for (int i = threadIdx.x; i < s_count; i += blockDim.x) staged[i] = ord[s_first + i];
  __syncthreads();
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    bool any = false;
    for (int a = 0; a < n_ci; ++a)
      for (int j = cols[c].x; j <= cols[c].y; ++j) any |= st[a * (wc + 1) + j + 1] > st[a * (wc + 1) + j];
    busy[c] = any;
  }
  __syncthreads();
  return {cols, st, in_smem ? staged : ord + s_first, busy, ci_lo, n_ci, s_first};
}

constexpr int IDX_THREADS = 256;
constexpr int IDX_PARTS = 8;                          // threads a slot, each counting an eighth of the keys
constexpr int IDX_SLOTS = IDX_THREADS / IDX_PARTS;    // slots a slot block
constexpr int IDX_CELLS = IDX_THREADS;                // cells a cell block, one a thread
constexpr int IDX_CHUNK = 2048;                       // ids staged in shared memory at a time
constexpr int IDX_WARPS = IDX_THREADS / 32;

__device__ __forceinline__ int key_of(int id, int n_cells) { return (id >= 0 && id < n_cells) ? id : n_cells; }

// order[b, :]: the slots in a stable order of their key (the cell id, or
// n_cells for an id outside the grid); cell_start[b, c], c in [0, n_cells]:
// the number of slots whose key is below c. Blocks below slot_blocks rank
// slots: a slot's place is the number of keys below its own, and of equal keys
// at smaller slot index, counted by IDX_PARTS neighbouring lanes over the
// staged keys (lane p of them comparing 16-byte groups p, p + IDX_PARTS, ...:
// no bank conflicts) and added by shuffles. The others each take IDX_CELLS
// consecutive cells from c0 on: the keys below c0, counted over the block, plus
// a prefix sum of the block's histogram of the keys in [c0, c0 + IDX_CELLS).
// Every sum is of integers, exact in any order (the histogram's shared-memory
// atomics too), so both arrays are the same from run to run.
__global__ void __launch_bounds__(IDX_THREADS)
scatter_index_kernel(const int* __restrict__ ids, int* __restrict__ order,
                     int* __restrict__ cell_start, int K, int n_cells, int slot_blocks) {
  __shared__ __align__(16) int keys[IDX_CHUNK];  // a slot block's staged keys; a cell block's histogram
  __shared__ int warp_sums[2][IDX_WARPS];
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* idb = ids + (size_t)b * K;
  if ((int)blockIdx.x >= slot_blocks) {
    const int c0 = (blockIdx.x - slot_blocks) * IDX_CELLS;
    keys[threadIdx.x] = 0;
    __syncthreads();
    int below = 0;
    for (int j = threadIdx.x; j < K; j += IDX_THREADS) {
      const int key = key_of(idb[j], n_cells);
      below += key < c0;
      if (key >= c0 && key < c0 + IDX_CELLS) atomicAdd(keys + (key - c0), 1);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) below += __shfl_xor_sync(0xffffffffu, below, m);
    if (lane == 0) warp_sums[0][warp] = below;
    __syncthreads();
    const int v = keys[threadIdx.x];
    int x = v;  // the histogram's inclusive prefix within the warp
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, m);
      if (lane >= m) x += y;
    }
    if (lane == 31) warp_sums[1][warp] = x;
    __syncthreads();
    int start = x - v;
    for (int w = 0; w < IDX_WARPS; ++w) start += warp_sums[0][w] + (w < warp ? warp_sums[1][w] : 0);
    const int c = c0 + threadIdx.x;
    if (c <= n_cells) cell_start[(size_t)b * (n_cells + 1) + c] = start;
    return;
  }
  const int part = threadIdx.x % IDX_PARTS;
  const int i = blockIdx.x * IDX_SLOTS + threadIdx.x / IDX_PARTS;
  const bool is_slot = i < K;
  const int my_key = is_slot ? key_of(idb[i], n_cells) : 0;
  int count = 0;
  for (int base = 0; base < K; base += IDX_CHUNK) {
    const int len = min(IDX_CHUNK, K - base);
    const int padded = (len + 3) & ~3;
    __syncthreads();
    for (int j = threadIdx.x; j < padded; j += blockDim.x)
      keys[j] = j < len ? key_of(idb[base + j], n_cells) : 0x7fffffff;  // padding sorts after everything
    __syncthreads();
    if (is_slot) {
      const int lim = i - base;  // equal keys count below a slot at smaller slot index
      for (int j = 4 * part; j < padded; j += 4 * IDX_PARTS) {
        const int4 q = *reinterpret_cast<const int4*>(keys + j);
        count += (q.x < my_key) | ((q.x == my_key) & (j < lim));
        count += (q.y < my_key) | ((q.y == my_key) & (j + 1 < lim));
        count += (q.z < my_key) | ((q.z == my_key) & (j + 2 < lim));
        count += (q.w < my_key) | ((q.w == my_key) & (j + 3 < lim));
      }
    }
  }
#pragma unroll
  for (int m = 1; m < IDX_PARTS; m <<= 1) count += __shfl_xor_sync(0xffffffffu, count, m);
  if (is_slot && part == 0) order[(size_t)b * K + count] = i;
}

constexpr int SUM_THREADS = 256;
constexpr int SUM_MIN_BLOCKS = 6;  // blocks an SM: at most 40 registers a thread (more blocks in flight)
constexpr int SUM_CHUNKS = 8;      // chunks a thread: a map row is cut into blocks of SUM_THREADS * SUM_CHUNKS
constexpr int SLOT_CAP = 8192;     // ordered slots a block stages (32 KB)

// acc[e] += element e of the 16 bytes u where its bytes lie in [lo, hi): a
// select, not an add of zero, so a sum of -0.0 keeps its sign.
__device__ __forceinline__ void add_chunk(float (&acc)[4], const uint4& u, int lo, int hi) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = __uint_as_float(w[e]);
    acc[e] = (4 * e >= lo && 4 * e < hi) ? acc[e] + x : acc[e];
  }
}
__device__ __forceinline__ void add_chunk(float (&acc)[8], const uint4& u, int lo, int hi) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {  // bf16: the odd element in a word's high half
    const float x = __uint_as_float((e & 1) ? w[e >> 1] & 0xFFFF0000u : w[e >> 1] << 16);
    acc[e] = (2 * e >= lo && 2 * e < hi) ? acc[e] + x : acc[e];
  }
}
__device__ __forceinline__ uint4 pack_chunk(const float (&acc)[4]) {
  return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]), __float_as_uint(acc[2]),
                    __float_as_uint(acc[3]));
}
__device__ __forceinline__ uint4 pack_chunk(const float (&acc)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The span sum: block (r, b, z) owns the aligned chunks [z * per, (z + 1) *
// per) of map row r, the bytes [0, W * P) of the row from its address (a
// chunk's byte 0 at row offset 16 t - lead, lead = the row's address mod 16),
// and this thread the chunks t, t + SUM_THREADS, ... of them.
// magic_p = ceil(2^64 / P): a row offset's pixel column is its multiply-high
// by it. A chunk whose pixels lie under no window stores zeros.
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS, SUM_MIN_BLOCKS)
window_sum_kernel(const char* __restrict__ grad, const int* __restrict__ order,
                  const int* __restrict__ cell_start, char* __restrict__ out, int H, int W,
                  int P, int hc, int wc, int K, int stride, int window, int rows_in_reach,
                  int slot_cap, int per, unsigned long long magic_p, long long vec_lo) {
  constexpr int E = 16 / (int)sizeof(T);  // elements a chunk
  extern __shared__ __align__(16) int sm[];
  const int r = blockIdx.x, b = blockIdx.y;
  const int half = window / 2;
  const long long slot_bytes = (long long)window * window * P;
  const RowTables tb = stage_row(sm, cell_start + (size_t)b * (hc * wc + 1), order + (size_t)b * K,
                                 r, W, hc, wc, stride, window, rows_in_reach, slot_cap);
  const int pitch = W * P;  // bytes a map row (under 2^31)
  const long long row = reinterpret_cast<long long>(out) + ((long long)b * H + r) * pitch;
  const int lead = (int)(row & 15);
  char* const first = reinterpret_cast<char*>(row - lead);
  const int t_end = min((lead + pitch + 15) >> 4, (int)(blockIdx.z + 1) * per);
  const long long g_img = reinterpret_cast<long long>(grad) + (long long)b * K * slot_bytes;
  for (int t = blockIdx.z * per + threadIdx.x; t < t_end; t += SUM_THREADS) {
    const int o0 = 16 * t - lead;  // the row offset of the chunk's byte 0
    const int s_lo = max(0, -o0), s_hi = min(16, pitch - o0);  // its bytes in the row
    const int x_lo = (int)__umul64hi((unsigned long long)(o0 + s_lo), magic_p);
    const int x_hi = (int)__umul64hi((unsigned long long)(o0 + s_hi - 1), magic_p);
    bool busy = false;
    for (int x = x_lo; x <= x_hi; ++x) busy |= tb.busy[x];
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (busy) {
      const int j_lo = tb.cols[x_lo].x, j_hi = tb.cols[x_hi].y;  // the cell columns in reach of its pixels
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
      for (int a = 0; a < tb.n_ci; ++a) {
        const int tr = r - (stride * (tb.ci_lo + a) - half);  // the cell row's windows' tap row on map row r
        const int* row_st = tb.st + a * (wc + 1);
        for (int j = j_lo; j <= j_hi; ++j) {
          const int s0 = row_st[j], s1 = row_st[j + 1];
          if (s0 == s1) continue;
          const int c0 = stride * j - half;  // the window's first pixel column
          const int cl = max(c0, 0), ch = min(c0 + window, W);  // its columns on the map
          const int lo = max(s_lo, cl * P - o0), hi = min(s_hi, ch * P - o0);
          if (hi <= lo) continue;  // a window over the chunk's other pixels only
          // grad address of the chunk's byte 0 in the tap row, less the slot's offset
          const long long src = g_img + ((long long)tr * window - c0) * P + o0;
          for (int s = s0; s < s1; ++s)
            add_chunk(acc, opp::load16(src + tb.slots[s - tb.s_first] * slot_bytes, hi, vec_lo), lo, hi);
        }
      }
      val = pack_chunk(acc);
    }
    opp::store_chunk(first + 16 * t, val, s_lo, s_hi);
  }
}

int launch_scatter_index(const int* ids, int* order, int* cell_start, int B, int K, int n_cells,
                         cudaStream_t stream) {
  if (B <= 0 || K <= 0 || n_cells <= 0) return (int)cudaErrorInvalidValue;
  const int slot_blocks = (K + IDX_SLOTS - 1) / IDX_SLOTS;
  const int cell_blocks = (n_cells + 1 + IDX_CELLS - 1) / IDX_CELLS;
  scatter_index_kernel<<<dim3(slot_blocks + cell_blocks, B), IDX_THREADS, 0, stream>>>(
      ids, order, cell_start, K, n_cells, slot_blocks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_window_scatter(const void* grad, const int* ids, int* order, int* cell_start,
                          void* out, int B, int H, int W, int C, int hc, int wc, int K,
                          int stride, int window, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || K <= 0 || C <= 0 || window <= 0 ||
      stride <= 0 || hc <= 0 || wc <= 0 || (long long)W * C * sizeof(T) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int P = C * (int)sizeof(T);
  const uintptr_t g = reinterpret_cast<uintptr_t>(grad), o = reinterpret_cast<uintptr_t>(out);
  if (g % sizeof(T) || o % sizeof(T)) return (int)cudaErrorMisalignedAddress;
  const int rc = launch_scatter_index(ids, order, cell_start, B, K, hc * wc, stream);
  if (rc != 0) return rc;
  const int rows_in_reach = (window - 1) / stride + 1;
  const int slot_cap = K < SLOT_CAP ? K : SLOT_CAP;
  const size_t smem = ((size_t)2 * W + (size_t)rows_in_reach * (wc + 1) + slot_cap) * sizeof(int) + W;
  const int n_chunks = (15 + W * P + 15) >> 4;  // the most a row touches
  const int segments = (n_chunks + SUM_THREADS * SUM_CHUNKS - 1) / (SUM_THREADS * SUM_CHUNKS);
  if (segments > 65535) return (int)cudaErrorInvalidValue;
  const int per = (n_chunks + segments - 1) / segments;
  const unsigned long long magic_p = ~0ull / (unsigned long long)P + 1;  // ceil(2^64 / P)
  const auto kernel = window_sum_kernel<T>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<dim3(H, B, segments), SUM_THREADS, smem, stream>>>(
      static_cast<const char*>(grad), order, cell_start, static_cast<char*>(out), H, W, P, hc, wc,
      K, stride, window, rows_in_reach, slot_cap, per, magic_p, (long long)(g & ~(uintptr_t)15));
  return (int)cudaGetLastError();
}

}  // namespace

// The index launch alone: order [B, K] and cell_start [B, n_cells + 1] of ids [B, K].
extern "C" int opp_window_scatter_index(const int* ids, int* order, int* cell_start, int B, int K,
                                        int n_cells, void* stream) {
  return launch_scatter_index(ids, order, cell_start, B, K, n_cells,
                              static_cast<cudaStream_t>(stream));
}

// Both launches; order and cell_start are scratch the caller allocates; grad
// and out aligned to their element.
#define OPP_SCATTER_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const void* grad, const int* ids, int* order, int* cell_start,          \
                      void* out, int B, int H, int W, int C, int hc, int wc, int K,           \
                      int stride, int window, void* stream) {                                 \
    return launch_window_scatter<T>(grad, ids, order, cell_start, out, B, H, W, C, hc, wc,   \
                                    K, stride, window, static_cast<cudaStream_t>(stream));  \
  }

OPP_SCATTER_ENTRY(opp_window_scatter_f32, float)
OPP_SCATTER_ENTRY(opp_window_scatter_bf16, __nv_bfloat16)
