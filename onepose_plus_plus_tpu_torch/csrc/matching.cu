// K2: streaming dual-softmax statistics, never materialising [P, L].
//
// Replaces onepose_plus_plus_tpu/ops/pallas_matching.py::dual_softmax_rowcol_stats
// (_lse_kernel + _argmax_kernel). With s = f0 f1^T * inv_temp + masks:
//   row_lse[p], col_lse[l]             (log-sum-exp over l / over p)
//   row_best_j[p] = argmax_l (2 s - col_lse[l]),  col_best_p[l] = argmax_p (2 s - row_lse[p])
// with the lowest index kept on ties in both directions.
//
// Two passes, flash-style. Each block owns a BR-row tile of f0 and streams all
// L columns in BL-wide tiles, recomputing the similarity tile each pass:
//   1. lse_kernel: row LSE stays in the block (online max/sum); column
//      statistics of the tile are written as per-row-tile partial LSEs
//      [B, n_row_tiles, L] (a block cannot carry a sum across blocks), and
//      col_lse_reduce merges them in a second launch.
//   2. argmax_kernel: row argmax in the block; per-row-tile column argmax
//      partials, merged by col_argmax_reduce (tiles in order, so the lowest
//      row index wins ties).
// Operands are T (float or bf16), accumulation f32.
//
// Bound: FP32 FMA throughput (two P*L*C GEMM passes), then the 2 exp per
// similarity element of pass 1. Design: a 64x64 register-blocked tile (4x4 per
// thread) over 32-deep shared-memory slices of f0 and f1, then the tile is
// staged in shared memory for the row and column reductions (4 lanes per row
// or column, shuffle-merged). Tensor cores (wgmma) are later work.
#include <climits>

#include "sim_tile.cuh"

namespace {

using namespace opp;

// merge (max, sum-exp) pairs across the 4 lanes of a group
__device__ __forceinline__ void merge_lse4(float& m, float& s) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    const float nm = fmaxf(m, om);
    s = s * expf(m - nm) + os * expf(om - nm);
    m = nm;
  }
}

// merge (value, index) argmax pairs across the 4 lanes, lowest index on ties
__device__ __forceinline__ void merge_argmax4(float& v, int& i) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) lse_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                                                 const float* __restrict__ radd,
                                                 const float* __restrict__ cadd,
                                                 float* __restrict__ row_lse,
                                                 float* __restrict__ colpart, int P, int L, int C,
                                                 float inv_temp) {
  __shared__ TileSmem sm;
  const int pt = blockIdx.x, n_pt = gridDim.x, b = blockIdx.y;
  const int p0 = pt * BR;
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3;  // row / column g, quarter q
  const T* f0b = f0 + (size_t)b * P * C;
  const T* f1b = f1 + (size_t)b * L * C;
  const float* raddb = radd != nullptr ? radd + (size_t)b * P : nullptr;
  const float* caddb = cadd != nullptr ? cadd + (size_t)b * L : nullptr;
  float* cpart = colpart + ((size_t)b * n_pt + pt) * L;

  float rm = NEG, rs = 0.f;  // running row max / sum of row g
  for (int l0 = 0; l0 < L; l0 += BL) {
    sim_tile<T>(f0b, f1b, raddb, caddb, p0, l0, P, L, C, inv_temp, sm);
    // row g over columns q*16 .. q*16+15
    float m = NEG, s = 0.f;
    for (int j = 0; j < 16; ++j) {
      const int c = q * 16 + j;
      if (l0 + c < L) m = fmaxf(m, sm.s[g][c]);
    }
    for (int j = 0; j < 16; ++j) {
      const int c = q * 16 + j;
      if (l0 + c < L) s += expf(sm.s[g][c] - m);
    }
    merge_lse4(m, s);
    const float nm = fmaxf(rm, m);
    rs = rs * expf(rm - nm) + s * expf(m - nm);
    rm = nm;
    // column g over rows q*16 .. q*16+15
    float cm = NEG, cs = 0.f;
    for (int j = 0; j < 16; ++j) {
      const int r = q * 16 + j;
      if (p0 + r < P) cm = fmaxf(cm, sm.s[r][g]);
    }
    for (int j = 0; j < 16; ++j) {
      const int r = q * 16 + j;
      if (p0 + r < P) cs += expf(sm.s[r][g] - cm);
    }
    merge_lse4(cm, cs);
    if (q == 0 && l0 + g < L) cpart[l0 + g] = cs > 0.f ? cm + logf(cs) : NEG;
    __syncthreads();
  }
  if (q == 0 && p0 + g < P) row_lse[(size_t)b * P + p0 + g] = rm + logf(rs);
}

__global__ void col_lse_reduce(const float* __restrict__ colpart, float* __restrict__ col_lse,
                               int n_pt, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (l >= L) return;
  const float* p = colpart + (size_t)b * n_pt * L + l;
  float m = NEG;
  for (int t = 0; t < n_pt; ++t) m = fmaxf(m, p[(size_t)t * L]);
  float s = 0.f;
  for (int t = 0; t < n_pt; ++t) s += expf(p[(size_t)t * L] - m);
  col_lse[(size_t)b * L + l] = m + logf(s);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    argmax_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                  const float* __restrict__ radd, const float* __restrict__ cadd,
                  const float* __restrict__ row_lse, const float* __restrict__ col_lse,
                  float* __restrict__ row_val, int* __restrict__ row_j,
                  float* __restrict__ cpart_val, int* __restrict__ cpart_idx, int P, int L, int C,
                  float inv_temp) {
  __shared__ TileSmem sm;
  __shared__ float rl[BR];
  __shared__ float cl[BL];
  const int pt = blockIdx.x, n_pt = gridDim.x, b = blockIdx.y;
  const int p0 = pt * BR;
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3;
  const T* f0b = f0 + (size_t)b * P * C;
  const T* f1b = f1 + (size_t)b * L * C;
  const float* raddb = radd != nullptr ? radd + (size_t)b * P : nullptr;
  const float* caddb = cadd != nullptr ? cadd + (size_t)b * L : nullptr;
  const size_t cbase = ((size_t)b * n_pt + pt) * L;
  if (threadIdx.x < BR) {
    const int p = p0 + threadIdx.x;
    rl[threadIdx.x] = p < P ? row_lse[(size_t)b * P + p] : 0.f;
  }

  float bv = NEG;
  int bj = 0;
  for (int l0 = 0; l0 < L; l0 += BL) {
    if (threadIdx.x < BL) {
      const int l = l0 + threadIdx.x;
      cl[threadIdx.x] = l < L ? col_lse[(size_t)b * L + l] : 0.f;
    }
    sim_tile<T>(f0b, f1b, raddb, caddb, p0, l0, P, L, C, inv_temp, sm);  // syncs
    // row g: argmax over columns of 2 s - col_lse
    float v = NEG;
    int j = INT_MAX;
    for (int jj = 0; jj < 16; ++jj) {
      const int c = q * 16 + jj;
      if (l0 + c < L) {
        const float sc = 2.f * sm.s[g][c] - cl[c];
        if (sc > v) {
          v = sc;
          j = l0 + c;
        }
      }
    }
    merge_argmax4(v, j);
    if (v > bv) {
      bv = v;
      bj = j;
    }
    // column g: argmax over rows of 2 s - row_lse
    float cv = NEG;
    int cp = INT_MAX;
    for (int jj = 0; jj < 16; ++jj) {
      const int r = q * 16 + jj;
      if (p0 + r < P) {
        const float sc = 2.f * sm.s[r][g] - rl[r];
        if (sc > cv) {
          cv = sc;
          cp = p0 + r;
        }
      }
    }
    merge_argmax4(cv, cp);
    if (q == 0 && l0 + g < L) {
      cpart_val[cbase + l0 + g] = cv;
      cpart_idx[cbase + l0 + g] = cp;
    }
    __syncthreads();
  }
  if (q == 0 && p0 + g < P) {
    row_val[(size_t)b * P + p0 + g] = bv;
    row_j[(size_t)b * P + p0 + g] = bj;
  }
}

__global__ void col_argmax_reduce(const float* __restrict__ cpart_val,
                                  const int* __restrict__ cpart_idx, float* __restrict__ col_val,
                                  int* __restrict__ col_p, int n_pt, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (l >= L) return;
  const size_t base = (size_t)b * n_pt * L + l;
  float v = NEG;
  int p = 0;
  for (int t = 0; t < n_pt; ++t) {  // row tiles in order: strict > keeps the lowest row
    const float ov = cpart_val[base + (size_t)t * L];
    if (ov > v) {
      v = ov;
      p = cpart_idx[base + (size_t)t * L];
    }
  }
  col_val[(size_t)b * L + l] = v;
  col_p[(size_t)b * L + l] = p;
}

template <typename T>
int launch_rowcol_stats(const void* f0, const void* f1, const float* radd, const float* cadd,
                        float* row_lse, float* col_lse, float* row_val, int* row_j,
                        float* col_val, int* col_p, float* part_val, int* part_idx, int B, int P,
                        int L, int C, float inv_temp, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || L <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int n_pt = (P + BR - 1) / BR;
  const dim3 grid(n_pt, B), rgrid((L + 255) / 256, B);
  const T* a = static_cast<const T*>(f0);
  const T* b = static_cast<const T*>(f1);
  lse_kernel<T><<<grid, NT, 0, stream>>>(a, b, radd, cadd, row_lse, part_val, P, L, C, inv_temp);
  col_lse_reduce<<<rgrid, 256, 0, stream>>>(part_val, col_lse, n_pt, L);
  argmax_kernel<T><<<grid, NT, 0, stream>>>(a, b, radd, cadd, row_lse, col_lse, row_val, row_j,
                                            part_val, part_idx, P, L, C, inv_temp);
  col_argmax_reduce<<<rgrid, 256, 0, stream>>>(part_val, part_idx, col_val, col_p, n_pt, L);
  return (int)cudaGetLastError();
}

// Pass 1 alone (row and column LSE), for K5's forward (coarse_loss.cu), as the
// TPU kernel shares pallas_matching._lse_kernel with the fused focal loss.
template <typename T>
int launch_dual_lse(const void* f0, const void* f1, const float* radd, const float* cadd,
                    float* row_lse, float* col_lse, float* part, int B, int P, int L, int C,
                    float inv_temp, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || L <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int n_pt = (P + BR - 1) / BR;
  lse_kernel<T><<<dim3(n_pt, B), NT, 0, stream>>>(static_cast<const T*>(f0),
                                                  static_cast<const T*>(f1), radd, cadd, row_lse,
                                                  part, P, L, C, inv_temp);
  col_lse_reduce<<<dim3((L + 255) / 256, B), 256, 0, stream>>>(part, col_lse, n_pt, L);
  return (int)cudaGetLastError();
}

}  // namespace

#define OPP_STATS_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const void* f0, const void* f1, const float* radd, const float* cadd, \
                      float* row_lse, float* col_lse, float* row_val, int* row_j,           \
                      float* col_val, int* col_p, float* part_val, int* part_idx, int B,    \
                      int P, int L, int C, float inv_temp, void* stream) {                  \
    return launch_rowcol_stats<T>(f0, f1, radd, cadd, row_lse, col_lse, row_val, row_j,     \
                                  col_val, col_p, part_val, part_idx, B, P, L, C, inv_temp, \
                                  static_cast<cudaStream_t>(stream));                       \
  }

OPP_STATS_ENTRY(opp_rowcol_stats_f32, float)
OPP_STATS_ENTRY(opp_rowcol_stats_bf16, __nv_bfloat16)

// Row tiles of the partial buffers: part_val / part_idx are [B, tiles, L].
extern "C" int opp_rowcol_row_tiles(int P) { return (P + opp::BR - 1) / opp::BR; }

#define OPP_LSE_ENTRY(NAME, T)                                                                \
  extern "C" int NAME(const void* f0, const void* f1, const float* radd, const float* cadd,  \
                      float* row_lse, float* col_lse, float* part, int B, int P, int L, int C, \
                      float inv_temp, void* stream) {                                        \
    return launch_dual_lse<T>(f0, f1, radd, cadd, row_lse, col_lse, part, B, P, L, C,        \
                              inv_temp, static_cast<cudaStream_t>(stream));                  \
  }

OPP_LSE_ENTRY(opp_dual_lse_f32, float)
OPP_LSE_ENTRY(opp_dual_lse_bf16, __nv_bfloat16)
