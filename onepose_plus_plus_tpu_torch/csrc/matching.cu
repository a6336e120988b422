// K2: streaming dual-softmax statistics, never materialising [P, L].
//
// Replaces onepose_plus_plus_tpu/ops/pallas_matching.py::dual_softmax_rowcol_stats
// (_lse_kernel + _argmax_kernel). With s = f0 f1^T * inv_temp + masks:
//   row_lse[p], col_lse[l]             (log-sum-exp over l / over p)
//   row_best_j[p] = argmax_l (2 s - col_lse[l]),  col_best_p[l] = argmax_p (2 s - row_lse[p])
// with the lowest index kept on ties in both directions.
//
// Two passes, flash-style. Each block owns a 64-row tile of f0 and streams all
// L columns in 64-wide tiles, recomputing the similarity tile each pass:
//   1. lse: row LSE stays in the block (online max/sum); column statistics of
//      the tile are written as per-row-tile partial LSEs [B, n_row_tiles, L]
//      (a block cannot carry a sum across blocks), and col_lse_reduce merges
//      them in a second launch, tiles in order.
//   2. argmax: row argmax in the block; per-row-tile column argmax partials,
//      merged by col_argmax_reduce (tiles in order, so the lowest row index
//      wins ties).
// No atomics: the result is the same bit for bit from run to run.
//
// Bound: two P*L*C products (operations), then the exponentials of pass 1:
// 2 P L of them, which the special-function units issue at 16 a clock per SM
// (0.25 ms at the query step's [16, 7000] x [16, 4096], beside 0.12 ms a
// product at the tensor cores' peak). Three instances:
//
// bf16 operands (the bench, inference and SfM configurations): the tensor
// cores (sim_tile_tc.cuh). The wrapper packs f0 and f1 once, scaled, rounded
// and zero-padded (pack_operand_kernel, one launch each), so that every 64-row
// tile is one bulk copy; one warpgroup a block keeps its f0 tile resident and
// streams the f1 tiles through a two-stage ring; m64n64k16 products leave s
// in registers, and both reductions run on the accumulator fragment: a row
// over the 4 lanes of a quad (a running max and sum a thread, merged at the
// end), a column over the 8 quads of a warp by shuffles and across the 4
// warps through a 2 KB scratch, in a fixed order. The column argmax takes the
// column's largest value first and then the lowest row holding it by an
// integer min: half the time of shuffling (value, index) pairs. Exponentials
// are ex2.approx (branch-free; a few ulp), with the max subtracted in natural
// units so that the masks' -1e9 rounds as in the plain version. Two blocks
// share an SM, so one block's exponentials overlap the other's products.
//
// f32 operands up to C = 576 (the demo and the train config): the same passes
// and epilogues on the tensor cores in split TF32 (sim_tile_tf32.cuh: three
// TF32 products a product, f32 accuracy; lse_tf32x3_kernel,
// argmax_tf32x3_kernel). The wrapper packs f0 and f1 as scaled f32 in 32-channel
// chunks (pack_tf32_operand_kernel). Bound: the three products at the TF32
// rate, 3 x 2 P L C / 495 TFLOP/s a pass, and the L2 rate of the streamed
// f32 chunks (4 bytes a value, twice bf16's).
//
// f32 operands wider than 576 (and bf16 ones wider than the bf16 tile):
// exact f32 FMAs on the CUDA cores, a 64x64 register-blocked tile
// (sim_tile.cuh) staged in shared memory for the row and column reductions
// (4 lanes per row or column, shuffle-merged).
#include <climits>

#include "sim_tile.cuh"
#include "sim_tile_tc.cuh"
#include "sim_tile_tf32.cuh"

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

// ------------------------------------------------------ bf16: tensor cores

namespace tcm {

// (sim_tile.cuh's opp::NT and opp::NEG are the CUDA-core tile's)
using opp::tc::col_max;
using opp::tc::col_min;
using opp::tc::col_sum;
using opp::tc::exp_fast;
using opp::tc::lanes_argmax;
using opp::tc::LN2;
using opp::tc::MAX_C;
using opp::tc::NEG;
using opp::tc::NT;
using opp::tc::NWARP;
using opp::tc::pad_channels;
using opp::tc::pad_rows;
using opp::tc::quad_max;
using opp::tc::quad_sum;
using opp::tc::sim_product;
using opp::tc::smem_bytes;
using opp::tc::Tiles;
using opp::tc::TM;
using bf16 = __nv_bfloat16;

// dst [B, rows_pad / 8, Cp / 8, 8, 8] bf16 (sim_tile_tc.cuh's layout) of
// src [B, rows, C] (T = float or bf16) times `scale`, rounded to bf16 as
// torch's (x * scale).to(bfloat16); zeros past rows and C. One thread per 16
// output bytes (8 channels of one row): output index i * 8, written in order.
template <typename T>
__global__ void pack_operand_kernel(const T* __restrict__ src, bf16* __restrict__ dst, int rows,
                                    int rows_pad, int C, int cp, float scale, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r8 = (int)(i & 7);
  long long rest = i >> 3;
  const int kg = (int)(rest % (cp / 8));
  rest /= cp / 8;
  const int rg = (int)(rest % (rows_pad / 8));
  const long long b = rest / (rows_pad / 8);
  const int r = rg * 8 + r8, k0 = kg * 8;
  __align__(16) bf16 out[8];
  const T* row = src + ((size_t)b * rows + r) * C;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    out[k] = __float2bfloat16_rn(r < rows && k0 + k < C ? opp::to_f32(row[k0 + k]) * scale : 0.f);
  *reinterpret_cast<uint4*>(dst + i * 8) = *reinterpret_cast<const uint4*>(out);
}

// The bf16 similarity tile (sim_tile_tc.cuh) as the passes read it.
struct Bf16Sim {
  Tiles tl;
  int cp;
  uint32_t a_addr = 0;
  __device__ Bf16Sim(unsigned char* smem, int cp_, const bf16* f1b, int n_tiles)
      : tl(smem, cp_, f1b, n_tiles), cp(cp_) {}
  __device__ __forceinline__ void start(const bf16* f0_tile) {
    tl.start(f0_tile);
    a_addr = tl.resident();
  }
  __device__ __forceinline__ int n_tiles() const { return tl.n_tiles; }
  // issued and committed only: the caller waits
  __device__ __forceinline__ void product(float (&acc)[32], int it) const {
    sim_product(acc, a_addr, tl.wait(it), cp);
  }
  __device__ __forceinline__ float* cols(int it) const { return tl.cols(it); }
  __device__ __forceinline__ void release(int it) const { tl.release(it); }
};

// The split-TF32 tile (sim_tile_tf32.cuh): products complete on return.
using opp::tf::Tf32Sim;

// Pass 1: row LSE and per-row-tile column partial LSEs (natural units), on
// the block's similarity tiles.
template <typename Sim>
__device__ __forceinline__ void lse_pass(Sim& sim, const float* __restrict__ radd,
                                         const float* __restrict__ cadd,
                                         float* __restrict__ row_lse, float* __restrict__ colpart,
                                         int P, int L, float inv_temp) {
  const int pt = blockIdx.x, n_pt = gridDim.x, b = blockIdx.y;
  const int p0 = pt * TM, tid = threadIdx.x, w = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  float ra[2];  // row masks; rows past P drop out of the column statistics
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + 16 * w + g + 8 * h;
    ra[h] = p < P ? (radd != nullptr ? radd[(size_t)b * P + p] : 0.f) : NEG;
  }
  float rm[2] = {NEG, NEG}, rs[2] = {0.f, 0.f};  // this thread's running row max / sum
  float* cpart = colpart + ((size_t)b * n_pt + pt) * L;

#pragma unroll 1
  for (int it = 0; it < sim.n_tiles(); ++it) {
    const int l0 = it * TM;
    float acc[32];
    sim.product(acc, it);
    float ca[16];  // column masks; columns past L drop out of the row statistics
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int l = l0 + 8 * (q >> 1) + 2 * t + (q & 1);
      ca[q] = l < L ? (cadd != nullptr ? cadd[(size_t)b * L + l] : 0.f) : NEG;
    }
    wg::wait<0>();
    wg::fence_regs(acc);
    // s = dot * inv_temp + row mask + column mask, in the plain version's order
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i] = __fadd_rn(__fadd_rn(__fmul_rn(acc[i], inv_temp), ra[(i >> 1) & 1]),
                         ca[2 * (i >> 2) + (i & 1)]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = rm[h];
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      float sum = rs[h] * exp_fast(rm[h] - m);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum += exp_fast(acc[4 * j + 2 * h] - m) + exp_fast(acc[4 * j + 2 * h + 1] - m);
      rm[h] = m;
      rs[h] = sum;
    }
    float* sc = sim.cols(it);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int i = 4 * (q >> 1) + (q & 1);  // rows g (acc[i]) and g + 8 (acc[i + 2])
      const float cm = col_max(fmaxf(acc[i], acc[i + 2]));
      const float cs = col_sum(exp_fast(acc[i] - cm) + exp_fast(acc[i + 2] - cm));
      if (g == 0) {
        const int col = 8 * (q >> 1) + 2 * t + (q & 1);
        sc[w * TM + col] = cm;
        sc[NWARP * TM + w * TM + col] = cs;
      }
    }
    __syncthreads();
    sim.release(it);
    if (tid < TM && l0 + tid < L) {
      float m = sc[tid];
#pragma unroll
      for (int v = 1; v < NWARP; ++v) m = fmaxf(m, sc[v * TM + tid]);
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < NWARP; ++v)
        sum += sc[NWARP * TM + v * TM + tid] * exp_fast(sc[v * TM + tid] - m);
      cpart[l0 + tid] = m + log2f(sum) * LN2;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = quad_max(rm[h]);
    const float sum = quad_sum(rs[h] * exp_fast(rm[h] - m));
    const int p = p0 + 16 * w + g + 8 * h;
    if (t == 0 && p < P) row_lse[(size_t)b * P + p] = m + log2f(sum) * LN2;
  }
}

__global__ void __launch_bounds__(NT, 2)
    lse_tc_kernel(const bf16* __restrict__ f0, const bf16* __restrict__ f1,
                  const float* __restrict__ radd, const float* __restrict__ cadd,
                  float* __restrict__ row_lse, float* __restrict__ colpart, int P, int L, int C,
                  float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = pad_channels(C), b = blockIdx.y;
  Bf16Sim sim(smem, cp, f1 + (size_t)b * pad_rows(L) * cp, pad_rows(L) / TM);
  sim.start(f0 + ((size_t)b * pad_rows(P) + blockIdx.x * TM) * cp);
  lse_pass(sim, radd, cadd, row_lse, colpart, P, L, inv_temp);
}

__global__ void __launch_bounds__(NT, 2)
    lse_tf32x3_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                      const float* __restrict__ radd, const float* __restrict__ cadd,
                      float* __restrict__ row_lse, float* __restrict__ colpart, int P, int L,
                      int C, float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = opp::tf::pad_channels(C), b = blockIdx.y;
  Tf32Sim sim(smem, cp, f1 + (size_t)b * pad_rows(L) * cp, pad_rows(L) / TM);
  sim.start(f0 + ((size_t)b * pad_rows(P) + blockIdx.x * TM) * cp);
  lse_pass(sim, radd, cadd, row_lse, colpart, P, L, inv_temp);
}

// Pass 2: row argmax of 2 s - col_lse and per-row-tile column argmax partials
// of 2 s - row_lse, the lowest index on ties.
template <typename Sim>
__device__ __forceinline__ void argmax_pass(Sim& sim, const float* __restrict__ radd,
                                            const float* __restrict__ cadd,
                                            const float* __restrict__ row_lse,
                                            const float* __restrict__ col_lse,
                                            float* __restrict__ row_val, int* __restrict__ row_j,
                                            float* __restrict__ cpart_val,
                                            int* __restrict__ cpart_idx, int P, int L,
                                            float inv_temp) {
  const int pt = blockIdx.x, n_pt = gridDim.x, b = blockIdx.y;
  const int p0 = pt * TM, tid = threadIdx.x, w = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  float ra[2], rl[2];
  int rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + 16 * w + g + 8 * h;
    rows[h] = p;
    ra[h] = p < P ? (radd != nullptr ? radd[(size_t)b * P + p] : 0.f) : NEG;
    rl[h] = p < P ? row_lse[(size_t)b * P + p] : 0.f;
  }
  float bv[2] = {NEG, NEG};
  int bj[2] = {0, 0};
  const size_t cbase = ((size_t)b * n_pt + pt) * L;

#pragma unroll 1
  for (int it = 0; it < sim.n_tiles(); ++it) {
    const int l0 = it * TM;
    float acc[32];
    sim.product(acc, it);
    float ca[16], cl[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int l = l0 + 8 * (q >> 1) + 2 * t + (q & 1);
      ca[q] = l < L ? (cadd != nullptr ? cadd[(size_t)b * L + l] : 0.f) : NEG;
      cl[q] = l < L ? col_lse[(size_t)b * L + l] : 0.f;
    }
    wg::wait<0>();
    wg::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i] = __fadd_rn(__fadd_rn(__fmul_rn(acc[i], inv_temp), ra[(i >> 1) & 1]),
                         ca[2 * (i >> 2) + (i & 1)]);
    // rows: this thread's columns in ascending order, strict > keeps the first
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = 2.f * acc[4 * (q >> 1) + 2 * h + (q & 1)] - cl[q];
        const bool take = v > bv[h];
        bv[h] = take ? v : bv[h];
        bj[h] = take ? l0 + 8 * (q >> 1) + 2 * t + (q & 1) : bj[h];
      }
    // columns: the largest value over the warp's 16 rows, then the lowest row holding it
    float* sc = sim.cols(it);
    int* si = reinterpret_cast<int*>(sc + NWARP * TM);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int i = 4 * (q >> 1) + (q & 1);
      const float v0 = 2.f * acc[i] - rl[0], v1 = 2.f * acc[i + 2] - rl[1];
      const float v = col_max(fmaxf(v0, v1));
      const int r = col_min(v0 == v ? rows[0] : v1 == v ? rows[1] : INT_MAX);
      if (g == 0) {
        const int col = 8 * (q >> 1) + 2 * t + (q & 1);
        sc[w * TM + col] = v;
        si[w * TM + col] = r;
      }
    }
    __syncthreads();
    sim.release(it);
    if (tid < TM && l0 + tid < L) {  // warps in order: rows ascending, strict > keeps the lowest
      float v = sc[tid];
      int r = si[tid];
#pragma unroll
      for (int u = 1; u < NWARP; ++u) {
        const bool take = sc[u * TM + tid] > v;
        v = take ? sc[u * TM + tid] : v;
        r = take ? si[u * TM + tid] : r;
      }
      cpart_val[cbase + l0 + tid] = v;
      cpart_idx[cbase + l0 + tid] = r;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lanes_argmax<1, 2>(bv[h], bj[h]);
    if (t == 0 && rows[h] < P) {
      row_val[(size_t)b * P + rows[h]] = bv[h];
      row_j[(size_t)b * P + rows[h]] = bj[h];
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
    argmax_tc_kernel(const bf16* __restrict__ f0, const bf16* __restrict__ f1,
                     const float* __restrict__ radd, const float* __restrict__ cadd,
                     const float* __restrict__ row_lse, const float* __restrict__ col_lse,
                     float* __restrict__ row_val, int* __restrict__ row_j,
                     float* __restrict__ cpart_val, int* __restrict__ cpart_idx, int P, int L,
                     int C, float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = pad_channels(C), b = blockIdx.y;
  Bf16Sim sim(smem, cp, f1 + (size_t)b * pad_rows(L) * cp, pad_rows(L) / TM);
  sim.start(f0 + ((size_t)b * pad_rows(P) + blockIdx.x * TM) * cp);
  argmax_pass(sim, radd, cadd, row_lse, col_lse, row_val, row_j, cpart_val, cpart_idx, P, L,
              inv_temp);
}

__global__ void __launch_bounds__(NT, 2)
    argmax_tf32x3_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                         const float* __restrict__ radd, const float* __restrict__ cadd,
                         const float* __restrict__ row_lse, const float* __restrict__ col_lse,
                         float* __restrict__ row_val, int* __restrict__ row_j,
                         float* __restrict__ cpart_val, int* __restrict__ cpart_idx, int P, int L,
                         int C, float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = opp::tf::pad_channels(C), b = blockIdx.y;
  Tf32Sim sim(smem, cp, f1 + (size_t)b * pad_rows(L) * cp, pad_rows(L) / TM);
  sim.start(f0 + ((size_t)b * pad_rows(P) + blockIdx.x * TM) * cp);
  argmax_pass(sim, radd, cadd, row_lse, col_lse, row_val, row_j, cpart_val, cpart_idx, P, L,
              inv_temp);
}

int launch_dual_lse_tc(const void* f0, const void* f1, const float* radd, const float* cadd,
                       float* row_lse, float* col_lse, float* part, int B, int P, int L, int C,
                       float inv_temp, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || L <= 0 || C <= 0 || C > MAX_C) return (int)cudaErrorInvalidValue;
  const int cp = pad_channels(C), n_pt = pad_rows(P) / TM;
  static int have[opp::MAX_DEVICES];
  opp::raise_smem_limit(lse_tc_kernel, smem_bytes(cp), have);
  lse_tc_kernel<<<dim3(n_pt, B), NT, smem_bytes(cp), stream>>>(
      static_cast<const bf16*>(f0), static_cast<const bf16*>(f1), radd, cadd, row_lse, part, P, L,
      C, inv_temp);
  col_lse_reduce<<<dim3((L + 255) / 256, B), 256, 0, stream>>>(part, col_lse, n_pt, L);
  return (int)cudaGetLastError();
}

int launch_rowcol_stats_tc(const void* f0, const void* f1, const float* radd, const float* cadd,
                           float* row_lse, float* col_lse, float* row_val, int* row_j,
                           float* col_val, int* col_p, float* part_val, int* part_idx, int B,
                           int P, int L, int C, float inv_temp, cudaStream_t stream) {
  const int rc = launch_dual_lse_tc(f0, f1, radd, cadd, row_lse, col_lse, part_val, B, P, L, C,
                                    inv_temp, stream);
  if (rc != 0) return rc;
  const int cp = pad_channels(C), n_pt = pad_rows(P) / TM;
  static int have[opp::MAX_DEVICES];
  opp::raise_smem_limit(argmax_tc_kernel, smem_bytes(cp), have);
  argmax_tc_kernel<<<dim3(n_pt, B), NT, smem_bytes(cp), stream>>>(
      static_cast<const bf16*>(f0), static_cast<const bf16*>(f1), radd, cadd, row_lse, col_lse,
      row_val, row_j, part_val, part_idx, P, L, C, inv_temp);
  col_argmax_reduce<<<dim3((L + 255) / 256, B), 256, 0, stream>>>(part_val, part_idx, col_val,
                                                                   col_p, n_pt, L);
  return (int)cudaGetLastError();
}

// Both passes on the split-TF32 tile (f32 operands packed by launch_pack_tf32).
int launch_rowcol_stats_tf32x3(const void* f0, const void* f1, const float* radd,
                               const float* cadd, float* row_lse, float* col_lse, float* row_val,
                               int* row_j, float* col_val, int* col_p, float* part_val,
                               int* part_idx, int B, int P, int L, int C, float inv_temp,
                               cudaStream_t stream) {
  if (B <= 0 || P <= 0 || L <= 0 || C <= 0 || C > opp::tf::MAX_C) return (int)cudaErrorInvalidValue;
  const int cp = opp::tf::pad_channels(C), n_pt = pad_rows(P) / TM;
  const size_t smem = opp::tf::smem_bytes(cp);
  const float* a = static_cast<const float*>(f0);
  const float* b = static_cast<const float*>(f1);
  static int have_lse[opp::MAX_DEVICES], have_arg[opp::MAX_DEVICES];
  opp::raise_smem_limit(lse_tf32x3_kernel, smem, have_lse);
  opp::raise_smem_limit(argmax_tf32x3_kernel, smem, have_arg);
  lse_tf32x3_kernel<<<dim3(n_pt, B), NT, smem, stream>>>(a, b, radd, cadd, row_lse, part_val, P,
                                                         L, C, inv_temp);
  col_lse_reduce<<<dim3((L + 255) / 256, B), 256, 0, stream>>>(part_val, col_lse, n_pt, L);
  argmax_tf32x3_kernel<<<dim3(n_pt, B), NT, smem, stream>>>(a, b, radd, cadd, row_lse, col_lse,
                                                            row_val, row_j, part_val, part_idx, P,
                                                            L, C, inv_temp);
  col_argmax_reduce<<<dim3((L + 255) / 256, B), 256, 0, stream>>>(part_val, part_idx, col_val,
                                                                   col_p, n_pt, L);
  return (int)cudaGetLastError();
}

// dst [B, rows_pad / 64, Cp / 32, 8, 8, 8, 4] f32 (sim_tile_tf32.cuh's layout)
// of src [B, rows, C] f32 times `scale`; zeros past rows and C. One thread per 16 output bytes
// (4 channels of one row): output index i * 4, written in order.
__global__ void pack_tf32_operand_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                         int rows, int rows_pad, int C, int cp, float scale,
                                         long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // i = ((((b * tiles + tile) * chunks + chunk) * 8 + rg) * 8 + kq) * 8 + r8
  const int r8 = (int)(i & 7), kq = (int)((i >> 3) & 7), rg = (int)((i >> 6) & 7);
  long long rest = i >> 9;
  const int chunk = (int)(rest % (cp / 32));
  rest /= cp / 32;
  const int tile = (int)(rest % (rows_pad / TM));
  const long long b = rest / (rows_pad / TM);
  const int r = tile * TM + rg * 8 + r8, k0 = chunk * 32 + kq * 4;
  float4 out;
  float* o = &out.x;
  const float* row = src + ((size_t)b * rows + r) * C;
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = r < rows && k0 + k < C ? row[k0 + k] * scale : 0.f;
  reinterpret_cast<float4*>(dst)[i] = out;
}

int launch_pack_tf32(const void* src, void* dst, int B, int rows, int C, float scale,
                     cudaStream_t stream) {
  if (B <= 0 || rows <= 0 || C <= 0 || C > opp::tf::MAX_C) return (int)cudaErrorInvalidValue;
  const int cp = opp::tf::pad_channels(C), rows_pad = pad_rows(rows);
  const long long n = (long long)B * rows_pad * (cp / 4);
  pack_tf32_operand_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), rows, rows_pad, C, cp, scale, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pack(const void* src, void* dst, int B, int rows, int C, float scale,
                cudaStream_t stream) {
  if (B <= 0 || rows <= 0 || C <= 0 || C > MAX_C) return (int)cudaErrorInvalidValue;
  const int cp = pad_channels(C), rows_pad = pad_rows(rows);
  const long long n = (long long)B * rows_pad * (cp / 8);
  pack_operand_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(src), static_cast<bf16*>(dst), rows, rows_pad, C, cp, scale, n);
  return (int)cudaGetLastError();
}

}  // namespace tcm

}  // namespace

// f32 operands [B, P, C] / [B, L, C] (CUDA cores; the widths the split-TF32
// instance does not take). part_val / part_idx are [B, tiles, L] with
// tiles = opp_rowcol_row_tiles(P).
extern "C" int opp_rowcol_stats_f32(const void* f0, const void* f1, const float* radd,
                                    const float* cadd, float* row_lse, float* col_lse,
                                    float* row_val, int* row_j, float* col_val, int* col_p,
                                    float* part_val, int* part_idx, int B, int P, int L, int C,
                                    float inv_temp, void* stream) {
  return launch_rowcol_stats<float>(f0, f1, radd, cadd, row_lse, col_lse, row_val, row_j,
                                    col_val, col_p, part_val, part_idx, B, P, L, C, inv_temp,
                                    static_cast<cudaStream_t>(stream));
}

// bf16 operands on the tensor cores: f0 and f1 packed by opp_pack_operand_*
// (already scaled; C <= 576 channels before padding), the other arguments as
// the f32 entry's.
extern "C" int opp_rowcol_stats_bf16(const void* f0, const void* f1, const float* radd,
                                     const float* cadd, float* row_lse, float* col_lse,
                                     float* row_val, int* row_j, float* col_val, int* col_p,
                                     float* part_val, int* part_idx, int B, int P, int L, int C,
                                     float inv_temp, void* stream) {
  return tcm::launch_rowcol_stats_tc(f0, f1, radd, cadd, row_lse, col_lse, row_val, row_j,
                                     col_val, col_p, part_val, part_idx, B, P, L, C, inv_temp,
                                     static_cast<cudaStream_t>(stream));
}

// Row tiles of the partial buffers: part_val / part_idx are [B, tiles, L].
extern "C" int opp_rowcol_row_tiles(int P) { return (P + opp::BR - 1) / opp::BR; }

// f32 operands on the tensor cores in split TF32: f0 and f1 packed by
// opp_pack_tf32_operand_f32 (already scaled; C <= 576 channels before padding),
// the other arguments as the f32 entry's.
extern "C" int opp_rowcol_stats_tf32x3(const void* f0, const void* f1, const float* radd,
                                       const float* cadd, float* row_lse, float* col_lse,
                                       float* row_val, int* row_j, float* col_val, int* col_p,
                                       float* part_val, int* part_idx, int B, int P, int L, int C,
                                       float inv_temp, void* stream) {
  return tcm::launch_rowcol_stats_tf32x3(f0, f1, radd, cadd, row_lse, col_lse, row_val, row_j,
                                         col_val, col_p, part_val, part_idx, B, P, L, C, inv_temp,
                                         static_cast<cudaStream_t>(stream));
}

// Pass 1 alone (row and column LSE), for K5's forward (coarse_loss.cu), as the
// TPU kernel shares pallas_matching._lse_kernel with the fused focal loss:
extern "C" int opp_dual_lse_bf16(const void* f0, const void* f1, const float* radd,
                                 const float* cadd, float* row_lse, float* col_lse, float* part,
                                 int B, int P, int L, int C, float inv_temp, void* stream) {
  return tcm::launch_dual_lse_tc(f0, f1, radd, cadd, row_lse, col_lse, part, B, P, L, C,
                                 inv_temp, static_cast<cudaStream_t>(stream));
}

// The operand layout of the tensor-core instances (K2 bf16, K5): dst
// [B, rows_pad / 8, Cp / 8, 8, 8] bf16 of src [B, rows, C] times scale, with
// Cp = C rounded up to 16 and rows_pad = rows rounded up to 64.
extern "C" int opp_pack_operand_f32(const void* src, void* dst, int B, int rows, int C,
                                    float scale, void* stream) {
  return tcm::launch_pack<float>(src, dst, B, rows, C, scale, static_cast<cudaStream_t>(stream));
}
extern "C" int opp_pack_operand_bf16(const void* src, void* dst, int B, int rows, int C,
                                     float scale, void* stream) {
  return tcm::launch_pack<__nv_bfloat16>(src, dst, B, rows, C, scale,
                                         static_cast<cudaStream_t>(stream));
}

// The operand layout of the split-TF32 instance (K2 f32): dst
// [B, rows_pad / 64, Cp / 32, 8, 8, 8, 4] f32 of src [B, rows, C] times scale,
// with Cp = C rounded up to 32 and rows_pad = rows rounded up to 64.
extern "C" int opp_pack_tf32_operand_f32(const void* src, void* dst, int B, int rows, int C,
                                         float scale, void* stream) {
  return tcm::launch_pack_tf32(src, dst, B, rows, C, scale, static_cast<cudaStream_t>(stream));
}
