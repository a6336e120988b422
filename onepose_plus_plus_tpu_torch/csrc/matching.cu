// K2: streaming dual-softmax statistics, never materialising [P, L].
//
// Replaces onepose_plus_plus_tpu/ops/pallas_matching.py::dual_softmax_rowcol_stats
// (_lse_kernel + _argmax_kernel). With s = f0 f1^T * inv_temp + masks:
//   row_lse[p], col_lse[l]             (log-sum-exp over l / over p)
//   row_best_j[p] = argmax_l (2 s - col_lse[l]),  col_best_p[l] = argmax_p (2 s - row_lse[p])
// with the lowest index kept on ties in both directions.
//
// Two passes, flash-style. Each block owns a 64-row tile of f0 and streams all
// L columns in 64-wide tiles (128-wide above 576 channels), recomputing the
// similarity tile each pass:
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
// product at the tensor cores' peak). Four instances, all on the tensor cores
// (ops/cuda_matching.py::k2_instance routes), all with the same two passes
// and epilogues (lse_pass, argmax_pass, over column tiles of Sim::NC):
//
// bf16 operands up to C = 576 (the bench, inference and SfM configurations):
// sim_tile_tc.cuh. The wrapper packs f0 and f1 once, scaled, rounded
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
// TF32 products a product, each pair of 32-channel chunks in a fresh
// accumulator added in f32, f32 accuracy; lse_tf32x3_kernel,
// argmax_tf32x3_kernel). The wrapper packs f0 and f1 as scaled f32 in 32-channel
// chunks (pack_tf32_operand_kernel). Bound: the three products at the TF32
// rate, 3 x 2 P L C / 495 TFLOP/s a pass, and the L2 rate of the streamed
// f32 chunks (4 bytes a value, twice bf16's).
//
// Above 576 channels, at any width (wider coarse stages): sim_tile_wide.cuh,
// bf16 (lse_wide_bf16_kernel, argmax_wide_bf16_kernel; packs by
// pack_wide_bf16_kernel) or f32 in split TF32 (lse_wide_tf32x3_kernel,
// argmax_wide_tf32x3_kernel; f0 by pack_tf32_operand_kernel, f1 as TF32 hi and
// lo images by pack_tf32_hilo_kernel): both operands streamed in channel
// chunks from L2, 128-column tiles, the same epilogues over 128 columns.
#include <climits>

#include "sim_tile_tc.cuh"
#include "sim_tile_tf32.cuh"
#include "sim_tile_wide.cuh"

namespace {

using namespace opp;
using opp::tc::NEG;

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

// ------------------------------------------------------ bf16: tensor cores

namespace tcm {

using opp::tc::col_max;
using opp::tc::col_min;
using opp::tc::col_sum;
using opp::tc::exp_fast;
using opp::tc::lanes_argmax;
using opp::tc::LN2;
using opp::tc::MAX_C;
using opp::tc::NT;
using opp::tc::NWARP;
using opp::tc::pad_channels;
using opp::tc::pad_rows;
using opp::tc::quad_max;
using opp::tc::quad_sum;
using opp::tc::smem_bytes;
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

using opp::tc::Bf16Sim;  // the bf16 similarity tile (sim_tile_tc.cuh)

// The split-TF32 tile (sim_tile_tf32.cuh): products complete on return.
using opp::tf::Tf32Sim;

// Pass 1: row LSE and per-row-tile column partial LSEs (natural units), on
// the block's similarity tiles of Sim::NC columns (64, or 128 for the wide
// instances): a thread holds NC / 4 columns of each of its two rows.
template <typename Sim>
__device__ __forceinline__ void lse_pass(Sim& sim, const float* __restrict__ radd,
                                         const float* __restrict__ cadd,
                                         float* __restrict__ row_lse, float* __restrict__ colpart,
                                         int P, int L, float inv_temp) {
  constexpr int NC = Sim::NC, NQ = NC / 4;
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
    const int l0 = it * NC;
    float acc[NC / 2];
    sim.product(acc, it);
    float ca[NQ];  // column masks; columns past L drop out of the row statistics
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int l = l0 + 8 * (q >> 1) + 2 * t + (q & 1);
      ca[q] = l < L ? (cadd != nullptr ? cadd[(size_t)b * L + l] : 0.f) : NEG;
    }
    wg::wait<0>();
    wg::fence_regs(acc);
    // s = dot * inv_temp + row mask + column mask, in the plain version's order
#pragma unroll
    for (int i = 0; i < NC / 2; ++i)
      acc[i] = __fadd_rn(__fadd_rn(__fmul_rn(acc[i], inv_temp), ra[(i >> 1) & 1]),
                         ca[2 * (i >> 2) + (i & 1)]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = rm[h];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) m = fmaxf(m, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      float sum = rs[h] * exp_fast(rm[h] - m);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
        sum += exp_fast(acc[4 * j + 2 * h] - m) + exp_fast(acc[4 * j + 2 * h + 1] - m);
      rm[h] = m;
      rs[h] = sum;
    }
    float* sc = sim.cols(it);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int i = 4 * (q >> 1) + (q & 1);  // rows g (acc[i]) and g + 8 (acc[i + 2])
      const float cm = col_max(fmaxf(acc[i], acc[i + 2]));
      const float cs = col_sum(exp_fast(acc[i] - cm) + exp_fast(acc[i + 2] - cm));
      if (g == 0) {
        const int col = 8 * (q >> 1) + 2 * t + (q & 1);
        sc[w * NC + col] = cm;
        sc[NWARP * NC + w * NC + col] = cs;
      }
    }
    __syncthreads();
    sim.release(it);
    if (tid < NC && l0 + tid < L) {
      float m = sc[tid];
#pragma unroll
      for (int v = 1; v < NWARP; ++v) m = fmaxf(m, sc[v * NC + tid]);
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < NWARP; ++v)
        sum += sc[NWARP * NC + v * NC + tid] * exp_fast(sc[v * NC + tid] - m);
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
  constexpr int NC = Sim::NC, NQ = NC / 4;
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
    const int l0 = it * NC;
    float acc[NC / 2];
    sim.product(acc, it);
    float ca[NQ], cl[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int l = l0 + 8 * (q >> 1) + 2 * t + (q & 1);
      ca[q] = l < L ? (cadd != nullptr ? cadd[(size_t)b * L + l] : 0.f) : NEG;
      cl[q] = l < L ? col_lse[(size_t)b * L + l] : 0.f;
    }
    wg::wait<0>();
    wg::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i)
      acc[i] = __fadd_rn(__fadd_rn(__fmul_rn(acc[i], inv_temp), ra[(i >> 1) & 1]),
                         ca[2 * (i >> 2) + (i & 1)]);
    // rows: this thread's columns in ascending order, strict > keeps the first
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = 2.f * acc[4 * (q >> 1) + 2 * h + (q & 1)] - cl[q];
        const bool take = v > bv[h];
        bv[h] = take ? v : bv[h];
        bj[h] = take ? l0 + 8 * (q >> 1) + 2 * t + (q & 1) : bj[h];
      }
    // columns: the largest value over the warp's 16 rows, then the lowest row holding it
    float* sc = sim.cols(it);
    int* si = reinterpret_cast<int*>(sc + NWARP * NC);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int i = 4 * (q >> 1) + (q & 1);
      const float v0 = 2.f * acc[i] - rl[0], v1 = 2.f * acc[i + 2] - rl[1];
      const float v = col_max(fmaxf(v0, v1));
      const int r = col_min(v0 == v ? rows[0] : v1 == v ? rows[1] : INT_MAX);
      if (g == 0) {
        const int col = 8 * (q >> 1) + 2 * t + (q & 1);
        sc[w * NC + col] = v;
        si[w * NC + col] = r;
      }
    }
    __syncthreads();
    sim.release(it);
    if (tid < NC && l0 + tid < L) {  // warps in order: rows ascending, strict > keeps the lowest
      float v = sc[tid];
      int r = si[tid];
#pragma unroll
      for (int u = 1; u < NWARP; ++u) {
        const bool take = sc[u * NC + tid] > v;
        v = take ? sc[u * NC + tid] : v;
        r = take ? si[u * NC + tid] : r;
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

// ------------------------------ above 576 channels: sim_tile_wide.cuh

namespace wd = opp::wide;

// The block's view of its batch element's packed operands (bf16, or f32 in split TF32).
__device__ __forceinline__ auto wide_sim(unsigned char* smem, const bf16* f0, const bf16* f1, int P,
                                         int L, int cp) {
  const size_t b = blockIdx.y;
  return wd::bf16_sim(smem, f0 + b * pad_rows(P) * cp, f1 + b * wd::pad_rows(L, wd::NC) * cp,
                      blockIdx.x, cp, L);
}
__device__ __forceinline__ auto wide_sim(unsigned char* smem, const float* f0, const float* f1, int P,
                                         int L, int cp) {
  const size_t b = blockIdx.y;  // f1 holds two images, hi and lo
  return wd::tf32_sim(smem, f0 + b * pad_rows(P) * cp, f1 + b * wd::pad_rows(L, wd::NC) * cp * 2,
                      blockIdx.x, cp, L);
}

__global__ void __launch_bounds__(NT, 2)
    lse_wide_bf16_kernel(const bf16* __restrict__ f0, const bf16* __restrict__ f1,
                         const float* __restrict__ radd, const float* __restrict__ cadd,
                         float* __restrict__ row_lse, float* __restrict__ colpart, int P, int L,
                         int C, float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto sim = wide_sim(smem, f0, f1, P, L, wd::pad_channels(C));
  sim.start();
  lse_pass(sim, radd, cadd, row_lse, colpart, P, L, inv_temp);
}

__global__ void __launch_bounds__(NT, 2)
    lse_wide_tf32x3_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                           const float* __restrict__ radd, const float* __restrict__ cadd,
                           float* __restrict__ row_lse, float* __restrict__ colpart, int P, int L,
                           int C, float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto sim = wide_sim(smem, f0, f1, P, L, wd::pad_channels(C));
  sim.start();
  lse_pass(sim, radd, cadd, row_lse, colpart, P, L, inv_temp);
}

__global__ void __launch_bounds__(NT, 2)
    argmax_wide_bf16_kernel(const bf16* __restrict__ f0, const bf16* __restrict__ f1,
                            const float* __restrict__ radd, const float* __restrict__ cadd,
                            const float* __restrict__ row_lse, const float* __restrict__ col_lse,
                            float* __restrict__ row_val, int* __restrict__ row_j,
                            float* __restrict__ cpart_val, int* __restrict__ cpart_idx, int P,
                            int L, int C, float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto sim = wide_sim(smem, f0, f1, P, L, wd::pad_channels(C));
  sim.start();
  argmax_pass(sim, radd, cadd, row_lse, col_lse, row_val, row_j, cpart_val, cpart_idx, P, L,
              inv_temp);
}

__global__ void __launch_bounds__(NT, 2)
    argmax_wide_tf32x3_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                              const float* __restrict__ radd, const float* __restrict__ cadd,
                              const float* __restrict__ row_lse, const float* __restrict__ col_lse,
                              float* __restrict__ row_val, int* __restrict__ row_j,
                              float* __restrict__ cpart_val, int* __restrict__ cpart_idx, int P,
                              int L, int C, float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto sim = wide_sim(smem, f0, f1, P, L, wd::pad_channels(C));
  sim.start();
  argmax_pass(sim, radd, cadd, row_lse, col_lse, row_val, row_j, cpart_val, cpart_idx, P, L,
              inv_temp);
}

template <typename T>
using LseKernel = void (*)(const T*, const T*, const float*, const float*, float*, float*, int, int,
                           int, float);
template <typename T>
using ArgmaxKernel = void (*)(const T*, const T*, const float*, const float*, const float*,
                              const float*, float*, int*, float*, int*, int, int, int, float);

// A wide instance's LSE pass and its merge, then (arg_k not null) the argmax
// pass and its merge, on operands packed by opp_pack_wide_* (any C).
template <typename T>
int launch_wide(LseKernel<T> lse_k, ArgmaxKernel<T> arg_k, size_t smem, int* have_lse,
                int* have_arg, const void* f0, const void* f1, const float* radd,
                const float* cadd, float* row_lse, float* col_lse, float* row_val, int* row_j,
                float* col_val, int* col_p, float* part_val, int* part_idx, int B, int P, int L,
                int C, float inv_temp, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || P <= 0 || L <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int n_pt = pad_rows(P) / TM;
  const T* a = static_cast<const T*>(f0);
  const T* b = static_cast<const T*>(f1);
  opp::raise_smem_limit(lse_k, smem, have_lse);
  lse_k<<<dim3(n_pt, B), NT, smem, stream>>>(a, b, radd, cadd, row_lse, part_val, P, L, C, inv_temp);
  col_lse_reduce<<<dim3((L + 255) / 256, B), 256, 0, stream>>>(part_val, col_lse, n_pt, L);
  if (arg_k != nullptr) {
    opp::raise_smem_limit(arg_k, smem, have_arg);
    arg_k<<<dim3(n_pt, B), NT, smem, stream>>>(a, b, radd, cadd, row_lse, col_lse, row_val, row_j,
                                               part_val, part_idx, P, L, C, inv_temp);
    col_argmax_reduce<<<dim3((L + 255) / 256, B), 256, 0, stream>>>(part_val, part_idx, col_val,
                                                                     col_p, n_pt, L);
  }
  return (int)cudaGetLastError();
}

constexpr size_t WIDE_BF16_SMEM = wd::smem_bytes_bf16<wd::NST_BF16>();
constexpr size_t WIDE_TF32_SMEM = wd::smem_bytes_tf32<wd::NST_TF32>();

// dst [B, rows_pad / TR, Cp / 64, TR / 8, 8, 8, 8] bf16 (sim_tile_wide.cuh's
// layout, TR = 64 or 128) of src [B, rows, C] (T = float or bf16) times
// `scale`, rounded to bf16 as torch's (x * scale).to(bfloat16); zeros past rows
// and C. One thread per 16 output bytes (8 channels of one row): output index
// i * 8, written in order.
template <typename T>
__global__ void pack_wide_bf16_kernel(const T* __restrict__ src, bf16* __restrict__ dst, int rows,
                                      int rows_pad, int tr, int C, int cp, float scale, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // i = ((((b * tiles + tile) * chunks + chunk) * (TR / 8) + rg) * 8 + kg) * 8 + r8
  const int r8 = (int)(i & 7), kg = (int)((i >> 3) & 7);
  long long rest = i >> 6;
  const int rg = (int)(rest % (tr / 8));
  rest /= tr / 8;
  const int chunk = (int)(rest % (cp / 64));
  rest /= cp / 64;
  const int tile = (int)(rest % (rows_pad / tr));
  const long long b = rest / (rows_pad / tr);
  const int r = tile * tr + rg * 8 + r8, k0 = chunk * 64 + kg * 8;
  __align__(16) bf16 out[8];
  const T* row = src + ((size_t)b * rows + r) * C;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    out[k] = __float2bfloat16_rn(r < rows && k0 + k < C ? opp::to_f32(row[k0 + k]) * scale : 0.f);
  *reinterpret_cast<uint4*>(dst + i * 8) = *reinterpret_cast<const uint4*>(out);
}

// dst [B, rows_pad / 128, Cp / 32, 2, 16, 8, 8, 4] f32 (sim_tile_wide.cuh's f1
// layout in split TF32) of src [B, rows, C] f32 times `scale`: each 32-channel
// chunk of a 128-row tile as its TF32 hi image, then its lo image (wgmma.cuh's
// tf32_split); zeros past rows and C. One thread per 16 output bytes (4
// channels of one row, one half): output index i * 4, written in order.
__global__ void pack_tf32_hilo_kernel(const float* __restrict__ src, float* __restrict__ dst, int rows,
                                      int rows_pad, int C, int cp, float scale, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // i = (((((b * tiles + tile) * chunks + chunk) * 2 + half) * 16 + rg) * 8 + kq) * 8 + r8
  const int r8 = (int)(i & 7), kq = (int)((i >> 3) & 7), rg = (int)((i >> 6) & 15);
  const int half = (int)((i >> 10) & 1);
  long long rest = i >> 11;
  const int chunk = (int)(rest % (cp / 32));
  rest /= cp / 32;
  const int tile = (int)(rest % (rows_pad / wd::NC));
  const long long b = rest / (rows_pad / wd::NC);
  const int r = tile * wd::NC + rg * 8 + r8, k0 = chunk * 32 + kq * 4;
  uint4 out;
  uint32_t* o = &out.x;
  const float* row = src + ((size_t)b * rows + r) * C;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t hi, lo;
    wg::tf32_split(r < rows && k0 + k < C ? row[k0 + k] * scale : 0.f, hi, lo);
    o[k] = half ? lo : hi;
  }
  reinterpret_cast<uint4*>(dst)[i] = out;
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

// Cp: C padded to 32 (the split-TF32 tile) or to 64 (the wide instance's f0).
int launch_pack_tf32(const void* src, void* dst, int B, int rows, int C, int cp, float scale,
                     cudaStream_t stream) {
  if (B <= 0 || rows <= 0 || C <= 0 || cp < C || cp % 32 != 0) return (int)cudaErrorInvalidValue;
  const int rows_pad = pad_rows(rows);
  const long long n = (long long)B * rows_pad * (cp / 4);
  pack_tf32_operand_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), rows, rows_pad, C, cp, scale, n);
  return (int)cudaGetLastError();
}

int launch_pack_tf32_hilo(const void* src, void* dst, int B, int rows, int C, float scale,
                          cudaStream_t stream) {
  if (B <= 0 || rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int cp = wd::pad_channels(C), rows_pad = wd::pad_rows(rows, wd::NC);
  const long long n = (long long)B * rows_pad * (cp / 4) * 2;
  pack_tf32_hilo_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), rows, rows_pad, C, cp, scale, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pack_wide_bf16(const void* src, void* dst, int B, int rows, int C, int tr, float scale,
                          cudaStream_t stream) {
  if (B <= 0 || rows <= 0 || C <= 0 || (tr != TM && tr != wd::NC)) return (int)cudaErrorInvalidValue;
  const int cp = wd::pad_channels(C), rows_pad = wd::pad_rows(rows, tr);
  const long long n = (long long)B * rows_pad * (cp / 8);
  pack_wide_bf16_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(src), static_cast<bf16*>(dst), rows, rows_pad, tr, C, cp, scale, n);
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

// bf16 operands on the tensor cores: f0 and f1 packed by opp_pack_operand_*
// (already scaled; C <= 576 channels before padding); radd [B, P] and cadd
// [B, L] additive masks (or null), the outputs [B, P] (row) and [B, L]
// (column), part_val / part_idx [B, tiles, L] scratch with tiles =
// opp_rowcol_row_tiles(P).
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
extern "C" int opp_rowcol_row_tiles(int P) { return tcm::pad_rows(P) / tcm::TM; }

// f32 operands on the tensor cores in split TF32: f0 and f1 packed by
// opp_pack_tf32_operand_f32 (already scaled; C <= 576 channels before padding),
// the other arguments as opp_rowcol_stats_bf16's.
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

// The operand layout of the split-TF32 instance (K2 f32) and of the wide one's
// f0: dst [B, rows_pad / 64, Cp / 32, 8, 8, 8, 4] f32 of src [B, rows, C]
// times scale, with Cp = C rounded up to 32 (or to 64 for the wide instance,
// the caller's cp) and rows_pad = rows rounded up to 64.
extern "C" int opp_pack_tf32_operand_f32(const void* src, void* dst, int B, int rows, int C, int cp,
                                         float scale, void* stream) {
  return tcm::launch_pack_tf32(src, dst, B, rows, C, cp, scale, static_cast<cudaStream_t>(stream));
}

// ------------------------------------------------- above 576 channels

// K2 on the tensor cores at any width (sim_tile_wide.cuh), the arguments as
// opp_rowcol_stats_bf16's. bf16: f0 packed by opp_pack_wide_*(tr = 64), f1 by
// opp_pack_wide_*(tr = 128); f32 in split TF32: f0 packed by
// opp_pack_tf32_operand_f32 at Cp = C rounded up to 64, f1 by
// opp_pack_wide_tf32_hilo_f32.
extern "C" int opp_rowcol_stats_wide_bf16(const void* f0, const void* f1, const float* radd,
                                          const float* cadd, float* row_lse, float* col_lse,
                                          float* row_val, int* row_j, float* col_val, int* col_p,
                                          float* part_val, int* part_idx, int B, int P, int L,
                                          int C, float inv_temp, void* stream) {
  static int have_lse[opp::MAX_DEVICES], have_arg[opp::MAX_DEVICES];
  return tcm::launch_wide<__nv_bfloat16>(
      tcm::lse_wide_bf16_kernel, tcm::argmax_wide_bf16_kernel, tcm::WIDE_BF16_SMEM, have_lse,
      have_arg, f0, f1, radd, cadd, row_lse, col_lse, row_val, row_j, col_val, col_p, part_val,
      part_idx, B, P, L, C, inv_temp, static_cast<cudaStream_t>(stream));
}
extern "C" int opp_rowcol_stats_wide_tf32x3(const void* f0, const void* f1, const float* radd,
                                            const float* cadd, float* row_lse, float* col_lse,
                                            float* row_val, int* row_j, float* col_val, int* col_p,
                                            float* part_val, int* part_idx, int B, int P, int L,
                                            int C, float inv_temp, void* stream) {
  static int have_lse[opp::MAX_DEVICES], have_arg[opp::MAX_DEVICES];
  return tcm::launch_wide<float>(
      tcm::lse_wide_tf32x3_kernel, tcm::argmax_wide_tf32x3_kernel, tcm::WIDE_TF32_SMEM, have_lse,
      have_arg, f0, f1, radd, cadd, row_lse, col_lse, row_val, row_j, col_val, col_p, part_val,
      part_idx, B, P, L, C, inv_temp, static_cast<cudaStream_t>(stream));
}

// The bf16 LSE pass alone at any width, for K5's instance above 576 channels
// (coarse_loss.cu), the arguments as opp_dual_lse_bf16's, the operands as
// opp_rowcol_stats_wide_bf16's.
extern "C" int opp_dual_lse_wide_bf16(const void* f0, const void* f1, const float* radd,
                                      const float* cadd, float* row_lse, float* col_lse,
                                      float* part, int B, int P, int L, int C, float inv_temp,
                                      void* stream) {
  static int have_lse[opp::MAX_DEVICES];
  return tcm::launch_wide<__nv_bfloat16>(
      tcm::lse_wide_bf16_kernel, nullptr, tcm::WIDE_BF16_SMEM, have_lse, nullptr, f0, f1, radd,
      cadd, row_lse, col_lse, nullptr, nullptr, nullptr, nullptr, part, nullptr, B, P, L, C,
      inv_temp, static_cast<cudaStream_t>(stream));
}

// The wide instance's bf16 operand layout: dst [B, rows_pad / tr, Cp / 64,
// tr / 8, 8, 8, 8] bf16 of src [B, rows, C] times scale, with Cp = C rounded
// up to 64 and rows_pad = rows rounded up to tr (64 for f0, 128 for f1).
extern "C" int opp_pack_wide_f32(const void* src, void* dst, int B, int rows, int C, int tr,
                                 float scale, void* stream) {
  return tcm::launch_pack_wide_bf16<float>(src, dst, B, rows, C, tr, scale,
                                           static_cast<cudaStream_t>(stream));
}
extern "C" int opp_pack_wide_bf16(const void* src, void* dst, int B, int rows, int C, int tr,
                                  float scale, void* stream) {
  return tcm::launch_pack_wide_bf16<__nv_bfloat16>(src, dst, B, rows, C, tr, scale,
                                                   static_cast<cudaStream_t>(stream));
}

// The wide split-TF32 instance's f1 layout: dst [B, rows_pad / 128, Cp / 32, 2,
// 16, 8, 8, 4] f32, the TF32 hi and lo images of src [B, rows, C] times scale,
// with Cp = C rounded up to 64 and rows_pad = rows rounded up to 128.
extern "C" int opp_pack_wide_tf32_hilo_f32(const void* src, void* dst, int B, int rows, int C,
                                           float scale, void* stream) {
  return tcm::launch_pack_tf32_hilo(src, dst, B, rows, C, scale, static_cast<cudaStream_t>(stream));
}
