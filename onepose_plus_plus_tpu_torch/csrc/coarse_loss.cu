// K5: the fused coarse focal loss over the dual softmax, forward and backward,
// never materialising [P, L].
//
// Replaces onepose_plus_plus_tpu/ops/pallas_coarse_loss.py::fused_coarse_focal_loss
// (_loss_kernel, _gsum_kernel, _dfeat_kernel). With s = f0 f1^T * inv_temp over
// f0, f1 already scaled by 1/sqrt(C) and rounded to bf16 (f32 accumulation):
//   log conf[p, l] = min(2 s - colLSE[l] - rowLSE[p], LOGCAP)
// The row/column LSEs come from K2's LSE pass (matching.cu, opp_dual_lse_bf16),
// as the TPU kernel shares pallas_matching._lse_kernel. Then:
//   loss_kernel   per-row pos/neg focal sums (times alpha, 1 - alpha) and the
//                 per-row max conf; the wrapper sums rows.
//   gsum_kernel   g = dL/dlogconf per element (zero where the LOGCAP cap is
//                 active), row sums kept in the block, column sums as
//                 per-row-tile partials, merged in order by colg_reduce.
//   df0_kernel    one block per row tile, looping over column tiles:
//                 df0 += dsim @ f1
//   df1_kernel    one block per column tile, looping over row tiles:
//                 df1 += dsim^T @ f0
// with dsim = (2 g - softmax_p * colsum_g - softmax_l * rowsum_g) * inv_temp
// rounded to bf16 before both products (the TPU kernel's ds16), products in
// f32. Every pass recomputes its similarity tiles (flash-attention style), so
// no [P, L] tensor and no [B, n_row_tiles, L, C] partial is ever stored, and
// no pass needs atomics: the result is the same bit for bit from run to run.
//
// Bound: FP32 FMA throughput of seven P*L*C similarity-sized passes (LSE,
// loss, gsum, and two per feature gradient), then the exponentials. The
// design reuses K2's 64x64 register-blocked similarity tile (sim_tile.cuh)
// and contracts the staged dsim tile against 32-channel slices of the other
// operand held in shared memory, each thread owning 4 rows x 2 channels of
// every slice (at most C = 256 channels: 64 f32 accumulators a thread).
// Tensor cores (wgmma) are later work.
#include "sim_tile.cuh"

namespace {

using namespace opp;

using bf16 = __nv_bfloat16;
constexpr float LOGCAP = -1e-6f;  // log conf <= log(1 - ~1e-6): log1p stays finite
constexpr int MAXC = 256;         // channels a thread's accumulators can hold
constexpr int CH = MAXC / BK;     // 32-channel slices

struct Focal {
  float alpha, gamma;
  // (pos, neg) terms of the log-space focal BCE, unweighted
  __device__ void terms(float conf, float lc, float& pos, float& neg) const {
    const float om = 1.f - conf;
    const float pg = gamma == 2.f ? om * om : powf(om, gamma);
    const float ng = gamma == 2.f ? conf * conf : powf(conf, gamma);
    pos = -pg * lc;
    neg = -ng * log1pf(-conf);
  }
  // d/dlogconf of the terms
  __device__ void dterms(float conf, float lc, float& dpos, float& dneg) const {
    const float om = 1.f - conf;
    float pgm1, ngm1;
    if (gamma == 2.f) {
      pgm1 = om;
      ngm1 = conf;
    } else {
      pgm1 = powf(om, gamma - 1.f);
      ngm1 = powf(conf, gamma - 1.f);
    }
    const float pg = pgm1 * om, ng = ngm1 * conf;
    dpos = gamma * conf * pgm1 * lc - pg;
    dneg = gamma * ng * (-log1pf(-conf)) + ng * conf / om;
  }
};

// g = dL/dlogconf of one element (class coefficients already carry the
// cotangents); zero where the forward's cap is active, as the dense path's
// autodiff through the min gives
__device__ __forceinline__ float elem_g(float s, float rl, float cl, bool is_pos, float pos_coef,
                                        float neg_coef, const Focal& f) {
  const float raw = 2.f * s - cl - rl;
  if (raw >= LOGCAP) return 0.f;
  const float conf = expf(raw);
  float dpos, dneg;
  f.dterms(conf, raw, dpos, dneg);
  return is_pos ? pos_coef * dpos : neg_coef * dneg;
}

__device__ __forceinline__ void sum4(float& v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void max4(float& v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(NT)
    loss_kernel(const bf16* __restrict__ f0, const bf16* __restrict__ f1,
                const int* __restrict__ gt, const float* __restrict__ row_lse,
                const float* __restrict__ col_lse, float* __restrict__ pos_out,
                float* __restrict__ neg_out, float* __restrict__ mx_out, int P, int L, int C,
                float inv_temp, Focal focal) {
  __shared__ TileSmem sm;
  __shared__ float cl[BL];
  const int b = blockIdx.y, p0 = blockIdx.x * BR;
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3;  // row g, column quarter q
  const bf16* f0b = f0 + (size_t)b * P * C;
  const bf16* f1b = f1 + (size_t)b * L * C;
  const int p = p0 + g;
  const float rl = p < P ? row_lse[(size_t)b * P + p] : 0.f;
  const int gtp = p < P ? gt[(size_t)b * P + p] : -2;

  float pos = 0.f, neg = 0.f, mx = 0.f;
  for (int l0 = 0; l0 < L; l0 += BL) {
    if (threadIdx.x < BL) cl[threadIdx.x] = l0 + threadIdx.x < L ? col_lse[(size_t)b * L + l0 + threadIdx.x] : 0.f;
    sim_tile<bf16>(f0b, f1b, nullptr, nullptr, p0, l0, P, L, C, inv_temp, sm);  // syncs
    if (p < P) {
      for (int j = 0; j < 16; ++j) {
        const int c = q * 16 + j, l = l0 + c;
        if (l >= L) break;
        const float lc = fminf(2.f * sm.s[g][c] - cl[c] - rl, LOGCAP);
        const float conf = expf(lc);
        float tp, tn;
        focal.terms(conf, lc, tp, tn);
        if (gtp == l)
          pos += tp;
        else
          neg += tn;
        mx = fmaxf(mx, conf);
      }
    }
    __syncthreads();
  }
  sum4(pos);
  sum4(neg);
  max4(mx);
  if (q == 0 && p < P) {
    pos_out[(size_t)b * P + p] = focal.alpha * pos;
    neg_out[(size_t)b * P + p] = (1.f - focal.alpha) * neg;
    mx_out[(size_t)b * P + p] = mx;
  }
}

// ---------------------------------------------------------- backward: sums

__global__ void __launch_bounds__(NT)
    gsum_kernel(const bf16* __restrict__ f0, const bf16* __restrict__ f1,
                const int* __restrict__ gt, const float* __restrict__ row_lse,
                const float* __restrict__ col_lse, const float* __restrict__ coef,
                float* __restrict__ rowg_out, float* __restrict__ colpart, int P, int L, int C,
                float inv_temp, Focal focal) {
  __shared__ TileSmem sm;
  __shared__ float cl[BL];
  const int b = blockIdx.y, pt = blockIdx.x, n_pt = gridDim.x, p0 = pt * BR;
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3;
  const bf16* f0b = f0 + (size_t)b * P * C;
  const bf16* f1b = f1 + (size_t)b * L * C;
  float* cpart = colpart + ((size_t)b * n_pt + pt) * L;
  const int p = p0 + g;
  const float rl = p < P ? row_lse[(size_t)b * P + p] : 0.f;
  const int gtp = p < P ? gt[(size_t)b * P + p] : -2;
  const float pos_coef = coef[0] * focal.alpha, neg_coef = coef[1] * (1.f - focal.alpha);

  float rowg = 0.f;
  for (int l0 = 0; l0 < L; l0 += BL) {
    if (threadIdx.x < BL) cl[threadIdx.x] = l0 + threadIdx.x < L ? col_lse[(size_t)b * L + l0 + threadIdx.x] : 0.f;
    sim_tile<bf16>(f0b, f1b, nullptr, nullptr, p0, l0, P, L, C, inv_temp, sm);  // syncs
    // g of row g, columns q*16 .. q*16+15, staged in place of the similarity
    float ge[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = q * 16 + j, l = l0 + c;
      ge[j] = (p < P && l < L) ? elem_g(sm.s[g][c], rl, cl[c], gtp == l, pos_coef, neg_coef, focal)
                               : 0.f;
    }
    __syncthreads();  // every thread has read its similarities
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sm.s[g][q * 16 + j] = ge[j];
      rowg += ge[j];
    }
    __syncthreads();
    // column g over rows q*16 .. q*16+15, rows in order
    float cs = 0.f;
    for (int j = 0; j < 16; ++j) cs += sm.s[q * 16 + j][g];
    sum4(cs);
    if (q == 0 && l0 + g < L) cpart[l0 + g] = cs;
    __syncthreads();
  }
  sum4(rowg);
  if (q == 0 && p < P) rowg_out[(size_t)b * P + p] = rowg;
}

__global__ void colg_reduce(const float* __restrict__ colpart, float* __restrict__ colg, int n_pt,
                            int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (l >= L) return;
  const float* c = colpart + (size_t)b * n_pt * L + l;
  float s = 0.f;
  for (int t = 0; t < n_pt; ++t) s += c[(size_t)t * L];  // row tiles in order
  colg[(size_t)b * L + l] = s;
}

// ------------------------------------------------- backward: feature grads

// Overwrite the similarity tile sm.s with dsim rounded to bf16 (0 outside the
// matrix). Row stats rl/rg/gts and column stats cl/cg are staged per tile.
__device__ __forceinline__ void dsim_tile(TileSmem& sm, const float* rl, const float* rg,
                                          const int* gts, const float* cl, const float* cg,
                                          int p0, int l0, int P, int L, float inv_temp,
                                          float pos_coef, float neg_coef, const Focal& focal) {
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int p = p0 + g;
  float ds[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = q * 16 + j, l = l0 + c;
    float d = 0.f;
    if (p < P && l < L) {
      const float s = sm.s[g][c];
      const float ge = elem_g(s, rl[g], cl[c], gts[g] == l, pos_coef, neg_coef, focal);
      const float sm_p = expf(s - cl[c]);  // softmax over rows, given the column
      const float sm_l = expf(s - rl[g]);  // softmax over columns, given the row
      d = round_to<bf16>((2.f * ge - sm_p * cg[c] - sm_l * rg[g]) * inv_temp);
    }
    ds[j] = d;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 16; ++j) sm.s[g][q * 16 + j] = ds[j];
  __syncthreads();
}

// acc[ch][i][jj] += sum_m ds(own_i, m) * opnd[m][ch*32 + tx*2 + jj] over one
// 64-long contraction tile; ds(i, m) = sm.s[i][m] (transpose = false, rows
// own the output) or sm.s[m][i] (transpose = true, columns own the output).
// opnd rows m0 .. m0+63 of a [M, C] bf16 matrix.
template <bool TRANSPOSE>
__device__ __forceinline__ void contract_tile(TileSmem& sm, const bf16* __restrict__ opnd, int m0,
                                              int M, int C, float (&acc)[CH][4][2]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float(*slice)[BK + 1] = reinterpret_cast<float(*)[BK + 1]>(&sm.a[0][0]);  // [64][33]
  static_assert(64 * (BK + 1) <= BK * (BR + 4), "slice must fit in sm.a");
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
    if (ch * BK < C) {
      for (int i = threadIdx.x; i < 64 * BK; i += NT) {
        const int m = i / BK, k = i % BK, col = ch * BK + k;
        slice[m][k] = (m0 + m < M && col < C) ? __bfloat162float(opnd[(size_t)(m0 + m) * C + col]) : 0.f;
      }
      __syncthreads();
      for (int m = 0; m < 64; ++m) {
        const float o0 = slice[m][tx * 2], o1 = slice[m][tx * 2 + 1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = TRANSPOSE ? sm.s[m][ty * 4 + i] : sm.s[ty * 4 + i][m];
          acc[ch][i][0] = fmaf(d, o0, acc[ch][i][0]);
          acc[ch][i][1] = fmaf(d, o1, acc[ch][i][1]);
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void store_acc(float* __restrict__ out, int r0, int R, int C,
                                          const float (&acc)[CH][4][2]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = ch * BK + tx * 2 + jj;
        if (r < R && col < C) out[(size_t)r * C + col] = acc[ch][i][jj];
      }
    }
  }
}

struct BwdArgs {
  const bf16* f0;
  const bf16* f1;
  const int* gt;
  const float* row_lse;
  const float* col_lse;
  const float* coef;
  const float* rowg;
  const float* colg;
  int P, L, C;
  float inv_temp;
  Focal focal;
};

__global__ void __launch_bounds__(NT) df0_kernel(BwdArgs a, float* __restrict__ df0) {
  __shared__ TileSmem sm;
  __shared__ float rl[BR], rg[BR], cl[BL], cg[BL];
  __shared__ int gts[BR];
  const int b = blockIdx.y, p0 = blockIdx.x * BR;
  const bf16* f0b = a.f0 + (size_t)b * a.P * a.C;
  const bf16* f1b = a.f1 + (size_t)b * a.L * a.C;
  const float pos_coef = a.coef[0] * a.focal.alpha, neg_coef = a.coef[1] * (1.f - a.focal.alpha);
  if (threadIdx.x < BR) {
    const int p = p0 + threadIdx.x;
    const bool ok = p < a.P;
    rl[threadIdx.x] = ok ? a.row_lse[(size_t)b * a.P + p] : 0.f;
    rg[threadIdx.x] = ok ? a.rowg[(size_t)b * a.P + p] : 0.f;
    gts[threadIdx.x] = ok ? a.gt[(size_t)b * a.P + p] : -2;
  }
  float acc[CH][4][2] = {};
  for (int l0 = 0; l0 < a.L; l0 += BL) {
    if (threadIdx.x < BL) {
      const int l = l0 + threadIdx.x;
      cl[threadIdx.x] = l < a.L ? a.col_lse[(size_t)b * a.L + l] : 0.f;
      cg[threadIdx.x] = l < a.L ? a.colg[(size_t)b * a.L + l] : 0.f;
    }
    sim_tile<bf16>(f0b, f1b, nullptr, nullptr, p0, l0, a.P, a.L, a.C, a.inv_temp, sm);  // syncs
    dsim_tile(sm, rl, rg, gts, cl, cg, p0, l0, a.P, a.L, a.inv_temp, pos_coef, neg_coef, a.focal);
    contract_tile<false>(sm, f1b, l0, a.L, a.C, acc);
  }
  store_acc(df0 + (size_t)b * a.P * a.C, p0, a.P, a.C, acc);
}

__global__ void __launch_bounds__(NT) df1_kernel(BwdArgs a, float* __restrict__ df1) {
  __shared__ TileSmem sm;
  __shared__ float rl[BR], rg[BR], cl[BL], cg[BL];
  __shared__ int gts[BR];
  const int b = blockIdx.y, l0 = blockIdx.x * BL;
  const bf16* f0b = a.f0 + (size_t)b * a.P * a.C;
  const bf16* f1b = a.f1 + (size_t)b * a.L * a.C;
  const float pos_coef = a.coef[0] * a.focal.alpha, neg_coef = a.coef[1] * (1.f - a.focal.alpha);
  if (threadIdx.x < BL) {
    const int l = l0 + threadIdx.x;
    cl[threadIdx.x] = l < a.L ? a.col_lse[(size_t)b * a.L + l] : 0.f;
    cg[threadIdx.x] = l < a.L ? a.colg[(size_t)b * a.L + l] : 0.f;
  }
  float acc[CH][4][2] = {};
  for (int p0 = 0; p0 < a.P; p0 += BR) {
    if (threadIdx.x < BR) {
      const int p = p0 + threadIdx.x;
      const bool ok = p < a.P;
      rl[threadIdx.x] = ok ? a.row_lse[(size_t)b * a.P + p] : 0.f;
      rg[threadIdx.x] = ok ? a.rowg[(size_t)b * a.P + p] : 0.f;
      gts[threadIdx.x] = ok ? a.gt[(size_t)b * a.P + p] : -2;
    }
    sim_tile<bf16>(f0b, f1b, nullptr, nullptr, p0, l0, a.P, a.L, a.C, a.inv_temp, sm);  // syncs
    dsim_tile(sm, rl, rg, gts, cl, cg, p0, l0, a.P, a.L, a.inv_temp, pos_coef, neg_coef, a.focal);
    contract_tile<true>(sm, f0b, p0, a.P, a.C, acc);
  }
  store_acc(df1 + (size_t)b * a.L * a.C, l0, a.L, a.C, acc);
}

bool bad_shape(int B, int P, int L, int C) {
  return B <= 0 || P <= 0 || L <= 0 || C <= 0 || C > MAXC;
}

}  // namespace

// Forward after opp_dual_lse_bf16: per-row alpha * pos sums, (1 - alpha) * neg
// sums and max conf, each [B, P].
extern "C" int opp_coarse_loss_fwd(const void* f0, const void* f1, const int* gt,
                                   const float* row_lse, const float* col_lse, float* pos,
                                   float* neg, float* mx, int B, int P, int L, int C,
                                   float inv_temp, float alpha, float gamma, void* stream) {
  if (bad_shape(B, P, L, C)) return (int)cudaErrorInvalidValue;
  loss_kernel<<<dim3((P + BR - 1) / BR, B), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(f0), static_cast<const bf16*>(f1), gt, row_lse, col_lse, pos, neg,
      mx, P, L, C, inv_temp, Focal{alpha, gamma});
  return (int)cudaGetLastError();
}

// Backward: coef = (dL/dpos_sum, dL/dneg_sum) on the device; rowg [B, P],
// colg [B, L] and colpart [B, row tiles, L] are scratch; df0 [B, P, C] and
// df1 [B, L, C] f32 outputs.
extern "C" int opp_coarse_loss_bwd(const void* f0, const void* f1, const int* gt,
                                   const float* row_lse, const float* col_lse, const float* coef,
                                   float* rowg, float* colg, float* colpart, float* df0,
                                   float* df1, int B, int P, int L, int C, float inv_temp,
                                   float alpha, float gamma, void* stream) {
  if (bad_shape(B, P, L, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pt = (P + BR - 1) / BR;
  const Focal focal{alpha, gamma};
  const bf16* a0 = static_cast<const bf16*>(f0);
  const bf16* a1 = static_cast<const bf16*>(f1);
  gsum_kernel<<<dim3(n_pt, B), NT, 0, st>>>(a0, a1, gt, row_lse, col_lse, coef, rowg, colpart, P,
                                            L, C, inv_temp, focal);
  colg_reduce<<<dim3((L + 255) / 256, B), 256, 0, st>>>(colpart, colg, n_pt, L);
  const BwdArgs args{a0, a1, gt, row_lse, col_lse, coef, rowg, colg, P, L, C, inv_temp, focal};
  df0_kernel<<<dim3(n_pt, B), NT, 0, st>>>(args, df0);
  df1_kernel<<<dim3((L + BL - 1) / BL, B), NT, 0, st>>>(args, df1);
  return (int)cudaGetLastError();
}

// Row tiles of the colpart scratch ([B, tiles, L]).
extern "C" int opp_coarse_loss_row_tiles(int P) { return (P + BR - 1) / BR; }
