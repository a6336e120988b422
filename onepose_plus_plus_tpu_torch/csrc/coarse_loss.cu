// K5: the fused coarse focal loss over the dual softmax, forward and backward,
// never materialising [P, L].
//
// Replaces onepose_plus_plus_tpu/ops/pallas_coarse_loss.py::fused_coarse_focal_loss
// (_loss_kernel, _gsum_kernel, _dfeat_kernel). With s = f0 f1^T * inv_temp over
// f0, f1 already scaled by 1/sqrt(C) and rounded to bf16 (f32 accumulation):
//   log conf[p, l] = min(2 s - colLSE[l] - rowLSE[p], LOGCAP)
// The row/column LSEs come from K2's LSE pass (matching.cu: opp_dual_lse_bf16
// on the resident tile, opp_dual_lse_wide_bf16 on the channel-streaming one
// above 576 channels), as the TPU kernel shares pallas_matching._lse_kernel.
// Then:
//   loss_*_kernel    per-row pos/neg focal sums (times alpha, 1 - alpha) and
//                    the per-row max conf; the wrapper sums rows.
//   gsum_*_kernel    g = dL/dlogconf per element (zero where the LOGCAP cap is
//                    active), row sums kept in the block, column sums as
//                    per-row-tile partials, merged in order by colg_reduce.
//   dfeat_*_kernel   df0 = dsim f1, blocks owning row tiles of f0 over f1's
//                    tiles, and df1 = dsim^T f0, blocks owning row tiles of f1
//                    over f0's tiles (on the transposed tile s^T),
// with dsim = (2 g - softmax_p * colsum_g - softmax_l * rowsum_g) * inv_temp
// rounded to bf16 before both products (the TPU kernel's ds16), products in
// f32. Every pass recomputes its similarity tiles (flash-attention style), so
// no [P, L] tensor and no [B, n_row_tiles, L, C] partial is ever stored, and
// no pass needs atomics: the result is the same bit for bit from run to run.
//
// Bound: operations, seven P*L*C products (LSE, loss, gsum, and two for each
// feature gradient), then ~14 transcendentals per similarity element over the
// four passes. Two instances, by width (ops/cuda_coarse_loss.py::k5_instance),
// both on the tensor cores; the loss and g-sum passes are one epilogue each
// (loss_pass, gsum_pass) over either tile, as K2's passes are:
//
// C <= 576 (three 64-row tiles fit a block's shared memory): every pass runs
// on the tensor-core similarity tile of sim_tile_tc.cuh (operands packed once
// by the wrapper, one warpgroup a block, the resident tile and a two-stage
// ring of streamed tiles, the reductions on the accumulator fragment). The
// feature gradients need a second product per tile: dsim is formed in the
// registers of the first product's accumulators, packed to bf16 pairs, and fed
// as the A operand from registers to a second wgmma whose B is the streamed
// tile itself, read MN-major (transposed): the packed layout's core matrices
// are the same bytes either way, so one shared copy serves both products. df1
// computes the transposed tile s^T = f1 f0^T directly, so dsim^T arises in
// registers the same way. The second product's accumulators hold one
// 256-channel chunk of the output (128 registers a thread, in pieces of 64, 32
// or 16 columns, whichever divides the padded C); above 256 channels each
// chunk is a block of its own (blockIdx.z) that recomputes the similarity
// tiles, so a chunk costs one more first product and nothing else changes.
//
// 576 < C <= 4096 (as wide as K1 goes): the loss and g-sum passes on K2's
// channel-streaming tile (sim_tile_wide.cuh: a 64-row f0 tile against 128-row
// f1 tiles, both streamed in 64-channel chunks through gemm::Ring, 128
// columns a product), over the operands its LSE pass reads (packed once by
// pack_wide_bf16_kernel). The feature gradients run in thread-block clusters
// (dfeat_wide_kernel, wdf:: below) that form each similarity and each dsim
// element once on the device: a cluster of n = ceil(Cp / 256) blocks owns one
// 64-row tile, block j holds output channels [256 j, 256 j + 256) in its
// accumulators and the products over that channel slice only; the partial
// similarities of a tile are reduce-scattered through distributed shared
// memory (summed in rank order), each block forms dsim for its share of the
// tile and all-gathers it in bf16, and every block multiplies the whole dsim
// tile with its own slice of the streamed tile.
#include <cooperative_groups.h>

#include "sim_tile_tc.cuh"
#include "sim_tile_wide.cuh"

namespace {

using namespace opp::tc;
namespace wd = opp::wide;
namespace coop = cooperative_groups;

using bf16 = __nv_bfloat16;
constexpr float LOGCAP = -1e-6f;       // log conf <= log(1 - ~1e-6): log1p stays finite
constexpr float CONF_CAP = 0.999999f;  // exp(LOGCAP) rounded down
constexpr int MAXC = 256;              // channels the feature-gradient accumulators hold (a chunk)
constexpr int MAX_C_WIDE = 4096;       // the wide instance's widest operand (K1's widest)

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
    dneg = gamma * ng * (-log1pf(-conf)) + ng * __fdividef(conf, om);
  }
};

// g = dL/dlogconf of one element at raw = 2 s - colLSE - rowLSE and its
// confidence (class coefficients already carry the cotangents); zero where the
// forward's cap is active, as the dense path's autodiff through the min gives
__device__ __forceinline__ float elem_g(float raw, float conf, bool is_pos, float pos_coef,
                                        float neg_coef, const Focal& f) {
  float dpos, dneg;
  f.dterms(fminf(conf, CONF_CAP), raw, dpos, dneg);
  const float ge = is_pos ? pos_coef * dpos : neg_coef * dneg;
  return raw < LOGCAP ? ge : 0.f;
}

// The batch element's packed operands and the stats the passes share.
struct Args {
  const bf16* f0;  // packed: [B, P_pad / 8, Cp / 8, 8, 8] (C <= 576), or the wide layout
  const bf16* f1;  // (sim_tile_wide.cuh: f0 in 64-row, f1 in 128-row tiles)
  const int* gt;
  const float* row_lse;
  const float* col_lse;
  const float* coef;  // (dL/dpos_sum, dL/dneg_sum) on the device
  const float* rowg;
  const float* colg;
  int P, L, C;
  float inv_temp;
  float grad_scale;  // df0 and df1 are written times this (the operands' scale)
  Focal focal;
};

// A thread's place in the accumulator fragment (wgmma.cuh): warp w, row group
// g, column pair t; it holds rows 16 w + g + 8 h (h < 2) of the block's tile.
struct Frag {
  int w, g, t;
  __device__ Frag() : w(threadIdx.x >> 5), g((threadIdx.x >> 2) & 7), t(threadIdx.x & 3) {}
  __device__ int row(int h) const { return 16 * w + g + 8 * h; }
  __device__ int col(int q) const { return 8 * (q >> 1) + 2 * t + (q & 1); }  // within a tile
};

// The block's f0 rows: their LSE, GT column and whether they exist.
struct OwnRows {
  float rl[2];
  int gt[2];
  bool ok[2];
  __device__ OwnRows(const Args& a, const Frag& fr, int p0, int b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + fr.row(h);
      ok[h] = p < a.P;
      rl[h] = ok[h] ? a.row_lse[(size_t)b * a.P + p] : 0.f;
      gt[h] = ok[h] ? a.gt[(size_t)b * a.P + p] : -2;
    }
  }
};

// ---------------------------------------------------------------- forward

// Per-row focal sums and max conf of the block's 64 f0 rows over every column
// tile of `sim` (Bf16Sim: 64 columns a product; WideSim: 128): a thread holds
// NC / 4 columns of each of its two rows.
template <class Sim>
__device__ __forceinline__ void loss_pass(const Sim& sim, const Args& a, float* __restrict__ pos_out,
                                          float* __restrict__ neg_out, float* __restrict__ mx_out) {
  constexpr int NC = Sim::NC, NQ = NC / 4;
  const Frag fr;
  const int L = a.L, b = blockIdx.y, p0 = blockIdx.x * TM;
  const OwnRows own(a, fr, p0, b);
  float pos[2] = {0.f, 0.f}, neg[2] = {0.f, 0.f}, mx[2] = {0.f, 0.f};

#pragma unroll 1
  for (int it = 0; it < sim.n_tiles(); ++it) {
    const int l0 = it * NC;
    float acc[NC / 2];
    sim.product(acc, it);
    float cl[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int l = l0 + fr.col(q);
      cl[q] = l < L ? a.col_lse[(size_t)b * L + l] : 0.f;
    }
    wg::wait<0>();
    wg::fence_regs(acc);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + fr.col(q);
        const float s = acc[4 * (q >> 1) + 2 * h + (q & 1)] * a.inv_temp;
        const float lc = fminf(2.f * s - cl[q] - own.rl[h], LOGCAP);
        const float conf = exp_fast(lc);
        float tp, tn;
        a.focal.terms(conf, lc, tp, tn);
        const bool ok = own.ok[h] && l < L, is_pos = own.gt[h] == l;
        pos[h] += ok && is_pos ? tp : 0.f;
        neg[h] += ok && !is_pos ? tn : 0.f;
        mx[h] = ok ? fmaxf(mx[h], conf) : mx[h];
      }
    __syncthreads();  // every warp's product has read the stage
    sim.release(it);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float ps = quad_sum(pos[h]), ns = quad_sum(neg[h]), m = quad_max(mx[h]);
    if (fr.t == 0 && own.ok[h]) {
      const size_t o = (size_t)b * a.P + p0 + fr.row(h);
      pos_out[o] = a.focal.alpha * ps;
      neg_out[o] = (1.f - a.focal.alpha) * ns;
      mx_out[o] = m;
    }
  }
}

// The resident tile (C <= 576).
__global__ void __launch_bounds__(NT, 2)
    loss_tc_kernel(Args a, float* __restrict__ pos_out, float* __restrict__ neg_out,
                   float* __restrict__ mx_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = pad_channels(a.C), b = blockIdx.y;
  Bf16Sim sim(smem, cp, a.f1 + (size_t)b * pad_rows(a.L) * cp, pad_rows(a.L) / TM);
  sim.start(a.f0 + ((size_t)b * pad_rows(a.P) + blockIdx.x * TM) * cp);
  loss_pass(sim, a, pos_out, neg_out, mx_out);
}

// K2's channel-streaming tile (C > 576), on the operands of its LSE pass.
__device__ __forceinline__ auto wide_sim(unsigned char* smem, const Args& a) {
  const int cp = wd::pad_channels(a.C);
  const size_t b = blockIdx.y;
  return wd::bf16_sim(smem, a.f0 + b * pad_rows(a.P) * cp, a.f1 + b * wd::pad_rows(a.L, wd::NC) * cp,
                      blockIdx.x, cp, a.L);
}

__global__ void __launch_bounds__(NT, 2)
    loss_wide_kernel(Args a, float* __restrict__ pos_out, float* __restrict__ neg_out,
                     float* __restrict__ mx_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const auto sim = wide_sim(smem, a);
  sim.start();
  loss_pass(sim, a, pos_out, neg_out, mx_out);
}

// ---------------------------------------------------------- backward: sums

// g per element, its row sums (kept in the block) and its column sums as this
// row tile's partials [B, row tiles, L], on the block's tiles of `sim`.
template <class Sim>
__device__ __forceinline__ void gsum_pass(const Sim& sim, const Args& a, float* __restrict__ rowg_out,
                                          float* __restrict__ colpart) {
  constexpr int NC = Sim::NC, NQ = NC / 4;
  const Frag fr;
  const int L = a.L, b = blockIdx.y, p0 = blockIdx.x * TM, tid = threadIdx.x;
  const OwnRows own(a, fr, p0, b);
  float* cpart = colpart + ((size_t)b * gridDim.x + blockIdx.x) * L;
  const float pos_coef = a.coef[0] * a.focal.alpha, neg_coef = a.coef[1] * (1.f - a.focal.alpha);
  float rowg[2] = {0.f, 0.f};

#pragma unroll 1
  for (int it = 0; it < sim.n_tiles(); ++it) {
    const int l0 = it * NC;
    float acc[NC / 2];
    sim.product(acc, it);
    float cl[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int l = l0 + fr.col(q);
      cl[q] = l < L ? a.col_lse[(size_t)b * L + l] : 0.f;
    }
    wg::wait<0>();
    wg::fence_regs(acc);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (q >> 1) + 2 * h + (q & 1), l = l0 + fr.col(q);
        const float raw = 2.f * (acc[i] * a.inv_temp) - cl[q] - own.rl[h];
        const float ge = elem_g(raw, exp_fast(raw), own.gt[h] == l, pos_coef, neg_coef, a.focal);
        acc[i] = own.ok[h] && l < L ? ge : 0.f;
        rowg[h] += acc[i];
      }
    float* sc = sim.cols(it);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int i = 4 * (q >> 1) + (q & 1);
      const float v = col_sum(acc[i] + acc[i + 2]);
      if (fr.g == 0) sc[fr.w * NC + fr.col(q)] = v;
    }
    __syncthreads();
    sim.release(it);
    if (tid < NC && l0 + tid < L) {  // warps in order
      float v = sc[tid];
#pragma unroll
      for (int u = 1; u < NWARP; ++u) v += sc[u * NC + tid];
      cpart[l0 + tid] = v;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v = quad_sum(rowg[h]);
    if (fr.t == 0 && own.ok[h]) rowg_out[(size_t)b * a.P + p0 + fr.row(h)] = v;
  }
}

__global__ void __launch_bounds__(NT, 2)
    gsum_tc_kernel(Args a, float* __restrict__ rowg_out, float* __restrict__ colpart) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = pad_channels(a.C), b = blockIdx.y;
  Bf16Sim sim(smem, cp, a.f1 + (size_t)b * pad_rows(a.L) * cp, pad_rows(a.L) / TM);
  sim.start(a.f0 + ((size_t)b * pad_rows(a.P) + blockIdx.x * TM) * cp);
  gsum_pass(sim, a, rowg_out, colpart);
}

__global__ void __launch_bounds__(NT, 2)
    gsum_wide_kernel(Args a, float* __restrict__ rowg_out, float* __restrict__ colpart) {
  extern __shared__ __align__(128) unsigned char smem[];
  const auto sim = wide_sim(smem, a);
  sim.start();
  gsum_pass(sim, a, rowg_out, colpart);
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

// dsim of one element, before its rounding to bf16
__device__ __forceinline__ float dsim(float s, float rl, float cl, float rg, float cg, bool is_pos,
                                      float pos_coef, float neg_coef, float inv_temp,
                                      const Focal& f) {
  const float raw = 2.f * s - cl - rl;
  const float sm_p = exp_fast(s - cl);  // softmax over rows, given the column
  const float sm_l = exp_fast(s - rl);  // softmax over columns, given the row
  const float ge = elem_g(raw, sm_p * sm_l, is_pos, pos_coef, neg_coef, f);
  return (2.f * ge - sm_p * cg - sm_l * rg) * inv_temp;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc (+)= A[64, 16] B[16, NC], A the bf16 pairs in registers, B MN-major
template <int NC>
__device__ __forceinline__ void mma_rs(float (&acc)[NC / 2], const uint32_t (&af)[4], uint64_t b);
template <>
__device__ __forceinline__ void mma_rs<64>(float (&acc)[32], const uint32_t (&af)[4], uint64_t b) {
  wg::mma_rs_n64_tb(acc, af, b, 1);
}
template <>
__device__ __forceinline__ void mma_rs<32>(float (&acc)[16], const uint32_t (&af)[4], uint64_t b) {
  wg::mma_rs_n32_tb(acc, af, b, 1);
}
template <>
__device__ __forceinline__ void mma_rs<16>(float (&acc)[8], const uint32_t (&af)[4], uint64_t b) {
  wg::mma_rs_n16_tb(acc, af, b, 1);
}

// df0 (T1 = false): the block's resident tile is 64 rows p of f0, the streamed
// tiles are f1's, out[b, p, :] = sum_l dsim[p, l] f1[l, :]. df1 (T1 = true):
// resident 64 rows l of f1, streamed f0, out[b, l, :] = sum_p dsim[p, l] f0[p, :],
// on the transposed tile s^T. NC: columns of one accumulator piece. CHUNKED
// (padded C > 256): the block writes output channels [256 z, 256 z + 256),
// z = blockIdx.z; otherwise all of them, with the chunk arithmetic compiled
// out (the train config's C = 256 instance).
template <bool T1, int NC, bool CHUNKED>
__global__ void __launch_bounds__(NT, 1) dfeat_tc_kernel(Args a, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = pad_channels(a.C), p_pad = pad_rows(a.P), l_pad = pad_rows(a.L);
  const int own_n = T1 ? a.L : a.P, oth_n = T1 ? a.P : a.L;
  const int b = blockIdx.y, r0 = blockIdx.x * TM, tid = threadIdx.x;
  const int w = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  const bf16* own = T1 ? a.f1 + (size_t)b * l_pad * cp : a.f0 + (size_t)b * p_pad * cp;
  const bf16* oth = T1 ? a.f0 + (size_t)b * p_pad * cp : a.f1 + (size_t)b * l_pad * cp;
  const Tiles tl(smem, cp, oth, (T1 ? p_pad : l_pad) / TM);
  const float* own_lse = T1 ? a.col_lse : a.row_lse;
  const float* own_sum = T1 ? a.colg : a.rowg;
  const float* oth_lse = T1 ? a.row_lse : a.col_lse;
  const float* oth_sum = T1 ? a.rowg : a.colg;
  // the streamed tiles' column stats (LSE, sum of g, GT column for df1), staged
  // one tile ahead: [tile parity][3][64]
  float* xst = tl.scratch;
  const auto stage_stats = [&](int it) {
    if (tid < TM) {
      const int c = it * TM + tid;
      const bool ok = c < oth_n;
      float* x = xst + (it & 1) * 3 * TM;
      x[tid] = ok ? oth_lse[(size_t)b * oth_n + c] : 0.f;
      x[TM + tid] = ok ? oth_sum[(size_t)b * oth_n + c] : 0.f;
      reinterpret_cast<int*>(x)[2 * TM + tid] = T1 && ok ? a.gt[(size_t)b * a.P + c] : -2;
    }
  };
  stage_stats(0);
  tl.start(own + (size_t)r0 * cp);  // its barrier publishes tile 0's stats
  const uint32_t a_addr = tl.resident();
  const float pos_coef = a.coef[0] * a.focal.alpha, neg_coef = a.coef[1] * (1.f - a.focal.alpha);
  float olse[2], osum[2];
  int ogt[2], orow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * w + g + 8 * h;
    const bool ok = r < own_n;
    orow[h] = r;
    olse[h] = ok ? own_lse[(size_t)b * own_n + r] : 0.f;
    osum[h] = ok ? own_sum[(size_t)b * own_n + r] : 0.f;
    ogt[h] = !T1 && ok ? a.gt[(size_t)b * a.P + r] : -2;
  }
  constexpr int NCH = MAXC / NC;
  const int ch0 = CHUNKED ? blockIdx.z * MAXC : 0;  // the block's first output channel
  const int nch = (CHUNKED ? min(cp - ch0, MAXC) : cp) / NC;
  float acc2[NCH][NC / 2];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc2[ch][i] = 0.f;
  const uint32_t row_step = 2 * 16u * cp;  // 16 rows of the streamed tile: one k step

#pragma unroll 1
  for (int it = 0; it < tl.n_tiles; ++it) {
    const int c0 = it * TM;
    const uint32_t bs = tl.wait(it);
    float acc[32];
    sim_product(acc, a_addr, bs, cp);
    if (it + 1 < tl.n_tiles) stage_stats(it + 1);
    wg::wait<0>();
    wg::fence_regs(acc);
    const float* x = xst + (it & 1) * 3 * TM;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int cc = 8 * (q >> 1) + 2 * t + (q & 1), c = c0 + cc;
      const float xl = x[cc], xs = x[TM + cc];
      const int xg = reinterpret_cast<const int*>(x)[2 * TM + cc];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (q >> 1) + 2 * h + (q & 1);
        const float s = acc[i] * a.inv_temp;
        const float d = T1 ? dsim(s, xl, olse[h], xs, osum[h], xg == orow[h], pos_coef, neg_coef,
                                  a.inv_temp, a.focal)
                           : dsim(s, olse[h], xl, osum[h], xs, ogt[h] == c, pos_coef, neg_coef,
                                  a.inv_temp, a.focal);
        acc[i] = orow[h] < own_n && c < oth_n ? d : 0.f;
      }
    }
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        af[kk][q] = bf16_pair(acc[8 * kk + 2 * q], acc[8 * kk + 2 * q + 1]);
    // out[own rows, :] += dsim [64, 64 streamed rows] x streamed tile [64 rows, Cp],
    // the tile read MN-major (wgmma.cuh): LBO steps along its rows (the
    // contraction), 16 Cp bytes a core matrix, SBO along its channels (the
    // output columns), 128 bytes; probed on the card, the other assignment
    // reads past the tile
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        if (ch < nch)
          mma_rs<NC>(acc2[ch], af[kk],
                     wg::desc(bs + kk * row_step + (ch0 + ch * NC) / 8 * LBO, 16u * cp, LBO));
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) wg::fence_regs(acc2[ch]);
    __syncthreads();  // the stage is read, the next tile's stats are staged
    tl.release(it);
  }
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    if (ch >= nch) break;
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = ch0 + ch * NC + 8 * jj + 2 * t;
        if (orow[h] >= own_n) continue;
        float* o = out + ((size_t)b * own_n + orow[h]) * a.C;
        if (col < a.C) o[col] = acc2[ch][4 * jj + 2 * h] * a.grad_scale;
        if (col + 1 < a.C) o[col + 1] = acc2[ch][4 * jj + 2 * h + 1] * a.grad_scale;
      }
  }
}

// --------------------------- feature gradients above 576: thread-block clusters
//
// A cluster of n = ceil(Cp / S) blocks (Cp = C padded to 64, 3 <= n <= 16)
// owns one 64-row tile of its own operand (f0 for df0, f1 for df1) and
// streams the other operand's 128-row tiles (f1's, or pairs of f0's 64-row
// tiles). Block j (its rank) holds output channels [S j, S j + w_j),
// w_j = min(S, Cp - S j): its slice of the own tile stays resident, and each
// streamed tile brings only that slice. A block is two warpgroups: the first
// runs the products and holds the slice's accumulators, both form dsim. For
// each streamed tile:
//   1. the partial similarity over the slice, s_j = own[:, slice] x
//      streamed[:, slice]^T (m64n128k16, one 64-channel chunk after another),
//      goes to the block's exchange tile X (f32 [64, 128]), while the second
//      warpgroup stages the next tile's column statistics;
//   2. cluster barrier; the tile's 1024 groups of 8 columns are dealt out to
//      the ranks in units of 32 (two rows of the tile, a warp's: unit u to
//      rank u % n, so a block reads ~32 KB of partials and writes ~16 KB of
//      dsim a tile whatever n is, and a warp's lanes hit distinct banks): a
//      thread sums its group's n partials from the n blocks' X, in rank order
//      (so s is the same for every launch), forms dsim there once on the whole device,
//      rounds it to bf16 and stores it into every block's dsim tile D
//      (distributed shared memory, 16 bytes a store), row-major with a padded
//      row so that the wgmma A fragments load without bank conflicts;
//   3. cluster barrier; out[:, slice] += D [64, 128] x streamed[:, slice]: the
//      A fragments from D, B the streamed chunks read MN-major (the bytes of
//      the first product's B, as in the tensor-core instance), m64n64k16 for
//      each of the slice's 64-channel chunks.
// One block an SM (its shared memory), so nothing else hides a warpgroup's
// latency: the second warpgroup halves the epilogue's share of a tile (on an
// H100 at C = 1024, B = 4, P = 7000, L = 4096: 3.8 -> 3.1 ms a side).
// Each similarity element is one product over the channels (split by slice)
// and each dsim element is formed once; no output is read back from device
// memory, and the slice's accumulators (128 registers a thread) are written
// once at the end. A ragged width has a narrower last slice (64, 128 or 192
// channels: fewer chunks, the same code); the own tile's rows past the operand
// and the streamed rows past the other's get dsim 0.
namespace wdf {

constexpr int S = 256;          // output channels a block holds (one warpgroup's accumulators)
constexpr int WNT = 2 * NT;      // threads a block: the products' warpgroup and one that helps with the epilogue
constexpr int MAX_CLUSTER = 16;  // C up to 4096; above 8 blocks a cluster is non-portable
constexpr int NS = 128;          // rows of a streamed tile: columns of s a step gives
constexpr int NCH = S / 64;      // 64-channel chunks of a slice
constexpr uint32_t OWN_CHUNK = TM * 128;  // [64 rows, 64 channels] bf16 image
constexpr uint32_t ST_CHUNK = NS * 128;   // [128 rows, 64 channels]
constexpr uint32_t STAGE = NCH * ST_CHUNK;
constexpr int XS = NS + 8;  // row stride of X (floats): two-way banks at most for the fragment's stores
constexpr int DS = NS + 8;  // row stride of D (bf16, 272 bytes): conflict-free A fragment loads
constexpr int GROUPS = TM * NS / 8;  // 8-column groups of a tile
// shared memory: own slice, two stages, X, D, stats (own [3][64], streamed [2][3][128]), barriers
constexpr uint32_t OFF_ST = NCH * OWN_CHUNK;
constexpr uint32_t OFF_X = OFF_ST + 2 * STAGE;
constexpr uint32_t OFF_D = OFF_X + TM * XS * 4;
constexpr uint32_t OFF_STATS = OFF_D + TM * DS * 2;
constexpr uint32_t OFF_BAR = OFF_STATS + (3 * TM + 2 * 3 * NS) * 4;
constexpr size_t SMEM = OFF_BAR + 3 * 8;
static_assert(SMEM <= 232448, "a block's shared memory");
static_assert(OFF_D % 16 == 0 && OFF_BAR % 8 == 0, "alignment");

__host__ __device__ __forceinline__ int cluster_size(int c) { return (wd::pad_channels(c) + S - 1) / S; }
static_assert((MAX_C_WIDE + S - 1) / S <= MAX_CLUSTER, "the widest operand fits a cluster");

}  // namespace wdf

// df0 (T1 = false): own rows p of f0 (64-row tiles), streamed f1 (128-row
// tiles), out[b, p, :] = sum_l dsim[p, l] f1[l, :]. df1 (T1 = true): own rows l
// of f1 (a half of a 128-row tile), streamed pairs of f0's 64-row tiles,
// out[b, l, :] = sum_p dsim[p, l] f0[p, :]. Grid (own tiles * n, B), clusters of n.
template <bool T1>
__global__ void __launch_bounds__(wdf::WNT, 1) dfeat_wide_kernel(Args a, float* __restrict__ out, int n) {
  using namespace wdf;
  extern __shared__ __align__(128) unsigned char smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cp = wd::pad_channels(a.C), nchk = cp / 64, c0 = rank * S;
  const int nc = min(S, cp - c0) / 64;  // this block's chunks
  const int own_t = blockIdx.x / n, b = blockIdx.y, tid = threadIdx.x;
  const bool prod = tid < NT;  // the products' warpgroup; the other forms dsim beside it and stages stats
  const Frag fr;
  const int own_n = T1 ? a.L : a.P, oth_n = T1 ? a.P : a.L;
  const int n_f0 = pad_rows(a.P) / TM;  // f0's 64-row tiles
  const int n_tiles = T1 ? (n_f0 + 1) / 2 : wd::pad_rows(a.L, NS) / NS;
  const unsigned char* f0b =
      reinterpret_cast<const unsigned char*>(a.f0 + (size_t)b * pad_rows(a.P) * cp);
  const unsigned char* f1b =
      reinterpret_cast<const unsigned char*>(a.f1 + (size_t)b * wd::pad_rows(a.L, NS) * cp);
  // chunk u of f0's 64-row tile t / f1's 128-row tile t
  const auto f0_chunk = [&](int t, int u) { return f0b + ((size_t)t * nchk + u) * OWN_CHUNK; };
  const auto f1_chunk = [&](int t, int u) { return f1b + ((size_t)t * nchk + u) * ST_CHUNK; };
  unsigned char* own = smem;
  float* xs = reinterpret_cast<float*>(smem + OFF_X);
  bf16* dsm = reinterpret_cast<bf16*>(smem + OFF_D);
  float* own_st = reinterpret_cast<float*>(smem + OFF_STATS);  // [lse, sum of g, gt][64]
  float* oth_st = own_st + 3 * TM;                              // [parity][lse, sum of g, gt][128]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + OFF_BAR);  // own, stage 0, stage 1
  const float* own_lse = T1 ? a.col_lse : a.row_lse;
  const float* own_sum = T1 ? a.colg : a.rowg;
  const float* oth_lse = T1 ? a.row_lse : a.col_lse;
  const float* oth_sum = T1 ? a.rowg : a.colg;

  // streamed tile it's slice into stage it % 2 (thread 0)
  const auto fetch = [&](int it) {
    unsigned char* dst = smem + OFF_ST + (it & 1) * STAGE;
    uint64_t* bb = bar + 1 + (it & 1);
    wg::mbar_expect_tx(bb, nc * ST_CHUNK);
    if (!T1) {
      wg::bulk_load(dst, f1_chunk(it, 4 * rank), nc * ST_CHUNK, bb);
    } else {  // f0's tiles 2 it and 2 it + 1 as the two halves of each chunk image
      const int t1 = min(2 * it + 1, n_f0 - 1);  // a missing second tile: rows masked below
      for (int c = 0; c < nc; ++c) {
        wg::bulk_load(dst + c * ST_CHUNK, f0_chunk(2 * it, 4 * rank + c), OWN_CHUNK, bb);
        wg::bulk_load(dst + c * ST_CHUNK + OWN_CHUNK, f0_chunk(t1, 4 * rank + c), OWN_CHUNK, bb);
      }
    }
  };
  // the streamed tile's column stats (LSE, sum of g, GT of f0's rows for df1), by the helper warpgroup
  const auto stage_stats = [&](int it) {
    if (prod) return;
    float* x = oth_st + (it & 1) * 3 * NS;
    const int i = tid - NT, c = it * NS + i;
    const bool ok = c < oth_n;
    x[i] = ok ? oth_lse[(size_t)b * oth_n + c] : 0.f;
    x[NS + i] = ok ? oth_sum[(size_t)b * oth_n + c] : 0.f;
    reinterpret_cast<int*>(x)[2 * NS + i] = T1 && ok ? a.gt[(size_t)b * a.P + c] : -2;
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) wg::mbar_init(bar + i, 1);
    wg::mbar_init_fence();
  }
  if (tid < TM) {
    const int r = own_t * TM + tid;
    const bool ok = r < own_n;
    own_st[tid] = ok ? own_lse[(size_t)b * own_n + r] : 0.f;
    own_st[TM + tid] = ok ? own_sum[(size_t)b * own_n + r] : 0.f;
    reinterpret_cast<int*>(own_st)[2 * TM + tid] = !T1 && ok ? a.gt[(size_t)b * a.P + r] : -2;
  }
  stage_stats(0);
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect_tx(bar, nc * OWN_CHUNK);
    if (!T1) {
      wg::bulk_load(own, f0_chunk(own_t, 4 * rank), nc * OWN_CHUNK, bar);
    } else {  // the half of f1's 128-row tile that holds these 64 rows
      for (int c = 0; c < nc; ++c)
        wg::bulk_load(own + c * OWN_CHUNK, f1_chunk(own_t >> 1, 4 * rank + c) + (own_t & 1) * OWN_CHUNK,
                      OWN_CHUNK, bar);
    }
    for (int it = 0; it < 2 && it < n_tiles; ++it) fetch(it);
  }
  const float pos_coef = a.coef[0] * a.focal.alpha, neg_coef = a.coef[1] * (1.f - a.focal.alpha);
  float acc2[NCH][32];  // the products' warpgroup's
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[c][i] = 0.f;
  const uint32_t own_addr = wg::smem_u32(own);
  wg::mbar_wait(bar, 0);

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const uint32_t st = wg::smem_u32(smem + OFF_ST + (it & 1) * STAGE);
    if (prod) {
      wg::mbar_wait(bar + 1 + (it & 1), (it >> 1) & 1);
      // 1. the partial similarity over this block's slice
      float acc[64];
      wg::fence();
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (c < nc)
            wg::mma_n128(acc, wg::desc(own_addr + c * OWN_CHUNK + kk * 256, 128, 1024),
                         wg::desc(st + c * ST_CHUNK + kk * 256, 128, 1024), (c > 0 || kk > 0) ? 1 : 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(acc);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(xs + fr.row(h) * XS + 8 * j + 2 * fr.t) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    } else if (it + 1 < n_tiles) {
      stage_stats(it + 1);
    }
    cluster.sync();  // every rank's partial of this tile is in its X
    // 2. this rank's groups: s summed in rank order, dsim formed and all-gathered
    const float* x = oth_st + (it & 1) * 3 * NS;
    for (int gi = (rank + n * (tid >> 5)) * 32 + (tid & 31); gi < GROUPS; gi += n * WNT) {
      const int row = gi >> 4, col0 = (gi & 15) * 8, orow = own_t * TM + row;
      float s[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = 0.f;
      for (int r = 0; r < n; ++r) {
        const float* xr = cluster.map_shared_rank(xs, r) + row * XS + col0;
        const float4 lo = *reinterpret_cast<const float4*>(xr);
        const float4 hi = *reinterpret_cast<const float4*>(xr + 4);
        s[0] += lo.x, s[1] += lo.y, s[2] += lo.z, s[3] += lo.w;
        s[4] += hi.x, s[5] += hi.y, s[6] += hi.z, s[7] += hi.w;
      }
      const float rl = own_st[row], rg = own_st[TM + row];
      const int rgt = reinterpret_cast<const int*>(own_st)[2 * TM + row];
      float d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int cc = col0 + e, c = it * NS + cc;
        const float xl = x[cc], xsum = x[NS + cc];
        const int xg = reinterpret_cast<const int*>(x)[2 * NS + cc];
        const float sv = s[e] * a.inv_temp;
        const float v = T1 ? dsim(sv, xl, rl, xsum, rg, xg == orow, pos_coef, neg_coef, a.inv_temp, a.focal)
                           : dsim(sv, rl, xl, rg, xsum, rgt == c, pos_coef, neg_coef, a.inv_temp, a.focal);
        d[e] = orow < own_n && c < oth_n ? v : 0.f;
      }
      const uint4 v = make_uint4(bf16_pair(d[0], d[1]), bf16_pair(d[2], d[3]), bf16_pair(d[4], d[5]),
                                 bf16_pair(d[6], d[7]));
      for (int r = 0; r < n; ++r)
        *reinterpret_cast<uint4*>(cluster.map_shared_rank(dsm, r) + row * DS + col0) = v;
    }
    cluster.sync();  // every rank's D holds the whole dsim tile; the X are read
    // 3. out[:, slice] += dsim x streamed[:, slice]
    if (prod) {
      uint32_t af[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const bf16* d0 = dsm + fr.row(0) * DS + 16 * kk + 2 * fr.t;
        af[kk][0] = *reinterpret_cast<const uint32_t*>(d0);
        af[kk][1] = *reinterpret_cast<const uint32_t*>(d0 + 8 * DS);
        af[kk][2] = *reinterpret_cast<const uint32_t*>(d0 + 8);
        af[kk][3] = *reinterpret_cast<const uint32_t*>(d0 + 8 * DS + 8);
      }
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          if (c < nc)  // MN-major: LBO steps along the streamed rows (1024), SBO along the channels (128)
            wg::mma_rs_n64_tb(acc2[c], af[kk], wg::desc(st + c * ST_CHUNK + kk * 2048, 1024, 128), 1);
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int c = 0; c < NCH; ++c) wg::fence_regs(acc2[c]);
    }
    __syncthreads();  // every warp's products have read the stage
    if (tid == 0 && it + 2 < n_tiles) fetch(it + 2);
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (c >= nc || !prod) break;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = own_t * TM + fr.row(h), col = c0 + 64 * c + 8 * jj + 2 * fr.t;
        if (r >= own_n) continue;
        float* o = out + ((size_t)b * own_n + r) * a.C;
        if (col < a.C) o[col] = acc2[c][4 * jj + 2 * h] * a.grad_scale;
        if (col + 1 < a.C) o[col + 1] = acc2[c][4 * jj + 2 * h + 1] * a.grad_scale;
      }
  }
}

bool bad_shape(int B, int P, int L, int C, int max_c) {
  return B <= 0 || B > 65535 || P <= 0 || L <= 0 || C <= 0 || C > max_c;
}

template <int NC, bool CHUNKED>
void launch_dfeat(const Args& a, float* df0, float* df1, int B, cudaStream_t st) {
  const int cp = pad_channels(a.C), chunks = (cp + MAXC - 1) / MAXC;
  static int have0[opp::MAX_DEVICES], have1[opp::MAX_DEVICES];
  opp::raise_smem_limit(dfeat_tc_kernel<false, NC, CHUNKED>, smem_bytes(cp), have0);
  opp::raise_smem_limit(dfeat_tc_kernel<true, NC, CHUNKED>, smem_bytes(cp), have1);
  dfeat_tc_kernel<false, NC, CHUNKED>
      <<<dim3(pad_rows(a.P) / TM, B, chunks), NT, smem_bytes(cp), st>>>(a, df0);
  dfeat_tc_kernel<true, NC, CHUNKED>
      <<<dim3(pad_rows(a.L) / TM, B, chunks), NT, smem_bytes(cp), st>>>(a, df1);
}

template <bool CHUNKED>
void launch_dfeat_pieces(const Args& a, float* df0, float* df1, int B, cudaStream_t st) {
  const int cp = pad_channels(a.C);
  if (cp % 64 == 0)
    launch_dfeat<64, CHUNKED>(a, df0, df1, B, st);
  else if (cp % 32 == 0)
    launch_dfeat<32, CHUNKED>(a, df0, df1, B, st);
  else
    launch_dfeat<16, CHUNKED>(a, df0, df1, B, st);
}

// One feature gradient of the wide instance: n_own 64-row tiles of its own
// operand, a cluster of wdf::cluster_size(C) blocks each.
template <bool T1>
int launch_dfeat_wide(const Args& a, float* out, int n_own, int B, cudaStream_t st) {
  const int n = wdf::cluster_size(a.C);
  static int have[opp::MAX_DEVICES];
  opp::raise_smem_limit(dfeat_wide_kernel<T1>, wdf::SMEM, have);
  if (n > 8)  // 9-16 blocks a cluster: allowed on the H100, not portable
    cudaFuncSetAttribute(dfeat_wide_kernel<T1>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_own * n, B);
  cfg.blockDim = dim3(wdf::WNT);
  cfg.dynamicSmemBytes = wdf::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, dfeat_wide_kernel<T1>, a, out, n);
}

Args make_args(const void* f0, const void* f1, const int* gt, const float* row_lse,
               const float* col_lse, const float* coef, const float* rowg, const float* colg,
               int P, int L, int C, float inv_temp, float alpha, float gamma,
               float grad_scale) {
  return Args{static_cast<const bf16*>(f0), static_cast<const bf16*>(f1), gt, row_lse, col_lse,
              coef, rowg, colg, P, L, C, inv_temp, grad_scale, Focal{alpha, gamma}};
}

constexpr size_t WIDE_SMEM = wd::smem_bytes_bf16<wd::NST_BF16>();

}  // namespace

// Forward after opp_dual_lse_bf16, on the packed operands (opp_pack_operand_*):
// per-row alpha * pos sums, (1 - alpha) * neg sums and max conf, each [B, P].
extern "C" int opp_coarse_loss_fwd(const void* f0, const void* f1, const int* gt,
                                   const float* row_lse, const float* col_lse, float* pos,
                                   float* neg, float* mx, int B, int P, int L, int C,
                                   float inv_temp, float alpha, float gamma, void* stream) {
  if (bad_shape(B, P, L, C, MAX_C)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(f0, f1, gt, row_lse, col_lse, nullptr, nullptr, nullptr, P, L, C,
                           inv_temp, alpha, gamma, 1.f);
  const int cp = pad_channels(C);
  static int have[opp::MAX_DEVICES];
  opp::raise_smem_limit(loss_tc_kernel, smem_bytes(cp), have);
  loss_tc_kernel<<<dim3(pad_rows(P) / TM, B), NT, smem_bytes(cp),
                   static_cast<cudaStream_t>(stream)>>>(a, pos, neg, mx);
  return (int)cudaGetLastError();
}

// Backward on the packed operands: coef = (dL/dpos_sum, dL/dneg_sum) on the
// device; rowg [B, P], colg [B, L] and colpart [B, row tiles, L] are scratch;
// df0 [B, P, C] and df1 [B, L, C] f32 outputs, the gradients of the packed
// operands times grad_scale (the pack's scale: the gradients of its input).
extern "C" int opp_coarse_loss_bwd(const void* f0, const void* f1, const int* gt,
                                   const float* row_lse, const float* col_lse, const float* coef,
                                   float* rowg, float* colg, float* colpart, float* df0,
                                   float* df1, int B, int P, int L, int C, float inv_temp,
                                   float alpha, float gamma, float grad_scale, void* stream) {
  if (bad_shape(B, P, L, C, MAX_C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cp = pad_channels(C), n_pt = pad_rows(P) / TM;
  const Args a = make_args(f0, f1, gt, row_lse, col_lse, coef, rowg, colg, P, L, C, inv_temp,
                           alpha, gamma, grad_scale);
  static int have[opp::MAX_DEVICES];
  opp::raise_smem_limit(gsum_tc_kernel, smem_bytes(cp), have);
  gsum_tc_kernel<<<dim3(n_pt, B), NT, smem_bytes(cp), st>>>(a, rowg, colpart);
  colg_reduce<<<dim3((L + 255) / 256, B), 256, 0, st>>>(colpart, colg, n_pt, L);
  if (cp > MAXC)
    launch_dfeat_pieces<true>(a, df0, df1, B, st);
  else
    launch_dfeat_pieces<false>(a, df0, df1, B, st);
  return (int)cudaGetLastError();
}

// The wide instance (576 < C <= 4096): f0 and f1 packed by opp_pack_wide_*
// (f0 in 64-row, f1 in 128-row tiles, already scaled), the row and column
// LSEs from opp_dual_lse_wide_bf16 over them; the other arguments as
// opp_coarse_loss_fwd's.
extern "C" int opp_coarse_loss_fwd_wide(const void* f0, const void* f1, const int* gt,
                                        const float* row_lse, const float* col_lse, float* pos,
                                        float* neg, float* mx, int B, int P, int L, int C,
                                        float inv_temp, float alpha, float gamma, void* stream) {
  if (bad_shape(B, P, L, C, MAX_C_WIDE)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(f0, f1, gt, row_lse, col_lse, nullptr, nullptr, nullptr, P, L, C,
                           inv_temp, alpha, gamma, 1.f);
  static int have[opp::MAX_DEVICES];
  opp::raise_smem_limit(loss_wide_kernel, WIDE_SMEM, have);
  loss_wide_kernel<<<dim3(pad_rows(P) / TM, B), NT, WIDE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      a, pos, neg, mx);
  return (int)cudaGetLastError();
}

// Backward of the wide instance, the arguments as opp_coarse_loss_bwd's on
// the operands of opp_coarse_loss_fwd_wide.
extern "C" int opp_coarse_loss_bwd_wide(const void* f0, const void* f1, const int* gt,
                                        const float* row_lse, const float* col_lse,
                                        const float* coef, float* rowg, float* colg,
                                        float* colpart, float* df0, float* df1, int B, int P,
                                        int L, int C, float inv_temp, float alpha, float gamma,
                                        float grad_scale, void* stream) {
  if (bad_shape(B, P, L, C, MAX_C_WIDE)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pt = pad_rows(P) / TM;
  const Args a = make_args(f0, f1, gt, row_lse, col_lse, coef, rowg, colg, P, L, C, inv_temp,
                           alpha, gamma, grad_scale);
  static int have[opp::MAX_DEVICES];
  opp::raise_smem_limit(gsum_wide_kernel, WIDE_SMEM, have);
  gsum_wide_kernel<<<dim3(n_pt, B), NT, WIDE_SMEM, st>>>(a, rowg, colpart);
  colg_reduce<<<dim3((L + 255) / 256, B), 256, 0, st>>>(colpart, colg, n_pt, L);
  int rc = (int)cudaGetLastError();
  if (rc == 0) rc = launch_dfeat_wide<false>(a, df0, n_pt, B, st);
  if (rc == 0) rc = launch_dfeat_wide<true>(a, df1, (L + TM - 1) / TM, B, st);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// Blocks of a cluster of the wide instance's feature gradients at C channels.
extern "C" int opp_coarse_loss_cluster_size(int C) { return wdf::cluster_size(C); }

// Row tiles of the colpart scratch ([B, tiles, L]), both instances.
extern "C" int opp_coarse_loss_row_tiles(int P) { return pad_rows(P) / TM; }
