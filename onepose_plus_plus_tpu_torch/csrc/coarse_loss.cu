// K5: the fused coarse focal loss over the dual softmax, forward and backward,
// never materialising [P, L].
//
// Replaces onepose_plus_plus_tpu/ops/pallas_coarse_loss.py::fused_coarse_focal_loss
// (_loss_kernel, _gsum_kernel, _dfeat_kernel). With s = f0 f1^T * inv_temp over
// f0, f1 already scaled by 1/sqrt(C) and rounded to bf16 (f32 accumulation):
//   log conf[p, l] = min(2 s - colLSE[l] - rowLSE[p], LOGCAP)
// The row/column LSEs come from K2's LSE pass (matching.cu: opp_dual_lse_bf16
// on the tensor cores, opp_dual_lse_cc_bf16 on the CUDA cores), as the TPU
// kernel shares pallas_matching._lse_kernel. Then:
//   loss_*_kernel    per-row pos/neg focal sums (times alpha, 1 - alpha) and
//                    the per-row max conf; the wrapper sums rows.
//   gsum_*_kernel    g = dL/dlogconf per element (zero where the LOGCAP cap is
//                    active), row sums kept in the block, column sums as
//                    per-row-tile partials, merged in order by colg_reduce.
//   dfeat_*_kernel   df0 = dsim f1, one block per row tile over the column
//                    tiles, and df1 = dsim^T f0, one block per column tile over
//                    the row tiles,
// with dsim = (2 g - softmax_p * colsum_g - softmax_l * rowsum_g) * inv_temp
// rounded to bf16 before both products (the TPU kernel's ds16), products in
// f32. Every pass recomputes its similarity tiles (flash-attention style), so
// no [P, L] tensor and no [B, n_row_tiles, L, C] partial is ever stored, and
// no pass needs atomics: the result is the same bit for bit from run to run.
//
// Bound: operations, seven P*L*C products (LSE, loss, gsum, and two for each
// feature gradient), then ~14 transcendentals per similarity element over the
// four passes. Two instances, by width (ops/cuda_coarse_loss.py::k5_instance):
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
// 576 < C <= 4096 (as wide as K1 goes): the same passes on the CUDA cores over
// unpacked bf16 operands, on sim_tile.cuh's register-blocked f32 tile staged
// in shared memory. A correctness instance, not tuned (see cc:: below).
#include "sim_tile.cuh"
#include "sim_tile_tc.cuh"

namespace {

using namespace opp::tc;

using bf16 = __nv_bfloat16;
constexpr float LOGCAP = -1e-6f;       // log conf <= log(1 - ~1e-6): log1p stays finite
constexpr float CONF_CAP = 0.999999f;  // exp(LOGCAP) rounded down
constexpr int MAXC = 256;              // channels the feature-gradient accumulators hold (a chunk)
constexpr int MAXC_CC = 4096;          // the CUDA-core instance's widest operand (K1's widest)

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
  const bf16* f0;  // packed [B, P_pad / 8, Cp / 8, 8, 8]
  const bf16* f1;  // packed [B, L_pad / 8, Cp / 8, 8, 8]
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

// Block set-up of the row-tile passes (loss, gsum): f0's row tile resident, f1 streamed.
struct RowPass {
  int cp, p0, b, w, g, t;
  __device__ RowPass(const Args& a)
      : cp(pad_channels(a.C)), p0(blockIdx.x * TM), b(blockIdx.y), w(threadIdx.x >> 5),
        g((threadIdx.x >> 2) & 7), t(threadIdx.x & 3) {}
  __device__ int row(int h) const { return p0 + 16 * w + g + 8 * h; }
  __device__ int col(int q) const { return 8 * (q >> 1) + 2 * t + (q & 1); }  // within a tile
};

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(NT, 2)
    loss_tc_kernel(Args a, float* __restrict__ pos_out, float* __restrict__ neg_out,
                float* __restrict__ mx_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowPass rp(a);
  const int P = a.P, L = a.L, cp = rp.cp, b = rp.b;
  const Tiles tl(smem, cp, a.f1 + (size_t)b * pad_rows(L) * cp, pad_rows(L) / TM);
  tl.start(a.f0 + ((size_t)b * pad_rows(P) + rp.p0) * cp);
  const uint32_t a_addr = tl.resident();
  float rl[2];
  int gtp[2];
  bool okr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = rp.row(h);
    okr[h] = p < P;
    rl[h] = okr[h] ? a.row_lse[(size_t)b * P + p] : 0.f;
    gtp[h] = okr[h] ? a.gt[(size_t)b * P + p] : -2;
  }
  float pos[2] = {0.f, 0.f}, neg[2] = {0.f, 0.f}, mx[2] = {0.f, 0.f};

#pragma unroll 1
  for (int it = 0; it < tl.n_tiles; ++it) {
    const int l0 = it * TM;
    float acc[32];
    sim_product(acc, a_addr, tl.wait(it), cp);
    float cl[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int l = l0 + rp.col(q);
      cl[q] = l < L ? a.col_lse[(size_t)b * L + l] : 0.f;
    }
    wg::wait<0>();
    wg::fence_regs(acc);
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + rp.col(q);
        const float s = acc[4 * (q >> 1) + 2 * h + (q & 1)] * a.inv_temp;
        const float lc = fminf(2.f * s - cl[q] - rl[h], LOGCAP);
        const float conf = exp_fast(lc);
        float tp, tn;
        a.focal.terms(conf, lc, tp, tn);
        const bool ok = okr[h] && l < L, is_pos = gtp[h] == l;
        pos[h] += ok && is_pos ? tp : 0.f;
        neg[h] += ok && !is_pos ? tn : 0.f;
        mx[h] = ok ? fmaxf(mx[h], conf) : mx[h];
      }
    __syncthreads();  // every warp's product has read the stage
    tl.release(it);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float ps = quad_sum(pos[h]), ns = quad_sum(neg[h]), m = quad_max(mx[h]);
    if (rp.t == 0 && okr[h]) {
      const size_t o = (size_t)b * P + rp.row(h);
      pos_out[o] = a.focal.alpha * ps;
      neg_out[o] = (1.f - a.focal.alpha) * ns;
      mx_out[o] = m;
    }
  }
}

// ---------------------------------------------------------- backward: sums

__global__ void __launch_bounds__(NT, 2)
    gsum_tc_kernel(Args a, float* __restrict__ rowg_out, float* __restrict__ colpart) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowPass rp(a);
  const int P = a.P, L = a.L, cp = rp.cp, b = rp.b, tid = threadIdx.x;
  const Tiles tl(smem, cp, a.f1 + (size_t)b * pad_rows(L) * cp, pad_rows(L) / TM);
  tl.start(a.f0 + ((size_t)b * pad_rows(P) + rp.p0) * cp);
  const uint32_t a_addr = tl.resident();
  float* cpart = colpart + ((size_t)b * gridDim.x + blockIdx.x) * L;
  const float pos_coef = a.coef[0] * a.focal.alpha, neg_coef = a.coef[1] * (1.f - a.focal.alpha);
  float rl[2];
  int gtp[2];
  bool okr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = rp.row(h);
    okr[h] = p < P;
    rl[h] = okr[h] ? a.row_lse[(size_t)b * P + p] : 0.f;
    gtp[h] = okr[h] ? a.gt[(size_t)b * P + p] : -2;
  }
  float rowg[2] = {0.f, 0.f};

#pragma unroll 1
  for (int it = 0; it < tl.n_tiles; ++it) {
    const int l0 = it * TM;
    float acc[32];
    sim_product(acc, a_addr, tl.wait(it), cp);
    float cl[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int l = l0 + rp.col(q);
      cl[q] = l < L ? a.col_lse[(size_t)b * L + l] : 0.f;
    }
    wg::wait<0>();
    wg::fence_regs(acc);
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (q >> 1) + 2 * h + (q & 1), l = l0 + rp.col(q);
        const float raw = 2.f * (acc[i] * a.inv_temp) - cl[q] - rl[h];
        const float ge = elem_g(raw, exp_fast(raw), gtp[h] == l, pos_coef, neg_coef, a.focal);
        acc[i] = okr[h] && l < L ? ge : 0.f;
        rowg[h] += acc[i];
      }
    float* sc = tl.cols(it);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int i = 4 * (q >> 1) + (q & 1);
      const float v = col_sum(acc[i] + acc[i + 2]);
      if (rp.g == 0) sc[rp.w * TM + rp.col(q)] = v;
    }
    __syncthreads();
    tl.release(it);
    if (tid < TM && l0 + tid < L) {  // warps in order
      float v = sc[tid];
#pragma unroll
      for (int u = 1; u < NWARP; ++u) v += sc[u * TM + tid];
      cpart[l0 + tid] = v;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v = quad_sum(rowg[h]);
    if (rp.t == 0 && okr[h]) rowg_out[(size_t)b * P + rp.row(h)] = v;
  }
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

// ------------------------------------------ CUDA-core instance (C > 576)
//
// The four passes on unpacked bf16 operands [B, rows, C] (the wrapper scales
// and rounds them), for widths whose tiles do not fit the tensor-core block's
// shared memory. Each pass is one block per 64-row tile of its own operand,
// streaming the other's 64-row tiles: opp::sim_tile (sim_tile.cuh, 256
// threads, f32 FMAs) leaves the similarity tile in shared memory, and thread
// (g, q) reads row g, columns 16 q .. 16 q + 15 of it, as K2's CUDA-core LSE
// pass. Row sums merge over the quad's four lanes, column sums over the
// quad's rows 16 q .. 16 q + 15 and then its lanes, in a fixed order.
//
// The feature gradients keep no [64, C] accumulators (C goes to 4096): after
// each streamed tile, dsim (rounded to bf16) replaces the tile in shared
// memory and a thread per output channel multiplies it with the streamed
// rows into 64 row sums, then adds them into the block's own rows of the f32
// output (read, add, write; the block owns those rows, the tiles come in
// order), so the result is the same bit for bit from run to run. Bound: the
// similarity products on the CUDA cores at f32 rate; this instance is right
// first and not tuned.
namespace cc {

using opp::BL;
using opp::BR;

// The per-row stats a pass needs of its own operand's row g.
struct OwnRow {
  bool ok;
  float lse;
  int gt;
};

__device__ __forceinline__ OwnRow own_row(const float* lse, const int* gt, int b, int n, int r) {
  const bool ok = r < n;
  return OwnRow{ok, ok ? lse[(size_t)b * n + r] : 0.f, ok && gt != nullptr ? gt[(size_t)b * n + r] : -2};
}

__global__ void __launch_bounds__(opp::NT)
    loss_cc_kernel(Args a, float* __restrict__ pos_out, float* __restrict__ neg_out,
                   float* __restrict__ mx_out) {
  __shared__ opp::TileSmem sm;
  const int P = a.P, L = a.L, C = a.C, b = blockIdx.y, p0 = blockIdx.x * BR;
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3;
  const bf16* f0 = a.f0 + (size_t)b * P * C;
  const bf16* f1 = a.f1 + (size_t)b * L * C;
  const OwnRow row = own_row(a.row_lse, a.gt, b, P, p0 + g);
  float pos = 0.f, neg = 0.f, mx = 0.f;
  for (int l0 = 0; l0 < L; l0 += BL) {
    opp::sim_tile<bf16>(f0, f1, nullptr, nullptr, p0, l0, P, L, C, a.inv_temp, sm);
    for (int j = 0; j < 16; ++j) {
      const int l = l0 + 16 * q + j;
      if (!row.ok || l >= L) continue;
      const float lc = fminf(2.f * sm.s[g][16 * q + j] - a.col_lse[(size_t)b * L + l] - row.lse,
                             LOGCAP);
      const float conf = expf(lc);
      float tp, tn;
      a.focal.terms(conf, lc, tp, tn);
      if (row.gt == l)
        pos += tp;
      else
        neg += tn;
      mx = fmaxf(mx, conf);
    }
    __syncthreads();
  }
  pos = quad_sum(pos);
  neg = quad_sum(neg);
  mx = quad_max(mx);
  if (q == 0 && row.ok) {
    const size_t o = (size_t)b * P + p0 + g;
    pos_out[o] = a.focal.alpha * pos;
    neg_out[o] = (1.f - a.focal.alpha) * neg;
    mx_out[o] = mx;
  }
}

__global__ void __launch_bounds__(opp::NT)
    gsum_cc_kernel(Args a, float* __restrict__ rowg_out, float* __restrict__ colpart) {
  __shared__ opp::TileSmem sm;
  const int P = a.P, L = a.L, C = a.C, b = blockIdx.y, p0 = blockIdx.x * BR;
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3;
  const bf16* f0 = a.f0 + (size_t)b * P * C;
  const bf16* f1 = a.f1 + (size_t)b * L * C;
  float* cpart = colpart + ((size_t)b * gridDim.x + blockIdx.x) * L;
  const float pos_coef = a.coef[0] * a.focal.alpha, neg_coef = a.coef[1] * (1.f - a.focal.alpha);
  const OwnRow row = own_row(a.row_lse, a.gt, b, P, p0 + g);
  float rowg = 0.f;
  for (int l0 = 0; l0 < L; l0 += BL) {
    opp::sim_tile<bf16>(f0, f1, nullptr, nullptr, p0, l0, P, L, C, a.inv_temp, sm);
    float ge[16];
    for (int j = 0; j < 16; ++j) {
      const int l = l0 + 16 * q + j;
      ge[j] = 0.f;
      if (row.ok && l < L) {
        const float raw = 2.f * sm.s[g][16 * q + j] - a.col_lse[(size_t)b * L + l] - row.lse;
        ge[j] = elem_g(raw, expf(raw), row.gt == l, pos_coef, neg_coef, a.focal);
      }
      rowg += ge[j];
    }
    __syncthreads();  // every similarity is read
    for (int j = 0; j < 16; ++j) sm.s[g][16 * q + j] = ge[j];
    __syncthreads();
    float cs = 0.f;  // column g over rows 16 q .. 16 q + 15, then the quad's lanes
    for (int j = 0; j < 16; ++j) cs += sm.s[16 * q + j][g];
    cs = quad_sum(cs);
    if (q == 0 && l0 + g < L) cpart[l0 + g] = cs;
    __syncthreads();
  }
  rowg = quad_sum(rowg);
  if (q == 0 && row.ok) rowg_out[(size_t)b * P + p0 + g] = rowg;
}

// df0 (T1 = false): rows p of f0 own the block, f1's tiles stream,
// out[b, p, :] = sum_l dsim[p, l] f1[l, :]. df1 (T1 = true): rows l of f1 own
// it, f0's tiles stream, out[b, l, :] = sum_p dsim[p, l] f0[p, :], on s^T.
template <bool T1>
__global__ void __launch_bounds__(opp::NT) dfeat_cc_kernel(Args a, float* __restrict__ out) {
  __shared__ opp::TileSmem sm;
  const int C = a.C, b = blockIdx.y, r0 = blockIdx.x * BR;
  const int own_n = T1 ? a.L : a.P, oth_n = T1 ? a.P : a.L;
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3, r = r0 + g;
  const bf16* own = (T1 ? a.f1 : a.f0) + (size_t)b * own_n * C;
  const bf16* oth = (T1 ? a.f0 : a.f1) + (size_t)b * oth_n * C;
  const float* own_sum = T1 ? a.colg : a.rowg;
  const float* oth_lse = T1 ? a.row_lse : a.col_lse;
  const float* oth_sum = T1 ? a.rowg : a.colg;
  const float pos_coef = a.coef[0] * a.focal.alpha, neg_coef = a.coef[1] * (1.f - a.focal.alpha);
  const OwnRow row = own_row(T1 ? a.col_lse : a.row_lse, T1 ? nullptr : a.gt, b, own_n, r);
  const float osum = row.ok ? own_sum[(size_t)b * own_n + r] : 0.f;
  const int rows = min(BR, own_n - r0);
  float* o = out + ((size_t)b * own_n + r0) * C;  // the block's own rows
  for (int c0 = 0; c0 < oth_n; c0 += BL) {
    opp::sim_tile<bf16>(own, oth, nullptr, nullptr, r0, c0, own_n, oth_n, C, a.inv_temp, sm);
    float d[16];
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 16 * q + j;
      d[j] = 0.f;
      if (row.ok && c < oth_n) {
        const float s = sm.s[g][16 * q + j];
        const float xl = oth_lse[(size_t)b * oth_n + c], xs = oth_sum[(size_t)b * oth_n + c];
        const float v =
            T1 ? dsim(s, xl, row.lse, xs, osum, a.gt[(size_t)b * a.P + c] == r, pos_coef,
                      neg_coef, a.inv_temp, a.focal)
               : dsim(s, row.lse, xl, osum, xs, row.gt == c, pos_coef, neg_coef, a.inv_temp,
                      a.focal);
        d[j] = opp::round_to<bf16>(v);
      }
    }
    __syncthreads();  // every similarity is read
    for (int j = 0; j < 16; ++j) sm.s[g][16 * q + j] = d[j];
    __syncthreads();
    const int nj = min(BL, oth_n - c0);
    const bool first = c0 == 0, last = c0 + BL >= oth_n;
    for (int k = threadIdx.x; k < C; k += opp::NT) {
      float acc[BR];
#pragma unroll
      for (int i = 0; i < BR; ++i) acc[i] = 0.f;
      for (int j = 0; j < nj; ++j) {
        const float v = __bfloat162float(oth[(size_t)(c0 + j) * C + k]);
#pragma unroll
        for (int i = 0; i < BR; ++i) acc[i] = fmaf(sm.s[i][j], v, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < BR; ++i) {
        if (i >= rows) break;
        float* dst = o + (size_t)i * C + k;
        const float v = (first ? 0.f : *dst) + acc[i];
        *dst = last ? v * a.grad_scale : v;
      }
    }
    __syncthreads();  // the dsim tile is read
  }
}

}  // namespace cc

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

Args make_args(const void* f0, const void* f1, const int* gt, const float* row_lse,
               const float* col_lse, const float* coef, const float* rowg, const float* colg,
               int P, int L, int C, float inv_temp, float alpha, float gamma,
               float grad_scale) {
  return Args{static_cast<const bf16*>(f0), static_cast<const bf16*>(f1), gt, row_lse, col_lse,
              coef, rowg, colg, P, L, C, inv_temp, grad_scale, Focal{alpha, gamma}};
}

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

// The CUDA-core instance (576 < C <= 4096): f0 [B, P, C] and f1 [B, L, C]
// bf16, already scaled and rounded, unpacked; the row and column LSEs from
// opp_dual_lse_cc_bf16; the other arguments as opp_coarse_loss_fwd's.
extern "C" int opp_coarse_loss_fwd_cc(const void* f0, const void* f1, const int* gt,
                                      const float* row_lse, const float* col_lse, float* pos,
                                      float* neg, float* mx, int B, int P, int L, int C,
                                      float inv_temp, float alpha, float gamma, void* stream) {
  if (bad_shape(B, P, L, C, MAXC_CC)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(f0, f1, gt, row_lse, col_lse, nullptr, nullptr, nullptr, P, L, C,
                           inv_temp, alpha, gamma, 1.f);
  cc::loss_cc_kernel<<<dim3((P + opp::BR - 1) / opp::BR, B), opp::NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, pos, neg, mx);
  return (int)cudaGetLastError();
}

// Backward of the CUDA-core instance, the arguments as opp_coarse_loss_bwd's
// on the unpacked operands of opp_coarse_loss_fwd_cc.
extern "C" int opp_coarse_loss_bwd_cc(const void* f0, const void* f1, const int* gt,
                                      const float* row_lse, const float* col_lse,
                                      const float* coef, float* rowg, float* colg,
                                      float* colpart, float* df0, float* df1, int B, int P,
                                      int L, int C, float inv_temp, float alpha, float gamma,
                                      float grad_scale, void* stream) {
  if (bad_shape(B, P, L, C, MAXC_CC)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pt = (P + opp::BR - 1) / opp::BR;
  const Args a = make_args(f0, f1, gt, row_lse, col_lse, coef, rowg, colg, P, L, C, inv_temp,
                           alpha, gamma, grad_scale);
  cc::gsum_cc_kernel<<<dim3(n_pt, B), opp::NT, 0, st>>>(a, rowg, colpart);
  colg_reduce<<<dim3((L + 255) / 256, B), 256, 0, st>>>(colpart, colg, n_pt, L);
  cc::dfeat_cc_kernel<false><<<dim3(n_pt, B), opp::NT, 0, st>>>(a, df0);
  cc::dfeat_cc_kernel<true><<<dim3((L + opp::BR - 1) / opp::BR, B), opp::NT, 0, st>>>(a, df1);
  return (int)cudaGetLastError();
}

// Row tiles of the colpart scratch ([B, tiles, L]), both instances.
extern "C" int opp_coarse_loss_row_tiles(int P) { return pad_rows(P) / TM; }
