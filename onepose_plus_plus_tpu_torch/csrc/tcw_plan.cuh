// The chain that K1's two tensor-core instances at every width but (256, 8)
// share (encoder_tcw.cu, bf16; encoder_tcw_tf32.cu, f32 in split TF32): its
// plan (64-row tiles, 128-column product blocks, the heads a block touches,
// the LayerNorms from per-block (mean, M2) partials), the product launches'
// parameters, the epilogues that do not depend on the operand type, and the
// host side: the scratch layout and the twelve launches in order. Each
// instance supplies the rest as a traits class T: its chunk width and chunk
// sizes, and its kernels (the product kernel in seven kinds, pack, reduce, LN1
// image, LN2 + residual), which keep their own names. The plan's CPU mirrors
// are ops/cuda_encoder.py's tcw_value_blocks, tcw_head_chunks,
// tcw32_head_chunks and tcw_source_chunks.
//
// Widths: C a multiple of 32 from 32 to 4096, any head count dividing C.
// Every activation image (x, source, Q', msg, the LN1 output) holds C padded
// to a whole 64-channel tile (padded(C)), its channels past C zero, and every
// weight chunk its input columns past C zero, so that padding adds nothing to
// a product's k sum; output columns past C are computed (their weight rows
// are zero) and never stored. The attention's B holds, besides the 128 value
// columns of its block, the denominators: where the head width is a multiple
// of 8, one row of sum K' for each of the at most 16 heads of a 128-column
// block (N = 144, the epilogue picks a column's row by its head); at any other
// head width (a head ends inside a thread's 8-column fragment group, and a
// block may hold up to 128 heads), the blocks are 64 columns wide and B's rows
// 64 + c hold column c's head sum K' on that head's channels (N = 128, the
// denominator of column c is column 64 + c, in the same thread and register
// row: the TPU kernel's replicated layout, independent of the head width).
#pragma once

#include <cuda_runtime.h>

#include "wgmma.cuh"
#include "wgmma_gemm.cuh"

namespace opp {
namespace tcw_plan {

constexpr int TM = 64;   // rows of a tile
constexpr int BN = 128;  // output columns of a product block
constexpr int BR = 64;   // output columns of an attention block with replicated denominators
constexpr int SUMS = 16; // rows of head sums in the attention's B otherwise (N = BN + SUMS)
constexpr int FILL = 132;  // stats blocks a launch should have at least: one an SM of an H100 SXM
constexpr uint32_t CHUNK = gemm::A_CHUNK;  // 8192: an image chunk ([64, 64] bf16 or [64, 32] f32)
constexpr float EPS = 1e-6f;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float elu_p1_fast(float x) {  // as encoder.cu's tc::elu_p1_fast
  return opp::wg::ex2_fast(fminf(x, 0.f) * 1.4426950408889634f) + fmaxf(x, 0.f);
}

// C padded to a whole 64-channel tile: the channels of an activation image.
__host__ __device__ __forceinline__ int padded(int C) { return (C + TM - 1) / TM * TM; }

// Whether the attention keeps replicated denominators (64-column blocks)
// rather than rows of head sums: head widths that are not a multiple of 8.
__host__ __device__ __forceinline__ bool replicated(int hd) { return hd % 8 != 0; }

// The 128-column blocks of V^T whose channels share a head with the channels
// below C of 64-channel tile i.
__host__ __device__ __forceinline__ void value_blocks(int i, int C, int hd, int& lo, int& hi) {
  const int h_a = (TM * i) / hd, h_b = ((TM * i + TM < C ? TM * i + TM : C) - 1) / hd;
  lo = h_a * hd / BN;
  hi = ((h_b + 1) * hd - 1) / BN;
}

// The heads [h_first, h_last] of attention column block nb, bw columns wide,
// and the k chunks [k_lo, k_hi) of kw channels of Q' they read.
__host__ __device__ __forceinline__ void head_chunks(int nb, int bw, int C, int hd, int kw, int& h_first,
                                                     int& h_last, int& k_lo, int& k_hi) {
  const int n0 = nb * bw;
  h_first = n0 / hd;
  h_last = ((n0 + bw < C ? n0 + bw : C) - 1) / hd;
  k_lo = h_first * hd / kw;
  k_hi = ((h_last + 1) * hd + kw - 1) / kw;
}

// The products of the chain: their kinds, in launch order, and what a product
// launch reads and writes.
// (ATT: the attention with rows of head sums; ATT_REP: with replicated denominators.)
enum Kind { KV_PROJ, STATS, QPROJ, ATT, ATT_REP, RAW, RELU };

struct Params {
  const unsigned char* a0;  // A image: chunks 0..ka0-1 of a row tile
  const unsigned char* a1;  // A image: chunks ka0..ka-1 (FFN hidden: [x | LN1])
  int ka0, ka, a_tiles;     // k chunks of a row tile in a0, in all; row tiles a batch element
  const unsigned char* b;   // B chunks [batch][column block][kb] (split TF32: each hi then lo)
  long long b_batch;        // bytes from one batch element's B chunks to the next (0: weights)
  int kb;                   // chunks a column block has
  uint32_t b_bytes;         // bytes of a B chunk (split TF32: of its hi or lo half)
  int n;                    // output columns
  int C, hd, rows, tiles;   // width, head width, valid rows of A, row tiles of the output image
  int G, n_src_chunks, nb;  // source groups, source chunks, 128-column blocks of C
  int sg;                   // source chunks a stats block sums (the last group's may be fewer)
  int out_k;                // k chunks of the output image (its columns past n are written as zeros)
  const float* mask;
  unsigned char* out0;      // output image (K'^T for KV_PROJ)
  unsigned char* out1;      // V^T (KV_PROJ)
  float* outf;              // f32 rows (RAW) or partials (STATS)
  float* lnp;               // (mean, M2) per row and column block (RAW)
};

// The mask of the block's two accumulator rows r_loc[h] of row tile rt: 0 past p.rows.
__device__ __forceinline__ void row_mask(const Params& p, int b, int rt, const int (&r_loc)[2], float (&m)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rt * TM + r_loc[h];
    m[h] = r < p.rows ? (p.mask != nullptr ? p.mask[(size_t)b * p.rows + r] : 1.f) : 0.f;
  }
}

// The STATS epilogue: this source group's partials, part[b][grp][d][e - the
// first channel of d's head], and sum K' (the B column 128) at [d][hd], for
// the channels d below C (the last tile's rows past C are not written by K/V).
template <int NT>
__device__ __forceinline__ void store_stats(const Params& p, const float (&acc)[NT / 2], int b, int grp, int rt,
                                            int nb, int vb_lo, const int (&r_loc)[2], int t) {
  float* out = p.outf + ((size_t)b * p.G + grp) * p.C * (p.hd + 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = rt * TM + r_loc[h], head0 = (d / p.hd) * p.hd;
    if (d >= p.C) continue;
    float* row = out + (size_t)d * (p.hd + 1);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nb * BN + 8 * j + 2 * t + e;
        if (col < p.C && col >= head0 && col < head0 + p.hd) row[col - head0] = acc[4 * j + 2 * h + e];
      }
    if (t == 0 && nb == vb_lo) row[p.hd] = acc[64 + 2 * h];
  }
}

// The RAW epilogue: f32 rows and each row's (mean, M2) over this block's columns.
__device__ __forceinline__ void store_raw(const Params& p, const float (&acc)[BN / 2], int b, int rt, int nb,
                                          const int (&r_loc)[2], int t) {
  const int valid = min(16, (p.n - nb * BN) / 8);  // 8-column groups of this block inside N
  const float inv_n = 1.f / (8 * valid);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)b * p.tiles * TM + rt * TM + r_loc[h];
    float* dst = p.outf + row * p.n + nb * BN + 2 * t;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < valid) {
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        s += v0 + v1;
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(v0, v1);
      }
    const float mean = gemm::quad_sum(s) * inv_n;
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < valid) {
        const float d0 = acc[4 * j + 2 * h] - mean, d1 = acc[4 * j + 2 * h + 1] - mean;
        m2 += d0 * d0 + d1 * d1;
      }
    m2 = gemm::quad_sum(m2);
    if (t == 0) *reinterpret_cast<float2*>(p.lnp + (row * p.nb + nb) * 2) = make_float2(mean, m2);
  }
}

// A row's LayerNorm statistics from its column blocks' (mean, M2), merged in
// block order by Chan's formula; rstd over C columns (biased variance).
__device__ __forceinline__ void row_stats(const float* __restrict__ lnp, size_t row, int nb, int C,
                                          float& mean, float& rstd) {
  const float2* q = reinterpret_cast<const float2*>(lnp) + row * nb;
  float m = q[0].x, m2 = q[0].y, cnt = (float)min(BN, C);
  for (int i = 1; i < nb; ++i) {
    const float2 v = q[i];
    const float c = (float)min(BN, C - i * BN), tot = cnt + c;
    const float delta = v.x - m;
    m += delta * (c / tot);
    m2 += v.y + delta * delta * (cnt * c / tot);
    cnt = tot;
  }
  mean = m;
  rstd = rsqrtf(m2 / C + LN_EPS);
}

// LN2 and the residual, y = x + LN(FFN out), for the L valid rows of each
// batch element: one warp a row (blocks of 256 threads, B * L rows).
__device__ __forceinline__ void ln_residual(const float* __restrict__ raw, const float* __restrict__ lnp,
                                            const float* __restrict__ scale, const float* __restrict__ bias,
                                            const float* __restrict__ x, float* __restrict__ y, int B, int L,
                                            int tiles, int C, int nb) {
  const size_t out_row = (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (out_row >= (size_t)B * L) return;
  const int lane = threadIdx.x & 31;
  const size_t row = (out_row / L) * tiles * TM + out_row % L;  // in the padded rows
  float mean, rstd;
  row_stats(lnp, row, nb, C, mean, rstd);
  const float* src = raw + row * C;
  for (int k = 4 * lane; k < C; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(src + k);
    const float4 s = *reinterpret_cast<const float4*>(scale + k);
    const float4 bi = *reinterpret_cast<const float4*>(bias + k);
    const float4 xv = *reinterpret_cast<const float4*>(x + out_row * C + k);
    *reinterpret_cast<float4*>(y + out_row * C + k) =
        make_float4(xv.x + ((v.x - mean) * rstd * s.x + bi.x), xv.y + ((v.y - mean) * rstd * s.y + bi.y),
                    xv.z + ((v.z - mean) * rstd * s.z + bi.z), xv.w + ((v.w - mean) * rstd * s.w + bi.w));
  }
}

// ------------------------------------------------------------ host side
// T, an instance's traits:
//   KW          k columns of an image chunk (64 bf16, 32 f32)
//   SG          source chunks a stats block sums at most (even)
//   W_BYTES     bytes a product copies of a weight or V^T chunk (split TF32:
//               of one half)
//   W_STRIDE    bytes from one such chunk to the next (split TF32: both halves)
//   KV_BYTES, KV_STRIDE   the same of an attention B chunk with head sums
//                         (with replicated denominators: W_BYTES, W_STRIDE)
//   gemm<KIND>(Params, grid, stream), pack(src, img, rows, C, tiles, B,
//   stream), kv_reduce(part, kv, C, hd, G, B, stream), ln_image(raw, lnp,
//   scale, bias, img, n_rows, tiles, C, nb, stream), ln_residual(raw, lnp,
//   scale, bias, x, y, B, L, tiles, C, nb, stream): each launches its kernel
//   and returns cudaGetLastError().

inline bool takes(int C, int nhead) {
  return C % 32 == 0 && C >= 32 && C <= 4096 && nhead > 0 && C % nhead == 0;
}

// The scratch of one call, carved from one buffer (every piece 128-byte aligned).
template <class T>
struct Layout {
  // 64-channel tiles of padded(C), its k chunks, k chunks of the FFN hidden
  // (2C), 128-column blocks of C and of 2C, V^T's column blocks (every column
  // the K/V product computes past C lands in one), attention blocks, row
  // tiles, source chunks, value blocks a channel tile needs at most, source
  // chunks of a group, source groups, head width
  int CK, KC, KH, NB, NB2, NBV, NBA, LT, ST, SC, widest, SGC, G, hd;
  bool rep;  // replicated denominators
  size_t sa, kt, vt, part, kv, xa, qa, ma, hid, raw, lnp, total;
  Layout(int B, int L, int S, int C, int nhead, bool self) {
    CK = padded(C) / TM;
    KC = padded(C) / T::KW;
    KH = 2 * C / T::KW;
    NB = (C + BN - 1) / BN;
    NB2 = (2 * C + BN - 1) / BN;
    NBV = (NB2 * BN - C + BN - 1) / BN;
    LT = (L + TM - 1) / TM;
    ST = (S + TM - 1) / TM;
    SC = ST * (TM / T::KW);
    hd = C / nhead;
    widest = 0;
    for (int i = 0; i < CK; ++i) {
      int lo, hi;
      value_blocks(i, C, hd, lo, hi);
      widest = hi - lo + 1 > widest ? hi - lo + 1 : widest;
    }
    // groups of at most T::SG chunks, or, where those would give fewer than
    // half the SMs a stats block, smaller ones (an even count, as the
    // split-TF32 loop takes chunks in pairs) that give every SM one: a narrow
    // layer has few channel tiles, and its stats blocks are (value blocks,
    // channel tiles, batch x groups)
    const int blocks = widest * CK * B, want = (FILL + blocks - 1) / blocks;
    SGC = T::SG;
    if (2 * blocks * ((SC + SGC - 1) / SGC) < FILL) SGC = ((SC + want - 1) / want + 1) / 2 * 2;
    G = (SC + SGC - 1) / SGC;
    rep = replicated(hd);
    NBA = rep ? padded(C) / BR : NB;
    size_t at = 0;
    const auto take = [&](size_t bytes) {
      const size_t here = at;
      at += (bytes + 127) / 128 * 128;
      return here;
    };
    const size_t x_img = (size_t)B * LT * KC * CHUNK;
    xa = take(x_img);
    sa = self ? xa : take((size_t)B * ST * KC * CHUNK);
    kt = take((size_t)B * CK * SC * CHUNK);
    vt = take((size_t)B * NBV * SC * T::W_STRIDE);
    part = take((size_t)B * G * C * (hd + 1) * 4);
    kv = take((size_t)B * NBA * KC * (rep ? T::W_STRIDE : T::KV_STRIDE));
    qa = take(x_img);  // Q', then the LN1 output
    ma = take(x_img);
    hid = take((size_t)B * LT * KH * CHUNK);
    raw = take((size_t)B * LT * TM * C * 4);
    lnp = take((size_t)B * LT * TM * NB * 8);
    total = at;
  }
};

// Bytes of scratch a call needs (self: x and source are one tensor); 0 where the instance does not take C.
template <class T>
long long scratch_bytes(int B, int L, int S, int C, int nhead, bool self) {
  if (B <= 0 || L <= 0 || S <= 0 || !takes(C, nhead)) return 0;
  return (long long)Layout<T>(B, L, S, C, nhead, self && L == S).total;
}

#define OPP_TCW_CHECK(call)                \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// The layer: wkv holds [Wk; Wv] as [ceil(2C / 128) column blocks][padded(C) /
// KW k chunks], wapply Wq and Wmerge ([ceil(C / 128)][padded(C) / KW] each), W0
// ([ceil(2C / 128)][2 padded(C) / KW]: its input columns of x, then those of
// the LN1 output, each half padded) and W1 ([ceil(C / 128)][2C / KW]), chunks
// W_STRIDE bytes apart, input columns past C and output rows past N zero.
template <class T>
int launch(const float* x, const float* src, const void* wkv, const void* wapply, const float* ln1s,
           const float* ln1b, const float* ln2s, const float* ln2b, const float* qmask, const float* smask,
           void* scratch, float* y, int B, int L, int S, int C, int nhead, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || S <= 0 || !takes(C, nhead)) return (int)cudaErrorInvalidValue;
  const bool self = x == src && L == S;
  const Layout<T> lay(B, L, S, C, nhead, self);
  const int CK = lay.CK, KC = lay.KC, KH = lay.KH, NB = lay.NB, NB2 = lay.NB2, NBA = lay.NBA, widest = lay.widest;
  const int LT = lay.LT, ST = lay.ST, SC = lay.SC, G = lay.G, hd = lay.hd;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  unsigned char *sa = base + lay.sa, *kt = base + lay.kt, *vt = base + lay.vt, *kv = base + lay.kv;
  unsigned char *xa = base + lay.xa, *qa = base + lay.qa, *ma = base + lay.ma, *hid = base + lay.hid;
  float* part = reinterpret_cast<float*>(base + lay.part);
  float* raw = reinterpret_cast<float*>(base + lay.raw);
  float* lnp = reinterpret_cast<float*>(base + lay.lnp);
  const unsigned char* wq = static_cast<const unsigned char*>(wapply);
  const unsigned char* wm = wq + (size_t)NB * KC * T::W_STRIDE;
  const unsigned char* w0 = wm + (size_t)NB * KC * T::W_STRIDE;
  const unsigned char* w1 = w0 + (size_t)NB2 * 2 * KC * T::W_STRIDE;

  // source side: pack, K' and V (transposed), the stats, their reduction
  if (!self) OPP_TCW_CHECK(T::pack(src, sa, S, C, ST, B, stream));
  OPP_TCW_CHECK(T::pack(x, xa, L, C, LT, B, stream));
  Params p{};
  p.C = C;
  p.hd = hd;
  p.G = G;
  p.n_src_chunks = SC;
  p.nb = lay.NBV;  // V^T's column blocks
  p.a0 = sa;
  p.ka0 = p.ka = KC;
  p.a_tiles = ST;
  p.b = static_cast<const unsigned char*>(wkv);
  p.kb = KC;
  p.b_bytes = T::W_BYTES;
  p.n = 2 * C;
  p.rows = S;
  p.mask = smask;
  p.out0 = kt;
  p.out1 = vt;
  OPP_TCW_CHECK(T::template gemm<KV_PROJ>(p, dim3(NB2, ST, B), stream));

  Params s{};
  s.C = C;
  s.hd = hd;
  s.G = G;
  s.sg = lay.SGC;
  s.n_src_chunks = SC;
  s.nb = NB;
  s.a0 = kt;
  s.ka0 = s.ka = SC;
  s.a_tiles = CK;
  s.b = vt;
  s.b_batch = (long long)lay.NBV * SC * T::W_STRIDE;
  s.kb = SC;
  s.b_bytes = T::W_BYTES;
  s.outf = part;
  OPP_TCW_CHECK(T::template gemm<STATS>(s, dim3(widest, CK, B * G), stream));
  OPP_TCW_CHECK(T::kv_reduce(part, kv, C, hd, G, B, stream));

  // x side: Q', attention, merge, LN1, FFN, LN2 + residual
  Params a{};
  a.C = C;
  a.hd = hd;
  a.nb = NB;
  a.rows = L;
  a.tiles = LT;
  a.a_tiles = LT;
  a.out_k = KC;

  a.a0 = xa;
  a.ka0 = a.ka = KC;
  a.b = wq;
  a.kb = KC;
  a.b_bytes = T::W_BYTES;
  a.n = C;
  a.mask = qmask;
  a.out0 = qa;
  OPP_TCW_CHECK(T::template gemm<QPROJ>(a, dim3(NB, LT, B), stream));

  a.a0 = qa;
  a.b = kv;
  a.mask = nullptr;
  a.out0 = ma;
  if (lay.rep) {
    a.b_batch = (long long)NBA * KC * T::W_STRIDE;
    a.b_bytes = T::W_BYTES;
    OPP_TCW_CHECK(T::template gemm<ATT_REP>(a, dim3(NBA, LT, B), stream));
  } else {
    a.b_batch = (long long)NBA * KC * T::KV_STRIDE;
    a.b_bytes = T::KV_BYTES;
    OPP_TCW_CHECK(T::template gemm<ATT>(a, dim3(NBA, LT, B), stream));
  }

  a.a0 = ma;
  a.b = wm;
  a.b_batch = 0;
  a.b_bytes = T::W_BYTES;
  a.outf = raw;
  a.lnp = lnp;
  OPP_TCW_CHECK(T::template gemm<RAW>(a, dim3(NB, LT, B), stream));
  const int n_rows = B * LT * TM;
  OPP_TCW_CHECK(T::ln_image(raw, lnp, ln1s, ln1b, qa, n_rows, LT, C, NB, stream));

  a.a0 = xa;
  a.a1 = qa;  // the LN1 output
  a.ka0 = KC;
  a.ka = 2 * KC;
  a.b = w0;
  a.kb = 2 * KC;
  a.n = 2 * C;
  a.out0 = hid;
  a.out_k = KH;
  OPP_TCW_CHECK(T::template gemm<RELU>(a, dim3(NB2, LT, B), stream));

  a.a0 = hid;
  a.a1 = nullptr;
  a.ka0 = a.ka = KH;
  a.kb = KH;
  a.b = w1;
  a.n = C;
  a.outf = raw;
  a.lnp = lnp;
  OPP_TCW_CHECK(T::template gemm<RAW>(a, dim3(NB, LT, B), stream));
  OPP_TCW_CHECK(T::ln_residual(raw, lnp, ln2s, ln2b, x, y, B, L, LT, C, NB, stream));
  return 0;
}

#undef OPP_TCW_CHECK

}  // namespace tcw_plan
}  // namespace opp
