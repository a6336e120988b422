// K1's bf16 instance on the tensor cores at the widths the 256-channel one
// (encoder.cu, namespace tc) does not take: C a multiple of 32 from 32 to
// 4096 with any head count that divides it, all but (256, 8).
//
// Replaces onepose_plus_plus_tpu/ops/pallas_encoder.py::fused_encoder_layer
// (_kv_stats_kernel + _apply_kernel) at those widths, with its precision rule:
// every product operand (x, source, K', V, Q', K'^T[V|1], msg, the LN1 output,
// the FFN hidden, the weights) is rounded to bf16, products sum in f32, the
// LayerNorms and the residual stay f32 and the output is f32.
//
// Bound: operations (20 C^2 an x row, 4 C^2 a source row, and the attention's
// 2 C (hd + 1) each). The 256-channel instance keeps a row tile's whole width
// in shared memory; a [64, C] f32 tile is 1 MB at C = 4096, so this one
// streams channels instead. The layer is a chain of products, each of the
// same shape: a block of one warpgroup computes a [64 rows, 128 columns]
// (or 136, 144) output tile from 64-row A chunks and B chunks that arrive by bulk
// copies through a ring (wgmma_gemm.cuh), every weight read once per 64 rows.
// Operands live in device memory as bf16 byte images of the chunks a product
// reads ("images": [batch][row tile][k chunk][64 x 64] in the core-matrix
// layout), written by the previous product's epilogue, so every A chunk and
// every B chunk is one contiguous copy. The weights are packed once per layer
// on the host side ([column block][k chunk][128 out x 64 in], out rows past N
// zero; input columns past C zero, tcw_plan.cuh). The launches, in order:
//   1. pack: the f32 source rows, rounded to bf16, as an image (rows past S and
//      channels past C zero).
//   2. K and V: one product against [Wk; Wv] (N = 2C); its epilogue applies
//      elu + 1 and the source mask to K' and writes K' and V transposed
//      (channel-major images, the source rows as k), so that K'^T V is a
//      K-major product too.
//   3. stats: a block per (64 channels d, 128 value columns e of d's heads,
//      a group of up to 16 source chunks) sums K'^T [V | 1] over its group:
//      B is V^T's chunk plus 8 more rows, one of them ones, which the
//      prologue writes into every stage once (the copies leave them alone),
//      so column 128 is sum K'. It writes the group's partials of each head's
//      K'_h^T V_h and sum K'_h ([C, hd + 1] a group).
//   4. reduce: sums the groups' partials in group order and writes, per
//      128-column block of the attention output, the B image
//      [KV_h^T (block-diagonal) ; sum K'_h of the block's heads (16 rows)],
//      bf16, only the k chunks of the block's heads; at head widths that are
//      not a multiple of 8, per 64-column block [KV_h^T ; the replicated
//      sums] (tcw_plan.cuh).
//   5. pack x; 6. Q' = (elu(x Wq) + 1) * mask, an image.
//   7. attention: [num | den] = Q' [KV | sum K'] (N = 144, or 128 over 64
//      columns), only over the block's heads' channels; the epilogue takes
//      each column's denominator from its head's column (a quad shuffle; with
//      replicated denominators the thread's own column 64 + c) and writes
//      msg, an image.
//   8. merge: msg Wmerge in f32 to device memory, with each row's
//      (mean, M2) over the block's columns.
//   9. LN1: the partials merged in column-block order (Chan's formula), the
//      rows normalised and written as an image.
//  10. FFN hidden: relu([x | LN1] W0) (A from two images), an image.
//  11. FFN out: hidden W1 in f32 with its row partials, as in 8.
//  12. LN2 and the residual on the f32 x: y.
// No atomics; every sum runs in a fixed order, so two launches are bitwise
// equal. Every launch is checked with cudaGetLastError. The plan, the launch
// sequence, the scratch layout and the epilogues that do not depend on the
// operand type are tcw_plan.cuh's, shared with the split-TF32 chain
// (encoder_tcw_tf32.cu); this file holds the bf16 kernels and their traits.
#include "common.cuh"
#include "wgmma.cuh"
#include "tcw_plan.cuh"
#include "wgmma_gemm.cuh"

namespace {
namespace tcw {

namespace wg = opp::wg;
namespace gm = opp::gemm;
using opp::MAX_DEVICES;
using opp::raise_smem_limit;
using gm::in_chunk;
using namespace opp::tcw_plan;

constexpr int KW = 64;                    // k columns of a chunk
constexpr int NTS = BN + 8;               // the stats' B: V^T and the ones row
constexpr int NTA = BN + SUMS;            // the attention's B: KV^T and 16 rows of sum K'
constexpr int NST = 4;                    // ring stages: two blocks an SM
constexpr int SG = 16;                    // source chunks a stats block sums, at most
constexpr uint32_t W_CHUNK = BN * 128;    // 16384: a weight chunk [128, 64], a V^T chunk
constexpr uint32_t KV_CHUNK = NTA * 128;  // 18432: an attention B chunk [144, 64]

template <int KIND>
__host__ __device__ constexpr int n_cols() {
  return KIND == STATS ? NTS : KIND == ATT ? NTA : BN;
}

__device__ __forceinline__ void store_bf16x2(unsigned char* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

template <int KIND>
__global__ void __launch_bounds__(128, 2) tcw_gemm_kernel(Params p) {
  constexpr int NT = n_cols<KIND>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r_loc[2] = {16 * w + g, 16 * w + g + 8};

  int nb = blockIdx.x, rt = blockIdx.y, b = blockIdx.z, k0 = 0, k1 = p.ka, vb_lo = 0, grp = 0;
  if constexpr (KIND == STATS) {  // rt: a 64-channel tile of K'^T; nb: a 128-column block of V^T
    int vb_hi;
    value_blocks(rt, p.C, p.hd, vb_lo, vb_hi);
    nb = vb_lo + blockIdx.x;
    if (nb > vb_hi) return;
    b = blockIdx.z / p.G;
    grp = blockIdx.z % p.G;
    k0 = grp * p.sg;
    k1 = min(p.n_src_chunks, k0 + p.sg);
  } else if constexpr (KIND == ATT || KIND == ATT_REP) {
    int h_first, h_last;
    head_chunks(nb, KIND == ATT ? BN : BR, p.C, p.hd, KW, h_first, h_last, k0, k1);
  }
  const size_t tile = (size_t)b * p.a_tiles + rt;
  const auto a_of = [&](int u) -> const void* {
    const int kc = k0 + u;
    return kc < p.ka0 ? p.a0 + (tile * p.ka0 + kc) * CHUNK
                      : p.a1 + (tile * (p.ka - p.ka0) + (kc - p.ka0)) * CHUNK;
  };
  const auto b_of = [&](int u) -> const void* {
    return p.b + b * p.b_batch + ((size_t)nb * p.kb + k0 + u) * p.b_bytes;
  };
  const auto prologue = [&](unsigned char* s) {
    if constexpr (KIND == STATS) {
      // rows 128..135 of every stage's B: row 128 ones, the rest zeros
      using S = gm::Smem<NT, NST>;
      for (int i = tid; i < NST * 256; i += blockDim.x) {
        const int st = i / 256, byte = (i % 256) * 4;
        const uint32_t v = (byte % 128) < 16 ? 0x3F803F80u : 0u;
        *reinterpret_cast<uint32_t*>(s + st * S::STAGE + CHUNK + W_CHUNK + byte) = v;
      }
    }
  };

  const auto epilogue = [&](float(&acc)[NT / 2]) {
    if constexpr (KIND == KV_PROJ) {
      // K' (columns < C) and V (the rest), written transposed: element (channel c,
      // source row s) of K'^T at [b][c / 64][s / 64] chunk of 8 KB, of V^T at
      // [b][c / 128][s / 64] chunk of 16 KB (V^T's rows past C zero: p.nb is
      // V^T's column blocks). Lanes g and g ^ 1 hold rows s and s ^ 1: they
      // swap one value of each column pair, so that a thread stores two rows of
      // one column as one word, a warp one 128-byte core matrix.
      float m[2];
      row_mask(p, b, rt, r_loc, m);
      const bool odd = g & 1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = nb * BN + 8 * j + 2 * t;
        const bool is_k = nb * BN + 8 * j < p.C;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (is_k) {
            v0 = elu_p1_fast(v0) * m[h];
            v1 = elu_p1_fast(v1) * m[h];
          }
          const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
          const int c = (is_k ? n : n - p.C) + (odd ? 1 : 0);
          const int s = (rt * TM + r_loc[h]) & ~1;
          const float lo = odd ? got : v0, hi = odd ? v1 : got;
          unsigned char* dst =
              is_k ? p.out0 + (((size_t)b * (padded(p.C) / TM) + c / TM) * p.n_src_chunks + s / TM) * CHUNK +
                         in_chunk(c % TM, s % TM)
                   : p.out1 + (((size_t)b * p.nb + c / BN) * p.n_src_chunks + s / TM) * W_CHUNK +
                         in_chunk(c % BN, s % TM);
          store_bf16x2(dst, lo, hi);
        }
      }
    } else if constexpr (KIND == STATS) {
      store_stats<NT>(p, acc, b, grp, rt, nb, vb_lo, r_loc, t);
    } else if constexpr (KIND == ATT) {
      // msg = num / (den + 1e-6): column 128 + i holds the denominator of the
      // block's i-th head (i < 16), in register group 16 + i / 8 of the quad's
      // thread (i % 8) / 2, register i % 2; msg's channels past C are zeros
      int h_first, h_last, kl, kh;
      head_chunks(nb, BN, p.C, p.hd, KW, h_first, h_last, kl, kh);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = nb * BN + 8 * j;
        if (n >= p.out_k * KW) continue;
        float inv0 = 0.f, inv1 = 0.f;
        if (n < p.C) {
          const int i = n / p.hd - h_first;  // the same in every lane
          const int src = (lane & ~3) | ((i & 7) >> 1);
          const bool odd = i & 1, high = i & 8;
          const float r0 = high ? (odd ? acc[69] : acc[68]) : (odd ? acc[65] : acc[64]);
          const float r1 = high ? (odd ? acc[71] : acc[70]) : (odd ? acc[67] : acc[66]);
          inv0 = 1.f / (__shfl_sync(0xffffffffu, r0, src) + EPS);
          inv1 = 1.f / (__shfl_sync(0xffffffffu, r1, src) + EPS);
        }
        const int c = n + 2 * t;
        unsigned char* chunk = p.out0 + (((size_t)b * p.tiles + rt) * p.out_k + c / TM) * CHUNK;
        store_bf16x2(chunk + in_chunk(r_loc[0], c % TM), acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        store_bf16x2(chunk + in_chunk(r_loc[1], c % TM), acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    } else if constexpr (KIND == ATT_REP) {
      // msg = num / (den + 1e-6) over a 64-column block: column 64 + c holds
      // column c's denominator, in the same thread (register 32 further)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nb * BR + 8 * j;
        if (n >= p.out_k * KW) continue;
        const bool live = n < p.C;
        const int c = n + 2 * t;
        unsigned char* chunk = p.out0 + (((size_t)b * p.tiles + rt) * p.out_k + c / TM) * CHUNK;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 4 * j + 2 * h;
          const float v0 = live ? acc[r] * (1.f / (acc[32 + r] + EPS)) : 0.f;
          const float v1 = live ? acc[r + 1] * (1.f / (acc[33 + r] + EPS)) : 0.f;
          store_bf16x2(chunk + in_chunk(r_loc[h], c % TM), v0, v1);
        }
      }
    } else if constexpr (KIND == QPROJ || KIND == RELU) {
      float m[2] = {1.f, 1.f};
      if constexpr (KIND == QPROJ) row_mask(p, b, rt, r_loc, m);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = nb * BN + 8 * j + 2 * t;
        if (nb * BN + 8 * j >= p.out_k * KW) continue;
        const float live = nb * BN + 8 * j < p.n ? 1.f : 0.f;  // the image's channels past N are zeros
        unsigned char* chunk = p.out0 + (((size_t)b * p.tiles + rt) * p.out_k + c / TM) * CHUNK;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if constexpr (KIND == QPROJ) {
            v0 = elu_p1_fast(v0) * (m[h] * live);
            v1 = elu_p1_fast(v1) * (m[h] * live);
          } else {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          store_bf16x2(chunk + in_chunk(r_loc[h], c % TM), v0, v1);
        }
      }
    } else {  // RAW
      store_raw(p, acc, b, rt, nb, r_loc, t);
    }
  };
  gm::run<NT, NST>(smem, k1 - k0, a_of, b_of, p.b_bytes, prologue, epilogue);
}

// f32 rows [B, rows, C] -> a bf16 image [B, tiles, padded(C) / 64, 64 x 64], rows past `rows`
// and channels past C zero. Block (k chunk, row tile, batch); a thread writes 16 bytes (a
// core-matrix row) at a time.
__global__ void tcw_pack_kernel(const float* __restrict__ src, unsigned char* __restrict__ img,
                                int rows, int C, int tiles) {
  const int kc = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  unsigned char* out = img + (((size_t)b * tiles + rt) * gridDim.x + kc) * CHUNK;
  for (int q = threadIdx.x; q < 512; q += blockDim.x) {  // q = (row / 8) * 64 + (k / 8) * 8 + row % 8
    const int row = rt * TM + (q >> 6) * 8 + (q & 7), k = kc * 64 + ((q >> 3) & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && k < C) {
      const float4* s = reinterpret_cast<const float4*>(src + ((size_t)b * rows + row) * C + k);
      const float4 x0 = s[0], x1 = s[1];
      __nv_bfloat162 h[4] = {__floats2bfloat162_rn(x0.x, x0.y), __floats2bfloat162_rn(x0.z, x0.w),
                             __floats2bfloat162_rn(x1.x, x1.y), __floats2bfloat162_rn(x1.z, x1.w)};
      v = *reinterpret_cast<const uint4*>(h);
    }
    *reinterpret_cast<uint4*>(out + q * 16) = v;
  }
}

// The attention's B image: block (k chunk, column block, batch) writes chunk
// [144, 64] of column block nb: rows 0..127 KV^T (value column e, channel d:
// the groups' partials summed in group order where e and d share a head, else
// 0), rows 128.. sum K' of the block's heads; only the chunks of its heads.
// With replicated denominators (REP), chunk [128, 64] of 64-column block nb:
// rows 0..63 KV^T, row 64 + c sum K' on the channels of column c's head.
// Channels past C are zeros.
template <bool REP>
__global__ void tcw_kv_reduce_kernel(const float* __restrict__ part, unsigned char* __restrict__ kvimg,
                                     int C, int hd, int G) {
  constexpr int BW = REP ? BR : BN, NR = REP ? BN : NTA;  // output columns of a block, rows of a chunk
  const int kc = blockIdx.x, nb = blockIdx.y, b = blockIdx.z;
  int h_first, h_last, k_lo, k_hi;
  head_chunks(nb, BW, C, hd, KW, h_first, h_last, k_lo, k_hi);
  if (kc < k_lo || kc >= k_hi) return;
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(
      kvimg + (((size_t)b * gridDim.y + nb) * gridDim.x + kc) * NR * 128);
  const size_t group = (size_t)C * (hd + 1);
  for (int q = threadIdx.x; q < NR * 64; q += blockDim.x) {  // q: the element at byte 2 q
    const int n = (q >> 9) * 8 + ((q >> 3) & 7), d = kc * 64 + ((q >> 6) & 7) * 8 + (q & 7);
    const int head = d / hd;
    int col = -1;
    if (n < BW) {
      const int e = nb * BW + n;
      if (e < C && e / hd == head) col = e - head * hd;
    } else if (REP) {
      const int e = nb * BW + n - BW;
      if (e < C && e / hd == head) col = hd;
    } else if (h_first + n - BW <= h_last && h_first + n - BW == head) {
      col = hd;
    }
    float a = 0.f;
    if (col >= 0)
      for (int gi = 0; gi < G; ++gi) a += part[((size_t)b * G + gi) * group + (size_t)d * (hd + 1) + col];
    out[q] = __float2bfloat16_rn(a);
  }
}

// LN1: every row of the f32 merge output (padded rows too) normalised and
// written as a bf16 image, its channels past C zeros. One warp a row; a lane
// writes 8 values at a time.
__global__ void tcw_ln_image_kernel(const float* __restrict__ raw, const float* __restrict__ lnp,
                                    const float* __restrict__ scale, const float* __restrict__ bias,
                                    unsigned char* __restrict__ img, int n_rows, int tiles, int C, int nb) {
  const size_t row = (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= (size_t)n_rows) return;
  const int lane = threadIdx.x & 31;
  float mean, rstd;
  row_stats(lnp, row, nb, C, mean, rstd);
  const size_t b = row / (tiles * TM);
  const int r = row % (tiles * TM);
  const float* src = raw + row * C;
  const int cp = padded(C);
  for (int k = 8 * lane; k < cp; k += 256) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < C) {
      const float4 x0 = *reinterpret_cast<const float4*>(src + k), x1 = *reinterpret_cast<const float4*>(src + k + 4);
      const float4 s0 = *reinterpret_cast<const float4*>(scale + k), s1 = *reinterpret_cast<const float4*>(scale + k + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bias + k), b1 = *reinterpret_cast<const float4*>(bias + k + 4);
      __nv_bfloat162 h[4] = {
          __floats2bfloat162_rn((x0.x - mean) * rstd * s0.x + b0.x, (x0.y - mean) * rstd * s0.y + b0.y),
          __floats2bfloat162_rn((x0.z - mean) * rstd * s0.z + b0.z, (x0.w - mean) * rstd * s0.w + b0.w),
          __floats2bfloat162_rn((x1.x - mean) * rstd * s1.x + b1.x, (x1.y - mean) * rstd * s1.y + b1.y),
          __floats2bfloat162_rn((x1.z - mean) * rstd * s1.z + b1.z, (x1.w - mean) * rstd * s1.w + b1.w)};
      v = *reinterpret_cast<const uint4*>(h);
    }
    unsigned char* chunk = img + ((b * tiles + r / TM) * (cp / 64) + k / 64) * CHUNK;
    *reinterpret_cast<uint4*>(chunk + in_chunk(r % TM, k % 64)) = v;
  }
}

// LN2 and the residual: y = x + LN(FFN out) for the L valid rows of each batch element.
__global__ void tcw_ln_residual_kernel(const float* __restrict__ raw, const float* __restrict__ lnp,
                                       const float* __restrict__ scale, const float* __restrict__ bias,
                                       const float* __restrict__ x, float* __restrict__ y, int B, int L,
                                       int tiles, int C, int nb) {
  ln_residual(raw, lnp, scale, bias, x, y, B, L, tiles, C, nb);
}

// The chain's traits (tcw_plan.cuh): bf16 images of [64, 64] chunks.
struct Chain {
  static constexpr int KW = tcw::KW, SG = tcw::SG;
  static constexpr uint32_t W_BYTES = W_CHUNK, W_STRIDE = W_CHUNK, KV_BYTES = KV_CHUNK, KV_STRIDE = KV_CHUNK;

  template <int KIND>
  static cudaError_t gemm(const Params& p, dim3 grid, cudaStream_t stream) {
    constexpr size_t smem = gm::Smem<n_cols<KIND>(), NST>::BYTES;
    static int have[MAX_DEVICES];
    raise_smem_limit(tcw_gemm_kernel<KIND>, smem, have);
    tcw_gemm_kernel<KIND><<<grid, 128, smem, stream>>>(p);
    return cudaGetLastError();
  }
  static cudaError_t pack(const float* src, unsigned char* img, int rows, int C, int tiles, int B,
                          cudaStream_t stream) {
    tcw_pack_kernel<<<dim3(padded(C) / KW, tiles, B), 256, 0, stream>>>(src, img, rows, C, tiles);
    return cudaGetLastError();
  }
  static cudaError_t kv_reduce(const float* part, unsigned char* kv, int C, int hd, int G, int B,
                               cudaStream_t stream) {
    const dim3 grid(padded(C) / KW, replicated(hd) ? padded(C) / BR : (C + BN - 1) / BN, B);
    if (replicated(hd))
      tcw_kv_reduce_kernel<true><<<grid, 256, 0, stream>>>(part, kv, C, hd, G);
    else
      tcw_kv_reduce_kernel<false><<<grid, 256, 0, stream>>>(part, kv, C, hd, G);
    return cudaGetLastError();
  }
  static cudaError_t ln_image(const float* raw, const float* lnp, const float* scale, const float* bias,
                              unsigned char* img, int n_rows, int tiles, int C, int nb, cudaStream_t stream) {
    tcw_ln_image_kernel<<<(n_rows + 7) / 8, 256, 0, stream>>>(raw, lnp, scale, bias, img, n_rows, tiles, C, nb);
    return cudaGetLastError();
  }
  static cudaError_t ln_residual(const float* raw, const float* lnp, const float* scale, const float* bias,
                                 const float* x, float* y, int B, int L, int tiles, int C, int nb,
                                 cudaStream_t stream) {
    tcw_ln_residual_kernel<<<(B * L + 7) / 8, 256, 0, stream>>>(raw, lnp, scale, bias, x, y, B, L, tiles, C, nb);
    return cudaGetLastError();
  }
};

}  // namespace tcw
}  // namespace

// bf16 operands on the tensor cores at the other widths (C a multiple of 32
// from 32 to 4096, any head count dividing it). With Cp = C padded to a
// multiple of 64: wkv: [Wk; Wv] as [ceil(2C / 128) column blocks][Cp / 64 k
// chunks] of [128 out, 64 in] bf16 chunks; wapply: Wq and Wmerge
// ([ceil(C / 128)][Cp / 64] chunks each), W0 ([ceil(2C / 128)][2 Cp / 64], its
// x and LN1 input halves each padded to Cp), W1 ([ceil(C / 128)][2 C / 64]);
// output rows past N and input columns past C zero. scratch:
// opp_encoder_tcw_scratch_bytes bytes, 128-byte aligned.
extern "C" int opp_encoder_layer_tcw(const float* x, const float* src, const void* wkv,
                                     const void* wapply, const float* ln1s, const float* ln1b,
                                     const float* ln2s, const float* ln2b, const float* qmask,
                                     const float* smask, void* scratch, float* y, int B, int L, int S,
                                     int C, int nhead, void* stream) {
  return opp::tcw_plan::launch<tcw::Chain>(x, src, wkv, wapply, ln1s, ln1b, ln2s, ln2b, qmask, smask, scratch, y,
                                           B, L, S, C, nhead, static_cast<cudaStream_t>(stream));
}

// Bytes of scratch a call needs (self: x and source are one tensor); 0 where no instance takes C.
extern "C" long long opp_encoder_tcw_scratch_bytes(int B, int L, int S, int C, int nhead, int self) {
  return opp::tcw_plan::scratch_bytes<tcw::Chain>(B, L, S, C, nhead, self != 0);
}
