// K1's f32 instance on the tensor cores, in split TF32, at the widths the
// 256-channel one (encoder.cu, namespace tf) does not take: C a multiple of 32
// from 32 to 4096 with any head count that divides it, all but (256, 8).
//
// Replaces onepose_plus_plus_tpu/ops/pallas_encoder.py::fused_encoder_layer
// (_kv_stats_kernel + _apply_kernel) at those widths, with the f32 rule of the
// 256-channel split-TF32 instance: every product runs as three TF32 products
// of hi / lo halves (hi hi + hi lo + lo hi, wg::tf32_split, ~2^-22 relative),
// sums in f32, the LayerNorms and the residual f32 on the f32 x, the output
// f32.
//
// Bound: operations (20 C^2 an x row, 4 C^2 a source row, the attention's
// 2 C (hd + 1) each), three TF32 products each. The design is the bf16 chain's
// (encoder_tcw.cu: 64-row tiles, [64, 128], [64, 136] or [64, 144] output
// blocks, every operand an image of the chunks a product copies, C padded to
// 64 channels in every image, the launches in the same order, the same
// epilogues), computed by wgmma_gemm.cuh's run_tf32: A chunks
// are [64 rows, 32 k] f32 images (8 KB), split in registers; B chunks are
// [N rows, 32 k] f32 images in two halves, TF32 hi then lo, which their
// producers write: the weights' pack (once a layer, on the host side), the
// K/V epilogue (V^T) and the reduce (the attention's B). A stage of the ring
// is 40-45 KB: two stages a block, two blocks an SM. Where the
// bf16 chain differs:
//   - the stats' ones row is hi = 1, lo = 0;
//   - a product's chunk count must be even (two register sets of A
//     fragments): the attention's k range over Q' is widened by one chunk
//     where it is odd, a chunk the reduce writes with zeros; every other
//     count is even by construction (images padded to 64 channels, the FFN
//     hidden's 2C a multiple of 64, source chunks in pairs).
// No atomics; every sum runs in a fixed order, so two launches are bitwise
// equal. Every launch is checked with cudaGetLastError. The launch sequence,
// the scratch layout and the shared epilogues are tcw_plan.cuh's; this file
// holds the split-TF32 kernels and their traits.
#include "common.cuh"
#include "tcw_plan.cuh"
#include "wgmma.cuh"
#include "wgmma_gemm.cuh"

namespace {
namespace tcw32 {

namespace wg = opp::wg;
namespace gm = opp::gemm;
using namespace opp::tcw_plan;
using gm::in_chunk32;
using opp::MAX_DEVICES;
using opp::raise_smem_limit;

constexpr int KW = 32;                     // k columns of a chunk
constexpr int NTS = BN + 8;                // the stats' B: V^T and the ones row
constexpr int NTA = BN + SUMS;             // the attention's B: KV^T and 16 rows of sum K'
constexpr int NST = 2;                     // ring stages: two blocks an SM (2-5 measured alike, 2 best at C = 2048)
constexpr int SG = 32;                     // source chunks a stats block sums, at most (1024 rows)
constexpr uint32_t W_HALF = BN * 128;      // 16384: one half of a weight chunk [128, 32], of a V^T chunk
constexpr uint32_t KV_HALF = NTA * 128;    // 18432: one half of an attention B chunk [144, 32]

template <int KIND>
__host__ __device__ constexpr int n_cols() {
  return KIND == STATS ? NTS : KIND == ATT ? NTA : BN;
}

// The heads of attention block nb (bw columns wide) and its k chunks of Q', an
// even count: one more chunk where the heads' channels span an odd number
// (padded(C) / 32 is even, so it fits on one side).
__host__ __device__ __forceinline__ void head_chunks32(int nb, int bw, int C, int hd, int& h_first, int& h_last,
                                                       int& k_lo, int& k_hi) {
  head_chunks(nb, bw, C, hd, KW, h_first, h_last, k_lo, k_hi);
  if ((k_hi - k_lo) & 1) {
    if (k_hi < padded(C) / KW)
      ++k_hi;
    else
      --k_lo;
  }
}

__device__ __forceinline__ void store_split(unsigned char* hi, uint32_t lo_offset, float v) {
  uint32_t h, l;
  wg::tf32_split(v, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(hi + lo_offset) = l;
}

template <int KIND>
__global__ void __launch_bounds__(128, 2) tcw32_gemm_kernel(Params p) {
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
    head_chunks32(nb, KIND == ATT ? BN : BR, p.C, p.hd, h_first, h_last, k0, k1);
  }
  const size_t tile = (size_t)b * p.a_tiles + rt;
  const auto a_of = [&](int u) -> const void* {
    const int kc = k0 + u;
    return kc < p.ka0 ? p.a0 + (tile * p.ka0 + kc) * CHUNK
                      : p.a1 + (tile * (p.ka - p.ka0) + (kc - p.ka0)) * CHUNK;
  };
  const auto b_of = [&](int u) -> const void* {
    return p.b + b * p.b_batch + ((size_t)nb * p.kb + k0 + u) * 2 * p.b_bytes;
  };
  const auto prologue = [&](unsigned char* s) {
    if constexpr (KIND == STATS) {
      // rows 128..135 of every stage's B halves: hi row 128 ones, the rest zeros
      using S = gm::Smem32<NT, NST>;
      for (int i = tid; i < NST * 512; i += blockDim.x) {
        const int st = i / 512, half = (i / 256) & 1, byte = (i % 256) * 4;
        const uint32_t v = half == 0 && (byte % 128) < 16 ? 0x3F800000u : 0u;
        *reinterpret_cast<uint32_t*>(s + st * S::STAGE + gm::A_CHUNK + half * S::B_HALF + W_HALF + byte) = v;
      }
    }
  };

  const auto epilogue = [&](float(&acc)[NT / 2]) {
    if constexpr (KIND == KV_PROJ) {
      // K' (columns < C) and V (the rest), written transposed: element (channel c,
      // source row s) of K'^T at [b][c / 64][s / 32] chunk of 8 KB; of V^T, split,
      // at [b][c / 128][s / 32] chunk of 2 x 16 KB (hi, then lo; its rows past C
      // zero: p.nb is V^T's column blocks)
      float m[2];
      row_mask(p, b, rt, r_loc, m);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const bool is_k = nb * BN + 8 * j < p.C;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = rt * TM + r_loc[h];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nb * BN + 8 * j + 2 * t + e;
            const float v = acc[4 * j + 2 * h + e];
            if (is_k) {
              *reinterpret_cast<float*>(p.out0 + (((size_t)b * (padded(p.C) / TM) + n / TM) * p.n_src_chunks + s / KW) * CHUNK +
                                        in_chunk32(n % TM, s % KW)) = elu_p1_fast(v) * m[h];
            } else {
              const int c = n - p.C;
              store_split(p.out1 + (((size_t)b * p.nb + c / BN) * p.n_src_chunks + s / KW) * 2 * W_HALF +
                              in_chunk32(c % BN, s % KW),
                          W_HALF, v);
            }
          }
        }
      }
    } else if constexpr (KIND == STATS) {
      store_stats<NT>(p, acc, b, grp, rt, nb, vb_lo, r_loc, t);
    } else if constexpr (KIND == ATT) {
      // msg = num / (den + 1e-6): column 128 + i holds the denominator of the
      // block's i-th head (i < 16), in register group 16 + i / 8 of the quad's
      // thread (i % 8) / 2, register i % 2; msg's channels past C are zeros
      int h_first, h_last, kl, kh;
      head_chunks32(nb, BN, p.C, p.hd, h_first, h_last, kl, kh);
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
        unsigned char* chunk = p.out0 + (((size_t)b * p.tiles + rt) * p.out_k + c / KW) * CHUNK;
        *reinterpret_cast<float2*>(chunk + in_chunk32(r_loc[0], c % KW)) =
            make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        *reinterpret_cast<float2*>(chunk + in_chunk32(r_loc[1], c % KW)) =
            make_float2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
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
        unsigned char* chunk = p.out0 + (((size_t)b * p.tiles + rt) * p.out_k + c / KW) * CHUNK;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 4 * j + 2 * h;
          *reinterpret_cast<float2*>(chunk + in_chunk32(r_loc[h], c % KW)) =
              live ? make_float2(acc[r] * (1.f / (acc[32 + r] + EPS)), acc[r + 1] * (1.f / (acc[33 + r] + EPS)))
                   : make_float2(0.f, 0.f);
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
        unsigned char* chunk = p.out0 + (((size_t)b * p.tiles + rt) * p.out_k + c / KW) * CHUNK;
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
          *reinterpret_cast<float2*>(chunk + in_chunk32(r_loc[h], c % KW)) = make_float2(v0, v1);
        }
      }
    } else {  // RAW
      store_raw(p, acc, b, rt, nb, r_loc, t);
    }
  };
  gm::run_tf32<NT, NST>(smem, k1 - k0, a_of, b_of, p.b_bytes, prologue, epilogue);
}

// f32 rows [B, rows, C] -> an f32 image [B, tiles, padded(C) / 32, 64 x 32], rows past `rows`
// and channels past C zero. Block (k chunk, row tile, batch); a thread writes 16 bytes (a
// core-matrix row) at a time.
__global__ void tcw32_pack_kernel(const float* __restrict__ src, unsigned char* __restrict__ img, int rows,
                                  int C, int tiles) {
  const int kc = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  unsigned char* out = img + (((size_t)b * tiles + rt) * gridDim.x + kc) * CHUNK;
  for (int q = threadIdx.x; q < 512; q += blockDim.x) {  // q = (row / 8) * 64 + (k / 4) * 8 + row % 8
    const int row = rt * TM + (q >> 6) * 8 + (q & 7), k = kc * KW + ((q >> 3) & 7) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows && k < C) v = *reinterpret_cast<const float4*>(src + ((size_t)b * rows + row) * C + k);
    *reinterpret_cast<float4*>(out + q * 16) = v;
  }
}

// The attention's B image: block (k chunk, column block, batch) writes chunk
// [144, 32] of column block nb, hi then lo: rows 0..127 KV^T (value column e,
// channel d: the groups' partials summed in group order where e and d share a
// head, else 0), rows 128.. sum K' of the block's heads; only the chunks of
// its heads (head_chunks32's range, zeros where the range was widened). With
// replicated denominators (REP), chunk [128, 32] of 64-column block nb: rows
// 0..63 KV^T, row 64 + c sum K' on the channels of column c's head. Channels
// past C are zeros.
template <bool REP>
__global__ void tcw32_kv_reduce_kernel(const float* __restrict__ part, unsigned char* __restrict__ kvimg, int C,
                                       int hd, int G) {
  constexpr int BW = REP ? BR : BN, NR = REP ? BN : NTA;  // output columns of a block, rows of a chunk
  const int kc = blockIdx.x, nb = blockIdx.y, b = blockIdx.z;
  int h_first, h_last, k_lo, k_hi;
  head_chunks32(nb, BW, C, hd, h_first, h_last, k_lo, k_hi);
  if (kc < k_lo || kc >= k_hi) return;
  uint32_t* out = reinterpret_cast<uint32_t*>(kvimg + (((size_t)b * gridDim.y + nb) * gridDim.x + kc) * NR * 256);
  const size_t group = (size_t)C * (hd + 1);
  for (int q = threadIdx.x; q < NR * KW; q += blockDim.x) {  // q: the value at byte 4 q of a half
    const int n = (q >> 8) * 8 + ((q >> 2) & 7), d = kc * KW + ((q >> 5) & 7) * 4 + (q & 3);
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
    wg::tf32_split(a, out[q], out[q + NR * KW]);
  }
}

// LN1: every row of the f32 merge output (padded rows too) normalised and
// written as an f32 image, its channels past C zeros. One warp a row; a lane
// writes 4 values at a time.
__global__ void tcw32_ln_image_kernel(const float* __restrict__ raw, const float* __restrict__ lnp,
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
  for (int k = 4 * lane; k < cp; k += 128) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < C) {
      const float4 x = *reinterpret_cast<const float4*>(src + k);
      const float4 s = *reinterpret_cast<const float4*>(scale + k);
      const float4 bi = *reinterpret_cast<const float4*>(bias + k);
      v = make_float4((x.x - mean) * rstd * s.x + bi.x, (x.y - mean) * rstd * s.y + bi.y,
                      (x.z - mean) * rstd * s.z + bi.z, (x.w - mean) * rstd * s.w + bi.w);
    }
    unsigned char* chunk = img + ((b * tiles + r / TM) * (cp / KW) + k / KW) * CHUNK;
    *reinterpret_cast<float4*>(chunk + in_chunk32(r % TM, k % KW)) = v;
  }
}

// LN2 and the residual: y = x + LN(FFN out) for the L valid rows of each batch element.
__global__ void tcw32_ln_residual_kernel(const float* __restrict__ raw, const float* __restrict__ lnp,
                                         const float* __restrict__ scale, const float* __restrict__ bias,
                                         const float* __restrict__ x, float* __restrict__ y, int B, int L,
                                         int tiles, int C, int nb) {
  ln_residual(raw, lnp, scale, bias, x, y, B, L, tiles, C, nb);
}

// The chain's traits (tcw_plan.cuh): f32 images of [64, 32] chunks, B chunks as hi and lo halves.
struct Chain {
  static constexpr int KW = tcw32::KW, SG = tcw32::SG;
  static constexpr uint32_t W_BYTES = W_HALF, W_STRIDE = 2 * W_HALF, KV_BYTES = KV_HALF, KV_STRIDE = 2 * KV_HALF;

  template <int KIND>
  static cudaError_t gemm(const Params& p, dim3 grid, cudaStream_t stream) {
    constexpr size_t smem = gm::Smem32<n_cols<KIND>(), NST>::BYTES;
    static int have[MAX_DEVICES];
    raise_smem_limit(tcw32_gemm_kernel<KIND>, smem, have);
    tcw32_gemm_kernel<KIND><<<grid, 128, smem, stream>>>(p);
    return cudaGetLastError();
  }
  static cudaError_t pack(const float* src, unsigned char* img, int rows, int C, int tiles, int B,
                          cudaStream_t stream) {
    tcw32_pack_kernel<<<dim3(padded(C) / KW, tiles, B), 256, 0, stream>>>(src, img, rows, C, tiles);
    return cudaGetLastError();
  }
  static cudaError_t kv_reduce(const float* part, unsigned char* kv, int C, int hd, int G, int B,
                               cudaStream_t stream) {
    const dim3 grid(padded(C) / KW, replicated(hd) ? padded(C) / BR : (C + BN - 1) / BN, B);
    if (replicated(hd))
      tcw32_kv_reduce_kernel<true><<<grid, 256, 0, stream>>>(part, kv, C, hd, G);
    else
      tcw32_kv_reduce_kernel<false><<<grid, 256, 0, stream>>>(part, kv, C, hd, G);
    return cudaGetLastError();
  }
  static cudaError_t ln_image(const float* raw, const float* lnp, const float* scale, const float* bias,
                              unsigned char* img, int n_rows, int tiles, int C, int nb, cudaStream_t stream) {
    tcw32_ln_image_kernel<<<(n_rows + 7) / 8, 256, 0, stream>>>(raw, lnp, scale, bias, img, n_rows, tiles, C, nb);
    return cudaGetLastError();
  }
  static cudaError_t ln_residual(const float* raw, const float* lnp, const float* scale, const float* bias,
                                 const float* x, float* y, int B, int L, int tiles, int C, int nb,
                                 cudaStream_t stream) {
    tcw32_ln_residual_kernel<<<(B * L + 7) / 8, 256, 0, stream>>>(raw, lnp, scale, bias, x, y, B, L, tiles, C,
                                                                  nb);
    return cudaGetLastError();
  }
};

}  // namespace tcw32
}  // namespace

// f32 operands on the tensor cores in split TF32 at the other widths (C a
// multiple of 32 from 32 to 4096, any head count dividing it). With Cp = C
// padded to a multiple of 64: wkv: [Wk; Wv] as [ceil(2C / 128) column
// blocks][Cp / 32 k chunks] of [128 out, 32 in] chunks, each the TF32 hi image
// then the lo image (16 KB each); wapply: Wq and Wmerge ([ceil(C / 128)][Cp /
// 32] chunks each), W0 ([ceil(2C / 128)][2 Cp / 32], its x and LN1 input
// halves each padded to Cp), W1 ([ceil(C / 128)][2 C / 32]); output rows past
// N and input columns past C zero. scratch: opp_encoder_tcw_tf32_scratch_bytes
// bytes, 128-byte aligned.
extern "C" int opp_encoder_layer_tcw_tf32(const float* x, const float* src, const void* wkv,
                                          const void* wapply, const float* ln1s, const float* ln1b,
                                          const float* ln2s, const float* ln2b, const float* qmask,
                                          const float* smask, void* scratch, float* y, int B, int L, int S,
                                          int C, int nhead, void* stream) {
  return opp::tcw_plan::launch<tcw32::Chain>(x, src, wkv, wapply, ln1s, ln1b, ln2s, ln2b, qmask, smask, scratch,
                                             y, B, L, S, C, nhead, static_cast<cudaStream_t>(stream));
}

// Bytes of scratch a call needs (self: x and source are one tensor); 0 where the instance does not take C.
extern "C" long long opp_encoder_tcw_tf32_scratch_bytes(int B, int L, int S, int C, int nhead, int self) {
  return opp::tcw_plan::scratch_bytes<tcw32::Chain>(B, L, S, C, nhead, self != 0);
}
