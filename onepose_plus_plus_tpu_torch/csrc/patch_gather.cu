// K6: W x W patch gather at any integer top-left corner.
//
// Replaces onepose_plus_plus_tpu/ops/pallas_patch_gather.py::gather_patches_dma
// as used by ops/window_gather.py::gather_windows (the LoFTR `refine` mode of
// the SfM post-optimisation and descriptor extraction) and by
// models/backbone.py::ResNetFPN_8_2.fine_windows (the sparse fine FPN of the
// query step, which gathers halo patches of the 196-channel pin map):
//   out[b, k, dr * W + dc, :] = feat[b, row0[b, k] + dr, col0[b, k] + dc, :]
// with taps outside the map zero. A corner entirely off the map (padded match
// slots come in with row0 <= -W) gives an all-zero patch. Exact (a copy).
//
// The TPU kernel DMAs an (8, 128)-aligned superset block per patch out of a
// map padded by W on every side, because Mosaic cannot prove an arbitrary
// offset aligned, and then slices the true window out with XLA gathers. None
// of that is needed here: the kernel reads the unpadded NHWC map.
//
// Bound: device-memory bandwidth. The least the card must move is one write
// of the [B, K, W*W, C] output and one read of the map pixels the patches
// cover (at the refine shapes, [8, 1024, 81, 128] bf16 out = 170 MB; at the
// sparse FPN's, [16, 512, 81, 196] bf16 out = 260 MB).
//
// Design: a copy of byte spans. In NHWC the in-map taps of one patch row are
// one contiguous span of the map, (c_hi - c_lo) * P bytes from pixel
// (row, c_lo) for a pixel of P bytes, and the patch row is one contiguous
// span of the output, window * P bytes; the taps clipped at the row's two
// ends, and rows off the map, are zeros. So the pixel's width does not set
// the width of the copy: a thread stores 16 aligned output bytes at a time
// (st.global.cs: the output is read only by the next kernel), a row's first
// and last partial 16 bytes as 2-byte halves (every pointer and pixel here is
// whole halves). The 16 bytes at output address A take the map bytes from
// A + delta on, delta being the row's distance from output to map: one
// aligned 16-byte load (ld.global.nc) where (A + delta) mod 16 is 0, else a
// second one where the chunk's map bytes run into it, and a funnel shift by
// (A + delta) mod 16; the bytes outside the row's span are zeroed. A first
// vector that holds no map byte (the map's first bytes, a map that is a view
// at any 2-byte offset) is raised to the map's first aligned vector, so no
// load leaves the 16-byte blocks the map touches.
//
// Work: one block of 128 threads a patch (grid [K, N]), one 16-byte chunk a
// thread a step, as the first design had one vector: many small blocks keep
// the SM's loads in flight. Two designs that gave a warp a patch and four
// chunks a lane in flight read 60-65 % of the bound at the refine shapes
// (94-118 registers, 16 warps an SM) and one that walked a warp along the
// rows 48 %, against 84-89 % here (40 registers). A patch row is CMAX chunk
// slots (the most aligned chunks a row of window * P bytes touches); slot
// t's row is a multiply and a shift ((t * magic) >> 48, magic =
// ceil(2^48 / CMAX), exact while window * CMAX^2 < 2^48), so nothing in the
// loop divides. ops/cuda_patch_gather.py::patch_spans and patch_chunks are
// the same arithmetic in PyTorch, held against the plain version by the CPU
// tests. The corners are read in the caller's integer type and strides (a
// column of a [N, K, 2] centre tensor needs no copy), plus a constant offset
// (gather_windows' -W/2), so a call is one launch.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;      // a block a patch
constexpr int MAGIC_SHIFT = 48;   // a slot's patch row is (slot * magic) >> 48
constexpr int MAX_WINDOW = 255;

// Bytes [o, o + 16) of the 32 bytes a | b (little endian), 0 <= o < 16.
__device__ __forceinline__ uint4 funnel16(const uint4& a, const uint4& b, int o) {
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = o >> 2, sh = (o & 3) * 8;
  unsigned s[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {  // s[j] = w[q + j] by selects, no local memory
    const unsigned even = (q & 1) ? w[j + 1] : w[j];
    const unsigned odd = (q & 1) ? w[j + 3] : w[j + 2];
    s[j] = (q & 2) ? odd : even;
  }
  return make_uint4(__funnelshift_r(s[0], s[1], sh), __funnelshift_r(s[1], s[2], sh),
                    __funnelshift_r(s[2], s[3], sh), __funnelshift_r(s[3], s[4], sh));
}

__device__ __forceinline__ unsigned half_mask(int lo, int hi, int h) {  // 2-byte half h in [lo, hi)?
  return (2 * h >= lo && 2 * h < hi) ? 0xFFFFu << (16 * (h & 1)) : 0u;
}

template <typename Idx>
__global__ void __launch_bounds__(THREADS)
patch_gather_kernel(const char* __restrict__ feat, const Idx* __restrict__ row0,
                    const Idx* __restrict__ col0, char* __restrict__ out, long long row_sn,
                    long long row_sk, long long col_sn, long long col_sk, int offset, int H,
                    int W, int P, int window, int cmax, unsigned long long magic,
                    long long vec_lo) {
  const int kk = blockIdx.x, b = blockIdx.y;
  const long long r0 = (long long)__ldg(row0 + b * row_sn + kk * row_sk) + offset;
  const long long c0 = (long long)__ldg(col0 + b * col_sn + kk * col_sk) + offset;
  const int row = window * P;                        // bytes a patch row (a patch is under 2^31 bytes)
  const long long pitch = (long long)W * P;          // bytes an image row
  char* const dst = out + ((long long)b * gridDim.x + kk) * window * row;
  const int dmod = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  const long long src0 = reinterpret_cast<long long>(feat) + (long long)b * H * pitch + c0 * P;
  const long long cl = c0 > 0 ? c0 : 0, ch = c0 + window < W ? c0 + window : W;
  const int copy_lo = ch > cl ? (int)((cl - c0) * P) : 0;  // a row's map bytes: [copy_lo, copy_hi)
  const int copy_hi = ch > cl ? (int)((ch - c0) * P) : 0;
  const int T = window * cmax;
  // slot t: chunk c of patch row dr, the aligned 16 output bytes at patch offset a
  for (int t = threadIdx.x; t < T; t += THREADS) {
    const int dr = (int)(((unsigned long long)t * magic) >> MAGIC_SHIFT);
    const int c = t - dr * cmax;
    const int start = dr * row;                      // the row: patch bytes [start, start + row)
    const int a = ((start + dmod) & ~15) - dmod + 16 * c;
    if (a >= start + row) continue;                  // a slot past the row's last chunk
    const int lo = start + copy_lo - a, hi = start + copy_hi - a;  // its map bytes, unclipped
    const long long r = r0 + dr;
    const bool copy = r >= 0 && r < H && copy_hi > copy_lo && hi > 0 && lo < 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (copy) {
      const long long src = src0 + r * pitch + (a - start);  // map address of the chunk's byte 0
      const int o = (int)(src & 15);
      // f0 holds no map byte where the first lies in f1: at the map's first
      // bytes it would leave the map's vectors, so it is raised to the first
      const long long f1 = src - o + 16, f0 = f1 - 16 < vec_lo ? vec_lo : f1 - 16;
      val = __ldg(reinterpret_cast<const uint4*>(f0));
      if (o != 0) {
        uint4 second = make_uint4(0u, 0u, 0u, 0u);
        if (o + hi > 16) second = __ldg(reinterpret_cast<const uint4*>(f1));
        val = funnel16(val, second, o);
      }
      if (lo > 0 || hi < 16) {  // the row's first or last map bytes: zero the rest
        val.x &= half_mask(lo, hi, 0) | half_mask(lo, hi, 1);
        val.y &= half_mask(lo, hi, 2) | half_mask(lo, hi, 3);
        val.z &= half_mask(lo, hi, 4) | half_mask(lo, hi, 5);
        val.w &= half_mask(lo, hi, 6) | half_mask(lo, hi, 7);
      }
    }
    char* p = dst + a;
    const int s_lo = start - a, s_hi = start + row - a;  // its bytes in the row
    if (s_lo <= 0 && s_hi >= 16) {
      __stcs(reinterpret_cast<uint4*>(p), val);
    } else {  // the row's first or last chunk: its own 2-byte halves
      const unsigned w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int h = 0; h < 8; ++h)
        if (2 * h >= s_lo && 2 * h < s_hi)
          reinterpret_cast<unsigned short*>(p)[h] = (unsigned short)(w[h >> 1] >> (16 * (h & 1)));
    }
  }
}

// Chunk slots a patch row: the most 16-byte chunks a row of `row` bytes
// touches when rows start at multiples of gcd(row, 16) past an alignment.
long long chunk_slots(long long row) {
  int g = 16;
  while (row % g) g >>= 1;
  return (16 - g + row + 15) / 16;
}

template <typename Idx>
int launch_patch_gather(const void* feat, const void* row0, const void* col0, void* out,
                        long long row_sn, long long row_sk, long long col_sn, long long col_sk,
                        int N, int K, int H, int W, int P, int window, int offset,
                        cudaStream_t stream) {
  if (N <= 0 || N > 65535 || K <= 0 || H <= 0 || W <= 0 || P <= 0 || P % 2 || window <= 0 ||
      window > MAX_WINDOW || (long long)window * window * P >= (1LL << 31) - 64)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(feat) % 2 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const long long cmax = chunk_slots((long long)window * P);
  if (window * cmax * cmax >= (1LL << MAGIC_SHIFT)) return (int)cudaErrorInvalidValue;
  const unsigned long long magic = ((1ull << MAGIC_SHIFT) + cmax - 1) / cmax;
  const long long base = reinterpret_cast<long long>(feat);
  const long long vec_lo = base & ~15LL;
  patch_gather_kernel<Idx><<<dim3(K, N), THREADS, 0, stream>>>(
      static_cast<const char*>(feat), static_cast<const Idx*>(row0),
      static_cast<const Idx*>(col0), static_cast<char*>(out), row_sn, row_sk, col_sn, col_sk,
      offset, H, W, P, window, (int)cmax, magic, vec_lo);
  return (int)cudaGetLastError();
}

}  // namespace

// feat: the [N, H, W, P bytes] map (any element type; P even, 2-byte aligned);
// row0 / col0: [N, K] corners of type int32 or int64 at element strides
// (sn, sk); offset is added to both; out: [N, K, window^2, P bytes], 16-byte
// aligned.
#define OPP_PATCH_ENTRY(NAME, IDX)                                                               \
  extern "C" int NAME(const void* feat, const void* row0, const void* col0, void* out,          \
                      long long row_sn, long long row_sk, long long col_sn, long long col_sk,   \
                      int N, int K, int H, int W, int P, int window, int offset, void* stream) { \
    return launch_patch_gather<IDX>(feat, row0, col0, out, row_sn, row_sk, col_sn, col_sk, N,   \
                                    K, H, W, P, window, offset,                                 \
                                    static_cast<cudaStream_t>(stream));                         \
  }

OPP_PATCH_ENTRY(opp_patch_gather_i32, int)
OPP_PATCH_ENTRY(opp_patch_gather_i64, long long)
