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
// (gather_windows' -W/2), so a call is one launch. The copy loop itself
// (opp::copy_patch, span.cuh) is shared with K3's span instance, which
// derives each window's corner from its cell id (gather.cu).
#include <cstdint>

#include "common.cuh"
#include "span.cuh"

namespace {

constexpr int MAX_WINDOW = 255;

template <typename Idx>
__global__ void __launch_bounds__(opp::PATCH_THREADS)
patch_gather_kernel(const char* __restrict__ feat, const Idx* __restrict__ row0,
                    const Idx* __restrict__ col0, char* __restrict__ out, long long row_sn,
                    long long row_sk, long long col_sn, long long col_sk, int offset, int H,
                    int W, int P, int window, int cmax, unsigned long long magic,
                    long long vec_lo) {
  const int kk = blockIdx.x, b = blockIdx.y;
  const long long r0 = (long long)__ldg(row0 + b * row_sn + kk * row_sk) + offset;
  const long long c0 = (long long)__ldg(col0 + b * col_sn + kk * col_sk) + offset;
  char* const dst = out + ((long long)b * gridDim.x + kk) * window * window * P;
  opp::copy_patch(feat, dst, b, r0, c0, H, W, P, window, cmax, magic, vec_lo);
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
  const long long cmax = opp::chunk_slots((long long)window * P);
  if (window * cmax * cmax >= (1LL << opp::MAGIC_SHIFT)) return (int)cudaErrorInvalidValue;
  const unsigned long long magic = ((1ull << opp::MAGIC_SHIFT) + cmax - 1) / cmax;
  const long long base = reinterpret_cast<long long>(feat);
  const long long vec_lo = base & ~15LL;
  patch_gather_kernel<Idx><<<dim3(K, N), opp::PATCH_THREADS, 0, stream>>>(
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
