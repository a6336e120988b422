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
// of that is needed here: the kernel is the corner-addressed sibling of K3
// (gather.cu), reading the unpadded NHWC map and writing zeros for the taps
// that fall outside it.
//
// Bound: device-memory bandwidth. The least the card must move is one write
// of the [B, K, W*W, C] output and one read of the map pixels the patches
// cover (at the refine shapes, [8, 1024, 81, 128] bf16 out = 170 MB against
// at most the 134 MB [8, 256, 256, 128] map; at the sparse FPN's,
// [16, 512, 81, 196] bf16 out = 260 MB). Design: one block per patch, vector
// copies with neighbouring threads on neighbouring addresses, so loads and
// stores coalesce along the C * itemsize bytes of each tap. The copy does not
// look at the element type, only at the vector: 16 bytes where the pixel's
// bytes and both base pointers allow it, else 8 (a bf16 pixel of 196
// channels is 392 = 49 x 8 bytes), else 4, else 2 (a bf16 pixel of an odd
// number of channels, or a bf16 map 2 bytes past an alignment); the wrapper
// picks the widest.
#include <cstdint>

#include "common.cuh"

namespace {

template <typename V>
__global__ void patch_gather_kernel(const V* __restrict__ feat, const int* __restrict__ row0,
                                    const int* __restrict__ col0, V* __restrict__ out, int H,
                                    int W, int nv, int K, int window) {
  const int k = blockIdx.x, b = blockIdx.y;
  const size_t slot = (size_t)b * K + k;
  const int r0 = row0[slot], c0 = col0[slot];
  const int taps = window * window;
  const V* src = feat + (size_t)b * H * W * nv;  // nv vectors per pixel
  V* dst = out + slot * taps * nv;
  for (int i = threadIdx.x; i < taps * nv; i += blockDim.x) {
    const int t = i / nv, v = i % nv;
    const int r = r0 + t / window;
    const int c = c0 + t % window;
    V val{};
    if (r >= 0 && r < H && c >= 0 && c < W) val = src[((size_t)r * W + c) * nv + v];
    dst[i] = val;
  }
}

template <typename V>
int launch_vec(const void* feat, const int* row0, const int* col0, void* out, int B, int H,
               int W, int row_bytes, int K, int window, cudaStream_t stream) {
  if (row_bytes % (int)sizeof(V) != 0 || reinterpret_cast<uintptr_t>(feat) % sizeof(V) != 0 ||
      reinterpret_cast<uintptr_t>(out) % sizeof(V) != 0)
    return (int)cudaErrorMisalignedAddress;
  patch_gather_kernel<V><<<dim3(K, B), 128, 0, stream>>>(
      static_cast<const V*>(feat), row0, col0, static_cast<V*>(out), H, W,
      row_bytes / (int)sizeof(V), K, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_patch_gather(const void* feat, const int* row0, const int* col0, void* out, int B,
                        int H, int W, int C, int K, int window, int vec_bytes,
                        cudaStream_t stream) {
  if (B <= 0 || B > 65535 || K <= 0 || C <= 0 || window <= 0) return (int)cudaErrorInvalidValue;
  const int row_bytes = C * (int)sizeof(T);
  switch (vec_bytes) {
    case 16:
      return launch_vec<uint4>(feat, row0, col0, out, B, H, W, row_bytes, K, window, stream);
    case 8:
      return launch_vec<uint2>(feat, row0, col0, out, B, H, W, row_bytes, K, window, stream);
    case 4:
      return launch_vec<unsigned int>(feat, row0, col0, out, B, H, W, row_bytes, K, window,
                                      stream);
    case 2:
      return launch_vec<unsigned short>(feat, row0, col0, out, B, H, W, row_bytes, K, window,
                                        stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define OPP_PATCH_ENTRY(NAME, T)                                                               \
  extern "C" int NAME(const void* feat, const int* row0, const int* col0, void* out, int B,    \
                      int H, int W, int C, int K, int window, int vec_bytes, void* stream) {   \
    return launch_patch_gather<T>(feat, row0, col0, out, B, H, W, C, K, window, vec_bytes,    \
                                  static_cast<cudaStream_t>(stream));                         \
  }

OPP_PATCH_ENTRY(opp_patch_gather_f32, float)
OPP_PATCH_ENTRY(opp_patch_gather_bf16, __nv_bfloat16)
