// K6: W x W patch gather at any integer top-left corner.
//
// Replaces onepose_plus_plus_tpu/ops/pallas_patch_gather.py::gather_patches_dma
// as used by ops/window_gather.py::gather_windows (the LoFTR `refine` mode of
// the SfM post-optimisation and descriptor extraction):
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
// at most the 134 MB [8, 256, 256, 128] map). Design: one block per patch,
// 16-byte vector copies with neighbouring threads on neighbouring addresses,
// so loads and stores coalesce along the C * itemsize bytes of each tap.
#include "common.cuh"

namespace {

template <typename T>
__global__ void patch_gather_kernel(const T* __restrict__ feat, const int* __restrict__ row0,
                                    const int* __restrict__ col0, T* __restrict__ out, int H,
                                    int W, int C, int K, int window) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  const int k = blockIdx.x, b = blockIdx.y;
  const size_t slot = (size_t)b * K + k;
  const int r0 = row0[slot], c0 = col0[slot];
  const int nv = C / VEC;  // vectors per tap
  const int taps = window * window;
  const uint4* src = reinterpret_cast<const uint4*>(feat + (size_t)b * H * W * C);
  uint4* dst = reinterpret_cast<uint4*>(out + slot * taps * C);
  for (int i = threadIdx.x; i < taps * nv; i += blockDim.x) {
    const int t = i / nv, v = i % nv;
    const int r = r0 + t / window;
    const int c = c0 + t % window;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r >= 0 && r < H && c >= 0 && c < W) val = src[((size_t)r * W + c) * nv + v];
    dst[i] = val;
  }
}

template <typename T>
int launch_patch_gather(const void* feat, const int* row0, const int* col0, void* out, int B,
                        int H, int W, int C, int K, int window, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || K <= 0 || C <= 0 || C % (16 / (int)sizeof(T)) != 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  patch_gather_kernel<T><<<dim3(K, B), 128, 0, stream>>>(static_cast<const T*>(feat), row0, col0,
                                                         static_cast<T*>(out), H, W, C, K, window);
  return (int)cudaGetLastError();
}

}  // namespace

#define OPP_PATCH_ENTRY(NAME, T)                                                               \
  extern "C" int NAME(const void* feat, const int* row0, const int* col0, void* out, int B,    \
                      int H, int W, int C, int K, int window, void* stream) {                  \
    return launch_patch_gather<T>(feat, row0, col0, out, B, H, W, C, K, window,               \
                                  static_cast<cudaStream_t>(stream));                         \
  }

OPP_PATCH_ENTRY(opp_patch_gather_f32, float)
OPP_PATCH_ENTRY(opp_patch_gather_bf16, __nv_bfloat16)
