// Shared helpers for the port's Hopper kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace opp {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and back (round to nearest even, as torch's .to(bfloat16)):
// the value a product operand of type T holds.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// elu(x) + 1, the linear-attention feature map (precise expf, to stay
// bit-close to the plain PyTorch version).
__device__ __forceinline__ float elu_p1(float x) { return x > 0.f ? x + 1.f : expf(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[r] += sum_k in[r, k] * W[k, col] for the R rows staged in shared memory
// `in` (row stride `ld`, K columns, K a multiple of 4), W row-major [K, ldw]
// of T. One thread per output column: each weight is read once per block and
// each float4 of `in` is a shared-memory broadcast feeding four FMAs.
template <typename T, int R>
__device__ __forceinline__ void mac_rows(const float* __restrict__ in, int ld, int K,
                                         const T* __restrict__ W, int ldw, int col,
                                         float (&acc)[R]) {
  for (int k = 0; k < K; k += 4) {
    const float w0 = to_f32(W[(size_t)(k + 0) * ldw + col]);
    const float w1 = to_f32(W[(size_t)(k + 1) * ldw + col]);
    const float w2 = to_f32(W[(size_t)(k + 2) * ldw + col]);
    const float w3 = to_f32(W[(size_t)(k + 3) * ldw + col]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(in + r * ld + k);
      acc[r] = fmaf(v.x, w0, acc[r]);
      acc[r] = fmaf(v.y, w1, acc[r]);
      acc[r] = fmaf(v.z, w2, acc[r]);
      acc[r] = fmaf(v.w, w3, acc[r]);
    }
  }
}

// Raising a kernel's dynamic shared-memory limit is a call into the driver:
// make it when a device first needs this many bytes for the kernel, not at
// every launch (have: bytes already granted, by device; 0 at start).
constexpr int MAX_DEVICES = 64;
template <typename Kernel>
void raise_smem_limit(Kernel kernel, size_t bytes, int* have) {
  int dev = 0;
  cudaGetDevice(&dev);
  const bool tracked = dev >= 0 && dev < MAX_DEVICES;
  if (tracked && have[dev] >= (int)bytes) return;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) ==
          cudaSuccess && tracked)
    have[dev] = (int)bytes;
}

// Row-wise LayerNorm of buf [rows, C] in place (one warp per row), output
// rounded to T.
template <typename T>
__device__ __forceinline__ void layernorm_rows(float* buf, int rows, int C,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    float* row = buf + r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
    for (int c = lane; c < C; c += 32)
      row[c] = round_to<T>((row[c] - mean) * rstd * scale[c] + bias[c]);
  }
}

}  // namespace opp
