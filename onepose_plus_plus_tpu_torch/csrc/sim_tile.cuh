// The similarity tile shared by K2 (matching.cu) and K5 (coarse_loss.cu):
// s[r][c] = dot(f0[p0 + r], f1[l0 + c]) * inv_temp + radd[p] + cadd[l] for a
// BR x BL tile, f32 accumulation over T (float or bf16) operands.
//
// Design: a 64x64 register-blocked tile (4x4 per thread, 256 threads) over
// 32-deep shared-memory slices of f0 and f1; the tile is left in shared
// memory (sm.s) for the caller's row and column reductions.
#pragma once

#include "common.cuh"

namespace opp {

constexpr int BR = 64;  // f0 rows per block
constexpr int BL = 64;  // f1 columns per streamed tile
constexpr int BK = 32;  // channel slice
constexpr int NT = 256;
constexpr float NEG = -1e30f;

struct TileSmem {
  __align__(16) float a[BK][BR + 4];
  __align__(16) float b[BK][BL + 4];
  float s[BR][BL + 1];
};

// s[r][c] = dot(f0[p0 + r], f1[l0 + c]) * inv_temp + radd[p] + cadd[l]
template <typename T>
__device__ void sim_tile(const T* __restrict__ f0, const T* __restrict__ f1,
                         const float* __restrict__ radd, const float* __restrict__ cadd, int p0,
                         int l0, int P, int L, int C, float inv_temp, TileSmem& sm) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += BK) {
    for (int i = tid; i < BR * BK; i += NT) {
      const int r = i / BK, k = i % BK, p = p0 + r;
      sm.a[k][r] = (p < P && k0 + k < C) ? opp::to_f32(f0[(size_t)p * C + k0 + k]) : 0.f;
    }
    for (int i = tid; i < BL * BK; i += NT) {
      const int c = i / BK, k = i % BK, l = l0 + c;
      sm.b[k][c] = (l < L && k0 + k < C) ? opp::to_f32(f1[(size_t)l * C + k0 + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[k][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, p = p0 + r;
    const float ra = (radd != nullptr && p < P) ? radd[p] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j, l = l0 + c;
      const float ca = (cadd != nullptr && l < L) ? cadd[l] : 0.f;
      sm.s[r][c] = acc[i][j] * inv_temp + ra + ca;
    }
  }
  __syncthreads();
}


}  // namespace opp
