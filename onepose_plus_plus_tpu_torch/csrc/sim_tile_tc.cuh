// The tensor-core similarity tile of K2's and K5's bf16 instances (matching.cu,
// coarse_loss.cu): a block of one warpgroup keeps a resident 64-row tile of
// one operand and streams 64-row tiles of the other through a two-stage ring
// by bulk copies; it multiplies the resident tile with each streamed tile in
// m64n64k16 wgmma products with f32 accumulators, and the callers reduce the
// accumulator fragments in registers (rows over the 4 lanes of a quad,
// columns over the 8 quads of a warp, then across the block's four warps
// through a small shared array). Three tiles of shared memory a block (C up
// to 576); two blocks share an SM, so one block's epilogue overlaps the
// other's products.
//
// Operands are packed beforehand (matching.cu, opp_pack_operand_*): bf16, the
// channels zero-padded to Cp (a multiple of 16), the rows zero-padded to a
// multiple of TM, as [B, rows / 8, Cp / 8, 8, 8], so that element (r, k) of a
// batch element lies at byte
//     (r / 8) * (16 Cp) + (k / 8) * 128 + (r % 8) * 16 + (k % 8) * 2,
// the unswizzled K-major layout of wgmma.cuh with LBO = 128 and SBO = 16 Cp.
// A 64-row tile is then one contiguous slab of 128 Cp bytes (32 KB at C = 256)
// that one cp.async.bulk brings in. Zero channels leave every dot product as
// it is; rows past the operand's end are masked by index in the callers. The
// rows are padded to a multiple of TM, so that every tile exists.
//
// Accumulator fragment (wgmma.cuh): thread (w = warp of the block, g = lane /
// 4, t = lane % 4) holds acc[4 j + 2 h + e] = s[16 w + g + 8 h][8 j + 2 t + e]
// of its block's rows, j < 8.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace opp {
namespace tc {

namespace wg = opp::wg;

constexpr int TM = 64;         // rows of every tile, and of a block
constexpr int NWARP = 4;       // warps a block: one warpgroup
constexpr int NT = 32 * NWARP;
constexpr int NST = 2;         // ring stages of the streamed operand
constexpr uint32_t LBO = 128;  // K-major: the next 8 channels
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1e30f;
constexpr int SCRATCH_FLOATS = 2 * 2 * NWARP * TM;  // [tile parity][two quantities][warp][column]
constexpr int MAX_C = 576;  // three tiles of 64 x 576 bf16 fill a block's shared memory

__host__ __device__ __forceinline__ int pad_channels(int c) { return (c + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int pad_rows(int n) { return (n + TM - 1) / TM * TM; }
__host__ __device__ __forceinline__ uint32_t tile_bytes(int cp) { return (uint32_t)TM * cp * 2; }
// Dynamic shared memory of a block: the resident tile, the ring, the
// barriers and the cross-warp scratch.
__host__ __device__ __forceinline__ size_t smem_bytes(int cp) {
  return (size_t)(1 + NST) * tile_bytes(cp) + 64 + SCRATCH_FLOATS * sizeof(float);
}

// The resident tile and the ring of streamed tiles. Tile t of the streamed
// operand lands in stage t % NST; thread 0 starts every copy.
struct Tiles {
  unsigned char* res;
  unsigned char* ring;
  uint64_t* bar;  // NST ring barriers, then the resident tile's
  float* scratch;
  const unsigned char* stream;  // the streamed operand of this batch element
  uint32_t bytes;
  int n_tiles;

  __device__ Tiles(unsigned char* smem, int cp, const void* stream_src, int n)
      : res(smem),
        ring(smem + tile_bytes(cp)),
        bar(reinterpret_cast<uint64_t*>(smem + (1 + NST) * tile_bytes(cp))),
        scratch(reinterpret_cast<float*>(smem + (1 + NST) * tile_bytes(cp) + 64)),
        stream(static_cast<const unsigned char*>(stream_src)),
        bytes(tile_bytes(cp)),
        n_tiles(n) {}

  __device__ __forceinline__ void fetch(int t) const {
    const int st = t % NST;
    wg::mbar_expect_tx(bar + st, bytes);
    wg::bulk_load(ring + (size_t)st * bytes, stream + (size_t)t * bytes, bytes, bar + st);
  }
  // Arms the barriers (thread 0), then starts the copy of the block's
  // resident tile and of the first NST streamed tiles; every thread returns
  // once the resident tile is in.
  __device__ __forceinline__ void start(const void* res_src) const {
    if (threadIdx.x == 0) {
      for (int i = 0; i <= NST; ++i) wg::mbar_init(bar + i, 1);
      wg::mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(bar + NST, bytes);
      wg::bulk_load(res, res_src, bytes, bar + NST);
      for (int t = 0; t < NST && t < n_tiles; ++t) fetch(t);
    }
    wg::mbar_wait(bar + NST, 0);
  }
  // Shared address of the resident tile.
  __device__ __forceinline__ uint32_t resident() const { return wg::smem_u32(res); }
  // Shared address of streamed tile t, once it has landed.
  __device__ __forceinline__ uint32_t wait(int t) const {
    wg::mbar_wait(bar + t % NST, (t / NST) & 1);
    return wg::smem_u32(ring + (size_t)(t % NST) * bytes);
  }
  // After the block barrier that follows tile t's last product: its stage
  // takes tile t + NST.
  __device__ __forceinline__ void release(int t) const {
    if (threadIdx.x == 0 && t + NST < n_tiles) fetch(t + NST);
  }
  // The cross-warp scratch of tile t: two [NWARP warps][64 columns] arrays.
  __device__ __forceinline__ float* cols(int t) const { return scratch + (t & 1) * 2 * NWARP * TM; }
};

// acc = A[64, Cp] B[64, Cp]^T for two packed tiles at shared addresses a and
// b. Issued and committed only: the caller waits (wg::wait<0>, fence_regs)
// after issuing its loads for the epilogue. At the coarse matchers' width
// (Cp = 256) the 16 products are one straight-line chain: in a loop over a
// runtime count the compiler fences every product (ptxas C7519).
__device__ __forceinline__ void sim_product(float (&acc)[32], uint32_t a, uint32_t b, int cp) {
  const uint32_t sbo = 16u * cp;
  wg::fence();
  if (cp == 256) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      wg::mma_n64(acc, wg::desc(a + k * 2 * LBO, LBO, 4096), wg::desc(b + k * 2 * LBO, LBO, 4096),
                  k > 0 ? 1 : 0);
  } else {
#pragma unroll 4
    for (int k = 0; k < cp / 16; ++k)
      wg::mma_n64(acc, wg::desc(a + k * 2 * LBO, LBO, sbo), wg::desc(b + k * 2 * LBO, LBO, sbo),
                  k > 0 ? 1 : 0);
  }
  wg::commit();
}

// Reductions of the fragment: over the quad (a row's 4 lanes) and over the 8
// quads of a warp (a column's 8 lanes), in a fixed order.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float col_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
__device__ __forceinline__ int col_min(int v) {
  v = min(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = min(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return min(v, __shfl_xor_sync(0xffffffffu, v, 16));
}
// (value, index) argmax over the lanes lane ^ lo, lane ^ 2 lo, ... up to hi,
// the lowest index on ties
template <int LO, int HI>
__device__ __forceinline__ void lanes_argmax(float& v, int& i) {
#pragma unroll
  for (int o = LO; o <= HI; o <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    const bool take = ov > v || (ov == v && oi < i);
    v = take ? ov : v;
    i = take ? oi : i;
  }
}

// exp(x) by ex2.approx, branch-free (a few ulp of f32)
__device__ __forceinline__ float exp_fast(float x) { return wg::ex2_fast(x * LOG2E); }

}  // namespace tc
}  // namespace opp
