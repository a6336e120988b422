// The similarity tile of K2's instances above 576 channels (matching.cu):
// the tensor cores at any width, on the channel-streaming product loops of
// wgmma_gemm.cuh (Ring: bf16; Ring32: f32 in split TF32). Where the resident
// tiles of sim_tile_tc.cuh and sim_tile_tf32.cuh stop (a 64-row tile of f0
// and the ring no longer fit a block's shared memory), a block keeps nothing
// resident: it owns one 64-row f0 tile, as they do, so the row statistics
// stay in the block, and streams f0's and f1's chunks alike, one bulk copy
// each, from L2. For each 128-row f1 tile (128 columns of s) the product runs
// over the channels in chunks, the ring's chunk counter running on from one
// column tile into the next, so the next tile's first chunks arrive while
// the epilogue reduces this one.
//
//   - wide_bf16 (the JAX kernel's precision): A and B bf16 [rows, 64]
//     chunks in gemm::in_chunk's layout; m64n128k16 products, the whole k in
//     one accumulator (gemm::Ring).
//   - wide_tf32 (f32 operands, f32 tolerances): A an f32 [64, 32] chunk
//     split into TF32 halves in registers, B a [128, 32] chunk as hi and lo
//     images; three m64n128k8 products a k step, pairs of chunks promoted
//     into an f32 sum (run_tf32's arithmetic).
//
// Operands are packed beforehand (matching.cu), scaled, rounded and
// zero-padded, rows to a multiple of the tile (64 for f0, 128 for f1) and
// channels to a multiple of 64 (an even count of 32-channel chunks), each
// [tile][chunk] image contiguous:
//   bf16  [B, rows / TR, Cp / 64, TR / 8, 8, 8, 8]: element (r, k) of tile
//         r / TR at byte (k / 64) * 128 TR + in_chunk(r % TR, k % 64);
//   f32   f0 [B, rows / 64, Cp / 32, 8, 8, 8, 4] (sim_tile_tf32.cuh's pack):
//         (k / 32) * 8192 + in_chunk32(r % 64, k % 32);
//         f1 [B, rows / 128, Cp / 32, 2, 16, 8, 8, 4]: hi then lo image of each
//         chunk, (k / 32) * 32768 + half * 16384 + in_chunk32(r % 128, k % 32).
//
// Bound: the two P*L*C products (operations) at the tensor cores' rate, but
// a 64 x 128 tile's chunk step brings 24 KB (bf16) for 2 * 64 * 128 * 64
// operations, ~43 a byte, so the L2 rate comes first; the exponentials of
// the LSE pass as in the other instances. A column tile is 128 wide, so the
// epilogue's column reduction runs over all four warps' 128 columns at once.
#pragma once

#include "sim_tile_tc.cuh"
#include "wgmma_gemm.cuh"

namespace opp {
namespace wide {

namespace gm = opp::gemm;
using opp::tc::NWARP;
using opp::tc::TM;

constexpr int NC = 128;              // columns of s a product gives: rows of an f1 tile
constexpr int KP = 64;               // channel padding: an even count of 32-channel chunks
constexpr int NST_BF16 = 4;          // ring stages: two blocks an SM (24 KB a stage)
constexpr int NST_TF32 = 2;          // (40 KB a stage: A, B hi, B lo)
constexpr int SCRATCH_FLOATS = 2 * 2 * NWARP * NC;  // [tile parity][two quantities][warp][column]

__host__ __device__ __forceinline__ int pad_channels(int c) { return (c + KP - 1) / KP * KP; }
__host__ __device__ __forceinline__ int pad_rows(int n, int tr) { return (n + tr - 1) / tr * tr; }

template <int NST>
__host__ __device__ constexpr size_t smem_bytes_bf16() {
  return gm::Smem<NC, NST>::BYTES + SCRATCH_FLOATS * sizeof(float);
}
template <int NST>
__host__ __device__ constexpr size_t smem_bytes_tf32() {
  return gm::Smem32<NC, NST>::BYTES + SCRATCH_FLOATS * sizeof(float);
}

// The passes' view of a ring (matching.cu: lse_pass, argmax_pass): products
// complete on return, the cross-warp scratch past the ring.
template <class R>
struct WideSim {
  static constexpr int NC = wide::NC;
  R ring;
  float* scratch;
  int tiles;

  __device__ WideSim(const R& r, unsigned char* scratch_, int tiles_)
      : ring(r), scratch(reinterpret_cast<float*>(scratch_)), tiles(tiles_) {}
  __device__ __forceinline__ void start() const {
    ring.start([](unsigned char*) {});
  }
  __device__ __forceinline__ int n_tiles() const { return tiles; }
  __device__ __forceinline__ void product(float (&acc)[NC / 2], int it) const { ring.product(acc, it); }
  // The cross-warp scratch of tile t: two [NWARP warps][128 columns] arrays.
  __device__ __forceinline__ float* cols(int t) const { return scratch + (t & 1) * 2 * NWARP * NC; }
  // The ring refills itself.
  __device__ __forceinline__ void release(int) const {}
};

// bf16: f0b / f1b the packed operands of this batch element, `pt` the block's
// f0 tile, Cp channels (a multiple of 64), L rows of f1.
__device__ __forceinline__ auto bf16_sim(unsigned char* smem, const __nv_bfloat16* f0b,
                                         const __nv_bfloat16* f1b, int pt, int cp, int L) {
  const int n = cp / 64, tiles = pad_rows(L, NC) / NC;
  const unsigned char* a0 = reinterpret_cast<const unsigned char*>(f0b) + (size_t)pt * TM * cp * 2;
  const unsigned char* b0 = reinterpret_cast<const unsigned char*>(f1b);
  const auto of = [=](int v, const void*& a, const void*& b) {
    const int t = v / n, u = v - t * n;
    a = a0 + (size_t)u * gm::A_CHUNK;
    b = b0 + ((size_t)t * n + u) * gm::Smem<NC, NST_BF16>::B_CHUNK;
  };
  using R = gm::Ring<NC, NST_BF16, decltype(of)>;
  return WideSim<R>(R(smem, n, tiles, gm::Smem<NC, NST_BF16>::B_CHUNK, of),
                    smem + gm::Smem<NC, NST_BF16>::BYTES, tiles);
}

// f32 in split TF32: f0b packed by sim_tile_tf32.cuh's pack at Cp channels, f1b
// as hi and lo images; Cp a multiple of 64.
__device__ __forceinline__ auto tf32_sim(unsigned char* smem, const float* f0b, const float* f1b, int pt,
                                         int cp, int L) {
  const int n = cp / 32, tiles = pad_rows(L, NC) / NC;
  constexpr uint32_t B_HALF = gm::Smem32<NC, NST_TF32>::B_HALF;
  const unsigned char* a0 = reinterpret_cast<const unsigned char*>(f0b) + (size_t)pt * TM * cp * 4;
  const unsigned char* b0 = reinterpret_cast<const unsigned char*>(f1b);
  const auto of = [=](int v, const void*& a, const void*& b) {
    const int t = v / n, u = v - t * n;
    a = a0 + (size_t)u * gm::A_CHUNK;
    b = b0 + ((size_t)t * n + u) * 2 * B_HALF;
  };
  using R = gm::Ring32<NC, NST_TF32, decltype(of)>;
  return WideSim<R>(R(smem, n, tiles, B_HALF, of), smem + gm::Smem32<NC, NST_TF32>::BYTES, tiles);
}

}  // namespace wide
}  // namespace opp
