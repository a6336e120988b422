// The split-TF32 similarity tile of K2's f32 instance (matching.cu): the
// tensor cores at f32 accuracy. Each product x y is taken as
// x_lo y_hi + x_hi y_lo + x_hi y_hi of TF32 halves (wgmma.cuh, tf32_split):
// three m64n64k8 TF32 products, about 2^-22 relative from the f32 product,
// at 495 TFLOP/s TF32 against the CUDA cores' 67 TFLOP/s f32.
//
// The f32 operands need twice the bytes of bf16 ones, and their TF32 halves
// four times. So that two blocks still share an SM (one block's epilogue
// overlaps the other's products) and L2 does not carry the halves:
//   - the resident 64-row f0 tile stays f32 in shared memory (64 KB at
//     C = 256) and is split into A fragments in registers at each k step;
//   - the f1 tiles stream as f32 in 32-channel chunks (8 KB): the threads
//     load chunk c + 2 into registers and split chunk c + 1 into hi and lo
//     images (the B operands, double-buffered in shared memory) while chunk
//     c's twelve products run, one block barrier a chunk.
//
// Operands are packed beforehand (matching.cu, opp_pack_tf32_operand_f32):
// f32, scaled, the channels zero-padded to Cp (a multiple of 32), the rows to
// a multiple of 64, as [B, rows / 64, Cp / 32, 8, 8, 8, 4], so that element
// (r, k) of a 64-row tile lies at float
//     (k / 32) * 2048 + (r / 8) * 256 + ((k % 32) / 4) * 32 + (r % 8) * 4 + k % 4,
// each 32-channel chunk of a tile the K-major layout of wgmma.cuh with
// LBO = 128 (the next 4 channels) and SBO = 1024 (the next 8 rows), a tile
// one contiguous bulk copy and a chunk 8 contiguous KB.
#pragma once

#include "sim_tile_tc.cuh"

namespace opp {
namespace tf {

namespace wg = opp::wg;
using opp::tc::NT;
using opp::tc::NWARP;
using opp::tc::SCRATCH_FLOATS;
using opp::tc::TM;

constexpr int KC = 32;                         // channels of a streamed chunk
constexpr uint32_t LBO = 128, SBO = 1024;      // a chunk image [64 rows, 32 channels]
constexpr uint32_t CHUNK_BYTES = TM * KC * 4;  // 8192
constexpr int CHUNK_FLOATS = TM * KC;          // 2048
constexpr int PER_THREAD = CHUNK_FLOATS / 4 / NT;  // float4s of a chunk a thread loads and splits
constexpr int MAX_C = 576;  // the resident tile and the images of a block at C = 576: 180 KB

__host__ __device__ __forceinline__ int pad_channels(int c) { return (c + KC - 1) / KC * KC; }
__host__ __device__ __forceinline__ uint32_t tile_bytes(int cp) { return (uint32_t)TM * cp * 4; }
// Dynamic shared memory of a block: the resident tile, two pairs of hi and lo
// images, the barrier and the cross-warp scratch.
__host__ __device__ __forceinline__ size_t smem_bytes(int cp) {
  return tile_bytes(cp) + (size_t)4 * CHUNK_BYTES + 64 + SCRATCH_FLOATS * sizeof(float);
}

struct Tf32Sim {
  static constexpr int NC = TM;  // columns of s a product gives
  const float* res;        // the resident f0 tile
  float* img;              // images of chunk parity p: hi at img + 2 p CHUNK_FLOATS, lo after it
  uint64_t* bar;           // the resident tile's
  float* scratch;
  const float4* stream;    // the f1 chunks of this batch element, in order of use
  int cp, nch, tiles;
  float4 next[PER_THREAD];  // this thread's share of the chunk after the one being split

  __device__ Tf32Sim(unsigned char* smem, int cp_, const void* stream_src, int n)
      : res(reinterpret_cast<const float*>(smem)),
        img(reinterpret_cast<float*>(smem + tile_bytes(cp_))),
        bar(reinterpret_cast<uint64_t*>(smem + tile_bytes(cp_) + 4 * CHUNK_BYTES)),
        scratch(reinterpret_cast<float*>(smem + tile_bytes(cp_) + 4 * CHUNK_BYTES + 64)),
        stream(static_cast<const float4*>(stream_src)),
        cp(cp_),
        nch(cp_ / KC),
        tiles(n) {}

  __device__ __forceinline__ void load(int c) {
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q)
      next[q] = __ldg(stream + (size_t)c * (CHUNK_FLOATS / 4) + threadIdx.x + q * NT);
  }
  // The loaded chunk, split into the hi and lo images of parity p.
  __device__ __forceinline__ void split(int p) {
    uint4* hi = reinterpret_cast<uint4*>(img + 2 * p * CHUNK_FLOATS);
    uint4* lo = reinterpret_cast<uint4*>(img + (2 * p + 1) * CHUNK_FLOATS);
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      uint4 h, l;
      wg::tf32_split(next[q].x, h.x, l.x);
      wg::tf32_split(next[q].y, h.y, l.y);
      wg::tf32_split(next[q].z, h.z, l.z);
      wg::tf32_split(next[q].w, h.w, l.w);
      hi[threadIdx.x + q * NT] = h;
      lo[threadIdx.x + q * NT] = l;
    }
  }
  // Starts the copy of the resident tile, splits the first chunk and loads
  // the second; every thread returns once both are in shared memory.
  __device__ __forceinline__ void start(const void* res_src) {
    if (threadIdx.x == 0) {
      wg::mbar_init(bar, 1);
      wg::mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(bar, tile_bytes(cp));
      wg::bulk_load(const_cast<float*>(res), res_src, tile_bytes(cp), bar);
    }
    load(0);
    split(0);
    if (tiles * nch > 1) load(1);
    wg::fence_proxy_async();
    wg::mbar_wait(bar, 0);
    __syncthreads();
  }

  // acc = f0 tile [64, Cp] x f1 tile it [64, Cp]^T, complete on return.
  __device__ __forceinline__ void product(float (&acc)[32], int it) {
    const int tid = threadIdx.x, w = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
    const int total = tiles * nch;
#pragma unroll 1
    for (int j = 0; j < nch; ++j) {
      const int c = it * nch + j, p = c & 1;
      // A fragments of the chunk's four k steps: rows 16 w + g (+ 8), channels
      // 8 s + t (+ 4) of the chunk
      uint32_t ah[4][4], al[4][4];
      const float* a = res + j * CHUNK_FLOATS + (2 * w) * 256 + g * 4 + t;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        wg::tf32_split(a[(2 * s) * 32], ah[s][0], al[s][0]);
        wg::tf32_split(a[256 + (2 * s) * 32], ah[s][1], al[s][1]);
        wg::tf32_split(a[(2 * s + 1) * 32], ah[s][2], al[s][2]);
        wg::tf32_split(a[256 + (2 * s + 1) * 32], ah[s][3], al[s][3]);
      }
      const uint32_t hi_addr = wg::smem_u32(img + 2 * p * CHUNK_FLOATS);
      const uint32_t lo_addr = hi_addr + CHUNK_BYTES;
      wg::fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint64_t bh = wg::desc(hi_addr + s * 2 * LBO, LBO, SBO);
        const uint64_t bl = wg::desc(lo_addr + s * 2 * LBO, LBO, SBO);
        // the two small cross products first, then the large one
        wg::mma_rs_tf32_n64(acc, al[s], bh, (j > 0 || s > 0) ? 1 : 0);
        wg::mma_rs_tf32_n64(acc, ah[s], bl, 1);
        wg::mma_rs_tf32_n64(acc, ah[s], bh, 1);
      }
      wg::commit();
      // while they run: the next chunk into the other images (whose products
      // ended before the last barrier), and the one after it into registers
      if (c + 1 < total) {
        split(p ^ 1);
        if (c + 2 < total) load(c + 2);
        wg::fence_proxy_async();
      }
      wg::wait<0>();
      wg::fence_regs(acc);
      __syncthreads();
    }
  }
  __device__ __forceinline__ int n_tiles() const { return tiles; }
  // The cross-warp scratch of tile t: two [NWARP warps][64 columns] arrays.
  __device__ __forceinline__ float* cols(int t) const { return scratch + (t & 1) * 2 * NWARP * TM; }
  // The images are refilled as the products run.
  __device__ __forceinline__ void release(int) const {}
};

}  // namespace tf
}  // namespace opp
