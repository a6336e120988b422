// Tensor-core product loops for kernels that run products over operands in
// device memory: Ring (bf16) and Ring32 (f32 in split TF32) over a sequence
// of output tiles (K2's instances above 576 channels, sim_tile_wide.cuh), and
// run / run_tf32, one tile of them (K1's wide chains: encoder_tcw.cu,
// encoder_tcw_tf32.cu). A block
// of one warpgroup computes acc[64, NT] = sum over n chunks u of A_u B_u^T,
// A_u a [64 rows, 64 k] chunk and B_u an [NT rows, 64 k] chunk (a torch
// Linear weight's [out, in] orientation), both bf16 byte images of wgmma's
// unswizzled K-major core-matrix layout (wgmma.cuh):
//     element (r, k) of a chunk at byte (r / 8) * 1024 + (k / 8) * 128 + (r % 8) * 16 + (k % 8) * 2,
// i.e. LBO = 128 (the next 8 k), SBO = 1024 (the next 8 rows). The caller's
// functors give each chunk's device address; one bulk copy (cp.async.bulk +
// mbarrier) brings each operand's chunk into a ring of NST stages, and a
// chunk's four k16 products stay in flight while the next chunk's are issued.
// The four products of a chunk are one unrolled chain (a compile-time trip
// count); chunks are counted at run time. A prologue functor writes shared
// memory before the first copy (a constant block of B that the copies leave
// alone, say); the epilogue functor gets the f32 accumulator fragments:
// thread (w = warp, g = lane / 4, t = lane % 4) holds acc[4 j + 2 h + e] =
// D[16 w + g + 8 h][8 j + 2 t + e].
#pragma once

#include "wgmma.cuh"

namespace opp {
namespace gemm {

namespace wg = opp::wg;

constexpr int TM = 64;                      // rows of A, of a block's output
constexpr uint32_t A_CHUNK = TM * 64 * 2;   // 8192 bytes: A [64, 64] bf16
constexpr uint32_t LBO = 128, SBO = 1024;

// Shared memory of a block: NST stages of an A chunk and an [NT, 64] B chunk, the barriers.
template <int NT, int NST>
struct Smem {
  static constexpr uint32_t B_CHUNK = NT * 128;
  static constexpr uint32_t STAGE = A_CHUNK + B_CHUNK;
  static constexpr size_t BYTES = (size_t)NST * STAGE + 8 * NST;
  static_assert(STAGE % 128 == 0, "stages stay 128-byte aligned");
};

// D[64, 136] (+)= A[64, 16] * B[136, 16]^T, bf16 operands from shared memory, f32 accumulators.
__device__ __forceinline__ void mma_n136(float (&d)[68], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67},"
      " %68, %69, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64, 144] (+)= A[64, 16] * B[144, 16]^T, bf16 operands from shared memory, f32 accumulators.
__device__ __forceinline__ void mma_n144(float (&d)[72], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71},"
      " %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int NT>
__device__ __forceinline__ void mma(float (&d)[NT / 2], uint64_t a, uint64_t b, int scale_d);
template <>
__device__ __forceinline__ void mma<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  wg::mma_n128(d, a, b, scale_d);
}
template <>
__device__ __forceinline__ void mma<136>(float (&d)[68], uint64_t a, uint64_t b, int scale_d) {
  mma_n136(d, a, b, scale_d);
}
template <>
__device__ __forceinline__ void mma<144>(float (&d)[72], uint64_t a, uint64_t b, int scale_d) {
  mma_n144(d, a, b, scale_d);
}

// ---------------------------------------------------------- the ring
// A block's products for a sequence of output tiles of n chunks each, on one
// ring whose chunk counter runs on from one tile into the next (K2's wide
// instances: a block's 64-row f0 tile against each 128-row f1 tile in turn).
// Chunk v of the sequence (tile v / n, chunk v % n of its product) lands in
// stage v % NST, so the next tile's first chunks are in flight while the
// caller's epilogue of a tile runs (a tile's last stage is refilled before
// product returns); the barriers are set once, at start. of(v, a, b) sets
// chunk v's A and B device addresses (16-byte aligned; B: the bf16 chunk, or
// the hi image with lo b_bytes further), b_bytes the bytes of B to copy.
// Every thread of the warpgroup calls start once and then product for tiles
// 0, 1, ... in order; product returns the tile's sum, complete. An epilogue
// between two products may use shared memory past the ring (Smem::BYTES)
// and must not leave a thread behind a block barrier that others have passed.

// bf16 chunks (Smem<NT, NST>): the tensor cores sum the whole k of a tile. (In
// K2 at C = 2048 that sits 1.65x as far from float64 as the plain version's
// f32 sums; pairs of chunks summed apart, as Ring32 does, bought 1.39x and
// cost up to 17 % at C = 640, so bf16 does without.)
template <int NT, int NST, class Of>
struct Ring {
  unsigned char* smem;
  uint64_t* full;
  int n, total;
  uint32_t b_bytes;
  Of of;

  __device__ Ring(unsigned char* smem_, int n_, int tiles, uint32_t b_bytes_, Of of_)
      : smem(smem_),
        full(reinterpret_cast<uint64_t*>(smem_ + NST * Smem<NT, NST>::STAGE)),
        n(n_),
        total(n_ * tiles),
        b_bytes(b_bytes_),
        of(of_) {}

  __device__ __forceinline__ void fetch(int v) const {
    const void *a, *b;
    of(v, a, b);
    unsigned char* stage = smem + (v % NST) * Smem<NT, NST>::STAGE;
    wg::mbar_expect_tx(full + v % NST, A_CHUNK + b_bytes);
    wg::bulk_load(stage, a, A_CHUNK, full + v % NST);
    wg::bulk_load(stage + A_CHUNK, b, b_bytes, full + v % NST);
  }
  // Sets the barriers, runs prologue(smem) (shared memory the copies leave
  // alone, such as B rows past b_bytes) and starts the first copies.
  template <class Pro>
  __device__ __forceinline__ void start(Pro prologue) const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < NST; ++i) wg::mbar_init(full + i, 1);
      wg::mbar_init_fence();
    }
    prologue(smem);
    wg::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0)
      for (int v = 0; v < NST && v < total; ++v) fetch(v);
  }
  // chunk v's products are done in every warp: its stage takes chunk v + NST
  __device__ __forceinline__ void refill(int v) const {
    __syncthreads();
    if (threadIdx.x == 0 && v + NST < total) fetch(v + NST);
  }
  __device__ __forceinline__ void product(float (&acc)[NT / 2], int tile) const {
#pragma unroll 1
    for (int u = 0; u < n; ++u) {
      const int v = tile * n + u, st = v % NST;
      wg::mbar_wait(full + st, (v / NST) & 1);
      const uint32_t a = wg::smem_u32(smem + st * Smem<NT, NST>::STAGE), b = a + A_CHUNK;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma<NT>(acc, wg::desc(a + kk * 2 * LBO, LBO, SBO), wg::desc(b + kk * 2 * LBO, LBO, SBO),
                (u > 0 || kk > 0) ? 1 : 0);
      wg::commit();
      if (u > 0) {
        wg::wait<1>();
        refill(v - 1);
      }
    }
    wg::wait<0>();
    wg::fence_regs(acc);
    refill(tile * n + n - 1);  // before the caller's epilogue
  }
};

// The block's product over chunks 0..n-1 (n >= 1), one tile of Ring: a_of(u) /
// b_of(u) give the device addresses of chunk u's A and B (16-byte aligned),
// b_bytes the bytes of B to copy (at most Smem<NT, NST>::B_CHUNK; rows past
// them keep what the prologue wrote). prologue(smem) runs once, before the
// first copy; epilogue(acc) once the last product is in the registers. Every
// thread of the warpgroup calls this.
template <int NT, int NST, class AOf, class BOf, class Pro, class Epi>
__device__ __forceinline__ void run(unsigned char* smem, int n, AOf a_of, BOf b_of, uint32_t b_bytes,
                                    Pro prologue, Epi epilogue) {
  const auto of = [&](int u, const void*& a, const void*& b) {
    a = a_of(u);
    b = b_of(u);
  };
  const Ring<NT, NST, decltype(of)> ring(smem, n, 1, b_bytes, of);
  ring.start(prologue);
  float acc[NT / 2];
  ring.product(acc, 0);
  epilogue(acc);
}

// Sum over the four lanes of a quad (one accumulator row's threads), in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Byte offset of element (r, k) of a [rows, 64] chunk image.
__host__ __device__ __forceinline__ uint32_t in_chunk(int r, int k) {
  return (r >> 3) * 1024 + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// ------------------------------------------------------------ split TF32
// The same ring for f32 operands in split TF32: A_u is a [64 rows, 32 k] f32
// chunk (8 KB) and B_u an [NT rows, 32 k] f32 chunk as two images, its TF32 hi
// and lo halves (kernels.tf32_split), b_bytes each, hi then lo in device
// memory; all in wgmma's K-major core-matrix layout of 4-byte values:
//     element (r, k) at byte (r / 8) * 1024 + (k / 4) * 128 + (r % 8) * 16 + (k % 4) * 4
// (the same LBO and SBO as a bf16 [rows, 64] chunk). TF32 wgmma reads only
// K-major operands from shared memory, and a B operand cannot be split once it
// is there, so B arrives split; A comes from registers: each thread reads its
// fragments of the chunk (a warp's 32 lanes hit 32 distinct banks) and splits
// them there. A k8 step is three products, lo x B_hi, hi x B_lo, hi x B_hi
// (~2^-22 relative); a chunk's twelve are one unrolled chain. The next chunk's
// fragments are split while they run, into the other of two register sets:
// n (the chunks) must be even. The tensor cores' f32 accumulation over a long
// k loses accuracy (a layer of such products was 4-9x further from a float64
// layer than cuBLAS's f32 one, the more so the wider), so each pair of chunks
// (k = 64) sums in a fresh accumulator that is then added into an f32 sum in
// registers, rounded to nearest: the epilogue gets that sum.

// Bytes of element (r, k) of a [rows, 32] f32 chunk image.
__host__ __device__ __forceinline__ uint32_t in_chunk32(int r, int k) {
  return (r >> 3) * 1024 + (k >> 2) * 128 + (r & 7) * 16 + (k & 3) * 4;
}

// Shared memory of a split-TF32 block: NST stages of an A chunk, B's hi and lo images, the barriers.
template <int NT, int NST>
struct Smem32 {
  static constexpr uint32_t B_HALF = NT * 128;
  static constexpr uint32_t STAGE = A_CHUNK + 2 * B_HALF;
  static constexpr size_t BYTES = (size_t)NST * STAGE + 8 * NST;
  static_assert(STAGE % 128 == 0, "stages stay 128-byte aligned");
};

template <int NT>
__device__ __forceinline__ void mma_tf32(float (&d)[NT / 2], const uint32_t (&a)[4], uint64_t b, int scale_d);
template <>
__device__ __forceinline__ void mma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  wg::mma_rs_tf32_n128(d, a, b, scale_d);
}
template <>
__device__ __forceinline__ void mma_tf32<136>(float (&d)[68], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  wg::mma_rs_tf32_n136(d, a, b, scale_d);
}
template <>
__device__ __forceinline__ void mma_tf32<144>(float (&d)[72], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  wg::mma_rs_tf32_n144(d, a, b, scale_d);
}

// Split-TF32 chunks (Smem32<NT, NST>; n even). A tile's first chunk is split
// once its products may start; within a tile the next chunk's split overlaps
// the running products.
template <int NT, int NST, class Of>
struct Ring32 {
  unsigned char* smem;
  uint64_t* full;
  int n, total;
  uint32_t b_bytes;
  Of of;

  __device__ Ring32(unsigned char* smem_, int n_, int tiles, uint32_t b_bytes_, Of of_)
      : smem(smem_),
        full(reinterpret_cast<uint64_t*>(smem_ + NST * Smem32<NT, NST>::STAGE)),
        n(n_),
        total(n_ * tiles),
        b_bytes(b_bytes_),
        of(of_) {}

  __device__ __forceinline__ void fetch(int v) const {
    const void *a, *b;
    of(v, a, b);
    unsigned char* stage = smem + (v % NST) * Smem32<NT, NST>::STAGE;
    const unsigned char* bh = static_cast<const unsigned char*>(b);
    wg::mbar_expect_tx(full + v % NST, A_CHUNK + 2 * b_bytes);
    wg::bulk_load(stage, a, A_CHUNK, full + v % NST);
    wg::bulk_load(stage + A_CHUNK, bh, b_bytes, full + v % NST);
    wg::bulk_load(stage + A_CHUNK + Smem32<NT, NST>::B_HALF, bh + b_bytes, b_bytes, full + v % NST);
  }
  // Sets the barriers, runs prologue(smem) (shared memory the copies leave
  // alone, such as B rows past b_bytes) and starts the first copies.
  template <class Pro>
  __device__ __forceinline__ void start(Pro prologue) const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < NST; ++i) wg::mbar_init(full + i, 1);
      wg::mbar_init_fence();
    }
    prologue(smem);
    wg::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0)
      for (int v = 0; v < NST && v < total; ++v) fetch(v);
  }
  // chunk v's A fragments, read from its stage and split in registers
  __device__ __forceinline__ void split(int v, uint32_t (&h)[4][4], uint32_t (&l)[4][4]) const {
    const int tid = threadIdx.x, w = tid >> 5, g = (tid >> 2) & 7, t = tid & 3, st = v % NST;
    wg::mbar_wait(full + st, (v / NST) & 1);
    const float* a = reinterpret_cast<const float*>(smem + st * Smem32<NT, NST>::STAGE) +
                     (2 * w * 1024 + g * 16 + t * 4) / 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::tf32_split(a[64 * kk], h[kk][0], l[kk][0]);
      wg::tf32_split(a[64 * kk + 256], h[kk][1], l[kk][1]);
      wg::tf32_split(a[64 * kk + 32], h[kk][2], l[kk][2]);
      wg::tf32_split(a[64 * kk + 288], h[kk][3], l[kk][3]);
    }
  }
  // chunk v's twelve products (fresh at an even chunk of the tile), issued
  __device__ __forceinline__ void products(float (&acc)[NT / 2], int v, bool fresh, const uint32_t (&h)[4][4],
                                           const uint32_t (&l)[4][4]) const {
    const uint32_t bh = wg::smem_u32(smem + (v % NST) * Smem32<NT, NST>::STAGE + A_CHUNK);
    const uint32_t bl = bh + Smem32<NT, NST>::B_HALF;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = wg::desc(bh + kk * 2 * LBO, LBO, SBO), dl = wg::desc(bl + kk * 2 * LBO, LBO, SBO);
      mma_tf32<NT>(acc, l[kk], dh, (!fresh || kk > 0) ? 1 : 0);
      mma_tf32<NT>(acc, h[kk], dl, 1);
      mma_tf32<NT>(acc, h[kk], dh, 1);
    }
    wg::commit();
  }
  // chunk v's products are done in every warp: its stage takes chunk v + NST
  __device__ __forceinline__ void refill(int v) const {
    __syncthreads();
    if (threadIdx.x == 0 && v + NST < total) fetch(v + NST);
  }
  __device__ __forceinline__ void product(float (&out)[NT / 2], int tile) const {
    uint32_t ah[2][4][4], al[2][4][4];
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) out[i] = 0.f;
    const int v0 = tile * n;
    split(v0, ah[0], al[0]);
#pragma unroll 1
    for (int u = 0; u < n; u += 2) {
      const int v = v0 + u;
      products(acc, v, true, ah[0], al[0]);
      if (u > 0) refill(v - 1);  // done at the last pair's wait<0>
      split(v + 1, ah[1], al[1]);
      products(acc, v + 1, false, ah[1], al[1]);
      wg::wait<1>();
      refill(v);
      if (u + 2 < n) split(v + 2, ah[0], al[0]);
      wg::wait<0>();
      wg::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) out[i] += acc[i];
    }
    refill(v0 + n - 1);  // before the caller's epilogue
  }
};

// run's contract with split-TF32 chunks, one tile of Ring32: a_of(u) / b_of(u)
// give chunk u's A and its B hi image (lo follows b_bytes further, b_bytes at
// most Smem32<NT, NST>::B_HALF), n >= 2 and even; epilogue(sum) gets the f32 sum.
template <int NT, int NST, class AOf, class BOf, class Pro, class Epi>
__device__ __forceinline__ void run_tf32(unsigned char* smem, int n, AOf a_of, BOf b_of, uint32_t b_bytes,
                                         Pro prologue, Epi epilogue) {
  const auto of = [&](int u, const void*& a, const void*& b) {
    a = a_of(u);
    b = b_of(u);
  };
  const Ring32<NT, NST, decltype(of)> ring(smem, n, 1, b_bytes, of);
  ring.start(prologue);
  float sum[NT / 2];
  ring.product(sum, 0);
  epilogue(sum);
}

}  // namespace gemm
}  // namespace opp
