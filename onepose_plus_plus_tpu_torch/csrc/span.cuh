// Span copies in 16-byte chunks, shared by K3's span instance (gather.cu),
// K4's span sum (scatter.cu) and K6 (patch_gather.cu).
//
// In NHWC a run of neighbouring pixels is one contiguous span of bytes, for a
// pixel of P bytes. These kernels move such spans 16 aligned output bytes a
// lane whatever P is: the 16 bytes at output address A take their source
// bytes from A + delta on, delta being the span's distance from output to
// source; one aligned 16-byte load (ld.global.nc) where (A + delta) mod 16 is
// 0, else a second one where the chunk's source bytes run into it, and a
// funnel shift by (A + delta) mod 16. A first vector that holds no source
// byte (at the source's first bytes, a source at any 2-byte offset) is
// raised to the source's first aligned vector, so no load leaves the 16-byte
// blocks the source touches. A span's partial first and last chunks store
// their own 2-byte halves (every pointer and pixel here is whole halves).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace opp {

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

// The 16 source bytes from address src for a chunk whose bytes [lo, hi) are
// wanted (0 <= lo < hi <= 16): the aligned vector holding src (raised to
// vec_lo where it lies below it: it then holds no wanted byte) and, where src
// is not aligned and the wanted bytes run past that vector, the next one,
// funnel-shifted into place. Bytes outside [lo, hi) are undefined.
__device__ __forceinline__ uint4 load16(long long src, int hi, long long vec_lo) {
  const int o = (int)(src & 15);
  const long long f1 = src - o + 16, f0 = f1 - 16 < vec_lo ? vec_lo : f1 - 16;
  uint4 val = __ldg(reinterpret_cast<const uint4*>(f0));
  if (o != 0) {
    uint4 second = make_uint4(0u, 0u, 0u, 0u);
    if (o + hi > 16) second = __ldg(reinterpret_cast<const uint4*>(f1));
    val = funnel16(val, second, o);
  }
  return val;
}

// val with the bytes outside [lo, hi) zeroed (whole 2-byte halves).
__device__ __forceinline__ uint4 keep_bytes(uint4 val, int lo, int hi) {
  if (lo > 0 || hi < 16) {
    val.x &= half_mask(lo, hi, 0) | half_mask(lo, hi, 1);
    val.y &= half_mask(lo, hi, 2) | half_mask(lo, hi, 3);
    val.z &= half_mask(lo, hi, 4) | half_mask(lo, hi, 5);
    val.w &= half_mask(lo, hi, 6) | half_mask(lo, hi, 7);
  }
  return val;
}

// Store the bytes [s_lo, s_hi) of val to the aligned chunk p: one streaming
// 16-byte store (st.global.cs) where the chunk is whole, else its own 2-byte
// halves.
__device__ __forceinline__ void store_chunk(char* p, const uint4& val, int s_lo, int s_hi) {
  if (s_lo <= 0 && s_hi >= 16) {
    __stcs(reinterpret_cast<uint4*>(p), val);
  } else {
    const unsigned w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
    for (int h = 0; h < 8; ++h)
      if (2 * h >= s_lo && 2 * h < s_hi)
        reinterpret_cast<unsigned short*>(p)[h] = (unsigned short)(w[h >> 1] >> (16 * (h & 1)));
  }
}

constexpr int PATCH_THREADS = 128;  // a block a patch
constexpr int MAGIC_SHIFT = 48;     // a slot's patch row is (slot * magic) >> 48

// One W x W patch, rows r0 .. r0 + window - 1 and columns c0 .. c0 + window - 1
// of image b of the [., H, W, P bytes] map at feat, to dst (window rows of
// window * P bytes); taps off the map are zero. The block's PATCH_THREADS
// threads walk the patch's window * cmax chunk slots: slot t is chunk
// c = t - dr * cmax of patch row dr = (t * magic) >> 48 (magic =
// ceil(2^48 / cmax), exact while window * cmax^2 < 2^48), so nothing in the
// loop divides; a row's chunks are the aligned 16-byte output chunks from the
// one holding its first byte, cmax the most a row touches (chunk_slots).
// A patch row's map bytes are one span: its in-map taps, (ch - cl) * P bytes
// from pixel (row, cl); the clipped taps and rows off the map are zero.
__device__ __forceinline__ void copy_patch(const char* __restrict__ feat, char* __restrict__ dst,
                                           int b, long long r0, long long c0, int H, int W, int P,
                                           int window, int cmax, unsigned long long magic,
                                           long long vec_lo) {
  const int row = window * P;                        // bytes a patch row (a patch is under 2^31 bytes)
  const long long pitch = (long long)W * P;          // bytes an image row
  const int dmod = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  const long long src0 = reinterpret_cast<long long>(feat) + (long long)b * H * pitch + c0 * P;
  const long long cl = c0 > 0 ? c0 : 0, ch = c0 + window < W ? c0 + window : W;
  const int copy_lo = ch > cl ? (int)((cl - c0) * P) : 0;  // a row's map bytes: [copy_lo, copy_hi)
  const int copy_hi = ch > cl ? (int)((ch - c0) * P) : 0;
  const int T = window * cmax;
  // slot t: chunk c of patch row dr, the aligned 16 output bytes at patch offset a
  for (int t = threadIdx.x; t < T; t += PATCH_THREADS) {
    const int dr = (int)(((unsigned long long)t * magic) >> MAGIC_SHIFT);
    const int c = t - dr * cmax;
    const int start = dr * row;                      // the row: patch bytes [start, start + row)
    const int a = ((start + dmod) & ~15) - dmod + 16 * c;
    if (a >= start + row) continue;                  // a slot past the row's last chunk
    const int lo = start + copy_lo - a, hi = start + copy_hi - a;  // its map bytes, unclipped
    const long long r = r0 + dr;
    const bool copy = r >= 0 && r < H && copy_hi > copy_lo && hi > 0 && lo < 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (copy)  // the map address of the chunk's byte 0
      val = keep_bytes(load16(src0 + r * pitch + (a - start), hi, vec_lo), lo, hi);
    store_chunk(dst + a, val, start - a, start + row - a);
  }
}

// Chunk slots a patch row: the most 16-byte chunks a row of `row` bytes
// touches when rows start at multiples of gcd(row, 16) past an alignment.
inline long long chunk_slots(long long row) {
  int g = 16;
  while (row % g) g >>= 1;
  return (16 - g + row + 15) / 16;
}

}  // namespace opp
