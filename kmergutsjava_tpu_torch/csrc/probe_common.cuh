// Device helpers shared by the window probes of the u16 fingerprint plane:
// csrc/tilejoin.cu (the sparse first-event probe, B1), csrc/block_probe.cu
// (the block probe, B3), and through probe_answers.cuh csrc/shard_probe.cu
// (B12) and csrc/fused_probe.cu. A window is read as aligned 16-byte
// vectors of 8 slots and compared two slots a 32-bit word.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Bit 15 (bit 31) set where the low (high) 16-bit half of x is zero: exact
// per half, since the sum never carries across halves.
__device__ __forceinline__ uint32_t zero_halves(uint32_t x) {
  return ~(((x & 0x7FFF7FFFu) + 0x7FFF7FFFu) | x) & 0x80008000u;
}

// The per-slot flags of one 16-byte vector (8 slots, 4 words; the low half
// of a word is the lower slot), from zero_halves of each word, as bits 0..7.
__device__ __forceinline__ uint32_t slot_flags(uint32_t z0, uint32_t z1,
                                               uint32_t z2, uint32_t z3) {
  // one byte a slot, 0x80 or 0: slots 0..3 and 4..7
  const uint32_t a = __byte_perm(z0, z1, 0x7531);
  const uint32_t b = __byte_perm(z2, z3, 0x7531);
  // slot k's flag at bit 8k (k < 4) or 8(k - 4) + 4; the multiply moves
  // them to bits 21..28 in slot order, with no two partial products on
  // the same bit
  return (((a >> 7) | (b >> 3)) * 0x00204081u) >> 21 & 0xFFu;
}

// Plane slots [8k - shift, 8k - shift + 8), as one aligned vector where it
// lies inside the plane, else slot by slot (0 outside the plane, which no
// window reads).
__device__ __forceinline__ uint4 load_vec(const uint16_t* __restrict__ abase,
                                          int64_t k, int64_t shift,
                                          int64_t plane_len) {
  const int64_t lo = 8 * k - shift;
  if (lo >= 0 && lo + 8 <= plane_len)
    return __ldg(reinterpret_cast<const uint4*>(abase) + k);
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = lo + i >= 0 && lo + i < plane_len ? __ldg(abase + 8 * k + i) : 0;
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                    h[6] | h[7] << 16);
}

struct Plane {
  const uint16_t* abase;  // fp - shift, 16-byte aligned
  int64_t shift;          // slots of fp before its first aligned vector
  int64_t len;
  int32_t w;
};

}  // namespace
