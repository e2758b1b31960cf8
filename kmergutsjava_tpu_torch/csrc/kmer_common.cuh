// The reference's k-mer window arithmetic on the card, shared by the window
// kernel (csrc/kmer_windows.cu) and the fused step's kernel
// (csrc/fused_probe.cu): the encoding tables, an 8-mer's packed value and
// its home residue by an exact reciprocal.
//
// The residue. A 64-bit % by a divisor known only at run time is a long
// software sequence on the card. A value is < 20^8 < 2^35, and for a
// divisor 5 <= d < 2^31 the reciprocal M = ceil(2^66 / d) fits 64 bits and
// gives the exact quotient floor(v * M / 2^66) for every v < 2^35: with
// e = M*d - 2^66 < d, v * M / 2^66 = v/d + v*e / (d * 2^66), and
// v*e < 2^35 * 2^31 = 2^66 keeps the excess below 1/d, so it never carries
// the remainder past d (the wrapper, ops/kmer_windows.py reciprocal,
// computes M, and a CPU test checks the identity). That is one 64-bit
// multiply-high and a multiply a window. The fingerprint's divisor is the
// constant 65535, which the compiler divides by a multiply itself.
// Divisors below 5 (tables of under 5 slots) take the plain %.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 8;
constexpr uint8_t kInvalidDna = 4, kInvalidAa = 20, kTerminator = 21;
constexpr uint64_t kFpMod = 65535;

// The reference's tables, copied from the wrapper a launch (by value, as a
// kernel argument) into shared memory by each block.
struct Luts {
  uint8_t aa[256];     // ASCII -> amino-acid offset (20 = invalid)
  uint8_t dna[256];    // ASCII -> base code (4 = invalid)
  uint8_t compl_[256]; // ASCII -> base code of its complement
  uint8_t codon[64];   // codon index -> amino-acid offset
};

// v mod ns: floor(v * magic / 2^66) is v's exact quotient for v < 2^35 and
// magic = ceil(2^66 / ns); magic 0 (ns < 5) takes the plain %.
__device__ __forceinline__ uint32_t residue(uint64_t v, uint64_t ns,
                                            uint64_t magic) {
  if (magic == 0) return static_cast<uint32_t>(v % ns);
  const uint64_t q = __umul64hi(v, magic) >> 2;
  return static_cast<uint32_t>(v - q * ns);
}

// The packed value of the 8-mer at offsets a[0..7]; ``ok`` is cleared
// where an offset is not an amino acid (>= 20).
__device__ __forceinline__ uint64_t pack_window(const uint8_t* a, bool& ok) {
  uint32_t hi = 0, lo = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ok &= a[k] < 20;
    ok &= a[k + 4] < 20;
    hi = hi * 20 + a[k];
    lo = lo * 20 + a[k + 4];
  }
  return static_cast<uint64_t>(hi) * 160000u + lo;
}

}  // namespace
