// K-mer windows from ASCII rows, for Hopper (sm_90a): encode, six-frame
// translation and 8-mer packing, ending in each window's home slot and u16
// fingerprint (the sparse probe's inputs) or its packed value (the device
// prepare's). The fused step computes the same windows and probes for them
// in one launch (csrc/fused_probe.cu, which shares kmer_common.cuh).
//
// Replaces the device programs that the JAX package writes in XLA for the
// TPU: kmergutsjava_tpu/parallel/annotate_step.py _encode_and_probe (:52)
// and _dna_encode_and_probe (:96) up to the probe, with the ops they run
// (ops/encode.py aa_offsets, dna_codes, revcomp_codes; ops/translate.py
// translate_6frames; ops/kmerize.py kmer_windows and the residues of
// _window_homes_qfp), and parallel/seq_windows.py _window_probe (:98), the
// windowed form for one long contig. What they compute is kept; their TPU
// workarounds are not: the one-hot matrix-unit tables are a shared-memory
// index here, the int32 modular residues an int64 value.
//
// Contract (the plain twin is kmergutsjava_tpu_torch/ops/kmer_windows.py
// windows_reference, over ops/encode.py, translate.py and kmerize.py):
//   aa rows  ascii[B, Lpad], num_starts[B]: window j of row b covers
//            ascii[b, j..j+7], W = Lpad - 7 windows a row, valid when all
//            8 offsets are < 20 and j < num_starts[b] (the caller passes
//            length - 8: the reference skips a protein's last window);
//   DNA rows ascii[B, Lpad], lengths[B]: the six frames of row b
//            (+0 +1 +2 -0 -1 -2; frame f has (len - f)/3 codons, a reverse
//            frame reads base len-1-p complemented), W = Lpad/3 - 7
//            windows a frame, out[b, g, j], valid when all 8 offsets are
//            < 20 and j < max(len/3 - 7, 0); or, with row_map, own_start
//            and own_end [B, 6] (a long contig's windows,
//            parallel/seq_windows.py), container g reads frame
//            row_map[b, g] and is valid for own_start <= j < own_end.
// Outputs: homes (int32, value mod num_sigs, -1 for a window that is not
// valid, which the probe answers as off the plane without a read) and
// fingerprints (u16, value mod 65535, 0 where not valid); or values
// (int64, -1 where not valid).
//
// What bounds it. Each ASCII byte is read once and each window writes 6
// bytes (8 for values): bytes, at 3.35 TB/s. The work a window is a few
// dozen integer operations, below the byte bound at these shapes. So a
// block takes one row's tile of 256 windows and reads the bytes it needs
// once, coalesced, into shared memory through the tables (for DNA the
// tile's nucleotides of both strands, then its codons of all six frames),
// and each thread then packs one window (for DNA one window of each of the
// six containers) from shared memory and writes it coalesced.
//
// The two residues. A 64-bit % by a divisor known only at run time is a
// long software sequence on the card. A value is < 20^8 < 2^35, and for a
// divisor 5 <= d < 2^31 the reciprocal M = ceil(2^66 / d) fits 64 bits and
// gives the exact quotient floor(v * M / 2^66) for every v < 2^35: with
// e = M*d - 2^66 < d, v * M / 2^66 = v/d + v*e / (d * 2^66), and
// v*e < 2^35 * 2^31 = 2^66 keeps the excess below 1/d, so it never carries
// the remainder past d (the wrapper computes M, and a CPU test checks the
// identity). That is one 64-bit multiply-high and a multiply a window.
// The fingerprint's divisor is the constant 65535, which the compiler
// divides by a multiply itself.
// Divisors below 5 (tables of under 5 slots) take the plain %.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkmer_windows.so kmer_windows.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/ops/kmer_windows.py.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "kmer_common.cuh"  // Luts, residue, pack_window, kK

namespace {

constexpr int kThreads = 256;             // windows a block: one row's tile
constexpr int kSpan = kThreads + kK - 1;  // aa offsets a tile reads
// nucleotides of one strand a DNA tile reads: frame f <= 2, codon
// j0 + jj with jj <= kSpan - 1, base t <= 2
constexpr int kNt = 2 + 3 * (kSpan - 1) + 2 + 1;
static_assert(kThreads == 256, "a block copies one table entry a thread");

struct Out {
  int32_t* homes;   // null in values mode
  uint16_t* fps;
  int64_t* values;  // null in homes mode
  uint64_t ns;      // num_sigs
  uint64_t magic;   // ceil(2^66 / ns), or 0 for ns < 5
};

// One window from its 8 offsets in shared memory: its value, or its home
// and fingerprint, written at ``at``; -1 (home 0 fingerprint) when it is
// not valid.
__device__ __forceinline__ void emit(const uint8_t* a, bool ok, const Out& o,
                                     int64_t at) {
  const uint64_t v = pack_window(a, ok);
  if (o.values) {
    o.values[at] = ok ? static_cast<int64_t>(v) : -1;
  } else if (ok) {
    o.homes[at] = static_cast<int32_t>(residue(v, o.ns, o.magic));
    o.fps[at] = static_cast<uint16_t>(v % kFpMod);
  } else {
    o.homes[at] = -1;
    o.fps[at] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
aa_windows_kernel(Luts L, const uint8_t* __restrict__ ascii, int64_t lpad,
                  int64_t tiles, int64_t w,
                  const int32_t* __restrict__ num_starts, Out o) {
  __shared__ uint8_t lut[256];
  __shared__ uint8_t offs[kSpan];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x / tiles;
  const int64_t j0 = (blockIdx.x % tiles) * kThreads;
  lut[t] = L.aa[t];
  __syncthreads();
  const uint8_t* row = ascii + b * lpad;
  for (int i = t; i < kSpan; i += kThreads) {
    const int64_t p = j0 + i;
    offs[i] = p < lpad ? lut[row[p]] : kTerminator;
  }
  __syncthreads();
  const int64_t j = j0 + t;
  if (j < w) emit(offs + t, j < num_starts[b], o, b * w + j);
}

__global__ void __launch_bounds__(kThreads)
dna_windows_kernel(Luts L, const uint8_t* __restrict__ ascii, int64_t lpad,
                   int64_t tiles, int64_t w,
                   const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ row_map,
                   const int32_t* __restrict__ own_start,
                   const int32_t* __restrict__ own_end, Out o) {
  __shared__ uint8_t code[256], comp[256], codon[64];
  __shared__ uint8_t nt[2][kNt];       // the tile's bases, both strands
  __shared__ uint8_t frames[6][kSpan];  // the tile's codons, six frames
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x / tiles;
  const int64_t j0 = (blockIdx.x % tiles) * kThreads;
  code[t] = L.dna[t];
  comp[t] = L.compl_[t];
  if (t < 64) codon[t] = L.codon[t];
  __syncthreads();
  const int64_t len = lengths[b];
  const uint8_t* row = ascii + b * lpad;
  // strand position p = 3*j0 + i: the forward strand reads base p, the
  // reverse strand base len-1-p complemented; reads off the row are
  // invalid bases
  for (int i = t; i < kNt; i += kThreads) {
    const int64_t pf = 3 * j0 + i;
    const int64_t pr = len - 1 - pf;
    nt[0][i] = pf < lpad ? code[row[pf]] : kInvalidDna;
    nt[1][i] = pr >= 0 && pr < lpad ? comp[row[pr]] : kInvalidDna;
  }
  __syncthreads();
  for (int i = t; i < 6 * kSpan; i += kThreads) {
    const int r = i / kSpan, jj = i % kSpan, f = r % 3;
    const int64_t ncod = (len > f ? len - f : 0) / 3;
    uint8_t a = kTerminator;
    if (j0 + jj < ncod) {
      const uint8_t* c = nt[r / 3] + f + 3 * jj;
      a = c[0] < 4 && c[1] < 4 && c[2] < 4
              ? codon[c[0] * 16 + c[1] * 4 + c[2]]
              : kInvalidAa;
    }
    frames[r][jj] = a;
  }
  __syncthreads();
  const int64_t j = j0 + t;
  if (j >= w) return;
  const int64_t starts = len / 3 - kK + 1;
#pragma unroll
  for (int g = 0; g < 6; ++g) {
    int r = g;
    bool ok = j < starts;
    if (row_map) {
      r = row_map[b * 6 + g];
      ok = r >= 0 && r < 6 && j >= own_start[b * 6 + g] &&
           j < own_end[b * 6 + g];
      r = ok ? r : 0;
    }
    emit(&frames[r][t], ok, o, (b * 6 + g) * w + j);
  }
}

bool grid_of(int64_t rows, int64_t w, int64_t* tiles, unsigned* blocks) {
  *tiles = (w + kThreads - 1) / kThreads;
  const int64_t n = rows * *tiles;
  if (n >= (1LL << 31)) return false;
  *blocks = static_cast<unsigned>(n);
  return true;
}

Out out_of(int64_t num_sigs, uint64_t magic, void* homes, void* fps,
           void* values) {
  return Out{static_cast<int32_t*>(homes), static_cast<uint16_t*>(fps),
             static_cast<int64_t*>(values),
             static_cast<uint64_t>(num_sigs), magic};
}

bool bad_out(int64_t num_sigs, void* homes, void* fps, void* values) {
  return values ? false : (!homes || !fps || num_sigs < 1);
}

}  // namespace

extern "C" {

// Launches on ``stream``; returns a CUDA error code (0 = the launch was
// accepted). ``luts``: the 832 host bytes of struct Luts. Homes and
// fingerprints are written when ``values`` is null, else values.
int kmer_windows_aa(const void* luts, const void* ascii, int64_t rows,
                    int64_t lpad, const void* num_starts, int64_t num_sigs,
                    uint64_t magic, void* homes, void* fps, void* values,
                    void* stream) {
  const int64_t w = lpad - (kK - 1);
  if (rows < 0 || lpad < 0 || bad_out(num_sigs, homes, fps, values))
    return cudaErrorInvalidValue;
  if (rows == 0 || w <= 0) return cudaSuccess;
  int64_t tiles;
  unsigned blocks;
  if (!grid_of(rows, w, &tiles, &blocks)) return cudaErrorInvalidValue;
  Luts L;
  std::memcpy(&L, luts, sizeof(L));
  aa_windows_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<const uint8_t*>(ascii), lpad, tiles, w,
      static_cast<const int32_t*>(num_starts),
      out_of(num_sigs, magic, homes, fps, values));
  return static_cast<int>(cudaGetLastError());
}

// DNA rows; row_map, own_start and own_end all null (whole contigs) or all
// given (a long contig's windows).
int kmer_windows_dna(const void* luts, const void* ascii, int64_t rows,
                     int64_t lpad, const void* lengths, const void* row_map,
                     const void* own_start, const void* own_end,
                     int64_t num_sigs, uint64_t magic, void* homes,
                     void* fps, void* values, void* stream) {
  const int64_t w = lpad / 3 - (kK - 1);
  const bool windowed = row_map != nullptr;
  if (rows < 0 || lpad < 0 || bad_out(num_sigs, homes, fps, values) ||
      windowed != (own_start != nullptr) || windowed != (own_end != nullptr))
    return cudaErrorInvalidValue;
  if (rows == 0 || w <= 0) return cudaSuccess;
  int64_t tiles;
  unsigned blocks;
  if (!grid_of(rows, w, &tiles, &blocks)) return cudaErrorInvalidValue;
  Luts L;
  std::memcpy(&L, luts, sizeof(L));
  dna_windows_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<const uint8_t*>(ascii), lpad, tiles, w,
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(row_map),
      static_cast<const int32_t*>(own_start),
      static_cast<const int32_t*>(own_end),
      out_of(num_sigs, magic, homes, fps, values));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
