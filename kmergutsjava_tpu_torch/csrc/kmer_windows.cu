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
//   ragged   the device prepare's entry (--prepare jax): rows unpadded,
//            concatenated in bytes[bounds[R]], row r = bytes[bounds[r],
//            bounds[r+1]); containers are the rows (aa) or each row's six
//            frames (DNA, 6r + g). Only the valid windows come out,
//            compacted in the order np.nonzero gives the padded values
//            (container, then position): each one's value (int64) and
//            position (int32), and each container's count of them.
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
// The ragged entry (replacing, for the device prepare, the padded values
// launches of the JAX prepare's power-of-two buckets, models/prepare.py
// prepare_aa and prepare_dna, and their compaction on the host) writes 12
// bytes a valid window and reads each byte once, so it too is bound by
// bytes; at the prepare's launches (a few MB of rows) that is a few
// microseconds, as long as a block's chain of dependent trips to device
// memory is short and paid by many windows. Positions run over the bytes
// (aa: one a byte, its window starting there; DNA: two a byte, so that a
// row's six frames of len/3 codon positions fit its 2 * len positions),
// so a block finds its positions' rows from the row bounds alone: a warp
// searches bounds for its first row (32 probes a step), the block keeps the
// next 256 row bounds in shared memory, and each thread walks them along
// its positions (past the table, a binary search of bounds). A block
// takes 2,048 consecutive positions across rows, eight a thread, and
// stages the amino-acid offsets they read (the fused kernel's staging: aa
// bytes through the table, DNA codons each made once from three bases).
// Two kernels a call: ragged_zero (the counts and the blocks' status words
// to 0) and ragged_pass, in which a block ranks its valid windows by warp
// ballots and a scan of its 64 (round, warp) counts, posts its count, and
// learns the count of the blocks before it by a decoupled look-back (the
// statuses of the 32 blocks before it at a time, by one warp), then packs
// its windows again from the stage and writes them in order there, with
// each position's container and place read back from shared memory (32
// registers a thread, so more blocks an SM hide the chain); a container's
// count is added by a warp-aggregated atomic. Measured in turns by
// chip_turns.py on an H100 80GB HBM3 (700 W; PERF.md, Findings), device
// time of a whole prepare's calls: the E. coli proteome 0.041 ms in one
// call, the read set 0.38 in five, against 0.131 and 0.938 for the JAX
// batching's 29 and 6 padded launches (whose values the host then read
// back whole and compacted). Slower: a count pass, a scan of the blocks'
// counts and a write pass (0.050 / 0.66); the values kept in registers
// (0.044 / 0.45, 64 registers); 4 or 16 positions a thread; five blocks
// an SM forced (spills); a DNA row's bases staged in shared memory; the
// counts by lane runs in place of __match_any_sync. Loading the
// proteome's bytes before the row search, and a DNA frame by compares,
// took 0.061 to 0.050 in the three-pass form.
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

#include <algorithm>
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

// --- the ragged entry ---

constexpr int kRounds = 8;                   // positions a thread
constexpr int kTileN = kThreads * kRounds;   // positions a block
constexpr int kTileStaged = kTileN + kK - 1;
constexpr int kTable = 256;                  // row bounds a block keeps
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = kRounds * kWarps / 32;  // (round, warp) counts
static_assert(kRounds * kWarps % 32 == 0, "whole runs of counts a lane");

struct Ragged {
  const uint8_t* bytes;   // the rows, concatenated
  const int32_t* bounds;  // [rows + 1]
  int32_t rows;
  int32_t slots;          // positions: bytes (aa) or 2 * bytes (DNA)
};

// Inclusive sum of x over the warp's lanes.
__device__ __forceinline__ int32_t warp_inclusive(int32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The last row r < rows with bounds[r] <= p, for a byte p < bounds[rows]
// (so a row that holds p: an empty row before it starts at p too);
// called by a whole warp, 32 probes a step.
__device__ int warp_find_row(const Ragged& R, int32_t p) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = R.rows;  // bounds[lo] <= p < bounds[hi]
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const unsigned le =
        __ballot_sync(0xFFFFFFFFu, i < hi && __ldg(R.bounds + i) <= p);
    lo += (31 - __clz(le)) * step;  // lane 0 probes lo itself
    hi = min(lo + step, hi);
  }
  return lo;
}

struct RowAt {
  int32_t r, start, len;
};

// The row that holds byte p: from the block's table tb (the bounds of rows
// r0 .. r0 + kTable, INT32_MAX past the last), walking on from table index
// k (a thread's positions only grow), or past the table by a binary search
// of bounds.
__device__ __forceinline__ RowAt row_at(const Ragged& R, const int32_t* tb,
                                        int r0, int32_t p, int& k) {
  if (p < tb[kTable]) {
    while (tb[k + 1] <= p) ++k;
    return RowAt{r0 + k, tb[k], tb[k + 1] - tb[k]};
  }
  int lo = r0 + kTable, hi = R.rows;  // bounds[lo] <= p
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(R.bounds + mid) <= p)
      lo = mid;
    else
      hi = mid;
  }
  const int32_t s = __ldg(R.bounds + lo);
  return RowAt{lo, s, __ldg(R.bounds + lo + 1) - s};
}

// The table index to start a thread's walk at, for its first byte p.
__device__ __forceinline__ int table_index(const int32_t* tb, int32_t p) {
  int lo = 0, hi = kTable;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tb[mid] <= p)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// Codon j of frame g (+0 +1 +2 -0 -1 -2) of a row of len >= 3 bases: a
// reverse frame reads base len-1-p complemented; past the frame's
// (len - f)/3 codons, a terminator.
__device__ __forceinline__ uint8_t codon_at(const uint8_t* row, int32_t len,
                                            int g, int32_t j,
                                            const uint8_t* code,
                                            const uint8_t* comp,
                                            const uint8_t* codon) {
  const int f = g % 3;
  if (j >= (len - f) / 3) return kTerminator;
  const int32_t p = f + 3 * j;
  uint32_t x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    x[k] = g < 3 ? code[__ldg(row + p + k)]
                 : comp[__ldg(row + len - 1 - (p + k))];
  return x[0] < 4 && x[1] < 4 && x[2] < 4 ? codon[x[0] * 16 + x[1] * 4 + x[2]]
                                          : kInvalidAa;
}

// Position s's window: its container, its position in the container, and
// whether it is in range (its offsets still to check).
struct Win {
  int32_t c, j;
  bool in_range;
};

// A block's share of the ragged entry: its row table, its staged offsets
// and its positions' containers and places (position s0 + i; a thread
// takes i = q * kThreads + t for q < kRounds).
template <bool kAa>
struct Tile {
  uint8_t lut[256], comp[256], codon[64];
  uint8_t offs[kTileStaged];
  int32_t tb[kTable + 1];
  int32_t r0;
  int32_t wc[kRounds * kWarps];  // valid windows a (round, warp)
  int32_t c_of[kTileN], j_of[kTileN];
};

// A thread's aa bytes of the tile (staging entry q * kThreads + t), read
// before the block knows its rows: they do not depend on them.
__device__ __forceinline__ void preload(const Ragged& R, int32_t s0,
                                        uint8_t* raw) {
#pragma unroll
  for (int q = 0; q <= kRounds; ++q) {
    const int32_t s = s0 + q * kThreads + static_cast<int>(threadIdx.x);
    raw[q] = s < R.slots ? __ldg(R.bytes + s) : 0;
  }
}

// Stages the tile's offsets (aa: from the preloaded bytes) and its
// positions' containers and places, and whether each of the thread's
// windows is in range (the block's row r0 in T.r0 and the lookup tables
// loaded); ends with a barrier.
template <bool kAa>
__device__ __forceinline__ void stage(const Ragged& R, Tile<kAa>& T,
                                      int32_t s0, const uint8_t* raw,
                                      bool* in_range) {
  const int t = threadIdx.x;
  const int r0 = T.r0;
  for (int k = t; k <= kTable; k += kThreads)
    T.tb[k] = r0 + k <= R.rows ? __ldg(R.bounds + r0 + k) : INT32_MAX;
  __syncthreads();
  const int32_t shift = kAa ? 0 : 1;
  int k = 0;
  if ((s0 + t) < R.slots && ((s0 + t) >> shift) < T.tb[kTable])
    k = table_index(T.tb, (s0 + t) >> shift);
#pragma unroll
  for (int q = 0; q <= kRounds; ++q) {
    const int i = q * kThreads + t;
    if (q == kRounds && i >= kTileStaged) break;
    const int32_t s = s0 + i;
    Win w{0, 0, false};
    uint8_t a = kTerminator;
    if (s < R.slots) {
      const RowAt row = row_at(R, T.tb, r0, s >> shift, k);
      if (kAa) {
        a = T.lut[raw[q]];
        w = Win{row.r, s - row.start, s - row.start < row.len - kK};
      } else {
        const int32_t m = row.len / 3;
        const int32_t u = s - 2 * row.start;
        if (u < 6 * m) {
          // u / m (< 6) by compares, not a run-time division
          const int g = (u >= m) + (u >= 2 * m) + (u >= 3 * m) +
                        (u >= 4 * m) + (u >= 5 * m);
          const int32_t j = u - g * m;
          w = Win{6 * row.r + g, j, j < m - kK + 1};
          a = codon_at(R.bytes + row.start, row.len, g, j, T.lut, T.comp,
                       T.codon);
        }
      }
    }
    T.offs[i] = a;
    if (q < kRounds) {
      in_range[q] = w.in_range;
      T.c_of[i] = w.c;
      T.j_of[i] = w.j;
    }
  }
  __syncthreads();
}

template <bool kAa>
__device__ __forceinline__ void load_tables(const Luts& L, Tile<kAa>& T) {
  const int t = threadIdx.x;
  T.lut[t] = kAa ? L.aa[t] : L.dna[t];
  if (!kAa) {
    T.comp[t] = L.compl_[t];
    if (t < 64) T.codon[t] = L.codon[t];
  }
}

// A tile's status word: its flag (0 not yet, 1 its own count, 2 the
// count of it and every tile before it) over the count.
constexpr uint64_t kOwn = 1ull << 32, kUpTo = 2ull << 32;

// status[tiles] and counts[containers] to 0.
__global__ void __launch_bounds__(kThreads)
ragged_zero_kernel(uint64_t* __restrict__ status, int64_t tiles,
                   int32_t* __restrict__ counts, int64_t containers) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t k = i; k < tiles; k += step) status[k] = 0;
  for (int64_t k = i; k < containers; k += step) counts[k] = 0;
}

// The valid windows before tile t (t > 0), by warp 0 of its block, from
// the status words of the tiles before it, 32 at a time from the nearest
// (a tile's own count until one holds the count up to it); spins while
// one of them has none yet. Blocks start in tile order, so every tile
// before t is running or done, and a running one posts its own count
// without waiting.
__device__ int32_t look_back(const uint64_t* status, int t) {
  const int lane = threadIdx.x & 31;
  int32_t sum = 0;
  for (int p = t - 1;;) {
    const int i = p - lane;
    const uint64_t st =
        i >= 0 ? *reinterpret_cast<const volatile uint64_t*>(status + i)
               : kUpTo;
    const unsigned up_to = __ballot_sync(0xFFFFFFFFu, st >= kUpTo);
    const unsigned none = __ballot_sync(0xFFFFFFFFu, st < kOwn);
    const unsigned need = up_to ? (up_to & -up_to) * 2 - 1 : 0xFFFFFFFFu;
    if (none & need) continue;  // a tile it needs has posted nothing yet
    int32_t x = (1u << lane) & need ? static_cast<int32_t>(st) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, d);
    sum += x;
    if (up_to) return sum;
    p -= 32;
  }
}

// Each block's valid windows, in order, at the count of the valid windows
// of the tiles before it, which it learns by a decoupled look-back (its
// own count posted first); each container's count added to counts; the
// last tile writes the total.
template <bool kAa>
__global__ void __launch_bounds__(kThreads)
ragged_pass_kernel(Luts L, Ragged R, uint64_t* __restrict__ status,
                   int32_t* __restrict__ total, int64_t* __restrict__ values,
                   int32_t* __restrict__ pos, int32_t* __restrict__ counts) {
  __shared__ Tile<kAa> T;
  __shared__ int32_t base;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x;
  const int32_t s0 = static_cast<int32_t>(tile) * kTileN;
  uint8_t raw[kRounds + 1];
  if (kAa) preload(R, s0, raw);
  load_tables(L, T);
  if (warp == 0) {
    const int r0 = warp_find_row(R, s0 >> (kAa ? 0 : 1));
    if (lane == 0) T.r0 = r0;
  }
  __syncthreads();
  bool in_range[kRounds];
  stage(R, T, s0, raw, in_range);
  unsigned ballot[kRounds];  // the valid windows of a (round, warp)
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    bool ok = in_range[q];
    pack_window(T.offs + q * kThreads + t, ok);
    ballot[q] = __ballot_sync(0xFFFFFFFFu, ok);
    if (lane == 0) T.wc[q * kWarps + warp] = __popc(ballot[q]);
  }
  __syncthreads();
  // exclusive prefix of the (round, warp) counts in position order, a
  // run of kPerLane of them a lane of warp 0; then the tile's offset
  if (warp == 0) {
    int32_t c[kPerLane], sum = 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      c[k] = T.wc[kPerLane * lane + k];
      sum += c[k];
    }
    int32_t x = warp_inclusive(sum, lane) - sum;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      T.wc[kPerLane * lane + k] = x;
      x += c[k];
    }
    const int32_t own = __shfl_sync(0xFFFFFFFFu, x, 31);
    volatile uint64_t* mine = status + tile;
    int32_t before = 0;
    if (tile == 0) {
      if (lane == 0) *mine = kUpTo | static_cast<uint32_t>(own);
    } else {
      if (lane == 0) *mine = kOwn | static_cast<uint32_t>(own);
      before = look_back(status, tile);
      if (lane == 0) *mine = kUpTo | static_cast<uint32_t>(before + own);
    }
    if (lane == 0) {
      base = before;
      if (tile == static_cast<int>(gridDim.x) - 1) *total = before + own;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int i = q * kThreads + t;
    bool ok = ballot[q] >> lane & 1u;
    if (ok) {
      const int32_t o =
          base + T.wc[q * kWarps + warp] + __popc(ballot[q] & below);
      values[o] = static_cast<int64_t>(pack_window(T.offs + i, ok));
      pos[o] = T.j_of[i];
    }
    const unsigned same = __match_any_sync(0xFFFFFFFFu, ok ? T.c_of[i] : -1);
    if (ok && (same & below) == 0) atomicAdd(counts + T.c_of[i], __popc(same));
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

// The ragged entry: rows[bounds[rows]] concatenated, ``aa`` or DNA. Outputs
// values and pos (room for every position: bytes (aa) or 2 * bytes (DNA);
// the first ``total`` hold the valid windows), counts[containers] (rows,
// or 6 * rows) and scratch[2 * tiles + 1] (tiles = ceil(positions /
// kmer_values_tile()): the tiles' 8-byte status words, then the total).
// Two launches on ``stream``; the bounds must run from 0 to n_bytes,
// never down.
int kmer_values_ragged(const void* luts, int aa, const void* bytes,
                       int64_t n_bytes, const void* bounds, int64_t rows,
                       void* values, void* pos, void* counts, void* scratch,
                       void* stream) {
  if (n_bytes < 0 || n_bytes >= (1LL << 30) || rows < 0 ||
      rows >= (1LL << 28))
    return cudaErrorInvalidValue;
  const int64_t slots = aa ? n_bytes : 2 * n_bytes;
  if (slots == 0) return cudaSuccess;
  const int64_t tiles = (slots + kTileN - 1) / kTileN;
  const Ragged R{static_cast<const uint8_t*>(bytes),
                 static_cast<const int32_t*>(bounds),
                 static_cast<int32_t>(rows), static_cast<int32_t>(slots)};
  Luts L;
  std::memcpy(&L, luts, sizeof(L));
  const auto st = static_cast<cudaStream_t>(stream);
  auto* status = static_cast<uint64_t*>(scratch);
  int32_t* total = static_cast<int32_t*>(scratch) + 2 * tiles;
  auto* v = static_cast<int64_t*>(values);
  auto* p = static_cast<int32_t*>(pos);
  auto* c = static_cast<int32_t*>(counts);
  const auto blocks = static_cast<unsigned>(tiles);
  const int64_t containers = aa ? rows : 6 * rows;
  const int64_t most = tiles > containers ? tiles : containers;
  const auto zero_blocks = static_cast<unsigned>(
      std::min<int64_t>((most + kThreads - 1) / kThreads, 1024));
  ragged_zero_kernel<<<zero_blocks, kThreads, 0, st>>>(status, tiles, c,
                                                       containers);
  if (aa)
    ragged_pass_kernel<true><<<blocks, kThreads, 0, st>>>(L, R, status,
                                                          total, v, p, c);
  else
    ragged_pass_kernel<false><<<blocks, kThreads, 0, st>>>(L, R, status,
                                                           total, v, p, c);
  return static_cast<int>(cudaGetLastError());
}

// Positions a block of the ragged entry takes (its scratch's tile).
int kmer_values_tile() { return kTileN; }

}  // extern "C"
