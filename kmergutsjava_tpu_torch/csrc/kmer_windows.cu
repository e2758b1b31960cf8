// The device prepare's k-mer windows (--prepare jax), for Hopper (sm_90a):
// encode, six-frame translation and 8-mer packing of unpadded ASCII rows,
// ending in the valid windows' packed values, compacted on the card. The
// fused step computes the same windows and probes for them in one launch
// (csrc/fused_probe.cu, which shares kmer_common.cuh).
//
// Replaces the device programs that the JAX package writes in XLA for the
// TPU to prepare queries: the values of kmergutsjava_tpu/ops/kmerize.py
// kmer_windows and kmer_window_mods over the power-of-two buckets of
// padded rows that models/prepare.py prepare_aa and prepare_dna launch,
// with the ops they run (ops/encode.py aa_offsets, dna_codes,
// revcomp_codes; ops/translate.py translate_6frames), and the compaction
// of their valid windows on the host. What they compute is kept; their TPU
// workarounds are not: the one-hot matrix-unit tables are a shared-memory
// index here.
//
// Contract (the plain twin is kmergutsjava_tpu_torch/ops/kmer_windows.py
// ragged_values_reference, over windows_reference and ops/encode.py,
// translate.py and kmerize.py): rows unpadded, concatenated in
// bytes[bounds[R]], row r = bytes[bounds[r], bounds[r+1]); containers are
// the rows (aa) or each row's six frames (DNA, 6r + g: +0 +1 +2 -0 -1 -2;
// frame f has (len - f)/3 codons, a reverse frame reads base len-1-p
// complemented). Window j of a container covers its amino acids j..j+7
// and is valid when all 8 are amino acids (offsets < 20) and j < len - 8
// (aa: the reference skips a protein's last window) or j < len/3 - 7
// (DNA). Only the valid windows come out, compacted in the order
// np.nonzero gives the padded values (container, then position): each
// one's value (int64) and position (int32), and each container's count of
// them.
//
// What bounds it. It reads each byte once and writes 12 bytes a valid
// window; the work a window is a few dozen integer operations, below the
// byte bound. At the prepare's launches (a few MB of rows) that is a few
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
// call, the read set 0.38 in five, against 0.131 and 0.938 for the 29 and
// 6 padded launches of the JAX batching that this entry replaced (whose
// values the host then read back whole and compacted). Slower: a count
// pass, a scan of the blocks' counts and a write pass (0.050 / 0.66); the
// values kept in registers (0.044 / 0.45, 64 registers); 4 or 16
// positions a thread; five blocks an SM forced (spills); a DNA row's bases
// staged in shared memory; the counts by lane runs in place of
// __match_any_sync. Loading the proteome's bytes before the row search,
// and a DNA frame by compares, took 0.061 to 0.050 in the three-pass form.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkmer_windows.so kmer_windows.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/ops/kmer_windows.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "kmer_common.cuh"  // Luts, pack_window, kK

namespace {

constexpr int kThreads = 256;  // threads a block
static_assert(kThreads == 256, "a block copies one table entry a thread");

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

}  // namespace

extern "C" {

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
