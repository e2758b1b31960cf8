// The stream lookup's per-query stages on the card (wrappers and plain
// PyTorch twins: lookup/stream_tiles.py). A pass keeps its tiles, answers
// and occupancy in device memory; the host sends up only the query
// values and reads back one int32 a query.
//
// stream_scatter: one thread a query places it in its home slot's tile
// cells, as native/scatter.cpp scatter_chunk does on the host. home =
// v mod num_sigs, fingerprint = v mod 65535. A query whose fingerprint
// already sits in one of its home's taken channels shares that cell
// (coverage repeats 8-mers, across the chunks of a pass too, so this
// keeps a home's C channels for distinct values); else it claims the next
// channel; past C channels it is marked overflow (-1). Its channel goes to
// res[i]. Channel order follows the threads' race, not the host's
// encounter order: any split is valid as long as every placed query's
// cell holds its fingerprint. Unused cells stay 0 (the probe's presence
// bitmap skips them).
//
// A home's occupancy is one byte of occ[S] (S = slots, a multiple of 4),
// claimed by a 32-bit CAS on the word that holds it: the low seven bits
// count the taken channels, the top bit marks a channel being written. A
// claimant sets count + 1 and the mark in one CAS, writes its cell, fences
// and clears the mark; a reader that sees the mark spins until it clears,
// so it never reads a taken channel before its fingerprint is there (and
// never takes a second channel for a value whose cell is being written).
// The writer's critical section is a store and a fence; independent
// thread scheduling (sm_70 and later) lets it finish while others of its
// warp spin.
//
// stream_resolve: one thread a query does what scatter.cpp resolve_one
// does on the host, in device memory: the query's packed byte of the
// probe's answers, the stop-at-empty gate from the empty-distance plane
// fe, verification against the resident k-mer column hk, and the exact
// full-window scan for overflow, fingerprint collisions and windows with
// no empty slot. res[i] (its channel in) becomes its table slot, or -1
// for a miss. counts[0..2] gain the block's overflow queries, the queries
// sent to the full-window scan, and the hits (one atomic each a block).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kFpMod = 65535;
constexpr uint32_t kBusy = 0x80;
constexpr int kMaxChannels = 64;

__global__ void __launch_bounds__(kThreads)
    stream_scatter_kernel(const int64_t* __restrict__ values, int64_t n,
                   int64_t num_sigs, int64_t slots, int32_t channels,
                   uint16_t* tiles, unsigned int* occ,
                   int32_t* __restrict__ res) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int64_t v = values[i];
    const int64_t h = v % num_sigs;
    const uint16_t fp = static_cast<uint16_t>(v % kFpMod);
    unsigned int* const word = occ + (h >> 2);
    const uint32_t sh = 8u * static_cast<uint32_t>(h & 3);
    volatile uint16_t* const cell = tiles + h;
    int32_t got;
    while (true) {
      const uint32_t wv = *reinterpret_cast<volatile unsigned int*>(word);
      const uint32_t o = (wv >> sh) & 0xFFu;
      if (o & kBusy) continue;  // a channel of this home is being written
      __threadfence();          // its cells are read after the count
      const int32_t live = static_cast<int32_t>(o);
      int32_t c = 0;
      while (c < live && cell[static_cast<int64_t>(c) * slots] != fp) ++c;
      if (c < live) {
        got = c;
        break;
      }
      if (live >= channels) {  // every channel taken by another value
        got = -1;
        break;
      }
      const uint32_t nw = (wv & ~(0xFFu << sh)) | ((o + 1u) | kBusy) << sh;
      if (atomicCAS(word, wv, nw) != wv) continue;
      cell[static_cast<int64_t>(live) * slots] = fp;
      __threadfence();
      atomicAnd(word, ~(kBusy << sh));
      got = live;
      break;
    }
    res[i] = got;
  }
}

__global__ void __launch_bounds__(kThreads)
    stream_resolve_kernel(const int64_t* __restrict__ values, int64_t n,
                   int64_t num_sigs, int64_t slots,
                   const int32_t* __restrict__ answers,
                   const uint8_t* __restrict__ fe,
                   const int64_t* __restrict__ hk, int64_t hk_len, int32_t w,
                   int32_t full_w, int32_t* __restrict__ res,
                   unsigned long long* counts) {
  __shared__ unsigned int tally[3];
  if (threadIdx.x < 3) tally[threadIdx.x] = 0;
  __syncthreads();
  unsigned int over = 0, fell = 0, hits = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int64_t v = values[i];
    const int64_t h = v % num_sigs;
    const int32_t ch = res[i];
    int64_t slot = -1;
    bool fallback;
    if (ch < 0) {
      fallback = true;  // overflow at scatter time
      ++over;
    } else {
      const uint32_t packed = static_cast<uint32_t>(
          answers[static_cast<int64_t>(ch >> 2) * slots + h]);
      const int32_t off = (packed >> (8 * (ch & 3))) & 0xFF;
      const int32_t f = fe[h];
      if (off < f) {  // a candidate before the first empty slot
        fallback = !(h + off < hk_len && hk[h + off] == v);
        if (!fallback) slot = h + off;
      } else {
        fallback = f >= w;  // no empty slot in the window: unresolved
      }
    }
    if (fallback) {
      ++fell;
      const int64_t lim = full_w < hk_len - h ? full_w : hk_len - h;
      for (int64_t l = 0; l < lim; ++l) {
        if (hk[h + l] == v) {
          slot = h + l;
          break;
        }
      }
    }
    hits += slot >= 0;
    res[i] = static_cast<int32_t>(slot);
  }
  if (over) atomicAdd(&tally[0], over);
  if (fell) atomicAdd(&tally[1], fell);
  if (hits) atomicAdd(&tally[2], hits);
  __syncthreads();
  if (threadIdx.x < 3 && tally[threadIdx.x])
    atomicAdd(&counts[threadIdx.x],
              static_cast<unsigned long long>(tally[threadIdx.x]));
}

int grid_for(int64_t n, const void* kernel, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // a few waves of resident blocks, each thread striding over the rest
  const int64_t most = 4ll * sms * (per_sm > 0 ? per_sm : 1);
  const int64_t need = (n + kThreads - 1) / kThreads;
  *grid = static_cast<unsigned>(need < most ? need : most);
  return 0;
}

}  // namespace

extern "C" {

// Places the n query values of one chunk into the pass's tiles[channels,
// slots] (u16) and occupancy occ[slots] (u8, slots a multiple of 4, both
// zero before a pass's first chunk); res[n] (int32) gets each query's
// channel, or -1 for overflow. Launches on ``stream``; returns a CUDA
// error code (0 = the launch was accepted).
int stream_scatter(const void* values, int64_t n, int64_t num_sigs,
                   int64_t slots, int32_t channels, void* tiles, void* occ,
                   void* res, void* stream) {
  if (n < 0 || num_sigs < 1 || slots < num_sigs || slots % 4 ||
      channels < 1 || channels > kMaxChannels ||
      reinterpret_cast<uintptr_t>(occ) % 4)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  unsigned grid = 0;
  const int rc =
      grid_for(n, reinterpret_cast<const void*>(stream_scatter_kernel), &grid);
  if (rc) return rc;
  const auto st = static_cast<cudaStream_t>(stream);
  stream_scatter_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int64_t*>(values), n, num_sigs, slots, channels,
      static_cast<uint16_t*>(tiles), static_cast<unsigned int*>(occ),
      static_cast<int32_t*>(res));
  return static_cast<int>(cudaGetLastError());
}

// Resolves the n queries of one chunk after the probe: answers[channels /
// 4, slots] (int32, the probe's output), fe[slots + w] (u8), hk[hk_len]
// (int64, the k-mer column padded past num_sigs by full_w empty slots);
// res[n] holds each query's channel in and its table slot (-1: miss) out;
// counts[3] (u64) gain the overflow, fallback and hit counts.
int stream_resolve(const void* values, int64_t n, int64_t num_sigs,
                   int64_t slots, const void* answers, const void* fe,
                   const void* hk, int64_t hk_len, int32_t w, int32_t full_w,
                   void* res, void* counts, void* stream) {
  if (n < 0 || num_sigs < 1 || slots < num_sigs || w < 1 || full_w < 1 ||
      hk_len < num_sigs)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  unsigned grid = 0;
  const int rc =
      grid_for(n, reinterpret_cast<const void*>(stream_resolve_kernel), &grid);
  if (rc) return rc;
  const auto st = static_cast<cudaStream_t>(stream);
  stream_resolve_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int64_t*>(values), n, num_sigs, slots,
      static_cast<const int32_t*>(answers), static_cast<const uint8_t*>(fe),
      static_cast<const int64_t*>(hk), hk_len, w, full_w,
      static_cast<int32_t*>(res), static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
