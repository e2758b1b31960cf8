// Routing bins of the routed lookup, for Hopper (sm_90a).
//
// Replaces the binning and un-binning of the JAX package's device program
// kmergutsjava_tpu/parallel/routed_lookup.py _routed_step (written in XLA
// for the TPU, under shard_map; its lines 57-81 and 119-133). A source
// shard holds n queries (home, u16 fingerprint); the first n_valid are
// real. Each real query's owner is clip(home / s_loc, 0, T - 1) (the shard
// whose slot range holds its home), a padded one's is T. route_bins gives
// each query its STABLE rank among the queries of its owner (the order of
// a stable sort by owner), and lays the queries out in bins [T, cap]:
// cell owner * cap + rank holds its fingerprint and home, a cell no query
// takes holds FP_EMPTY and 0. A query whose rank is cap or more, or whose
// owner is T, overflows: its cell is -1 and the host's exact pass answers
// it. Row t of the bins goes to shard t (the exchange, outside the
// kernel); the owner probes it, and its answers come back as rows of
// back[T, 2, cap] in the same cells, a row of offsets and a row of
// states for each owner, one piece a (owner, source) pair, so one exchange
// carries them. route_unbin writes each query's answer in the host's
// layout: one u8 buffer [3, ld] (ld = n rounded up to 16), a row of
// offsets, a row of states and a row of overflow flags (1 where the cell
// is -1; its offset and state are 0), read back in one copy.
//
// What bounds it. Per query its home and fingerprint in (6 B) and its cell
// out (4 B), then the bins written (6 B a cell); the un-binning reads a
// cell (4 B) and the two answer bytes of each answered cell, and writes
// 3 B. All of it is bytes, and small beside the probe's random reads.
// Stability comes from tiles of 1024 queries in order. A first kernel
// ranks each query within its tile (warps by __match_any_sync, then a
// prefix over the tile's 32 warps in shared memory) and counts the
// tile's queries per owner; a second scans
// those counts over the tiles, a block an owner: a block-wide exclusive
// scan (warp shuffles, then the 32 warps' sums in shared memory) over
// 1024 tiles at a time with a carried total, which also leaves each
// owner's total after the last tile; a third fills only the cells past
// each owner's total with FP_EMPTY and 0; a fourth adds the two ranks and
// scatters into the bins, so no cell is written twice. A scan of one
// thread an owner, walking every tile in turn, would keep T + 1 threads of
// the card busy. The un-binning takes 2 consecutive queries a thread in
// blocks of 256: one 8-byte load of their cells, their four answer bytes
// from the back buffer (an owner's queries hold consecutive cells, so a
// warp's reads fall into a few short runs, and the buffer is small enough
// to stay in L2), and one 2-byte store into each of the three rows, whose
// 16-byte row stride keeps every row aligned. Of 1, 2, 4, 8 and 16 queries
// a thread and blocks of 128 to 1024, two a thread in 256 measured fastest
// (more threads in flight over the cell -> answer dependence); with the L2
// cold it is held by the cells' stream from device memory and that
// dependence: four a thread without the gather took 18% less time than
// with it (PERF.md). Every kernel's name
// starts with route_, so that a trace tells them apart. The TPU program's
// argsort, searchsorted and scatter with a parking column are XLA forms
// and are not carried.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libroute_bins.so route_bins.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/parallel/
// route_bins.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;       // queries a tile, one thread each
constexpr int kWarps = kTile / 32;
constexpr int kMaxShards = 256;   // owners are 0..T, so T + 1 <= 257
constexpr int kScanThreads = 1024; // tiles a scan block takes at a time
constexpr int kFillThreads = 256;
constexpr int kUnbinThreads = 256;  // a block of the un-binning

__device__ __forceinline__ int owner_of(const int32_t* __restrict__ homes,
                                        int64_t i, int64_t n_valid,
                                        int64_t s_loc, int n_shards) {
  if (i >= n_valid) return n_shards;
  const int64_t o = static_cast<int64_t>(__ldg(homes + i)) / s_loc;
  return static_cast<int>(o < 0 ? 0 : o >= n_shards ? n_shards - 1 : o);
}

// The cells of bin row blockIdx.y past its owner's total (no query takes
// them) empty: fingerprint FP_EMPTY, home 0.
__global__ void __launch_bounds__(kFillThreads)
route_fill_kernel(uint16_t* __restrict__ bin_qfp,
                  int32_t* __restrict__ bin_home, int64_t cap,
                  const int32_t* __restrict__ totals) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * kFillThreads + threadIdx.x;
  if (j >= cap || j < __ldg(totals + blockIdx.y)) return;
  const int64_t i = static_cast<int64_t>(blockIdx.y) * cap + j;
  bin_qfp[i] = 0xFFFFu;
  bin_home[i] = 0;
}

// Each query's rank within its tile among the queries of its owner, and
// each tile's count of every owner: counts[tile * (T + 1) + owner].
__global__ void __launch_bounds__(kTile)
route_rank_kernel(const int32_t* __restrict__ homes, int64_t n,
                 int64_t n_valid, int64_t s_loc, int n_shards,
                 int32_t* __restrict__ rank, int32_t* __restrict__ counts) {
  __shared__ int32_t wc[kWarps * (kMaxShards + 1)];
  const int owners = n_shards + 1;
  for (int k = threadIdx.x; k < kWarps * owners; k += kTile) wc[k] = 0;
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const int owner = i < n ? owner_of(homes, i, n_valid, s_loc, n_shards) : -1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned same = __match_any_sync(0xFFFFFFFFu, owner);
  const int in_warp = __popc(same & ((1u << lane) - 1u));
  if (owner >= 0 && in_warp == 0) wc[warp * owners + owner] = __popc(same);
  __syncthreads();
  for (int o = threadIdx.x; o < owners; o += kTile) {
    int32_t run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = wc[w * owners + o];
      wc[w * owners + o] = run;
      run += c;
    }
    counts[static_cast<int64_t>(blockIdx.x) * owners + o] = run;
  }
  __syncthreads();
  if (owner >= 0) rank[i] = wc[warp * owners + owner] + in_warp;
}

// Inclusive sum of x over the warp's lanes.
__device__ __forceinline__ int32_t warp_inclusive(int32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// counts[t * owners + o] for t < tiles -> owner o's exclusive prefix over
// the tiles, in place, and counts[tiles * owners + o] = its total; owner
// o = blockIdx.x.
__global__ void __launch_bounds__(kScanThreads)
route_scan_kernel(int32_t* __restrict__ counts, int64_t tiles, int owners) {
  __shared__ int32_t sums[kScanThreads / 32];
  const int o = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t carry = 0;  // the owner's count in the tiles before this round
  for (int64_t t0 = 0; t0 < tiles; t0 += kScanThreads) {
    const int64_t t = t0 + threadIdx.x;
    int32_t* cell = counts + t * owners + o;
    const int32_t c = t < tiles ? *cell : 0;
    const int32_t x = warp_inclusive(c, lane);
    if (lane == 31) sums[warp] = x;
    __syncthreads();
    if (warp == 0) sums[lane] = warp_inclusive(sums[lane], lane);
    __syncthreads();
    if (t < tiles) *cell = carry + (warp ? sums[warp - 1] : 0) + x - c;
    carry += sums[kScanThreads / 32 - 1];
    __syncthreads();  // sums is rewritten in the next round
  }
  if (threadIdx.x == 0) counts[tiles * owners + o] = carry;
}

__global__ void __launch_bounds__(kTile)
route_scatter_kernel(const uint16_t* __restrict__ q_fp,
               const int32_t* __restrict__ homes, int64_t n, int64_t n_valid,
               int64_t s_loc, int n_shards, int64_t cap,
               const int32_t* __restrict__ rank,
               const int32_t* __restrict__ prefix,
               uint16_t* __restrict__ bin_qfp, int32_t* __restrict__ bin_home,
               int32_t* __restrict__ cell) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i >= n) return;
  const int owner = owner_of(homes, i, n_valid, s_loc, n_shards);
  int64_t c = -1;
  if (owner < n_shards) {
    const int64_t r =
        static_cast<int64_t>(
            prefix[static_cast<int64_t>(blockIdx.x) * (n_shards + 1) +
                   owner]) +
        rank[i];
    if (r < cap) c = owner * cap + r;
  }
  cell[i] = static_cast<int32_t>(c);
  if (c >= 0) {
    bin_qfp[c] = __ldg(q_fp + i);
    bin_home[c] = __ldg(homes + i);
  }
}

// The answer of the query whose cell is c, a byte of row ``row`` (0:
// offset, 1: state) of the back buffer [T, 2, cap]: owner c / cap, rank
// c % cap.
__device__ __forceinline__ uint32_t answer_byte(
    const uint8_t* __restrict__ back, int32_t c, uint32_t cap, int row) {
  if (c < 0) return 0;
  const uint32_t owner = static_cast<uint32_t>(c) / cap;
  return __ldg(back + static_cast<int64_t>(c) + (owner + row) * cap);
}

__global__ void __launch_bounds__(kUnbinThreads)
route_unbin_kernel(const int32_t* __restrict__ cell, int64_t n, int64_t ld,
                   const uint8_t* __restrict__ back, uint32_t cap,
                   uint8_t* __restrict__ out) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kUnbinThreads + threadIdx.x) * 2;
  if (i0 >= ld) return;
  const int64_t live = n - i0;  // this thread's queries below n
  int32_t c[2];
  if (live >= 2) {  // cell + i0 is 8-byte aligned
    const int2 a = __ldg(reinterpret_cast<const int2*>(cell + i0));
    c[0] = a.x;
    c[1] = a.y;
  } else {  // the tail, and the row padding past n (all 0)
#pragma unroll
    for (int k = 0; k < 2; ++k) c[k] = k < live ? __ldg(cell + i0 + k) : -1;
  }
  uint32_t word[3] = {0, 0, 0};  // the two queries' bytes of each row
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    word[0] |= answer_byte(back, c[k], cap, 0) << (8 * k);
    word[1] |= answer_byte(back, c[k], cap, 1) << (8 * k);
    word[2] |= static_cast<uint32_t>(k < live && c[k] < 0) << (8 * k);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    *reinterpret_cast<uint16_t*>(out + r * ld + i0) =
        static_cast<uint16_t>(word[r]);
}

}  // namespace

extern "C" {

// Bins one source shard's n queries on ``stream``; returns a CUDA error
// code (0 = every launch was accepted). Inputs q_fp[n], homes[n]; outputs
// bin_qfp[T * cap], bin_home[T * cap] and cell[n]; scratch rank[n] and
// counts[(ceil(n / 1024) + 1) * (T + 1)].
int route_bins(const void* q_fp, const void* homes, int64_t n,
               int64_t n_valid, int64_t s_loc, int32_t n_shards, int64_t cap,
               void* bin_qfp, void* bin_home, void* cell, void* rank,
               void* counts, void* stream) {
  if (n < 0 || s_loc < 1 || n_shards < 1 || n_shards > kMaxShards ||
      cap < 1 || n_shards * cap >= (1LL << 31) || n >= (1LL << 31))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  const auto* h = static_cast<const int32_t*>(homes);
  auto* rk = static_cast<int32_t*>(rank);
  auto* cn = static_cast<int32_t*>(counts);
  const int owners = n_shards + 1;
  if (tiles > 0)
    route_rank_kernel<<<static_cast<unsigned>(tiles), kTile, 0, st>>>(
        h, n, n_valid, s_loc, n_shards, rk, cn);
  route_scan_kernel<<<owners, kScanThreads, 0, st>>>(cn, tiles, owners);
  route_fill_kernel<<<dim3(static_cast<unsigned>(
                               (cap + kFillThreads - 1) / kFillThreads),
                           static_cast<unsigned>(n_shards)),
                      kFillThreads, 0, st>>>(
      static_cast<uint16_t*>(bin_qfp), static_cast<int32_t*>(bin_home), cap,
      cn + tiles * owners);
  if (tiles > 0)
    route_scatter_kernel<<<static_cast<unsigned>(tiles), kTile, 0, st>>>(
        static_cast<const uint16_t*>(q_fp), h, n, n_valid, s_loc, n_shards,
        cap, rk, cn, static_cast<uint16_t*>(bin_qfp),
        static_cast<int32_t*>(bin_home), static_cast<int32_t*>(cell));
  return static_cast<int>(cudaGetLastError());
}

// Writes each of n queries' answer from its cell on ``stream``, in the
// host's layout; returns a CUDA error code. Inputs cell[n] and back[T, 2,
// cap]; output out[3, ld] (ld = n rounded up to 16): offsets, states and
// overflow flags, 0 past n.
int route_unbin(const void* cell, int64_t n, const void* back, int64_t cap,
                void* out, void* stream) {
  const int64_t ld = (n + 15) / 16 * 16;
  if (n < 0 || n >= (1LL << 31) || cap < 1 || cap >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t per_block = 2 * kUnbinThreads;  // two queries a thread
  route_unbin_kernel<<<static_cast<unsigned>((ld + per_block - 1) /
                                             per_block),
                       kUnbinThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cell), n, ld,
      static_cast<const uint8_t*>(back), static_cast<uint32_t>(cap),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
