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
// back[T, cap] in the same cells. route_unbin gathers each query's (off,
// state) from its cell, 0 for an overflow.
//
// What bounds it. Per query its home and fingerprint in (6 B) and its cell
// out (4 B), then the bins written (6 B a cell); the un-binning reads a
// cell index and two answer bytes and writes two. All of it is bytes, and
// small beside the probe's random reads. Stability comes from tiles of
// 1024 queries in order. A first kernel ranks each query within its tile
// (warps by __match_any_sync, then a prefix over the tile's 32 warps in
// shared memory) and counts the tile's queries per owner; a second scans
// those counts over the tiles, a block an owner: a block-wide exclusive
// scan (warp shuffles, then the 32 warps' sums in shared memory) over
// 1024 tiles at a time with a carried total, which also leaves each
// owner's total after the last tile; a third fills only the cells past
// each owner's total with FP_EMPTY and 0; a fourth adds the two ranks and
// scatters into the bins, so no cell is written twice. A scan of one
// thread an owner, walking every tile in turn, would keep T + 1 threads of
// the card busy. Every kernel's name starts with route_, so that a trace
// tells them apart. The TPU program's argsort, searchsorted and scatter
// with a parking column are XLA forms and are not carried.
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

__global__ void __launch_bounds__(kTile)
route_unbin_kernel(const int32_t* __restrict__ cell, int64_t n,
             const uint8_t* __restrict__ back_off,
             const uint8_t* __restrict__ back_state,
             uint8_t* __restrict__ off, uint8_t* __restrict__ state) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i >= n) return;
  const int32_t c = __ldg(cell + i);
  off[i] = c >= 0 ? __ldg(back_off + c) : 0;
  state[i] = c >= 0 ? __ldg(back_state + c) : 0;
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

// Gathers each of n queries' answer from its cell on ``stream``; returns a
// CUDA error code. Inputs cell[n], back_off[T * cap], back_state[T * cap];
// outputs off[n], state[n].
int route_unbin(const void* cell, int64_t n, const void* back_off,
                const void* back_state, void* off, void* state,
                void* stream) {
  if (n < 0 || n >= (1LL << 31)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n + kTile - 1) / kTile;
  route_unbin_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cell), n,
      static_cast<const uint8_t*>(back_off),
      static_cast<const uint8_t*>(back_state), static_cast<uint8_t*>(off),
      static_cast<uint8_t*>(state));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
