// Dense stream probe of the u16 fingerprint plane, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kmergutsjava_tpu/lookup/pallas_stream.py
// _stream_block_kernel (launched by stream_probe_blocks). Queries were
// scattered on the host into a slot-major tile: tiles[c, s] holds the
// fingerprint of the c-th distinct query whose home slot is s (0 where
// none). For every slot s and channel c the kernel returns the smallest
// l < w with fp[s + l] == tiles[c, s], else w, and packs four channels per
// int32, channel c in the byte at bit 8 * (c & 3) of out[c / 4, s]. It does
// not stop at an empty slot: the host applies stop-at-empty from its
// empty-distance plane. Unused cells (fingerprint 0, a valid value) are
// computed like any other; the host decode never reads them.
//
// What bounds it. The bytes: a pass reads the plane (2 B a slot) and the
// tiles (2 B a cell) once and writes the output (1 B a cell): 14 B a slot
// at C = 4, 560 MB at 40M slots, 0.167 ms at 3.35 TB/s. The TPU kernel's
// form, a compare-select of every cell against every window offset (w * C
// integer ops a slot), is bound by the integer pipe on this card: ported
// as it was it took 0.021 ms per window offset at 40M slots (0.61 ms at
// w=16, 1.56 ms at w=64). The design's answer is to make the compares
// rare, not faster:
// - persistent CTAs walk work items of kSpan slots (4 a thread: 8 B tile
//   loads, 16 B output stores, neighbouring threads on neighbouring
//   slots); the next item's tiles and plane values are loaded into
//   registers while the current one is answered, and its kSpan + w - 1
//   plane values are staged in shared memory;
// - the item marks every fingerprint its span holds in a 65,536-bit
//   presence bitmap (shared atomics; FP_EMPTY, much of any plane, with one
//   atomic a warp);
// - a cell whose bit is clear cannot match anywhere in its window, which
//   lies inside the span, so its answer is w with no compare (exact);
// - the other cells (true matches, and the false positives of a bitmap
//   over about 1,088 values: some 1.6% of random fingerprints, and every
//   unused cell of a span whose plane holds 0) go to a shared list (a
//   warp-aggregated reservation) and are answered densely, one a thread:
//   each scans its window, 8 offsets a step with an early exit.
// Measured on an H100 80GB HBM3 (700 W; PERF.md, Findings): 0.295 ms for a
// pass of real tiles at w=16 (1.7% of the cells listed), 0.37 / 0.53 ms on
// 40M synthetic slots at w=24 / 64 (8.4% listed), against the 0.167 ms
// bound. What is left: the bitmap tests of every cell and the three
// barriers an item (without marks or tests the kernel moves its bytes in
// 0.19 ms), and at wide windows the scans. __launch_bounds__(256, 6): 40
// registers, six CTAs an SM (five and seven were slower on real tiles).
// Tried and not kept: a table of the span's fingerprints and positions
// for wide windows (faster only where w = 64 and every cell is planted,
// a window no table of the repo needs, and slower on real tiles), a hash
// join of the listed cells against the plane; cp.async or TMA staging is
// not used (the register prefetch already overlaps the loads).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libstream_probe.so stream_probe.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/lookup/stream.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindow = 64;  // offsets w <= 64 pack into a byte
constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kSpan = kThreads * kSlotsPerThread;  // slots a work item owns
constexpr int kStage = kSpan + kMaxWindow;         // staged plane values
constexpr int kStageRegs = (kStage + kThreads - 1) / kThreads;
constexpr int kScanStep = 8;  // window offsets a scan step reads at once
constexpr int kCells = 4 * kSpan;  // cells of one four-channel group
constexpr uint32_t kFpEmpty = 65535;

struct __align__(16) Shared {
  uint32_t bits[65536 / 32];         // presence of each fingerprint in the
                                     // span
  uint32_t packed[kSpan];            // answers of the slots that have listed
                                     // cells
  uint32_t work[kCells];             // listed cells: slot | c << 10 | fp << 16
  uint16_t win[kStage + kScanStep];  // the span's plane values (the last
                                     // scan step may read past them)
  int count;                         // listed cells
};

// The first offset l < w with win[sl + l] == x, else w.
__device__ __forceinline__ uint32_t scan_window(const uint16_t* win,
                                                uint32_t sl, uint32_t x,
                                                int32_t w) {
  for (int32_t l0 = 0; l0 < w; l0 += kScanStep) {
    uint16_t v[kScanStep];
#pragma unroll
    for (int k = 0; k < kScanStep; ++k) v[k] = win[sl + l0 + k];
    int first = kScanStep;
#pragma unroll
    for (int k = kScanStep - 1; k >= 0; --k)
      if (v[k] == x) first = k;
    if (first < kScanStep) return l0 + first < w ? l0 + first : w;
  }
  return w;
}

// One work item's loads, held in registers while the item before it runs.
struct Fetch {
  uint2 q[4];  // four slots of each channel, two to a word (low half first)
  uint4 pv;    // plane values: one vector (kVec), or kStageRegs halves
};

struct Item {
  int64_t base;  // the span's first slot
  int32_t p;     // the four-channel group
};

// Item t of a launch: spans by groups, repeated ``reps`` times.
__device__ __forceinline__ Item item_of(int64_t t, int64_t nspans,
                                        int32_t planes) {
  const int64_t u = t % (nspans * planes);
  return {(u / planes) * kSpan, static_cast<int32_t>(u % planes)};
}

__device__ __forceinline__ uint32_t half_at(uint4 v, int k) {
  const uint32_t word = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
  return k & 1 ? word >> 16 : word & 0xFFFF;
}

// Issues this thread's loads of an item: the tile cells of its four slots
// and its share of the span's plane values (kFpEmpty past the plane).
template <bool kVec>
__device__ __forceinline__ void fetch(const uint16_t* __restrict__ fp,
                                      const uint16_t* __restrict__ tiles,
                                      int64_t slots, int64_t plane_len,
                                      Item it, Fetch& f) {
  const int tid = threadIdx.x;
  const int64_t s0 = it.base + tid * kSlotsPerThread;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint16_t* row =
        tiles + static_cast<int64_t>(4 * it.p + c) * slots + s0;
    if (kVec) {
      f.q[c] = s0 < slots ? __ldg(reinterpret_cast<const uint2*>(row))
                          : make_uint2(0, 0);
    } else {
      uint32_t h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = s0 + j < slots ? __ldg(row + j) : 0;
      f.q[c] = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
    }
  }
  if (kVec) {
    const int64_t at = it.base + 8 * tid;
    if (tid < kStage / 8 && at + 8 <= plane_len) {
      f.pv = __ldg(reinterpret_cast<const uint4*>(fp + at));
    } else if (tid < kStage / 8) {
      uint32_t h[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        h[k] = at + k < plane_len ? __ldg(fp + at + k) : kFpEmpty;
      f.pv = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                        h[4] | h[5] << 16, h[6] | h[7] << 16);
    }
  } else {
    uint32_t h[8] = {kFpEmpty, kFpEmpty, kFpEmpty, kFpEmpty,
                     kFpEmpty, kFpEmpty, kFpEmpty, kFpEmpty};
#pragma unroll
    for (int k = 0; k < kStageRegs; ++k) {
      const int i = tid + k * kThreads;
      if (i < kStage && it.base + i < plane_len)
        h[k] = __ldg(fp + it.base + i);
    }
    f.pv = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                      h[4] | h[5] << 16, h[6] | h[7] << 16);
  }
}

// Writes a fetched item's plane values into shared memory (waits for
// their loads; the tile cells stay in registers).
template <bool kVec>
__device__ __forceinline__ void stage(uint16_t* win, const Fetch& f) {
  const int tid = threadIdx.x;
  if (kVec) {
    if (tid < kStage / 8) reinterpret_cast<uint4*>(win)[tid] = f.pv;
  } else {
#pragma unroll
    for (int k = 0; k < kStageRegs; ++k)
      if (tid + k * kThreads < kStage)
        win[tid + k * kThreads] = static_cast<uint16_t>(half_at(f.pv, k));
  }
}

// Stores four packed answers at out[s0 .. s0 + 3] (those below slots).
template <bool kVec>
__device__ __forceinline__ void store4(int32_t* __restrict__ out,
                                       int64_t slots, int64_t s0,
                                       uint4 v) {
  if (kVec) {
    if (s0 < slots) *reinterpret_cast<uint4*>(out + s0) = v;
  } else {
    const uint32_t a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (s0 + j < slots) out[s0 + j] = static_cast<int32_t>(a[j]);
  }
}

// Zeroes the bitmap.
__device__ __forceinline__ void clear_bits(uint32_t* bits) {
  for (int i = threadIdx.x; i < 65536 / 128; i += kThreads)
    reinterpret_cast<uint4*>(bits)[i] = make_uint4(0, 0, 0, 0);
}

// Persistent CTAs walk the work items (span, group, rep), each fetching
// the next item's tiles and plane values into registers while it answers
// the current one. kVec: slots % 4 == 0, fp 16-byte aligned, tiles 8-byte
// aligned and out 16-byte aligned (the host entry checks); else scalar
// loads and stores.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 6)
stream_probe_kernel(const uint16_t* __restrict__ fp,
                    const uint16_t* __restrict__ tiles, int64_t slots,
                    int32_t planes, int32_t w, int32_t reps,
                    int32_t* __restrict__ out) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the plane holds slots + w values (the wrapper checks it)
  const int64_t plane_len = slots + w;
  const int64_t nspans = (slots + kSpan - 1) / kSpan;
  const int64_t total = nspans * planes * reps;
  const uint32_t dflt = static_cast<uint32_t>(w) * 0x01010101u;
  const uint4 d4 = make_uint4(dflt, dflt, dflt, dflt);
  uint8_t* const answer = reinterpret_cast<uint8_t*>(sh.packed);

  int64_t t = blockIdx.x;
  Fetch f;
  if (t < total) {
    fetch<kVec>(fp, tiles, slots, plane_len, item_of(t, nspans, planes), f);
    stage<kVec>(sh.win, f);
  }
  clear_bits(sh.bits);
  if (tid == 0) sh.count = 0;
  __syncthreads();

  for (; t < total; t += gridDim.x) {
    const Item it = item_of(t, nspans, planes);
    const int64_t tn = t + gridDim.x;
    Fetch fn;
    if (tn < total)  // in flight while this item runs
      fetch<kVec>(fp, tiles, slots, plane_len, item_of(tn, nspans, planes),
                  fn);
    const int64_t span_slots = slots - it.base < kSpan ? slots - it.base
                                                       : kSpan;
    // 1. mark the fingerprints that the windows of the span's slots
    // cover; FP_EMPTY (much of any plane) gets one atomic a warp
    const int n_stage = static_cast<int>(span_slots) + w - 1;
    bool saw_empty = false;
    for (int i = tid; i < n_stage; i += kThreads) {
      const uint32_t v = sh.win[i];
      if (v == kFpEmpty)
        saw_empty = true;
      else
        atomicOr(&sh.bits[v >> 5], 1u << (v & 31));
    }
    if (__any_sync(0xFFFFFFFFu, saw_empty) && lane == 0)
      atomicOr(&sh.bits[kFpEmpty >> 5], 1u << (kFpEmpty & 31));
    __syncthreads();

    // 2. list the cells whose fingerprint occurs in the span (bit 4c + j
    // of need); every other cell's answer is w
    const int64_t s0 = it.base + tid * kSlotsPerThread;
    const int64_t left = slots - s0;
    const uint32_t valid =
        ((1u << (left <= 0 ? 0 : left >= 4 ? 4 : left)) - 1u) * 0x1111u;
    uint32_t need = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t word = j < 2 ? f.q[c].x : f.q[c].y;
        const uint32_t x = j & 1 ? word >> 16 : word & 0xFFFF;
        need |= ((sh.bits[x >> 5] >> (x & 31)) & 1u) << (4 * c + j);
      }
    }
    need &= valid;
    // reserve room in the list: one shared atomic a warp
    const int n = __popc(need);
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += v;
    }
    const int wtotal = __shfl_sync(0xFFFFFFFFu, incl, 31);
    int wbase = 0;
    if (lane == 31 && wtotal > 0) wbase = atomicAdd(&sh.count, wtotal);
    int at = __shfl_sync(0xFFFFFFFFu, wbase, 31) + incl - n;
    const uint32_t local = tid * kSlotsPerThread;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // static indices keep q in registers
        if ((need >> (4 * c + j)) & 1u) {
          const uint32_t word = j < 2 ? f.q[c].x : f.q[c].y;
          const uint32_t x = j & 1 ? word >> 16 : word & 0xFFFF;
          sh.work[at++] = (local + j) | static_cast<uint32_t>(c) << 10 |
                          x << 16;
        }
      }
    }
    int32_t* const row = out + static_cast<int64_t>(it.p) * slots;
    if (need == 0)
      store4<kVec>(row, slots, s0, d4);  // no cell of these slots can match
    else
      reinterpret_cast<uint4*>(sh.packed)[tid] = d4;
    __syncthreads();

    // 3. scan the listed cells' windows, one cell a thread
    const int nwork = sh.count;
    for (int e = tid; e < nwork; e += kThreads) {
      const uint32_t cell = sh.work[e];
      const uint32_t sl = cell & (kSpan - 1);
      const uint32_t l = scan_window(sh.win, sl, cell >> 16, w);
      if (l < static_cast<uint32_t>(w))
        answer[4 * sl + ((cell >> 10) & 3)] = static_cast<uint8_t>(l);
    }
    __syncthreads();

    if (need != 0)
      store4<kVec>(row, slots, s0,
                   reinterpret_cast<const uint4*>(sh.packed)[tid]);
    clear_bits(sh.bits);
    if (tid == 0) sh.count = 0;
    if (tn < total) {
      stage<kVec>(sh.win, fn);
      f = fn;
    }
    __syncthreads();
  }
}

template <bool kVec>
int launch_kernel(const uint16_t* fp, const uint16_t* tiles, int64_t slots,
                  int32_t planes, int32_t w, int32_t reps, int32_t* out,
                  cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stream_probe_kernel<kVec>, kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t items = (slots + kSpan - 1) / kSpan * planes * reps;
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid =
      static_cast<unsigned>(items < resident ? items : resident);
  stream_probe_kernel<kVec><<<grid, kThreads, 0, st>>>(fp, tiles, slots,
                                                      planes, w, reps, out);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* fp, const void* tiles, int64_t slots,
           int32_t channels, int32_t w, int32_t reps, void* out,
           void* stream) {
  if (w < 1 || w > kMaxWindow || channels < 4 || channels % 4 || slots < 0 ||
      reps < 1 || reps > 65535)
    return cudaErrorInvalidValue;
  if (slots == 0) return cudaSuccess;
  const bool vec = slots % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(fp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(tiles) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* f = static_cast<const uint16_t*>(fp);
  const auto* t = static_cast<const uint16_t*>(tiles);
  auto* o = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch_kernel<true>(f, t, slots, channels / 4, w, reps, o, st)
             : launch_kernel<false>(f, t, slots, channels / 4, w, reps, o, st);
}

}  // namespace

extern "C" {

// Launches the probe on ``stream``; returns a CUDA error code (0 = the
// launch was accepted). Inputs: the plane fp[slots + w] and the tiles
// [channels, slots]; output out[channels / 4, slots].
int stream_probe(const void* fp, const void* tiles, int64_t slots,
                 int32_t channels, int32_t w, void* out, void* stream) {
  return launch(fp, tiles, slots, channels, w, 1, out, stream);
}

// The same probe repeated, for timing (the port of
// scripts/microbench_probe.py stream_reps): one launch whose work items
// run ``reps`` times, each rep recomputing and rewriting the same output,
// as the TPU grid (reps, nsuper) does. reps <= 65535.
int stream_probe_reps(const void* fp, const void* tiles, int64_t slots,
                      int32_t channels, int32_t w, int32_t reps, void* out,
                      void* stream) {
  return launch(fp, tiles, slots, channels, w, reps, out, stream);
}

}  // extern "C"
