// Block-streamed merge-join probe of the u16 fingerprint plane, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel kmergutsjava_tpu/lookup/pallas_kernel.py
// _probe_block_kernel (launched by probe_blocks). The plane is cut into
// blocks of 2048 slots; queries are sorted by home slot and the queries of
// block b are [starts[b], starts[b+1]) (CSR). For one query with home h and
// fingerprint q, over the window fp[h .. h+w-1] (w <= 128):
//   first_cand  = the first offset l with fp[h+l] == q,
//   first_empty = the first offset l with fp[h+l] == FP_EMPTY,
//   off   = first_cand if there is one (even after an empty slot), else 0,
//   state = has_cand + 2 * empty_any, where empty_any is an empty slot
//           anywhere in the window and has_cand a candidate before the
//           first empty slot.
// This is not _first_event's encoding (csrc/tilejoin.cu). A query whose
// home lies outside its block's 2048 slots is unresolved (state 0, off 0).
// The answer for sorted query i is written at position order[i], so the
// caller reads it back in its own query order.
//
// Bound: device-memory bytes. The plane is read once (2 B a slot, plus a
// 128-slot halo a block), each query reads 2 + 4 + 8 B (fingerprint, home,
// order) and writes 2 B at a scattered position. The design: one thread
// block per plane block stages its 2048 + 128 slots (4.25 KB) in shared
// memory once, and its threads stride over the block's queries, each
// scanning its window there. There is no per-block query capacity, so
// nothing overflows (the TPU kernel's fixed 2176-query tile did). Measured
// on an H100 80GB HBM3 (700 W) with 22.5M read 8-mers against a 40M-slot
// plane at w=16, in an order that scatters the answers: 2.0 ms, against
// 50 ms for the plain twin (PERF.md, Findings); the scattered one-byte
// stores, not the plane, are the larger cost there. In home order, as the
// engine feeds it, 0.35 ms, plus 1.4 ms for the caller's device sort; a
// direct per-query scan with this encoding took 0.39 ms with no sort.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libblock_probe.so block_probe.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/lookup/blockprobe.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 2048;  // plane slots a block
constexpr int kHalo = 128;    // the largest window
constexpr int kThreads = 256;
constexpr uint16_t kFpEmpty = 65535;

__global__ void __launch_bounds__(kThreads)
block_probe_kernel(const uint16_t* __restrict__ fp,
                   const uint16_t* __restrict__ q_fp,
                   const int32_t* __restrict__ homes,
                   const int64_t* __restrict__ starts,
                   const int64_t* __restrict__ order, int64_t n, int32_t w,
                   uint8_t* __restrict__ off, uint8_t* __restrict__ state) {
  __shared__ uint16_t win[kBlock + kHalo];
  const int64_t b = blockIdx.x;
  const int64_t lo = starts[b] < 0 ? 0 : starts[b];
  const int64_t hi = starts[b + 1] > n ? n : starts[b + 1];
  if (lo >= hi) return;  // the whole block returns: no barrier is skipped
  const int64_t base = b * kBlock;
  // the plane holds nblocks * 2048 + 128 slots (the wrapper checks it)
  for (int i = threadIdx.x; i < kBlock + kHalo; i += kThreads)
    win[i] = __ldg(fp + base + i);
  __syncthreads();
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int64_t local = static_cast<int64_t>(homes[i]) - base;
    uint8_t o = 0, st = 0;
    if (local >= 0 && local < kBlock) {
      const uint16_t want = q_fp[i];
      const uint16_t* my = win + local;
      int32_t fc = -1, fe = -1;
      for (int32_t l = 0; l < w; ++l) {
        const uint16_t v = my[l];
        if (fc < 0 && v == want) fc = l;
        if (fe < 0 && v == kFpEmpty) fe = l;
        if (fc >= 0 && fe >= 0) break;
      }
      const bool cand_any = fc >= 0;
      const bool empty_any = fe >= 0;
      const bool has_cand = cand_any && (!empty_any || fc < fe);
      o = cand_any ? static_cast<uint8_t>(fc) : 0;
      st = static_cast<uint8_t>(has_cand) + 2 * static_cast<uint8_t>(empty_any);
    }
    const int64_t at = order[i];
    if (at >= 0 && at < n) {
      off[at] = o;
      state[at] = st;
    }
  }
}

}  // namespace

extern "C" {

// Launches the probe on ``stream``; returns cudaGetLastError() (0 = the
// launch was accepted). Inputs: the plane fp[plane_len >= nblocks * 2048 +
// 128]; per sorted query its fingerprint q_fp[n], home homes[n] and output
// position order[n]; the CSR starts[nblocks + 1]. Outputs off[n] and
// state[n] (zeroed by the caller: a position no query writes stays 0).
int block_probe(const void* fp, int64_t plane_len, const void* q_fp,
                const void* homes, const void* starts, int64_t nblocks,
                const void* order, int64_t n, int32_t w, void* off,
                void* state, void* stream) {
  if (w < 1 || w > kHalo || n < 0 || nblocks < 0 || nblocks >= (1LL << 31) ||
      plane_len < nblocks * kBlock + kHalo)
    return cudaErrorInvalidValue;
  if (n == 0 || nblocks == 0) return cudaSuccess;
  block_probe_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(fp), static_cast<const uint16_t*>(q_fp),
      static_cast<const int32_t*>(homes), static_cast<const int64_t*>(starts),
      static_cast<const int64_t*>(order), n, w, static_cast<uint8_t*>(off),
      static_cast<uint8_t*>(state));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
