// Sparse first-event probe of the u16 fingerprint plane, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kmergutsjava_tpu/lookup/pallas_tilejoin.py
// _tilejoin_kernel (launched by tilejoin_probe). For each query it returns
// the first event in the w-slot window that starts at its home slot, the
// contract of lookup/xla.py _first_event:
//   state 1, off = l  the slot at home + l holds the query's fingerprint
//                     (a candidate; the host verifies the full k-mer),
//   state 2, off = 0  an empty slot (FP_EMPTY) comes first: a miss,
//   state 0, off = 0  neither within w slots, or a window that runs off
//                     the plane: the host's exact pass.
// A slot that holds the fingerprint is a candidate even if the
// fingerprint is FP_EMPTY's value.
//
// What bounds it. The bytes the function needs: each query's home (4 B)
// and fingerprint (2 B) in, its off and state (2 B) out, and the 32-byte
// plane sector its window starts in (at the tables' load factors a window
// ends at an empty slot or a candidate within a few slots): 20.97 MB for
// the engine's dispatch of 2^19 queries, 0.0063 ms at 3.35 TB/s. Those
// sectors lie at random in an 80 MB plane, and random reads are what the
// card is slow at: 2^19 random 16-byte reads, one a query and nothing
// else, take 0.0152 ms of device time, against 0.0038 ms for the same
// reads in order and 0.0045 ms for the kernel with no window read at all
// (PERF.md, Findings; the L2 fetches at least 64 bytes a miss). The
// TPU kernel's tile join (queries sorted by home, the whole plane staged
// in fast memory a launch) took 0.154 ms with its sort; the first port,
// one thread a query scanning its window one u16 load at a time, 0.0191 ms.
// The design's answer is to spend as little as it can beyond those random
// reads, one a window where it can: each thread takes kQueries = 4
// consecutive queries, whose homes and fingerprints come in as 16- and
// 8-byte vectors, and reads each window in turn as aligned 16-byte vectors
// from the one that holds its home (1-8 of its slots), then two vectors at
// a time while no event is found. Each read
// gives a candidate mask and an empty mask (two slots a word, the exact
// zero-half test of probe_common.cuh); the first event is the lowest bit
// of their OR. The answers go out as 4-byte words, four queries' off
// bytes and four state bytes, into one buffer that the host reads back in
// one copy.
// Measured in turns by chip_turns.py on an H100 80GB HBM3 (700 W; PERF.md,
// Findings), device time a dispatch of the E. coli proteome's 2^19 queries
// on a 24M-signature plane: 0.0174 ms against the first port's 0.0190.
// Every window's first two vectors in flight before any compare (0.0202),
// one query a thread (0.0188), two (0.0185) or eight (0.0202), a first
// read of the window's 32-byte sector (0.0216) or 64-byte line (0.0200), a
// 32-byte L2 fetch granularity (0.0174) and a persisting L2 window over
// the plane (0.0219) were each measured and were no faster.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtilejoin.so tilejoin.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/lookup/tilejoin.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_answers.cuh"  // answer, in_plane (probe_common.cuh)

namespace {

constexpr int kMaxWindow = 256;  // largest w (offsets are u8)
constexpr int kThreads = 256;
constexpr int kQueries = 4;  // queries a thread: one int4 of homes

// kQueries consecutive queries a thread, their windows in turn. kAligned:
// the inputs and outputs are aligned for vector loads and stores, which a
// thread uses when its queries are whole.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
first_event_kernel(Plane P, const uint16_t* __restrict__ q_fp,
                   const int32_t* __restrict__ homes, int64_t n,
                   uint8_t* __restrict__ off, uint8_t* __restrict__ state) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kQueries;
  if (i0 >= n) return;
  const bool vec = kAligned && i0 + kQueries <= n;
  int32_t h[kQueries];
  uint32_t q[kQueries];
  if (vec) {
    const int4 hv = __ldg(reinterpret_cast<const int4*>(homes + i0));
    const uint2 qv = __ldg(reinterpret_cast<const uint2*>(q_fp + i0));
    h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
    q[0] = qv.x & 0xFFFF, q[1] = qv.x >> 16;
    q[2] = qv.y & 0xFFFF, q[3] = qv.y >> 16;
  } else {
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
      h[k] = i0 + k < n ? __ldg(homes + i0 + k) : -1;
      q[k] = i0 + k < n ? __ldg(q_fp + i0 + k) : 0;
    }
  }
  // an off-plane window is unresolved: off 0, state 0
  uint32_t ans[kQueries];
#pragma unroll
  for (int k = 0; k < kQueries; ++k)
    ans[k] = in_plane(P, h[k]) ? answer(P, h[k], q[k]) : 0;
  if (vec) {
    uint32_t o = 0, s = 0;
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
      o |= (ans[k] & 0xFFu) << (8 * k);
      s |= (ans[k] >> 8 & 0xFFu) << (8 * k);
    }
    *reinterpret_cast<uint32_t*>(off + i0) = o;
    *reinterpret_cast<uint32_t*>(state + i0) = s;
  } else {
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
      if (i0 + k < n) {
        off[i0 + k] = static_cast<uint8_t>(ans[k]);
        state[i0 + k] = static_cast<uint8_t>(ans[k] >> 8);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the probe on ``stream``; returns a CUDA error code (0 = the
// launch was accepted). Inputs: the plane fp[plane_len], and per query its
// fingerprint q_fp[n] and home slot homes[n]; outputs off[n], state[n].
int tilejoin_first_event(const void* fp, int64_t plane_len, const void* q_fp,
                         const void* homes, int64_t n, int32_t w, void* off,
                         void* state, void* stream) {
  const auto addr = reinterpret_cast<uintptr_t>(fp);
  if (w < 1 || w > kMaxWindow || n < 0 || plane_len < 0 || addr % 2)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t threads = (n + kQueries - 1) / kQueries;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const int64_t shift = (addr % 16) / 2;
  const Plane P{static_cast<const uint16_t*>(fp) - shift, shift, plane_len,
                w};
  const auto* q = static_cast<const uint16_t*>(q_fp);
  const auto* h = static_cast<const int32_t*>(homes);
  auto* o = static_cast<uint8_t*>(off);
  auto* s = static_cast<uint8_t*>(state);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(q) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(s) % 4 == 0;
  if (aligned)
    first_event_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                               st>>>(P, q, h, n, o, s);
  else
    first_event_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                st>>>(P, q, h, n, o, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
