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
//
// Bound: device-memory bytes. Each query reads its fingerprint (2 B) and
// home (4 B), writes 2 B, and reads the plane sectors its window touches:
// at the tables' load factors a window ends at an empty slot or a match
// after a few slots, so usually one 32-byte sector. The design's answer is
// to read only those sectors: one thread per query scans its own window
// straight from device memory (through L1/L2), in the queries' order, with
// no sort. The TPU kernel's answer, a tile join (queries sorted by home,
// each tile of the plane staged once in fast memory), reads the whole
// plane per launch; on an H100 80GB HBM3 (700 W limit) at the engine's
// launch of 2^19 queries over a 40M-slot plane it took 0.154 ms with its
// sort against 0.019 ms for this scan (PERF.md, Findings).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtilejoin.so tilejoin.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/lookup/tilejoin.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindow = 256;  // largest w (offsets are u8)
constexpr int kThreads = 256;
constexpr uint16_t kFpEmpty = 65535;

__global__ void __launch_bounds__(kThreads)
first_event_kernel(const uint16_t* __restrict__ fp, int64_t plane_len,
                   const uint16_t* __restrict__ q_fp,
                   const int32_t* __restrict__ homes, int64_t n, int32_t w,
                   uint8_t* __restrict__ off, uint8_t* __restrict__ state) {
  const int64_t q =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int64_t h = homes[q];
  uint8_t o = 0, st = 0;
  if (h >= 0 && h + w <= plane_len) {  // else the window runs off the plane
    const uint16_t want = q_fp[q];
    for (int32_t l = 0; l < w; ++l) {
      const uint16_t v = __ldg(fp + h + l);
      if (v == want) {  // a candidate outranks an empty slot
        o = static_cast<uint8_t>(l);
        st = 1;
        break;
      }
      if (v == kFpEmpty) {
        st = 2;
        break;
      }
    }
  }
  off[q] = o;
  state[q] = st;
}

}  // namespace

extern "C" {

// Launches the probe on ``stream``; returns cudaGetLastError() (0 = the
// launch was accepted). Inputs: the plane fp[plane_len], and per query its
// fingerprint q_fp[n] and home slot homes[n]; outputs off[n], state[n].
int tilejoin_first_event(const void* fp, int64_t plane_len, const void* q_fp,
                         const void* homes, int64_t n, int32_t w, void* off,
                         void* state, void* stream) {
  if (w < 1 || w > kMaxWindow || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  first_event_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(fp), plane_len,
      static_cast<const uint16_t*>(q_fp), static_cast<const int32_t*>(homes),
      n, w, static_cast<uint8_t*>(off), static_cast<uint8_t*>(state));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
