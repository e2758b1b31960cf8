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
// What bounds it: bytes and compares. A pass reads the plane once (2 B a
// slot, the w-slot halo of each block is re-read from L2), the tile (2 B a
// slot and channel) and writes the output (1 B a slot and channel): about
// 14 B a slot at C = 4, some 0.56 GB at 40M slots, 0.17 ms at 3.35 TB/s.
// The compares (w * C a slot) are integer ops on registers and shared
// memory.
// The design's answer: one thread per slot, neighbouring threads on
// neighbouring slots, so every tile load and output store is coalesced;
// each block stages its blockDim + w plane slots in shared memory once,
// and each thread scans its w-slot window there, in reverse with
// overwrite (first match wins), as the TPU kernel does with static lane
// shifts. Measured on an H100 80GB HBM3 (700 W) at 40M slots: 0.75 ms at
// w=24 and 1.58 ms at w=64 (PERF.md, Findings), about 0.25 ms of
// traffic plus 0.021 ms per window offset: at these windows the compare
// loop, which does not overlap the loads, costs more than the bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libstream_probe.so stream_probe.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/lookup/stream.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindow = 64;  // offsets w <= 64 pack into a byte
constexpr int kThreads = 256;
constexpr uint16_t kFpEmpty = 65535;

__global__ void __launch_bounds__(kThreads)
stream_probe_kernel(const uint16_t* __restrict__ fp,
                    const uint16_t* __restrict__ tiles, int64_t slots,
                    int32_t planes, int32_t w, int32_t* __restrict__ out) {
  __shared__ uint16_t win[kThreads + kMaxWindow];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  // the plane holds slots + w entries (the wrapper checks it)
  const int64_t plane_len = slots + w;
  for (int i = threadIdx.x; i < kThreads + w; i += kThreads) {
    const int64_t at = base + i;
    win[i] = at < plane_len ? __ldg(fp + at) : kFpEmpty;
  }
  __syncthreads();
  const int64_t s = base + threadIdx.x;
  if (s >= slots) return;
  const uint16_t* my = win + threadIdx.x;
  for (int32_t p = 0; p < planes; ++p) {
    const uint16_t* t = tiles + static_cast<int64_t>(4 * p) * slots + s;
    const uint16_t q0 = __ldg(t);
    const uint16_t q1 = __ldg(t + slots);
    const uint16_t q2 = __ldg(t + 2 * slots);
    const uint16_t q3 = __ldg(t + 3 * slots);
    int32_t r0 = w, r1 = w, r2 = w, r3 = w;
    for (int32_t l = w - 1; l >= 0; --l) {
      const uint16_t v = my[l];
      r0 = v == q0 ? l : r0;
      r1 = v == q1 ? l : r1;
      r2 = v == q2 ? l : r2;
      r3 = v == q3 ? l : r3;
    }
    out[static_cast<int64_t>(p) * slots + s] =
        r0 | (r1 << 8) | (r2 << 16) | (r3 << 24);
  }
}

}  // namespace

extern "C" {

// Launches the probe on ``stream``; returns cudaGetLastError() (0 = the
// launch was accepted). Inputs: the plane fp[slots + w] and the tiles
// [channels, slots]; output out[channels / 4, slots].
int stream_probe(const void* fp, const void* tiles, int64_t slots,
                 int32_t channels, int32_t w, void* out, void* stream) {
  if (w < 1 || w > kMaxWindow || channels < 4 || channels % 4 || slots < 0)
    return cudaErrorInvalidValue;
  if (slots == 0) return cudaSuccess;
  const int64_t blocks = (slots + kThreads - 1) / kThreads;
  stream_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(fp), static_cast<const uint16_t*>(tiles),
      slots, channels / 4, w, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The same probe with a leading repetition axis, for timing (the port of
// scripts/microbench_probe.py stream_reps): one launch with gridDim.y =
// reps, each rep recomputing and rewriting the same output, as the TPU
// grid (reps, nsuper) does. reps <= 65535 (the grid's y limit).
int stream_probe_reps(const void* fp, const void* tiles, int64_t slots,
                      int32_t channels, int32_t w, int32_t reps, void* out,
                      void* stream) {
  if (w < 1 || w > kMaxWindow || channels < 4 || channels % 4 || slots < 0 ||
      reps < 1 || reps > 65535)
    return cudaErrorInvalidValue;
  if (slots == 0) return cudaSuccess;
  const int64_t blocks = (slots + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(reps));
  stream_probe_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(fp), static_cast<const uint16_t*>(tiles),
      slots, channels / 4, w, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
