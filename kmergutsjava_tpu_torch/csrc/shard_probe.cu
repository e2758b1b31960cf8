// Shard probe of one table shard's slice of the u16 fingerprint plane, for
// Hopper (sm_90a).
//
// Replaces the JAX package's device program
// kmergutsjava_tpu/parallel/sharded_lookup.py _local_probe (written in XLA
// for the TPU, run under shard_map on every position of a data x table
// mesh). A table shard t owns the slots [lo, lo + s_loc), lo = t * s_loc,
// and holds them with a halo of w slots: the plane slice
// plane[0, s_loc + w) is global slots [lo, lo + s_loc + w). For each query
// whose home falls in the owned range (local = home - lo in [0, s_loc)) the
// answer is the global slot + 1 of the FIRST slot of its w-slot window
// that holds the query's fingerprint (empty slots do not stop it: this is
// not B1's first-event contract), as int32; 0 for a query the shard does
// not own (a negative home included) or with no match. Summed over the
// table axis, every query gets its owner's answer.
//
// What bounds it. Each query's home (4 B) and fingerprint (2 B) in and its
// answer (4 B) out, and for the queries it owns (1 in T of them) the
// plane's sectors under the window: at the tables' windows (w <= 32 at
// load 0.6) one or two random sectors a query, and empty slots do not end
// a window, so a window with no match (most of them) reads all of its
// slots. Like B1 it is bound by random reads of device memory, which the
// L2 fetches 64 bytes at a time: at the sharded (2, 2) run's data row
// (2,019,072 queries, 1,030,866 owned, a 20M-slot shard, w=16) about 1.5
// such fetches an owned query, some 100 MB, 0.030 ms at 3.35 TB/s, beside
// 20 MB of queries and answers. The design is B1's reading: one thread a
// query, the window read as aligned 16-byte vectors from the one that
// holds its home (probe_common.cuh), each compared two slots a word; it
// stops at the first match or the window's end, and a query the shard
// does not own reads nothing of the plane. Measured in turns by
// chip_turns.py --shard on an H100 80GB HBM3 (700 W; PERF.md, Findings):
// 0.0365-0.0377 ms at that shape, and no other design was faster: each
// warp listing its owned queries of 128 in shared memory and its lanes
// probing only those, up to three windows a lane in flight (0.0390-0.0404
// ms; one or two vectors ahead 0.0383-0.0396), four queries a thread read
// as vectors (0.0396-0.0411), a window's first two vectors loaded before
// any compare (0.0364-0.0372: no gain), all of them (0.0441), the two
// vectors of the home's 32-byte sector first (0.0372-0.0374). Half the
// lanes of a warp idle is not what holds it: the random fetches are. The
// TPU program's 128-lane overlapped rows (shard_table_planes) are a
// layout for its row gather and are not carried.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libshard_probe.so shard_probe.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/parallel/
// shard_probe.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_answers.cuh"  // first_match (probe_common.cuh)

namespace {

constexpr int kMaxWindow = 128;  // the sharded lookup's largest window
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
shard_probe_kernel(Plane P, const uint16_t* __restrict__ q_fp,
                   const int32_t* __restrict__ homes, int64_t n, int64_t lo,
                   int64_t s_loc, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t local = static_cast<int64_t>(__ldg(homes + i)) - lo;
  int32_t ans = 0;
  if (local >= 0 && local < s_loc) {
    const int off = first_match(P, local, __ldg(q_fp + i));
    if (off >= 0) ans = static_cast<int32_t>(lo + local + off + 1);
  }
  out[i] = ans;
}

}  // namespace

extern "C" {

// Launches the probe on ``stream``; returns a CUDA error code (0 = the
// launch was accepted). Inputs: the shard's plane slice plane[plane_len]
// (plane_len >= s_loc + w), per query its fingerprint q_fp[n] and global
// home slot homes[n], the shard's first slot lo and slot count s_loc;
// output out[n].
int shard_probe(const void* plane, int64_t plane_len, const void* q_fp,
                const void* homes, int64_t n, int64_t lo, int64_t s_loc,
                int32_t w, void* out, void* stream) {
  const auto addr = reinterpret_cast<uintptr_t>(plane);
  if (w < 1 || w > kMaxWindow || n < 0 || s_loc < 0 || lo < 0 ||
      plane_len < s_loc + w || addr % 2 || lo + s_loc + w >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const int64_t shift = (addr % 16) / 2;
  const Plane P{static_cast<const uint16_t*>(plane) - shift, shift,
                plane_len, w};
  shard_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const uint16_t*>(q_fp),
      static_cast<const int32_t*>(homes), n, lo, s_loc,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
