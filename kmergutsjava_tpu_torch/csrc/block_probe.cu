// Window probe of the u16 fingerprint plane with the block probe's
// encoding, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kmergutsjava_tpu/lookup/pallas_kernel.py
// _probe_block_kernel (launched by probe_blocks). For one query with home h
// and fingerprint q, over the window fp[h .. h+w-1] (w <= 128):
//   first_cand  = the first offset l with fp[h+l] == q,
//   first_empty = the first offset l with fp[h+l] == FP_EMPTY,
//   off   = first_cand if there is one (even after an empty slot), else 0,
//   state = has_cand + 2 * empty_any, where empty_any is an empty slot
//           anywhere in the window and has_cand a candidate before the
//           first empty slot.
// This is not _first_event's encoding (csrc/tilejoin.cu). A window that
// runs off the plane (h < 0 or h + w > plane_len) is unresolved (state 0,
// off 0), as in the tile-join kernel. Answers are written at the query's
// own position, so queries come in any order.
//
// What bounds it. The bytes the function needs: each query's fingerprint
// and home in (6 B), its off and state out (2 B), and the plane once:
// 260 MB for 22.5M queries against a 40M-slot plane, 0.078 ms at 3.35 TB/s.
// The TPU kernel's design, ported first (queries sorted by home on the
// card, a CSR of 2048-slot blocks, one CTA a block), took 0.33 ms in home
// order plus 1.39 ms for the sort and CSR. A query with no candidate must
// see its whole window (a candidate after an empty slot still counts), so
// the window is always read to its end.
// The design's answer: no sort and no CSR. Each thread takes kQueries
// consecutive queries in the caller's order: their homes and fingerprints
// come in as 16- and 8-byte vectors, each window as aligned 16-byte
// vectors (ceil((w + 7) / 8) cover any w-slot window), compared two slots
// at a time in registers with an exact test for a zero 16-bit half of
// word ^ (q * 0x10001) (and of ~word for FP_EMPTY); the per-half flags are
// gathered into bit masks with a byte permute and one multiply, and the
// first offsets are __ffs of the masks. Each test stops once its first
// offset is known; wide windows are walked in pieces of 32 slots. The
// answers go out as 4-byte stores at the queries' own positions.
// Measured on an H100 80GB HBM3 (700 W; PERF.md, Findings): 0.29 ms in
// home order, 0.69 ms in a random order (windows far apart in an 80 MB
// plane), against 1.72 / 3.68 ms for the sort, CSR and block kernel. What
// is left is latency: a thread's window loads wait on its homes, and the
// windows of its queries come one after another; streaming the homes and
// fingerprints alone, with no window, takes 0.15 ms. More queries a
// thread, all windows in flight at once, a grid-stride loop that fetches
// the next query's window ahead, and more CTAs an SM were each measured
// and were no faster.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libblock_probe.so block_probe.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/lookup/blockprobe.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_common.cuh"  // zero_halves, slot_flags, load_vec, Plane

namespace {

constexpr int kMaxWindow = 128;
constexpr int kThreads = 256;
constexpr int kFirstVecs = 3;   // loaded first: any window of w <= 17
constexpr int kQueries = 4;     // queries a thread (a multiple of 4)
constexpr int kNone = 1 << 30;  // no such offset yet

// Folds one vector into the first offsets: ``at`` is the window offset of
// its first slot, ``keep`` the slots of it inside the window. Each test
// runs only until its first offset is known.
__device__ __forceinline__ void scan_vec(uint4 v, uint32_t qq, uint32_t keep,
                                         int at, int& fc, int& fe) {
  if (fc == kNone) {
    const uint32_t c =
        slot_flags(zero_halves(v.x ^ qq), zero_halves(v.y ^ qq),
                   zero_halves(v.z ^ qq), zero_halves(v.w ^ qq)) & keep;
    if (c) fc = at + __ffs(c) - 1;
  }
  if (fe == kNone) {
    const uint32_t e = slot_flags(zero_halves(~v.x), zero_halves(~v.y),
                                  zero_halves(~v.z), zero_halves(~v.w)) &
                       keep;
    if (e) fe = at + __ffs(e) - 1;
  }
}

// The slots of the vector that starts ``from`` slots after the first
// vector's start that lie in the window [lead, span), as bits 0..7.
__device__ __forceinline__ uint32_t keep_bits(int from, int lead, int span) {
  uint32_t keep = 0xFFu;
  if (from == 0) keep = (keep << lead) & 0xFFu;
  if (span - from < 8) keep &= (1u << (span - from)) - 1u;
  return keep;
}

// One query's answer; v holds its window's first kFirstVecs vectors
// (loaded by the caller), the rest is loaded here.
__device__ __forceinline__ uint32_t answer(const Plane& P, int64_t h,
                                           uint32_t q, const uint4 (&v)[3]) {
  const uint32_t qq = q * 0x10001u;
  const int64_t e0 = h + P.shift;
  const int lead = static_cast<int>(e0 & 7);
  const int span = lead + P.w;  // slots from the first vector's start
  int fc = kNone, fe = kNone;
#pragma unroll
  for (int j = 0; j < kFirstVecs; ++j)
    if (8 * j < span)
      scan_vec(v[j], qq, keep_bits(8 * j, lead, span), 8 * j - lead, fc,
               fe);
  // a wider window: the rest four vectors at a time, loaded together
  for (int piece = 8 * kFirstVecs;
       piece < span && (fc == kNone || fe == kNone); piece += 32) {
    uint4 u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      u[j] = piece + 8 * j < span
                 ? load_vec(P.abase, (e0 >> 3) + (piece >> 3) + j, P.shift,
                            P.len)
                 : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (piece + 8 * j < span)
        scan_vec(u[j], qq, keep_bits(piece + 8 * j, lead, span),
                 piece + 8 * j - lead, fc, fe);
  }
  const bool cand_any = fc != kNone;
  const bool empty_any = fe != kNone;
  const uint32_t off = cand_any ? static_cast<uint32_t>(fc) : 0;
  const uint32_t state = (cand_any && (!empty_any || fc < fe) ? 1u : 0u) +
                         (empty_any ? 2u : 0u);
  return off | state << 8;
}

// kQueries consecutive queries a thread: their homes and fingerprints
// come in with a few vector loads, so that enough bytes are in flight for
// this streaming kernel, then each window in turn. kAligned: the inputs
// and outputs are aligned for vector loads and stores, which a thread
// uses when its queries are whole.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
block_probe_kernel(Plane P, const uint16_t* __restrict__ q_fp,
                   const int32_t* __restrict__ homes, int64_t n,
                   uint8_t* __restrict__ off, uint8_t* __restrict__ state) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kQueries;
  if (i0 >= n) return;
  const bool vec = kAligned && i0 + kQueries <= n;
  int32_t h[kQueries];
  uint32_t q[kQueries];
  if (vec) {
#pragma unroll
    for (int k = 0; k < kQueries; k += 4) {
      const int4 hv = __ldg(reinterpret_cast<const int4*>(homes + i0 + k));
      const uint2 qv = __ldg(reinterpret_cast<const uint2*>(q_fp + i0 + k));
      h[k] = hv.x, h[k + 1] = hv.y, h[k + 2] = hv.z, h[k + 3] = hv.w;
      q[k] = qv.x & 0xFFFF, q[k + 1] = qv.x >> 16;
      q[k + 2] = qv.y & 0xFFFF, q[k + 3] = qv.y >> 16;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
      h[k] = i0 + k < n ? __ldg(homes + i0 + k) : -1;
      q[k] = i0 + k < n ? __ldg(q_fp + i0 + k) : 0;
    }
  }
  uint32_t o[kQueries / 4] = {}, st[kQueries / 4] = {};
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    // a window that runs off the plane is unresolved: off 0, state 0
    if (h[k] < 0 || static_cast<int64_t>(h[k]) + P.w > P.len) continue;
    const int64_t e0 = h[k] + P.shift;
    const int span = static_cast<int>(e0 & 7) + P.w;
    uint4 v[kFirstVecs];
#pragma unroll
    for (int j = 0; j < kFirstVecs; ++j)
      v[j] = 8 * j < span ? load_vec(P.abase, (e0 >> 3) + j, P.shift, P.len)
                          : make_uint4(0, 0, 0, 0);
    const uint32_t a = answer(P, h[k], q[k], v);
    o[k / 4] |= (a & 0xFF) << (8 * (k % 4));
    st[k / 4] |= (a >> 8) << (8 * (k % 4));
  }
  if (vec) {
#pragma unroll
    for (int k = 0; k < kQueries; k += 4) {
      *reinterpret_cast<uint32_t*>(off + i0 + k) = o[k / 4];
      *reinterpret_cast<uint32_t*>(state + i0 + k) = st[k / 4];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
      if (i0 + k < n) {
        off[i0 + k] = static_cast<uint8_t>(o[k / 4] >> (8 * (k % 4)));
        state[i0 + k] = static_cast<uint8_t>(st[k / 4] >> (8 * (k % 4)));
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the probe on ``stream``; returns a CUDA error code (0 = the
// launch was accepted). Inputs: the plane fp[plane_len]; per query its
// fingerprint q_fp[n] and home homes[n], in any order. Outputs off[n] and
// state[n], at the queries' positions.
int block_probe(const void* fp, int64_t plane_len, const void* q_fp,
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
    block_probe_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                               st>>>(P, q, h, n, o, s);
  else
    block_probe_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                st>>>(P, q, h, n, o, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
