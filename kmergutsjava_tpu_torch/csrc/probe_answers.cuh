// One window's answer from the u16 fingerprint plane, shared by the kernels
// that probe it a query a thread: B1's first event (csrc/tilejoin.cu and the
// fused step's first-event form, csrc/fused_probe.cu) and B12's first
// fingerprint match (csrc/shard_probe.cu and the fused step's shard form).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_common.cuh"  // zero_halves, slot_flags, load_vec, Plane

namespace {

// The window's slots [lead, span) among the 16 slots that start ``from``
// slots after its first vector's start, as bits 0..15.
__device__ __forceinline__ uint32_t window_bits(int from, int lead,
                                                int span) {
  const int lo = max(lead - from, 0);
  const int hi = min(span - from, 16);
  return lo < hi ? (0xFFFFu >> (16 - hi)) & (0xFFFFu << lo) : 0u;
}

// The first event among the 16 slots of vectors a, b: 0 if none, else
// state << 8 | off, with ``at`` the window offset of a's first slot.
__device__ __forceinline__ uint32_t pair_event(uint4 a, uint4 b, uint32_t qq,
                                               uint32_t keep, int at) {
  const uint32_t c =
      (slot_flags(zero_halves(a.x ^ qq), zero_halves(a.y ^ qq),
                  zero_halves(a.z ^ qq), zero_halves(a.w ^ qq)) |
       slot_flags(zero_halves(b.x ^ qq), zero_halves(b.y ^ qq),
                  zero_halves(b.z ^ qq), zero_halves(b.w ^ qq)) << 8) &
      keep;
  const uint32_t e =
      (slot_flags(zero_halves(~a.x), zero_halves(~a.y), zero_halves(~a.z),
                  zero_halves(~a.w)) |
       slot_flags(zero_halves(~b.x), zero_halves(~b.y), zero_halves(~b.z),
                  zero_halves(~b.w)) << 8) &
      keep;
  const uint32_t m = c | e;
  if (!m) return 0;
  const int bit = __ffs(m) - 1;
  // a candidate outranks an empty slot at the same offset
  return (c >> bit) & 1u ? 1u << 8 | static_cast<uint32_t>(at + bit)
                         : 2u << 8;
}

__device__ __forceinline__ bool in_plane(const Plane& P, int32_t h) {
  return h >= 0 && static_cast<int64_t>(h) + P.w <= P.len;
}

// B1: one in-plane query's answer (state << 8 | off): its window read from
// the 16-byte vector that holds its home (1-8 of its slots), then two
// vectors at a time while no event is found.
__device__ __forceinline__ uint32_t answer(const Plane& P, int32_t h,
                                           uint32_t q) {
  const uint32_t qq = q * 0x10001u;
  const int64_t e0 = h + P.shift;
  const int lead = static_cast<int>(e0 & 7);  // slots before the home
  const int64_t k0 = e0 >> 3;
  const int span = lead + P.w;  // slots from the first vector's start
  uint32_t ans = pair_event(load_vec(P.abase, k0, P.shift, P.len),
                            make_uint4(0, 0, 0, 0), qq,
                            window_bits(0, lead, min(span, 8)), -lead);
  for (int from = 8; !ans && from < span; from += 16) {
    const int64_t k = k0 + (from >> 3);
    const uint4 u = load_vec(P.abase, k, P.shift, P.len);
    const uint4 w = from + 8 < span ? load_vec(P.abase, k + 1, P.shift, P.len)
                                    : make_uint4(0, 0, 0, 0);
    ans = pair_event(u, w, qq, window_bits(from, lead, span), from - lead);
  }
  return ans;
}

// The fingerprint-match flags of one vector's 8 slots, as bits 0..7.
__device__ __forceinline__ uint32_t match_bits(uint4 a, uint32_t qq) {
  return slot_flags(zero_halves(a.x ^ qq), zero_halves(a.y ^ qq),
                    zero_halves(a.z ^ qq), zero_halves(a.w ^ qq));
}

// B12: the window offset of the first match in [local, local + w), or -1
// (empty slots do not stop it).
__device__ __forceinline__ int first_match(const Plane& P, int64_t local,
                                           uint32_t q) {
  const uint32_t qq = q * 0x10001u;
  const int64_t e0 = local + P.shift;
  const int lead = static_cast<int>(e0 & 7);  // slots before the home
  const int64_t k0 = e0 >> 3;
  const int span = lead + P.w;  // slots from the first vector's start
  for (int from = 0; from < span; from += 8) {
    uint32_t m = match_bits(load_vec(P.abase, k0 + (from >> 3), P.shift,
                                     P.len), qq);
    // keep the window's slots [lead, span) among bits from..from+7
    const int lo = max(lead - from, 0);
    const int hi = min(span - from, 8);
    m &= (0xFFu >> (8 - hi)) & (0xFFu << lo);
    if (m) return from + __ffs(m) - 1 - lead;
  }
  return -1;
}

}  // namespace
