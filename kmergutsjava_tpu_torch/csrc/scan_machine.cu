// The call-grouping state machine (gatherHits / processSetOfHits of the
// reference) over containers of position-sorted hits, for Hopper (sm_90a).
//
// Replaces the JAX package's device program
// kmergutsjava_tpu/calls/scan_machine.py _scan_container (:62), vmapped by
// scan_containers (:214): a lax.scan over each container's hits, written in
// XLA for the TPU. A container of len hits runs len + 1 steps: step s < len
// takes hit s, step len is the final flush. Each step writes one flag byte
// (bit 0: the hit was appended to the list, bit 1: a CALL was emitted) and,
// where it emits, the 7-int call record (fi, start, end, count, start
// step, end step, the float32 weight's bits); records of other steps are
// not written. Step s of container c is output row offsets[c] + c + s.
//
// The state is the JAX step's: 19 ints (kmergutsjava_tpu/calls/
// scan_machine.py:44-59) and the float32 running weight. Integer arithmetic
// wraps as int32 does in XLA; the weight is accumulated in list order with
// round-to-nearest adds (__fadd_rn: no contraction, and the library must
// not be built with --use_fast_math), recomputed from zero over a retained
// seed pair, and compared with float32(min_weighted).
//
// Design: one thread a container, the state in registers, the hits read in
// order from the ragged columns (no padding: a thread loops over its own
// length). The JAX package pads containers to power-of-two buckets only so
// that XLA reuses compiled shapes; nothing here needs that. A container's
// steps are a dependent chain, so the longest container sets the time when
// the batch is small; coalesced layouts are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libscan_machine.so scan_machine.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/calls/
// scan_machine.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kK = 8;                      // k-mer length (constants.K)
constexpr int kMaxHitsPerSeq = 40000;      // constants.MAX_HITS_PER_SEQ
constexpr int kCols = 5;                   // pos, oi, avg, fi, weight bits
constexpr int kRec = 7;

enum {
  S_LEN, S_FIRST, S_LASTPOS, S_LASTFI, S_LASTAVG, S_L2FI, S_CURFI, S_CNT,
  S_LASTCUR, S_LASTCURSTEP, S_STARTSTEP, S_L2POS, S_L2AVG, S_L2OI, S_L2STEP,
  S_L1POS, S_L1AVG, S_L1OI, S_L1STEP, STATE_INTS
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

struct Params {
  int32_t min_hits;
  float min_weighted;
  int32_t max_gap;
  int32_t order_constraint;
};

struct Machine {
  int32_t st[STATE_INTS];
  float w;
};

// The CALL record of the current state and whether it passes the
// emission thresholds (make_call, :74-82).
__device__ __forceinline__ bool make_call(const Machine& m, const Params& p,
                                          int32_t* rec) {
  rec[0] = m.st[S_CURFI];
  rec[1] = m.st[S_FIRST];
  rec[2] = wadd(m.st[S_LASTCUR], kK - 1);
  rec[3] = m.st[S_CNT];
  rec[4] = m.st[S_STARTSTEP];
  rec[5] = m.st[S_LASTCURSTEP];
  rec[6] = __float_as_int(m.w);
  return m.st[S_CNT] >= p.min_hits && m.w >= p.min_weighted;
}

// processSetOfHits (process, :84-110): the record, then the list either
// keeps its last two hits as a seed pair or is cleared.
__device__ __forceinline__ bool process(Machine& m, const Params& p,
                                        const int32_t* __restrict__ h,
                                        int64_t len, int32_t* rec) {
  const bool emit = make_call(m, p, rec);
  int32_t* st = m.st;
  const bool retain = st[S_L2FI] != st[S_CURFI] && st[S_L2FI] == st[S_LASTFI];
  if (retain) {
    // the seed pair's weight, recomputed in list order from zero
    auto wt = [&](int32_t step) {
      const int64_t s = step < 0 ? 0 : step >= len ? len - 1 : step;
      return __int_as_float(__ldg(h + s * kCols + 4));
    };
    m.w = __fadd_rn(__fadd_rn(0.0f, wt(st[S_L2STEP])), wt(st[S_L1STEP]));
    st[S_CURFI] = st[S_LASTFI];
    st[S_LEN] = 2;
    st[S_FIRST] = st[S_L2POS];
    st[S_CNT] = 2;
    st[S_LASTCUR] = st[S_L1POS];
    st[S_LASTCURSTEP] = st[S_L1STEP];
    st[S_STARTSTEP] = st[S_L2STEP];
  } else {
    m.w = 0.0f;
    st[S_LEN] = 0;
    st[S_CNT] = 0;
  }
  return emit;
}

__global__ void __launch_bounds__(kThreads)
scan_machine_kernel(const int32_t* __restrict__ hits,
                    const int64_t* __restrict__ offsets, int64_t n_cont,
                    Params p, uint8_t* __restrict__ flags,
                    int32_t* __restrict__ recs) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= n_cont) return;
  const int64_t first = offsets[c];
  const int64_t len = offsets[c + 1] - first;
  const int32_t* __restrict__ h = hits + first * kCols;
  uint8_t* __restrict__ fl = flags + first + c;
  int32_t* __restrict__ rc = recs + (first + c) * kRec;

  Machine m;
  for (int k = 0; k < STATE_INTS; ++k) m.st[k] = 0;
  m.w = 0.0f;
  int32_t* st = m.st;
  for (int64_t s = 0; s <= len; ++s) {
    const int32_t step = static_cast<int32_t>(s);
    int32_t rec[kRec];
    bool emit = false;
    bool appended = false;
    if (s < len) {
      const int32_t pos = __ldg(h + s * kCols);
      const int32_t oi = __ldg(h + s * kCols + 1);
      const int32_t avg = __ldg(h + s * kCols + 2);
      const int32_t fi = __ldg(h + s * kCols + 3);
      const float w = __int_as_float(__ldg(h + s * kCols + 4));
      // gap close (ref :477-484)
      if (st[S_LEN] > 0 && wadd(st[S_LASTPOS], p.max_gap) < pos) {
        if (st[S_LEN] >= p.min_hits) {
          emit = process(m, p, h, len, rec);
        } else {
          st[S_LEN] = 0;
          st[S_CNT] = 0;
          m.w = 0.0f;
        }
      }
      // currentFI reset on an empty list (ref :486-488)
      if (st[S_LEN] == 0) st[S_CURFI] = fi;
      // order constraint (ref :490-494)
      bool accept = true;
      if (p.order_constraint && st[S_LEN] != 0) {
        const int32_t d = wsub(wsub(pos, st[S_LASTPOS]),
                               wsub(st[S_LASTAVG], avg));
        const int32_t ad = d < 0 ? wsub(0, d) : d;
        accept = fi == st[S_LASTFI] && ad <= 20;
      }
      // append (ref :496-502)
      if (accept && st[S_LEN] < kMaxHitsPerSeq - 2) {
        appended = true;
        const bool is_cur = fi == st[S_CURFI];
        if (is_cur) m.w = __fadd_rn(m.w, w);
        if (st[S_LEN] == 0) {
          st[S_FIRST] = pos;
          st[S_STARTSTEP] = step;
        }
        st[S_LEN] += 1;
        st[S_L2FI] = st[S_LASTFI];
        st[S_L2POS] = st[S_L1POS];
        st[S_L2AVG] = st[S_L1AVG];
        st[S_L2OI] = st[S_L1OI];
        st[S_L2STEP] = st[S_L1STEP];
        st[S_LASTFI] = fi;
        st[S_LASTPOS] = pos;
        st[S_LASTAVG] = avg;
        st[S_L1POS] = pos;
        st[S_L1AVG] = avg;
        st[S_L1OI] = oi;
        st[S_L1STEP] = step;
        if (is_cur) {
          st[S_CNT] += 1;
          st[S_LASTCUR] = pos;
          st[S_LASTCURSTEP] = step;
        }
      }
      // pair trigger (ref :503-508), checked even when the append was
      // capped; the JAX step keeps the gap close's record when both emit
      if (accept && st[S_LEN] > 1 && st[S_CURFI] != fi &&
          st[S_L2FI] == st[S_LASTFI]) {
        int32_t rec2[kRec];
        const bool e2 = process(m, p, h, len, rec2);
        if (e2 && !emit)
          for (int k = 0; k < kRec; ++k) rec[k] = rec2[k];
        emit = emit || e2;
      }
    } else if (st[S_LEN] >= p.min_hits) {
      // final flush at the sentinel step (ref :511-513)
      emit = process(m, p, h, len, rec);
    }
    fl[s] = static_cast<uint8_t>((appended ? 1 : 0) | (emit ? 2 : 0));
    if (emit)
      for (int k = 0; k < kRec; ++k) rc[s * kRec + k] = rec[k];
  }
}

}  // namespace

extern "C" {

// Launches the machine on ``stream``; returns a CUDA error code (0 = the
// launch was accepted). Inputs: hits[n, 5] int32 (pos, oi, avg, fi, the
// float32 weight's bits; each container's hits in position order), the
// container offsets offsets[n_cont + 1] (int64, offsets[0] = 0,
// offsets[n_cont] = n) and the grouping parameters. Outputs: flags[n +
// n_cont] u8 and recs[n + n_cont, 7] int32 (written at emitting steps).
int scan_machine(const void* hits, const void* offsets, int64_t n_cont,
                 int32_t min_hits, float min_weighted, int32_t max_gap,
                 int32_t order_constraint, void* flags, void* recs,
                 void* stream) {
  if (n_cont < 0) return cudaErrorInvalidValue;
  if (n_cont == 0) return cudaSuccess;
  const int64_t blocks = (n_cont + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const Params p{min_hits, min_weighted, max_gap, order_constraint};
  scan_machine_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hits), static_cast<const int64_t*>(offsets),
      n_cont, p, static_cast<uint8_t*>(flags), static_cast<int32_t*>(recs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
