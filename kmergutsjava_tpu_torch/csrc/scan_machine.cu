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
// The state is the part of the JAX step's 19 ints (kmergutsjava_tpu/calls/
// scan_machine.py:44-59) that reaches an output (the last two hits' avg
// and oi never do) and the float32 running weight. Integer arithmetic
// wraps as int32 does in XLA; the weight is accumulated in list order with
// round-to-nearest adds (__fadd_rn: no contraction, and the library must
// not be built with --use_fast_math), recomputed from zero over a retained
// seed pair, and compared with float32(min_weighted).
//
// What bounds it. The bytes are few (20 a hit in, a flag byte a step out),
// but a container's steps are a dependent chain, so the longest container
// sets the time: its steps times the latency of one step, for a warp that
// is alone on its scheduler. That latency is the chain of instructions a
// step issues, and anything else the same warp issues (loads of the next
// hit, copies, flag write-back, loop control) lengthens it.
//
// Design. Teams of two warps for 32 containers, one a lane, taken longest
// first (the wrapper's ``order``), so the longest chains start in the first
// wave and a warp's lanes run chains of similar length; output rows do not
// move. The producer warp stages each lane's hits in shared memory, a
// chunk of kChunk rows at a time in a ring of kStages: the 16-byte blocks
// that hold the chunk's rows, by cp.async (csrc/async_copy.cuh; the
// load-store units take many small copies at the rate of loads, where one
// bulk copy a lane and chunk would wait on the copy engine), completing on
// the stage's ``full`` barrier; it also writes each stepped chunk's flags
// back, 32 containers' spans of kChunk bytes a warp. The consumer warp
// only steps: it waits on ``full``, runs the chunk's steps unrolled with
// every update a select (no branch but the rare record store), leaves the
// flag bytes in the stage and arrives on ``empty``. A lane's steps past its
// container's end change nothing; the final flush runs after the last
// chunk, and its flag is stored by the lane. The consumer warps are warps
// 0..kTeams - 1 of the block, so that they fall on different schedulers.
// The seed pair's two weights are kept in registers (w1, w2: the weights
// of the hits at S_L1STEP and S_L2STEP), moved on each append, instead of
// being read back from the hits: while fewer than two hits were appended
// those steps are 0 and the weight is hit 0's, as the JAX step's clamp
// gives (and no retain is reachable before a second append, so the clamp
// never decides a record).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libscan_machine.so scan_machine.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/calls/
// scan_machine.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kTeams = 2;                  // teams of two warps a block
constexpr int kThreads = 64 * kTeams;
constexpr int kChunk = 8;                  // hits a lane stages at a time
constexpr int kStages = 2;                 // the ring of chunks a lane
constexpr int kK = 8;                      // k-mer length (constants.K)
constexpr int kMaxHitsPerSeq = 40000;      // constants.MAX_HITS_PER_SEQ
constexpr int kCols = 5;                   // pos, oi, avg, fi, weight bits
constexpr int kRec = 7;

static_assert(kChunk % 4 == 0 && 32 % kChunk == 0,
              "a chunk's rows start at the same word of a 16-byte block, "
              "and a warp writes back whole spans of flags");

// 16-byte blocks that hold a chunk's rows (up to three words before them)
constexpr int kChunkVecs = (3 + kChunk * kCols + 3) / 4;
// Words of a lane's stage: the chunk's blocks, four times an odd number of
// words, so that 32 lanes reading the same step of their own stages fall
// on eight different bank groups.
constexpr int kLaneWords = 4 * (kChunkVecs | 1);
constexpr int kFlagStride = kChunk + 4;    // bytes, an odd number of words

struct alignas(16) TeamSmem {
  int32_t hits[kStages][32][kLaneWords];   // a stage: a chunk of each lane
  uint8_t flags[kStages][32 * kFlagStride];  // its steps' flags, by lane
  uint64_t full[kStages];                  // a stage's copies have landed
  uint64_t empty[kStages];                 // its chunk was stepped
};
static_assert(sizeof(TeamSmem) * kTeams <= 48 * 1024,
              "a block's shared memory needs no opt-in");

enum {  // the JAX step's state indices, less L2AVG, L2OI, L1AVG and L1OI
  S_LEN, S_FIRST, S_LASTPOS, S_LASTFI, S_LASTAVG, S_L2FI, S_CURFI, S_CNT,
  S_LASTCUR, S_LASTCURSTEP, S_STARTSTEP, S_L2POS, S_L2STEP, S_L1POS,
  S_L1STEP, STATE_INTS
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
  float w1, w2;  // weights of the hits at S_L1STEP and S_L2STEP
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

// processSetOfHits (process, :84-110) where ``go``, as selects: the
// record, then the list either keeps its last two hits as a seed pair or
// is cleared; returns go && emitted.
__device__ __forceinline__ bool process_if(Machine& m, const Params& p,
                                           bool go, int32_t* rec) {
  const bool emit = make_call(m, p, rec) && go;
  int32_t* st = m.st;
  const bool retain = st[S_L2FI] != st[S_CURFI] && st[S_L2FI] == st[S_LASTFI];
  const bool keep = go && retain, clear = go && !retain;
  const float w2 = __fadd_rn(__fadd_rn(0.0f, m.w2), m.w1);
  m.w = keep ? w2 : clear ? 0.0f : m.w;
  st[S_CURFI] = keep ? st[S_LASTFI] : st[S_CURFI];
  st[S_LEN] = keep ? 2 : clear ? 0 : st[S_LEN];
  st[S_FIRST] = keep ? st[S_L2POS] : st[S_FIRST];
  st[S_CNT] = keep ? 2 : clear ? 0 : st[S_CNT];
  st[S_LASTCUR] = keep ? st[S_L1POS] : st[S_LASTCUR];
  st[S_LASTCURSTEP] = keep ? st[S_L1STEP] : st[S_LASTCURSTEP];
  st[S_STARTSTEP] = keep ? st[S_L2STEP] : st[S_STARTSTEP];
  return emit;
}

__device__ __forceinline__ bool process(Machine& m, const Params& p,
                                        int32_t* rec) {
  return process_if(m, p, true, rec);
}

// Step ``step`` of a container, taking the hit (pos, avg, fi, w), where
// ``act`` (else nothing changes): the flag byte (appended | emitted << 1);
// ``rec`` is set where it emits. Every update is a select.
__device__ __forceinline__ uint32_t step_hit(Machine& m, const Params& p,
                                             bool act, int32_t step,
                                             int32_t pos, int32_t avg,
                                             int32_t fi, float w,
                                             int32_t* rec) {
  int32_t* st = m.st;
  const bool gap = act && st[S_LEN] > 0 &&
                   wadd(st[S_LASTPOS], p.max_gap) < pos;
  const bool big = st[S_LEN] >= p.min_hits;
  bool emit = process_if(m, p, gap && big, rec);
  const bool drop = gap && !big;
  st[S_LEN] = drop ? 0 : st[S_LEN];
  st[S_CNT] = drop ? 0 : st[S_CNT];
  m.w = drop ? 0.0f : m.w;
  if (act && st[S_LEN] == 0) st[S_CURFI] = fi;
  bool accept = act;
  if (p.order_constraint && st[S_LEN] != 0) {
    const int32_t d = wsub(wsub(pos, st[S_LASTPOS]),
                           wsub(st[S_LASTAVG], avg));
    const int32_t ad = d < 0 ? wsub(0, d) : d;
    accept = act && fi == st[S_LASTFI] && ad <= 20;
  }
  const bool app = accept && st[S_LEN] < kMaxHitsPerSeq - 2;
  const bool is_cur = fi == st[S_CURFI];
  const bool add = app && is_cur;
  m.w = add ? __fadd_rn(m.w, w) : m.w;
  const bool empty = st[S_LEN] == 0;
  st[S_FIRST] = app && empty ? pos : st[S_FIRST];
  st[S_STARTSTEP] = app && empty ? step : st[S_STARTSTEP];
  st[S_LEN] += app ? 1 : 0;
  st[S_L2FI] = app ? st[S_LASTFI] : st[S_L2FI];
  st[S_L2POS] = app ? st[S_L1POS] : st[S_L2POS];
  st[S_L2STEP] = app ? st[S_L1STEP] : st[S_L2STEP];
  m.w2 = app ? m.w1 : m.w2;
  st[S_LASTFI] = app ? fi : st[S_LASTFI];
  st[S_LASTPOS] = app ? pos : st[S_LASTPOS];
  st[S_LASTAVG] = app ? avg : st[S_LASTAVG];
  st[S_L1POS] = app ? pos : st[S_L1POS];
  st[S_L1STEP] = app ? step : st[S_L1STEP];
  m.w1 = app ? w : m.w1;
  st[S_CNT] += add ? 1 : 0;
  st[S_LASTCUR] = add ? pos : st[S_LASTCUR];
  st[S_LASTCURSTEP] = add ? step : st[S_LASTCURSTEP];
  const bool pair = accept && st[S_LEN] > 1 && st[S_CURFI] != fi &&
                    st[S_L2FI] == st[S_LASTFI];
  int32_t rec2[kRec];
  const bool e2 = process_if(m, p, pair, rec2);
#pragma unroll
  for (int k = 0; k < kRec; ++k) rec[k] = emit ? rec[k] : rec2[k];
  emit = emit || e2;
  return (app ? 1u : 0u) | (emit ? 2u : 0u);
}

// The producer's half of a team: for the consumer's 32 containers (lane
// by lane), the copies of each chunk into the ring of stages, kStages
// chunks ahead of the machine, and the write-back of each stepped chunk's
// flags, the warp writing each container's span of kChunk bytes.
__device__ __forceinline__ void produce(TeamSmem& ts, int lane, int64_t first,
                                        int32_t len, int64_t row,
                                        int32_t chunks,
                                        const int32_t* __restrict__ hits,
                                        int64_t n_hits,
                                        uint8_t* __restrict__ flags) {
  // This lane's container's words, from the 16-byte block of its first row
  // (its row 0 starts at word ``skew``, chunk k's at word 40 k + skew):
  // whole blocks below ``vec_end`` are copied 16 bytes at a time, the
  // words from there to ``words`` (the array's last block, where it is
  // partial) 4 bytes at a time.
  const int skew = static_cast<int>(first & 3);  // (first * 5) % 4
  const int64_t base = first * kCols - skew;
  const int32_t* __restrict__ src = hits + base;
  const int32_t words = skew + kCols * max(len, 0);
  const int32_t vec_end = static_cast<int32_t>(
      min(static_cast<int64_t>((words + 3) & ~3),
          ((n_hits * kCols) & ~int64_t{3}) - base));
  // byte b = lane % kChunk of the flag spans of containers L = j * 32 /
  // kChunk + lane / kChunk, for each j
  uint8_t* fl_out[kChunk];
  int32_t fl_last[kChunk];  // the last chunk start whose byte b is a hit's
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int L = (j * 32 + lane) / kChunk;
    fl_out[j] = flags + __shfl_sync(0xFFFFFFFFu, row, L) + lane % kChunk;
    fl_last[j] = __shfl_sync(0xFFFFFFFFu, len, L) - 1 - lane % kChunk;
  }
  for (int32_t k = 0; k < chunks + kStages; ++k) {
    const int st = k % kStages;
    if (k >= kStages) {
      // chunk k - kStages was stepped: write its flags back, free the stage
      mbar_wait(&ts.empty[st], (k / kStages - 1) & 1);
      const int32_t s0 = (k - kStages) * kChunk;
      const uint8_t* fb = ts.flags[st];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int L = (j * 32 + lane) / kChunk;
        if (s0 <= fl_last[j])
          fl_out[j][s0] = fb[L * kFlagStride + lane % kChunk];
      }
    }
    if (k < chunks) {
      int32_t* dst = ts.hits[st][lane];
      const int32_t w0 = k * kChunk * kCols;
#pragma unroll
      for (int v = 0; v < kChunkVecs; ++v)
        if (w0 + 4 * v < vec_end) cp_async16(dst + 4 * v, src + w0 + 4 * v);
      for (int32_t w = max(vec_end, w0);
           w < min(words, w0 + 4 * kChunkVecs); ++w)
        cp_async4(dst + (w - w0), src + w);
      cp_async_arrive(&ts.full[st]);
    }
  }
}

// The consumer's half of a team: the machine over this lane's container,
// a chunk at a time as its stage fills; each step's flag byte to the
// stage's flag buffer, each emitting step's record to ``rc``.
__device__ __forceinline__ void consume(TeamSmem& ts, int lane, int64_t first,
                                        int32_t len, int32_t longest,
                                        int32_t chunks, const Params& p,
                                        int32_t* __restrict__ rc,
                                        uint8_t* __restrict__ flags_row) {
  const int skew = static_cast<int>(first & 3);
  Machine m;
  for (int k = 0; k < STATE_INTS; ++k) m.st[k] = 0;
  m.w = m.w1 = m.w2 = 0.0f;
  for (int32_t k = 0; k < chunks; ++k) {
    const int st = k % kStages;
    mbar_wait(&ts.full[st], (k / kStages) & 1);
    const int32_t* h = ts.hits[st][lane] + skew;
    uint8_t* fb = ts.flags[st] + lane * kFlagStride;
    if (k == 0 && len > 0) m.w1 = m.w2 = __int_as_float(h[4]);
    const int32_t s0 = k * kChunk;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int32_t s = s0 + j;
      if (s >= longest) break;  // the warp's last hit is stepped
      const int32_t* hj = h + j * kCols;
      int32_t rec[kRec];
      const uint32_t f = step_hit(m, p, s < len, s, hj[0], hj[2], hj[3],
                                  __int_as_float(hj[4]), rec);
      fb[j] = static_cast<uint8_t>(f);
      if (f & 2u)
        for (int q = 0; q < kRec; ++q) rc[static_cast<int64_t>(s) * kRec + q]
            = rec[q];
    }
    mbar_arrive(&ts.empty[st]);
  }
  if (len >= 0) {
    // final flush at the sentinel step (ref :511-513); its flag is this
    // lane's to write, not the write-back's
    int32_t rec[kRec];
    const bool e = m.st[S_LEN] >= p.min_hits && process(m, p, rec);
    flags_row[len] = e ? 2 : 0;
    if (e)
      for (int q = 0; q < kRec; ++q)
        rc[static_cast<int64_t>(len) * kRec + q] = rec[q];
  }
}

__global__ void __launch_bounds__(kThreads)
scan_machine_kernel(const int32_t* __restrict__ hits, int64_t n_hits,
                    const int64_t* __restrict__ offsets,
                    const int32_t* __restrict__ order, int64_t n_cont,
                    Params p, uint8_t* __restrict__ flags,
                    int32_t* __restrict__ recs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp % kTeams;  // consumers on warps 0..kTeams - 1
  const bool producer = warp >= kTeams;
  TeamSmem& ts = reinterpret_cast<TeamSmem*>(smem_raw)[team];
  if (producer && lane < 2 * kStages)
    mbar_init(lane < kStages ? &ts.full[lane] : &ts.empty[lane - kStages],
              32);
  __syncthreads();
  // both warps of a team take the same 32 containers, lane by lane
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kTeams + team) * 32 + lane;
  int64_t first = 0, row = 0;
  int32_t len = -1;
  if (i < n_cont) {
    const int64_t c = order[i];
    first = offsets[c];
    len = static_cast<int32_t>(offsets[c + 1] - first);
    row = first + c;
  }
  const int32_t longest = __reduce_max_sync(0xFFFFFFFFu, len);
  if (longest < 0) return;  // the team is past the last container
  const int32_t chunks = longest / kChunk + 1;  // steps 0..longest
  if (producer)
    produce(ts, lane, first, len, row, chunks, hits, n_hits, flags);
  else
    consume(ts, lane, first, len, longest, chunks, p, recs + row * kRec,
            flags + row);
}

}  // namespace

extern "C" {

// Launches the machine on ``stream``; returns a CUDA error code (0 = the
// launch was accepted). Inputs: hits[n_hits, 5] int32 (pos, oi, avg, fi,
// the float32 weight's bits; each container's hits in position order; the
// array 16-byte aligned), the container offsets offsets[n_cont + 1]
// (int64, offsets[0] = 0, offsets[n_cont] = n_hits), ``order`` (int32, a
// permutation of the n_cont containers, longest first: the order in which
// warps take them) and the grouping parameters. Outputs: flags[n_hits +
// n_cont] u8 and recs[n_hits + n_cont, 7] int32 (written at emitting
// steps).
int scan_machine(const void* hits, int64_t n_hits, const void* offsets,
                 const void* order, int64_t n_cont, int32_t min_hits,
                 float min_weighted, int32_t max_gap,
                 int32_t order_constraint, void* flags, void* recs,
                 void* stream) {
  if (n_cont < 0 || n_hits < 0 || n_hits >= (1LL << 40) ||
      reinterpret_cast<uintptr_t>(hits) % 16 != 0)
    return cudaErrorInvalidValue;
  if (n_cont == 0) return cudaSuccess;
  const int64_t blocks = (n_cont + 32 * kTeams - 1) / (32 * kTeams);
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(TeamSmem)) * kTeams;
  const Params p{min_hits, min_weighted, max_gap, order_constraint};
  scan_machine_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hits), n_hits,
      static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(order), n_cont, p,
      static_cast<uint8_t*>(flags), static_cast<int32_t*>(recs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
