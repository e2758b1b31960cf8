// The fused step's kernel, for Hopper (sm_90a): k-mer windows from ASCII
// rows and their probe of the u16 fingerprint plane in one launch. Each
// window's packed value, home and fingerprint stay in registers, and the
// thread that made them probes the plane for them, so homes and
// fingerprints never reach device memory.
//
// Replaces, in one launch a batch, the device programs that the JAX package
// writes in XLA for the TPU: kmergutsjava_tpu/parallel/annotate_step.py
// _encode_and_probe (:52) and _dna_encode_and_probe (:96), with the probe
// they end in (parallel/sharded_lookup.py _local_probe, :129), and
// parallel/seq_windows.py _window_probe (:98), a long contig's windows. On
// the card they were the window kernel (csrc/kmer_windows.cu) followed by
// a probe that read its homes and fingerprints back: B1 (csrc/tilejoin.cu)
// on one device, B12 (csrc/shard_probe.cu) at a mesh position.
//
// Contract (the plain twin is kmergutsjava_tpu_torch/parallel/
// fused_probe.py: ops/kmer_windows.py windows_reference, then
// lookup/tilejoin.py first_event_reference or parallel/shard_probe.py
// shard_probe_reference). The windows are windows_reference's, in its flat
// order: aa rows [B, Lpad - 7] (valid for j < num_starts[b] and 8 amino
// acids), DNA rows [B, 6, Lpad/3 - 7] (valid for j < len/3 - 7, or, with
// row_map, own_start and own_end, container g reads frame row_map[b, g]
// and is valid in [own_start, own_end)), home = value % num_sigs,
// fingerprint = value % 65535. Per window:
//   first-event form: B1's answer at window w (off u8 at [0, n), state u8
//            from the 16-byte boundary after it; state 0 for a window that
//            is not valid or runs off the plane);
//   shard form: B12's answer for table shard [lo, lo + s_loc) on its plane
//            slice (global slots [lo, lo + plane_len)): the global slot + 1
//            of the first fingerprint match in the w slots from the home,
//            0 for a window that is not valid, not owned, or has none.
// Nothing of the plane is read for a window that is not valid or not
// owned.
//
// What bounds it. The bytes it needs are the rows in, the answer out (2 or
// 4 bytes a window) and, for each valid (owned) window, the 32-byte plane
// sectors up to its first event, at random in the plane: at the fused
// step's batches (512 rows of 256 bytes: 127,488 aa or 239,616 DNA
// windows, 40-60% of them not valid) a few MB, about a microsecond at 3.35
// TB/s. So a launch is one wave of short chains (the rows' bytes, the
// window, one or two random plane reads, the answer), and its time is
// their latency and the launch's fixed cost, which this kernel pays once
// where the window kernel and the probe paid it twice; the homes and
// fingerprints (6 bytes a window) are neither written nor read back.
// The window kernel's tile of one row's 256 windows left most of a block
// idle at these rows (78 DNA windows a frame at Lpad 256), staged 791
// bases a strand for them and emitted a row's six containers on one
// thread, which here would be six random plane reads in a row. So a block
// takes 256 consecutive windows of the flat order, one a thread, across
// rows and containers; it stages in shared memory only the amino-acid
// offsets its windows read (a container's run of windows and the 7 after
// it: at most 2,048 bytes), each codon made once from its three bases
// through the tables; then each thread packs its window from shared memory
// and probes the plane with B1's or B12's own code (probe_answers.cuh).
// The residue is by an exact reciprocal (kmer_common.cuh says why);
// block indices are 32-bit, divided by exact reciprocals (Div).
// Measured by chip_smoke.py on an H100 80GB HBM3 (700 W; PERF.md,
// Findings), device time a launch in turns with the two launches it
// replaces: 0.0075 ms a proteome bucket batch and 0.0134 a read batch
// (the window kernel then B1: 0.0118, 0.0190), 0.0052 / 0.0083 at a (2, 2)
// position (window kernel then B12: 0.0065, 0.0110), 0.308 the genome's
// 9.3M windows (0.294). At a batch's one wave every block stages its
// windows and then waits on its random plane reads, so the two phases add.
// In turns by chip_turns.py --fused: 23% fewer instructions (64-bit block
// indices and run-time divisions before) took 1-3% off; the validity loads
// issued before the barriers, and an L2 prefetch of the window's later
// vectors, were within 3% or slower.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_probe.so fused_probe.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/parallel/
// fused_probe.py.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "kmer_common.cuh"    // Luts, residue, pack_window, kK
#include "probe_answers.cuh"  // answer, in_plane, first_match, Plane

namespace {

constexpr int kThreads = 256;          // windows a block, one a thread
constexpr int kStage = kThreads * kK;  // offsets a block stages, at most
constexpr int kMaxFirstEvent = 256;    // B1's largest window (u8 offsets)
constexpr int kMaxShard = 128;         // B12's
static_assert(kThreads == 256, "a block copies one table entry a thread");

// Exact x / d for x < 2^31 by a multiply and a shift: m = ceil(2^(31+s) /
// d) with 2^s >= d keeps the excess of x * m / 2^(31+s) over x / d below
// 2^-s <= 1/d, so the quotient never carries (a run-time 32-bit division
// is a long sequence on the card; a block divides by two of them).
struct Div {
  uint64_t m;
  int shift;
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
    return static_cast<uint32_t>((static_cast<uint64_t>(x) * m) >> shift);
  }
};

Div div_of(uint32_t d) {
  int s = 0;
  while ((uint64_t{1} << s) < d) ++s;
  return Div{((uint64_t{1} << (31 + s)) + d - 1) / d, 31 + s};
}

struct Rows {
  const uint8_t* ascii;    // [rows, lpad]
  int64_t lpad;
  int32_t w;               // windows a container (a row, or a row's frame)
  Div by_w;                // / w
  Div by_seg;              // / (w + 7)
  int32_t n;               // windows in all (< 2^31)
  const int32_t* counts;   // num_starts (aa) or lengths (DNA) [rows]
  const int32_t* row_map;  // [rows, 6] for a long contig's windows, or null
  const int32_t* own_start;
  const int32_t* own_end;
  uint64_t ns;             // num_sigs
  uint64_t magic;          // ceil(2^66 / ns), or 0 for ns < 5
};

struct Answer {
  uint8_t* off;    // first-event form
  uint8_t* state;
  int32_t* slot;   // shard form
  int64_t lo;
  int64_t s_loc;
};

// The frame (0..5: +0 +1 +2 -0 -1 -2) that container g of DNA row b reads:
// g, or row_map's (0 where it names none: those windows are not valid).
__device__ __forceinline__ int frame_of(const Rows& R, uint32_t b, int g) {
  if (!R.row_map) return g;
  const int r = __ldg(R.row_map + b * 6 + g);
  return r >= 0 && r < 6 ? r : 0;
}

// Amino-acid offset j of container c: row c's byte j (aa), or codon j of
// the frame container c reads (DNA; the reverse strand reads base
// len-1-p complemented, a base off the row is invalid, a codon past the
// frame's end a terminator).
template <bool kAa>
__device__ __forceinline__ uint8_t offset_at(const Rows& R,
                                             const uint8_t* lut,
                                             const uint8_t* comp,
                                             const uint8_t* codon,
                                             uint32_t c, int j) {
  if (kAa)
    return j < R.lpad ? lut[__ldg(R.ascii + c * R.lpad + j)] : kTerminator;
  const uint32_t b = c / 6;
  const int r = frame_of(R, b, static_cast<int>(c - b * 6));
  const int f = r % 3;
  const int64_t len = __ldg(R.counts + b);
  if (j >= (len > f ? len - f : 0) / 3) return kTerminator;
  const uint8_t* row = R.ascii + b * R.lpad;
  const int64_t p = f + 3 * static_cast<int64_t>(j);
  uint32_t x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (r < 3) {
      x[k] = p + k < R.lpad ? lut[__ldg(row + p + k)] : kInvalidDna;
    } else {
      const int64_t q = len - 1 - (p + k);
      x[k] = q >= 0 && q < R.lpad ? comp[__ldg(row + q)] : kInvalidDna;
    }
  }
  return x[0] < 4 && x[1] < 4 && x[2] < 4
             ? codon[x[0] * 16 + x[1] * 4 + x[2]]
             : kInvalidAa;
}

// Whether window j of container c is valid by its position (the offsets
// are checked when it is packed).
template <bool kAa>
__device__ __forceinline__ bool in_range(const Rows& R, uint32_t c, int j) {
  if (kAa) return j < __ldg(R.counts + c);
  const uint32_t b = c / 6;
  if (!R.row_map) return j < __ldg(R.counts + b) / 3 - kK + 1;
  const int r = __ldg(R.row_map + c);
  return r >= 0 && r < 6 && j >= __ldg(R.own_start + c) &&
         j < __ldg(R.own_end + c);
}

template <bool kAa, bool kShard>
__global__ void __launch_bounds__(kThreads)
fused_probe_kernel(Luts L, Rows R, Plane P, Answer A) {
  __shared__ uint8_t lut[256], comp[256], codon[64];
  __shared__ uint8_t offs[kStage];
  const int t = threadIdx.x;
  lut[t] = kAa ? L.aa[t] : L.dna[t];
  if (!kAa) {
    comp[t] = L.compl_[t];
    if (t < 64) codon[t] = L.codon[t];
  }
  // the block's windows: from window d of container c0, ``items`` of the
  // flat order; window j of container c0 + s stages its 8 offsets at
  // s * seg + j - d, so container c0 + s's offsets j' lie at s * seg + j'
  // - d, and staged entry k is offset (k + d) % seg of container c0 + (k +
  // d) / seg
  const uint32_t i0 = blockIdx.x * kThreads;
  const int items = min(R.n - static_cast<int>(i0), kThreads);
  const uint32_t c0 = R.by_w(i0);
  const int d = static_cast<int>(i0 - c0 * R.w);
  const int seg = R.w + kK - 1;
  const int last = d + items - 1;
  const int last_s = R.by_w(last);
  const int staged = last_s * seg + last - last_s * R.w - d + kK;
  __syncthreads();
  for (int k = t; k < staged; k += kThreads) {
    const int s = R.by_seg(k + d);
    offs[k] = offset_at<kAa>(R, lut, comp, codon, c0 + s, k + d - s * seg);
  }
  __syncthreads();
  if (t >= items) return;
  const int s = R.by_w(t + d);
  const int j = t + d - s * R.w;
  const uint32_t c = c0 + s;
  bool ok = in_range<kAa>(R, c, j);
  const uint64_t v = pack_window(offs + s * seg + j - d, ok);
  const uint32_t i = i0 + t;
  const uint32_t q = static_cast<uint32_t>(v % kFpMod);
  if (kShard) {
    int32_t ans = 0;
    if (ok) {
      const int64_t local =
          static_cast<int64_t>(residue(v, R.ns, R.magic)) - A.lo;
      if (local >= 0 && local < A.s_loc) {
        const int o = first_match(P, local, q);
        if (o >= 0) ans = static_cast<int32_t>(A.lo + local + o + 1);
      }
    }
    A.slot[i] = ans;
  } else {
    uint32_t ans = 0;
    if (ok) {
      const int32_t h = static_cast<int32_t>(residue(v, R.ns, R.magic));
      if (in_plane(P, h)) ans = answer(P, h, q);
    }
    A.off[i] = static_cast<uint8_t>(ans);
    A.state[i] = static_cast<uint8_t>(ans >> 8);
  }
}

// Checks the rows and fills R; returns a CUDA error code (0 = good) and
// the blocks to launch in *blocks (0: no window).
int rows_of(bool aa, const void* ascii, int64_t rows, int64_t lpad,
            const void* counts, const void* row_map, const void* own_start,
            const void* own_end, int64_t num_sigs, uint64_t magic, Rows* R,
            unsigned* blocks) {
  const bool windowed = row_map != nullptr;
  if (rows < 0 || lpad < 0 || lpad >= (1LL << 30) || num_sigs < 1 ||
      num_sigs >= (1LL << 31) || (aa && windowed) ||
      windowed != (own_start != nullptr) || windowed != (own_end != nullptr))
    return cudaErrorInvalidValue;
  const int64_t w = (aa ? lpad : lpad / 3) - (kK - 1);
  const int64_t n = w > 0 ? rows * (aa ? 1 : 6) * w : 0;
  if (n >= (1LL << 31)) return cudaErrorInvalidValue;
  const auto w1 = static_cast<uint32_t>(w > 0 ? w : 1);
  *R = Rows{static_cast<const uint8_t*>(ascii), lpad,
            static_cast<int32_t>(w1), div_of(w1), div_of(w1 + kK - 1),
            static_cast<int32_t>(n), static_cast<const int32_t*>(counts),
            static_cast<const int32_t*>(row_map),
            static_cast<const int32_t*>(own_start),
            static_cast<const int32_t*>(own_end),
            static_cast<uint64_t>(num_sigs), magic};
  *blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  return cudaSuccess;
}

Plane plane_of(const void* plane, int64_t plane_len, int32_t w) {
  const int64_t shift = (reinterpret_cast<uintptr_t>(plane) % 16) / 2;
  return Plane{static_cast<const uint16_t*>(plane) - shift, shift, plane_len,
               w};
}

template <bool kShard>
int launch(const void* luts, bool aa, const Rows& R, unsigned blocks,
           const Plane& P, const Answer& A, void* stream) {
  Luts L;
  std::memcpy(&L, luts, sizeof(L));
  const auto st = static_cast<cudaStream_t>(stream);
  if (aa)
    fused_probe_kernel<true, kShard><<<blocks, kThreads, 0, st>>>(L, R, P, A);
  else
    fused_probe_kernel<false, kShard><<<blocks, kThreads, 0, st>>>(L, R, P,
                                                                    A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on ``stream``; returns a CUDA error code (0 = the launch was
// accepted). ``luts``: the 832 host bytes of struct Luts. Rows: ``aa``
// (counts = num_starts) or DNA (counts = lengths; row_map, own_start and
// own_end all null, or all given for a long contig's windows). The
// magic is ceil(2^66 / num_sigs), or 0 below 5. Output: B1's answer to
// each window at window w on plane[plane_len], off[n] and state[n].
int fused_first_event(const void* luts, int aa, const void* ascii,
                      int64_t rows, int64_t lpad, const void* counts,
                      const void* row_map, const void* own_start,
                      const void* own_end, int64_t num_sigs, uint64_t magic,
                      const void* plane, int64_t plane_len, int32_t w,
                      void* off, void* state, void* stream) {
  Rows R;
  unsigned blocks;
  int rc = rows_of(aa, ascii, rows, lpad, counts, row_map, own_start,
                   own_end, num_sigs, magic, &R, &blocks);
  if (rc) return rc;
  if (w < 1 || w > kMaxFirstEvent || plane_len < 0 ||
      reinterpret_cast<uintptr_t>(plane) % 2)
    return cudaErrorInvalidValue;
  if (!blocks) return cudaSuccess;
  return launch<false>(luts, aa, R, blocks, plane_of(plane, plane_len, w),
                       Answer{static_cast<uint8_t*>(off),
                              static_cast<uint8_t*>(state), nullptr, 0, 0},
                       stream);
}

// The same rows; output: B12's answer to each window, slot[n] (int32), for
// the table shard that owns global slots [lo, lo + s_loc) and holds them
// with a halo of w slots in plane[plane_len] (global slots from lo).
int fused_shard_probe(const void* luts, int aa, const void* ascii,
                      int64_t rows, int64_t lpad, const void* counts,
                      const void* row_map, const void* own_start,
                      const void* own_end, int64_t num_sigs, uint64_t magic,
                      const void* plane, int64_t plane_len, int64_t lo,
                      int64_t s_loc, int32_t w, void* slot, void* stream) {
  Rows R;
  unsigned blocks;
  int rc = rows_of(aa, ascii, rows, lpad, counts, row_map, own_start,
                   own_end, num_sigs, magic, &R, &blocks);
  if (rc) return rc;
  if (w < 1 || w > kMaxShard || s_loc < 0 || lo < 0 ||
      plane_len < s_loc + w || reinterpret_cast<uintptr_t>(plane) % 2 ||
      lo + s_loc + w >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (!blocks) return cudaSuccess;
  return launch<true>(luts, aa, R, blocks, plane_of(plane, plane_len, w),
                      Answer{nullptr, nullptr, static_cast<int32_t*>(slot),
                             lo, s_loc},
                      stream);
}

}  // extern "C"
