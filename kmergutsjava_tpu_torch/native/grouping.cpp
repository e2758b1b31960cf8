// Native core of the hit-grouping state machine (CALL/OTU), batch form.
//
// Exact transcription of the reference's gatherHits/processSetOfHits
// (/root/reference/lib/src/kmergutsjava/KmerGutsJava.java:457-514 and
// :385-455), matching kmergutsjava_tpu/calls/grouping.py line for line:
// gap segmentation with seed-pair carryover, mid-run new-function-pair
// triggers, the MAX_HITS_PER_SEQ-2 append cap, the optional order
// constraint, float32 weight accumulation in hit order, and the weight
// threshold compared in double (numpy float64 promotion semantics, which
// match Java's float-vs-int promotion for all realistic values).
//
// The batch runs many containers in one call; per emitted CALL it also
// emits the OTU increments (run-length encoded over consecutive equal
// oIs). emit_report below then renders the ENTIRE report text (sequence
// headers, CALL lines with Java HALF_UP "%f" weights, and the top-5
// move-to-front OTU-COUNTS lines) in one pass, so the non-debug grouping
// phase has no per-sequence Python at all; utils/javafmt stays the
// formatting oracle (tests/test_javafmt.py pins the C++ twin to it).
//
// Build: g++ -O3 -shared -fPIC -o grouping.so grouping.cpp

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <utility>
#include <vector>

#include "threading.h"

namespace {
constexpr int K = 8;
constexpr long CAP = 40000 - 2;  // MAX_HITS_PER_SEQ - 2 (ref :496-502)

using kmer_native::num_threads;
using kmer_native::parallel_for_threads;
}  // namespace

// One container range [c_begin, c_end) of the batch machine; outputs are
// appended from slot 0 of the given arrays. Returns n_calls (n_upds via
// out param), -1 on output overflow, -2 on a <2-hit processSetOfHits.
static int64_t group_range(
    const int64_t* pos, const int32_t* otu, const int32_t* avg,
    const int32_t* fi, const float* wt,
    const int64_t* bounds, int64_t c_begin, int64_t c_end,
    int64_t min_hits, int64_t min_weighted_hits, int64_t max_gap,
    int32_t order_constraint,
    int64_t* call_container, int64_t* call_start, int64_t* call_end,
    int32_t* call_count, int32_t* call_fi, float* call_weight,
    int32_t* call_nupd, int32_t* upd_oi, int32_t* upd_inc,
    int64_t max_calls, int64_t max_upds, int64_t* out_n_upds) {
  int64_t n_calls = 0, n_upds = 0;
  std::vector<int64_t> hits;
  for (int64_t c = c_begin; c < c_end; ++c) {
    const int64_t a = bounds[c], b = bounds[c + 1];
    hits.clear();
    int32_t current_fi = 0;
    bool overflow = false, too_few = false;

    // processSetOfHits (ref :385-455); returns the next currentFI
    auto process = [&]() -> int32_t {
      int64_t cnt = 0;
      float weighted = 0.0f;  // float accumulation in hit order (ref :393)
      int64_t end_hit = hits[0];
      for (int64_t idx : hits)
        if (fi[idx] == current_fi) {
          ++cnt;
          weighted += wt[idx];
          end_hit = idx;
        }
      if (cnt >= min_hits && (double)weighted >= (double)min_weighted_hits) {
        if (n_calls >= max_calls) { overflow = true; return current_fi; }
        call_container[n_calls] = c;
        call_start[n_calls] = pos[hits[0]];
        call_end[n_calls] = pos[end_hit] + (K - 1);
        call_count[n_calls] = (int32_t)cnt;
        call_fi[n_calls] = current_fi;
        call_weight[n_calls] = weighted;
        // OTU increments: called hits in order, RLE over equal oIs
        int32_t nupd = 0;
        int32_t run_oi = 0, run_len = 0;
        for (int64_t idx : hits) {
          if (fi[idx] != current_fi) continue;
          if (run_len && otu[idx] == run_oi) {
            ++run_len;
          } else {
            if (run_len) {
              if (n_upds >= max_upds) { overflow = true; return current_fi; }
              upd_oi[n_upds] = run_oi;
              upd_inc[n_upds] = run_len;
              ++n_upds;
              ++nupd;
            }
            run_oi = otu[idx];
            run_len = 1;
          }
        }
        if (run_len) {
          if (n_upds >= max_upds) { overflow = true; return current_fi; }
          upd_oi[n_upds] = run_oi;
          upd_inc[n_upds] = run_len;
          ++n_upds;
          ++nupd;
        }
        call_nupd[n_calls] = nupd;
        ++n_calls;
      }
      const size_t num = hits.size();
      if (num < 2) { too_few = true; return current_fi; }  // ref throws (:442)
      // trailing pair with a new shared fI seeds the next run (ref :441-450)
      if (fi[hits[num - 2]] != current_fi
          && fi[hits[num - 2]] == fi[hits[num - 1]]) {
        int32_t next_fi = fi[hits[num - 1]];
        int64_t s1 = hits[num - 2], s2 = hits[num - 1];
        hits.clear();
        hits.push_back(s1);
        hits.push_back(s2);
        return next_fi;
      }
      hits.clear();
      return current_fi;
    };

    // gatherHits main loop (ref :457-514); input is position-sorted
    for (int64_t i = a; i < b && !overflow && !too_few; ++i) {
      if (!hits.empty() && pos[hits.back()] + max_gap < pos[i]) {
        if ((int64_t)hits.size() >= min_hits)
          current_fi = process();
        else
          hits.clear();
        if (overflow || too_few) break;
      }
      if (hits.empty()) current_fi = fi[i];
      bool accept = true;
      if (order_constraint && !hits.empty()) {
        const int64_t last = hits.back();
        const int64_t d = (pos[i] - pos[last])
                          - (int64_t)(avg[last] - avg[i]);
        accept = (fi[i] == fi[last]) && (d <= 20 && d >= -20);
      }
      if (accept) {
        if ((int64_t)hits.size() < CAP) hits.push_back(i);
        if (current_fi != fi[i] && hits.size() > 1
            && fi[hits[hits.size() - 2]] == fi[hits[hits.size() - 1]])
          current_fi = process();
      }
    }
    if (too_few) return -2;
    if (overflow) return -1;
    if ((int64_t)hits.size() >= min_hits) {
      current_fi = process();
      if (too_few) return -2;
      if (overflow) return -1;
    }
  }
  *out_n_upds = n_upds;
  return n_calls;
}

extern "C" int64_t group_batch(
    const int64_t* pos, const int32_t* otu, const int32_t* avg,
    const int32_t* fi, const float* wt,
    const int64_t* bounds, int64_t n_containers,
    int64_t min_hits, int64_t min_weighted_hits, int64_t max_gap,
    int32_t order_constraint,
    // outputs: one record per emitted CALL (+ its RLE OTU updates)
    int64_t* call_container, int64_t* call_start, int64_t* call_end,
    int32_t* call_count, int32_t* call_fi, float* call_weight,
    int32_t* call_nupd, int32_t* upd_oi, int32_t* upd_inc,
    int64_t max_calls, int64_t max_upds) {
  const int64_t total = n_containers ? bounds[n_containers] - bounds[0] : 0;
  const int T0 = num_threads();
  const int T = (total < (int64_t)1 << 16 || n_containers < 2) ? 1
      : (int)((int64_t)T0 < n_containers ? T0 : n_containers);
  if (T <= 1) {
    int64_t n_upds = 0;
    return group_range(pos, otu, avg, fi, wt, bounds, 0, n_containers,
                       min_hits, min_weighted_hits, max_gap,
                       order_constraint, call_container, call_start,
                       call_end, call_count, call_fi, call_weight,
                       call_nupd, upd_oi, upd_inc, max_calls, max_upds,
                       &n_upds);
  }
  // Containers are independent: split the batch into T contiguous ranges
  // balanced by hit count, run each into exactly-bounded thread-local
  // buffers (<= hits + containers + 1 calls, <= 2*hits + 2 updates — the
  // same worst-case formula the caller sizes the global arrays with),
  // then stitch in range order. Output bytes identical to the sequential
  // pass (order preserved; call_container indices are global already).
  struct Range {
    int64_t c0, c1, calls_cap, upds_cap, n_calls, n_upds, rc;
    std::vector<int64_t> cc, cs, ce;
    std::vector<int32_t> cnt, cfi, nupd, uoi, uinc;
    std::vector<float> cw;
  };
  std::vector<Range> ranges(T);
  int64_t c0 = 0;
  for (int t = 0; t < T; ++t) {
    // advance until this range holds ~1/T'th of the remaining hits
    const int64_t want = (total + T - 1) / T;
    int64_t c1 = c0;
    while (c1 < n_containers
           && (t == T - 1 || bounds[c1 + 1] - bounds[c0] <= want))
      ++c1;
    if (c1 == c0 && c0 < n_containers) ++c1;  // giant container: take one
    Range& r = ranges[t];
    r.c0 = c0;
    r.c1 = c1;
    const int64_t h = bounds[c1] - bounds[c0];
    r.calls_cap = h + (c1 - c0) + 1;
    r.upds_cap = 2 * h + 2;
    c0 = c1;
  }
  parallel_for_threads(T, [&](int t) {
    Range& r = ranges[t];
    r.cc.resize(r.calls_cap);
    r.cs.resize(r.calls_cap);
    r.ce.resize(r.calls_cap);
    r.cnt.resize(r.calls_cap);
    r.cfi.resize(r.calls_cap);
    r.cw.resize(r.calls_cap);
    r.nupd.resize(r.calls_cap);
    r.uoi.resize(r.upds_cap);
    r.uinc.resize(r.upds_cap);
    r.n_upds = 0;
    r.rc = group_range(pos, otu, avg, fi, wt, bounds, r.c0, r.c1,
                       min_hits, min_weighted_hits, max_gap,
                       order_constraint, r.cc.data(), r.cs.data(),
                       r.ce.data(), r.cnt.data(), r.cfi.data(),
                       r.cw.data(), r.nupd.data(), r.uoi.data(),
                       r.uinc.data(), r.calls_cap, r.upds_cap, &r.n_upds);
    r.n_calls = r.rc >= 0 ? r.rc : 0;
  });
  int64_t n_calls = 0, n_upds = 0;
  for (int t = 0; t < T; ++t) {
    const Range& r = ranges[t];
    if (r.rc < 0) return r.rc;
    if (n_calls + r.n_calls > max_calls || n_upds + r.n_upds > max_upds)
      return -1;
    std::memcpy(call_container + n_calls, r.cc.data(),
                sizeof(int64_t) * r.n_calls);
    std::memcpy(call_start + n_calls, r.cs.data(),
                sizeof(int64_t) * r.n_calls);
    std::memcpy(call_end + n_calls, r.ce.data(),
                sizeof(int64_t) * r.n_calls);
    std::memcpy(call_count + n_calls, r.cnt.data(),
                sizeof(int32_t) * r.n_calls);
    std::memcpy(call_fi + n_calls, r.cfi.data(),
                sizeof(int32_t) * r.n_calls);
    std::memcpy(call_weight + n_calls, r.cw.data(),
                sizeof(float) * r.n_calls);
    std::memcpy(call_nupd + n_calls, r.nupd.data(),
                sizeof(int32_t) * r.n_calls);
    std::memcpy(upd_oi + n_upds, r.uoi.data(), sizeof(int32_t) * r.n_upds);
    std::memcpy(upd_inc + n_upds, r.uinc.data(),
                sizeof(int32_t) * r.n_upds);
    n_calls += r.n_calls;
    n_upds += r.n_upds;
  }
  return n_calls;
}

namespace {

inline char* put_u64(char* p, uint64_t v) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

inline char* put_i64(char* p, int64_t v) {
  if (v < 0) {
    *p++ = '-';
    return put_u64(p, (uint64_t)(-(v + 1)) + 1);
  }
  return put_u64(p, (uint64_t)v);
}

inline char* put_bytes(char* p, const void* s, int64_t n) {
  std::memcpy(p, s, (size_t)n);
  return p + n;
}

// Java String.format("%f", w): 6 decimals, ROUND HALF UP on the exact
// binary value of the (float->double promoted) weight. utils/javafmt.py is
// the decimal-arithmetic oracle. printf is correctly rounded on the exact
// value too, but half-to-EVEN; the two differ only when the exact value
// terminates exactly halfway at 6 digits. That case is decided exactly
// here: |v|*1e6 is an exact double product for any float32-sourced v
// (24-bit significand times 5^6's 14 bits stays under 53), so a
// fractional part of exactly 0.5 is detectable and rounded away from
// zero; everything else defers to printf's nearest = HALF_UP.
inline char* put_jweight(char* p, float wf) {
  const double v = (double)wf;
  if (std::isnan(v)) return put_bytes(p, "NaN", 3);
  if (std::isinf(v))
    return v > 0 ? put_bytes(p, "Infinity", 8) : put_bytes(p, "-Infinity", 9);
  const double a = std::fabs(v) * 1e6;  // exact (see above)
  const double fl = std::floor(a);
  if (a - fl == 0.5) {
    // exactly halfway: HALF_UP rounds away from zero. a < 2^52 here (a
    // double that large has no fractional bits), so the int64 is exact.
    const uint64_t n = (uint64_t)fl + 1;
    if (std::signbit(v)) *p++ = '-';
    p = put_u64(p, n / 1000000);
    *p++ = '.';
    uint64_t f = n % 1000000;
    for (int i = 5; i >= 0; --i) {
      p[i] = (char)('0' + f % 10);
      f /= 10;
    }
    return p + 6;
  }
  // glibc %f prints the correctly-rounded exact expansion (float32 range
  // tops out near 3.4e38: at most ~39 integer digits + sign + 7 = fits 64)
  return p + std::snprintf(p, 64, "%.6f", v);
}

// top-5 move-to-front OTU counter (ref :411-439), batch increments exact
// per the argument at calls/grouping._otu_add_batch
struct OtuCounter {
  int32_t oi[5];
  int64_t cnt[5];
  int n = 0;
  void add(int32_t o, int64_t inc) {
    int j = 0;
    while (j < n && oi[j] != o) ++j;
    if (j == n) {
      if (n == 5) {
        j = 4;
      } else {
        j = n++;
      }
      oi[j] = o;
      cnt[j] = inc;
    } else {
      cnt[j] += inc;
    }
    while (j > 0 && cnt[j - 1] <= cnt[j]) {
      std::swap(oi[j - 1], oi[j]);
      std::swap(cnt[j - 1], cnt[j]);
      --j;
    }
  }
};

}  // namespace

// test hook: format one weight exactly as emit_report's CALL lines do
// (differentially pinned to utils/javafmt.jformat in tests/test_javafmt.py)
extern "C" int64_t jweight(float w, uint8_t* out) {
  return put_jweight((char*)out, w) - (char*)out;
}

// Render the whole non-debug report (the emission side of the reference's
// processSeq/processAASeq/tabulateOtuDataForContig, ref :516-558) from the
// columnar group_batch output. frames = 1 renders PROTEIN-ID headers (aa
// mode), 6 renders processing + TRANSLATION headers in (+,-)x(0,1,2)
// order. seq_batch[i*frames + j] is the batch index of sequence i's j-th
// container (-1 = no hits); call_off[b]..call_off[b+1] delimits batch
// container b's calls; upd_base gives each call's RLE OTU updates.
// Returns bytes written, or -1 if out_cap would overflow.
static int64_t emit_range(
    const uint8_t* ids_blob, const int64_t* ids_off, const int64_t* seq_len,
    int64_t i_begin, int64_t i_end, int32_t frames,
    const int64_t* seq_batch,
    const int64_t* call_off, const int64_t* call_start,
    const int64_t* call_end, const int32_t* call_count,
    const int32_t* call_fi, const float* call_weight,
    const int64_t* upd_base, const int32_t* upd_oi, const int32_t* upd_inc,
    const uint8_t* fn_blob, const int64_t* fn_off,
    uint8_t* out, int64_t out_cap) {
  char* p = (char*)out;
  char* const end = (char*)out + out_cap;
  for (int64_t i = i_begin; i < i_end; ++i) {
    const char* id = (const char*)ids_blob + ids_off[i];
    const int64_t idn = ids_off[i + 1] - ids_off[i];
    const int64_t len = seq_len[i];
    OtuCounter otus;
    if (end - p < (int64_t)(frames + 1) * (idn + 64)) return -1;
    if (frames == 1) {
      p = put_bytes(p, "PROTEIN-ID\t", 11);
      p = put_bytes(p, id, idn);
      *p++ = '\t';
      p = put_i64(p, len);
      *p++ = '\n';
    } else {
      p = put_bytes(p, "processing ", 11);
      p = put_bytes(p, id, idn);
      *p++ = '[';
      p = put_i64(p, len);
      *p++ = ']';
      *p++ = '\n';
    }
    for (int32_t j = 0; j < frames; ++j) {
      if (frames != 1) {
        p = put_bytes(p, "TRANSLATION\t", 12);
        p = put_bytes(p, id, idn);
        *p++ = '\t';
        p = put_i64(p, len);
        *p++ = '\t';
        *p++ = (j < 3) ? '+' : '-';
        *p++ = '\t';
        *p++ = (char)('0' + j % 3);
        *p++ = '\n';
      }
      const int64_t b = seq_batch[i * frames + j];
      if (b < 0) continue;
      for (int64_t ci = call_off[b]; ci < call_off[b + 1]; ++ci) {
        const int32_t f = call_fi[ci];
        const int64_t fn_n = fn_off[f + 1] - fn_off[f];
        if (end - p < fn_n + 192) return -1;
        p = put_bytes(p, "CALL\t", 5);
        p = put_i64(p, call_start[ci]);
        *p++ = '\t';
        p = put_i64(p, call_end[ci]);
        *p++ = '\t';
        p = put_i64(p, call_count[ci]);
        *p++ = '\t';
        p = put_i64(p, f);
        *p++ = '\t';
        p = put_bytes(p, fn_blob + fn_off[f], fn_n);
        *p++ = '\t';
        p = put_jweight(p, call_weight[ci]);
        *p++ = '\n';
        for (int64_t u = upd_base[ci]; u < upd_base[ci + 1]; ++u)
          otus.add(upd_oi[u], upd_inc[u]);
      }
    }
    if (end - p < idn + 64 + 5 * 48) return -1;
    p = put_bytes(p, "OTU-COUNTS\t", 11);
    p = put_bytes(p, id, idn);
    *p++ = '[';
    p = put_i64(p, len);
    *p++ = ']';
    for (int k = 0; k < otus.n; ++k) {
      *p++ = '\t';
      p = put_i64(p, otus.cnt[k]);
      *p++ = '-';
      p = put_i64(p, otus.oi[k]);
    }
    *p++ = '\n';
  }
  return p - (char*)out;
}

extern "C" int64_t emit_report(
    const uint8_t* ids_blob, const int64_t* ids_off, const int64_t* seq_len,
    int64_t n_seq, int32_t frames, const int64_t* seq_batch,
    const int64_t* call_off, const int64_t* call_start,
    const int64_t* call_end, const int32_t* call_count,
    const int32_t* call_fi, const float* call_weight,
    const int64_t* upd_base, const int32_t* upd_oi, const int32_t* upd_inc,
    const uint8_t* fn_blob, const int64_t* fn_off,
    uint8_t* out, int64_t out_cap) {
  const int T0 = num_threads();
  const int T = n_seq < 4096 ? 1
      : (int)((int64_t)T0 < n_seq ? T0 : n_seq);
  if (T <= 1) {
    return emit_range(ids_blob, ids_off, seq_len, 0, n_seq, frames,
                      seq_batch, call_off, call_start, call_end, call_count,
                      call_fi, call_weight, upd_base, upd_oi, upd_inc,
                      fn_blob, fn_off, out, out_cap);
  }
  // Sequences render independently (the OTU counter is per-sequence), so
  // the report emits range-parallel into per-thread buffers sized by the
  // caller's own capacity formula restricted to the range, then stitches
  // in order — bytes identical to the sequential pass.
  const int64_t step = (n_seq + T - 1) / T;
  std::vector<std::vector<char>> bufs(T);
  std::vector<int64_t> lens(T, 0);
  parallel_for_threads(T, [&](int t) {
    const int64_t a = t * step;
    const int64_t b = a + step < n_seq ? a + step : n_seq;
    if (a >= b) return;
    // capacity: ids bytes * (frames+2) + per-seq headers/otu lines +
    // per-call lines (function text + 192), mirroring the caller formula
    const int64_t id_bytes = ids_off[b] - ids_off[a];
    int64_t calls_bytes = 0;
    for (int64_t i = a; i < b; ++i)
      for (int32_t j = 0; j < frames; ++j) {
        const int64_t bb = seq_batch[i * frames + j];
        if (bb < 0) continue;
        for (int64_t ci = call_off[bb]; ci < call_off[bb + 1]; ++ci) {
          const int32_t f = call_fi[ci];
          calls_bytes += (fn_off[f + 1] - fn_off[f]) + 192;
        }
      }
    const int64_t cap = id_bytes * ((int64_t)frames + 2)
        + (b - a) * (((int64_t)frames + 2) * 64 + 5 * 48)
        + calls_bytes + 64;
    bufs[t].resize(cap);
    lens[t] = emit_range(ids_blob, ids_off, seq_len, a, b, frames,
                         seq_batch, call_off, call_start, call_end,
                         call_count, call_fi, call_weight, upd_base,
                         upd_oi, upd_inc, fn_blob, fn_off,
                         (uint8_t*)bufs[t].data(), cap);
  });
  int64_t n = 0;
  for (int t = 0; t < T; ++t) {
    if (lens[t] < 0) return -1;
    if (!lens[t]) continue;  // empty range: buffer was never resized
    if (n + lens[t] > out_cap) return -1;
    std::memcpy(out + n, bufs[t].data(), (size_t)lens[t]);
    n += lens[t];
  }
  return n;
}
