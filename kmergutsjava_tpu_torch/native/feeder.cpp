// Native feeder: the per-byte hot loop of the prepare phase.
//
// The Python FASTA parser owns the reference's parsing quirks; this library
// takes parsed sequence bytes and emits query k-mer records:
//   - aa mode: amino-acid offsets, rolling base-20 8-mer pack, window bound
//     strictly i < len-K (the reference's skip-last-window quirk,
//     KmerGutsJava.java:912);
//   - dna mode: 6-frame translation (codon walk identical to ref :320-343)
//     and full-window k-mers per frame row (bound i < len/3+1-K over the
//     reference's buffer == all full windows of the len/3-long row).
//
// Exactness is pinned by differential tests against the numpy feeder, which
// is itself fuzzed against a scalar transcription of the Java code.
//
// Build: g++ -O3 -shared -fPIC -o feeder.so feeder.cpp

#include <cstdint>
#include <cstring>
#include <vector>

#include "threading.h"

namespace {

constexpr int K = 8;

using kmer_native::num_threads;
using kmer_native::parallel_for_threads;
constexpr int64_t POW7 = 1280000000LL;  // 20^7

const char GENETIC_CODE[65] =
    "KNKNTTTTRSRSIIMI"
    "QHQHPPPPRRRRLLLL"
    "EDEDAAAAGGGGVVVV"
    "*Y*YSSSS*CWCLFLF";

struct Luts {
  uint8_t aa_off[256];
  uint8_t dna_code[256];
  uint8_t compl_code[256];  // dna code of the complement
  uint8_t codon_aa[64];
  Luts() {
    for (int i = 0; i < 256; i++) aa_off[i] = 20;
    const char* alpha = "ACDEFGHIKLMNPQRSTVWY";
    for (int i = 0; i < 20; i++) aa_off[(uint8_t)alpha[i]] = (uint8_t)i;
    for (int i = 0; i < 256; i++) dna_code[i] = 4;
    dna_code['a'] = dna_code['A'] = 0;
    dna_code['c'] = dna_code['C'] = 1;
    dna_code['g'] = dna_code['G'] = 2;
    dna_code['t'] = dna_code['T'] = 3;
    dna_code['u'] = dna_code['U'] = 3;
    // complement char table (ref compl :177-260), composed with dna_code
    uint8_t comp[256];
    for (int i = 0; i < 256; i++) comp[i] = (uint8_t)i;
    const char* pairs[] = {"at", "AT", "cg", "CG", "gc", "GC", "ta", "ua",
                           "TA", "UA", "mk", "MK", "ry", "RY", "ww", "WW",
                           "sS", "SS", "yr", "YR", "km", "KM", "bv", "BV",
                           "dh", "DH", "hd", "HD", "vb", "VB", "nn", "NN"};
    for (auto p : pairs) comp[(uint8_t)p[0]] = (uint8_t)p[1];
    for (int i = 0; i < 256; i++) compl_code[i] = dna_code[comp[i]];
    for (int i = 0; i < 64; i++) codon_aa[i] = aa_off[(uint8_t)GENETIC_CODE[i]];
  }
};
const Luts LUT;

// Emit all valid windows over `offs[0..n)` with start < num_starts.
// Returns records written (or stops silently at capacity; caller sizes
// out_cap as n which is an upper bound).
inline int64_t window_pass(const uint8_t* offs, int64_t n, int64_t num_starts,
                           int64_t cnt_id, int64_t* out_values,
                           int32_t* out_cnt, int32_t* out_pos,
                           int64_t out_off) {
  if (n < K || num_starts <= 0) return 0;
  int64_t written = 0;
  int64_t value = 0;
  int invalid = 0;
  for (int i = 0; i < K; i++) {
    uint8_t a = offs[i];
    value = value * 20 + (a < 20 ? a : 0);
    invalid += (a >= 20);
  }
  int64_t limit = num_starts < n - K + 1 ? num_starts : n - K + 1;
  for (int64_t i = 0;;) {
    if (invalid == 0) {
      out_values[out_off + written] = value;
      out_cnt[out_off + written] = (int32_t)cnt_id;
      out_pos[out_off + written] = (int32_t)i;
      written++;
    }
    if (++i >= limit) break;
    uint8_t drop = offs[i - 1];
    uint8_t add = offs[i + K - 1];
    value -= (drop < 20 ? drop : 0) * POW7;
    value = value * 20 + (add < 20 ? add : 0);
    invalid += (add >= 20) - (drop >= 20);
  }
  return written;
}

// One record range of the aa feeder; returns records written.
int64_t feeder_aa_range(const uint8_t* seqs, const int64_t* rec_start,
                        const int64_t* rec_len, int64_t r0, int64_t r1,
                        const int64_t* cnt_ids, uint8_t* scratch,
                        int64_t* out_values, int32_t* out_cnt,
                        int32_t* out_pos) {
  int64_t written = 0;
  for (int64_t r = r0; r < r1; r++) {
    const uint8_t* s = seqs + rec_start[r];
    int64_t n = rec_len[r];
    for (int64_t i = 0; i < n; i++) scratch[i] = LUT.aa_off[s[i]];
    // reference quirk: strictly i < len - K
    written += window_pass(scratch, n, n - K, cnt_ids[r], out_values,
                           out_cnt, out_pos, written);
  }
  return written;
}

int64_t feeder_dna_range(const uint8_t* seqs, const int64_t* rec_start,
                         const int64_t* rec_len, int64_t r0, int64_t r1,
                         const int64_t* cnt_ids, uint8_t* scratch,
                         int64_t* out_values, int32_t* out_cnt,
                         int32_t* out_pos) {
  int64_t written = 0;
  for (int64_t r = r0; r < r1; r++) {
    const uint8_t* s = seqs + rec_start[r];
    int64_t n = rec_len[r];
    int64_t m = n / 3;
    int64_t num_starts = m - K + 1;
    uint8_t* codes = scratch;        // forward (or rc) base codes
    uint8_t* frame = scratch + n;    // frame aa offsets (m entries)
    for (int strand = 0; strand < 2; strand++) {
      if (strand == 0) {
        for (int64_t i = 0; i < n; i++) codes[i] = LUT.dna_code[s[i]];
      } else {
        for (int64_t i = 0; i < n; i++)
          codes[i] = LUT.compl_code[s[n - 1 - i]];
      }
      for (int f = 0; f < 3; f++) {
        int64_t cid = cnt_ids[r * 6 + strand * 3 + f];
        if (num_starts <= 0) continue;
        int64_t p = (n - f) >= 0 ? (n - f) / 3 : 0;
        for (int64_t j = 0; j < m; j++) {
          if (j < p) {
            uint8_t c1 = codes[f + 3 * j];
            uint8_t c2 = codes[f + 3 * j + 1];
            uint8_t c3 = codes[f + 3 * j + 2];
            frame[j] = (c1 < 4 && c2 < 4 && c3 < 4)
                           ? LUT.codon_aa[c1 * 16 + c2 * 4 + c3]
                           : 20;
          } else {
            frame[j] = 21;
          }
        }
        written += window_pass(frame, m, num_starts, cid, out_values,
                               out_cnt, out_pos, written);
      }
    }
  }
  return written;
}

// Record ranges are independent and records emit in order, so both
// feeders thread by contiguous record range (balanced by chars) into
// thread-local buffers sized by the per-record output bound (aa: len;
// dna: 2*len + 6), stitched in range order — records written in exactly
// the sequential order and bytes. Single record / small batches stay
// sequential (a lone multi-Mbp contig is the sequential worst case; real
// corpora are many records).
typedef int64_t (*range_fn)(const uint8_t*, const int64_t*, const int64_t*,
                            int64_t, int64_t, const int64_t*, uint8_t*,
                            int64_t*, int32_t*, int32_t*);

int64_t feeder_mt(bool aa, range_fn fn, const uint8_t* seqs,
                  const int64_t* rec_start, const int64_t* rec_len,
                  int64_t nrec, const int64_t* cnt_ids, uint8_t* scratch,
                  int64_t* out_values, int32_t* out_cnt, int32_t* out_pos) {
  int64_t total = 0;
  for (int64_t r = 0; r < nrec; r++) total += rec_len[r];
  const int T0 = num_threads();
  const int T = (total < (int64_t)1 << 20 || nrec < 2) ? 1
      : (int)((int64_t)T0 < nrec ? T0 : nrec);
  if (T <= 1)
    return fn(seqs, rec_start, rec_len, 0, nrec, cnt_ids, scratch,
              out_values, out_cnt, out_pos);
  struct Range {
    int64_t r0, r1, cap, max_len, written;
    std::vector<int64_t> v;
    std::vector<int32_t> c, p;
    std::vector<uint8_t> scr;
  };
  std::vector<Range> ranges(T);
  const int64_t want = (total + T - 1) / T;
  int64_t r0 = 0;
  for (int t = 0; t < T; t++) {
    Range& rg = ranges[t];
    rg.r0 = r0;
    int64_t chars = 0, cap = 0, mx = 1;
    while (r0 < nrec && (t == T - 1 || chars < want)) {
      const int64_t n = rec_len[r0];
      chars += n;
      cap += aa ? n : 2 * n + 6;
      if (n > mx) mx = n;
      ++r0;
    }
    rg.r1 = r0;
    rg.cap = cap > 0 ? cap : 1;
    rg.max_len = mx;
  }
  parallel_for_threads(T, [&](int t) {
    Range& rg = ranges[t];
    if (rg.r0 >= rg.r1) { rg.written = 0; return; }
    rg.v.resize(rg.cap);
    rg.c.resize(rg.cap);
    rg.p.resize(rg.cap);
    rg.scr.resize((aa ? 1 : 2) * rg.max_len + 2);
    rg.written = fn(seqs, rec_start, rec_len, rg.r0, rg.r1, cnt_ids,
                    rg.scr.data(), rg.v.data(), rg.c.data(), rg.p.data());
  });
  int64_t written = 0;
  for (int t = 0; t < T; t++) {
    const Range& rg = ranges[t];
    if (!rg.written) continue;  // empty range: buffers were never resized
    std::memcpy(out_values + written, rg.v.data(),
                sizeof(int64_t) * rg.written);
    std::memcpy(out_cnt + written, rg.c.data(),
                sizeof(int32_t) * rg.written);
    std::memcpy(out_pos + written, rg.p.data(),
                sizeof(int32_t) * rg.written);
    written += rg.written;
  }
  return written;
}

}  // namespace

extern "C" {

// Protein mode. Returns total records written.
int64_t feeder_aa(const uint8_t* seqs, const int64_t* rec_start,
                  const int64_t* rec_len, int64_t nrec,
                  const int64_t* cnt_ids, uint8_t* scratch,
                  int64_t* out_values, int32_t* out_cnt, int32_t* out_pos) {
  return feeder_mt(true, feeder_aa_range, seqs, rec_start, rec_len, nrec,
                   cnt_ids, scratch, out_values, out_cnt, out_pos);
}

// DNA mode: 6 containers per record in order +0,+1,+2,-0,-1,-2.
// cnt_ids has nrec*6 entries; scratch must hold 2*max_len bytes.
int64_t feeder_dna(const uint8_t* seqs, const int64_t* rec_start,
                   const int64_t* rec_len, int64_t nrec,
                   const int64_t* cnt_ids, uint8_t* scratch,
                   int64_t* out_values, int32_t* out_cnt, int32_t* out_pos) {
  return feeder_mt(false, feeder_dna_range, seqs, rec_start, rec_len, nrec,
                   cnt_ids, scratch, out_values, out_cnt, out_pos);
}

}  // extern "C"
