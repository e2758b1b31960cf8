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
// A chunk takes two calls. feeder_count counts each record's valid windows;
// the caller sizes three int64 columns (value, container, position) at the
// total and feeder_write fills them, each record at its exact offset, so
// every query is written once, in its final type, into memory the caller
// owns. Both passes share one window loop (a template), so the write pass
// writes exactly what the count pass counted.
//
// Exactness is pinned by differential tests against the numpy feeder, which
// is itself fuzzed against a scalar transcription of the Java code.
//
// Build: g++ -O3 -shared -fPIC -o feeder.so feeder.cpp

#include <cstdint>
#include <memory>
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

// The write pass's destination: the record's first row in each column
// (unused by the count pass).
struct Out {
  int64_t* values;
  int64_t* cnt;
  int64_t* pos;
};

// Count (WRITE false) or write the valid windows over `offs[0..n)` with
// start < num_starts; returns how many.
template <bool WRITE>
inline int64_t window_pass(const uint8_t* offs, int64_t n, int64_t num_starts,
                           int64_t cnt_id, const Out& out) {
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
      if (WRITE) {
        out.values[written] = value;
        out.cnt[written] = cnt_id;
        out.pos[written] = i;
      }
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

inline Out advanced(const Out& o, int64_t by) {
  return Out{o.values + by, o.cnt + by, o.pos + by};
}

// One record of the aa feeder, at `out`; returns its windows.
template <bool WRITE>
int64_t feed_aa(const uint8_t* s, int64_t n, int64_t cid, uint8_t* scratch,
                const Out& out) {
  for (int64_t i = 0; i < n; i++) scratch[i] = LUT.aa_off[s[i]];
  // reference quirk: strictly i < len - K
  return window_pass<WRITE>(scratch, n, n - K, cid, out);
}

// One record of the dna feeder, its six frame rows +0,+1,+2,-0,-1,-2
// (containers cid .. cid+5) one after another from `out`; returns its
// windows. scratch holds 2*n bytes.
template <bool WRITE>
int64_t feed_dna(const uint8_t* s, int64_t n, int64_t cid, uint8_t* scratch,
                 const Out& out) {
  int64_t written = 0;
  int64_t m = n / 3;
  int64_t num_starts = m - K + 1;
  if (num_starts <= 0) return 0;
  uint8_t* codes = scratch;        // forward (or rc) base codes
  uint8_t* frame = scratch + n;    // frame aa offsets (m entries)
  for (int strand = 0; strand < 2; strand++) {
    if (strand == 0) {
      for (int64_t i = 0; i < n; i++) codes[i] = LUT.dna_code[s[i]];
    } else {
      for (int64_t i = 0; i < n; i++) codes[i] = LUT.compl_code[s[n - 1 - i]];
    }
    for (int f = 0; f < 3; f++) {
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
      written += window_pass<WRITE>(frame, m, num_starts,
                                    cid + strand * 3 + f,
                                    WRITE ? advanced(out, written) : out);
    }
  }
  return written;
}

// A chunk's records: the sequence bytes, each record's start and length in
// them, and the container of record 0 (record r's first is first_cid +
// frames * r).
struct Chunk {
  bool aa;
  const uint8_t* seqs;
  const int64_t* rec_start;
  const int64_t* rec_len;
  int64_t nrec;
  int64_t first_cid;
};

// Records [r0, r1) of the chunk. The count pass stores each record's
// windows in rec_count; the write pass writes them from `out` on and
// returns how many it wrote.
template <bool WRITE>
int64_t feed_range(const Chunk& c, int64_t r0, int64_t r1,
                   int64_t* rec_count, const Out& out) {
  int64_t max_len = 1;
  for (int64_t r = r0; r < r1; r++)
    if (c.rec_len[r] > max_len) max_len = c.rec_len[r];
  // uninitialised: every byte is written before it is read
  std::unique_ptr<uint8_t[]> scratch(
      new uint8_t[(c.aa ? 1 : 2) * max_len + 2]);
  const int64_t frames = c.aa ? 1 : 6;
  int64_t written = 0;
  for (int64_t r = r0; r < r1; r++) {
    const uint8_t* s = c.seqs + c.rec_start[r];
    const int64_t cid = c.first_cid + frames * r;
    const Out at = WRITE ? advanced(out, written) : out;
    const int64_t got =
        c.aa ? feed_aa<WRITE>(s, c.rec_len[r], cid, scratch.get(), at)
             : feed_dna<WRITE>(s, c.rec_len[r], cid, scratch.get(), at);
    if (!WRITE) rec_count[r] = got;
    written += got;
  }
  return written;
}

// Record ranges are independent, so both passes thread by contiguous
// record range, balanced by chars, the same split in each. The write pass
// starts each range at the sum of the counts before it: records land in
// exactly the sequential order and bytes at any thread count. Small
// chunks and a lone record (a multi-Mbp contig is the sequential worst
// case; real corpora are many records) stay on one thread.
std::vector<int64_t> split(const Chunk& c) {
  int64_t total = 0;
  for (int64_t r = 0; r < c.nrec; r++) total += c.rec_len[r];
  const int T0 = num_threads();
  const int T = (total < (int64_t)1 << 20 || c.nrec < 2) ? 1
      : (int)((int64_t)T0 < c.nrec ? T0 : c.nrec);
  std::vector<int64_t> bounds{0};
  const int64_t want = (total + T - 1) / T;
  int64_t r = 0;
  for (int t = 0; t < T; t++) {
    int64_t chars = 0;
    while (r < c.nrec && (t == T - 1 || chars < want)) chars += c.rec_len[r++];
    bounds.push_back(r);
  }
  return bounds;
}

}  // namespace

extern "C" {

// Count pass: rec_count[r] = the windows record r yields (aa != 0: protein
// mode, one container a record; else DNA mode, six). Returns their sum.
int64_t feeder_count(int32_t aa, const uint8_t* seqs,
                     const int64_t* rec_start, const int64_t* rec_len,
                     int64_t nrec, int64_t* rec_count) {
  const Chunk c{aa != 0, seqs, rec_start, rec_len, nrec, 0};
  const std::vector<int64_t> b = split(c);
  const int T = (int)b.size() - 1;
  parallel_for_threads(T, [&](int t) {
    feed_range<false>(c, b[t], b[t + 1], rec_count, Out{});
  });
  int64_t total = 0;
  for (int64_t r = 0; r < nrec; r++) total += rec_count[r];
  return total;
}

// Write pass: each record's windows as (value, container, position), in
// record order, containers first_cid + frames * r + frame (DNA frames
// +0,+1,+2,-0,-1,-2), into columns of sum(rec_count) rows. Returns the
// rows written, or -1 where a range wrote other than its counts (the
// columns are then not to be read).
int64_t feeder_write(int32_t aa, const uint8_t* seqs,
                     const int64_t* rec_start, const int64_t* rec_len,
                     int64_t nrec, const int64_t* rec_count,
                     int64_t first_cid, int64_t* out_values,
                     int64_t* out_cnt, int64_t* out_pos) {
  const Chunk c{aa != 0, seqs, rec_start, rec_len, nrec, first_cid};
  const std::vector<int64_t> b = split(c);
  const int T = (int)b.size() - 1;
  std::vector<int64_t> at(T + 1, 0);
  for (int t = 0; t < T; t++) {
    at[t + 1] = at[t];
    for (int64_t r = b[t]; r < b[t + 1]; r++) at[t + 1] += rec_count[r];
  }
  std::vector<char> ok(T, 0);
  const Out out{out_values, out_cnt, out_pos};
  parallel_for_threads(T, [&](int t) {
    ok[t] = feed_range<true>(c, b[t], b[t + 1], nullptr,
                             advanced(out, at[t])) == at[t + 1] - at[t];
  });
  for (int t = 0; t < T; t++)
    if (!ok[t]) return -1;
  return at[T];
}

}  // extern "C"
