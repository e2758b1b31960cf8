// Native dense-tile scatter for the stream lookup front end.
//
// The Pallas stream kernel (kmergutsjava_tpu/lookup/pallas_stream.py)
// probes billions of slot-channels per second, but its host front end —
// bucketing query k-mers by home slot into the dense [nsuper, C, ROWS,
// BLOCK] fingerprint tile — ran at ~3.6M queries/s in numpy (np.unique +
// argsort per chunk). This scatter replaces that path: one pass over the
// chunk, O(1) per query, threaded by home-slot range (below).
//
// Deduplication is by (home slot, fingerprint), and the dedup structure
// is THE TILE ITSELF: before taking a new channel, the query's ≤C
// already-occupied channels are scanned for its fingerprint, and a match
// shares that cell. This makes dedup global across streaming chunks with
// no auxiliary hash table (the tiles plus the occupancy plane are the
// entire working set), which is what keeps metagenome-coverage inputs —
// the same genomic k-mer arriving over and over in different reads —
// from exhausting a home slot's C channels.
//
// Sharing a cell on a fingerprint collision (two DISTINCT values with
// equal home and equal fp) is sound: the kernel only ever matches
// fingerprints, and the host decode verifies every candidate against the
// full k-mer value, routing failures to the exact full-window fallback
// (lookup/pallas_stream.py _decode). Both colliding queries therefore
// still get exact answers.
//
// THREADING (exactness preserved): the tile/occupancy mutation is
// per-home-slot state, so the chunk parallelizes by slot range — a
// stable radix partition groups query indices by home range (original
// order preserved within each range), then each range is processed by
// one thread with exclusive ownership of its slots. Every home slot sees
// its queries in the same encounter order as the sequential loop, so the
// tiles, channel assignments, occupancy, and per-query outputs are
// BIT-IDENTICAL to the single-thread path (pinned by
// tests/test_native_scatter.py). Thread count: KMER_NATIVE_THREADS, else
// hardware concurrency; small chunks stay sequential.
//
// Outputs per query: home slot, flat element index into the flattened
// kernel output [nsuper, C/4, ROWS, BLOCK], and the bit shift of its
// packed result byte (the kernel packs 4 channels' offsets per int32);
// shift = -1 marks channel overflow (the caller routes those to the
// exact fallback).
//
// Reference analog: the home-slot routing side of the merge-join scan,
// /root/reference/lib/src/kmergutsjava/KmerGutsJava.java:964-994
// (neededHashCode = value % numSigs and the inProgress keying).

#include <atomic>
#include <cstdint>
#include <vector>

#include "threading.h"

namespace {

using kmer_native::num_threads;
using kmer_native::parallel_for_threads;

struct ScatterDims {
    int64_t num_sigs, channels, block, rows, fp_mod, planes, row_sz;
};

// The per-query placement body shared by the sequential and threaded
// paths; homes[i] must already hold v % num_sigs. Returns 1 if placed.
inline int64_t place_one(int64_t i, const int64_t* values,
                         const int64_t* homes, const ScatterDims& d,
                         uint16_t* qfp_tiles, uint8_t* occ,
                         int64_t* flat, int32_t* shift) {
    const int64_t v = values[i];
    const int64_t h = homes[i];
    const uint16_t fp = (uint16_t)(v % d.fp_mod);
    const int64_t blk = h / d.block;
    const int64_t sup = blk / d.rows;
    const int64_t row = blk % d.rows;
    const int64_t within = h % d.block;
    // tile cell of (home, channel c) = base + c * row_sz
    uint16_t* cell0 = qfp_tiles
        + (sup * d.channels * d.row_sz + row * d.block + within);
    const uint8_t c = occ[h];
    const int64_t live = c < d.channels ? c : d.channels;
    int64_t ch = -1;
    for (int64_t ci = 0; ci < live; ci++) {
        if (cell0[ci * d.row_sz] == fp) { ch = ci; break; }
    }
    if (ch < 0) {
        if (c < 255) occ[h] = (uint8_t)(c + 1);
        if ((int64_t)c >= d.channels) {  // channel overflow
            flat[i] = 0;
            shift[i] = -1;
            return 0;
        }
        ch = c;
        cell0[ch * d.row_sz] = fp;
    }
    flat[i] = ((sup * d.planes + (ch >> 2)) * d.rows + row) * d.block
        + within;
    shift[i] = (int32_t)(8 * (ch & 3));
    return 1;
}

}  // namespace

// Native decode of the stream kernel's packed output: candidate-offset
// extraction, stop-at-empty gating, full-value verification, the exact
// full-window fallback and hit compaction in two lean passes per query
// (resolve_slots + emit_hits — split so the caller can allocate hit
// columns at their EXACT final size between the passes, eliminating the
// capacity-n buffers and their shrinking copies, which measured as the
// single largest host cost on the proteome corpus). The numpy twin
// (lookup/pallas_stream.py _decode_numpy) needs ~20 full-size array
// passes for the same job; on hosts where memory is the bottleneck (and
// at metagenome scales it always is) these passes are ~10x faster.
//
// Per query: if shift < 0 the query overflowed its home's channels at
// scatter time -> probe the window directly. Otherwise read its packed
// byte; a fingerprint-candidate offset strictly before the home's first
// empty slot (fe plane) is verified against the full k-mer value; a
// failed verification or a windowful of non-empty slots falls back to
// the direct window probe (exact: first-free-slot insertion keeps every
// slot between home and placement occupied, see lookup/xla.py).
//
// Exactness contract as the reference's merge-join scan
// (/root/reference/lib/src/kmergutsjava/KmerGutsJava.java:995-1016):
// a hit's slot holds the exact k-mer value; misses stop at an empty slot.
//
// THREADING: queries are independent (all shared state is read-only), so
// the resolve pass runs slice-parallel into the per-query slot buffer;
// the compaction offsets come from per-slice hit counts, and each slice
// then writes its own contiguous region — the hit order (query order)
// and every output byte match a sequential decode exactly.
//
// Outputs are the compacted hit columns (cnt, pos, otu, avg, fi, wt) plus
// the hit values (for the kmers-found debug counter).

namespace {

// Resolve query i to its table slot, or -1 for a miss.
inline int64_t resolve_one(int64_t i, const int64_t* v, const int64_t* homes,
                           const int64_t* flat, const int32_t* shift,
                           const int32_t* out, const uint8_t* fe,
                           const int64_t* hk, int64_t hk_len, int64_t w,
                           int64_t full_w) {
    const int64_t h = homes[i];
    const int64_t vi = v[i];
    int64_t slot = -1;
    bool fallback;
    if (shift[i] < 0) {
        fallback = true;  // channel overflow at scatter time
    } else {
        const int64_t off = (out[flat[i]] >> shift[i]) & 0xFF;
        const uint8_t f = fe[h];
        if (off < (int64_t)f) {      // candidate before first empty
            if (h + off < hk_len && hk[h + off] == vi) {
                return h + off;
            }
            fallback = true;         // fingerprint collision
        } else {
            fallback = (int64_t)f >= w;  // no empty in window: unresolved
        }
    }
    if (fallback) {
        const int64_t lim = full_w < hk_len - h ? full_w : hk_len - h;
        for (int64_t l = 0; l < lim; l++) {
            if (hk[h + l] == vi) { slot = h + l; break; }
        }
    }
    return slot;
}

}  // namespace

// Pass 1: resolve every query to its table slot (-1 = miss), returning
// the hit count — so the caller can allocate EXACTLY-sized hit columns
// (no capacity-n buffers, no shrinking copies). Slice-parallel.
extern "C" int64_t resolve_slots(
    const int64_t* v, const int64_t* homes, const int64_t* flat,
    const int32_t* shift, int64_t n,
    const int32_t* out,       // flattened kernel output
    const uint8_t* fe,        // per-slot distance to first empty (cap w)
    const int64_t* hk,        // padded host k-mer plane
    int64_t hk_len, int64_t w, int64_t full_w,
    int64_t* slots)           // out [n]
{
    const int T0 = num_threads();
    const int T = n < (int64_t)1 << 16 ? 1
        : (int)(n / 32768 < T0 ? n / 32768 : T0);
    const int64_t step = T <= 1 ? n : (n + T - 1) / T;
    std::vector<int64_t> k_slice(T > 1 ? T : 1, 0);
    auto slice = [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        int64_t k = 0;
        for (int64_t i = a; i < b; i++) {
            const int64_t slot = resolve_one(i, v, homes, flat, shift, out,
                                             fe, hk, hk_len, w, full_w);
            slots[i] = slot;
            k += slot >= 0;
        }
        k_slice[t] = k;
    };
    if (T <= 1) slice(0); else parallel_for_threads(T, slice);
    int64_t k = 0;
    for (auto ks : k_slice) k += ks;
    return k;
}

// Gather-path resolve (round 5, the host-roofline's top stage): the
// XlaLookup dispatch/resolve protocol hands back per-query (off, state)
// — state 1 = fingerprint candidate at `off` (verify against the full
// k-mer), 2 = empty-first definitive miss, 0 = unresolved (exact
// full-window pass; also the bin-overflow route). Same slice-parallel
// shape as resolve_slots; pairs with emit_hits for the compaction.
// Bit-identical to the numpy twin in lookup/xla.py _verify_emit
// (pinned by tests/test_lookup.py).
extern "C" int64_t gather_resolve_slots(
    const int64_t* v, const int32_t* homes, const uint8_t* off,
    const uint8_t* state, int64_t n,
    const int64_t* hk, int64_t hk_len, int64_t full_w,
    int64_t* slots)
{
    const int T0 = num_threads();
    const int T = n < (int64_t)1 << 16 ? 1
        : (int)(n / 32768 < T0 ? n / 32768 : T0);
    const int64_t step = T <= 1 ? n : (n + T - 1) / T;
    std::vector<int64_t> k_slice(T > 1 ? T : 1, 0);
    auto slice = [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        int64_t k = 0;
        for (int64_t i = a; i < b; i++) {
            const int64_t h = homes[i];
            const int64_t vi = v[i];
            int64_t slot = -1;
            bool fallback;
            if (state[i] & 1) {               // candidate: verify
                const int64_t s0 = h + off[i];
                if (s0 < hk_len && hk[s0] == vi) {
                    slot = s0;
                    fallback = false;
                } else {
                    fallback = true;          // fingerprint collision
                }
            } else {
                fallback = !(state[i] & 2);   // 0 = unresolved
            }
            if (fallback) {
                const int64_t lim =
                    full_w < hk_len - h ? full_w : hk_len - h;
                for (int64_t l = 0; l < lim; l++) {
                    if (hk[h + l] == vi) { slot = h + l; break; }
                }
            }
            slots[i] = slot;
            k += slot >= 0;
        }
        k_slice[t] = k;
    };
    if (T <= 1) slice(0); else parallel_for_threads(T, slice);
    int64_t k = 0;
    for (auto ks : k_slice) k += ks;
    return k;
}

// Pass 2: compact the resolved hits into the caller's exactly-sized
// columns starting at their current fill point; returns hits emitted.
// Hit order = query order (identical to the one-pass sequential decode).
extern "C" int64_t emit_hits(
    const int64_t* v, const int64_t* cnt, const int64_t* pos,
    const int64_t* slots, int64_t n,
    const int32_t* t_otu, const int32_t* t_avg, const int32_t* t_fi,
    const float* t_wt,        // contiguous table columns [num_sigs]
    int64_t* o_cnt, int64_t* o_pos, int32_t* o_otu, int32_t* o_avg,
    int32_t* o_fi, float* o_wt, int64_t* o_val)
{
    const int T0 = num_threads();
    const int T = n < (int64_t)1 << 16 ? 1
        : (int)(n / 32768 < T0 ? n / 32768 : T0);
    if (T <= 1) {
        int64_t k = 0;
        for (int64_t i = 0; i < n; i++) {
            const int64_t slot = slots[i];
            if (slot >= 0) {
                o_cnt[k] = cnt[i];
                o_pos[k] = pos[i];
                o_otu[k] = t_otu[slot];
                o_avg[k] = t_avg[slot];
                o_fi[k] = t_fi[slot];
                o_wt[k] = t_wt[slot];
                o_val[k] = v[i];
                k++;
            }
        }
        return k;
    }
    const int64_t step = (n + T - 1) / T;
    std::vector<int64_t> base(T + 1, 0);
    parallel_for_threads(T, [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        int64_t k = 0;
        for (int64_t i = a; i < b; i++) k += slots[i] >= 0;
        base[t + 1] = k;
    });
    for (int t = 0; t < T; t++) base[t + 1] += base[t];
    parallel_for_threads(T, [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        int64_t k = base[t];
        for (int64_t i = a; i < b; i++) {
            const int64_t slot = slots[i];
            if (slot >= 0) {
                o_cnt[k] = cnt[i];
                o_pos[k] = pos[i];
                o_otu[k] = t_otu[slot];
                o_avg[k] = t_avg[slot];
                o_fi[k] = t_fi[slot];
                o_wt[k] = t_wt[slot];
                o_val[k] = v[i];
                k++;
            }
        }
    });
    return base[T];
}

// Table-builder helpers (formats/kmer_table.py build_table). The numpy
// build spent nearly all its time in 6 full-size random gathers by the
// sort permutation (columns + homes) plus a slow maximum.accumulate;
// these two calls replace every one of them:
//
// table_place: walk signatures in (home, kmer) sort order via the
// permutation, computing homes on the fly (one random read per element —
// unavoidable — instead of numpy's materialized home_s gather), the
// first-free-slot recurrence pos[i] = max(home, pos[i-1] + 1), the
// duplicate check (equal kmers are adjacent in this order), and the max
// probe-chain length, in ONE sequential pass. Returns max_probe (>= 1),
// -1 when a chain reaches the final slot (caller grows the table and
// retries; pos contents are then meaningless), or -2 on duplicate kmers.
extern "C" int64_t table_place(const int64_t* kmers, const int64_t* order,
                               int64_t n, int64_t num_sigs, int64_t* pos)
{
    int64_t prev = -1;
    int64_t maxd = 0;
    int64_t prev_k = -1;
    for (int64_t i = 0; i < n; i++) {
        const int64_t k = kmers[order[i]];
        if (k == prev_k) return -2;
        prev_k = k;
        const int64_t h = k % num_sigs;
        const int64_t p = h > prev + 1 ? h : prev + 1;
        pos[i] = p;
        prev = p;
        const int64_t d = p - h;
        if (d > maxd) maxd = d;
    }
    if (n && prev >= num_sigs - 1) return -1;
    return maxd + 1;
}

// table_fill: write the five signature columns into the 24-byte slot
// records (int64 kmer | int32 otu | int32 avg | int32 fi | float wt —
// the on-disk layout, docs/formats.md) in one slice-parallel pass. pos
// values are unique, so slices write disjoint records.
extern "C" void table_fill(const int64_t* order, const int64_t* pos,
                           int64_t n, const int64_t* kmers,
                           const int32_t* otu, const int32_t* avg,
                           const int32_t* fi, const float* wt,
                           uint8_t* slots)
{
    const int T0 = num_threads();
    const int T = n < (int64_t)1 << 16 ? 1
        : (int)(n / 32768 < T0 ? n / 32768 : T0);
    const int64_t step = T <= 1 ? n : (n + T - 1) / T;
    auto slice = [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        for (int64_t i = a; i < b; i++) {
            const int64_t j = order[i];
            uint8_t* r = slots + 24 * pos[i];
            *(int64_t*)r = kmers[j];
            *(int32_t*)(r + 8) = otu[j];
            *(int32_t*)(r + 12) = avg[j];
            *(int32_t*)(r + 16) = fi[j];
            *(float*)(r + 20) = wt[j];
        }
    };
    if (T <= 1) slice(0); else parallel_for_threads(T, slice);
}

extern "C" int64_t scatter_chunk(
    const int64_t* values, int64_t n,
    int64_t num_sigs, int64_t channels, int64_t block, int64_t rows,
    int64_t fp_mod,
    uint16_t* qfp_tiles,   // [nsuper*channels*rows*block], mutated
    uint8_t* occ,          // [num_sigs] per-slot channel occupancy, mutated
    int64_t* homes,        // out [n]
    int64_t* flat,         // out [n] flat kernel-output element index
    int32_t* shift)        // out [n] packed-byte bit shift; -1 = overflow
{
    const ScatterDims d{num_sigs, channels, block, rows, fp_mod,
                        channels >> 2, rows * block};
    const int T0 = num_threads();
    const int T = n < (int64_t)1 << 16 ? 1
        : (int)(n / 32768 < T0 ? n / 32768 : T0);
    if (T <= 1) {
        int64_t placed = 0;
        for (int64_t i = 0; i < n; i++) {
            homes[i] = values[i] % num_sigs;
            placed += place_one(i, values, homes, d, qfp_tiles, occ, flat,
                                shift);
        }
        return placed;
    }
    // Stable radix partition of query indices by home-slot range, then
    // one thread per range: exclusive slot ownership, sequential
    // per-slot encounter order, bit-identical outputs (header comment).
    const int R = T * 4 < 256 ? T * 4 : 256;
    const int64_t range_sz = (num_sigs + R - 1) / R;
    const int64_t step = (n + T - 1) / T;
    std::vector<int64_t> counts((size_t)T * R, 0);
    parallel_for_threads(T, [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        int64_t* cnt_t = counts.data() + (size_t)t * R;
        for (int64_t i = a; i < b; i++) {
            const int64_t h = values[i] % num_sigs;
            homes[i] = h;
            cnt_t[h / range_sz]++;
        }
    });
    // exclusive offsets, range-major then slice-order (stable)
    std::vector<int64_t> off((size_t)T * R);
    std::vector<int64_t> range_end(R);
    int64_t total = 0;
    for (int r = 0; r < R; r++) {
        for (int t = 0; t < T; t++) {
            off[(size_t)t * R + r] = total;
            total += counts[(size_t)t * R + r];
        }
        range_end[r] = total;
    }
    std::vector<int64_t> part(n);
    parallel_for_threads(T, [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        int64_t* off_t = off.data() + (size_t)t * R;
        for (int64_t i = a; i < b; i++) {
            part[off_t[homes[i] / range_sz]++] = i;
        }
    });
    std::vector<int64_t> placed_t(T, 0);
    std::atomic<int> next_range(0);
    parallel_for_threads(T, [&](int t) {
        int64_t placed = 0;
        for (;;) {
            const int r = next_range.fetch_add(1);
            if (r >= R) break;
            const int64_t a = r == 0 ? 0 : range_end[r - 1];
            const int64_t b = range_end[r];
            for (int64_t j = a; j < b; j++) {
                placed += place_one(part[j], values, homes, d, qfp_tiles,
                                    occ, flat, shift);
            }
        }
        placed_t[t] = placed;
    });
    int64_t placed = 0;
    for (int t = 0; t < T; t++) placed += placed_t[t];
    return placed;
}

// ---------------------------------------------------------------------
// Chunked-probe bin router (lookup/xla.py probe_impl="chunked").
//
// Routes query fingerprints into per-chunk capacity bins for the
// chunk-local device gather (the 2x sparse-probe win on HBM-bound
// planes, docs/performance.md round 2). rank_of[i] = how many earlier
// queries (input order) share query i's chunk — i.e. the bin cell in
// sequential encounter order — so the output is BIT-IDENTICAL to the
// single-thread pass and to the numpy stable-argsort twin at any thread
// count (pinned by tests/test_lookup.py).
//
// Two passes: per-thread per-chunk histograms, an exclusive scan giving
// each thread its starting cursor per chunk, then a scatter pass writing
// bin cells (rank < cap) and the per-query (chunk, rank) used by
// resolve_probe. Cells never written stay zero (callers pass
// zero-initialized bins); overflowed queries (rank >= cap — adversarial
// home skew only) are resolved by the exact host pass.
extern "C" void bin_queries(
    const int32_t* homes, const uint16_t* qfp, int64_t n,
    int64_t stride, int64_t chunk_rows, int64_t n_chunks, int64_t cap,
    uint16_t* qfp_b,    // [n_chunks*cap] zeroed by caller
    uint16_t* row_b,    // [n_chunks*cap] zeroed by caller
    uint8_t* off_b,     // [n_chunks*cap] zeroed by caller
    int64_t* chunk_of,  // out [n]
    int64_t* rank_of)   // out [n]
{
    const int64_t span = stride * chunk_rows;
    const int T0 = num_threads();
    const int T = n < (int64_t)1 << 15 ? 1
        : (int)(n / 16384 < T0 ? n / 16384 : T0);
    const int64_t step = (n + T - 1) / T;
    std::vector<int64_t> hist((size_t)T * n_chunks, 0);
    if (T <= 1) {
        for (int64_t i = 0; i < n; i++) {
            const int64_t h = homes[i];
            const int64_t c = h / span;
            const int64_t r = hist[(size_t)c]++;
            chunk_of[i] = c;
            rank_of[i] = r;
            if (r < cap) {
                const int64_t cell = c * cap + r;
                const int64_t row = h / stride;
                qfp_b[cell] = qfp[i];
                row_b[cell] = (uint16_t)(row - c * chunk_rows);
                off_b[cell] = (uint8_t)(h - row * stride);
            }
        }
        return;
    }
    parallel_for_threads(T, [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        int64_t* h_t = hist.data() + (size_t)t * n_chunks;
        for (int64_t i = a; i < b; i++) {
            const int64_t c = homes[i] / span;
            chunk_of[i] = c;
            h_t[c]++;
        }
    });
    // exclusive per-(chunk, thread) cursors in input-slice order: thread
    // t's first query of chunk c gets rank sum of earlier threads' counts
    for (int64_t c = 0; c < n_chunks; c++) {
        int64_t run = 0;
        for (int t = 0; t < T; t++) {
            const size_t k = (size_t)t * n_chunks + c;
            const int64_t v = hist[k];
            hist[k] = run;
            run += v;
        }
    }
    parallel_for_threads(T, [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        int64_t* cur_t = hist.data() + (size_t)t * n_chunks;
        for (int64_t i = a; i < b; i++) {
            const int64_t h = homes[i];
            const int64_t c = chunk_of[i];
            const int64_t r = cur_t[c]++;
            rank_of[i] = r;
            if (r < cap) {
                const int64_t cell = c * cap + r;
                const int64_t row = h / stride;
                qfp_b[cell] = qfp[i];
                row_b[cell] = (uint16_t)(row - c * chunk_rows);
                off_b[cell] = (uint8_t)(h - row * stride);
            }
        }
    });
}

// ---------------------------------------------------------------------
// Tile-join bin router (lookup/pallas_tilejoin.py, probe_impl
// "tilejoin"), DENSE variant: bins cover EVERY super-tile (the kernel
// grid is then simply 0..n_tiles/tpg), which the dispatcher uses only
// when the query load is dense enough that most tiles are touched
// anyway — the regime the tile-join kernel exists for. Each query packs
// (qfp<<14 | local_row<<7 | in_row_offset) into the int32 cell
// tile*cap + rank, rank = encounter-order rank within the TILE;
// rank_of[i] = sub_tile*cap + rank (the flattened block cell), or the
// sentinel tpg*cap when the tile overflowed cap (exact host pass).
// Bit-identical ranks at any thread count (same per-thread histogram +
// exclusive-cursor scheme as bin_queries above; pinned against the
// numpy twin by tests/test_tilejoin.py).
// n_bands > 1 (the banded kernel form "gather2b",
// pallas_tilejoin.band_geometry): a tile's cap cells split into n_bands
// home-offset bands of bcap = cap/n_bands cells each (band = in-row
// offset / bw, bw = ceil(stride/8) * 8/n_bands); ranks count within
// (tile, band) and overflow at bcap. n_bands = 1 is the classic layout.
extern "C" void bin_tiles_dense(
    const int32_t* homes, const uint16_t* qfp, int64_t n,
    int64_t stride, int64_t tpg, int64_t n_tiles, int64_t cap,
    int64_t n_bands,
    int32_t* packed_b,  // [n_tiles*cap] pre-filled with the pad word
    int64_t* block_of,  // out [n]
    int64_t* rank_of)   // out [n]
{
    const int64_t tile_span = stride * 128;
    const int64_t bw = ((stride + 7) / 8) * (8 / n_bands);
    const int64_t bcap = cap / n_bands;
    const int64_t n_keys = n_tiles * n_bands;
    const int T0 = num_threads();
    const int T = n < (int64_t)1 << 15 ? 1
        : (int)(n / 16384 < T0 ? n / 16384 : T0);
    const int64_t step = (n + T - 1) / T;
    if (T <= 1) {
        std::vector<int64_t> cur(n_keys, 0);
        for (int64_t i = 0; i < n; i++) {
            const int64_t h = homes[i];
            const int64_t t = h / tile_span;
            const int64_t row = h / stride;
            const int64_t off = h - row * stride;
            const int64_t band = n_bands > 1 ? off / bw : 0;
            const int64_t r = cur[(size_t)(t * n_bands + band)]++;
            const int64_t sub = t % tpg;
            block_of[i] = t / tpg;
            const int64_t base = band * bcap;
            rank_of[i] = r < bcap ? sub * cap + base + r : tpg * cap;
            if (r < bcap) {
                packed_b[t * cap + base + r] =
                    (int32_t)(((int64_t)qfp[i] << 14)
                              | ((row & 127) << 7) | off);
            }
        }
        return;
    }
    std::vector<int64_t> hist((size_t)T * n_keys, 0);
    parallel_for_threads(T, [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        int64_t* h_t = hist.data() + (size_t)t * n_keys;
        for (int64_t i = a; i < b; i++) {
            const int64_t h = homes[i];
            const int64_t tl = h / tile_span;
            const int64_t band = n_bands > 1
                ? (h - (h / stride) * stride) / bw : 0;
            h_t[tl * n_bands + band]++;
        }
    });
    for (int64_t c = 0; c < n_keys; c++) {
        int64_t run = 0;
        for (int t = 0; t < T; t++) {
            const size_t k = (size_t)t * n_keys + c;
            const int64_t v = hist[k];
            hist[k] = run;
            run += v;
        }
    }
    parallel_for_threads(T, [&](int t) {
        const int64_t a = t * step;
        const int64_t b = a + step < n ? a + step : n;
        int64_t* cur_t = hist.data() + (size_t)t * n_keys;
        for (int64_t i = a; i < b; i++) {
            const int64_t h = homes[i];
            const int64_t tl = h / tile_span;
            const int64_t row = h / stride;
            const int64_t off = h - row * stride;
            const int64_t band = n_bands > 1 ? off / bw : 0;
            const int64_t r = cur_t[tl * n_bands + band]++;
            const int64_t sub = tl % tpg;
            block_of[i] = tl / tpg;
            const int64_t base = band * bcap;
            rank_of[i] = r < bcap ? sub * cap + base + r : tpg * cap;
            if (r < bcap) {
                packed_b[tl * cap + base + r] =
                    (int32_t)(((int64_t)qfp[i] << 14)
                              | ((row & 127) << 7) | off);
            }
        }
    });
}
