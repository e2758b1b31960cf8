// Native bulk FASTA parser with reference-identical semantics.
//
// One pass over the whole input buffer replaces the Python line
// generator of formats/fasta.py (the reference's readFasta loop,
// /root/reference/lib/src/kmergutsjava/KmerGutsJava.java:1132-1192),
// reproducing its quirks exactly — Java trim (every char <= ' '),
// bare-">" lines silently skipped while seeking a caption, caption ids
// as the first space/tab token with the description re-joined by single
// spaces, raw (untrimmed) sequence lines, and the two error messages.
// Differentially pinned against the Python parser and the scalar Java
// oracle by tests/test_fasta_fuzz.py.
//
// Line semantics mirror readline().rstrip("\r\n"): lines split on '\n',
// then ALL trailing '\r' stripped; a trailing line without a newline is
// still a line; the empty tail after a final newline is not.
//
// Outputs: per record, six int64s (id_off, id_len, descr_off,
// descr_len, seq_off, seq_len) indexing into the compaction buffer
// `out` (ids, normalized descriptions, and concatenated sequence bytes
// are copied there; total <= n). Returns the record count, or -1
// ("Wrong caption line: <payload>") / -2 ("No sequence for caption:
// <payload>") with the message payload's (off, len) in err[0..1].

#include <cstdint>
#include <cstring>

static inline int64_t jtrim(const uint8_t* s, int64_t len, int64_t* start) {
    int64_t a = 0, b = len;
    while (a < b && s[a] <= ' ') a++;
    while (b > a && s[b - 1] <= ' ') b--;
    *start = a;
    return b - a;
}

extern "C" int64_t parse_fasta(
    const uint8_t* text, int64_t n,
    int64_t* rec, int64_t max_rec,
    uint8_t* out,          // capacity >= n
    int64_t* err)          // [2]: error payload (off, len) in out
{
    int64_t pos = 0, w = 0, nrec = 0;
    bool eof = (n == 0);
    int64_t ls = 0, le = 0;  // current line content [ls, le)

    auto next_line = [&]() {
        if (pos >= n) { eof = true; return; }
        ls = pos;
        const void* nl = memchr(text + pos, '\n', (size_t)(n - pos));
        int64_t end = nl ? (int64_t)((const uint8_t*)nl - text) : n;
        pos = nl ? end + 1 : n;
        while (end > ls && text[end - 1] == '\r') end--;
        le = end;
    };
    next_line();

    for (;;) {
        // --- caption seek (ref :1141-1162) ---
        int64_t id_off = 0, id_len = 0, descr_off = 0, descr_len = 0;
        for (;;) {
            if (eof) return nrec;
            int64_t ts;
            const int64_t tl = jtrim(text + ls, le - ls, &ts);
            const uint8_t* t = text + ls + ts;
            if (tl > 1) {
                int64_t rs;
                const int64_t rl = jtrim(t + 1, tl - 1, &rs);
                if (t[0] != '>' || rl == 0) {  // "Wrong caption line: <t>"
                    memcpy(out + w, t, (size_t)tl);
                    err[0] = w;
                    err[1] = tl;
                    return -1;
                }
                // id = first space/tab token; descr = rest, single-space
                // joined (ref: replace('\t',' ').split(' '), drop empties)
                int64_t i = 1;
                while (i < tl && (t[i] == ' ' || t[i] == '\t')) i++;
                id_off = w;
                while (i < tl && t[i] != ' ' && t[i] != '\t') out[w++] = t[i++];
                id_len = w - id_off;
                descr_off = w;
                bool any = false;
                while (i < tl) {
                    while (i < tl && (t[i] == ' ' || t[i] == '\t')) i++;
                    if (i >= tl) break;
                    if (any) out[w++] = ' ';
                    while (i < tl && t[i] != ' ' && t[i] != '\t')
                        out[w++] = t[i++];
                    any = true;
                }
                descr_len = w - descr_off;
                break;
            }
            next_line();  // trimmed length <= 1: silently skipped
        }
        // --- first sequence line (ref :1167-1174) ---
        for (;;) {
            next_line();
            int64_t s2 = 0;
            const int64_t l2 = eof ? 0 : jtrim(text + ls, le - ls, &s2);
            if (eof || (l2 > 0 && text[ls + s2] == '>')) {
                err[0] = id_off;  // "No sequence for caption: <id>"
                err[1] = id_len;
                return -2;
            }
            if (l2 > 0) break;
        }
        // --- sequence accumulation, raw lines (ref :1175-1180) ---
        const int64_t seq_off = w;
        for (;;) {
            memcpy(out + w, text + ls, (size_t)(le - ls));
            w += le - ls;
            next_line();
            if (eof) break;
            int64_t s3;
            if (jtrim(text + ls, le - ls, &s3) > 0 && text[ls + s3] == '>')
                break;
        }
        if (nrec >= max_rec) return -3;  // caller sized by '>' count
        rec[6 * nrec + 0] = id_off;
        rec[6 * nrec + 1] = id_len;
        rec[6 * nrec + 2] = descr_off;
        rec[6 * nrec + 3] = descr_len;
        rec[6 * nrec + 4] = seq_off;
        rec[6 * nrec + 5] = w - seq_off;
        nrec++;
        // current line (a '>' line) seeds the next caption seek
    }
}

// The ids of a parse's nrec records (rec as parse_fasta wrote it),
// newline-joined into `out` (capacity: the ids' bytes plus nrec - 1; an
// id holds no newline). Returns the bytes written.
extern "C" int64_t join_ids(const uint8_t* buf, const int64_t* rec,
                            int64_t nrec, uint8_t* out)
{
    int64_t w = 0;
    for (int64_t r = 0; r < nrec; r++) {
        if (r) out[w++] = '\n';
        memcpy(out + w, buf + rec[6 * r], (size_t)rec[6 * r + 1]);
        w += rec[6 * r + 1];
    }
    return w;
}
