// Fast delimited-numeric-text decoder for DAQ CSV files (VX2730 layout).
//
// The reference decodes CSVs through Polars/PyArrow/pandas
// (reference: waveform_analysis/utils/formats/vx2730.py:50-68); profiling
// our pyarrow path shows the per-column to_numpy + column_stack conversion
// dominating the records build. This decoder parses the ASCII bytes in one
// pass directly into the row-major float64 matrix the records builder
// consumes — no intermediate columnar table, no per-column copies.
//
// Performance shape (measured on this host): memchr runs ~2.4 GB/s but has
// ~30-cycle startup, so it is used ONLY for line-granularity scans (header
// skip, row-count upper bound). Field parsing is a single inline char walk
// — sign + digit accumulate, exact for < 2^63 — falling back to strtod for
// floats/exponents/overflow. Per-field memchr was measured 5x slower than
// the inline walk on ~4-byte fields.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this toolchain).
//
// Build: g++ -O3 -shared -fPIC csv_decode.cpp -o libwfa_native.so

#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

namespace {

inline const char* find_nl(const char* p, const char* end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    return nl ? nl : end;
}

// Advance past `skip_rows` lines.
const char* skip_lines(const char* p, const char* end, int skip_rows) {
    while (skip_rows > 0 && p < end) {
        p = find_nl(p, end);
        if (p < end) ++p;  // past '\n'
        --skip_rows;
    }
    return p;
}

// Count the fields on the line [p, line_end). A trailing delimiter before
// the newline does NOT open a new field (matches pandas/pyarrow handling of
// `1;2;3;\n`). Returns 0 for an empty/blank line.
long long count_fields(const char* p, const char* line_end, char delim) {
    if (p >= line_end || *p == '\r') return 0;
    long long fields = 1;
    const char* last_delim = nullptr;
    for (const char* q = p; q < line_end; ++q) {
        if (*q == delim) {
            last_delim = q;
            ++fields;
        }
    }
    // trailing delimiter (possibly followed by \r) -> drop the empty field
    if (last_delim) {
        const char* q = last_delim + 1;
        while (q < line_end && *q == '\r') ++q;
        if (q >= line_end) --fields;
    }
    return fields;
}

// Slow-path field parse for [p, field_end): trims spaces, then
// std::from_chars — locale-INDEPENDENT, unlike strtod, which would
// mis-parse "3.14" as 3.0 under a comma-decimal LC_NUMERIC set by the
// embedding application. Used when the inline digit walk rejects (floats,
// exponents, >19 digits, garbage).
double parse_field_slow(const char* p, const char* field_end) {
    while (p < field_end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    const char* e = field_end;
    while (e > p && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r')) --e;
    if (p >= e) return std::nan("");
    // from_chars rejects a leading '+' (strtod accepted it) — skip it
    if (*p == '+') ++p;
    double v = 0.0;
    auto res = std::from_chars(p, e, v);
    if (res.ec != std::errc() || res.ptr != e) return std::nan("");
    return v;
}

}  // namespace

extern "C" {

// Upper bound on data rows (line count after the header skip) and the
// column count of the first non-blank data line. The exact conforming-row
// count is wfa_csv_decode's return value; callers allocate with this bound
// and trim.
long long wfa_csv_shape(const char* buf, long long len, int skip_rows,
                        char delim, long long* n_cols_out) {
    const char* end = buf + len;
    const char* p = skip_lines(buf, end, skip_rows);
    // column count from the first non-blank line
    long long n_cols = 0;
    for (const char* q = p; q < end && n_cols == 0;) {
        const char* line_end = find_nl(q, end);
        n_cols = count_fields(q, line_end, delim);
        q = (line_end < end) ? line_end + 1 : end;
    }
    *n_cols_out = n_cols;
    if (n_cols == 0) return 0;
    // row upper bound: newline count (+1 for an unterminated last line)
    long long rows = 0;
    for (const char* q = p; q < end;) {
        const char* nl = (const char*)memchr(q, '\n', (size_t)(end - q));
        if (!nl) {
            ++rows;  // last line without trailing newline
            break;
        }
        ++rows;
        q = nl + 1;
    }
    return rows;
}

// Parse into out[max_rows * n_cols] (row-major float64). Rows whose field
// count differs from n_cols are skipped. Returns the number of rows
// written. Single pass, single char walk: fields parse inline as they are
// located; a row that turns out malformed simply does not advance the row
// cursor (its partial values are overwritten by the next valid row).
long long wfa_csv_decode(const char* buf, long long len, int skip_rows,
                         char delim, long long n_cols, long long max_rows,
                         double* out) {
    const char* end = buf + len;
    const char* p = skip_lines(buf, end, skip_rows);
    long long row = 0;
    while (p < end && row < max_rows) {
        const char* line_end = find_nl(p, end);
        if (p == line_end || *p == '\r') {  // blank line
            p = (line_end < end) ? line_end + 1 : end;
            continue;
        }
        double* out_row = out + row * n_cols;
        const char* f = p;
        long long c = 0;
        bool exhausted = false;  // ran out of fields before n_cols
        while (c < n_cols) {
            if (f == line_end) {
                // empty field after a delimiter at line end: a trailing
                // delimiter does not open a field (count_fields contract)
                exhausted = true;
                break;
            }
            // inline fast path: optional sign + up to 19 digits, ending
            // exactly at a delimiter or the line end
            const char* q = f;
            bool neg = false;
            if (q < line_end && (*q == '-' || *q == '+')) {
                neg = (*q == '-');
                ++q;
            }
            unsigned long long acc = 0;
            const char* ds = q;
            while (q < line_end && (unsigned char)(*q - '0') < 10u
                   && (q - ds) < 19) {
                acc = acc * 10ull + (unsigned long long)(*q - '0');
                ++q;
            }
            const char* fe;
            if (q > ds && (q == line_end || *q == delim)) {
                out_row[c++] = neg ? -(double)acc : (double)acc;
                fe = q;
            } else {
                // locate the field end, then slow-parse
                fe = q;
                while (fe < line_end && *fe != delim) ++fe;
                out_row[c++] = parse_field_slow(f, fe);
            }
            if (fe == line_end) {
                exhausted = true;
                f = line_end;
                break;
            }
            f = fe + 1;
        }
        bool ok;
        if (exhausted) {
            ok = (c == n_cols);  // last field ended exactly at line end
        } else {
            // wrote n_cols fields with a delimiter after the last one:
            // valid only if the remainder is empty (trailing delimiter)
            const char* q = f;
            while (q < line_end && *q == '\r') ++q;
            ok = (q >= line_end);
        }
        if (ok) ++row;
        p = (line_end < end) ? line_end + 1 : end;
    }
    return row;
}

// ---------------------------------------------------------------------------
// Typed single-pass VX2730 decode: parse directly into the records-builder
// columns (board/channel int16, timestamp int64, uint16 sample matrix,
// float64 baseline means) instead of a row-major float64 matrix.
//
// Why: the generic path writes n_cols*8 bytes per row of f64 output that
// numpy immediately re-reads and converts (board->i16, samples->u16,
// baseline window mean) — on this host the f64 stores alone exceed the CSV
// input bytes. The typed pass emits the final representation once and folds
// the baseline-window sum into the sample writes.
//
// Digit parsing is SWAR (8 bytes at a time): classify the digit run with
// bit tricks, left-align, and reduce with two multiplies — ~3x fewer
// instructions than the per-char accumulate loop on the 3-5 digit sample
// fields that dominate VX2730 rows.
//
// Strictness contract: the typed pass handles rows of exactly n_cols
// fields where board/channel/timestamp/samples are plain non-negative
// integers in range (i16 / i64 / u16). A row with the WRONG field count is
// skipped, matching wfa_csv_decode. Any other anomaly (float where an int
// must be, overflow, stray text) returns -1 and the caller falls back to
// the generic decoder — keeping bit-parity with the reference pipeline on
// weird files while real DAQ data takes the fast path.

#if defined(__AVX512BW__) && defined(__AVX512F__)
#include <immintrin.h>
#define WFA_HAVE_AVX512 1
#endif

namespace {

#ifdef WFA_HAVE_AVX512
// 64-byte classification window: one load + three compares yield per-byte
// delimiter / digit / line-end masks covering ~13 sample fields at once.
// The per-field work drops to tzcnt + an 8-byte value load + the two-mul
// SWAR reduction — the per-byte classify of the scalar path disappears.
struct MaskWin {
    const char* base;
    uint64_t delim;
    uint64_t digit;
    uint64_t stop;   // delim | \n | \r | NUL-pad
};

inline void load_win(const char* p, const char* end, char delim_c,
                     MaskWin* w) {
    __m512i v;
    if (end - p >= 64) {
        v = _mm512_loadu_si512((const void*)p);
    } else {
        alignas(64) char buf[64] = {0};  // NUL pad: non-digit, stop via NUL
        memcpy(buf, p, (size_t)(end - p));
        v = _mm512_load_si512((const void*)buf);
    }
    w->base = p;
    uint64_t d = _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8(delim_c));
    uint64_t ge = _mm512_cmp_epu8_mask(v, _mm512_set1_epi8('0'), _MM_CMPINT_NLT);
    uint64_t le = _mm512_cmp_epu8_mask(v, _mm512_set1_epi8('9'), _MM_CMPINT_LE);
    uint64_t nl = _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('\n'))
                | _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('\r'))
                | _mm512_cmpeq_epi8_mask(v, _mm512_setzero_si512());
    w->delim = d;
    w->digit = ge & le;
    w->stop = d | nl;
}
#endif

// Digit-run length at q (0..8) and the parsed value of that run.
// Requires 8 readable bytes at q (caller guarantees via padding check).
inline int swar_digit_run(const char* q, unsigned* val) {
    uint64_t w;
    memcpy(&w, q, 8);
    uint64_t x = w ^ 0x3030303030303030ull;           // digits: byte <= 9
    uint64_t hi = x & 0xF0F0F0F0F0F0F0F0ull;          // high nibble set -> non-digit
    uint64_t lo = ((x & 0x0F0F0F0F0F0F0F0Full) + 0x0606060606060606ull)
                  & 0x1010101010101010ull;            // low nibble > 9
    uint64_t nond = hi | lo;                          // per-byte non-digit flags
    int len = nond ? (__builtin_ctzll(nond) >> 3) : 8;
    if (len == 0) { *val = 0; return 0; }
    // left-align into an 8-digit string "000...d0d1..": shift digits to the
    // high byte positions and fill the vacated low bytes with ASCII zeros
    int pad = 8 - len;
    uint64_t digits = (pad == 0)
        ? w
        : ((w << (pad * 8)) | (0x3030303030303030ull >> (len * 8)));
    // Lemire parse-8-digits: pairs then quads then the full value
    uint64_t v = digits - 0x3030303030303030ull;
    v = (v * 10) + (v >> 8);
    v = (((v & 0x000000FF000000FFull) * 0x000F424000000064ull)
         + (((v >> 16) & 0x000000FF000000FFull) * 0x0000271000000001ull)) >> 32;
    *val = (unsigned)v;
    return len;
}

}  // namespace

long long wfa_csv_decode_typed(
    const char* buf, long long len, int skip_rows, char delim,
    long long n_cols, long long max_rows,
    int samples_start, int baseline_lo, int baseline_hi,
    short* board_out, short* channel_out, long long* ts_out,
    double* baseline_out, unsigned short* samples_out) {
    const char* end = buf + len;
    const char* p = skip_lines(buf, end, skip_rows);
    if (n_cols <= samples_start || samples_start < 3) return -1;
    const long long n_samples = n_cols - samples_start;
    // sample-relative baseline window (absolute col indexes in, clamped)
    long long bl_lo = baseline_lo - samples_start;
    long long bl_hi = baseline_hi - samples_start;
    if (bl_lo < 0) bl_lo = 0;
    if (bl_hi > n_samples) bl_hi = n_samples;
    const long long bl_count = (bl_hi > bl_lo) ? (bl_hi - bl_lo) : 0;

    // SWAR loads read 8 bytes; ensure the tail is never overrun by falling
    // back to -1 when a row approaches the last 8 bytes unterminated. The
    // caller passes the full file buffer, so simply require 8 spare bytes
    // after every field start (checked inline).
    long long row = 0;
    while (p < end && row < max_rows) {
        const char* line_end = find_nl(p, end);
        if (p == line_end || *p == '\r') {
            p = (line_end < end) ? line_end + 1 : end;
            continue;
        }
        const char* f = p;
        bool bail = false;       // anomaly -> generic decoder
        bool skip_row = false;   // wrong field count -> skip (parity)
        long long c = 0;
        short bd = 0, ch = 0;
        long long ts = 0;
        unsigned long long bl_isum = 0;
        unsigned short* srow = samples_out + row * n_samples;

        // --- board / channel: small ints --------------------------------
        for (int k = 0; k < 2 && !bail && !skip_row; ++k) {
            if (end - f < 8) { bail = true; break; }
            unsigned v;
            int dlen = swar_digit_run(f, &v);
            if (dlen == 0 || dlen > 5 || v > 32767) { bail = true; break; }
            const char* q = f + dlen;
            if (q >= line_end || *q != delim) { bail = true; break; }
            if (k == 0) bd = (short)v; else ch = (short)v;
            f = q + 1;
            ++c;
        }
        // --- timestamp: up to 19 digits, scalar accumulate ---------------
        if (!bail && !skip_row) {
            const char* q = f;
            unsigned long long acc = 0;
            const char* ds = q;
            while (q < line_end && (unsigned char)(*q - '0') < 10u
                   && (q - ds) < 19) {
                acc = acc * 10ull + (unsigned long long)(*q - '0');
                ++q;
            }
            if (q == ds || q >= line_end || *q != delim
                || acc > 0x7FFFFFFFFFFFFFFFull) {
                bail = true;
            } else {
                ts = (long long)acc;
                f = q + 1;
                ++c;
            }
        }
        // --- skipped header columns 3..samples_start-1 -------------------
        for (long long k = 3; k < samples_start && !bail && !skip_row; ++k) {
            const char* q = f;
            while (q < line_end && *q != delim) ++q;
            if (q >= line_end) { skip_row = true; break; }  // short row
            f = q + 1;
            ++c;
        }
        // --- samples: SWAR u16 parse + baseline accumulation -------------
#ifdef WFA_HAVE_AVX512
        // AVX-512 path: one 64-byte classification covers ~13 fields.
        // The mask walk extracts consecutive field boundaries with
        // tzcnt/blsr (2-3 cycle serial chain per field); the value parses
        // and digit validations hang off (start, len) pairs and overlap
        // across fields in the OOO window — the scalar path's long
        // per-field dependency chain (classify -> advance -> classify)
        // disappears. Same accept/skip/bail contract as the scalar loop
        // below (compiled when AVX-512BW is absent).
        if (!bail && !skip_row) {
            long long s = 0;
            while (s < n_samples && !bail && !skip_row) {
                MaskWin w;
                load_win(f, end, delim, &w);
                const char* base = w.base;
                const long long win_bytes =
                    (end - base >= 64) ? 64 : (end - base);
                uint64_t m = w.stop;
                long long start_off = 0;
                bool progressed = false;
                while (s < n_samples) {
                    if (m == 0) break;  // field crosses the window edge
                    int stop_pos = __builtin_ctzll(m);
                    int dlen = stop_pos - (int)start_off;
                    if (dlen <= 0 || dlen > 5) { bail = true; break; }
                    uint64_t need = ((1ull << stop_pos) - (1ull << start_off));
                    if ((w.digit & need) != need) { bail = true; break; }
                    const char* fs = base + start_off;
                    unsigned v;
                    if (end - fs >= 8) {
                        uint64_t wv; memcpy(&wv, fs, 8);
                        int pad = 8 - dlen;
                        uint64_t digits = (pad == 0) ? wv
                            : ((wv << (pad * 8))
                               | (0x3030303030303030ull >> (dlen * 8)));
                        uint64_t x = digits - 0x3030303030303030ull;
                        x = (x * 10) + (x >> 8);
                        x = (((x & 0x000000FF000000FFull)
                              * 0x000F424000000064ull)
                             + (((x >> 16) & 0x000000FF000000FFull)
                                * 0x0000271000000001ull)) >> 32;
                        v = (unsigned)x;
                    } else {
                        v = 0;
                        for (int i2 = 0; i2 < dlen; ++i2)
                            v = v * 10u + (unsigned)(fs[i2] - '0');
                    }
                    if (v > 65535u) { bail = true; break; }
                    const char* q = base + stop_pos;
                    if (q > line_end) q = line_end;  // NUL pad past buffer
                    bool lastf = (s == n_samples - 1);
                    if (lastf) {
                        const char* r = q;
                        while (r < line_end && *r == '\r') ++r;
                        if (r < line_end) {
                            if (*q == delim) {
                                const char* t = q + 1;
                                while (t < line_end && *t == '\r') ++t;
                                if (t < line_end) { skip_row = true; break; }
                            } else { bail = true; break; }
                        }
                    } else if (q >= line_end) {
                        skip_row = true;  // short row
                        break;
                    } else if (*q != delim) {
                        bail = true;  // junk after digits: generic decoder
                        break;
                    }
                    srow[s] = (unsigned short)v;
                    if (s >= bl_lo && s < bl_hi) bl_isum += v;
                    ++s;
                    ++c;
                    progressed = true;
                    start_off = stop_pos + 1;
                    m &= m - 1;
                    if (start_off >= win_bytes) break;
                }
                if (bail || skip_row || s >= n_samples) break;
                // reload at the start of the unfinished field
                const char* nf = base + start_off;
                if (!progressed && nf == f) { bail = true; break; }  // stuck
                f = nf;
            }
        }
#else
        if (!bail && !skip_row) {
            for (long long s = 0; s < n_samples; ++s) {
                if (end - f < 8) {
                    // near the buffer tail: only the final fields of the
                    // last line may land here; use the scalar path
                    unsigned long long acc = 0;
                    const char* q = f;
                    const char* ds = q;
                    while (q < line_end && (unsigned char)(*q - '0') < 10u
                           && (q - ds) < 6) {
                        acc = acc * 10ull + (unsigned long long)(*q - '0');
                        ++q;
                    }
                    if (q == ds || acc > 65535u) { bail = true; break; }
                    bool last = (s == n_samples - 1);
                    if (last) {
                        const char* r = q;
                        while (r < line_end && *r == '\r') ++r;
                        if (r < line_end) { bail = true; break; }
                    } else if (q >= line_end) {
                        skip_row = true; break;  // short row
                    } else if (*q != delim) {
                        bail = true; break;  // junk after digits: generic
                    }
                    srow[s] = (unsigned short)acc;
                    if (s >= bl_lo && s < bl_hi) bl_isum += acc;
                    f = (q < line_end && *q == delim) ? q + 1 : q;
                    ++c;
                    continue;
                }
                unsigned v;
                int dlen = swar_digit_run(f, &v);
                if (dlen == 0 || dlen > 5 || v > 65535u) { bail = true; break; }
                const char* q = f + dlen;
                bool last = (s == n_samples - 1);
                if (last) {
                    const char* r = q;
                    while (r < line_end && *r == '\r') ++r;
                    if (r < line_end) {
                        // extra field(s) beyond n_cols: trailing-delimiter
                        // rows are valid per count_fields; others skip
                        if (*q == delim) {
                            const char* t = q + 1;
                            while (t < line_end && *t == '\r') ++t;
                            if (t >= line_end) { r = line_end; }
                            else { skip_row = true; break; }
                        } else { bail = true; break; }
                    }
                } else if (q >= line_end) {
                    skip_row = true;  // short row (field count mismatch)
                    break;
                } else if (*q != delim) {
                    bail = true;  // junk after digits ("12x"): the generic
                    break;        // decoder keeps that row with NaN
                }
                srow[s] = (unsigned short)v;
                if (s >= bl_lo && s < bl_hi) bl_isum += v;
                f = (q < line_end && *q == delim) ? q + 1 : q;
                ++c;
            }
        }
#endif

        if (bail) return -1;
        if (!skip_row) {
            board_out[row] = bd;
            channel_out[row] = ch;
            ts_out[row] = ts;
            baseline_out[row] = bl_count ? ((double)bl_isum / (double)bl_count)
                                         : std::nan("");
            ++row;
        }
        p = (line_end < end) ? line_end + 1 : end;
    }
    return row;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CAEN V1725 DAW_DEMO binary decode (wire format: formats/v1725.py docstring;
// reference analog: waveform_analysis/utils/formats/v1725.py:26-115).
// Event header 16 B (channel mask = byte4 | byte11<<8); per active channel a
// 12 B header (22-bit size in words incl. 3 header words, trunc = bit6 of
// byte3, 48-bit LE timestamp at bytes 4-9, 16-bit baseline at bytes 10-11)
// followed by (size-3)*4 bytes of LE int16 samples. Malformed tails stop the
// file, matching the Python reader's truncation handling.

namespace {

inline unsigned long long le_u48(const unsigned char* p) {
    unsigned long long v = 0;
    for (int i = 5; i >= 0; --i) v = (v << 8) | p[i];
    return v;
}

}  // namespace

extern "C" {

// Count records and total samples (for exact preallocation).
long long wfa_v1725_scan(const char* buf, long long len,
                         long long* total_samples_out) {
    const unsigned char* b = (const unsigned char*)buf;
    long long pos = 0, records = 0, samples = 0;
    while (pos + 16 <= len) {
        unsigned mask = b[pos + 4] | ((unsigned)b[pos + 11] << 8);
        pos += 16;
        bool bad = false;
        for (int ch = 0; ch < 16 && mask; ++ch) {
            if (!(mask & (1u << ch))) continue;
            mask &= ~(1u << ch);
            if (pos + 12 > len) { bad = true; break; }
            long long words = (long long)(b[pos] | ((unsigned)b[pos + 1] << 8)
                              | ((unsigned)b[pos + 2] << 16)) & ((1 << 22) - 1);
            long long sig_bytes = (words - 3) * 4;
            pos += 12;
            if (sig_bytes < 0 || pos + sig_bytes > len) { bad = true; break; }
            pos += sig_bytes;
            ++records;
            samples += sig_bytes / 2;
        }
        if (bad) break;
    }
    *total_samples_out = samples;
    return records;
}

// Fill per-record columns + the contiguous uint16 sample pool. Outputs must
// be sized from wfa_v1725_scan. Returns records written.
long long wfa_v1725_decode(const char* buf, long long len,
                           short* channel_out, long long* timestamp_out,
                           double* baseline_out, unsigned char* trunc_out,
                           long long* offset_out, int* length_out,
                           unsigned short* pool_out) {
    const unsigned char* b = (const unsigned char*)buf;
    long long pos = 0, rec = 0, pool_pos = 0;
    while (pos + 16 <= len) {
        unsigned mask = b[pos + 4] | ((unsigned)b[pos + 11] << 8);
        pos += 16;
        bool bad = false;
        for (int ch = 0; ch < 16 && mask; ++ch) {
            if (!(mask & (1u << ch))) continue;
            mask &= ~(1u << ch);
            if (pos + 12 > len) { bad = true; break; }
            const unsigned char* h = b + pos;
            long long words = (long long)(h[0] | ((unsigned)h[1] << 8)
                              | ((unsigned)h[2] << 16)) & ((1 << 22) - 1);
            long long sig_bytes = (words - 3) * 4;
            pos += 12;
            if (sig_bytes < 0 || pos + sig_bytes > len) { bad = true; break; }
            channel_out[rec] = (short)ch;
            trunc_out[rec] = (h[3] >> 6) & 1;
            timestamp_out[rec] = (long long)le_u48(h + 4);
            baseline_out[rec] = (double)(h[10] | ((unsigned)h[11] << 8));
            long long n_samp = sig_bytes / 2;
            offset_out[rec] = pool_pos;
            length_out[rec] = (int)n_samp;
            // raw little-endian int16 bytes reinterpret as uint16 — bit-
            // identical to the Python path's int16 -> astype(uint16)
            memcpy(pool_out + pool_pos, b + pos, (size_t)sig_bytes);
            pool_pos += n_samp;
            pos += sig_bytes;
            ++rec;
        }
        if (bad) break;
    }
    return rec;
}

// Header-only walk: like wfa_v1725_decode but offset_out carries the BYTE
// offset of each record's samples within buf and no samples are copied —
// the caller uploads buf once and unpacks on the accelerator
// (ops/v1725_device.py). Outputs sized from wfa_v1725_scan; returns
// records written.
long long wfa_v1725_headers(const char* buf, long long len,
                            short* channel_out, long long* timestamp_out,
                            double* baseline_out, unsigned char* trunc_out,
                            long long* offset_out, int* length_out) {
    const unsigned char* b = (const unsigned char*)buf;
    long long pos = 0, rec = 0;
    while (pos + 16 <= len) {
        unsigned mask = b[pos + 4] | ((unsigned)b[pos + 11] << 8);
        pos += 16;
        bool bad = false;
        for (int ch = 0; ch < 16 && mask; ++ch) {
            if (!(mask & (1u << ch))) continue;
            mask &= ~(1u << ch);
            if (pos + 12 > len) { bad = true; break; }
            const unsigned char* h = b + pos;
            long long words = (long long)(h[0] | ((unsigned)h[1] << 8)
                              | ((unsigned)h[2] << 16)) & ((1 << 22) - 1);
            long long sig_bytes = (words - 3) * 4;
            pos += 12;
            if (sig_bytes < 0 || pos + sig_bytes > len) { bad = true; break; }
            channel_out[rec] = (short)ch;
            trunc_out[rec] = (h[3] >> 6) & 1;
            timestamp_out[rec] = (long long)le_u48(h + 4);
            baseline_out[rec] = (double)(h[10] | ((unsigned)h[11] << 8));
            offset_out[rec] = pos;
            length_out[rec] = (int)(sig_bytes / 2);
            pos += sig_bytes;
            ++rec;
        }
        if (bad) break;
    }
    return rec;
}

}  // extern "C"
