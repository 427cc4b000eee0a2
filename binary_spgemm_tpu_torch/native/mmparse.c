/* Fast Matrix-Market coordinate-body parser.
 *
 * Native equivalent of the reference's C ingest tier (readCOO's fscanf loop,
 * final/utils.c:66-71, and the vendored NIST mmio): parses the entry body of a
 * coordinate file — `nnz` lines of `row col [value...]` — into uint32 arrays.
 * Only the first two fields of each line are used (the reference's
 * fscanf("%u %u") semantics); any further fields are skipped.
 *
 * Built at first use by binary_spgemm_tpu_torch/native/__init__.py
 * (cc -O3 -fopenmp -shared -fPIC) into binary_spgemm_tpu_torch/build/ and
 * called from Python via ctypes.
 */
#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

/* Parse up to `nnz` coordinate entries from buf[0..len).  `fields` is the
 * number of whitespace-separated fields per entry (>= 2); fields beyond the
 * first two are skipped.  Writes 1-based values as found (caller shifts).
 * Returns the number of entries parsed, or -1 on malformed input. */
long mm_parse_pairs(const char *buf, long len, long nnz, int fields,
                    uint32_t *rows, uint32_t *cols) {
    const char *p = buf, *end = buf + len;
    long count = 0;
    while (count < nnz) {
        uint32_t vals[2];
        for (int f = 0; f < fields; f++) {
            /* skip whitespace / newlines */
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                               *p == '\r'))
                p++;
            if (p >= end)
                return (f == 0) ? count : -1; /* clean EOF only between entries */
            if (f < 2) {
                if (*p < '0' || *p > '9')
                    return -1;
                uint64_t v = 0;
                while (p < end && *p >= '0' && *p <= '9') {
                    v = v * 10u + (uint64_t)(*p - '0');
                    if (v > 0xffffffffu)
                        return -1;
                    p++;
                }
                vals[f] = (uint32_t)v;
            } else {
                /* skip a value token (real/integer field) */
                while (p < end && *p != ' ' && *p != '\t' && *p != '\n' &&
                       *p != '\r')
                    p++;
            }
        }
        rows[count] = vals[0];
        cols[count] = vals[1];
        count++;
    }
    return count;
}

/* Parallel variant of mm_parse_pairs (the reference parses serially with
 * fscanf on every rank, final/utils.c:66-71; multi-GB SuiteSparse bodies
 * deserve all host cores).  The body is split at newline boundaries; a
 * cheap token-count pass fixes each chunk's exact entry offset, then the
 * chunks parse independently into the shared output arrays.  Entries that
 * straddle a newline (non-standard layouts) make a chunk's token count
 * indivisible by `fields`; any such inconsistency returns -2 and the
 * caller falls back to the bit-identical serial parser. */
#define MM_PAR_MAX_THREADS 64

static int mm_is_ws(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

long mm_parse_pairs_par(const char *buf, long len, long nnz, int fields,
                        uint32_t *rows, uint32_t *cols, int nthreads) {
#ifndef _OPENMP
    (void)nthreads;
    return mm_parse_pairs(buf, len, nnz, fields, rows, cols);
#else
    int nt = nthreads;
    if (nt > MM_PAR_MAX_THREADS)
        nt = MM_PAR_MAX_THREADS;
    if (nt < 2 || len < (1L << 20))
        return mm_parse_pairs(buf, len, nnz, fields, rows, cols);
    long starts[MM_PAR_MAX_THREADS + 1];
    starts[0] = 0;
    for (int t = 1; t < nt; t++) {
        long p = len * t / nt;
        if (p < starts[t - 1])
            p = starts[t - 1];
        while (p < len && buf[p] != '\n')
            p++;
        starts[t] = (p < len) ? p + 1 : len;
    }
    starts[nt] = len;
    long cnt[MM_PAR_MAX_THREADS];
    int bad = 0;
#pragma omp parallel for num_threads(nt) reduction(| : bad)
    for (int t = 0; t < nt; t++) {
        const char *p = buf + starts[t], *end = buf + starts[t + 1];
        long tokens = 0;
        while (p < end) {
            while (p < end && mm_is_ws(*p))
                p++;
            if (p >= end)
                break;
            tokens++;
            while (p < end && !mm_is_ws(*p))
                p++;
        }
        if (tokens % fields)
            bad = 1;
        cnt[t] = tokens / fields;
    }
    if (bad)
        return -2;
    long off[MM_PAR_MAX_THREADS + 1];
    off[0] = 0;
    for (int t = 0; t < nt; t++)
        off[t + 1] = off[t] + cnt[t];
    if (off[nt] < nnz)
        return -2; /* fewer entries than declared: serial decides */
    int fail = 0;
#pragma omp parallel for num_threads(nt) reduction(| : fail)
    for (int t = 0; t < nt; t++) {
        long lo = off[t] < nnz ? off[t] : nnz;
        long hi = off[t + 1] < nnz ? off[t + 1] : nnz;
        if (hi <= lo)
            continue;
        long got = mm_parse_pairs(buf + starts[t], starts[t + 1] - starts[t],
                                  hi - lo, fields, rows + lo, cols + lo);
        if (got != hi - lo)
            fail = 1;
    }
    return fail ? -2 : nnz;
#endif
}

/* Filtered parse for sharded ingest: keep only entries whose 1-based field
 * `which` (0 = first, 1 = second) lies in [vlo, vhi).  With rows == NULL it
 * only counts (the sizing pass); otherwise it writes at most `cap` entries
 * and returns -3 on overflow.  Two calls give an exactly-sized, memory-
 * bounded per-process slice of a huge file — each rank stores O(local nnz)
 * instead of materialising every entry the way the reference's replicated
 * readCOO does (final/SpGEMM_mpi_omp.c:309). */
long mm_parse_pairs_filtered(const char *buf, long len, long nnz, int fields,
                             int which, uint32_t vlo, uint32_t vhi,
                             uint32_t *rows, uint32_t *cols, long cap) {
    const char *p = buf, *end = buf + len;
    long seen = 0, kept = 0;
    while (seen < nnz) {
        uint32_t vals[2];
        for (int f = 0; f < fields; f++) {
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                               *p == '\r'))
                p++;
            if (p >= end)
                return (f == 0) ? kept : -1;
            if (f < 2) {
                if (*p < '0' || *p > '9')
                    return -1;
                uint64_t v = 0;
                while (p < end && *p >= '0' && *p <= '9') {
                    v = v * 10u + (uint64_t)(*p - '0');
                    if (v > 0xffffffffu)
                        return -1;
                    p++;
                }
                vals[f] = (uint32_t)v;
            } else {
                while (p < end && *p != ' ' && *p != '\t' && *p != '\n' &&
                       *p != '\r')
                    p++;
            }
        }
        seen++;
        if (vals[which] >= vlo && vals[which] < vhi) {
            if (rows) {
                if (kept >= cap)
                    return -3;
                rows[kept] = vals[0];
                cols[kept] = vals[1];
            }
            kept++;
        }
    }
    return kept;
}

/* Format `n` coordinate pairs as 1-based "row col\n" ASCII into out (caller
 * sizes it: 22 bytes/pair is always enough).  Returns bytes written. */
long mm_format_pairs(const uint32_t *rows, const uint32_t *cols, long n,
                     char *out) {
    char *q = out;
    for (long i = 0; i < n; i++) {
        for (int f = 0; f < 2; f++) {
            uint32_t v = (f == 0 ? rows[i] : cols[i]) + 1u;
            char tmp[10];
            int k = 0;
            do {
                tmp[k++] = (char)('0' + v % 10u);
                v /= 10u;
            } while (v);
            while (k)
                *q++ = tmp[--k];
            *q++ = (f == 0) ? ' ' : '\n';
        }
    }
    return (long)(q - out);
}

/* Stable COO->CSR grouping (native tier of formats/bcsr.py::coo_to_csr_stable;
 * same histogram / exclusive-scan / write-cursor-scatter structure as the
 * reference's coo2csc, final/coo2csc.c:33-62, but grouping by the FIRST index
 * — the transpose semantics live in the caller, io/mmio.py).  Entries sharing
 * a row keep input order; duplicates are kept.  Returns 0, or -1 if any row
 * id is out of range. */
long coo2csr_stable(const uint32_t *rows, const uint32_t *cols, long nnz,
                    long n_rows, uint32_t *indptr /* n_rows+1 */,
                    uint32_t *indices /* nnz */) {
    for (long i = 0; i <= n_rows; i++)
        indptr[i] = 0;
    for (long e = 0; e < nnz; e++) {
        if ((long)rows[e] >= n_rows)
            return -1;
        indptr[rows[e] + 1]++;
    }
    for (long i = 0; i < n_rows; i++)
        indptr[i + 1] += indptr[i];
    /* write-cursor scatter on indptr[0..n_rows-1], then shift back */
    for (long e = 0; e < nnz; e++)
        indices[indptr[rows[e]]++] = cols[e];
    for (long i = n_rows; i > 0; i--)
        indptr[i] = indptr[i - 1];
    indptr[0] = 0;
    return 0;
}

/* Parallel stable COO->CSR: two-level blocked counting sort.  Phase 1
 * histograms (thread, row-block) cells; phase 2 scatters entries grouped by
 * row block into caller-provided scratch, with thread-major order inside a
 * block preserving global input order (stability); phase 3 finishes each
 * block independently with a local write-cursor scatter and writes its
 * indptr slice.  Bit-identical with coo2csr_stable; returns -2 when the
 * shape isn't worth parallelising (caller uses the serial path). */
long coo2csr_stable_par(const uint32_t *rows, const uint32_t *cols, long nnz,
                        long n_rows, uint32_t *indptr, uint32_t *indices,
                        uint32_t *tmp_rows, uint32_t *tmp_cols,
                        int nthreads) {
#ifndef _OPENMP
    (void)tmp_rows;
    (void)tmp_cols;
    (void)nthreads;
    return coo2csr_stable(rows, cols, nnz, n_rows, indptr, indices);
#else
    int nt = nthreads;
    if (nt > MM_PAR_MAX_THREADS)
        nt = MM_PAR_MAX_THREADS;
    if (nt < 2 || nnz < (1L << 20) || n_rows < nt)
        return coo2csr_stable(rows, cols, nnz, n_rows, indptr, indices);
    long nb = (long)nt * 8; /* row blocks: more than threads for balance */
    if (nb > n_rows)
        nb = nt;
    long rows_per_block = (n_rows + nb - 1) / nb;
    long *cell = calloc((size_t)nt * nb, sizeof(long));
    if (!cell)
        return coo2csr_stable(rows, cols, nnz, n_rows, indptr, indices);
    int bad = 0;
#pragma omp parallel for num_threads(nt) reduction(| : bad)
    for (int t = 0; t < nt; t++) {
        long lo = nnz * t / nt, hi = nnz * (t + 1) / nt;
        long *c = cell + (size_t)t * nb;
        for (long e = lo; e < hi; e++) {
            if ((long)rows[e] >= n_rows) {
                bad = 1;
                break;
            }
            c[rows[e] / rows_per_block]++;
        }
    }
    if (bad) {
        free(cell);
        return -1;
    }
    /* block-major, then thread-major exclusive scan -> scatter bases */
    long acc = 0;
    long *block_base = malloc((size_t)(nb + 1) * sizeof(long));
    if (!block_base) {
        free(cell);
        return coo2csr_stable(rows, cols, nnz, n_rows, indptr, indices);
    }
    for (long b = 0; b < nb; b++) {
        block_base[b] = acc;
        for (int t = 0; t < nt; t++) {
            long c = cell[(size_t)t * nb + b];
            cell[(size_t)t * nb + b] = acc;
            acc += c;
        }
    }
    block_base[nb] = acc;
#pragma omp parallel for num_threads(nt)
    for (int t = 0; t < nt; t++) {
        long lo = nnz * t / nt, hi = nnz * (t + 1) / nt;
        long *cur = cell + (size_t)t * nb;
        for (long e = lo; e < hi; e++) {
            long d = cur[rows[e] / rows_per_block]++;
            tmp_rows[d] = rows[e];
            tmp_cols[d] = cols[e];
        }
    }
    uint32_t *cursors =
        malloc((size_t)nt * rows_per_block * sizeof(uint32_t));
    if (!cursors) {
        free(block_base);
        free(cell);
        return coo2csr_stable(rows, cols, nnz, n_rows, indptr, indices);
    }
#pragma omp parallel num_threads(nt)
    {
        uint32_t *cursor = cursors + (size_t)omp_get_thread_num() * rows_per_block;
#pragma omp for
        for (long b = 0; b < nb; b++) {
            long r0 = b * rows_per_block;
            long r1 = r0 + rows_per_block;
            if (r1 > n_rows)
                r1 = n_rows;
            long e0 = block_base[b], e1 = block_base[b + 1];
            for (long i = 0; i < r1 - r0; i++)
                cursor[i] = 0;
            for (long e = e0; e < e1; e++)
                cursor[tmp_rows[e] - r0]++;
            long base = e0;
            for (long i = 0; i < r1 - r0; i++) {
                uint32_t c = cursor[i];
                indptr[r0 + i] = (uint32_t)base;
                cursor[i] = (uint32_t)base;
                base += c;
            }
            for (long e = e0; e < e1; e++)
                indices[cursor[tmp_rows[e] - r0]++] = tmp_cols[e];
        }
    }
    indptr[n_rows] = (uint32_t)nnz;
    free(cursors);
    free(block_base);
    free(cell);
    return 0;
#endif
}

/* Per-class partition of A's entries for the sliced-ELL engine (native tier
 * of ops/ell.py::_build_class_entries).  Entry e of A (CSR row r, column c)
 * belongs to class class_of_row[c] (-1 = empty B row; dropped).  Outputs the
 * per-class concatenated (entry row id, in-class position) lists in input
 * order (stable) plus the class cuts.  Parallel stable counting sort:
 * per-thread histograms over contiguous entry ranges; a (class, thread)-
 * ordered exclusive scan gives write cursors, so within a class thread order
 * equals input order.  Returns the number of kept entries, or -1 on alloc
 * failure. */
static long ell_row_of(const uint32_t *indptr, long n_rows, long e) {
    long lo = 0, hi = n_rows; /* last r with indptr[r] <= e */
    while (lo < hi) {
        long mid = (lo + hi + 1) >> 1;
        if ((long)indptr[mid] <= e)
            lo = mid;
        else
            hi = mid - 1;
    }
    return lo;
}

long ell_class_partition(const uint32_t *indptr, long n_rows,
                         const int32_t *cols, long nnz,
                         const int32_t *class_of_row,
                         const int32_t *pos_in_class, int n_classes,
                         int32_t *out_rows, int32_t *out_pos,
                         long *cuts /* n_classes+1 */, int nthreads) {
    int nt = 1;
#ifdef _OPENMP
    nt = nthreads;
    if (nt > MM_PAR_MAX_THREADS)
        nt = MM_PAR_MAX_THREADS;
    if (nt < 1 || nnz < (1L << 18))
        nt = 1;
#else
    (void)nthreads;
#endif
    long *hist = calloc((size_t)nt * n_classes, sizeof(long));
    if (!hist)
        return -1;
#pragma omp parallel for num_threads(nt)
    for (int t = 0; t < nt; t++) {
        long lo = nnz * t / nt, hi = nnz * (t + 1) / nt;
        long *h = hist + (size_t)t * n_classes;
        for (long e = lo; e < hi; e++) {
            int32_t c = class_of_row[cols[e]];
            if (c >= 0)
                h[c]++;
        }
    }
    long acc = 0;
    for (int c = 0; c < n_classes; c++) {
        cuts[c] = acc;
        for (int t = 0; t < nt; t++) {
            long h = hist[(size_t)t * n_classes + c];
            hist[(size_t)t * n_classes + c] = acc;
            acc += h;
        }
    }
    cuts[n_classes] = acc;
#pragma omp parallel for num_threads(nt)
    for (int t = 0; t < nt; t++) {
        long lo = nnz * t / nt, hi = nnz * (t + 1) / nt;
        if (hi <= lo)
            continue;
        long *cur = hist + (size_t)t * n_classes;
        long r = ell_row_of(indptr, n_rows, lo);
        for (long e = lo; e < hi; e++) {
            while (e >= (long)indptr[r + 1])
                r++;
            int32_t c = class_of_row[cols[e]];
            if (c < 0)
                continue;
            long d = cur[c]++;
            out_rows[d] = (int32_t)r;
            out_pos[d] = pos_in_class[cols[e]];
        }
    }
    free(hist);
    return acc;
}

/* Per-row weighted entry sum over a CSR structure: out[r] = sum over entries
 * e of row r of weight[cols[e]].  Serves both the Gustavson row-flop count
 * (weight = B's row lengths; ops/spgemm.py::row_flops) and the sliced-ELL
 * padded-weight plan input (weight = padded class width per B row).
 * Parallel over rows (guided: power-law rows are wildly uneven). */
long csr_row_weight(const uint32_t *indptr, long n_rows, const int32_t *cols,
                    const int64_t *weight, int64_t *out, int nthreads) {
#ifdef _OPENMP
    int nt = nthreads;
    if (nt > MM_PAR_MAX_THREADS)
        nt = MM_PAR_MAX_THREADS;
    if (nt < 1)
        nt = 1;
#pragma omp parallel for num_threads(nt) schedule(guided)
#else
    (void)nthreads;
#endif
    for (long r = 0; r < n_rows; r++) {
        int64_t s = 0;
        for (long e = (long)indptr[r]; e < (long)indptr[r + 1]; e++)
            s += weight[cols[e]];
        out[r] = s;
    }
    return 0;
}

/* Fill per-class sliced-ELLPACK tables (native tier of EllB.build's scatter):
 * each nonempty row r copies its indices into tables[class_of_row[r]] at slot
 * pos_in_class[r] and sentinel-pads the slot's tail.  `tables[c]` is a
 * caller-allocated (np.empty) [n_rows_c, widths[c]] int32 buffer.  Parallel
 * over rows; slots are disjoint by construction. */
long ell_table_fill(const uint32_t *indptr, long n_rows,
                    const int32_t *indices, const int32_t *class_of_row,
                    const int32_t *pos_in_class, int32_t **tables,
                    const long *widths, int32_t sentinel, int nthreads) {
#ifdef _OPENMP
    int nt = nthreads;
    if (nt > MM_PAR_MAX_THREADS)
        nt = MM_PAR_MAX_THREADS;
    if (nt < 1)
        nt = 1;
#pragma omp parallel for num_threads(nt) schedule(guided)
#else
    (void)nthreads;
#endif
    for (long r = 0; r < n_rows; r++) {
        int32_t c = class_of_row[r];
        if (c < 0)
            continue;
        long w = widths[c];
        int32_t *slot = tables[c] + (size_t)pos_in_class[r] * w;
        long lo = (long)indptr[r], hi = (long)indptr[r + 1];
        long i = 0;
        for (long e = lo; e < hi; e++)
            slot[i++] = indices[e];
        for (; i < w; i++)
            slot[i] = sentinel;
    }
    return 0;
}

/* ------------------------------------------------------------------------
 * Host boolean SpGEMM for the small-flop regime (the auto-router's fast
 * path below the device dispatch floor; ops/host.py).
 *
 * Gustavson row loop with a STAMP sparse accumulator: stamp[col] == i+1
 * marks col already emitted for output row i, so rows invalidate each
 * other's marks implicitly — no per-row reset walk and no bool array
 * (contrast the reference's calloc'd `bool xb` + reset loop,
 * final/SpGEMM_mpi_omp.c:36-50; same output contract: per-row ascending
 * deduplicated columns, exclusive row pointers).
 *
 * Returns nnz(C) (>= 0); -1 when `cap` slots are insufficient (caller
 * passes the Gustavson flop bound so this cannot happen from the router);
 * -2 on allocation failure.
 * ---------------------------------------------------------------------- */

static int spgemm_cmp_i32(const void *x, const void *y) {
    int32_t a = *(const int32_t *)x, b = *(const int32_t *)y;
    return (a > b) - (a < b);
}

/* ascending insertion sort: beats qsort for the short rows this path sees */
static void sort_row_i32(int32_t *v, long w) {
    if (w > 48) { qsort(v, (size_t)w, sizeof(int32_t), spgemm_cmp_i32); return; }
    for (long s = 1; s < w; s++) {
        int32_t key = v[s];
        long t = s - 1;
        while (t >= 0 && v[t] > key) { v[t + 1] = v[t]; t--; }
        v[t + 1] = key;
    }
}

long spgemm_host(const uint32_t *a_ptr, const int32_t *a_idx,
                 long n_rows, long n_cols,
                 const uint32_t *b_ptr, const int32_t *b_idx,
                 uint32_t *c_ptr, int32_t *c_idx, long cap) {
    uint32_t *stamp = (uint32_t *)calloc((size_t)n_cols, sizeof(uint32_t));
    if (!stamp) return -2;
    long out = 0;
    c_ptr[0] = 0;
    for (long i = 0; i < n_rows; i++) {
        const uint32_t tag = (uint32_t)i + 1u;
        const long row_start = out;
        for (uint32_t p = a_ptr[i]; p < a_ptr[i + 1]; p++) {
            const int32_t j = a_idx[p];
            const uint32_t q1 = b_ptr[j + 1];
            for (uint32_t q = b_ptr[j]; q < q1; q++) {
                const int32_t k = b_idx[q];
                if (stamp[k] != tag) {
                    stamp[k] = tag;
                    if (out >= cap) { free(stamp); return -1; }
                    c_idx[out++] = k;
                }
            }
        }
        sort_row_i32(c_idx + row_start, out - row_start);
        c_ptr[i + 1] = (uint32_t)out;
    }
    free(stamp);
    return out;
}

/* Masked variant C = F .* (A*B): one stamp array doubles as the allow set.
 * allow[k] == tag     -> k is in F's row i and not yet emitted;
 * allow[k] == tag + 1 -> already emitted.  Tags advance by 2 per row. */
long masked_spgemm_host(const uint32_t *f_ptr, const int32_t *f_idx,
                        const uint32_t *a_ptr, const int32_t *a_idx,
                        long n_rows, long n_cols,
                        const uint32_t *b_ptr, const int32_t *b_idx,
                        uint32_t *c_ptr, int32_t *c_idx, long cap) {
    uint32_t *allow = (uint32_t *)calloc((size_t)n_cols, sizeof(uint32_t));
    if (!allow) return -2;
    long out = 0;
    c_ptr[0] = 0;
    for (long i = 0; i < n_rows; i++) {
        const uint32_t tag = 2u * (uint32_t)i + 1u;
        const long row_start = out;
        for (uint32_t p = f_ptr[i]; p < f_ptr[i + 1]; p++)
            allow[f_idx[p]] = tag;
        for (uint32_t p = a_ptr[i]; p < a_ptr[i + 1]; p++) {
            const int32_t j = a_idx[p];
            const uint32_t q1 = b_ptr[j + 1];
            for (uint32_t q = b_ptr[j]; q < q1; q++) {
                const int32_t k = b_idx[q];
                if (allow[k] == tag) {
                    allow[k] = tag + 1u;
                    if (out >= cap) { free(allow); return -1; }
                    c_idx[out++] = k;
                }
            }
        }
        sort_row_i32(c_idx + row_start, out - row_start);
        c_ptr[i + 1] = (uint32_t)out;
    }
    free(allow);
    return out;
}

/* Counting variant: multiplicities of the 0/1 integer product.  `slot[k]`
 * remembers where col k was emitted for the current row (valid only while
 * stamp[k] == tag), so duplicates bump the count in place; counts are
 * permuted alongside the column sort. */
long spgemm_counts_host(const uint32_t *a_ptr, const int32_t *a_idx,
                        long n_rows, long n_cols,
                        const uint32_t *b_ptr, const int32_t *b_idx,
                        uint32_t *c_ptr, int32_t *c_idx, int64_t *c_cnt,
                        long cap) {
    uint32_t *stamp = (uint32_t *)calloc((size_t)n_cols, sizeof(uint32_t));
    int64_t *slot = (int64_t *)malloc((size_t)n_cols * sizeof(int64_t));
    int64_t *cnt_tmp = NULL;
    long tmp_cap = 0;
    if (!stamp || !slot) { free(stamp); free(slot); return -2; }
    long out = 0;
    c_ptr[0] = 0;
    for (long i = 0; i < n_rows; i++) {
        const uint32_t tag = (uint32_t)i + 1u;
        const long row_start = out;
        for (uint32_t p = a_ptr[i]; p < a_ptr[i + 1]; p++) {
            const int32_t j = a_idx[p];
            const uint32_t q1 = b_ptr[j + 1];
            for (uint32_t q = b_ptr[j]; q < q1; q++) {
                const int32_t k = b_idx[q];
                if (stamp[k] != tag) {
                    stamp[k] = tag;
                    if (out >= cap) { free(stamp); free(slot); free(cnt_tmp); return -1; }
                    slot[k] = out;
                    c_idx[out] = k;
                    c_cnt[out++] = 1;
                } else {
                    c_cnt[slot[k]]++;
                }
            }
        }
        const long w = out - row_start;
        if (w > 1) {
            /* sort the columns, then move each count to its column's sorted
             * position via the (still-valid) slot[] emission index */
            if (w > tmp_cap) {
                free(cnt_tmp);
                tmp_cap = w * 2;
                cnt_tmp = (int64_t *)malloc((size_t)tmp_cap * sizeof(int64_t));
                if (!cnt_tmp) { free(stamp); free(slot); return -2; }
            }
            for (long s = 0; s < w; s++) cnt_tmp[s] = c_cnt[row_start + s];
            sort_row_i32(c_idx + row_start, w);
            for (long s = 0; s < w; s++) {
                const int32_t col = c_idx[row_start + s];
                c_cnt[row_start + s] = cnt_tmp[slot[col] - row_start];
            }
        }
        c_ptr[i + 1] = (uint32_t)out;
    }
    free(stamp); free(slot); free(cnt_tmp);
    return out;
}
