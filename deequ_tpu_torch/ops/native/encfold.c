/* Run-fold kernels: fold semigroup state over encoded streams.
 *
 * pq_decode_chunk_runs (parquet_read.c) turns a dictionary-coded
 * column chunk into coalesced (run_length, dict_code) value runs plus
 * (run_length, present) definition-level runs. The kernels here reduce
 * those streams without ever expanding to row width:
 *
 *   encfold_code_counts  (run, code) stream -> per-code occurrence
 *                        counts, i.e. the multiset of the chunk slice
 *                        as a weighted bincount over dictionary codes.
 *                        One code->value rollup at the end of the batch
 *                        (Python side, through the dictionary) then
 *                        feeds the exact counts-family derivation the
 *                        row path's counts fast path uses — which is
 *                        what keeps moments/min-max/Frequency/HLL/KLL
 *                        bit-identical by construction.
 *   encfold_def_nulls    (run, present) stream -> null count, with the
 *                        same fail-closed validation.
 *
 * Both kernels validate every run (positive length, in-range code,
 * boolean def value) and return -1 on the first violation so a corrupt
 * run stream can never fold into wrong values — the caller falls back
 * to the row-width path for the column.
 */

#include <stdint.h>

/* Weighted bincount over dictionary codes. out_counts must hold
 * dict_count zero-initialised slots. Returns the total value count
 * (sum of run lengths) or -1 if any run is corrupt (len <= 0 or code
 * out of dictionary range). */
int64_t encfold_code_counts(const int64_t *run_len, const uint32_t *run_code,
                            int64_t n_runs, int64_t dict_count,
                            int64_t *out_counts) {
    if (n_runs < 0 || dict_count < 0 || (n_runs > 0 && (!run_len || !run_code)))
        return -1;
    if (n_runs > 0 && !out_counts) return -1;
    int64_t total = 0;
    for (int64_t i = 0; i < n_runs; i++) {
        int64_t len = run_len[i];
        uint32_t code = run_code[i];
        if (len <= 0 || (int64_t)code >= dict_count) return -1;
        out_counts[code] += len;
        total += len;
    }
    return total;
}

/* Fold definition-level runs into a null count: rows with def_val 0 are
 * null, 1 present — no materialized validity mask. Returns the null
 * count, or -1 if any run is corrupt (len <= 0, non-boolean def value,
 * or the total row count disagrees with expect_rows). */
int64_t encfold_def_nulls(const int64_t *def_len, const uint8_t *def_val,
                          int64_t n_defs, int64_t expect_rows) {
    if (n_defs < 0 || (n_defs > 0 && (!def_len || !def_val))) return -1;
    int64_t nulls = 0;
    int64_t rows = 0;
    for (int64_t i = 0; i < n_defs; i++) {
        int64_t len = def_len[i];
        uint8_t v = def_val[i];
        if (len <= 0 || v > 1) return -1;
        if (!v) nulls += len;
        rows += len;
    }
    if (expect_rows >= 0 && rows != expect_rows) return -1;
    return nulls;
}
