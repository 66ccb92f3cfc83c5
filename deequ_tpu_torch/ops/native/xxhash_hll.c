/* Native host kernels for the scan hot path.
 *
 * The placement engine folds discrete analyzers on the host when the
 * device link is slow (ops/runtime.py:placement_mode); the one host stage
 * that is not a single vectorized numpy reduction is HLL hashing: xxhash64
 * per row plus register index/rank extraction. numpy needs ~15 passes over
 * the buffer for that; this C loop does it in one pass at memory speed.
 *
 * Same semantics as the vectorized numpy path (ops/sketches/hll.py):
 * xxhash64 of the 8-byte value with seed 42, idx = top P bits, rank =
 * 1 + leading zeros of the remainder (capped for a 6-bit register) —
 * the same parameters as the reference kernel
 * (reference: catalyst/StatefulHyperloglogPlus.scala:86-155, p=9 from
 * RELATIVE_SD=0.05, 512 registers).
 */

#include <math.h>
#include <stdint.h>
#include <stddef.h>

#define P 9
#define SEED 42ULL

static const uint64_t PRIME1 = 0x9E3779B185EBCA87ULL;
static const uint64_t PRIME2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t PRIME3 = 0x165667B19E3779F9ULL;
static const uint64_t PRIME4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t PRIME5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

static inline uint64_t xxhash64_u64(uint64_t v) {
    uint64_t acc = v * PRIME2;
    acc = rotl64(acc, 31);
    acc *= PRIME1;
    acc ^= SEED + PRIME5 + 8ULL;
    acc = rotl64(acc, 27);
    acc *= PRIME1;
    acc += PRIME4;
    acc ^= acc >> 33;
    acc *= PRIME2;
    acc ^= acc >> 29;
    acc *= PRIME3;
    acc ^= acc >> 32;
    return acc;
}

/* packed[i] = (register_idx << 6) | rank for valid rows, 0 otherwise.
 * values: canonical 8-byte representation per row (int64 buffer). */
void xxhash64_pack(const int64_t *values, const uint8_t *valid, int64_t n,
                   int32_t *packed) {
    const int max_rank = 64 - P + 1;
    for (int64_t i = 0; i < n; i++) {
        if (!valid[i]) {
            packed[i] = 0;
            continue;
        }
        uint64_t h = xxhash64_u64((uint64_t)values[i]);
        int32_t idx = (int32_t)(h >> (64 - P));
        uint64_t rest = (h << P) | (1ULL << (P - 1));
        int rank = 1 + __builtin_clzll(rest);
        if (rank > max_rank) rank = max_rank;
        packed[i] = (idx << 6) | rank;
    }
}

/* register scatter-max over packed codes (the host fold of the HLL
 * reduce): regs must hold 1 << P int32 slots. where==NULL means all rows. */
void hll_update_registers(const int32_t *packed, const uint8_t *where,
                          int64_t n, int32_t *regs) {
    for (int64_t i = 0; i < n; i++) {
        if (where && !where[i]) continue;
        int32_t code = packed[i];
        int32_t idx = code >> 6;
        int32_t rank = code & 0x3F;
        if (rank > regs[idx]) regs[idx] = rank;
    }
}

/* Dense-code bincount: out[codes[i] + base]++ for in-range codes, one
 * pass with no shifted-copy temporary (numpy's bincount(codes + 1)
 * allocates an n-row temp and re-casts). The host fold of the group-by
 * count the reference runs as groupBy().agg(count)
 * (reference: GroupingAnalyzers.scala:67-72). where==NULL means all
 * rows; out must hold nbins slots (caller-zeroed). */
void bincount_i64(const int64_t *codes, const uint8_t *where, int64_t n,
                  int64_t base, int64_t nbins, int64_t *out) {
    for (int64_t i = 0; i < n; i++) {
        if (where && !where[i]) continue;
        int64_t c = codes[i] + base;
        if (c >= 0 && c < nbins) out[c]++;
    }
}

/* Same for int32 codes (arrow dictionary indices stay int32 end-to-end:
 * upcasting 4M codes to int64 per batch costs a copy plus 2x bincount
 * read traffic). */
void bincount_i32(const int32_t *codes, const uint8_t *where, int64_t n,
                  int64_t base, int64_t nbins, int64_t *out) {
    for (int64_t i = 0; i < n; i++) {
        if (where && !where[i]) continue;
        int64_t c = (int64_t)codes[i] + base;
        if (c >= 0 && c < nbins) out[c]++;
    }
}

/* Same for narrow codes (type-class codes, int8 wire formats). */
void bincount_i8(const int8_t *codes, const uint8_t *where, int64_t n,
                 int64_t base, int64_t nbins, int64_t *out) {
    for (int64_t i = 0; i < n; i++) {
        if (where && !where[i]) continue;
        int64_t c = (int64_t)codes[i] + base;
        if (c >= 0 && c < nbins) out[c]++;
    }
}

/* Windowed dense value counting for integer columns: counts[v - lo]++
 * for rows passing the masks whose value lies in [lo, lo + nbins).
 * Returns via meta: [0] = count of valid&where rows in-window,
 * [1] = count of where rows (n when where == NULL), [2] = 1 when any
 * valid&where value fell OUTSIDE the window (the pass aborts
 * immediately: the caller falls back to the select kernel, so a
 * speculative window on a wide-range column costs only the prefix it
 * scanned). One such pass replaces a whole family-kernel radix select
 * for low-range integer columns (the counts table answers moments,
 * decimated quantile sample, HLL registers and value histogram in
 * O(nbins) — see ops/fused.py counts fast path). */
void bincount_window_i64(const int64_t *v, const uint8_t *valid,
                         const uint8_t *where, int64_t n, int64_t lo,
                         int64_t nbins, int64_t *counts, int64_t *meta) {
    int64_t count = 0, n_where = 0;
    meta[0] = 0;
    meta[1] = where ? 0 : n;
    meta[2] = 0;
    for (int64_t i = 0; i < n; i++) {
        if (where) {
            if (!where[i]) continue;
            n_where++;
        }
        if (valid && !valid[i]) continue;
        /* unsigned subtraction: defined wraparound even at int64 extremes */
        uint64_t idx = (uint64_t)v[i] - (uint64_t)lo;
        if (idx >= (uint64_t)nbins) {
            meta[2] = 1;
            return;
        }
        counts[idx]++;
        count++;
    }
    meta[0] = count;
    if (where) meta[1] = n_where;
}

/* Open-addressing distinct-value counter over raw 8-byte keys (float64
 * bit patterns or int64 values — the same canonical identity HLL
 * hashes). counts[slot]==0 marks an empty slot, so keys[] needs no
 * sentinel and ANY bit pattern (including +0.0 == all-zero bits) is a
 * valid key. Returns the number of distinct keys, or -1 the moment the
 * table would exceed max_distinct — a high-cardinality column aborts
 * after seeing ~max_distinct distinct values (typically a small prefix
 * of the data), so speculatively probing every column is cheap. The
 * caller allocates keys[1<<cap2_log] / counts[1<<cap2_log] zeroed;
 * choose 1<<cap2_log >= 2*max_distinct so the load factor stays <= 0.5.
 * A skew guard bounds the worst case (a column whose distinct count
 * sits just above the cap with the tail appearing late, e.g. Zipf):
 * once probe_rows rows are scanned, a table already 3/4 full aborts —
 * heavy-tailed near-cap columns bail after a bounded prefix instead of
 * scanning almost everything before the inevitable overflow. Columns
 * rejected by the guard merely fall back to the select kernel.
 * On success the counts table answers the whole numeric family in
 * O(#distinct) (ops/counts_family.py) — this extends the windowed
 * integer fast path to LOW-CARDINALITY FLOAT columns (discount/tax/
 * rate-style data) and sparse wide-range integers. */
int64_t hashcount_u64(const uint64_t *x, const uint8_t *valid,
                      const uint8_t *where, int64_t n, int64_t cap2_log,
                      int64_t max_distinct, int64_t probe_rows,
                      uint64_t *keys, int64_t *counts, int64_t *meta) {
    uint64_t mask = ((uint64_t)1 << cap2_log) - 1;
    int64_t distinct = 0, count = 0, n_where = 0;
    int64_t guard_distinct = max_distinct - (max_distinct >> 2);
    meta[0] = 0;
    meta[1] = where ? 0 : n;
    for (int64_t i = 0; i < n; i++) {
        if (probe_rows > 0 && i == probe_rows && distinct >= guard_distinct)
            return -1;
        if (where) {
            if (!where[i]) continue;
            n_where++;
        }
        if (valid && !valid[i]) continue;
        uint64_t k = x[i];
        uint64_t h = xxhash64_u64(k) & mask;
        for (;;) {
            if (counts[h] == 0) {
                if (distinct >= max_distinct) return -1;
                distinct++;
                keys[h] = k;
                counts[h] = 1;
                break;
            }
            if (keys[h] == k) {
                counts[h]++;
                break;
            }
            h = (h + 1) & mask;
        }
        count++;
    }
    meta[0] = count;
    if (where) meta[1] = n_where;
    return distinct;
}

/* Fused masked numeric moments: one data traversal feeds Mean, Sum,
 * Minimum, Maximum, StandardDeviation and the count of a whole
 * (column, where) family — the reductions the reference pushes into one
 * Catalyst pass (reference: runners/AnalysisRunner.scala:279-326) need
 * ~15 separate numpy passes host-side; this does two cache-friendly
 * passes (sum/min/max, then centered m2 at the batch mean — the same
 * centering the device kernel uses, StatefulStdDevPop semantics).
 *
 * valid/where may each be NULL (= all rows). Long-double accumulators
 * keep sequential summation within 1e-15 of numpy's pairwise sums.
 * out[6]: count, sum, min (+inf when empty), max (-inf), m2, n_where. */
void masked_moments(const double *x, const uint8_t *valid,
                    const uint8_t *where, int64_t n, double *out) {
    long double sum = 0.0L;
    int64_t count = 0, n_where = 0;
    double mn = (double)INFINITY, mx = -(double)INFINITY;
    for (int64_t i = 0; i < n; i++) {
        if (where && !where[i]) continue;
        n_where++;
        if (valid && !valid[i]) continue;
        double v = x[i];
        sum += v;
        count++;
        if (v < mn) mn = v;
        if (v > mx) mx = v;
    }
    double avg = count > 0 ? (double)(sum / count) : 0.0;
    long double m2 = 0.0L;
    if (count > 0) {
        for (int64_t i = 0; i < n; i++) {
            if (valid && !valid[i]) continue;
            if (where && !where[i]) continue;
            double d = x[i] - avg;
            m2 += d * d;
        }
    }
    out[0] = (double)count;
    out[1] = (double)sum;
    out[2] = mn;
    out[3] = mx;
    out[4] = (double)m2;
    out[5] = where ? (double)n_where : (double)n;
}

/* ---------------------------------------------------------------------
 * Masked select-decimate: the per-batch heavy step of the quantile
 * sketch (analyzers/sketch.py device_batch). Computes EXACTLY
 *
 *     xm = sorted(x[valid & where]); xm[stride/2 :: stride][:cap]
 *     with stride = 2^level, level = ceil(log2(n_valid / cap))
 *
 * i.e. `cap` evenly spaced order statistics — WITHOUT sorting the whole
 * batch. The role this plays is the reference's per-partition quantile
 * digest update (reference: catalyst/StatefulApproxQuantile.scala:28).
 *
 * Method: map doubles to order-preserving uint64 keys and run an MSD
 * radix SELECT: histogram the keys on the most significant varying bits
 * (16 at the top level, 8 below), locate each wanted rank's bucket via
 * prefix sums, then gather and recurse ONLY into buckets that own a
 * wanted rank. Buckets whose min==max key are constant and resolve
 * without gathering (low-cardinality columns stay O(n)); segments
 * below 48 keys use insertion sort. IEEE exponent clustering (the case
 * that defeats single-level top-bit bucketing) just recurses one level
 * deeper into the mantissa bits.
 *
 * All large buffers come from a THREAD-LOCAL grow-only arena: repeated
 * calls (one per column per batch) reuse warm pages instead of paying
 * ~8k page faults per fresh 32MB malloc (measured: that was half the
 * kernel's wall time). Bounded by the largest batch ever processed per
 * thread.
 *
 * Determinism: key order equals IEEE total order on doubles (with -0.0
 * before +0.0 and NaN last; equal doubles are interchangeable in the
 * decimated sample, so the result matches the numpy sort path).
 *
 * Returns 0 on success (meta = [n_valid, level, kept], samples[kept]
 * filled), 1 on allocation failure (caller falls back to numpy). */

#include <stdlib.h>
#include <string.h>

#define SD_MAX_DEPTH 16
#define SD_TOP_BUCKETS 16384

/* arena slots: 0 = keys, 1 = top-level tables, 2+d = scratch at depth d */
/* slots: 0 = keys/gather scratch, 1 = top tables, 2+d = recursion
 * scratch at depth d, 18..23 = entry-point planning tables,
 * 24..27 = multi-column batch state (masked_moments_select_multi) */
#define SD_SLOT_MC_COLS (2 + SD_MAX_DEPTH + 6)
#define SD_SLOT_MC_TOPS (SD_SLOT_MC_COLS + 1)
#define SD_SLOT_MC_SUBIDX (SD_SLOT_MC_COLS + 2)
#define SD_SLOT_MC_PLANS (SD_SLOT_MC_COLS + 3)
#define SD_SLOT_MC_SUBHIST (SD_SLOT_MC_COLS + 4)
#define SD_SLOT_MC_SUBFILL (SD_SLOT_MC_COLS + 5)
#define SD_SLOT_MC_DIRECT (SD_SLOT_MC_COLS + 6)
#define SD_ARENA_SLOTS (2 + SD_MAX_DEPTH + 6 + 7)
static __thread struct { void *p; size_t cap; } sd_arena[SD_ARENA_SLOTS];

static void *sd_get(int slot, size_t bytes) {
    if (sd_arena[slot].cap < bytes) {
        free(sd_arena[slot].p);
        size_t ncap = bytes + bytes / 2 + 64;
        sd_arena[slot].p = malloc(ncap);
        sd_arena[slot].cap = sd_arena[slot].p ? ncap : 0;
    }
    return sd_arena[slot].p;
}

static inline uint64_t f64_key(double v) {
    uint64_t u;
    memcpy(&u, &v, 8);
    return (u >> 63) ? ~u : (u | 0x8000000000000000ULL);
}

static inline double key_f64(uint64_t k) {
    uint64_t u = (k >> 63) ? (k & 0x7FFFFFFFFFFFFFFFULL) : ~k;
    double v;
    memcpy(&v, &u, 8);
    return v;
}

static void ins_sort_u64(uint64_t *a, int64_t n) {
    for (int64_t i = 1; i < n; i++) {
        uint64_t v = a[i];
        int64_t j = i - 1;
        while (j >= 0 && a[j] > v) {
            a[j + 1] = a[j];
            j--;
        }
        a[j + 1] = v;
    }
}

/* Resolve wanted ranks r_j = roff + j*step (j in [j0, j1), all with
 * 0 <= r_j < m) against the UNSORTED keys[0..m) whose min/max are
 * kmin/kmax. Writes samples[j]. May permute keys. */
static int resolve_segment(uint64_t *keys, int64_t m, uint64_t kmin,
                           uint64_t kmax, int64_t roff, int64_t step,
                           int64_t j0, int64_t j1, double *samples,
                           int depth) {
    if (j0 >= j1) return 0;
    if (kmin == kmax) {
        double v = key_f64(kmin);
        for (int64_t j = j0; j < j1; j++) samples[j] = v;
        return 0;
    }
    if (m <= 48 || depth + 1 >= SD_MAX_DEPTH) {
        ins_sort_u64(keys, m);
        for (int64_t j = j0; j < j1; j++)
            samples[j] = key_f64(keys[roff + j * step]);
        return 0;
    }

    int width = depth == 0 ? 16 : 8;
    int hb = 63 - __builtin_clzll(kmin ^ kmax);
    int shift = hb + 1 - width;
    if (shift < 0) shift = 0;
    uint64_t base = kmin >> shift;
    int64_t nbuckets = (int64_t)((kmax >> shift) - base) + 1;

    /* tables: stack at depth >= 1 (<= 256 buckets), arena at the top */
    uint32_t hist_stack[256];
    uint64_t bmin_stack[256], bmax_stack[256];
    int64_t cstart_stack[256], cfill_stack[256];
    uint32_t *hist;
    uint64_t *bmin, *bmax;
    int64_t *cstart, *cfill;
    if (nbuckets <= 256) {
        hist = hist_stack;
        bmin = bmin_stack;
        bmax = bmax_stack;
        cstart = cstart_stack;
        cfill = cfill_stack;
    } else {
        char *tables = (char *)sd_get(
            1, (size_t)nbuckets * (4 + 8 + 8 + 8 + 8));
        if (!tables) return 1;
        hist = (uint32_t *)tables;
        bmin = (uint64_t *)(tables + (size_t)nbuckets * 4);
        bmax = bmin + nbuckets;
        cstart = (int64_t *)(bmax + nbuckets);
        cfill = cstart + nbuckets;
    }
    memset(hist, 0, (size_t)nbuckets * 4);
    memset(bmin, 0xFF, (size_t)nbuckets * 8);
    memset(bmax, 0x00, (size_t)nbuckets * 8);

    for (int64_t i = 0; i < m; i++) {
        uint64_t k = keys[i];
        int64_t b = (int64_t)((k >> shift) - base);
        hist[b]++;
        if (k < bmin[b]) bmin[b] = k;
        if (k > bmax[b]) bmax[b] = k;
    }

    /* walk buckets in key order; resolve constant ones, mark the rest */
    int64_t collect_total = 0;
    {
        int64_t rank0 = 0;
        for (int64_t b = 0; b < nbuckets; b++) {
            int64_t c = (int64_t)hist[b];
            cstart[b] = -1;
            if (c > 0) {
                int64_t jlo =
                    (roff + j0 * step < rank0)
                        ? j0 + (rank0 - roff - j0 * step + step - 1) / step
                        : j0;
                if (jlo < j1 && roff + jlo * step < rank0 + c) {
                    if (bmin[b] == bmax[b]) {
                        double v = key_f64(bmin[b]);
                        for (int64_t j = jlo;
                             j < j1 && roff + j * step < rank0 + c; j++)
                            samples[j] = v;
                    } else {
                        cstart[b] = collect_total;
                        collect_total += c;
                    }
                }
                rank0 += c;
            }
        }
    }

    int rc = 0;
    if (collect_total > 0) {
        uint64_t *scratch =
            (uint64_t *)sd_get(2 + depth, (size_t)collect_total * 8);
        if (!scratch) return 1;
        memcpy(cfill, cstart, (size_t)nbuckets * 8);
        for (int64_t i = 0; i < m; i++) {
            uint64_t k = keys[i];
            int64_t b = (int64_t)((k >> shift) - base);
            if (cstart[b] >= 0) scratch[cfill[b]++] = k;
        }
        int64_t rank0 = 0;
        for (int64_t b = 0; b < nbuckets && rc == 0; b++) {
            int64_t c = (int64_t)hist[b];
            if (c > 0) {
                if (cstart[b] >= 0) {
                    int64_t jlo =
                        (roff + j0 * step < rank0)
                            ? j0 + (rank0 - roff - j0 * step + step - 1) / step
                            : j0;
                    int64_t jhi = jlo;
                    while (jhi < j1 && roff + jhi * step < rank0 + c) jhi++;
                    /* shift == 0 with bmin != bmax is impossible (the
                     * bucket id is then the full key), so recursion
                     * always has bits left to split on */
                    rc = resolve_segment(scratch + cstart[b], c, bmin[b],
                                         bmax[b], roff - rank0, step, jlo,
                                         jhi, samples, depth + 1);
                }
                rank0 += c;
            }
        }
    }
    return rc;
}

/* Entry point. Three direct masked passes over x (no key-buffer
 * materialization for the common case):
 *   P1: fixed 16-bit-prefix histogram + per-bucket min/max key
 *   P2: 8-bit count-only sub-histograms for buckets owning wanted ranks
 *   P3: gather only the sub-buckets owning wanted ranks
 * then resolve each gathered sub-bucket with resolve_segment (insertion
 * sort when tiny, recursion when an adversarial distribution concentrates
 * a sub-bucket). Constant buckets short-circuit at both levels. The rare
 * all-keys-share-top-16-bits case compacts keys and uses the adaptive
 * recursive path directly. */

#define SD_TOP_SHIFT 50
#define SD_SUB_BITS 8
#define SD_SUB_W (1 << SD_SUB_BITS)

static inline int sd_masked_out(const uint8_t *valid, const uint8_t *where,
                                int64_t i) {
    return (valid && !valid[i]) || (where && !where[i]);
}

/* core: select-decimate, optionally accumulating the masked-moments
 * family outputs [count, sum, min, max, m2, n_where] into mom (NULL =
 * skip) — the moments ride P1/P2's traversals instead of paying their
 * own two passes (ops/native masked_moments). hll_mode additionally
 * folds the HLL++ register update into P1 (the reference's
 * StatefulHyperloglogPlus per-row loop): 0 = off, 1 = hash the f64 bit
 * pattern of x[i] (float columns' canonical identity), 2 = hash
 * hashvals[i] (caller-supplied canonical int64 per row — int/bool
 * columns, whose identity is the integer value, not the float bits).
 * regs must hold 1 << P int32 slots (caller-zeroed). */
/* P1 bucket record: one 24-byte struct per bucket (single cache line
 * per update); 14-bit top level keeps the whole table L2-resident. */
typedef struct {
    uint64_t mn, mx;
    uint32_t cnt, pad;
} SdTop;

/* per planned bucket: its gather area offset (sizes known from P1).
 * subofs/subw serve only the multi-column kernel's adaptive sub level
 * (unused by sd_core). */
typedef struct {
    int64_t rank0, jlo, jhi, gofs, fill;
    uint64_t kmin, kmax;
    int64_t subofs;
    int32_t subw, pad;
} SdPlan;

static int sd_core(const double *x, const uint8_t *valid,
                   const uint8_t *where, int64_t n, int64_t cap,
                   double *samples, int64_t *meta, double *mom,
                   const int64_t *hashvals, int hll_mode, int32_t *regs) {
    if (cap <= 0) return 1;

    /* ---- P1: top histogram + per-bucket min/max + global min/max ---- */
    SdTop *top = (SdTop *)sd_get(1, (size_t)SD_TOP_BUCKETS * sizeof(SdTop));
    if (!top) return 1;
    for (int64_t b = 0; b < SD_TOP_BUCKETS; b++) {
        top[b].mn = ~0ULL;
        top[b].mx = 0ULL;
        top[b].cnt = 0;
    }

    int64_t m = 0, n_where = 0;
    uint64_t kmin = ~0ULL, kmax = 0ULL;
    /* block accumulation: the inner 2048-element partial runs in SSE
     * doubles (an x87 long-double add per row serializes the loop); the
     * outer fold stays long double, so total error ~ pairwise-summation
     * class, comfortably inside the 1e-12 parity tests */
    long double sum = 0.0L;
    double bsum = 0.0;
    int bn = 0;
    for (int64_t i = 0; i < n; i++) {
        if (where && !where[i]) continue;
        n_where++;
        if (valid && !valid[i]) continue;
        uint64_t k = f64_key(x[i]);
        SdTop *t = &top[k >> SD_TOP_SHIFT];
        m++;
        t->cnt++;
        if (k < t->mn) t->mn = k;
        if (k > t->mx) t->mx = k;
        if (k < kmin) kmin = k;
        if (k > kmax) kmax = k;
        if (mom) {
            bsum += x[i];
            if (++bn == 2048) {
                sum += bsum;
                bsum = 0.0;
                bn = 0;
            }
        }
        if (hll_mode) {
            uint64_t canon;
            if (hll_mode == 1) {
                memcpy(&canon, &x[i], 8);
            } else {
                canon = (uint64_t)hashvals[i];
            }
            uint64_t h = xxhash64_u64(canon);
            int32_t idx = (int32_t)(h >> (64 - P));
            uint64_t rest = (h << P) | (1ULL << (P - 1));
            int rank = 1 + __builtin_clzll(rest);
            if (rank > 64 - P + 1) rank = 64 - P + 1;
            if (rank > regs[idx]) regs[idx] = rank;
        }
    }
    if (mom) {
        sum += bsum;
        mom[0] = (double)m;
        mom[1] = (double)sum;
        mom[2] = m > 0 ? key_f64(kmin) : (double)INFINITY;
        mom[3] = m > 0 ? key_f64(kmax) : -(double)INFINITY;
        mom[4] = 0.0; /* m2 filled below */
        mom[5] = where ? (double)n_where : (double)n;
    }
    meta[0] = m;
    meta[1] = 0;
    meta[2] = 0;
    if (m == 0) return 0;

    int level = 0;
    while (((int64_t)cap << level) < m) level++;
    int64_t stride = 1LL << level;
    int64_t offset = stride / 2;
    int64_t kept = (m - offset + stride - 1) / stride;
    if (kept < 0) kept = 0;
    meta[1] = level;
    meta[2] = kept;
    if (kept == 0) return 0;

    if (kmin == kmax) {
        double v = key_f64(kmin);
        for (int64_t j = 0; j < kept; j++) samples[j] = v;
        return 0;
    }
    if ((kmin >> SD_TOP_SHIFT) == (kmax >> SD_TOP_SHIFT)) {
        /* all keys share the top 16 bits: compact and go adaptive */
        uint64_t *keys = (uint64_t *)sd_get(0, (size_t)m * 8);
        if (!keys) return 1;
        int64_t w = 0;
        for (int64_t i = 0; i < n; i++) {
            if (sd_masked_out(valid, where, i)) continue;
            keys[w++] = f64_key(x[i]);
        }
        if (mom) {
            long double m2 = 0.0L;
            double avg = mom[1] / (double)m;
            for (int64_t i = 0; i < m; i++) {
                double d = key_f64(keys[i]) - avg;
                m2 += d * d;
            }
            mom[4] = (double)m2;
        }
        return resolve_segment(keys, m, kmin, kmax, offset, stride, 0, kept,
                               samples, 0);
    }

    /* ---- walk top buckets: resolve constant ones, plan the rest ----- */
    int32_t *subidx = (int32_t *)sd_get(18, (size_t)SD_TOP_BUCKETS * 4);
    if (!subidx) return 1;
    memset(subidx, 0xFF, (size_t)SD_TOP_BUCKETS * 4);
    int32_t nplanned = 0;
    SdPlan *plans = (SdPlan *)sd_get(19, (size_t)kept * sizeof(SdPlan));
    if (!plans) return 1;
    int64_t gather_total = 0;
    {
        int64_t rank0 = 0;
        for (int64_t b = 0; b < SD_TOP_BUCKETS; b++) {
            int64_t c = (int64_t)top[b].cnt;
            if (c == 0) continue;
            int64_t jlo = (offset < rank0)
                              ? (rank0 - offset + stride - 1) / stride
                              : 0;
            if (jlo < kept && offset + jlo * stride < rank0 + c) {
                if (top[b].mn == top[b].mx) {
                    double v = key_f64(top[b].mn);
                    for (int64_t j = jlo;
                         j < kept && offset + j * stride < rank0 + c; j++)
                        samples[j] = v;
                } else {
                    int64_t jhi = jlo;
                    while (jhi < kept && offset + jhi * stride < rank0 + c)
                        jhi++;
                    SdPlan *p = &plans[nplanned];
                    p->rank0 = rank0;
                    p->jlo = jlo;
                    p->jhi = jhi;
                    p->gofs = gather_total;
                    p->fill = gather_total;
                    p->kmin = top[b].mn;
                    p->kmax = top[b].mx;
                    gather_total += c;
                    subidx[b] = nplanned++;
                }
            }
            rank0 += c;
        }
    }

    long double m2acc = 0.0L;
    double bm2 = 0.0;
    int bm2n = 0;
    double avg = mom && m > 0 ? mom[1] / (double)m : 0.0;
    if (nplanned == 0) {
        /* every wanted bucket was constant; m2 still needs a pass */
        if (mom && m > 0) {
            for (int64_t i = 0; i < n; i++) {
                if (sd_masked_out(valid, where, i)) continue;
                double d = x[i] - avg;
                bm2 += d * d;
                if (++bm2n == 2048) {
                    m2acc += bm2;
                    bm2 = 0.0;
                    bm2n = 0;
                }
            }
            m2acc += bm2;
            mom[4] = (double)m2acc;
        }
        return 0;
    }

    /* ---- P2: gather planned buckets' keys whole (sizes known from
     * P1), m2 riding the same pass; each plan's contiguous segment is
     * then resolved by the recursive radix select, whose histograms run
     * over the (cache-friendly) gathered data instead of a third full
     * scan of x ------------------------------------------------------ */
    uint64_t *scratch = (uint64_t *)sd_get(0, (size_t)gather_total * 8);
    if (!scratch) return 1;
    for (int64_t i = 0; i < n; i++) {
        if (sd_masked_out(valid, where, i)) continue;
        uint64_t k = f64_key(x[i]);
        int32_t si = subidx[k >> SD_TOP_SHIFT];
        if (si >= 0) scratch[plans[si].fill++] = k;
        if (mom) {
            double d = x[i] - avg;
            bm2 += d * d;
            if (++bm2n == 2048) {
                m2acc += bm2;
                bm2 = 0.0;
                bm2n = 0;
            }
        }
    }
    if (mom) {
        m2acc += bm2;
        mom[4] = (double)m2acc;
    }

    /* ---- resolve each plan's gathered segment ----------------------- */
    for (int32_t s = 0; s < nplanned; s++) {
        SdPlan *sg = &plans[s];
        int rc = resolve_segment(scratch + sg->gofs, sg->fill - sg->gofs,
                                 sg->kmin, sg->kmax, offset - sg->rank0,
                                 stride, sg->jlo, sg->jhi, samples, 1);
        if (rc) return rc;
    }
    return 0;
}

int masked_select_decimate(const double *x, const uint8_t *valid,
                           const uint8_t *where, int64_t n, int64_t cap,
                           double *samples, int64_t *meta) {
    return sd_core(x, valid, where, n, cap, samples, meta, NULL, NULL, 0,
                   NULL);
}

/* Combined family kernel: moments + decimated quantile sample in the
 * same traversals. mom = [count, sum, min, max, m2, n_where] (the
 * masked_moments contract); samples/meta as masked_select_decimate. */
int masked_moments_select(const double *x, const uint8_t *valid,
                          const uint8_t *where, int64_t n, int64_t cap,
                          double *samples, int64_t *meta, double *mom,
                          const int64_t *hashvals, int hll_mode,
                          int32_t *regs) {
    return sd_core(x, valid, where, n, cap, samples, meta, mom, hashvals,
                   hll_mode, regs);
}

/* =====================================================================
 * Multi-column batched family kernel.
 *
 * One row-blocked traversal computes the full fused-moment family
 * (count/sum/min/max/m2/n_where), the decimated quantile sample, and
 * optional HLL registers for K columns at once: a block of rows is
 * processed across all K columns before advancing, so the shared where
 * mask and loop machinery are paid once per block instead of once per
 * column-pass, and per-column call overhead disappears.
 *
 * Bit-exactness contract: every accumulation below replicates sd_core's
 * order exactly — the 2048-valid-row f64 partial folded into a long
 * double (block boundaries counted in *valid rows per column*, which is
 * invariant to how rows are blocked), per-row masking order (where
 * before n_where before valid), the compact-prefix path's unblocked
 * long-double m2 over compacted keys, and resolve_segment on gathered
 * segments. The parity tests assert the outputs are bit-identical to K
 * independent masked_moments_select calls.
 * ================================================================== */

#define SD_MC_BLOCK 4096 /* rows per tile; multiple of the 2048 fold */
#define SD_MC_TABLE_BUDGET (1 << 19) /* per-chunk sub-table cap, bytes */
/* Planned buckets at or under this count skip the count-then-gather
 * machinery entirely: their keys are gathered wholesale DURING the P2
 * m2 pass (sd_core's per-bucket strategy) and resolved straight from
 * the gathered segment, so a column whose every planned bucket is
 * small — the common case for spread-out keys, where a bucket holds
 * n/16384-ish rows — never pays the third full-row scan (P3). Only a
 * pathologically skewed bucket above the threshold keeps the
 * sub-histogram + selective-gather route, where counting first prunes
 * the gathered volume by roughly the stride factor. */
#define SD_MC_DIRECT_MAX 4096

typedef struct {
    const double *x;
    const uint8_t *valid;    /* NULL = all rows valid */
    const int64_t *hashvals; /* hll_mode 2 canonical values */
    int32_t *regs;
    SdTop *top;
    int hll_mode;
    int done; /* column fully resolved; no P2 work left */
    int64_t m, n_where;
    uint64_t kmin, kmax;
    long double sum; /* outer fold */
    double bsum;     /* 2048-row inner partial (sd_core order) */
    int bn;
    double avg;
    long double m2acc;
    double bm2;
    int bm2n;
    int32_t *subidx;
    SdPlan *plans;
    int32_t nplanned;
    int32_t *subhist;  /* per-plan adaptive-width sub counters */
    int64_t *subfill;  /* parallel gather cursors, -1 = skip */
    uint64_t *scratch; /* chunk-shared gather area (subfill indexes it) */
    uint64_t *direct;  /* chunk-shared direct-gather area (P2-filled) */
    int64_t gather_total;
    int64_t direct_total; /* keys across this column's direct plans */
    int64_t ndirect;      /* direct (subw == 0) plan count */
    int64_t subentries; /* sum of 1 << subw over this column's plans
                         * (a direct plan contributes its 1 cursor) */
    int64_t offset, stride, kept;
} SdMCol;

/* sub-bucket of key k within plan p: the next subw bits below the
 * top-bucket prefix */
static inline int64_t sd_mc_sub(uint64_t k, const SdPlan *p) {
    return (int64_t)((k >> (SD_TOP_SHIFT - p->subw)) &
                     ((1ULL << p->subw) - 1));
}

/* P1 over rows [i0, i1): exact clone of sd_core's P1 body, minus the
 * per-row global kmin/kmax update — the global extrema are recovered
 * exactly from the per-bucket mn/mx at finalize (the bucket minima ARE
 * the keys, so min-over-buckets == min-over-rows bit for bit). */
static void mc_p1_block(SdMCol *s, const uint8_t *where, int64_t i0,
                        int64_t i1) {
    const double *x = s->x;
    const uint8_t *valid = s->valid;
    SdTop *top = s->top;
    for (int64_t i = i0; i < i1; i++) {
        if (where && !where[i]) continue;
        s->n_where++;
        if (valid && !valid[i]) continue;
        uint64_t k = f64_key(x[i]);
        SdTop *t = &top[k >> SD_TOP_SHIFT];
        s->m++;
        t->cnt++;
        if (k < t->mn) t->mn = k;
        if (k > t->mx) t->mx = k;
        s->bsum += x[i];
        if (++s->bn == 2048) {
            s->sum += s->bsum;
            s->bsum = 0.0;
            s->bn = 0;
        }
        if (s->hll_mode) {
            uint64_t canon;
            if (s->hll_mode == 1) {
                memcpy(&canon, &x[i], 8);
            } else {
                canon = (uint64_t)s->hashvals[i];
            }
            uint64_t h = xxhash64_u64(canon);
            int32_t idx = (int32_t)(h >> (64 - P));
            uint64_t rest = (h << P) | (1ULL << (P - 1));
            int rank = 1 + __builtin_clzll(rest);
            if (rank > 64 - P + 1) rank = 64 - P + 1;
            if (rank > s->regs[idx]) s->regs[idx] = rank;
        }
    }
}

/* P1 fast path: no masks, no HLL, branchless key transform. */
static void mc_p1_block_fast(SdMCol *s, int64_t i0, int64_t i1) {
    const double *x = s->x;
    SdTop *top = s->top;
    double bsum = s->bsum;
    int bn = s->bn;
    for (int64_t i = i0; i < i1; i++) {
        double v = x[i];
        uint64_t u;
        memcpy(&u, &v, 8);
        uint64_t k = u ^ ((uint64_t)((int64_t)u >> 63) | 0x8000000000000000ULL);
        SdTop *t = &top[k >> SD_TOP_SHIFT];
        t->cnt++;
        if (k < t->mn) t->mn = k;
        if (k > t->mx) t->mx = k;
        bsum += v;
        if (++bn == 2048) {
            s->sum += bsum;
            bsum = 0.0;
            bn = 0;
        }
    }
    s->m += i1 - i0;
    s->bsum = bsum;
    s->bn = bn;
}

/* P1 fast path, four columns per row iteration. Each column keeps its
 * own sequential bsum chain (bit-identical per-column order), but the
 * four independent FP-add chains overlap in the pipeline — on this
 * latency-bound loop that is where the multi-column win comes from.
 * All four columns are all-valid, so their 2048-row fold counters are
 * always equal and one shared bn drives all four folds. */
static void mc_p1_block_fast4(SdMCol *s0, SdMCol *s1, SdMCol *s2, SdMCol *s3,
                              int64_t i0, int64_t i1) {
    const double *x0 = s0->x, *x1 = s1->x, *x2 = s2->x, *x3 = s3->x;
    SdTop *t0 = s0->top, *t1 = s1->top, *t2 = s2->top, *t3 = s3->top;
    double b0 = s0->bsum, b1 = s1->bsum, b2 = s2->bsum, b3 = s3->bsum;
    int bn = s0->bn;
    for (int64_t i = i0; i < i1; i++) {
#define MC_P1_ONE(xv, tt, bs)                                                \
    do {                                                                     \
        double v = (xv)[i];                                                  \
        uint64_t u;                                                          \
        memcpy(&u, &v, 8);                                                   \
        uint64_t k =                                                         \
            u ^ ((uint64_t)((int64_t)u >> 63) | 0x8000000000000000ULL);      \
        SdTop *t = &(tt)[k >> SD_TOP_SHIFT];                                 \
        t->cnt++;                                                            \
        if (k < t->mn) t->mn = k;                                            \
        if (k > t->mx) t->mx = k;                                            \
        (bs) += v;                                                           \
    } while (0)
        MC_P1_ONE(x0, t0, b0);
        MC_P1_ONE(x1, t1, b1);
        MC_P1_ONE(x2, t2, b2);
        MC_P1_ONE(x3, t3, b3);
#undef MC_P1_ONE
        if (++bn == 2048) {
            s0->sum += b0;
            s1->sum += b1;
            s2->sum += b2;
            s3->sum += b3;
            b0 = b1 = b2 = b3 = 0.0;
            bn = 0;
        }
    }
    int64_t cnt = i1 - i0;
    s0->m += cnt;
    s1->m += cnt;
    s2->m += cnt;
    s3->m += cnt;
    s0->bsum = b0;
    s1->bsum = b1;
    s2->bsum = b2;
    s3->bsum = b3;
    s0->bn = s1->bn = s2->bn = s3->bn = bn;
}

/* After P1: fold the tail partial, publish moments/meta, and either
 * finish the column outright (empty / constant / compact-prefix — the
 * latter pays its own compaction pass, as sd_core does) or plan the
 * P2 gather. Mirrors sd_core line for line. */
static int mc_finalize_p1(SdMCol *s, const uint8_t *where, int64_t n,
                          int64_t cap, double *samples, int64_t *meta,
                          double *mom) {
    s->sum += s->bsum;
    s->bsum = 0.0;
    s->bn = 0;
    /* global extrema from the bucket extrema: exact (bucket mn/mx are
     * actual keys), and cheaper than a per-row compare pair in P1 */
    for (int64_t b = 0; b < SD_TOP_BUCKETS; b++) {
        if (!s->top[b].cnt) continue;
        if (s->top[b].mn < s->kmin) s->kmin = s->top[b].mn;
        if (s->top[b].mx > s->kmax) s->kmax = s->top[b].mx;
    }
    int64_t m = s->m;
    mom[0] = (double)m;
    mom[1] = (double)s->sum;
    mom[2] = m > 0 ? key_f64(s->kmin) : (double)INFINITY;
    mom[3] = m > 0 ? key_f64(s->kmax) : -(double)INFINITY;
    mom[4] = 0.0;
    mom[5] = where ? (double)s->n_where : (double)n;
    meta[0] = m;
    meta[1] = 0;
    meta[2] = 0;
    s->done = 1;
    if (m == 0) return 0;

    int level = 0;
    while (((int64_t)cap << level) < m) level++;
    int64_t stride = 1LL << level;
    int64_t offset = stride / 2;
    int64_t kept = (m - offset + stride - 1) / stride;
    if (kept < 0) kept = 0;
    meta[1] = level;
    meta[2] = kept;
    if (kept == 0) return 0;
    s->stride = stride;
    s->offset = offset;
    s->kept = kept;

    if (s->kmin == s->kmax) {
        double v = key_f64(s->kmin);
        for (int64_t j = 0; j < kept; j++) samples[j] = v;
        return 0;
    }
    s->avg = mom[1] / (double)m;
    if ((s->kmin >> SD_TOP_SHIFT) == (s->kmax >> SD_TOP_SHIFT)) {
        /* all keys share the top 16 bits: compact and go adaptive */
        uint64_t *keys = (uint64_t *)sd_get(0, (size_t)m * 8);
        if (!keys) return 1;
        int64_t w = 0;
        for (int64_t i = 0; i < n; i++) {
            if (sd_masked_out(s->valid, where, i)) continue;
            keys[w++] = f64_key(s->x[i]);
        }
        {
            long double m2 = 0.0L;
            double avg = s->avg;
            for (int64_t i = 0; i < m; i++) {
                double d = key_f64(keys[i]) - avg;
                m2 += d * d;
            }
            mom[4] = (double)m2;
        }
        return resolve_segment(keys, m, s->kmin, s->kmax, offset, stride, 0,
                               kept, samples, 0);
    }

    /* walk top buckets: resolve constant ones, plan the rest. Each
     * plan's sub level gets an adaptive width: enough bits that its
     * sub-buckets hold ~128 keys, so the per-column sub tables are
     * bounded by ~m/128 entries no matter how the keys distribute, and
     * sub-buckets are fine enough (vs the rank stride) for the P3
     * gather to actually prune. */
    memset(s->subidx, 0xFF, (size_t)SD_TOP_BUCKETS * 4);
    s->nplanned = 0;
    s->gather_total = 0;
    s->direct_total = 0;
    s->ndirect = 0;
    s->subentries = 0;
    {
        int64_t rank0 = 0;
        for (int64_t b = 0; b < SD_TOP_BUCKETS; b++) {
            int64_t c = (int64_t)s->top[b].cnt;
            if (c == 0) continue;
            int64_t jlo = (offset < rank0)
                              ? (rank0 - offset + stride - 1) / stride
                              : 0;
            if (jlo < kept && offset + jlo * stride < rank0 + c) {
                if (s->top[b].mn == s->top[b].mx) {
                    double v = key_f64(s->top[b].mn);
                    for (int64_t j = jlo;
                         j < kept && offset + j * stride < rank0 + c; j++)
                        samples[j] = v;
                } else {
                    int64_t jhi = jlo;
                    while (jhi < kept && offset + jhi * stride < rank0 + c)
                        jhi++;
                    SdPlan *p = &s->plans[s->nplanned];
                    p->rank0 = rank0;
                    p->jlo = jlo;
                    p->jhi = jhi;
                    p->kmin = s->top[b].mn;
                    p->kmax = s->top[b].mx;
                    if (c <= SD_MC_DIRECT_MAX) {
                        /* direct: gathered whole during P2; gofs/fill
                         * carry the column-local region offset/size */
                        p->subw = 0;
                        p->gofs = s->direct_total;
                        p->fill = c;
                        s->direct_total += c;
                        s->ndirect++;
                        p->subofs = s->subentries;
                        s->subentries += 1; /* its gather cursor slot */
                    } else {
                        int32_t w = 4;
                        while (w < 16 && (c >> w) > 64) w++;
                        p->subw = w;
                        p->subofs = s->subentries;
                        s->subentries += (int64_t)1 << w;
                    }
                    s->subidx[b] = s->nplanned++;
                }
            }
            rank0 += c;
        }
    }
    /* nplanned == 0 still needs the P2 m2 pass (sd_core's "every wanted
     * bucket was constant" branch) — the P2 block handles both shapes */
    s->done = 0;
    return 0;
}

/* P2 over rows [i0, i1): blocked m2 (sd_core's exact fold order) plus,
 * per planned bucket, EITHER a wholesale gather (direct plans, count
 * <= SD_MC_DIRECT_MAX — sd_core's strategy, resolved straight from the
 * segment with no third scan) OR adaptive-width sub-histogram counting
 * (big plans), where counting first lets P3 gather only the
 * sub-buckets that own wanted ranks, shrinking the gathered volume
 * (and the resolve work on it) by roughly the stride factor. The
 * selected sample values are exact order statistics either way. */
static void mc_p2_block(SdMCol *s, const uint8_t *where, int64_t i0,
                        int64_t i1) {
    const double *x = s->x;
    const uint8_t *valid = s->valid;
    double avg = s->avg;
    double bm2 = s->bm2;
    int bm2n = s->bm2n;
    if (s->nplanned > 0) {
        int32_t *subidx = s->subidx;
        int32_t *subhist = s->subhist;
        int64_t *subfill = s->subfill;
        uint64_t *direct = s->direct;
        const SdPlan *plans = s->plans;
        for (int64_t i = i0; i < i1; i++) {
            if (sd_masked_out(valid, where, i)) continue;
            uint64_t k = f64_key(x[i]);
            int32_t si = subidx[k >> SD_TOP_SHIFT];
            if (si >= 0) {
                const SdPlan *p = &plans[si];
                if (p->subw)
                    subhist[p->subofs + sd_mc_sub(k, p)]++;
                else
                    direct[subfill[p->subofs]++] = k;
            }
            double d = x[i] - avg;
            bm2 += d * d;
            if (++bm2n == 2048) {
                s->m2acc += bm2;
                bm2 = 0.0;
                bm2n = 0;
            }
        }
    } else {
        for (int64_t i = i0; i < i1; i++) {
            if (sd_masked_out(valid, where, i)) continue;
            double d = x[i] - avg;
            bm2 += d * d;
            if (++bm2n == 2048) {
                s->m2acc += bm2;
                bm2 = 0.0;
                bm2n = 0;
            }
        }
    }
    s->bm2 = bm2;
    s->bm2n = bm2n;
}

/* P2 fast path: no masks, branchless key transform. */
static void mc_p2_block_fast(SdMCol *s, int64_t i0, int64_t i1) {
    const double *x = s->x;
    double avg = s->avg;
    double bm2 = s->bm2;
    int bm2n = s->bm2n;
    int32_t *subidx = s->subidx;
    int32_t *subhist = s->subhist;
    int64_t *subfill = s->subfill;
    uint64_t *direct = s->direct;
    const SdPlan *plans = s->plans;
    int counting = s->nplanned > 0;
    for (int64_t i = i0; i < i1; i++) {
        double v = x[i];
        if (counting) {
            uint64_t u;
            memcpy(&u, &v, 8);
            uint64_t k =
                u ^ ((uint64_t)((int64_t)u >> 63) | 0x8000000000000000ULL);
            int32_t si = subidx[k >> SD_TOP_SHIFT];
            if (si >= 0) {
                const SdPlan *p = &plans[si];
                if (p->subw)
                    subhist[p->subofs + sd_mc_sub(k, p)]++;
                else
                    direct[subfill[p->subofs]++] = k;
            }
        }
        double d = v - avg;
        bm2 += d * d;
        if (++bm2n == 2048) {
            s->m2acc += bm2;
            bm2 = 0.0;
            bm2n = 0;
        }
    }
    s->bm2 = bm2;
    s->bm2n = bm2n;
}

/* P2 fast path, four columns per row iteration (see mc_p1_block_fast4:
 * independent bm2 chains overlap; shared fold counter is valid because
 * every column sees every row). */
static void mc_p2_block_fast4(SdMCol *s0, SdMCol *s1, SdMCol *s2, SdMCol *s3,
                              int64_t i0, int64_t i1) {
    const double *x0 = s0->x, *x1 = s1->x, *x2 = s2->x, *x3 = s3->x;
    double a0 = s0->avg, a1 = s1->avg, a2 = s2->avg, a3 = s3->avg;
    double m0 = s0->bm2, m1 = s1->bm2, m2 = s2->bm2, m3 = s3->bm2;
    int g0 = s0->nplanned > 0, g1 = s1->nplanned > 0, g2 = s2->nplanned > 0,
        g3 = s3->nplanned > 0;
    int bm2n = s0->bm2n;
    for (int64_t i = i0; i < i1; i++) {
#define MC_P2_ONE(ss, xv, av, bm, gg)                                        \
    do {                                                                     \
        double v = (xv)[i];                                                  \
        if (gg) {                                                            \
            uint64_t u;                                                      \
            memcpy(&u, &v, 8);                                               \
            uint64_t k =                                                     \
                u ^ ((uint64_t)((int64_t)u >> 63) | 0x8000000000000000ULL);  \
            int32_t si = (ss)->subidx[k >> SD_TOP_SHIFT];                    \
            if (si >= 0) {                                                   \
                const SdPlan *p = &(ss)->plans[si];                          \
                if (p->subw)                                                 \
                    (ss)->subhist[p->subofs + sd_mc_sub(k, p)]++;            \
                else                                                         \
                    (ss)->direct[(ss)->subfill[p->subofs]++] = k;            \
            }                                                                \
        }                                                                    \
        double d = v - (av);                                                 \
        (bm) += d * d;                                                       \
    } while (0)
        MC_P2_ONE(s0, x0, a0, m0, g0);
        MC_P2_ONE(s1, x1, a1, m1, g1);
        MC_P2_ONE(s2, x2, a2, m2, g2);
        MC_P2_ONE(s3, x3, a3, m3, g3);
#undef MC_P2_ONE
        if (++bm2n == 2048) {
            s0->m2acc += m0;
            s1->m2acc += m1;
            s2->m2acc += m2;
            s3->m2acc += m3;
            m0 = m1 = m2 = m3 = 0.0;
            bm2n = 0;
        }
    }
    s0->bm2 = m0;
    s1->bm2 = m1;
    s2->bm2 = m2;
    s3->bm2 = m3;
    s0->bm2n = s1->bm2n = s2->bm2n = s3->bm2n = bm2n;
}

/* Between P2 and P3: walk each plan's sub-counters in key order,
 * decide which sub-buckets own wanted ranks, and assign their gather
 * cursors in the chunk-shared scratch (subfill; -1 = not gathered).
 * Same rank arithmetic as the entry-level planning loop, one radix
 * level down. Returns the updated chunk gather cursor. */
static int64_t mc_plan_subs(SdMCol *s, int64_t chunk_gofs) {
    int64_t offset = s->offset, stride = s->stride, kept = s->kept;
    s->gather_total = 0;
    for (int32_t p = 0; p < s->nplanned; p++) {
        const SdPlan *pl = &s->plans[p];
        if (pl->subw == 0) {
            /* direct plan: P2 already gathered it; park the cursor at
             * -1 so the P3 gather skips it (resolve recomputes the
             * segment from gofs/fill) */
            s->subfill[pl->subofs] = -1;
            continue;
        }
        int64_t rank0 = pl->rank0;
        int64_t nsub = (int64_t)1 << pl->subw;
        int32_t *hist = s->subhist + pl->subofs;
        int64_t *fill = s->subfill + pl->subofs;
        for (int64_t sub = 0; sub < nsub; sub++) {
            int64_t c = (int64_t)hist[sub];
            fill[sub] = -1;
            if (c == 0) continue;
            int64_t jlo = (offset < rank0)
                              ? (rank0 - offset + stride - 1) / stride
                              : 0;
            if (jlo < kept && offset + jlo * stride < rank0 + c) {
                fill[sub] = chunk_gofs;
                chunk_gofs += c;
                s->gather_total += c;
            }
            rank0 += c;
        }
    }
    return chunk_gofs;
}

/* P3 over rows [i0, i1): gather keys of wanted sub-buckets only. */
static void mc_p3_block(SdMCol *s, const uint8_t *where, int64_t i0,
                        int64_t i1) {
    const double *x = s->x;
    const uint8_t *valid = s->valid;
    int32_t *subidx = s->subidx;
    int64_t *subfill = s->subfill;
    const SdPlan *plans = s->plans;
    uint64_t *scratch = s->scratch;
    for (int64_t i = i0; i < i1; i++) {
        if (sd_masked_out(valid, where, i)) continue;
        uint64_t k = f64_key(x[i]);
        int32_t si = subidx[k >> SD_TOP_SHIFT];
        if (si < 0) continue;
        const SdPlan *p = &plans[si];
        int64_t *g = &subfill[p->subofs + sd_mc_sub(k, p)];
        if (*g >= 0) scratch[(*g)++] = k;
    }
}

/* P3 fast path: no masks. */
static void mc_p3_block_fast(SdMCol *s, int64_t i0, int64_t i1) {
    const double *x = s->x;
    int32_t *subidx = s->subidx;
    int64_t *subfill = s->subfill;
    const SdPlan *plans = s->plans;
    uint64_t *scratch = s->scratch;
    for (int64_t i = i0; i < i1; i++) {
        double v = x[i];
        uint64_t u;
        memcpy(&u, &v, 8);
        uint64_t k = u ^ ((uint64_t)((int64_t)u >> 63) | 0x8000000000000000ULL);
        int32_t si = subidx[k >> SD_TOP_SHIFT];
        if (si < 0) continue;
        const SdPlan *p = &plans[si];
        int64_t *g = &subfill[p->subofs + sd_mc_sub(k, p)];
        if (*g >= 0) scratch[(*g)++] = k;
    }
}

/* After P3: resolve each gathered sub-segment. Walks subs in the same
 * key order as mc_plan_subs, so each wanted sub's segment is
 * [subfill - count, subfill) in the chunk scratch. Segment min/max are
 * scanned from the gathered keys (exact: they ARE the keys). */
static int mc_resolve_subs(SdMCol *s, double *samples) {
    int64_t offset = s->offset, stride = s->stride, kept = s->kept;
    for (int32_t p = 0; p < s->nplanned; p++) {
        const SdPlan *pl = &s->plans[p];
        if (pl->subw == 0) {
            /* direct plan: the whole bucket sits at gofs in the
             * column's direct region; its extrema are the P1 bucket
             * extrema (actual keys), and depth 1 matches sd_core's
             * top-segment resolve */
            int rc = resolve_segment(s->direct + pl->gofs, pl->fill,
                                     pl->kmin, pl->kmax,
                                     offset - pl->rank0, stride, pl->jlo,
                                     pl->jhi, samples, 1);
            if (rc) return rc;
            continue;
        }
        int64_t rank0 = pl->rank0;
        int64_t nsub = (int64_t)1 << pl->subw;
        int32_t *hist = s->subhist + pl->subofs;
        int64_t *fill = s->subfill + pl->subofs;
        for (int64_t sub = 0; sub < nsub; sub++) {
            int64_t c = (int64_t)hist[sub];
            if (c == 0) continue;
            if (fill[sub] >= 0) {
                uint64_t *seg = s->scratch + (fill[sub] - c);
                uint64_t smin = ~0ULL, smax = 0ULL;
                for (int64_t i = 0; i < c; i++) {
                    if (seg[i] < smin) smin = seg[i];
                    if (seg[i] > smax) smax = seg[i];
                }
                int64_t jlo = (offset < rank0)
                                  ? (rank0 - offset + stride - 1) / stride
                                  : 0;
                int64_t jhi = jlo;
                while (jhi < kept && offset + jhi * stride < rank0 + c) jhi++;
                int rc = resolve_segment(seg, c, smin, smax, offset - rank0,
                                         stride, jlo, jhi, samples, 2);
                if (rc) return rc;
            }
            rank0 += c;
        }
    }
    return 0;
}

/* Entry point. xs[c] are K same-length f64 columns; valids[c] may be
 * NULL (all valid); where is shared across columns (NULL = all rows).
 * samples is ncols*cap, meta ncols*3, mom ncols*6; hashvals[c] feeds
 * hll_modes[c] == 2; regs is ncols*(1<<P) caller-zeroed int32 (may be
 * NULL when every hll_modes[c] == 0). Output layout per column c is
 * identical to masked_moments_select. Returns nonzero on allocation
 * failure (outputs then unspecified — caller falls back per-column). */
int masked_moments_select_multi(const double **xs, const uint8_t **valids,
                                const uint8_t *where, int64_t n,
                                int64_t ncols, int64_t cap, double *samples,
                                int64_t *meta, double *mom,
                                const int64_t **hashvals,
                                const int32_t *hll_modes, int32_t *regs) {
    if (cap <= 0 || ncols <= 0 || n < 0) return 1;
    SdMCol *cols =
        (SdMCol *)sd_get(SD_SLOT_MC_COLS, (size_t)ncols * sizeof(SdMCol));
    SdTop *tops = (SdTop *)sd_get(
        SD_SLOT_MC_TOPS, (size_t)ncols * SD_TOP_BUCKETS * sizeof(SdTop));
    int32_t *subidx = (int32_t *)sd_get(SD_SLOT_MC_SUBIDX,
                                        (size_t)ncols * SD_TOP_BUCKETS * 4);
    /* kept <= cap always (cap << level >= m), so cap plans per column */
    SdPlan *plans = (SdPlan *)sd_get(
        SD_SLOT_MC_PLANS, (size_t)ncols * (size_t)cap * sizeof(SdPlan));
    if (!cols || !tops || !subidx || !plans) return 1;

    for (int64_t c = 0; c < ncols; c++) {
        SdMCol *s = &cols[c];
        memset(s, 0, sizeof(SdMCol));
        s->x = xs[c];
        s->valid = valids ? valids[c] : NULL;
        s->hll_mode = hll_modes ? (int)hll_modes[c] : 0;
        s->hashvals = hashvals ? hashvals[c] : NULL;
        s->regs = regs ? regs + (size_t)c * (1 << P) : NULL;
        if (!s->regs || (s->hll_mode == 2 && !s->hashvals)) s->hll_mode = 0;
        s->top = tops + (size_t)c * SD_TOP_BUCKETS;
        s->subidx = subidx + (size_t)c * SD_TOP_BUCKETS;
        s->plans = plans + (size_t)c * cap;
        s->kmin = ~0ULL;
        s->kmax = 0ULL;
        for (int64_t b = 0; b < SD_TOP_BUCKETS; b++) {
            s->top[b].mn = ~0ULL;
            s->top[b].mx = 0ULL;
            s->top[b].cnt = 0;
        }
    }

    /* index scratch: fast / generic partitions + pending list */
    int64_t *idxbuf = (int64_t *)malloc((size_t)ncols * 8 * 3);
    if (!idxbuf) return 1;
    int64_t *fastc = idxbuf;
    int64_t *genc = idxbuf + ncols;
    int64_t *pend = idxbuf + 2 * ncols;

    /* ---- P1, row-blocked across columns; unmasked no-HLL columns run
     * the quad fast path (four interleaved accumulation chains) ---- */
    int64_t nfast = 0, ngen = 0;
    for (int64_t c = 0; c < ncols; c++) {
        SdMCol *s = &cols[c];
        if (!s->valid && !where && !s->hll_mode)
            fastc[nfast++] = c;
        else
            genc[ngen++] = c;
    }
    for (int64_t i0 = 0; i0 < n; i0 += SD_MC_BLOCK) {
        int64_t i1 = i0 + SD_MC_BLOCK;
        if (i1 > n) i1 = n;
        int64_t f = 0;
        for (; f + 4 <= nfast; f += 4)
            mc_p1_block_fast4(&cols[fastc[f]], &cols[fastc[f + 1]],
                              &cols[fastc[f + 2]], &cols[fastc[f + 3]], i0,
                              i1);
        for (; f < nfast; f++) mc_p1_block_fast(&cols[fastc[f]], i0, i1);
        for (int64_t g = 0; g < ngen; g++)
            mc_p1_block(&cols[genc[g]], where, i0, i1);
    }

    /* ---- per-column finalize: moments out, P2 plans in ---- */
    for (int64_t c = 0; c < ncols; c++) {
        int rc = mc_finalize_p1(&cols[c], where, n, cap,
                                samples + (size_t)c * cap, meta + c * 3,
                                mom + c * 6);
        if (rc) {
            free(idxbuf);
            return rc;
        }
    }

    /* ---- P2 (sub-hist count + m2) / P3 (sparse gather) / resolve,
     * row-blocked, chunked so the per-plan sub tables stay under
     * budget (at least one column per chunk) ---- */
    int64_t npend = 0;
    for (int64_t c = 0; c < ncols; c++)
        if (!cols[c].done) pend[npend++] = c;

    int64_t pi = 0;
    while (pi < npend) {
        int64_t pj = pi;
        int64_t tentries = 0;
        int64_t tdirect = 0;
        int64_t tcost = 0;
        while (pj < npend) {
            SdMCol *sc = &cols[pend[pj]];
            /* a direct plan's hot write set is its cursor plus the one
             * cache line being appended to — count it as a line, not
             * its whole (sequentially written) region */
            int64_t cost = sc->subentries * 12 + sc->ndirect * 64;
            if (pj > pi && tcost + cost > SD_MC_TABLE_BUDGET) break;
            tcost += cost;
            tentries += sc->subentries;
            tdirect += sc->direct_total;
            pj++;
        }
        int32_t *subhist = NULL;
        int64_t *subfill = NULL;
        if (tentries > 0) {
            subhist =
                (int32_t *)sd_get(SD_SLOT_MC_SUBHIST, (size_t)tentries * 4);
            subfill =
                (int64_t *)sd_get(SD_SLOT_MC_SUBFILL, (size_t)tentries * 8);
            if (!subhist || !subfill) {
                free(idxbuf);
                return 1;
            }
            memset(subhist, 0, (size_t)tentries * 4);
        }
        uint64_t *direct_buf = NULL;
        if (tdirect > 0) {
            direct_buf =
                (uint64_t *)sd_get(SD_SLOT_MC_DIRECT, (size_t)tdirect * 8);
            if (!direct_buf) {
                free(idxbuf);
                return 1;
            }
        }
        int64_t eofs = 0;
        int64_t dofs = 0;
        nfast = 0;
        ngen = 0;
        for (int64_t p = pi; p < pj; p++) {
            SdMCol *s = &cols[pend[p]];
            s->subhist = subhist + eofs;
            s->subfill = subfill + eofs;
            eofs += s->subentries;
            /* column-shifted base: cursors stay column-local (gofs) */
            s->direct = direct_buf ? direct_buf + dofs : NULL;
            dofs += s->direct_total;
            for (int32_t q = 0; q < s->nplanned; q++) {
                const SdPlan *pl = &s->plans[q];
                if (pl->subw == 0) s->subfill[pl->subofs] = pl->gofs;
            }
            if (!s->valid && !where)
                fastc[nfast++] = pend[p];
            else
                genc[ngen++] = pend[p];
        }
        for (int64_t i0 = 0; i0 < n; i0 += SD_MC_BLOCK) {
            int64_t i1 = i0 + SD_MC_BLOCK;
            if (i1 > n) i1 = n;
            int64_t f = 0;
            for (; f + 4 <= nfast; f += 4)
                mc_p2_block_fast4(&cols[fastc[f]], &cols[fastc[f + 1]],
                                  &cols[fastc[f + 2]], &cols[fastc[f + 3]],
                                  i0, i1);
            for (; f < nfast; f++) mc_p2_block_fast(&cols[fastc[f]], i0, i1);
            for (int64_t g = 0; g < ngen; g++)
                mc_p2_block(&cols[genc[g]], where, i0, i1);
        }
        int64_t chunk_g = 0;
        for (int64_t p = pi; p < pj; p++) {
            SdMCol *s = &cols[pend[p]];
            int64_t c = pend[p];
            s->m2acc += s->bm2;
            s->bm2 = 0.0;
            mom[c * 6 + 4] = (double)s->m2acc;
            if (s->nplanned > 0) chunk_g = mc_plan_subs(s, chunk_g);
        }
        if (chunk_g > 0) {
            /* only columns with an above-threshold plan gather here;
             * direct plans were gathered during P2 */
            uint64_t *scratch = (uint64_t *)sd_get(0, (size_t)chunk_g * 8);
            if (!scratch) {
                free(idxbuf);
                return 1;
            }
            nfast = 0;
            ngen = 0;
            for (int64_t p = pi; p < pj; p++) {
                SdMCol *s = &cols[pend[p]];
                s->scratch = scratch;
                if (s->gather_total <= 0) continue;
                if (!s->valid && !where)
                    fastc[nfast++] = pend[p];
                else
                    genc[ngen++] = pend[p];
            }
            for (int64_t i0 = 0; i0 < n; i0 += SD_MC_BLOCK) {
                int64_t i1 = i0 + SD_MC_BLOCK;
                if (i1 > n) i1 = n;
                for (int64_t f = 0; f < nfast; f++)
                    mc_p3_block_fast(&cols[fastc[f]], i0, i1);
                for (int64_t g = 0; g < ngen; g++)
                    mc_p3_block(&cols[genc[g]], where, i0, i1);
            }
        }
        for (int64_t p = pi; p < pj; p++) {
            SdMCol *s = &cols[pend[p]];
            if (s->gather_total <= 0 && s->ndirect <= 0) continue;
            int rc = mc_resolve_subs(s, samples + (size_t)pend[p] * cap);
            if (rc) {
                free(idxbuf);
                return rc;
            }
        }
        for (int64_t p = pi; p < pj; p++) cols[pend[p]].done = 1;
        pi = pj;
    }
    free(idxbuf);
    return 0;
}
