/* Buffer-level Arrow decode kernels: the fast path behind
 * Table.from_arrow for columns the planner proves need only packed
 * inputs (ops/fused.py:plan_decode_fastpath).
 *
 * Each kernel consumes the raw buffers of ONE contiguous Arrow chunk —
 * the values buffer, the validity BITMAP (LSB bit order, never a
 * byte-expanded bool array), and for dictionary columns the int32 index
 * buffer — and emits the engine's Column backing: values with the
 * neutral fill in null slots (0 / 0.0 / false / -1 for dict codes; the
 * data/table.py Column contract) plus a uint8 0/1 mask.
 *
 * The Python chain these replace (Table.from_arrow fallback) is
 * fill_null(fill) -> to_numpy -> astype -> NaN fold: 3-4 passes and as
 * many intermediate buffers per column.  Here the shape is two tight
 * passes built to auto-vectorize: expand the validity bitmap into the
 * output mask ONCE (byte-at-a-time, popcount for the invalid total),
 * then a branchless blend over the values.  Per-element bit extraction
 * inside the value loop — the obvious one-pass shape — defeats SIMD
 * and reloads the bitmap byte every iteration; measured, the two-pass
 * form is several times faster.  All pointers are restrict-qualified:
 * the buffers come from disjoint Arrow and numpy allocations.
 *
 * Offsets/slices: `values` arrives pre-advanced to the chunk's first
 * logical element; `validity` is the ORIGINAL bitmap buffer with
 * `bit_offset` the chunk's Arrow offset, so row i's bit sits at
 * absolute position (bit_offset + i).  validity == NULL means
 * null-free.  Loops are bounded by n, so bitmap tail bits past the
 * last row are never read.  Each kernel returns the number of INVALID
 * rows (callers skip mask work when it is zero).
 */

#include <math.h>
#include <stdint.h>
#include <stddef.h>
#include <string.h>

static inline int bit_at(const uint8_t *bits, int64_t pos) {
    return (bits[pos >> 3] >> (pos & 7)) & 1;
}

/* Bitmap -> uint8 0/1 mask. Head/tail rows handle a non-byte-aligned
 * bit_offset (sliced chunks); the body expands one bitmap byte into
 * eight mask bytes per iteration. Returns the number of ZERO bits. */
static int64_t expand_validity(const uint8_t *restrict validity,
                               int64_t bit_offset, int64_t n,
                               uint8_t *restrict out_valid) {
    int64_t invalid = 0;
    int64_t i = 0;
    while (i < n && ((bit_offset + i) & 7) != 0) {
        uint8_t ok = (uint8_t)bit_at(validity, bit_offset + i);
        out_valid[i] = ok;
        invalid += !ok;
        i++;
    }
    const uint8_t *bytes = validity + ((bit_offset + i) >> 3);
    int64_t nb = (n - i) >> 3;
    for (int64_t b = 0; b < nb; b++) {
        uint8_t byte = bytes[b];
        uint8_t *out = out_valid + i + b * 8;
        for (int j = 0; j < 8; j++) out[j] = (uint8_t)((byte >> j) & 1);
        invalid += 8 - __builtin_popcount(byte);
    }
    i += nb * 8;
    for (; i < n; i++) {
        uint8_t ok = (uint8_t)bit_at(validity, bit_offset + i);
        out_valid[i] = ok;
        invalid += !ok;
    }
    return invalid;
}

/* float64: NaN == NULL under this engine, so validity folds the NaN
 * mask in the same kernel (table.py from_arrow: valid &= ~isnan). */
int64_t decode_f64(const double *restrict values,
                   const uint8_t *restrict validity,
                   int64_t bit_offset, int64_t n,
                   double *restrict out_values,
                   uint8_t *restrict out_valid) {
    int64_t invalid = 0;
    if (validity) {
        invalid = expand_validity(validity, bit_offset, n, out_valid);
        for (int64_t i = 0; i < n; i++) {
            double v = out_valid[i] ? values[i] : 0.0;
            uint8_t nan = (uint8_t)(v != v); /* null slots are 0.0: never NaN */
            out_values[i] = nan ? 0.0 : v;
            out_valid[i] = (uint8_t)(out_valid[i] & !nan);
            invalid += nan;
        }
    } else {
        for (int64_t i = 0; i < n; i++) {
            double v = values[i];
            uint8_t nan = (uint8_t)(v != v);
            out_values[i] = nan ? 0.0 : v;
            out_valid[i] = (uint8_t)!nan;
            invalid += nan;
        }
    }
    return invalid;
}

/* float32 widens to the engine's float64 backing in the same pass. */
int64_t decode_f32(const float *restrict values,
                   const uint8_t *restrict validity,
                   int64_t bit_offset, int64_t n,
                   double *restrict out_values,
                   uint8_t *restrict out_valid) {
    int64_t invalid = 0;
    if (validity) {
        invalid = expand_validity(validity, bit_offset, n, out_valid);
        for (int64_t i = 0; i < n; i++) {
            double v = out_valid[i] ? (double)values[i] : 0.0;
            uint8_t nan = (uint8_t)(v != v);
            out_values[i] = nan ? 0.0 : v;
            out_valid[i] = (uint8_t)(out_valid[i] & !nan);
            invalid += nan;
        }
    } else {
        for (int64_t i = 0; i < n; i++) {
            double v = (double)values[i];
            uint8_t nan = (uint8_t)(v != v);
            out_values[i] = nan ? 0.0 : v;
            out_valid[i] = (uint8_t)!nan;
            invalid += nan;
        }
    }
    return invalid;
}

/* Integers widen to int64 (null -> 0). The uint64 > INT64_MAX wrap
 * matches numpy's astype(int64) C-cast semantics in the fallback. */
#define DECODE_INT(NAME, CTYPE)                                           \
int64_t NAME(const CTYPE *restrict values,                                \
             const uint8_t *restrict validity,                            \
             int64_t bit_offset, int64_t n,                               \
             int64_t *restrict out_values,                                \
             uint8_t *restrict out_valid) {                               \
    if (validity) {                                                       \
        int64_t invalid = expand_validity(validity, bit_offset, n,        \
                                          out_valid);                     \
        for (int64_t i = 0; i < n; i++)                                   \
            out_values[i] = out_valid[i] ? (int64_t)values[i] : 0;        \
        return invalid;                                                   \
    }                                                                     \
    for (int64_t i = 0; i < n; i++)                                       \
        out_values[i] = (int64_t)values[i];                               \
    memset(out_valid, 1, (size_t)n);                                      \
    return 0;                                                             \
}

DECODE_INT(decode_i8, int8_t)
DECODE_INT(decode_i16, int16_t)
DECODE_INT(decode_i32, int32_t)
DECODE_INT(decode_i64, int64_t)
DECODE_INT(decode_u8, uint8_t)
DECODE_INT(decode_u16, uint16_t)
DECODE_INT(decode_u32, uint32_t)
DECODE_INT(decode_u64, uint64_t)

/* Booleans: BOTH buffers are bitmaps, each with its own bit offset
 * (a sliced chunk shares buffers with its parent). null -> false.
 * Both bitmaps expand byte-wise; the value mask then ANDs the null
 * mask so null slots read false. */
int64_t decode_bool(const uint8_t *restrict value_bits,
                    int64_t value_bit_offset,
                    const uint8_t *restrict validity,
                    int64_t valid_bit_offset,
                    int64_t n, uint8_t *restrict out_values,
                    uint8_t *restrict out_valid) {
    expand_validity(value_bits, value_bit_offset, n, out_values);
    if (!validity) {
        memset(out_valid, 1, (size_t)n);
        return 0;
    }
    int64_t invalid = expand_validity(validity, valid_bit_offset, n,
                                      out_valid);
    for (int64_t i = 0; i < n; i++)
        out_values[i] = (uint8_t)(out_values[i] & out_valid[i]);
    return invalid;
}

/* Dictionary-encoded strings: int32 index buffer -> dict_encode codes
 * (null -> -1, the sentinel gather_with_null indexes) plus the mask.
 * The dictionary itself stays host-side (uniques via the fallback
 * helper); per-row strings remain lazy. */
int64_t decode_dict_i32(const int32_t *restrict indices,
                        const uint8_t *restrict validity,
                        int64_t bit_offset, int64_t n,
                        int32_t *restrict out_codes,
                        uint8_t *restrict out_valid) {
    if (validity) {
        int64_t invalid = expand_validity(validity, bit_offset, n,
                                          out_valid);
        for (int64_t i = 0; i < n; i++)
            out_codes[i] = out_valid[i] ? indices[i] : -1;
        return invalid;
    }
    memcpy(out_codes, indices, (size_t)n * sizeof(int32_t));
    memset(out_valid, 1, (size_t)n);
    return 0;
}

/* ---- decode-to-wire kernels -------------------------------------------
 *
 * The kernels above emit the engine Column backing (values + uint8
 * mask); the prep stage then re-reads every element to build the wire
 * format (ops/fused.py:pack_batch_inputs — np.packbits masks, int
 * narrowing, f32 pre-centering).  For planner-proven packed-only
 * columns that Column intermediate is pure waste, so the kernels below
 * emit the WIRE buffers directly from the Arrow buffers:
 *
 *   * a bitpacked 1-bit/row mask in np.packbits order (MSB-first —
 *     Arrow validity bitmaps are LSB-first, so this is a bit-order
 *     recode), validity AND the float NaN fold in the same pass;
 *   * value rows in the compute dtype, pre-centered by the sticky
 *     scan-constant shift on the f32 wire;
 *   * narrowed int rows at a statically pinned width (parquet
 *     statistics), range-checked — a lying file aborts the kernel
 *     (return -1) and the caller falls back to the Column path.
 *
 * Wire buffers are PREZEROED by the caller (the padded tail must read
 * zero to match the pack path's zeroed group buffer), and the mask
 * writers only OR bits in, so concurrent per-chunk writers at disjoint
 * row ranges never clobber a shared boundary byte.  `out_bit_offset`
 * is the chunk's first row position inside the batch row, which lands
 * mid-byte whenever a row group ends off a multiple of 8.  Tiles reuse
 * expand_validity for the LSB head/tail handling it already has.
 */

#define WIRE_TILE 512

/* OR `ok` (0/1 per row) into out_bits at out_off, MSB-first within each
 * byte (np.packbits bitorder="big"). Head/tail handle a mid-byte start
 * and end; the body packs eight rows per output byte. */
static void wire_set_bits_msb(const uint8_t *restrict ok, int64_t n,
                              uint8_t *restrict out_bits, int64_t out_off) {
    int64_t i = 0;
    while (i < n && ((out_off + i) & 7) != 0) {
        if (ok[i])
            out_bits[(out_off + i) >> 3] |=
                (uint8_t)(1u << (7 - ((out_off + i) & 7)));
        i++;
    }
    uint8_t *bytes = out_bits + ((out_off + i) >> 3);
    int64_t nb = (n - i) >> 3;
    for (int64_t b = 0; b < nb; b++) {
        const uint8_t *src = ok + i + b * 8;
        uint8_t byte = 0;
        for (int j = 0; j < 8; j++) byte = (uint8_t)((byte << 1) | (src[j] & 1));
        bytes[b] |= byte;
    }
    i += nb * 8;
    for (; i < n; i++)
        if (ok[i])
            out_bits[(out_off + i) >> 3] |=
                (uint8_t)(1u << (7 - ((out_off + i) & 7)));
}

/* Validity bitmap (LSB) -> wire mask bits (MSB) with no value pass:
 * int/bool columns whose only packed consumer is the valid: mask.
 * validity == NULL means null-free (all bits set). */
int64_t wire_valid_bits(const uint8_t *restrict validity, int64_t bit_offset,
                        int64_t n, uint8_t *restrict out_bits,
                        int64_t out_bit_offset) {
    uint8_t tile[WIRE_TILE];
    int64_t invalid = 0;
    for (int64_t t = 0; t < n; t += WIRE_TILE) {
        int64_t m = n - t < WIRE_TILE ? n - t : WIRE_TILE;
        if (validity)
            invalid += expand_validity(validity, bit_offset + t, m, tile);
        else
            memset(tile, 1, (size_t)m);
        wire_set_bits_msb(tile, m, out_bits, out_bit_offset + t);
    }
    return invalid;
}

/* Float chunk -> wire value row + wire mask bits in one pass.  The
 * value math replicates pack_batch_inputs exactly: v_eff is the Column
 * backing (null/NaN -> 0.0), the shift subtraction happens in double,
 * and only then does the result narrow to the wire dtype — so the f32
 * wire's (float)(v_eff - shift) matches numpy's f64-subtract-then-
 * astype bit for bit.  out_values == NULL emits mask bits only
 * (valid:-only consumers still need the NaN fold); out_bits == NULL
 * emits values only. */
#define WIRE_FLOAT(NAME, INTYPE, OUTTYPE)                                  \
int64_t NAME(const INTYPE *restrict values,                                \
             const uint8_t *restrict validity,                             \
             int64_t bit_offset, int64_t n, double shift,                  \
             OUTTYPE *restrict out_values,                                 \
             uint8_t *restrict out_bits, int64_t out_bit_offset) {         \
    uint8_t tile[WIRE_TILE];                                               \
    int64_t invalid = 0;                                                   \
    for (int64_t t = 0; t < n; t += WIRE_TILE) {                           \
        int64_t m = n - t < WIRE_TILE ? n - t : WIRE_TILE;                 \
        if (validity)                                                      \
            invalid += expand_validity(validity, bit_offset + t, m, tile); \
        else                                                               \
            memset(tile, 1, (size_t)m);                                    \
        for (int64_t i = 0; i < m; i++) {                                  \
            double v = tile[i] ? (double)values[t + i] : 0.0;              \
            uint8_t nan = (uint8_t)(v != v); /* null slots never NaN */    \
            invalid += nan;                                                \
            tile[i] = (uint8_t)(tile[i] & !nan);                           \
            if (out_values)                                                \
                out_values[t + i] = (OUTTYPE)((nan ? 0.0 : v) - shift);    \
        }                                                                  \
        if (out_bits)                                                      \
            wire_set_bits_msb(tile, m, out_bits, out_bit_offset + t);      \
    }                                                                      \
    return invalid;                                                        \
}

WIRE_FLOAT(wire_f64, double, double)
WIRE_FLOAT(wire_f64_to_f32, double, float)
WIRE_FLOAT(wire_f32_to_f64, float, double)
WIRE_FLOAT(wire_f32, float, float)

/* Int chunk -> wire value row (+ mask bits).  out_code selects the
 * wire dtype: 0=int8 1=int16 2=int32 (range-checked, null fill 0 is
 * always in range) 3=float64 4=float32 (pre-centered by `shift`, the
 * f32 wire's path).  A value outside the pinned narrow range returns
 * -1 — the statically chosen width came from parquet statistics, so
 * this only fires on a lying file; the caller discards the partial
 * wire buffers and re-decodes the column through the Column path. */
#define WIRE_INT(NAME, CTYPE)                                              \
int64_t NAME(const CTYPE *restrict values,                                 \
             const uint8_t *restrict validity,                             \
             int64_t bit_offset, int64_t n, int out_code, double shift,    \
             void *restrict out_values,                                    \
             uint8_t *restrict out_bits, int64_t out_bit_offset) {         \
    uint8_t tile[WIRE_TILE];                                               \
    int64_t invalid = 0;                                                   \
    int8_t *o8 = (int8_t *)out_values;                                     \
    int16_t *o16 = (int16_t *)out_values;                                  \
    int32_t *o32 = (int32_t *)out_values;                                  \
    double *o64 = (double *)out_values;                                    \
    float *of = (float *)out_values;                                       \
    for (int64_t t = 0; t < n; t += WIRE_TILE) {                           \
        int64_t m = n - t < WIRE_TILE ? n - t : WIRE_TILE;                 \
        if (validity)                                                      \
            invalid += expand_validity(validity, bit_offset + t, m, tile); \
        else                                                               \
            memset(tile, 1, (size_t)m);                                    \
        if (out_values) switch (out_code) {                                \
        case 0:                                                            \
            for (int64_t i = 0; i < m; i++) {                              \
                int64_t v = tile[i] ? (int64_t)values[t + i] : 0;          \
                if (v < -128 || v > 127) return -1;                        \
                o8[t + i] = (int8_t)v;                                     \
            }                                                              \
            break;                                                         \
        case 1:                                                            \
            for (int64_t i = 0; i < m; i++) {                              \
                int64_t v = tile[i] ? (int64_t)values[t + i] : 0;          \
                if (v < -32768 || v > 32767) return -1;                    \
                o16[t + i] = (int16_t)v;                                   \
            }                                                              \
            break;                                                         \
        case 2:                                                            \
            for (int64_t i = 0; i < m; i++) {                              \
                int64_t v = tile[i] ? (int64_t)values[t + i] : 0;          \
                if (v < -2147483648LL || v > 2147483647LL) return -1;      \
                o32[t + i] = (int32_t)v;                                   \
            }                                                              \
            break;                                                         \
        case 3:                                                            \
            for (int64_t i = 0; i < m; i++)                                \
                o64[t + i] = tile[i] ? (double)values[t + i] : 0.0;        \
            break;                                                         \
        case 4:                                                            \
            for (int64_t i = 0; i < m; i++) {                              \
                double v = tile[i] ? (double)values[t + i] : 0.0;          \
                of[t + i] = (float)(v - shift);                            \
            }                                                              \
            break;                                                         \
        default:                                                           \
            return -1;                                                     \
        }                                                                  \
        if (out_bits)                                                      \
            wire_set_bits_msb(tile, m, out_bits, out_bit_offset + t);      \
    }                                                                      \
    return invalid;                                                        \
}

WIRE_INT(wire_i8, int8_t)
WIRE_INT(wire_i16, int16_t)
WIRE_INT(wire_i32, int32_t)
WIRE_INT(wire_i64, int64_t)
WIRE_INT(wire_u8, uint8_t)
WIRE_INT(wire_u16, uint16_t)
WIRE_INT(wire_u32, uint32_t)
