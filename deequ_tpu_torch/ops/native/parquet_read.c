/* Native parquet column-chunk reader: page headers in, Arrow-layout
 * buffers out.
 *
 * pq_decode_chunk() walks one column chunk's byte range (dictionary
 * page + data pages), parses each Thrift-compact PageHeader,
 * decompresses the page body (snappy / zstd via dlopen — the container
 * ships runtime .so's but no dev symlinks), and decodes PLAIN,
 * RLE_DICTIONARY / PLAIN_DICTIONARY and RLE-boolean values into the
 * same buffer layout Arrow would hand decode.c: contiguous
 * little-endian values with zeros at null slots plus an LSB validity
 * bitmap. The existing decode and wire kernels then consume those
 * buffers unchanged, which is what makes the native path bit-identical
 * by construction.
 *
 * Scope is fail-closed: anything outside the proven shapes (nested
 * levels, BIT_PACKED def levels, unknown codecs, malformed headers,
 * out-of-range dictionary indices, row-count mismatches) returns a
 * negative error so the Python layer falls back to pyarrow for that
 * column. No input may crash this file — every read is bounds-checked
 * and fuzz + sanitizer drivers exercise the error paths.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <dlfcn.h>
#include <pthread.h>

/* ---- error codes (negative returns from pq_decode_chunk) ---- */
#define PQE_TRUNCATED (-1)   /* byte range ends mid-structure */
#define PQE_THRIFT (-2)      /* malformed compact-protocol header */
#define PQE_UNSUPPORTED (-3) /* page/encoding shape outside proven set */
#define PQE_CODEC (-4)       /* decompression failed or codec missing */
#define PQE_SIZE (-5)        /* size field implausible / overflow */
#define PQE_ALLOC (-6)       /* scratch allocation failed */
#define PQE_DICT (-7)        /* dictionary index out of range / absent */
#define PQE_ROWS (-8)        /* decoded row count != footer num_values */

/* ---- parquet enums (format spec values) ---- */
#define PT_BOOLEAN 0
#define PT_INT32 1
#define PT_INT64 2
#define PT_FLOAT 4
#define PT_DOUBLE 5

#define PAGE_DATA 0
#define PAGE_INDEX 1
#define PAGE_DICT 2
#define PAGE_DATA_V2 3

#define ENC_PLAIN 0
#define ENC_PLAIN_DICT 2
#define ENC_RLE 3
#define ENC_RLE_DICT 8

#define CODEC_NONE 0
#define CODEC_SNAPPY 1
#define CODEC_ZSTD 6

#define MAX_PAGE_BYTES ((int64_t)1 << 30)

/* ---- lazy-loaded decompressors ---- */

typedef int (*snappy_uncompress_fn)(const char *, size_t, char *, size_t *);
typedef int (*snappy_uncompressed_length_fn)(const char *, size_t, size_t *);
typedef size_t (*zstd_decompress_fn)(void *, size_t, const void *, size_t);
typedef unsigned (*zstd_iserror_fn)(size_t);

static snappy_uncompress_fn g_snappy_uncompress;
static snappy_uncompressed_length_fn g_snappy_len;
static zstd_decompress_fn g_zstd_decompress;
static zstd_iserror_fn g_zstd_iserror;
static int g_codec_mask; /* 1 = uncompressed, 2 = snappy, 4 = zstd */
static pthread_once_t g_codec_once = PTHREAD_ONCE_INIT;

static void codec_init(void) {
    g_codec_mask = 1;
    void *snappy = dlopen("libsnappy.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (snappy) {
        g_snappy_uncompress =
            (snappy_uncompress_fn)dlsym(snappy, "snappy_uncompress");
        g_snappy_len = (snappy_uncompressed_length_fn)dlsym(
            snappy, "snappy_uncompressed_length");
        if (g_snappy_uncompress && g_snappy_len) g_codec_mask |= 2;
    }
    void *zstd = dlopen("libzstd.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (zstd) {
        g_zstd_decompress = (zstd_decompress_fn)dlsym(zstd, "ZSTD_decompress");
        g_zstd_iserror = (zstd_iserror_fn)dlsym(zstd, "ZSTD_isError");
        if (g_zstd_decompress && g_zstd_iserror) g_codec_mask |= 4;
    }
}

int pq_reader_codecs(void) {
    pthread_once(&g_codec_once, codec_init);
    return g_codec_mask;
}

static int pq_decompress(int32_t codec, const uint8_t *src, int64_t src_len,
                         uint8_t *dst, int64_t dst_len) {
    pthread_once(&g_codec_once, codec_init);
    if (codec == CODEC_SNAPPY) {
        if (!(g_codec_mask & 2)) return PQE_CODEC;
        size_t out_len = 0;
        if (g_snappy_len((const char *)src, (size_t)src_len, &out_len) != 0)
            return PQE_CODEC;
        if ((int64_t)out_len != dst_len) return PQE_CODEC;
        if (g_snappy_uncompress((const char *)src, (size_t)src_len,
                                (char *)dst, &out_len) != 0)
            return PQE_CODEC;
        return 0;
    }
    if (codec == CODEC_ZSTD) {
        if (!(g_codec_mask & 4)) return PQE_CODEC;
        size_t rc = g_zstd_decompress(dst, (size_t)dst_len, src, (size_t)src_len);
        if (g_zstd_iserror(rc) || (int64_t)rc != dst_len) return PQE_CODEC;
        return 0;
    }
    return PQE_CODEC;
}

/* ---- Thrift compact protocol (read-only subset) ---- */

typedef struct {
    const uint8_t *p;
    const uint8_t *end;
    int err;
} tin_t;

static uint64_t t_uvarint(tin_t *t) {
    uint64_t v = 0;
    int shift = 0;
    while (t->p < t->end && shift < 64) {
        uint8_t b = *t->p++;
        v |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) return v;
        shift += 7;
    }
    t->err = 1;
    return 0;
}

static int64_t t_zigzag(tin_t *t) {
    uint64_t u = t_uvarint(t);
    return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
}

static void t_skipn(tin_t *t, uint64_t n) {
    if ((uint64_t)(t->end - t->p) < n) {
        t->err = 1;
        t->p = t->end;
        return;
    }
    t->p += n;
}

/* Skip one value of the given compact element type. Bool-in-struct is
 * encoded in the field-type nibble (1/2, no payload); bool-in-container
 * is one byte per element — callers pass type 3 (BYTE) for those. */
static void t_skip_value(tin_t *t, int ctype, int depth) {
    if (t->err || depth > 8) {
        t->err = 1;
        return;
    }
    switch (ctype) {
        case 1: /* BOOL true (field form, no payload) */
        case 2: /* BOOL false */
            return;
        case 3: /* BYTE */
            t_skipn(t, 1);
            return;
        case 4: /* I16 */
        case 5: /* I32 */
        case 6: /* I64 */
            (void)t_zigzag(t);
            return;
        case 7: /* DOUBLE */
            t_skipn(t, 8);
            return;
        case 8: { /* BINARY / STRING */
            uint64_t len = t_uvarint(t);
            t_skipn(t, len);
            return;
        }
        case 9:   /* LIST */
        case 10: { /* SET */
            if (t->p >= t->end) {
                t->err = 1;
                return;
            }
            uint8_t hdr = *t->p++;
            uint64_t size = hdr >> 4;
            int etype = hdr & 0x0f;
            if (size == 15) size = t_uvarint(t);
            if (size > (uint64_t)(t->end - t->p)) {
                /* every element is >= 1 byte on the wire */
                t->err = 1;
                return;
            }
            if (etype == 1 || etype == 2) etype = 3; /* bools: 1 byte each */
            for (uint64_t i = 0; i < size && !t->err; i++)
                t_skip_value(t, etype, depth + 1);
            return;
        }
        case 11: { /* MAP */
            uint64_t size = t_uvarint(t);
            if (size == 0) return;
            if (t->p >= t->end || size > (uint64_t)(t->end - t->p)) {
                t->err = 1;
                return;
            }
            uint8_t kv = *t->p++;
            int ktype = (kv >> 4) & 0x0f;
            int vtype = kv & 0x0f;
            if (ktype == 1 || ktype == 2) ktype = 3;
            if (vtype == 1 || vtype == 2) vtype = 3;
            for (uint64_t i = 0; i < size && !t->err; i++) {
                t_skip_value(t, ktype, depth + 1);
                t_skip_value(t, vtype, depth + 1);
            }
            return;
        }
        case 12: { /* STRUCT: fields until STOP */
            int16_t last_fid = 0;
            for (;;) {
                if (t->p >= t->end) {
                    t->err = 1;
                    return;
                }
                uint8_t fb = *t->p++;
                if (fb == 0) return; /* STOP */
                int ftype = fb & 0x0f;
                int delta = (fb >> 4) & 0x0f;
                if (delta == 0)
                    last_fid = (int16_t)t_zigzag(t);
                else
                    last_fid = (int16_t)(last_fid + delta);
                t_skip_value(t, ftype, depth + 1);
                if (t->err) return;
            }
        }
        default:
            t->err = 1;
            return;
    }
}

/* Parsed PageHeader fields we care about. */
typedef struct {
    int32_t page_type;
    int64_t uncompressed_size;
    int64_t compressed_size;
    /* data page v1 */
    int64_t num_values;
    int32_t encoding;
    int32_t def_encoding;
    /* dictionary page */
    int64_t dict_num_values;
    int32_t dict_encoding;
    /* data page v2 */
    int64_t v2_num_values;
    int64_t v2_num_nulls;
    int64_t v2_num_rows;
    int32_t v2_encoding;
    int64_t v2_dl_len;
    int64_t v2_rl_len;
    int v2_is_compressed;
} page_header_t;

static void parse_data_page_header(tin_t *t, page_header_t *h) {
    int16_t last_fid = 0;
    for (;;) {
        if (t->p >= t->end) {
            t->err = 1;
            return;
        }
        uint8_t fb = *t->p++;
        if (fb == 0) return;
        int ftype = fb & 0x0f;
        int delta = (fb >> 4) & 0x0f;
        if (delta == 0)
            last_fid = (int16_t)t_zigzag(t);
        else
            last_fid = (int16_t)(last_fid + delta);
        if (last_fid == 1 && ftype == 5)
            h->num_values = t_zigzag(t);
        else if (last_fid == 2 && ftype == 5)
            h->encoding = (int32_t)t_zigzag(t);
        else if (last_fid == 3 && ftype == 5)
            h->def_encoding = (int32_t)t_zigzag(t);
        else
            t_skip_value(t, ftype, 0);
        if (t->err) return;
    }
}

static void parse_dict_page_header(tin_t *t, page_header_t *h) {
    int16_t last_fid = 0;
    for (;;) {
        if (t->p >= t->end) {
            t->err = 1;
            return;
        }
        uint8_t fb = *t->p++;
        if (fb == 0) return;
        int ftype = fb & 0x0f;
        int delta = (fb >> 4) & 0x0f;
        if (delta == 0)
            last_fid = (int16_t)t_zigzag(t);
        else
            last_fid = (int16_t)(last_fid + delta);
        if (last_fid == 1 && ftype == 5)
            h->dict_num_values = t_zigzag(t);
        else if (last_fid == 2 && ftype == 5)
            h->dict_encoding = (int32_t)t_zigzag(t);
        else
            t_skip_value(t, ftype, 0);
        if (t->err) return;
    }
}

static void parse_data_page_v2_header(tin_t *t, page_header_t *h) {
    int16_t last_fid = 0;
    h->v2_is_compressed = 1; /* spec default when field absent */
    for (;;) {
        if (t->p >= t->end) {
            t->err = 1;
            return;
        }
        uint8_t fb = *t->p++;
        if (fb == 0) return;
        int ftype = fb & 0x0f;
        int delta = (fb >> 4) & 0x0f;
        if (delta == 0)
            last_fid = (int16_t)t_zigzag(t);
        else
            last_fid = (int16_t)(last_fid + delta);
        if (last_fid == 1 && ftype == 5)
            h->v2_num_values = t_zigzag(t);
        else if (last_fid == 2 && ftype == 5)
            h->v2_num_nulls = t_zigzag(t);
        else if (last_fid == 3 && ftype == 5)
            h->v2_num_rows = t_zigzag(t);
        else if (last_fid == 4 && ftype == 5)
            h->v2_encoding = (int32_t)t_zigzag(t);
        else if (last_fid == 5 && ftype == 5)
            h->v2_dl_len = t_zigzag(t);
        else if (last_fid == 6 && ftype == 5)
            h->v2_rl_len = t_zigzag(t);
        else if (last_fid == 7 && (ftype == 1 || ftype == 2))
            h->v2_is_compressed = (ftype == 1);
        else
            t_skip_value(t, ftype, 0);
        if (t->err) return;
    }
}

/* Parse one PageHeader struct starting at t->p. Returns 0 or PQE_*. */
static int parse_page_header(tin_t *t, page_header_t *h) {
    memset(h, 0, sizeof(*h));
    h->page_type = -1;
    h->uncompressed_size = -1;
    h->compressed_size = -1;
    h->num_values = -1;
    h->encoding = -1;
    h->def_encoding = -1;
    h->dict_num_values = -1;
    h->dict_encoding = -1;
    h->v2_num_values = -1;
    h->v2_num_nulls = -1;
    h->v2_num_rows = -1;
    h->v2_encoding = -1;
    h->v2_dl_len = -1;
    h->v2_rl_len = -1;
    int16_t last_fid = 0;
    int saw_dph = 0, saw_dict = 0, saw_v2 = 0;
    for (;;) {
        if (t->p >= t->end) return PQE_TRUNCATED;
        uint8_t fb = *t->p++;
        if (fb == 0) break; /* STOP */
        int ftype = fb & 0x0f;
        int delta = (fb >> 4) & 0x0f;
        if (delta == 0)
            last_fid = (int16_t)t_zigzag(t);
        else
            last_fid = (int16_t)(last_fid + delta);
        if (t->err) return PQE_THRIFT;
        if (last_fid == 1 && ftype == 5)
            h->page_type = (int32_t)t_zigzag(t);
        else if (last_fid == 2 && ftype == 5)
            h->uncompressed_size = t_zigzag(t);
        else if (last_fid == 3 && ftype == 5)
            h->compressed_size = t_zigzag(t);
        else if (last_fid == 5 && ftype == 12) {
            parse_data_page_header(t, h);
            saw_dph = 1;
        } else if (last_fid == 7 && ftype == 12) {
            parse_dict_page_header(t, h);
            saw_dict = 1;
        } else if (last_fid == 8 && ftype == 12) {
            parse_data_page_v2_header(t, h);
            saw_v2 = 1;
        } else
            t_skip_value(t, ftype, 0);
        if (t->err) return PQE_THRIFT;
    }
    if (h->page_type < 0 || h->uncompressed_size < 0 || h->compressed_size < 0)
        return PQE_THRIFT;
    if (h->uncompressed_size > MAX_PAGE_BYTES || h->compressed_size > MAX_PAGE_BYTES)
        return PQE_SIZE;
    if (h->page_type == PAGE_DATA && !saw_dph) return PQE_THRIFT;
    if (h->page_type == PAGE_DICT && !saw_dict) return PQE_THRIFT;
    if (h->page_type == PAGE_DATA_V2 && !saw_v2) return PQE_THRIFT;
    return 0;
}

/* ---- RLE / bit-packed hybrid decoder ---- */

/* Read `bw` bits at bit position `pos` from `in[0..in_len)`, LSB-first.
 * Caller guarantees the group's bytes exist; this re-checks anyway. */
/* Unpack one bit-packed group of 8 bw-bit values through a sliding
 * 64-bit bit buffer (the buffer never holds more than 39 live bits:
 * at most bw-1 <= 31 leftovers plus one 8-bit refill). The caller
 * guarantees all bw bytes of the group are present. Returns the
 * advanced input pointer. */
static inline const uint8_t *unpack8(const uint8_t *p, int bw,
                                     uint32_t *out) {
    if (bw == 1) {
        uint8_t b = p[0];
        for (int i = 0; i < 8; i++) out[i] = (b >> i) & 1u;
        return p + 1;
    }
    if (bw == 8) {
        for (int i = 0; i < 8; i++) out[i] = p[i];
        return p + 8;
    }
    uint64_t acc = 0;
    int have = 0;
    uint32_t mask = bw >= 32 ? 0xFFFFFFFFu : ((1u << bw) - 1u);
    for (int i = 0; i < 8; i++) {
        while (have < bw) {
            acc |= (uint64_t)(*p++) << have;
            have += 8;
        }
        out[i] = (uint32_t)acc & mask;
        acc >>= bw;
        have -= bw;
    }
    return p;
}

/* Decode exactly `count` values from an RLE/bit-packed hybrid stream.
 * Returns bytes consumed, or PQE_* (<0). */
static int64_t hybrid_u32(const uint8_t *in, int64_t in_len, int bw,
                          int64_t count, uint32_t *out) {
    if (bw < 0 || bw > 32) return PQE_UNSUPPORTED;
    if (count == 0) return 0;
    if (bw == 0) {
        memset(out, 0, (size_t)count * sizeof(uint32_t));
        return 0;
    }
    tin_t t = {in, in + in_len, 0};
    int64_t got = 0;
    int vbytes = (bw + 7) >> 3;
    while (got < count) {
        uint64_t header = t_uvarint(&t);
        if (t.err) return PQE_TRUNCATED;
        if ((header & 1) == 0) {
            int64_t run = (int64_t)(header >> 1);
            if (run <= 0) return PQE_THRIFT;
            if ((uint64_t)(t.end - t.p) < (uint64_t)vbytes)
                return PQE_TRUNCATED;
            uint32_t v = 0;
            for (int i = 0; i < vbytes; i++) v |= (uint32_t)t.p[i] << (8 * i);
            t.p += vbytes;
            if (bw < 32) v &= (uint32_t)(((uint64_t)1 << bw) - 1);
            int64_t take = run < count - got ? run : count - got;
            for (int64_t i = 0; i < take; i++) out[got + i] = v;
            got += take;
        } else {
            int64_t groups = (int64_t)(header >> 1);
            if (groups <= 0) return PQE_THRIFT;
            /* bw >= 1 here, so every group consumes at least one input
             * byte; bounding groups by the remaining bytes before the
             * multiplications keeps nvals/nbytes from overflowing on
             * corrupt varint group counts (up to 2^62). */
            if (groups > (int64_t)(t.end - t.p)) return PQE_TRUNCATED;
            int64_t nvals = groups * 8;
            int64_t nbytes = groups * bw;
            if ((int64_t)(t.end - t.p) < nbytes) return PQE_TRUNCATED;
            int64_t take = nvals < count - got ? nvals : count - got;
            /* every declared group's bw bytes are inside nbytes, so the
             * group containing a partial tail is still fully readable */
            const uint8_t *gp = t.p;
            uint32_t *op = out + got;
            int64_t full = take >> 3;
            for (int64_t g = 0; g < full; g++, op += 8)
                gp = unpack8(gp, bw, op);
            int64_t rem = take & 7;
            if (rem > 0) {
                uint32_t tail[8];
                unpack8(gp, bw, tail);
                for (int64_t i = 0; i < rem; i++) op[i] = tail[i];
            }
            t.p += nbytes;
            got += take;
        }
    }
    return (int64_t)(t.p - in);
}

/* OR bitmap bits [start, stop) (LSB-first). The output bitmaps arrive
 * zeroed and pages never overlap rows, so whole bytes inside the run
 * can be filled outright. */
static inline void bits_fill(uint8_t *bm, int64_t start, int64_t stop) {
    if (start >= stop) return;
    int64_t first = start >> 3, last = (stop - 1) >> 3;
    uint8_t head = (uint8_t)(0xFFu << (start & 7));
    uint8_t tail = (uint8_t)(0xFFu >> (7 - (int)((stop - 1) & 7)));
    if (first == last) {
        bm[first] |= (uint8_t)(head & tail);
        return;
    }
    bm[first] |= head;
    if (last > first + 1)
        memset(bm + first + 1, 0xFF, (size_t)(last - first - 1));
    bm[last] |= tail;
}

/* ---- value stores ---- */

/* Store one source element (parquet physical layout, LE host) into the
 * output at the engine's item size. Truncating narrows go through
 * unsigned intermediates: well-defined modulo arithmetic that preserves
 * the low bits exactly as Arrow's cast-free reinterpretation does. */
static inline void store_cast(uint8_t *dst, const uint8_t *src, int32_t phys,
                              int32_t out_itemsize) {
    if (phys == PT_INT32) {
        uint32_t v;
        memcpy(&v, src, 4);
        if (out_itemsize == 4) {
            memcpy(dst, &v, 4);
        } else if (out_itemsize == 2) {
            uint16_t w = (uint16_t)v;
            memcpy(dst, &w, 2);
        } else {
            uint8_t b = (uint8_t)v;
            dst[0] = b;
        }
    } else if (phys == PT_INT64) {
        uint64_t v;
        memcpy(&v, src, 8);
        if (out_itemsize == 8) {
            memcpy(dst, &v, 8);
        } else {
            uint32_t w = (uint32_t)v;
            memcpy(dst, &w, 4);
        }
    } else if (phys == PT_DOUBLE) {
        memcpy(dst, src, 8);
    } else { /* PT_FLOAT */
        memcpy(dst, src, 4);
    }
}

static inline int phys_itemsize(int32_t phys) {
    switch (phys) {
        case PT_INT32:
        case PT_FLOAT:
            return 4;
        case PT_INT64:
        case PT_DOUBLE:
            return 8;
        default:
            return 0;
    }
}

/* ---- scratch buffer ---- */

typedef struct {
    uint8_t *p;
    int64_t cap;
} buf_t;

static int buf_reserve(buf_t *b, int64_t need) {
    if (need <= b->cap) return 0;
    int64_t cap = b->cap > 0 ? b->cap : 4096;
    while (cap < need) cap *= 2;
    uint8_t *np = (uint8_t *)realloc(b->p, (size_t)cap);
    if (!np) return PQE_ALLOC;
    b->p = np;
    b->cap = cap;
    return 0;
}

/* ---- per-chunk decode state ---- */

typedef struct {
    int32_t phys;
    int32_t out_itemsize;
    int32_t max_def;
    uint8_t *out_values;
    uint8_t *out_validity;
    int64_t row; /* rows emitted so far */
    /* dictionary (physical-layout values) */
    uint8_t *dict;
    int64_t dict_count;
    /* scratch */
    buf_t page;   /* decompressed page body */
    buf_t defs;   /* def levels as u32 */
    buf_t idx;    /* dictionary indices as u32 */
    int64_t bytes_uncompressed;
} chunk_state_t;

/* Decode the def-level block: fills st->defs.p as u32[nv], returns the
 * number of non-null values (def == max_def) or PQE_*. When max_def is
 * 0 there is no def block and all values are present. */
static int64_t decode_defs(chunk_state_t *st, const uint8_t *block,
                           int64_t block_len, int64_t nv) {
    int rc = buf_reserve(&st->defs, nv * (int64_t)sizeof(uint32_t));
    if (rc < 0) return rc;
    uint32_t *defs = (uint32_t *)st->defs.p;
    if (st->max_def == 0) {
        for (int64_t i = 0; i < nv; i++) defs[i] = 1;
        return nv;
    }
    int64_t used = hybrid_u32(block, block_len, 1, nv, defs);
    if (used < 0) return used;
    int64_t nn = 0;
    for (int64_t i = 0; i < nv; i++) {
        if (defs[i] > 1) return PQE_UNSUPPORTED; /* nested — not proven */
        nn += defs[i];
    }
    return nn;
}

/* OR the page's validity bits in run-sized strokes: consecutive
 * non-null rows become one bits_fill instead of a per-value
 * read-modify-write. */
static void fill_validity(chunk_state_t *st, int64_t nv, int64_t nn) {
    if (!st->out_validity || st->max_def == 0) return;
    if (nn == nv) {
        bits_fill(st->out_validity, st->row, st->row + nv);
        return;
    }
    const uint32_t *defs = (const uint32_t *)st->defs.p;
    int64_t i = 0;
    while (i < nv) {
        if (!defs[i]) {
            i++;
            continue;
        }
        int64_t j = i + 1;
        while (j < nv && defs[j]) j++;
        bits_fill(st->out_validity, st->row + i, st->row + j);
        i = j;
    }
}

/* Set validity bits and write values for one page.
 * `nn` non-null values arrive dense; defs spread them over nv rows.
 * Runs of consecutive non-nulls move as one memcpy (same-width) or a
 * branch-free store_cast loop (narrowing), not a per-value branch. */
static int decode_values_plain(chunk_state_t *st, const uint8_t *vals,
                              int64_t vals_len, int64_t nv, int64_t nn) {
    const uint32_t *defs = (const uint32_t *)st->defs.p;
    int src_size = phys_itemsize(st->phys);
    if (src_size == 0) return PQE_UNSUPPORTED;
    if (vals_len < nn * src_size) return PQE_TRUNCATED;
    uint8_t *out = st->out_values + st->row * st->out_itemsize;
    int same = src_size == st->out_itemsize;
    if (nn == nv && same) {
        memcpy(out, vals, (size_t)(nn * src_size));
    } else {
        int64_t i = 0, t = 0;
        while (i < nv) {
            if (nn != nv && !defs[i]) {
                i++;
                continue;
            }
            int64_t j = nn == nv ? nv : i + 1;
            while (j < nv && defs[j]) j++;
            if (same) {
                memcpy(out + i * src_size, vals + t * src_size,
                       (size_t)((j - i) * src_size));
            } else {
                for (int64_t k = i; k < j; k++)
                    store_cast(out + k * st->out_itemsize,
                               vals + (t + (k - i)) * src_size, st->phys,
                               st->out_itemsize);
            }
            t += j - i;
            i = j;
        }
    }
    fill_validity(st, nv, nn);
    return 0;
}

/* PLAIN boolean: non-null values LSB bit-packed; out is an LSB bitmap. */
static int decode_values_plain_bool(chunk_state_t *st, const uint8_t *vals,
                                    int64_t vals_len, int64_t nv, int64_t nn) {
    const uint32_t *defs = (const uint32_t *)st->defs.p;
    if (vals_len < (nn + 7) / 8) return PQE_TRUNCATED;
    int64_t t = 0;
    for (int64_t i = 0; i < nv; i++) {
        if (nn == nv || defs[i]) {
            if ((vals[t >> 3] >> (t & 7)) & 1) {
                int64_t bit = st->row + i;
                st->out_values[bit >> 3] |= (uint8_t)(1u << (bit & 7));
            }
            t++;
        }
    }
    fill_validity(st, nv, nn);
    return 0;
}

/* RLE boolean values (format 2.x): 4-byte LE length prefix + hybrid
 * stream at bit width 1, one value per non-null slot. */
static int decode_values_rle_bool(chunk_state_t *st, const uint8_t *vals,
                                  int64_t vals_len, int64_t nv, int64_t nn) {
    if (vals_len < 4) return PQE_TRUNCATED;
    uint32_t rle_len = (uint32_t)vals[0] | ((uint32_t)vals[1] << 8) |
                       ((uint32_t)vals[2] << 16) | ((uint32_t)vals[3] << 24);
    if ((int64_t)rle_len > vals_len - 4) return PQE_TRUNCATED;
    int rc = buf_reserve(&st->idx, nn * (int64_t)sizeof(uint32_t));
    if (rc < 0) return rc;
    uint32_t *bits = (uint32_t *)st->idx.p;
    int64_t used = hybrid_u32(vals + 4, (int64_t)rle_len, 1, nn, bits);
    if (used < 0) return (int)used;
    const uint32_t *defs = (const uint32_t *)st->defs.p;
    int64_t t = 0;
    for (int64_t i = 0; i < nv; i++) {
        if (nn == nv || defs[i]) {
            if (bits[t]) {
                int64_t bit = st->row + i;
                st->out_values[bit >> 3] |= (uint8_t)(1u << (bit & 7));
            }
            t++;
        }
    }
    fill_validity(st, nv, nn);
    return 0;
}

/* RLE_DICTIONARY / PLAIN_DICTIONARY data page: 1 bit-width byte +
 * hybrid indices, gathered through the dictionary page's values. */
static int decode_values_dict(chunk_state_t *st, const uint8_t *vals,
                              int64_t vals_len, int64_t nv, int64_t nn) {
    if (!st->dict) return PQE_DICT;
    if (vals_len < 1) return PQE_TRUNCATED;
    int bw = vals[0];
    if (bw > 32) return PQE_UNSUPPORTED;
    int rc = buf_reserve(&st->idx, (nn > 0 ? nn : 1) * (int64_t)sizeof(uint32_t));
    if (rc < 0) return rc;
    uint32_t *idx = (uint32_t *)st->idx.p;
    int64_t used = hybrid_u32(vals + 1, vals_len - 1, bw, nn, idx);
    if (used < 0) return (int)used;
    int src_size = phys_itemsize(st->phys);
    if (src_size == 0) return PQE_UNSUPPORTED;
    /* validate every index up front so the gather loops run unchecked */
    uint32_t maxk = 0;
    for (int64_t i = 0; i < nn; i++)
        if (idx[i] > maxk) maxk = idx[i];
    if (nn > 0 && (int64_t)maxk >= st->dict_count) return PQE_DICT;
    const uint32_t *defs = (const uint32_t *)st->defs.p;
    uint8_t *out = st->out_values + st->row * st->out_itemsize;
    int same = src_size == st->out_itemsize;
    int64_t i = 0, t = 0;
    while (i < nv) {
        if (nn != nv && !defs[i]) {
            i++;
            continue;
        }
        int64_t j = nn == nv ? nv : i + 1;
        while (j < nv && defs[j]) j++;
        int64_t run = j - i;
        if (same && src_size == 8) {
            uint8_t *o = out + i * 8;
            for (int64_t k = 0; k < run; k++)
                memcpy(o + k * 8, st->dict + (int64_t)idx[t + k] * 8, 8);
        } else if (same && src_size == 4) {
            uint8_t *o = out + i * 4;
            for (int64_t k = 0; k < run; k++)
                memcpy(o + k * 4, st->dict + (int64_t)idx[t + k] * 4, 4);
        } else {
            for (int64_t k = 0; k < run; k++)
                store_cast(out + (i + k) * st->out_itemsize,
                           st->dict + (int64_t)idx[t + k] * src_size,
                           st->phys, st->out_itemsize);
        }
        t += run;
        i = j;
    }
    fill_validity(st, nv, nn);
    return 0;
}

static int decode_page_values(chunk_state_t *st, int32_t encoding,
                              const uint8_t *vals, int64_t vals_len,
                              int64_t nv, int64_t nn) {
    if (st->phys == PT_BOOLEAN) {
        if (encoding == ENC_PLAIN)
            return decode_values_plain_bool(st, vals, vals_len, nv, nn);
        if (encoding == ENC_RLE)
            return decode_values_rle_bool(st, vals, vals_len, nv, nn);
        return PQE_UNSUPPORTED;
    }
    if (encoding == ENC_PLAIN)
        return decode_values_plain(st, vals, vals_len, nv, nn);
    if (encoding == ENC_RLE_DICT || encoding == ENC_PLAIN_DICT)
        return decode_values_dict(st, vals, vals_len, nv, nn);
    return PQE_UNSUPPORTED;
}

/* ---- entry point ----
 *
 * chunk/chunk_len: the column chunk's byte range (dict page first when
 * present, then data pages back to back).
 * phys: parquet physical type enum. codec: chunk compression codec.
 * out_itemsize: engine dtype width (booleans: out_values is a bitmap).
 * max_def: 0 (required) or 1 (optional). num_values: footer row count.
 * out_values/out_validity: caller-zeroed buffers (validity may be NULL
 * when max_def == 0). out_info: [0]=pages, [1]=uncompressed bytes,
 * [2]=dict entries.
 *
 * Returns the chunk null count (>= 0) or a negative PQE_* error.
 */
int64_t pq_decode_chunk(const uint8_t *chunk, int64_t chunk_len, int32_t phys,
                        int32_t codec, int32_t out_itemsize, int32_t max_def,
                        int64_t num_values, uint8_t *out_values,
                        uint8_t *out_validity, int64_t *out_info) {
    if (!chunk || chunk_len < 0 || !out_values || num_values < 0)
        return PQE_UNSUPPORTED;
    if (max_def < 0 || max_def > 1) return PQE_UNSUPPORTED;
    if (max_def == 1 && !out_validity) return PQE_UNSUPPORTED;
    if (codec != CODEC_NONE && codec != CODEC_SNAPPY && codec != CODEC_ZSTD)
        return PQE_CODEC;
    if (phys != PT_BOOLEAN && phys_itemsize(phys) == 0) return PQE_UNSUPPORTED;

    chunk_state_t st;
    memset(&st, 0, sizeof(st));
    st.phys = phys;
    st.out_itemsize = out_itemsize;
    st.max_def = max_def;
    st.out_values = out_values;
    st.out_validity = out_validity;

    int64_t pages = 0;
    int64_t nulls = 0;
    int64_t rc = 0;
    const uint8_t *p = chunk;
    const uint8_t *chunk_end = chunk + chunk_len;

    while (p < chunk_end && st.row < num_values) {
        tin_t t = {p, chunk_end, 0};
        page_header_t h;
        int hrc = parse_page_header(&t, &h);
        if (hrc < 0) {
            rc = hrc;
            goto done;
        }
        const uint8_t *body = t.p;
        if (chunk_end - body < h.compressed_size) {
            rc = PQE_TRUNCATED;
            goto done;
        }
        p = body + h.compressed_size;
        pages++;

        if (h.page_type == PAGE_INDEX) continue;

        if (h.page_type == PAGE_DICT) {
            if (st.dict) { /* second dictionary page: malformed */
                rc = PQE_DICT;
                goto done;
            }
            if (phys == PT_BOOLEAN ||
                (h.dict_encoding != ENC_PLAIN &&
                 h.dict_encoding != ENC_PLAIN_DICT)) {
                rc = PQE_UNSUPPORTED;
                goto done;
            }
            if (h.dict_num_values < 0) {
                rc = PQE_THRIFT;
                goto done;
            }
            int src_size = phys_itemsize(phys);
            /* divide instead of multiply: dict_num_values * src_size can
             * wrap past int64 on corrupt headers and slip under
             * uncompressed_size. uncompressed_size is already bounded to
             * [0, MAX_PAGE_BYTES] by parse_page_header, so this also caps
             * dict_num_values (and the malloc below) at MAX_PAGE_BYTES. */
            if (h.dict_num_values > h.uncompressed_size / src_size) {
                rc = PQE_SIZE;
                goto done;
            }
            const uint8_t *data;
            if (codec == CODEC_NONE) {
                if (h.compressed_size != h.uncompressed_size) {
                    rc = PQE_SIZE;
                    goto done;
                }
                data = body;
            } else {
                int brc = buf_reserve(&st.page, h.uncompressed_size);
                if (brc < 0) {
                    rc = brc;
                    goto done;
                }
                int drc = pq_decompress(codec, body, h.compressed_size,
                                        st.page.p, h.uncompressed_size);
                if (drc < 0) {
                    rc = drc;
                    goto done;
                }
                data = st.page.p;
            }
            st.dict_count = h.dict_num_values;
            if (st.dict_count > 0) {
                st.dict = (uint8_t *)malloc((size_t)(st.dict_count * src_size));
                if (!st.dict) {
                    rc = PQE_ALLOC;
                    goto done;
                }
                memcpy(st.dict, data, (size_t)(st.dict_count * src_size));
            }
            st.bytes_uncompressed += h.uncompressed_size;
            continue;
        }

        if (h.page_type == PAGE_DATA) {
            if (h.num_values < 0 || h.encoding < 0) {
                rc = PQE_THRIFT;
                goto done;
            }
            int64_t nv = h.num_values;
            if (st.row + nv > num_values) {
                rc = PQE_ROWS;
                goto done;
            }
            const uint8_t *data;
            if (codec == CODEC_NONE) {
                if (h.compressed_size != h.uncompressed_size) {
                    rc = PQE_SIZE;
                    goto done;
                }
                data = body;
            } else {
                int brc = buf_reserve(&st.page, h.uncompressed_size);
                if (brc < 0) {
                    rc = brc;
                    goto done;
                }
                int drc = pq_decompress(codec, body, h.compressed_size,
                                        st.page.p, h.uncompressed_size);
                if (drc < 0) {
                    rc = drc;
                    goto done;
                }
                data = st.page.p;
            }
            int64_t data_len = h.uncompressed_size;
            const uint8_t *vals = data;
            int64_t vals_len = data_len;
            if (max_def > 0) {
                if (h.def_encoding != ENC_RLE) {
                    rc = PQE_UNSUPPORTED;
                    goto done;
                }
                if (data_len < 4) {
                    rc = PQE_TRUNCATED;
                    goto done;
                }
                uint32_t dl = (uint32_t)data[0] | ((uint32_t)data[1] << 8) |
                              ((uint32_t)data[2] << 16) |
                              ((uint32_t)data[3] << 24);
                if ((int64_t)dl > data_len - 4) {
                    rc = PQE_TRUNCATED;
                    goto done;
                }
                int64_t nn = decode_defs(&st, data + 4, (int64_t)dl, nv);
                if (nn < 0) {
                    rc = nn;
                    goto done;
                }
                nulls += nv - nn;
                vals = data + 4 + dl;
                vals_len = data_len - 4 - (int64_t)dl;
                int vrc = decode_page_values(&st, h.encoding, vals, vals_len,
                                             nv, nn);
                if (vrc < 0) {
                    rc = vrc;
                    goto done;
                }
            } else {
                int64_t nn = decode_defs(&st, NULL, 0, nv);
                if (nn < 0) {
                    rc = nn;
                    goto done;
                }
                int vrc = decode_page_values(&st, h.encoding, vals, vals_len,
                                             nv, nn);
                if (vrc < 0) {
                    rc = vrc;
                    goto done;
                }
            }
            st.row += nv;
            st.bytes_uncompressed += h.uncompressed_size;
            continue;
        }

        if (h.page_type == PAGE_DATA_V2) {
            if (h.v2_num_values < 0 || h.v2_encoding < 0 || h.v2_dl_len < 0 ||
                h.v2_rl_len < 0) {
                rc = PQE_THRIFT;
                goto done;
            }
            if (h.v2_rl_len != 0) { /* repeated fields — not proven */
                rc = PQE_UNSUPPORTED;
                goto done;
            }
            int64_t nv = h.v2_num_values;
            if (st.row + nv > num_values) {
                rc = PQE_ROWS;
                goto done;
            }
            int64_t lvl_len = h.v2_dl_len;
            if (lvl_len > h.compressed_size || lvl_len > h.uncompressed_size) {
                rc = PQE_TRUNCATED;
                goto done;
            }
            /* v2: levels sit uncompressed at the front of the body with
             * no length prefix; only the values region is compressed. */
            int64_t nn;
            if (max_def > 0) {
                nn = decode_defs(&st, body, lvl_len, nv);
                if (nn < 0) {
                    rc = nn;
                    goto done;
                }
            } else {
                if (lvl_len != 0) {
                    rc = PQE_UNSUPPORTED;
                    goto done;
                }
                nn = decode_defs(&st, NULL, 0, nv);
                if (nn < 0) {
                    rc = nn;
                    goto done;
                }
            }
            nulls += nv - nn;
            const uint8_t *vsrc = body + lvl_len;
            int64_t vsrc_len = h.compressed_size - lvl_len;
            int64_t vdst_len = h.uncompressed_size - lvl_len;
            if (vdst_len < 0) {
                rc = PQE_SIZE;
                goto done;
            }
            const uint8_t *vals;
            if (h.v2_is_compressed && codec != CODEC_NONE) {
                int brc = buf_reserve(&st.page, vdst_len > 0 ? vdst_len : 1);
                if (brc < 0) {
                    rc = brc;
                    goto done;
                }
                int drc = pq_decompress(codec, vsrc, vsrc_len, st.page.p,
                                        vdst_len);
                if (drc < 0) {
                    rc = drc;
                    goto done;
                }
                vals = st.page.p;
            } else {
                if (vsrc_len != vdst_len) {
                    rc = PQE_SIZE;
                    goto done;
                }
                vals = vsrc;
            }
            int vrc = decode_page_values(&st, h.v2_encoding, vals, vdst_len,
                                         nv, nn);
            if (vrc < 0) {
                rc = vrc;
                goto done;
            }
            st.row += nv;
            st.bytes_uncompressed += h.uncompressed_size;
            continue;
        }

        /* unknown page type */
        rc = PQE_UNSUPPORTED;
        goto done;
    }

    if (st.row != num_values) {
        rc = PQE_ROWS;
        goto done;
    }
    rc = nulls;

done:
    if (out_info) {
        out_info[0] = pages;
        out_info[1] = st.bytes_uncompressed;
        out_info[2] = st.dict_count;
    }
    free(st.dict);
    free(st.page.p);
    free(st.defs.p);
    free(st.idx.p);
    return rc;
}

/* ---- encoded-run output mode ----
 *
 * pq_decode_chunk_runs() walks the same page structure but never
 * expands to row width: dictionary-coded value streams come out as
 * coalesced (run_length, dict_code) pairs and definition levels as
 * (run_length, present) pairs, straight off the RLE/bit-packed hybrid
 * stream. Scope is narrower than pq_decode_chunk on purpose — every
 * data page must be RLE_DICTIONARY/PLAIN_DICTIONARY (a PLAIN data page,
 * e.g. a dictionary fallback mid-chunk, fails closed with
 * PQE_UNSUPPORTED and the Python layer re-decodes at row width).
 * Adjacent equal codes coalesce across page boundaries, so n_runs never
 * exceeds the non-null value count and n_defs never exceeds num_values
 * — the caller sizes the output arrays from the footer row count.
 */

typedef struct {
    int64_t *run_len;  /* coalesced non-null value runs */
    uint32_t *run_code;
    int64_t cap_runs;
    int64_t n_runs;
    int64_t *def_len;  /* coalesced definition-level runs */
    uint8_t *def_val;  /* 0 = null rows, 1 = present rows */
    int64_t cap_defs;
    int64_t n_defs;
    int64_t nn;        /* non-null rows accumulated via defs_push */
} runs_out_t;

static int runs_push(runs_out_t *r, int64_t len, uint32_t code) {
    if (len <= 0) return PQE_THRIFT;
    if (r->n_runs > 0 && r->run_code[r->n_runs - 1] == code) {
        r->run_len[r->n_runs - 1] += len;
        return 0;
    }
    if (r->n_runs >= r->cap_runs) return PQE_SIZE;
    r->run_len[r->n_runs] = len;
    r->run_code[r->n_runs] = code;
    r->n_runs++;
    return 0;
}

static int defs_push(runs_out_t *r, int64_t len, uint32_t val) {
    if (len <= 0) return PQE_THRIFT;
    if (val) r->nn += len;
    if (r->n_defs > 0 && r->def_val[r->n_defs - 1] == (uint8_t)val) {
        r->def_len[r->n_defs - 1] += len;
        return 0;
    }
    if (r->n_defs >= r->cap_defs) return PQE_SIZE;
    r->def_len[r->n_defs] = len;
    r->def_val[r->n_defs] = (uint8_t)val;
    r->n_defs++;
    return 0;
}

/* Decode exactly `count` entries of an RLE/bit-packed hybrid stream as
 * runs. An RLE run becomes one push; bit-packed groups unpack through
 * the same unpack8 the row path uses and push per value (coalescing
 * absorbs repeats). Every value must be < `bound`: dict codes check
 * against the dictionary size (PQE_DICT), def levels against
 * max_def + 1 (PQE_UNSUPPORTED — nested schema, not proven). Returns
 * bytes consumed or PQE_*. */
static int64_t hybrid_to_runs(const uint8_t *in, int64_t in_len, int bw,
                              int64_t count, uint32_t bound, runs_out_t *r,
                              int to_defs) {
    if (bw < 0 || bw > 32) return PQE_UNSUPPORTED;
    if (count == 0) return 0;
    if (bw == 0) {
        if (bound == 0) return to_defs ? PQE_UNSUPPORTED : PQE_DICT;
        int rc = to_defs ? defs_push(r, count, 0) : runs_push(r, count, 0);
        if (rc < 0) return rc;
        return 0;
    }
    tin_t t = {in, in + in_len, 0};
    int64_t got = 0;
    int vbytes = (bw + 7) >> 3;
    while (got < count) {
        uint64_t header = t_uvarint(&t);
        if (t.err) return PQE_TRUNCATED;
        if ((header & 1) == 0) {
            int64_t run = (int64_t)(header >> 1);
            if (run <= 0) return PQE_THRIFT;
            if ((uint64_t)(t.end - t.p) < (uint64_t)vbytes)
                return PQE_TRUNCATED;
            uint32_t v = 0;
            for (int i = 0; i < vbytes; i++) v |= (uint32_t)t.p[i] << (8 * i);
            t.p += vbytes;
            if (bw < 32) v &= (uint32_t)(((uint64_t)1 << bw) - 1);
            if (v >= bound) return to_defs ? PQE_UNSUPPORTED : PQE_DICT;
            int64_t take = run < count - got ? run : count - got;
            int rc = to_defs ? defs_push(r, take, v) : runs_push(r, take, v);
            if (rc < 0) return rc;
            got += take;
        } else {
            int64_t groups = (int64_t)(header >> 1);
            if (groups <= 0) return PQE_THRIFT;
            /* same pre-multiplication bound as hybrid_u32: groups is a
             * raw varint and could overflow nvals/nbytes otherwise */
            if (groups > (int64_t)(t.end - t.p)) return PQE_TRUNCATED;
            int64_t nvals = groups * 8;
            int64_t nbytes = groups * bw;
            if ((int64_t)(t.end - t.p) < nbytes) return PQE_TRUNCATED;
            int64_t take = nvals < count - got ? nvals : count - got;
            const uint8_t *gp = t.p;
            int64_t done = 0;
            while (done < take) {
                uint32_t tmp[8];
                gp = unpack8(gp, bw, tmp);
                int64_t m = take - done < 8 ? take - done : 8;
                for (int64_t i = 0; i < m; i++) {
                    uint32_t v = tmp[i];
                    if (v >= bound)
                        return to_defs ? PQE_UNSUPPORTED : PQE_DICT;
                    int rc = to_defs ? defs_push(r, 1, v) : runs_push(r, 1, v);
                    if (rc < 0) return rc;
                }
                done += m;
            }
            t.p += nbytes;
            got += take;
        }
    }
    return (int64_t)(t.p - in);
}

/* Entry point for the encoded-run mode.
 *
 * chunk/chunk_len, phys, codec, max_def, num_values: as pq_decode_chunk
 * (booleans are out of scope — their pages are not dictionary-coded).
 * out_dict: caller buffer for cap_dict dictionary entries in PHYSICAL
 * layout (phys_itemsize bytes each; a dictionary larger than cap_dict
 * fails with PQE_SIZE so the planner's entry bound is enforced here).
 * run_len/run_code: caller buffers for cap_runs coalesced value runs.
 * def_len/def_val: caller buffers for cap_defs coalesced def runs.
 * out_info: [0]=pages, [1]=uncompressed bytes, [2]=dict entries,
 * [3]=n_runs, [4]=n_defs.
 *
 * Returns the chunk null count (>= 0) or a negative PQE_* error.
 */
int64_t pq_decode_chunk_runs(const uint8_t *chunk, int64_t chunk_len,
                             int32_t phys, int32_t codec, int32_t max_def,
                             int64_t num_values, uint8_t *out_dict,
                             int64_t cap_dict, int64_t *run_len,
                             uint32_t *run_code, int64_t cap_runs,
                             int64_t *def_len, uint8_t *def_val,
                             int64_t cap_defs, int64_t *out_info) {
    if (!chunk || chunk_len < 0 || num_values < 0 || !out_dict || !run_len ||
        !run_code || !def_len || !def_val || cap_dict < 0)
        return PQE_UNSUPPORTED;
    if (max_def < 0 || max_def > 1) return PQE_UNSUPPORTED;
    if (codec != CODEC_NONE && codec != CODEC_SNAPPY && codec != CODEC_ZSTD)
        return PQE_CODEC;
    int src_size = phys_itemsize(phys);
    if (src_size == 0) return PQE_UNSUPPORTED; /* incl. PT_BOOLEAN */

    runs_out_t r;
    memset(&r, 0, sizeof(r));
    r.run_len = run_len;
    r.run_code = run_code;
    r.cap_runs = cap_runs;
    r.def_len = def_len;
    r.def_val = def_val;
    r.cap_defs = cap_defs;

    buf_t page;
    memset(&page, 0, sizeof(page));
    int64_t dict_count = 0;
    int saw_dict = 0;
    int64_t pages = 0;
    int64_t bytes_uncompressed = 0;
    int64_t row = 0;
    int64_t nulls = 0;
    int64_t rc = 0;
    const uint8_t *p = chunk;
    const uint8_t *chunk_end = chunk + chunk_len;

    while (p < chunk_end && row < num_values) {
        tin_t t = {p, chunk_end, 0};
        page_header_t h;
        int hrc = parse_page_header(&t, &h);
        if (hrc < 0) {
            rc = hrc;
            goto done;
        }
        const uint8_t *body = t.p;
        if (chunk_end - body < h.compressed_size) {
            rc = PQE_TRUNCATED;
            goto done;
        }
        p = body + h.compressed_size;
        pages++;

        if (h.page_type == PAGE_INDEX) continue;

        if (h.page_type == PAGE_DICT) {
            if (saw_dict) {
                rc = PQE_DICT;
                goto done;
            }
            if (h.dict_encoding != ENC_PLAIN &&
                h.dict_encoding != ENC_PLAIN_DICT) {
                rc = PQE_UNSUPPORTED;
                goto done;
            }
            if (h.dict_num_values < 0) {
                rc = PQE_THRIFT;
                goto done;
            }
            /* same wrap-proof divide bound as the row path */
            if (h.dict_num_values > h.uncompressed_size / src_size) {
                rc = PQE_SIZE;
                goto done;
            }
            if (h.dict_num_values > cap_dict) {
                rc = PQE_SIZE; /* planner's dictionary-entry bound */
                goto done;
            }
            const uint8_t *data;
            if (codec == CODEC_NONE) {
                if (h.compressed_size != h.uncompressed_size) {
                    rc = PQE_SIZE;
                    goto done;
                }
                data = body;
            } else {
                int brc = buf_reserve(&page, h.uncompressed_size);
                if (brc < 0) {
                    rc = brc;
                    goto done;
                }
                int drc = pq_decompress(codec, body, h.compressed_size,
                                        page.p, h.uncompressed_size);
                if (drc < 0) {
                    rc = drc;
                    goto done;
                }
                data = page.p;
            }
            dict_count = h.dict_num_values;
            saw_dict = 1;
            if (dict_count > 0)
                memcpy(out_dict, data, (size_t)(dict_count * src_size));
            bytes_uncompressed += h.uncompressed_size;
            continue;
        }

        if (h.page_type == PAGE_DATA) {
            if (h.num_values < 0 || h.encoding < 0) {
                rc = PQE_THRIFT;
                goto done;
            }
            if (h.encoding != ENC_RLE_DICT && h.encoding != ENC_PLAIN_DICT) {
                rc = PQE_UNSUPPORTED; /* plain data page: fail closed */
                goto done;
            }
            if (dict_count <= 0) {
                rc = PQE_DICT;
                goto done;
            }
            int64_t nv = h.num_values;
            if (row + nv > num_values) {
                rc = PQE_ROWS;
                goto done;
            }
            const uint8_t *data;
            if (codec == CODEC_NONE) {
                if (h.compressed_size != h.uncompressed_size) {
                    rc = PQE_SIZE;
                    goto done;
                }
                data = body;
            } else {
                int brc = buf_reserve(&page, h.uncompressed_size);
                if (brc < 0) {
                    rc = brc;
                    goto done;
                }
                int drc = pq_decompress(codec, body, h.compressed_size,
                                        page.p, h.uncompressed_size);
                if (drc < 0) {
                    rc = drc;
                    goto done;
                }
                data = page.p;
            }
            int64_t data_len = h.uncompressed_size;
            const uint8_t *vals = data;
            int64_t vals_len = data_len;
            int64_t nn = nv;
            if (max_def > 0) {
                if (h.def_encoding != ENC_RLE) {
                    rc = PQE_UNSUPPORTED;
                    goto done;
                }
                if (data_len < 4) {
                    rc = PQE_TRUNCATED;
                    goto done;
                }
                uint32_t dl = (uint32_t)data[0] | ((uint32_t)data[1] << 8) |
                              ((uint32_t)data[2] << 16) |
                              ((uint32_t)data[3] << 24);
                if ((int64_t)dl > data_len - 4) {
                    rc = PQE_TRUNCATED;
                    goto done;
                }
                int64_t nn_before = r.nn;
                int64_t drc = hybrid_to_runs(data + 4, (int64_t)dl, 1, nv,
                                             (uint32_t)(max_def + 1), &r, 1);
                if (drc < 0) {
                    rc = drc;
                    goto done;
                }
                nn = r.nn - nn_before;
                vals = data + 4 + dl;
                vals_len = data_len - 4 - (int64_t)dl;
            } else {
                int drc = defs_push(&r, nv, 1);
                if (drc < 0) {
                    rc = drc;
                    goto done;
                }
            }
            nulls += nv - nn;
            if (vals_len < 1) {
                rc = PQE_TRUNCATED;
                goto done;
            }
            int bw = vals[0];
            int64_t vrc = hybrid_to_runs(vals + 1, vals_len - 1, bw, nn,
                                         (uint32_t)dict_count, &r, 0);
            if (vrc < 0) {
                rc = vrc;
                goto done;
            }
            row += nv;
            bytes_uncompressed += h.uncompressed_size;
            continue;
        }

        if (h.page_type == PAGE_DATA_V2) {
            if (h.v2_num_values < 0 || h.v2_encoding < 0 || h.v2_dl_len < 0 ||
                h.v2_rl_len < 0) {
                rc = PQE_THRIFT;
                goto done;
            }
            if (h.v2_rl_len != 0) {
                rc = PQE_UNSUPPORTED;
                goto done;
            }
            if (h.v2_encoding != ENC_RLE_DICT &&
                h.v2_encoding != ENC_PLAIN_DICT) {
                rc = PQE_UNSUPPORTED;
                goto done;
            }
            if (dict_count <= 0) {
                rc = PQE_DICT;
                goto done;
            }
            int64_t nv = h.v2_num_values;
            if (row + nv > num_values) {
                rc = PQE_ROWS;
                goto done;
            }
            int64_t lvl_len = h.v2_dl_len;
            if (lvl_len > h.compressed_size || lvl_len > h.uncompressed_size) {
                rc = PQE_TRUNCATED;
                goto done;
            }
            int64_t nn = nv;
            if (max_def > 0) {
                int64_t nn_before = r.nn;
                int64_t drc = hybrid_to_runs(body, lvl_len, 1, nv,
                                             (uint32_t)(max_def + 1), &r, 1);
                if (drc < 0) {
                    rc = drc;
                    goto done;
                }
                nn = r.nn - nn_before;
            } else {
                if (lvl_len != 0) {
                    rc = PQE_UNSUPPORTED;
                    goto done;
                }
                int drc = defs_push(&r, nv, 1);
                if (drc < 0) {
                    rc = drc;
                    goto done;
                }
            }
            nulls += nv - nn;
            const uint8_t *vsrc = body + lvl_len;
            int64_t vsrc_len = h.compressed_size - lvl_len;
            int64_t vdst_len = h.uncompressed_size - lvl_len;
            if (vdst_len < 0) {
                rc = PQE_SIZE;
                goto done;
            }
            const uint8_t *vals;
            if (h.v2_is_compressed && codec != CODEC_NONE) {
                int brc = buf_reserve(&page, vdst_len > 0 ? vdst_len : 1);
                if (brc < 0) {
                    rc = brc;
                    goto done;
                }
                int drc = pq_decompress(codec, vsrc, vsrc_len, page.p,
                                        vdst_len);
                if (drc < 0) {
                    rc = drc;
                    goto done;
                }
                vals = page.p;
            } else {
                if (vsrc_len != vdst_len) {
                    rc = PQE_SIZE;
                    goto done;
                }
                vals = vsrc;
            }
            if (vdst_len < 1) {
                rc = PQE_TRUNCATED;
                goto done;
            }
            int bw = vals[0];
            int64_t vrc = hybrid_to_runs(vals + 1, vdst_len - 1, bw, nn,
                                         (uint32_t)dict_count, &r, 0);
            if (vrc < 0) {
                rc = vrc;
                goto done;
            }
            row += nv;
            bytes_uncompressed += h.uncompressed_size;
            continue;
        }

        rc = PQE_UNSUPPORTED;
        goto done;
    }

    if (row != num_values) {
        rc = PQE_ROWS;
        goto done;
    }
    rc = nulls;

done:
    if (out_info) {
        out_info[0] = pages;
        out_info[1] = bytes_uncompressed;
        out_info[2] = dict_count;
        out_info[3] = r.n_runs;
        out_info[4] = r.n_defs;
    }
    free(page.p);
    return rc;
}
