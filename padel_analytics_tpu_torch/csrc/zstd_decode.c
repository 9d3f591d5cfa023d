/* A Zstandard frame decoder (RFC 8878), with the CRC-32C of OCDBT files.
 *
 * The host side of the checkpoint reader (core/ocdbt.py, core/zarr.py):
 * every OCDBT manifest and B+tree node, and every zarr chunk the JAX
 * package's orbax writes, is a zstd frame. Built by the host C compiler at
 * first use (padel_analytics_tpu_torch/_build.py::host_library); a plain C
 * interface for ctypes, no library.
 *
 * Covered: raw, RLE and compressed blocks; raw, RLE, compressed and treeless
 * literals; Huffman tables with FSE-coded or direct weights; 1- and 4-stream
 * literals; predefined, RLE, FSE-compressed and repeat sequence modes; the
 * three repeat offsets; the window descriptor and the block size it bounds;
 * the frame content size; the XXH64 content checksum; skippable frames and
 * concatenated frames. Dictionaries are refused (ZD_E_DICT).
 *
 * Every read of the input and every write of the output is bounds-checked:
 * a malformed frame returns a negative code, never touches memory outside
 * [src, src + src_len) and [dst, dst + cap).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "zstd_decode.c assumes a little-endian host"
#endif

enum {
    ZD_E_MAGIC = -1,     /* not a zstd frame (bad magic number) */
    ZD_E_RESERVED = -2,  /* a reserved bit or block type is set */
    ZD_E_TRUNCATED = -3, /* the input ends inside a frame */
    ZD_E_TABLE = -4,     /* a bad FSE or Huffman table */
    ZD_E_CORRUPT = -5,   /* a bitstream, length or offset that does not fit */
    ZD_E_CHECKSUM = -6,  /* the content checksum does not match */
    ZD_E_DST_SMALL = -7, /* the output does not fit in cap */
    ZD_E_DICT = -8,      /* the frame needs a dictionary */
    ZD_E_WINDOW = -9,    /* the window is larger than this decoder takes */
    ZD_E_SIZE = -10,     /* the content size differs from the header's */
    ZD_E_NOMEM = -11,    /* malloc failed */
};

#define ZD_BLOCK_MAX (128 * 1024)
#define ZD_WINDOW_MAX ((uint64_t)1 << 31)
#define ZD_HUF_LOG_MAX 12
#define ZD_FSE_LOG_MAX 9

static int highbit32(uint32_t v) { return 31 - __builtin_clz(v); } /* v > 0 */

static uint32_t rd16(const uint8_t *p) { return (uint32_t)p[0] | ((uint32_t)p[1] << 8); }
static uint32_t rd24(const uint8_t *p) { return rd16(p) | ((uint32_t)p[2] << 16); }
static uint32_t rd32(const uint8_t *p) { return rd16(p) | (rd16(p + 2) << 16); }
static uint64_t rd64(const uint8_t *p) { return (uint64_t)rd32(p) | ((uint64_t)rd32(p + 4) << 32); }

/* ------------------------------------------------------------------ checks */

uint32_t zd_crc32c(const uint8_t *p, int64_t n) {
    uint32_t table[256];
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
        table[i] = c;
    }
    uint32_t crc = 0xFFFFFFFFu;
    for (int64_t i = 0; i < n; i++) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

#define P1 11400714785074694791ULL
#define P2 14029467366897019727ULL
#define P3 1609587929392839161ULL
#define P4 9650029242287828579ULL
#define P5 2870177450012600261ULL

static uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static uint64_t xxh_round(uint64_t acc, uint64_t lane) { return rotl64(acc + lane * P2, 31) * P1; }
static uint64_t xxh_merge(uint64_t h, uint64_t v) { return (h ^ xxh_round(0, v)) * P1 + P4; }

uint64_t zd_xxh64(const uint8_t *p, int64_t n, uint64_t seed) {
    const uint8_t *end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        while (end - p >= 32) {
            v1 = xxh_round(v1, rd64(p));
            v2 = xxh_round(v2, rd64(p + 8));
            v3 = xxh_round(v3, rd64(p + 16));
            v4 = xxh_round(v4, rd64(p + 24));
            p += 32;
        }
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = seed + P5;
    }
    h += (uint64_t)n;
    while (end - p >= 8) {
        h ^= xxh_round(0, rd64(p));
        h = rotl64(h, 27) * P1 + P4;
        p += 8;
    }
    if (end - p >= 4) {
        h ^= (uint64_t)rd32(p) * P1;
        h = rotl64(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (uint64_t)(*p++) * P5;
        h = rotl64(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

/* ------------------------------------------------------------- bitstreams */

/* Bits [pos, pos + nb) of p[0, n), bit i being (p[i >> 3] >> (i & 7)) & 1;
 * bits outside [0, 8n) read as 0. nb <= 56. */
static uint64_t get_bits(const uint8_t *p, int64_t n, int64_t pos, int nb) {
    if (nb == 0) return 0;
    uint64_t mask = ((uint64_t)1 << nb) - 1;
    int64_t lo = pos < 0 ? 0 : pos;
    int64_t byte = lo >> 3;
    uint64_t w = 0;
    if (byte + 8 <= n) {
        memcpy(&w, p + byte, 8);
    } else if (byte < n) {
        memcpy(&w, p + byte, (size_t)(n - byte));
    }
    w >>= (lo & 7);
    if (pos < 0) {
        int64_t shift = -pos;
        if (shift >= nb) return 0;
        w <<= shift;
    }
    return w & mask;
}

/* A backward bitstream (FSE and Huffman): read from its last bit down. */
typedef struct {
    const uint8_t *p;
    int64_t n;
    int64_t pos; /* bits left; < 0 once more were read than the stream has */
} bitrev;

static int bitrev_init(bitrev *b, const uint8_t *p, int64_t n) {
    if (n <= 0) return ZD_E_CORRUPT;
    if (p[n - 1] == 0) return ZD_E_CORRUPT; /* no end marker */
    b->p = p;
    b->n = n;
    b->pos = (n - 1) * 8 + highbit32(p[n - 1]);
    return 0;
}

static uint32_t bitrev_read(bitrev *b, int nb) {
    b->pos -= nb;
    return (uint32_t)get_bits(b->p, b->n, b->pos, nb);
}

/* ------------------------------------------------------------------- FSE */

typedef struct {
    uint16_t base; /* the next state's baseline */
    uint8_t sym;
    uint8_t nb; /* bits to read for the next state */
} fse_entry;

/* Read an FSE table description (RFC 8878 4.1.1) from p[0, n): the
 * normalized counts of symbols 0..*max_sym, into norm; returns the bytes
 * used or a negative code. On return *max_sym is the last symbol read. */
static int64_t fse_read_ncount(const uint8_t *p, int64_t n, int16_t *norm, int *max_sym,
                               int *log_out, int log_max) {
    if (n < 1) return ZD_E_TRUNCATED;
    int64_t bit = 0;
    int log = (int)get_bits(p, n, 0, 4) + 5;
    bit = 4;
    if (log > log_max) return ZD_E_TABLE;
    int remaining = (1 << log) + 1;
    int threshold = 1 << log;
    int nbits = log + 1;
    int sym = 0;
    int prev0 = 0;
    int limit = *max_sym;
    while (remaining > 1 && sym <= limit) {
        if (prev0) {
            int rep;
            do {
                rep = (int)get_bits(p, n, bit, 2);
                bit += 2;
                for (int k = 0; k < rep; k++) {
                    if (sym > limit) return ZD_E_TABLE;
                    norm[sym++] = 0;
                }
                if (bit > 8 * n) return ZD_E_TRUNCATED;
            } while (rep == 3);
            if (sym > limit) return ZD_E_TABLE;
        }
        int max = (2 * threshold - 1) - remaining;
        int count;
        uint32_t v = (uint32_t)get_bits(p, n, bit, nbits);
        if ((int)(v & (threshold - 1)) < max) {
            count = (int)(v & (threshold - 1));
            bit += nbits - 1;
        } else {
            count = (int)(v & (2 * threshold - 1));
            if (count >= threshold) count -= max;
            bit += nbits;
        }
        if (bit > 8 * n) return ZD_E_TRUNCATED;
        count--;
        remaining -= count < 0 ? -count : count;
        if (remaining < 1) return ZD_E_TABLE;
        norm[sym++] = (int16_t)count;
        prev0 = count == 0;
        while (remaining < threshold) {
            nbits--;
            threshold >>= 1;
        }
    }
    if (remaining != 1) return ZD_E_TABLE;
    *max_sym = sym - 1;
    *log_out = log;
    return (bit + 7) >> 3;
}

/* The decoding table of the normalized counts norm[0..max_sym] (sum
 * 1 << log, -1 being "less than 1"). */
static int fse_build(fse_entry *t, const int16_t *norm, int max_sym, int log) {
    int size = 1 << log;
    int high = size - 1;
    uint16_t next[256];
    int total = 0;
    for (int s = 0; s <= max_sym; s++) {
        if (norm[s] == -1) {
            if (high < 0) return ZD_E_TABLE;
            t[high--].sym = (uint8_t)s;
            next[s] = 1;
            total += 1;
        } else {
            if (norm[s] < 0) return ZD_E_TABLE;
            next[s] = (uint16_t)norm[s];
            total += norm[s];
        }
    }
    if (total != size) return ZD_E_TABLE;
    int step = (size >> 1) + (size >> 3) + 3;
    int mask = size - 1;
    int pos = 0;
    for (int s = 0; s <= max_sym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            t[pos].sym = (uint8_t)s;
            do {
                pos = (pos + step) & mask;
            } while (pos > high);
        }
    }
    if (pos != 0) return ZD_E_TABLE;
    for (int u = 0; u < size; u++) {
        int s = t[u].sym;
        uint32_t ns = next[s]++;
        int nb = log - highbit32(ns);
        t[u].nb = (uint8_t)nb;
        t[u].base = (uint16_t)((ns << nb) - (uint32_t)size);
    }
    return 0;
}

/* ------------------------------------------------------------- sequences */

static const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

typedef struct {
    fse_entry t[1 << ZD_FSE_LOG_MAX];
    int log;
    int ready; /* a table was set in this frame (for the repeat mode) */
} seq_table;

typedef struct {
    uint8_t sym;
    uint8_t nb;
} huf_entry;

typedef struct {
    seq_table ll, of, ml;
    huf_entry huf[1 << ZD_HUF_LOG_MAX];
    int huf_log;
    int huf_ready;
    uint64_t rep[3];
    uint8_t *lit; /* ZD_BLOCK_MAX bytes */
    int64_t block_max;
    uint64_t window;
} zctx;

/* One of the three sequence tables from its mode (RFC 8878 3.1.1.3.2.1):
 * returns the bytes of p[0, n) used or a negative code. */
static int64_t seq_table_read(seq_table *st, int mode, const uint8_t *p, int64_t n,
                              const int16_t *dflt, int dflt_max, int dflt_log, int max_sym,
                              int log_max) {
    int16_t norm[256];
    switch (mode) {
    case 0: { /* predefined */
        int r = fse_build(st->t, dflt, dflt_max, dflt_log);
        if (r) return r;
        st->log = dflt_log;
        st->ready = 1;
        return 0;
    }
    case 1: /* RLE: one symbol, no state bits */
        if (n < 1) return ZD_E_TRUNCATED;
        if (p[0] > max_sym) return ZD_E_TABLE;
        st->t[0].sym = p[0];
        st->t[0].nb = 0;
        st->t[0].base = 0;
        st->log = 0;
        st->ready = 1;
        return 1;
    case 2: { /* FSE-compressed */
        int ms = max_sym, log;
        int64_t used = fse_read_ncount(p, n, norm, &ms, &log, log_max);
        if (used < 0) return used;
        int r = fse_build(st->t, norm, ms, log);
        if (r) return r;
        st->log = log;
        st->ready = 1;
        return used;
    }
    default: /* repeat */
        return st->ready ? 0 : ZD_E_TABLE;
    }
}

/* --------------------------------------------------------------- Huffman */

/* The Huffman tree description at p[0, n) into ctx->huf; returns the bytes
 * used or a negative code. */
static int64_t huf_read_table(zctx *ctx, const uint8_t *p, int64_t n) {
    uint8_t w[256];
    int nw = 0;
    int64_t used;
    if (n < 1) return ZD_E_TRUNCATED;
    int hb = p[0];
    if (hb >= 128) { /* direct: 4 bits a weight */
        nw = hb - 127;
        int64_t bytes = (nw + 1) / 2;
        if (1 + bytes > n) return ZD_E_TRUNCATED;
        for (int i = 0; i < nw; i++) w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
        used = 1 + bytes;
    } else { /* FSE-compressed weights, two interleaved states */
        if (hb == 0) return ZD_E_TABLE;
        if (1 + (int64_t)hb > n) return ZD_E_TRUNCATED;
        const uint8_t *q = p + 1;
        int16_t norm[256];
        int ms = 255, log;
        int64_t nc = fse_read_ncount(q, hb, norm, &ms, &log, 6);
        if (nc < 0) return nc;
        fse_entry t[64];
        int r = fse_build(t, norm, ms, log);
        if (r) return r;
        bitrev b;
        r = bitrev_init(&b, q + nc, hb - nc);
        if (r) return r;
        uint32_t s1 = bitrev_read(&b, log), s2 = bitrev_read(&b, log);
        if (b.pos < 0) return ZD_E_CORRUPT;
        for (;;) {
            if (nw > 253) return ZD_E_TABLE;
            w[nw++] = t[s1].sym;
            s1 = t[s1].base + bitrev_read(&b, t[s1].nb);
            if (b.pos < 0) {
                w[nw++] = t[s2].sym;
                break;
            }
            w[nw++] = t[s2].sym;
            s2 = t[s2].base + bitrev_read(&b, t[s2].nb);
            if (b.pos < 0) {
                w[nw++] = t[s1].sym;
                break;
            }
        }
        used = 1 + hb;
    }
    /* The last weight is implied: the total must reach a power of two. */
    uint32_t total = 0;
    int rank[ZD_HUF_LOG_MAX + 2] = {0};
    for (int i = 0; i < nw; i++) {
        if (w[i] > ZD_HUF_LOG_MAX) return ZD_E_TABLE;
        rank[w[i]]++;
        if (w[i]) total += (uint32_t)1 << (w[i] - 1);
    }
    if (total == 0) return ZD_E_TABLE;
    int log = highbit32(total) + 1;
    if (log > ZD_HUF_LOG_MAX) return ZD_E_TABLE;
    uint32_t rest = ((uint32_t)1 << log) - total;
    if (rest & (rest - 1)) return ZD_E_TABLE;
    int last = highbit32(rest) + 1;
    w[nw++] = (uint8_t)last;
    rank[last]++;
    if (rank[1] < 2 || (rank[1] & 1)) return ZD_E_TABLE;
    /* Codes by increasing weight, then by symbol. */
    uint32_t start[ZD_HUF_LOG_MAX + 2];
    uint32_t pos = 0;
    for (int k = 1; k <= log; k++) {
        start[k] = pos;
        pos += (uint32_t)rank[k] << (k - 1);
    }
    if (pos != ((uint32_t)1 << log)) return ZD_E_TABLE;
    for (int s = 0; s < nw; s++) {
        int k = w[s];
        if (!k) continue;
        uint32_t len = (uint32_t)1 << (k - 1);
        for (uint32_t i = 0; i < len; i++) {
            ctx->huf[start[k] + i].sym = (uint8_t)s;
            ctx->huf[start[k] + i].nb = (uint8_t)(log + 1 - k);
        }
        start[k] += len;
    }
    ctx->huf_log = log;
    ctx->huf_ready = 1;
    return used;
}

/* A Huffman stream p[0, n) decoding to out[0, count): i symbols written, pos
 * bits left. */
typedef struct {
    const uint8_t *p;
    int64_t n, pos;
    uint8_t *out;
    int64_t i, count;
} huf_stream;

static int huf_open(huf_stream *st, const uint8_t *p, int64_t n, uint8_t *out, int64_t count) {
    bitrev b;
    int r = bitrev_init(&b, p, n);
    if (r) return r;
    st->p = p;
    st->n = n;
    st->pos = b.pos;
    st->out = out;
    st->i = 0;
    st->count = count;
    return 0;
}

/* Up to `max` symbols from bits [pos - 57, pos) in one load (pos >= 57):
 * each symbol takes at most log <= 12 bits, so 4 always fit. */
static inline void huf_burst(const huf_entry *t, int log, huf_stream *st, int64_t max) {
    uint32_t mask = (1u << log) - 1;
    int64_t start = st->pos - 57;
    uint64_t w;
    memcpy(&w, st->p + (start >> 3), 8);
    w >>= (start & 7);
    int avail = 57;
    int64_t i = st->i, end = i + max < st->count ? i + max : st->count;
    while (avail >= log && i < end) {
        huf_entry e = t[(w >> (avail - log)) & mask];
        st->out[i++] = e.sym;
        avail -= e.nb;
    }
    st->i = i;
    st->pos = start + avail;
}

/* The rest of a stream; it must end exactly at its first bit. */
static int huf_finish(const zctx *ctx, huf_stream *st) {
    int log = ctx->huf_log;
    while (st->i < st->count) {
        if (st->pos >= 57) {
            huf_burst(ctx->huf, log, st, st->count);
        } else { /* the stream's first bits, read past its start as zeros */
            huf_entry e = ctx->huf[get_bits(st->p, st->n, st->pos - log, log)];
            st->out[st->i++] = e.sym;
            st->pos -= e.nb;
        }
    }
    return st->pos == 0 ? 0 : ZD_E_CORRUPT;
}

/* Four streams, interleaved while each has a full load of bits left (four
 * independent chains of table lookups), then each finished alone. */
static int huf_four(const zctx *ctx, huf_stream *st) {
    int log = ctx->huf_log;
    for (;;) {
        int k;
        for (k = 0; k < 4; k++)
            if (st[k].pos < 57 || st[k].i + 4 > st[k].count) break;
        if (k < 4) break;
        for (k = 0; k < 4; k++) huf_burst(ctx->huf, log, &st[k], 4);
    }
    for (int k = 0; k < 4; k++) {
        int r = huf_finish(ctx, &st[k]);
        if (r) return r;
    }
    return 0;
}

/* ---------------------------------------------------------------- blocks */

static int64_t decode_literals(zctx *ctx, const uint8_t *src, int64_t n, const uint8_t **lits,
                               int64_t *lit_size) {
    if (n < 1) return ZD_E_TRUNCATED;
    int type = src[0] & 3, sf = (src[0] >> 2) & 3;
    if (type < 2) { /* raw or RLE */
        int64_t hs, size;
        if (sf == 0 || sf == 2) {
            hs = 1;
            size = src[0] >> 3;
        } else if (sf == 1) {
            hs = 2;
            if (n < 2) return ZD_E_TRUNCATED;
            size = (src[0] >> 4) + ((int64_t)src[1] << 4);
        } else {
            hs = 3;
            if (n < 3) return ZD_E_TRUNCATED;
            size = (src[0] >> 4) + ((int64_t)src[1] << 4) + ((int64_t)src[2] << 12);
        }
        if (size > ctx->block_max) return ZD_E_CORRUPT;
        if (type == 0) {
            if (hs + size > n) return ZD_E_TRUNCATED;
            *lits = src + hs;
            *lit_size = size;
            return hs + size;
        }
        if (hs + 1 > n) return ZD_E_TRUNCATED;
        memset(ctx->lit, src[hs], (size_t)size);
        *lits = ctx->lit;
        *lit_size = size;
        return hs + 1;
    }
    /* compressed or treeless */
    int hs = sf < 2 ? 3 : sf + 2;
    int bits = sf < 2 ? 10 : (sf == 2 ? 14 : 18);
    int streams = sf == 0 ? 1 : 4;
    if (n < hs) return ZD_E_TRUNCATED;
    uint64_t h = 0;
    for (int i = 0; i < hs; i++) h |= (uint64_t)src[i] << (8 * i);
    int64_t regen = (int64_t)((h >> 4) & ((1u << bits) - 1));
    int64_t csize = (int64_t)((h >> (4 + bits)) & ((1u << bits) - 1));
    if (regen > ctx->block_max) return ZD_E_CORRUPT;
    if (hs + csize > n) return ZD_E_TRUNCATED;
    const uint8_t *p = src + hs;
    int64_t left = csize;
    if (type == 2) {
        int64_t t = huf_read_table(ctx, p, left);
        if (t < 0) return t;
        p += t;
        left -= t;
    } else if (!ctx->huf_ready) {
        return ZD_E_TABLE; /* treeless with no earlier table */
    }
    int r;
    if (streams == 1) {
        huf_stream st;
        if ((r = huf_open(&st, p, left, ctx->lit, regen))) return r;
        if ((r = huf_finish(ctx, &st))) return r;
    } else {
        if (left < 6) return ZD_E_TRUNCATED;
        int64_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
        int64_t s4 = left - 6 - s1 - s2 - s3;
        if (s4 < 1) return ZD_E_CORRUPT;
        int64_t seg = (regen + 3) / 4, seg4 = regen - 3 * seg;
        if (seg4 < 0) return ZD_E_CORRUPT;
        const uint8_t *q = p + 6;
        huf_stream st[4];
        if ((r = huf_open(&st[0], q, s1, ctx->lit, seg))) return r;
        if ((r = huf_open(&st[1], q + s1, s2, ctx->lit + seg, seg))) return r;
        if ((r = huf_open(&st[2], q + s1 + s2, s3, ctx->lit + 2 * seg, seg))) return r;
        if ((r = huf_open(&st[3], q + s1 + s2 + s3, s4, ctx->lit + 3 * seg, seg4))) return r;
        if ((r = huf_four(ctx, st))) return r;
    }
    *lits = ctx->lit;
    *lit_size = regen;
    return hs + csize;
}

static int decode_block(zctx *ctx, const uint8_t *src, int64_t n, uint8_t *dst, int64_t cap,
                        int64_t *op, int64_t frame_start) {
    const uint8_t *lits;
    int64_t lit_size;
    int64_t used = decode_literals(ctx, src, n, &lits, &lit_size);
    if (used < 0) return (int)used;
    const uint8_t *p = src + used;
    int64_t left = n - used;
    if (left < 1) return ZD_E_TRUNCATED;
    int64_t nseq = p[0];
    int64_t hs = 1;
    if (nseq >= 128) {
        if (nseq < 255) {
            if (left < 2) return ZD_E_TRUNCATED;
            nseq = ((nseq - 128) << 8) + p[1];
            hs = 2;
        } else {
            if (left < 3) return ZD_E_TRUNCATED;
            nseq = p[1] + ((int64_t)p[2] << 8) + 0x7F00;
            hs = 3;
        }
    }
    int64_t o = *op;
    int64_t block_start = o;
    int64_t lp = 0;
    if (nseq > 0) {
        if (left < hs + 1) return ZD_E_TRUNCATED;
        int modes = p[hs];
        if (modes & 3) return ZD_E_RESERVED;
        p += hs + 1;
        left -= hs + 1;
        int64_t t;
        t = seq_table_read(&ctx->ll, modes >> 6, p, left, LL_DEFAULT, 35, 6, 35, 9);
        if (t < 0) return (int)t;
        p += t;
        left -= t;
        t = seq_table_read(&ctx->of, (modes >> 4) & 3, p, left, OF_DEFAULT, 28, 5, 31, 8);
        if (t < 0) return (int)t;
        p += t;
        left -= t;
        t = seq_table_read(&ctx->ml, (modes >> 2) & 3, p, left, ML_DEFAULT, 52, 6, 52, 9);
        if (t < 0) return (int)t;
        p += t;
        left -= t;
        bitrev b;
        int r = bitrev_init(&b, p, left);
        if (r) return r;
        uint32_t sll = bitrev_read(&b, ctx->ll.log);
        uint32_t sof = bitrev_read(&b, ctx->of.log);
        uint32_t sml = bitrev_read(&b, ctx->ml.log);
        for (int64_t i = 0; i < nseq; i++) {
            fse_entry ell = ctx->ll.t[sll], eof = ctx->of.t[sof], eml = ctx->ml.t[sml];
            int ofc = eof.sym;
            if (ofc > 31) return ZD_E_CORRUPT;
            uint64_t ofv = ((uint64_t)1 << ofc) + bitrev_read(&b, ofc);
            int64_t ml = ML_BASE[eml.sym] + bitrev_read(&b, ML_BITS[eml.sym]);
            int64_t ll = LL_BASE[ell.sym] + bitrev_read(&b, LL_BITS[ell.sym]);
            uint64_t offset;
            if (ofv > 3) {
                offset = ofv - 3;
                ctx->rep[2] = ctx->rep[1];
                ctx->rep[1] = ctx->rep[0];
                ctx->rep[0] = offset;
            } else {
                int idx = (int)ofv - 1 + (ll == 0);
                if (idx == 0) {
                    offset = ctx->rep[0];
                } else {
                    offset = idx == 3 ? ctx->rep[0] - 1 : ctx->rep[idx];
                    if (idx != 1) ctx->rep[2] = ctx->rep[1];
                    ctx->rep[1] = ctx->rep[0];
                    ctx->rep[0] = offset;
                }
            }
            if (i + 1 < nseq) {
                sll = ell.base + bitrev_read(&b, ell.nb);
                sml = eml.base + bitrev_read(&b, eml.nb);
                sof = eof.base + bitrev_read(&b, eof.nb);
            }
            /* execute: ll literals, then ml bytes from offset back */
            if (ll > lit_size - lp) return ZD_E_CORRUPT;
            if (o - block_start + ll + ml > ctx->block_max) return ZD_E_CORRUPT;
            if (ll + ml > cap - o) return ZD_E_DST_SMALL;
            memcpy(dst + o, lits + lp, (size_t)ll);
            o += ll;
            lp += ll;
            if (offset == 0 || offset > (uint64_t)(o - frame_start) || offset > ctx->window)
                return ZD_E_CORRUPT;
            uint8_t *d = dst + o;
            const uint8_t *s = d - offset;
            if (offset >= (uint64_t)ml) {
                memcpy(d, s, (size_t)ml);
            } else {
                for (int64_t k = 0; k < ml; k++) d[k] = s[k];
            }
            o += ml;
        }
        if (b.pos != 0) return ZD_E_CORRUPT;
    } else if (hs != left) {
        return ZD_E_CORRUPT; /* bytes after an empty sequences section */
    }
    int64_t rest = lit_size - lp;
    if (o - block_start + rest > ctx->block_max) return ZD_E_CORRUPT;
    if (rest > cap - o) return ZD_E_DST_SMALL;
    memcpy(dst + o, lits + lp, (size_t)rest);
    *op = o + rest;
    return 0;
}

/* ----------------------------------------------------------------- frames */

typedef struct {
    int64_t header;  /* header bytes */
    int64_t fcs;     /* content size, -1 when absent */
    uint64_t window; /* window size */
    int checksum;
} frame_header;

static int read_frame_header(const uint8_t *src, int64_t n, frame_header *fh) {
    if (n < 5) return ZD_E_TRUNCATED;
    int fhd = src[4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
    if (fhd & 8) return ZD_E_RESERVED;
    static const int did_size[4] = {0, 1, 2, 4};
    int fcs_size = fcs_flag == 0 ? single : (1 << fcs_flag);
    int64_t hs = 5 + !single + did_size[did_flag] + fcs_size;
    if (n < hs) return ZD_E_TRUNCATED;
    const uint8_t *p = src + 5;
    uint64_t window = 0;
    if (!single) {
        int exp = p[0] >> 3, mant = p[0] & 7;
        int wlog = 10 + exp;
        if (wlog > 31) return ZD_E_WINDOW;
        uint64_t base = (uint64_t)1 << wlog;
        window = base + (base >> 3) * (uint64_t)mant;
        p++;
    }
    uint32_t did = 0;
    for (int i = 0; i < did_size[did_flag]; i++) did |= (uint32_t)p[i] << (8 * i);
    p += did_size[did_flag];
    if (did) return ZD_E_DICT;
    int64_t fcs = -1;
    if (fcs_size == 1) fcs = p[0];
    else if (fcs_size == 2) fcs = rd16(p) + 256;
    else if (fcs_size == 4) fcs = rd32(p);
    else if (fcs_size == 8) {
        uint64_t v = rd64(p);
        if (v > ((uint64_t)1 << 62)) return ZD_E_WINDOW;
        fcs = (int64_t)v;
    }
    if (single) {
        if ((uint64_t)fcs > ZD_WINDOW_MAX) return ZD_E_WINDOW;
        window = (uint64_t)fcs;
    }
    if (window > ZD_WINDOW_MAX) return ZD_E_WINDOW;
    fh->header = hs;
    fh->fcs = fcs;
    fh->window = window;
    fh->checksum = (fhd >> 2) & 1;
    return 0;
}

static int is_skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

/* The decompressed size of every frame in src[0, n) when each header gives
 * its content size; -1 when one does not, or on a malformed header. */
int64_t zd_content_size(const uint8_t *src, int64_t n) {
    int64_t pos = 0, total = 0;
    if (n <= 0) return -1;
    while (pos < n) {
        if (n - pos < 8) return -1;
        uint32_t magic = rd32(src + pos);
        if (is_skippable(magic)) {
            int64_t sz = rd32(src + pos + 4);
            if (sz > n - pos - 8) return -1;
            pos += 8 + sz;
            continue;
        }
        if (magic != 0xFD2FB528u) return -1;
        frame_header fh;
        if (read_frame_header(src + pos, n - pos, &fh) || fh.fcs < 0) return -1;
        total += fh.fcs;
        /* skip the blocks */
        pos += fh.header;
        for (;;) {
            if (n - pos < 3) return -1;
            uint32_t bh = rd24(src + pos);
            int type = (bh >> 1) & 3;
            int64_t size = type == 1 ? 1 : (int64_t)(bh >> 3);
            if (size > n - pos - 3) return -1;
            pos += 3 + size;
            if (bh & 1) break;
        }
        if (fh.checksum) pos += 4;
        if (pos > n) return -1;
    }
    return total;
}

/* Decompress every frame of src[0, src_len) into dst[0, cap): the bytes
 * written, or a negative ZD_E_* code. */
int64_t zd_decompress(const uint8_t *src, int64_t src_len, uint8_t *dst, int64_t cap) {
    if (src_len <= 0) return ZD_E_TRUNCATED;
    zctx *ctx = (zctx *)malloc(sizeof(zctx));
    if (!ctx) return ZD_E_NOMEM;
    ctx->lit = (uint8_t *)malloc(ZD_BLOCK_MAX);
    if (!ctx->lit) {
        free(ctx);
        return ZD_E_NOMEM;
    }
    int64_t pos = 0, o = 0, ret = 0;
    while (pos < src_len) {
        if (src_len - pos < 4) {
            ret = ZD_E_TRUNCATED;
            goto done;
        }
        uint32_t magic = rd32(src + pos);
        if (is_skippable(magic)) {
            if (src_len - pos < 8) {
                ret = ZD_E_TRUNCATED;
                goto done;
            }
            int64_t sz = rd32(src + pos + 4);
            if (sz > src_len - pos - 8) {
                ret = ZD_E_TRUNCATED;
                goto done;
            }
            pos += 8 + sz;
            continue;
        }
        if (magic != 0xFD2FB528u) {
            ret = ZD_E_MAGIC;
            goto done;
        }
        frame_header fh;
        int r = read_frame_header(src + pos, src_len - pos, &fh);
        if (r) {
            ret = r;
            goto done;
        }
        pos += fh.header;
        ctx->window = fh.window;
        ctx->block_max = fh.window < ZD_BLOCK_MAX ? (int64_t)fh.window : ZD_BLOCK_MAX;
        ctx->rep[0] = 1;
        ctx->rep[1] = 4;
        ctx->rep[2] = 8;
        ctx->ll.ready = ctx->of.ready = ctx->ml.ready = 0;
        ctx->huf_ready = 0;
        int64_t frame_start = o;
        for (;;) {
            if (src_len - pos < 3) {
                ret = ZD_E_TRUNCATED;
                goto done;
            }
            uint32_t bh = rd24(src + pos);
            int last = bh & 1, type = (bh >> 1) & 3;
            int64_t size = bh >> 3;
            pos += 3;
            if (type == 3) {
                ret = ZD_E_RESERVED;
                goto done;
            }
            if (size > ctx->block_max) {
                ret = ZD_E_CORRUPT;
                goto done;
            }
            if (type == 0) {
                if (size > src_len - pos) {
                    ret = ZD_E_TRUNCATED;
                    goto done;
                }
                if (size > cap - o) {
                    ret = ZD_E_DST_SMALL;
                    goto done;
                }
                memcpy(dst + o, src + pos, (size_t)size);
                o += size;
                pos += size;
            } else if (type == 1) {
                if (src_len - pos < 1) {
                    ret = ZD_E_TRUNCATED;
                    goto done;
                }
                if (size > cap - o) {
                    ret = ZD_E_DST_SMALL;
                    goto done;
                }
                memset(dst + o, src[pos], (size_t)size);
                o += size;
                pos += 1;
            } else {
                if (size > src_len - pos) {
                    ret = ZD_E_TRUNCATED;
                    goto done;
                }
                r = decode_block(ctx, src + pos, size, dst, cap, &o, frame_start);
                if (r) {
                    ret = r;
                    goto done;
                }
                pos += size;
            }
            if (last) break;
        }
        if (fh.fcs >= 0 && o - frame_start != fh.fcs) {
            ret = ZD_E_SIZE;
            goto done;
        }
        if (fh.checksum) {
            if (src_len - pos < 4) {
                ret = ZD_E_TRUNCATED;
                goto done;
            }
            uint32_t want = rd32(src + pos);
            uint32_t got = (uint32_t)zd_xxh64(dst + frame_start, o - frame_start, 0);
            if (want != got) {
                ret = ZD_E_CHECKSUM;
                goto done;
            }
            pos += 4;
        }
    }
    ret = o;
done:
    free(ctx->lit);
    free(ctx);
    return ret;
}
