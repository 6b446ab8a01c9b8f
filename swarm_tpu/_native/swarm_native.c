/* Native host runtime for swarm_tpu.
 *
 * The reference implements its host pipeline in C++ (fasta parsing
 * src/db.cc:432-803, duplicate detection :719-790, abundance parsing
 * :161-283, sorting :388-413, BFS clustering src/algod1.cc:1185-1279).
 * These are latency-bound pointer/byte loops that gain nothing from an
 * accelerator; this module is their native equivalent, exposed to Python via
 * ctypes with numpy-owned buffers. Every function mirrors the Python
 * implementation in swarm_tpu/db.py / models/d1.py bit-for-bit — the
 * Python versions remain as the fallback and the differential-test
 * oracle.
 *
 * Build: cc -O2 -shared -fPIC swarm_native.c -o libswarm_native.so
 */

#define _GNU_SOURCE
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <stdio.h>

#define MAX_SEQUENCE_LENGTH 67108861LL /* src/db.cc:439 */
#define MAX_HEADER_LENGTH 16777215LL   /* src/db.cc:443 */
#define INT64_MAX_C 9223372036854775807LL
#define BAND_INF32 (1 << 28) /* int32 DP infinity for the 16-lane kernels */

/* unsigned decimal emitter: sprintf("%lld") costs ~300ns a call and
 * the writers print millions of integers (622k swarms at the 1M bench
 * = 0.5s of sprintf alone); this is ~15ns */
static inline int64_t emit_u64(uint64_t v, char *out) {
  char buf[20];
  int k = 0;
  do {
    buf[k++] = (char)('0' + (v % 10));
    v /= 10;
  } while (v);
  for (int i = 0; i < k; i++)
    out[i] = buf[k - 1 - i];
  return k;
}

/* ------------------------------------------------------------------ */
/* fasta scan                                                          */
/* ------------------------------------------------------------------ */

/* error codes (err_info[0]); err_info[1] = line number, err_info[2] =
 * char, err_info[3] = records completed before the error (fasta_scan:
 * the caller replays their progress milestones before the fatal) */
#define ERR_ILLEGAL_HEADER 1
#define ERR_EMPTY_SEQUENCE 2
#define ERR_ILLEGAL_CHAR 3
#define ERR_SEQ_TOO_LONG 4
#define ERR_HEADER_TOO_LONG 5

static const uint8_t NT_MAP[256] = {
    /* A/a=1 C/c=2 G/g=3 T/t/U/u=4, rest 0 */
    ['A'] = 1, ['a'] = 1, ['C'] = 2, ['c'] = 2,
    ['G'] = 3, ['g'] = 3, ['T'] = 4, ['t'] = 4, ['U'] = 4, ['u'] = 4,
};

/* direct-to-code map for the branch-free fast path: db codes 0..3,
 * anything else (incl. '\r' and NUL) = 0xFF -> line falls back to the
 * careful loop */
static uint8_t NT_MAP0[256];
static int nt_map0_ready = 0;
static void nt_map0_init(void) {
  if (nt_map0_ready)
    return;
  memset(NT_MAP0, 0xFF, sizeof NT_MAP0);
  for (int c = 0; c < 256; c++)
    if (NT_MAP[c])
      NT_MAP0[c] = (uint8_t)(NT_MAP[c] - 1);
  nt_map0_ready = 1;
}

/* Scan the whole fasta buffer. Returns the number of records or a
 * negative error code (details in err_info). Caller allocates codes
 * (buflen bytes) and the per-record arrays (max_records entries). */
int64_t fasta_scan(const uint8_t *buf, int64_t buflen, uint8_t *codes,
                   int64_t *seq_off, int64_t *seq_len, int64_t *hdr_off,
                   int64_t *hdr_len, int64_t *hdr_lineno, int64_t *filepos_out,
                   int64_t max_records, int64_t *err_info) {
  int64_t nrec = 0;
  int64_t codes_pos = 0;
  nt_map0_init();
  int64_t pos = 0;     /* byte offset of current line start */
  int64_t lineno = 0;  /* 1-based number of current line */
  int64_t filepos = 0; /* replicates the reference's progress position */

  /* first line's size is pre-added (db.py: filepos = line_sizes[0]) */
  int first = 1;

  while (pos < buflen) {
    /* current line: [pos, eol) */
    const uint8_t *nl = memchr(buf + pos, '\n', (size_t)(buflen - pos));
    int64_t eol = nl ? (int64_t)(nl - buf) : buflen;
    int64_t line_size = (eol - pos) + (nl ? 1 : 0);
    lineno++;
    if (first) {
      filepos = line_size;
      first = 0;
    }

    if (buf[pos] != '>') {
      err_info[0] = ERR_ILLEGAL_HEADER;
      err_info[1] = lineno;
      err_info[3] = nrec;
      return -1;
    }
    if (nrec >= max_records)
      return -99; /* caller bug: undercounted records */

    /* header: after '>' until first ' ', '\r' or NUL */
    int64_t hstart = pos + 1;
    int64_t hend = eol;
    for (int64_t i = hstart; i < eol; i++) {
      uint8_t c = buf[i];
      if (c == ' ' || c == '\r' || c == '\0') {
        hend = i;
        break;
      }
    }
    if (hend - hstart > MAX_HEADER_LENGTH) {
      err_info[0] = ERR_HEADER_TOO_LONG;
      err_info[1] = lineno;
      err_info[3] = nrec;
      return -1;
    }
    hdr_off[nrec] = hstart;
    hdr_len[nrec] = hend - hstart;
    hdr_lineno[nrec] = lineno;

    /* advance to sequence lines */
    pos = nl ? eol + 1 : buflen;

    int64_t slen = 0;
    seq_off[nrec] = codes_pos;
    while (pos < buflen && buf[pos] != '>') {
      const uint8_t *nl2 = memchr(buf + pos, '\n', (size_t)(buflen - pos));
      int64_t eol2 = nl2 ? (int64_t)(nl2 - buf) : buflen;
      int64_t lsz = (eol2 - pos) + (nl2 ? 1 : 0);
      lineno++;
      filepos += lsz;

      /* branch-free fast path: translate the whole line assuming only
       * clean code characters; any special byte ('\r', NUL, illegal)
       * poisons `bad` (codes are 0..3, specials 0xFF) and the line is
       * redone by the careful loop below */
      uint8_t bad = 0;
      int64_t llen = eol2 - pos;
      for (int64_t i = 0; i < llen; i++) {
        uint8_t t = NT_MAP0[buf[pos + i]];
        codes[codes_pos + i] = t;
        bad |= t;
      }
      if (!(bad & 0xFC)) {
        codes_pos += llen;
        slen += llen;
        if (slen > MAX_SEQUENCE_LENGTH) {
          err_info[0] = ERR_SEQ_TOO_LONG;
          err_info[1] = lineno;
          err_info[3] = nrec;
      return -1;
        }
      } else {
        for (int64_t i = pos; i < eol2; i++) {
          uint8_t c = buf[i];
          if (c == '\0')
            break; /* C-string scan stops at NUL */
          if (c == '\r')
            continue; /* silently skipped */
          uint8_t t = NT_MAP[c];
          if (t == 0) {
            err_info[0] = ERR_ILLEGAL_CHAR;
            err_info[1] = lineno;
            err_info[2] = c;
            err_info[3] = nrec;
      return -1;
          }
          codes[codes_pos++] = (uint8_t)(t - 1);
          slen++;
          if (slen > MAX_SEQUENCE_LENGTH) {
            err_info[0] = ERR_SEQ_TOO_LONG;
            err_info[1] = lineno;
            err_info[3] = nrec;
      return -1;
          }
        }
      }
      pos = nl2 ? eol2 + 1 : buflen;
    }
    /* look-ahead line number: next line is lineno+1; empty-sequence
     * errors report (lineno+1) - 1 = lineno of the last consumed line,
     * matching db.py:331 */
    if (slen == 0) {
      err_info[0] = ERR_EMPTY_SEQUENCE;
      err_info[1] = lineno; /* == (line_index + 1) - 1 in db.py terms */
      err_info[3] = nrec;
      return -1;
    }
    seq_len[nrec] = slen;
    /* account the upcoming header line into filepos (db.py adds the
     * look-ahead line's size when advancing onto it) */
    if (pos < buflen) {
      const uint8_t *nl3 = memchr(buf + pos, '\n', (size_t)(buflen - pos));
      int64_t eol3 = nl3 ? (int64_t)(nl3 - buf) : buflen;
      filepos += (eol3 - pos) + (nl3 ? 1 : 0);
    }
    filepos_out[nrec] = filepos;
    nrec++;
  }
  return nrec;
}

/* ------------------------------------------------------------------ */
/* abundance parsing (db.py:_find_abundance; reference src/db.cc)      */
/* ------------------------------------------------------------------ */

static int is_digit(uint8_t c) { return c >= '0' && c <= '9'; }

/* parse digits with int64 saturation (atol saturates in the reference) */
static int64_t parse_saturated(const uint8_t *s, int64_t ndig) {
  unsigned __int128 v = 0;
  for (int64_t i = 0; i < ndig; i++) {
    v = v * 10 + (unsigned)(s[i] - '0');
    if (v > (unsigned __int128)INT64_MAX_C)
      return INT64_MAX_C;
  }
  return (int64_t)v;
}

/* (_)([0-9]+)$ with <= 20 digits */
static int find_swarm_ab(const uint8_t *h, int64_t hlen, int64_t *start,
                         int64_t *end, int64_t *number) {
  int64_t pos = -1;
  for (int64_t i = hlen - 1; i >= 0; i--)
    if (h[i] == '_') {
      pos = i;
      break;
    }
  if (pos < 0)
    return 0;
  int64_t ndig = 0;
  for (int64_t i = pos + 1; i < hlen && is_digit(h[i]); i++)
    ndig++;
  if (ndig > 20 || ndig != hlen - pos - 1)
    return 0; /* zero digits matches: atol("") == 0 -> illegal-abundance fatal */
  *start = pos;
  *end = hlen;
  *number = parse_saturated(h + pos + 1, ndig);
  return 1;
}

/* (^|;)size=([0-9]+)(;|$) with the reference's skip distances */
static int find_usearch_ab(const uint8_t *h, int64_t hlen, int64_t *start,
                           int64_t *end, int64_t *number) {
  static const char attr[] = "size=";
  const int64_t alen = 5;
  int64_t position = 0;
  while (position + alen < hlen) {
    const uint8_t *f = memmem(h + position, (size_t)(hlen - position), attr,
                              (size_t)alen);
    if (!f)
      return 0;
    position = (int64_t)(f - h);
    if (position > 0 && h[position - 1] != ';') {
      position += alen + 1;
      continue;
    }
    int64_t ndig = 0;
    int64_t k = position + alen;
    while (k < hlen && is_digit(h[k])) {
      ndig++;
      k++;
    }
    if (ndig == 0) {
      position += alen + 1;
      continue;
    }
    if (position + alen + ndig < hlen && h[position + alen + ndig] != ';') {
      position += alen + ndig + 2;
      continue;
    }
    *start = position > 0 ? position - 1 : 0;
    int64_t e = position + alen + ndig + 1;
    *end = e < hlen ? e : hlen;
    *number = parse_saturated(h + position + alen, ndig);
    return 1;
  }
  return 0;
}

/* ------------------------------------------------------------------ */
/* per-record indexing: abundances + duplicate identifier detection    */
/* ------------------------------------------------------------------ */

static uint64_t fnv1a(const uint8_t *s, int64_t len) {
  uint64_t hash = 1469598103934665603ULL;
  for (int64_t i = 0; i < len; i++) {
    hash ^= s[i];
    hash *= 1099511628211ULL;
  }
  return hash;
}

/* Returns 0 on success; on the FIRST record-order error returns a code:
 *   1 = illegal abundance value (err_idx = record)
 *   2 = empty sequence identifier (err_idx = record)
 *   3 = duplicated sequence identifier (err_idx = record)
 * Outputs: abundance/ab_start/ab_end per record; missing_count and
 * first_missing record index (-1 if none). */
int64_t index_records(const uint8_t *buf, const int64_t *hdr_off,
                      const int64_t *hdr_len, int64_t n, int usearch,
                      int64_t append_ab, int64_t *abundance,
                      int32_t *ab_start, int32_t *ab_end,
                      int64_t *missing_count, int64_t *first_missing,
                      int64_t *err_idx) {
  *missing_count = 0;
  *first_missing = -1;

  /* open-addressing set for identifiers */
  uint64_t cap = 16;
  while (cap < (uint64_t)n * 2 + 8)
    cap <<= 1;
  int64_t *slots = malloc(cap * sizeof(int64_t));
  if (!slots)
    return -1;
  for (uint64_t i = 0; i < cap; i++)
    slots[i] = -1;
  /* identifier span per record (for equality compare) */
  int64_t *id_off = malloc((size_t)n * sizeof(int64_t));
  int64_t *id_len = malloc((size_t)n * sizeof(int64_t));
  if (!id_off || !id_len) {
    free(slots);
    free(id_off);
    free(id_len);
    return -1;
  }

  int64_t rc = 0;
  for (int64_t k = 0; k < n; k++) {
    const uint8_t *h = buf + hdr_off[k];
    int64_t hlen = hdr_len[k];
    int64_t start = hlen, end = hlen, number = 0;
    int found = usearch ? find_usearch_ab(h, hlen, &start, &end, &number)
                        : find_swarm_ab(h, hlen, &start, &end, &number);
    if (found) {
      if (number <= 0) {
        *err_idx = k;
        rc = 1;
        goto done;
      }
      abundance[k] = number;
    } else {
      start = hlen;
      end = hlen;
      if (append_ab != 0) {
        abundance[k] = append_ab;
      } else {
        abundance[k] = 0;
        if ((*missing_count)++ == 0)
          *first_missing = k;
      }
    }
    ab_start[k] = (int32_t)start;
    ab_end[k] = (int32_t)end;

    if (start == 0 && end == hlen) {
      *err_idx = k;
      rc = 2;
      goto done;
    }

    /* identifier = header minus annotation */
    int64_t ioff, ilen;
    if (start > 0) {
      ioff = hdr_off[k];
      ilen = start;
    } else {
      ioff = hdr_off[k] + end;
      ilen = hlen - end;
    }
    id_off[k] = ioff;
    id_len[k] = ilen;

    uint64_t hash = fnv1a(buf + ioff, ilen);
    uint64_t slot = hash & (cap - 1);
    for (;;) {
      int64_t other = slots[slot];
      if (other < 0) {
        slots[slot] = k;
        break;
      }
      if (id_len[other] == ilen &&
          memcmp(buf + id_off[other], buf + ioff, (size_t)ilen) == 0) {
        *err_idx = k;
        rc = 3;
        goto done;
      }
      slot = (slot + 1) & (cap - 1);
    }
  }

done:
  free(slots);
  free(id_off);
  free(id_len);
  return rc;
}

/* ------------------------------------------------------------------ */
/* duplicate sequence detection (d>1 check / d=1 hashing phase)        */
/* ------------------------------------------------------------------ */

/* Returns index of the second record of the first duplicate pair (in
 * scan order), or -1 when all sequences are distinct. */
int64_t find_duplicate_seq(const uint8_t *codes, const int64_t *seq_off,
                           const int64_t *seq_len, int64_t n) {
  uint64_t cap = 16;
  while (cap < (uint64_t)n * 2 + 8)
    cap <<= 1;
  int64_t *slots = malloc(cap * sizeof(int64_t));
  if (!slots)
    return -2;
  for (uint64_t i = 0; i < cap; i++)
    slots[i] = -1;

  int64_t result = -1;
  for (int64_t k = 0; k < n && result < 0; k++) {
    const uint8_t *s = codes + seq_off[k];
    uint64_t hash = fnv1a(s, seq_len[k]);
    uint64_t slot = hash & (cap - 1);
    for (;;) {
      int64_t other = slots[slot];
      if (other < 0) {
        slots[slot] = k;
        break;
      }
      if (seq_len[other] == seq_len[k] &&
          memcmp(codes + seq_off[other], s, (size_t)seq_len[k]) == 0) {
        result = k;
        break;
      }
      slot = (slot + 1) & (cap - 1);
    }
  }
  free(slots);
  return result;
}

/* ------------------------------------------------------------------ */
/* abundance sort: order by (-abundance, header bytes)                 */
/* ------------------------------------------------------------------ */

typedef struct {
  const uint8_t *buf;
  const int64_t *hdr_off;
  const int64_t *hdr_len;
  const int64_t *abundance;
} sort_ctx;

static int cmp_records(const void *pa, const void *pb, void *arg) {
  sort_ctx *ctx = (sort_ctx *)arg;
  int64_t a = *(const int64_t *)pa, b = *(const int64_t *)pb;
  int64_t aa = ctx->abundance[a], ab = ctx->abundance[b];
  if (aa != ab)
    return aa > ab ? -1 : 1;
  int64_t la = ctx->hdr_len[a], lb = ctx->hdr_len[b];
  int64_t m = la < lb ? la : lb;
  int c = memcmp(ctx->buf + ctx->hdr_off[a], ctx->buf + ctx->hdr_off[b],
                 (size_t)m);
  if (c)
    return c;
  if (la != lb)
    return la < lb ? -1 : 1;
  return a < b ? -1 : (a > b ? 1 : 0); /* stable */
}

/* composite sort key: (abundance desc, first 8 header bytes asc)
 * resolves almost every comparison from two in-struct u64 compares —
 * the pointer-chasing comparator paid ~3 random derefs per compare.
 * Ties on both keys fall back to the exact header rule. Zero-padding
 * the prefix is safe: header bytes exclude NUL (the parser terminates
 * headers at ' ', '\r' and NUL), so a shorter prefix sorts first. */
typedef struct {
  uint64_t k1, k2;
  int64_t idx;
} absort_key_t;

static const uint8_t *absort_buf;
static const int64_t *absort_off, *absort_len;

static int cmp_absort(const void *x, const void *y) {
  const absort_key_t *a = (const absort_key_t *)x;
  const absort_key_t *b = (const absort_key_t *)y;
  if (a->k1 != b->k1)
    return a->k1 < b->k1 ? -1 : 1;
  if (a->k2 != b->k2)
    return a->k2 < b->k2 ? -1 : 1;
  int64_t la = absort_len[a->idx], lb = absort_len[b->idx];
  int64_t m = la < lb ? la : lb;
  int c = memcmp(absort_buf + absort_off[a->idx],
                 absort_buf + absort_off[b->idx], (size_t)m);
  if (c)
    return c;
  if (la != lb)
    return la < lb ? -1 : 1;
  return a->idx < b->idx ? -1 : (a->idx > b->idx ? 1 : 0);
}

void abundance_sort(const uint8_t *buf, const int64_t *hdr_off,
                    const int64_t *hdr_len, const int64_t *abundance,
                    int64_t n, int64_t *order) {
  absort_key_t *keys =
      (absort_key_t *)malloc((size_t)(n > 0 ? n : 1) * sizeof(absort_key_t));
  if (keys == NULL) { /* fall back to the pointer-chasing comparator */
    for (int64_t i = 0; i < n; i++)
      order[i] = i;
    sort_ctx ctx = {buf, hdr_off, hdr_len, abundance};
    qsort_r(order, (size_t)n, sizeof(int64_t), cmp_records, &ctx);
    return;
  }
  for (int64_t i = 0; i < n; i++) {
    keys[i].k1 = ~(uint64_t)abundance[i];
    const uint8_t *h = buf + hdr_off[i];
    int64_t l = hdr_len[i];
    uint64_t k2 = 0;
    for (int64_t j = 0; j < 8 && j < l; j++)
      k2 |= (uint64_t)h[j] << (56 - 8 * j);
    keys[i].k2 = k2;
    keys[i].idx = i;
  }
  absort_buf = buf;
  absort_off = hdr_off;
  absort_len = hdr_len;
  qsort(keys, (size_t)n, sizeof(absort_key_t), cmp_absort);
  for (int64_t i = 0; i < n; i++)
    order[i] = keys[i].idx;
  free(keys);
}

/* ------------------------------------------------------------------ */
/* d=1 BFS cluster growth (reference src/algod1.cc:1185-1279)          */
/* ------------------------------------------------------------------ */

int cmp_i64(const void *x, const void *y) {
  int64_t a = *(const int64_t *)x, b = *(const int64_t *)y;
  return a < b ? -1 : (a > b ? 1 : 0);
}

static int cmp_i32(const void *x, const void *y) {
  int32_t a = *(const int32_t *)x, b = *(const int32_t *)y;
  return a < b ? -1 : (a > b ? 1 : 0);
}

/* Inputs: CSR edge lists sorted by (from, to). Outputs match
 * swarm_tpu/models/d1.py exactly: per-amplicon swarmid/parent/
 * generation; members = amplicon ids concatenated in chain order;
 * swarm boundaries; per-swarm stats. Returns swarm count.
 *
 * The hot loop works on int32 copies of the CSR (edge targets and the
 * per-amplicon swarm labels): at 1M amplicons the label array is the
 * random-access working set, and 4 MB of labels + 4 B/edge halves the
 * cache pressure of the original int64 walk (measured 0.47s -> ~0.2s
 * single-core). Hit lists per generation are tiny, so an insertion
 * sort replaces qsort below 32 elements. */
int64_t bfs_cluster(int64_t n, const int64_t *link_start,
                    const int64_t *link_count, const int64_t *edges_to,
                    const int64_t *abundance, const int64_t *lengths,
                    int64_t *swarmid, int64_t *parent, int64_t *generation,
                    int64_t *members, int64_t *swarm_bound /* [n+1] */,
                    int64_t *swarm_seed, int64_t *swarm_mass,
                    int64_t *swarm_sumlen, int64_t *swarm_size,
                    int64_t *swarm_singletons, int64_t *swarm_maxgen) {
  int64_t nedges = n > 0 ? link_start[n - 1] + link_count[n - 1] : 0;
  int32_t *sid32 = malloc((size_t)n * sizeof(int32_t));
  int32_t *eto32 = malloc((size_t)(nedges > 0 ? nedges : 1) * sizeof(int32_t));
  int32_t *frontier = malloc((size_t)n * sizeof(int32_t));
  int32_t *hits = malloc((size_t)n * sizeof(int32_t));
  if (!sid32 || !eto32 || !frontier || !hits) {
    free(sid32);
    free(eto32);
    free(frontier);
    free(hits);
    return -1;
  }
  for (int64_t i = 0; i < n; i++)
    sid32[i] = -1;
  for (int64_t e = 0; e < nedges; e++)
    eto32[e] = (int32_t)edges_to[e];

  int64_t nswarms = 0;
  int64_t mpos = 0;
  swarm_bound[0] = 0;

  for (int64_t seedi = 0; seedi < n; seedi++) {
    if (sid32[seedi] >= 0)
      continue;
    int32_t sid = (int32_t)nswarms;
    sid32[seedi] = sid;
    parent[seedi] = -1;
    generation[seedi] = 0;

    int64_t mass = abundance[seedi];
    int64_t singletons = abundance[seedi] == 1 ? 1 : 0;
    int64_t sumlen = lengths[seedi];
    int64_t maxgen = 0;
    int64_t size = 1;
    members[mpos++] = seedi;

    int64_t nf = 1;
    frontier[0] = (int32_t)seedi;
    int64_t gen = 0;
    while (nf > 0) {
      gen++;
      int64_t nh = 0;
      for (int64_t f = 0; f < nf; f++) {
        int32_t sub = frontier[f];
        int64_t st = link_start[sub];
        int64_t cnt = link_count[sub];
        if (f + 1 < nf) {
          /* the sid32 probes below are the walk's only random access;
           * start the next frontier entry's CSR row early */
          int32_t nxt = frontier[f + 1];
          __builtin_prefetch(&link_start[nxt]);
          __builtin_prefetch(&eto32[link_start[nxt]]);
        }
        for (int64_t e = 0; e < cnt; e++) {
          if (e + 4 < cnt) {
            int32_t t4 = eto32[st + e + 4];
            __builtin_prefetch(&sid32[t4]);
            __builtin_prefetch(&generation[t4], 1);
            __builtin_prefetch(&parent[t4], 1);
          }
          int32_t tgt = eto32[st + e];
          if (sid32[tgt] < 0) {
            sid32[tgt] = sid;
            generation[tgt] = gen;
            parent[tgt] = sub;
            hits[nh++] = tgt;
          }
        }
      }
      if (nh > 1) {
        /* hits attach in ascending amplicon order (src/algod1.cc:1215) */
        if (nh <= 32) {
          for (int64_t a = 1; a < nh; a++) {
            int32_t v = hits[a];
            int64_t b = a - 1;
            while (b >= 0 && hits[b] > v) {
              hits[b + 1] = hits[b];
              b--;
            }
            hits[b + 1] = v;
          }
        } else {
          qsort(hits, (size_t)nh, sizeof(int32_t), cmp_i32);
        }
      }
      for (int64_t hidx = 0; hidx < nh; hidx++) {
        int32_t tgt = hits[hidx];
        if (hidx + 4 < nh) {
          __builtin_prefetch(&abundance[hits[hidx + 4]]);
          __builtin_prefetch(&lengths[hits[hidx + 4]]);
        }
        members[mpos++] = tgt;
        mass += abundance[tgt];
        if (abundance[tgt] == 1)
          singletons++;
        sumlen += lengths[tgt];
        size++;
      }
      if (nh > 0)
        maxgen = gen;
      /* swap frontier/hits */
      int32_t *tmp = frontier;
      frontier = hits;
      hits = tmp;
      nf = nh;
    }

    swarm_seed[sid] = seedi;
    swarm_mass[sid] = mass;
    swarm_sumlen[sid] = sumlen;
    swarm_size[sid] = size;
    swarm_singletons[sid] = singletons;
    swarm_maxgen[sid] = maxgen;
    nswarms++;
    swarm_bound[nswarms] = mpos;
  }

  for (int64_t i = 0; i < n; i++)
    swarmid[i] = sid32[i];

  free(sid32);
  free(eto32);
  free(frontier);
  free(hits);
  return nswarms;
}


/* ------------------------------------------------------------------ */
/* alignment backtrack (reference src/utils/backtrack.h:51-138)        */
/* ------------------------------------------------------------------ */

#define BIT_UP 1
#define BIT_LEFT 2
#define BIT_EXTUP 4
#define BIT_EXTLEFT 8

/* Count differences along the kernel's tie-broken optimal path for a
 * batch of targets aligned against one query. dirs is [B, dlen_max,
 * qlen] row-major. Mirrors swarm_tpu/ops/search.py:_backtrack. */
void nw_backtrack_batch(const uint8_t *qseq, int64_t qlen,
                        const uint8_t *dseqs, const int64_t *dlens,
                        int64_t dlen_max, const uint8_t *dirs, int64_t B,
                        int64_t *diffs, int64_t *alignlengths) {
  for (int64_t b = 0; b < B; b++) {
    const uint8_t *dcodes = dseqs + b * dlen_max;
    const uint8_t *dir = dirs + b * dlen_max * qlen;
    int64_t column = qlen - 1;
    int64_t row = dlens[b] - 1;
    int64_t aligned = 0;
    int64_t matches = 0;
    int op = 0; /* 0 unknown, 1 insertion, 2 deletion, 3 match */
    while (column >= 0 && row >= 0) {
      aligned++;
      uint8_t cell = dir[row * qlen + column];
      if (op == 1 && !(cell & BIT_EXTLEFT)) {
        row--;
      } else if (op == 2 && !(cell & BIT_EXTUP)) {
        column--;
      } else if (cell & BIT_LEFT) {
        row--;
        op = 1;
      } else if (!(cell & BIT_UP)) {
        column--;
        op = 2;
      } else {
        if (qseq[column] == dcodes[row])
          matches++;
        column--;
        row--;
        op = 3;
      }
    }
    aligned += column + 1 + row + 1;
    diffs[b] = aligned - matches;
    alignlengths[b] = aligned;
  }
}

/* ------------------------------------------------------------------ */
/* arena gather: reorder per-record code segments into sorted order    */
/* ------------------------------------------------------------------ */

/* out must hold sum(seq_len); the parser already emits db codes 0..3,
 * so this is a pure segment permutation */
void gather_arena(const uint8_t *codes, const int64_t *seq_off,
                  const int64_t *seq_len, const int64_t *order, int64_t n,
                  uint8_t *out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t rec = order[i];
    memcpy(out + pos, codes + seq_off[rec], (size_t)seq_len[rec]);
    pos += seq_len[rec];
  }
}

/* pad codes into an [n, width] matrix (zero fill) */
void pad_rows(const uint8_t *arena, const int64_t *offsets,
              const int64_t *lengths, int64_t n, int64_t width,
              uint8_t *out) {
  memset(out, 0, (size_t)(n * width));
  for (int64_t i = 0; i < n; i++)
    memcpy(out + i * width, arena + offsets[i], (size_t)lengths[i]);
}

/* pack [n, width] 2-bit codes into uint32 words (16 bases per word) */
void pack_rows(const uint8_t *padded, int64_t n, int64_t width,
               uint32_t *out) {
  int64_t words = width / 16;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t *row = padded + i * width;
    for (int64_t w = 0; w < words; w++) {
      uint32_t v = 0;
      for (int64_t b = 0; b < 16; b++)
        v |= (uint32_t)(row[w * 16 + b] & 3) << (2 * b);
      out[i * words + w] = v;
    }
  }
}

/* ------------------------------------------------------------------ */
/* output-only scalar NW with CIGAR (reference src/nw.cc:40-191,       */
/* src/utils/cigar.cc:29-61) — used for -u H-lines                     */
/* ------------------------------------------------------------------ */

/* Returns cigar length. out3 = {nwdiff, alignment_length, cigar_len}.
 * work: caller-allocated >= dlen*qlen (dirs) and 2*qlen int64 (H/E). */
void nw_align(const uint8_t *dseq, int64_t dlen, const uint8_t *qseq,
              int64_t qlen, int64_t mismatch, int64_t go, int64_t ge,
              uint8_t *dirs, int64_t *Hbuf, int64_t *Ebuf, char *raw,
              char *cigar, int64_t *out3) {
  for (int64_t c = 0; c < qlen; c++) {
    Hbuf[c] = go + (c + 1) * ge;
    Ebuf[c] = 2 * go + (c + 2) * ge;
  }

  for (int64_t r = 0; r < dlen; r++) {
    int64_t diag_boundary = r == 0 ? 0 : go + r * ge;
    int64_t top_boundary = 2 * go + (r + 2) * ge;
    uint8_t dch = dseq[r];
    uint8_t *dirrow = dirs + r * qlen;

    int64_t T = top_boundary; /* top (horizontal gap) running value */
    int64_t prev_H = 0;       /* H[c-1] of previous row (diag source) */
    for (int64_t c = 0; c < qlen; c++) {
      int64_t diag_in = c == 0 ? diag_boundary : prev_H;
      int64_t diag = diag_in + (dch == qseq[c] ? 0 : mismatch);
      int64_t left = Ebuf[c];
      int64_t pre = diag < left ? diag : left;
      if (c > 0) {
        /* T[c] = min(T[c-1] + ge, pre[c-1] + go + ge) — pre of col c-1
         * is carried in prev_pre */
      }
      int64_t top = T;
      int64_t newH = pre < top ? pre : top;

      uint8_t bits = 0;
      if (top < diag)
        bits |= 1; /* MASKUP */
      {
        int64_t after_top = diag < top ? diag : top;
        if (left <= after_top)
          bits |= 2; /* MASKLEFT */
      }
      int64_t diag2 = newH + go + ge;
      int64_t left2 = left + ge;
      int64_t top2 = top + ge;
      if (top2 < diag2)
        bits |= 4; /* MASKEXTUP */
      if (left2 < diag2)
        bits |= 8; /* MASKEXTLEFT */
      dirrow[c] = bits;

      prev_H = Hbuf[c]; /* save previous-row H before overwrite */
      Hbuf[c] = newH;
      Ebuf[c] = diag2 < left2 ? diag2 : left2;
      /* advance T for next column: min(T + ge, pre + go + ge) */
      int64_t open2 = pre + go + ge;
      T = T + ge < open2 ? T + ge : open2;
    }
  }

  /* backtrack (reference src/nw.cc:115-191) */
  int64_t column = qlen, row = dlen;
  int64_t pos = qlen + dlen; /* fill raw from the end */
  int64_t total = pos;
  int64_t matches = 0;
  char operation = 0;
  while (column > 0 && row > 0) {
    uint8_t cell = dirs[(row - 1) * qlen + (column - 1)];
    if (operation == 'I' && (cell & 8)) {
      row--;
      raw[--pos] = 'I';
    } else if (operation == 'D' && (cell & 4)) {
      column--;
      raw[--pos] = 'D';
    } else if (cell & 2) {
      row--;
      raw[--pos] = 'I';
      operation = 'I';
    } else if (cell & 1) {
      column--;
      raw[--pos] = 'D';
      operation = 'D';
    } else {
      if (qseq[column - 1] == dseq[row - 1])
        matches++;
      column--;
      row--;
      raw[--pos] = 'M';
      operation = 'M';
    }
  }
  while (column > 0) {
    column--;
    raw[--pos] = 'D';
  }
  while (row > 0) {
    row--;
    raw[--pos] = 'I';
  }

  int64_t alen = total - pos;
  out3[0] = alen - matches;
  out3[1] = alen;

  /* RLE: counts of 1 omitted */
  int64_t clen = 0;
  int64_t i = pos;
  while (i < total) {
    char ch = raw[i];
    int64_t cnt = 1;
    while (i + cnt < total && raw[i + cnt] == ch)
      cnt++;
    if (cnt > 1)
      clen += emit_u64((uint64_t)cnt, cigar + clen);
    cigar[clen++] = ch;
    i += cnt;
  }
  cigar[clen] = 0;
  out3[2] = clen;
}

/* Banded nw_align: identical output to nw_align whenever it accepts.
 *
 * Correctness argument (cost space, penalties positive): any alignment
 * path whose column-row offset leaves [-wL, wR] contains at least
 * w+1 surplus insertions or deletions beyond the length difference,
 * so its cost is >= go + ge*(2*(w+1) + |qlen-dlen|).  If the banded
 * optimum c* is strictly below that bound, every cost-optimal path of
 * the FULL matrix lies inside the band; and at every cell the
 * backtrack visits, an out-of-band neighbour can neither win nor tie
 * the local argmin (a win/tie would extend to an optimal full path
 * exiting the band, cost >= bound > c*).  Hence all visited direction
 * bits — including the gap-extension bits — equal the full-matrix
 * bits, and the backtrack, CIGAR and match count are byte-identical.
 * On c* >= bound the caller must rerun the full nw_align.
 *
 * dirs must hold dlen * (wL + wR + 1) bytes; Hbuf/Ebuf hold qlen.
 * Returns 1 when accepted (raw/cigar/out3 filled), 0 otherwise. */
int nw_align_banded(const uint8_t *dseq, int64_t dlen, const uint8_t *qseq,
                    int64_t qlen, int64_t mismatch, int64_t go, int64_t ge,
                    int64_t w, uint8_t *dirs, int64_t *Hbuf, int64_t *Ebuf,
                    char *raw, char *cigar, int64_t *out3) {
  const int64_t INF = (int64_t)1 << 42;
  int64_t F = qlen - dlen;
  int64_t wL = w + (F < 0 ? -F : 0);
  int64_t wR = w + (F > 0 ? F : 0);
  int64_t B = wL + wR + 1;
  if (B >= qlen) /* band covers the full matrix: no point */
    return 0;

  for (int64_t c = 0; c < qlen; c++) {
    Hbuf[c] = INF;
    Ebuf[c] = INF;
  }
  {
    int64_t cend0 = wR < qlen - 1 ? wR : qlen - 1;
    for (int64_t c = 0; c <= cend0; c++) {
      Hbuf[c] = go + (c + 1) * ge;
      Ebuf[c] = 2 * go + (c + 2) * ge;
    }
  }

  for (int64_t r = 0; r < dlen; r++) {
    int64_t cstart = r - wL > 0 ? r - wL : 0;
    int64_t cend = r + wR < qlen - 1 ? r + wR : qlen - 1;
    int64_t diag_boundary = r == 0 ? 0 : go + r * ge;
    uint8_t dch = dseq[r];
    uint8_t *dirrow = dirs + r * B;

    int64_t T = cstart == 0 ? 2 * go + (r + 2) * ge : INF;
    /* H[r-1][cstart-1]: fresh whenever cstart>0 (the band's left edge
     * advances by exactly one column per row once it leaves 0) */
    int64_t prev_H = cstart > 0 ? Hbuf[cstart - 1] : 0;
    for (int64_t c = cstart; c <= cend; c++) {
      int64_t diag_in = c == 0 ? diag_boundary : prev_H;
      int64_t diag = diag_in + (dch == qseq[c] ? 0 : mismatch);
      int64_t left = Ebuf[c];
      int64_t pre = diag < left ? diag : left;
      int64_t top = T;
      int64_t newH = pre < top ? pre : top;

      uint8_t bits = 0;
      if (top < diag)
        bits |= 1;
      {
        int64_t after_top = diag < top ? diag : top;
        if (left <= after_top)
          bits |= 2;
      }
      int64_t diag2 = newH + go + ge;
      int64_t left2 = left + ge;
      int64_t top2 = top + ge;
      if (top2 < diag2)
        bits |= 4;
      if (left2 < diag2)
        bits |= 8;
      dirrow[c - cstart] = bits;

      prev_H = Hbuf[c];
      Hbuf[c] = newH;
      Ebuf[c] = diag2 < left2 ? diag2 : left2;
      int64_t open2 = pre + go + ge;
      T = T + ge < open2 ? T + ge : open2;
    }
    /* the column that just left the band on the right never existed
     * for this row; its Ebuf entry must not leak a stale value into
     * row r+1's new right edge — new right columns are INF by init */
  }

  int64_t cstar = Hbuf[qlen - 1];
  int64_t absF = F < 0 ? -F : F;
  if (cstar >= go + ge * (2 * (w + 1) + absF))
    return 0;

  /* backtrack — same decision order as nw_align, banded dirs index */
  int64_t column = qlen, row = dlen;
  int64_t pos = qlen + dlen;
  int64_t total = pos;
  int64_t matches = 0;
  char operation = 0;
  while (column > 0 && row > 0) {
    int64_t r1 = row - 1;
    int64_t cstart = r1 - wL > 0 ? r1 - wL : 0;
    int64_t j = (column - 1) - cstart;
    if (j < 0 || j >= B)
      return 0; /* defensive: cannot happen when the bound held */
    uint8_t cell = dirs[r1 * B + j];
    if (operation == 'I' && (cell & 8)) {
      row--;
      raw[--pos] = 'I';
    } else if (operation == 'D' && (cell & 4)) {
      column--;
      raw[--pos] = 'D';
    } else if (cell & 2) {
      row--;
      raw[--pos] = 'I';
      operation = 'I';
    } else if (cell & 1) {
      column--;
      raw[--pos] = 'D';
      operation = 'D';
    } else {
      if (qseq[column - 1] == dseq[row - 1])
        matches++;
      column--;
      row--;
      raw[--pos] = 'M';
      operation = 'M';
    }
  }
  while (column > 0) {
    column--;
    raw[--pos] = 'D';
  }
  while (row > 0) {
    row--;
    raw[--pos] = 'I';
  }

  int64_t alen = total - pos;
  out3[0] = alen - matches;
  out3[1] = alen;

  int64_t clen = 0;
  int64_t i = pos;
  while (i < total) {
    char ch = raw[i];
    int64_t cnt = 1;
    while (i + cnt < total && raw[i + cnt] == ch)
      cnt++;
    if (cnt > 1)
      clen += emit_u64((uint64_t)cnt, cigar + clen);
    cigar[clen++] = ch;
    i += cnt;
  }
  cigar[clen] = 0;
  out3[2] = clen;
  return 1;
}

/* ------------------------------------------------------------------ */
/* output writers (reference src/algod1.cc:791-815, 1043-1062)         */
/* ------------------------------------------------------------------ */

/* print_id (src/db.cc:946-975): header, plus appended abundance when
 * -a is active and the header has no annotation */
static int64_t emit_id(const uint8_t *hdr, int64_t hlen, int32_t ab_s,
                       int32_t ab_e, int64_t ab, int64_t append_ab,
                       int usearch, char *out) {
  memcpy(out, hdr, (size_t)hlen);
  int64_t w = hlen;
  if (append_ab != 0 && ab_s == ab_e) {
    if (usearch) {
      memcpy(out + w, ";size=", 6);
      w += 6;
      w += emit_u64((uint64_t)ab, out + w);
      out[w++] = ';';
    } else {
      out[w++] = '_';
      w += emit_u64((uint64_t)ab, out + w);
    }
  }
  return w;
}

/* print_id_noabundance (src/db.cc:978-998) */
static int64_t emit_id_noab(const uint8_t *hdr, int64_t hlen, int32_t ab_s,
                            int32_t ab_e, int usearch, char *out) {
  if (ab_s < ab_e) {
    memcpy(out, hdr, (size_t)ab_s);
    int64_t w = ab_s;
    if (usearch) {
      if (ab_s > 0 && ab_e < hlen)
        out[w++] = ';';
      memcpy(out + w, hdr + ab_e, (size_t)(hlen - ab_e));
      w += hlen - ab_e;
    }
    return w;
  }
  memcpy(out, hdr, (size_t)hlen);
  return hlen;
}

/* plain swarms output: members space-separated, one line per swarm.
 * Returns bytes written, or -1 if out_cap is too small. */
int64_t write_swarms_plain(
    const uint8_t *hdr_arena, const int64_t *hdr_off, const int64_t *hdr_len,
    const int32_t *ab_start, const int32_t *ab_end, const int64_t *abundance,
    int64_t append_ab, int usearch, const int64_t *members,
    const int64_t *bounds, const uint8_t *attached, int64_t nswarms,
    char *out, int64_t out_cap) {
  int64_t w = 0;
  int64_t nmembers = nswarms > 0 ? bounds[nswarms] : 0;
  for (int64_t s = 0; s < nswarms; s++) {
    if (attached[s])
      continue;
    for (int64_t m = bounds[s]; m < bounds[s + 1]; m++) {
      int64_t a = members[m];
      /* members walk headers in cluster order — random access; the
       * misses pipeline: index arrays 16 ahead, arena 4 ahead
       * (prefetching past the swarm boundary is harmless: members is
       * contiguous across swarms) */
      if (m + 16 < nmembers) {
        int64_t a16 = members[m + 16];
        __builtin_prefetch(&hdr_off[a16]);
        __builtin_prefetch(&hdr_len[a16]);
        __builtin_prefetch(&ab_start[a16]);
        __builtin_prefetch(&ab_end[a16]);
        __builtin_prefetch(&abundance[a16]);
      }
      if (m + 4 < nmembers)
        __builtin_prefetch(hdr_arena + hdr_off[members[m + 4]]);
      if (w + hdr_len[a] + 32 > out_cap)
        return -1;
      if (m > bounds[s])
        out[w++] = ' ';
      w += emit_id(hdr_arena + hdr_off[a], hdr_len[a], ab_start[a],
                   ab_end[a], abundance[a], append_ab, usearch, out + w);
    }
    out[w++] = '\n';
  }
  return w;
}

/* d=1 internal-structure (-i) output (reference src/algod1.cc:791-846):
 * one row per member edge (parent, amp, 1, cluster, gen) plus a
 * (graft_parent, amp, 2, cluster, gen+1) row for grafted members. */
int64_t write_structure_d1(
    const uint8_t *hdr_arena, const int64_t *hdr_off, const int64_t *hdr_len,
    const int32_t *ab_start, const int32_t *ab_end, int usearch,
    const int64_t *members, const int64_t *bounds, const uint8_t *attached,
    int64_t nswarms, const int64_t *graft_cand, const int64_t *parent,
    const int64_t *generation, char *out, int64_t out_cap) {
  int64_t w = 0;
  int64_t cluster_no = 0;
  for (int64_t s = 0; s < nswarms; s++) {
    if (attached[s])
      continue;
    for (int64_t m = bounds[s] + 1; m < bounds[s + 1]; m++) {
      int64_t amp = members[m];
      int64_t g = graft_cand[amp];
      if (g >= 0) {
        if (w + hdr_len[g] + hdr_len[amp] + 64 > out_cap)
          return -1;
        w += emit_id_noab(hdr_arena + hdr_off[g], hdr_len[g], ab_start[g],
                          ab_end[g], usearch, out + w);
        out[w++] = '\t';
        w += emit_id_noab(hdr_arena + hdr_off[amp], hdr_len[amp],
                          ab_start[amp], ab_end[amp], usearch, out + w);
        out[w++] = '\t';
        out[w++] = '2';
        out[w++] = '\t';
        w += emit_u64((uint64_t)(cluster_no + 1), out + w);
        out[w++] = '\t';
        w += emit_u64((uint64_t)(generation[g] + 1), out + w);
        out[w++] = '\n';
      }
      int64_t pr = parent[amp];
      if (pr >= 0) {
        if (w + hdr_len[pr] + hdr_len[amp] + 64 > out_cap)
          return -1;
        w += emit_id_noab(hdr_arena + hdr_off[pr], hdr_len[pr], ab_start[pr],
                          ab_end[pr], usearch, out + w);
        out[w++] = '\t';
        w += emit_id_noab(hdr_arena + hdr_off[amp], hdr_len[amp],
                          ab_start[amp], ab_end[amp], usearch, out + w);
        out[w++] = '\t';
        out[w++] = '1';
        out[w++] = '\t';
        w += emit_u64((uint64_t)(cluster_no + 1), out + w);
        out[w++] = '\t';
        w += emit_u64((uint64_t)generation[amp], out + w);
        out[w++] = '\n';
      }
    }
    cluster_no++;
  }
  return w;
}

/* d=1 statistics output (cols 6 and 7 both print maxgen,
 * src/algod1.cc:1055-1057) */
int64_t write_stats_d1(
    const uint8_t *hdr_arena, const int64_t *hdr_off, const int64_t *hdr_len,
    const int32_t *ab_start, const int32_t *ab_end, const int64_t *abundance,
    int usearch, const int64_t *seed, const int64_t *size,
    const int64_t *mass, const int64_t *singletons, const int64_t *maxgen,
    const uint8_t *attached, int64_t nswarms, char *out, int64_t out_cap) {
  int64_t w = 0;
  for (int64_t s = 0; s < nswarms; s++) {
    if (attached[s])
      continue;
    int64_t a = seed[s];
    /* each line costs ~6 dependent cache misses (seed -> five index
     * arrays -> arena); two-stage pipeline: index arrays 16 ahead,
     * arena (which needs hdr_off loaded) 4 ahead */
    if (s + 16 < nswarms) {
      int64_t a16 = seed[s + 16];
      __builtin_prefetch(&hdr_off[a16]);
      __builtin_prefetch(&hdr_len[a16]);
      __builtin_prefetch(&ab_start[a16]);
      __builtin_prefetch(&ab_end[a16]);
      __builtin_prefetch(&abundance[a16]);
    }
    if (s + 4 < nswarms)
      __builtin_prefetch(hdr_arena + hdr_off[seed[s + 4]]);
    if (w + hdr_len[a] + 160 > out_cap)
      return -1;
    w += emit_u64((uint64_t)size[s], out + w);
    out[w++] = '\t';
    w += emit_u64((uint64_t)mass[s], out + w);
    out[w++] = '\t';
    w += emit_id_noab(hdr_arena + hdr_off[a], hdr_len[a], ab_start[a],
                      ab_end[a], usearch, out + w);
    out[w++] = '\t';
    w += emit_u64((uint64_t)abundance[a], out + w);
    out[w++] = '\t';
    w += emit_u64((uint64_t)singletons[s], out + w);
    out[w++] = '\t';
    w += emit_u64((uint64_t)maxgen[s], out + w);
    out[w++] = '\t';
    w += emit_u64((uint64_t)maxgen[s], out + w);
    out[w++] = '\n';
  }
  return w;
}

/* ------------------------------------------------------------------ */
/* d=0 dereplication grouping (reference src/derep.cc:276-354)         */
/* ------------------------------------------------------------------ */

/* Assign each record the cluster index of its first identical sequence
 * (clusters numbered in first-seen order). Returns cluster count. */
int64_t derep_groups(const uint8_t *codes, const int64_t *seq_off,
                     const int64_t *seq_len, int64_t n, int64_t *group) {
  uint64_t cap = 16;
  while (cap < (uint64_t)n * 2 + 8)
    cap <<= 1;
  int64_t *slots = malloc(cap * sizeof(int64_t)); /* first record idx */
  if (!slots)
    return -1;
  for (uint64_t i = 0; i < cap; i++)
    slots[i] = -1;

  int64_t nclusters = 0;
  for (int64_t k = 0; k < n; k++) {
    const uint8_t *s = codes + seq_off[k];
    uint64_t hash = fnv1a(s, seq_len[k]);
    uint64_t slot = hash & (cap - 1);
    for (;;) {
      int64_t other = slots[slot];
      if (other < 0) {
        slots[slot] = k;
        group[k] = nclusters++;
        break;
      }
      if (seq_len[other] == seq_len[k] &&
          memcmp(codes + seq_off[other], s, (size_t)seq_len[k]) == 0) {
        group[k] = group[other];
        break;
      }
      slot = (slot + 1) & (cap - 1);
    }
  }
  free(slots);
  return nclusters;
}

/* ------------------------------------------------------------------ */
/* exact batched cost-space NW with direction bits + backtrack         */
/* (the reference's hot kernel, src/search8/16.cc semantics; mirrors   */
/* swarm_tpu/ops/search.py bit-for-bit)                                */
/* ------------------------------------------------------------------ */

/* One query vs B targets. dirs is caller scratch [dlen_max * qlen].
 * Hbuf/Ebuf are caller scratch [qlen]. sat_max: 255 or 65535; scores
 * >= sat_max are rejected with diff = sat_max, alignlength = 0. */
void nw_diffs_batch(const uint8_t *qseq, int64_t qlen, const uint8_t *dseqs,
                    const int64_t *dlens, int64_t dlen_max, int64_t B,
                    int64_t mismatch, int64_t go, int64_t ge,
                    int64_t sat_max, uint8_t *dirs, int64_t *Hbuf,
                    int64_t *Ebuf, int64_t *scores, int64_t *diffs,
                    int64_t *alignlengths) {
  const int64_t Q = go + ge;
  const int64_t R = ge;
  for (int64_t b = 0; b < B; b++) {
    const uint8_t *dseq = dseqs + b * dlen_max;
    int64_t dlen = dlens[b];
    for (int64_t i = 0; i < qlen; i++) {
      Hbuf[i] = Q + i * R;
      Ebuf[i] = 2 * Q + i * R;
    }
    int64_t score = 0;
    for (int64_t row = 0; row < dlen; row++) {
      uint8_t dch = dseq[row];
      int64_t diag_boundary = row == 0 ? 0 : go + row * ge;
      int64_t F = 2 * go + (row + 2) * ge; /* F_in[0] */
      int64_t prev_H = 0;
      uint8_t *dirrow = dirs + row * qlen;
      for (int64_t i = 0; i < qlen; i++) {
        int64_t diag_in = i == 0 ? diag_boundary : prev_H;
        int64_t diag = diag_in + (dch == qseq[i] ? 0 : mismatch);
        int64_t E_in = Ebuf[i];
        int64_t pre = diag < E_in ? diag : E_in;
        int64_t Hnew = pre < F ? pre : F;

        uint8_t bits = 0;
        if (diag <= F)
          bits |= 1; /* BIT_UP */
        {
          int64_t m = diag < F ? diag : F;
          if (E_in <= m)
            bits |= 2; /* BIT_LEFT */
        }
        int64_t hq = Hnew + Q;
        if (hq <= F + R)
          bits |= 4; /* BIT_EXTUP */
        if (hq <= E_in + R)
          bits |= 8; /* BIT_EXTLEFT */
        dirrow[i] = bits;

        prev_H = Hbuf[i];
        Hbuf[i] = Hnew;
        Ebuf[i] = hq < E_in + R ? hq : E_in + R;
        /* F_in[i+1] = min(F_in[i] + R, pre[i] + Q) */
        int64_t openF = pre + Q;
        F = F + R < openF ? F + R : openF;
      }
      if (row + 1 == dlen)
        score = Hbuf[qlen - 1];
    }
    scores[b] = score;
    if (score >= sat_max) {
      diffs[b] = sat_max;
      alignlengths[b] = 0;
      continue;
    }
    /* backtrack along the tie-broken optimal path */
    {
      int64_t column = qlen - 1, row = dlen - 1;
      int64_t aligned = 0, matches = 0;
      int op = 0;
      while (column >= 0 && row >= 0) {
        aligned++;
        uint8_t cell = dirs[row * qlen + column];
        if (op == 1 && !(cell & 8)) {
          row--;
        } else if (op == 2 && !(cell & 4)) {
          column--;
        } else if (cell & 2) {
          row--;
          op = 1;
        } else if (!(cell & 1)) {
          column--;
          op = 2;
        } else {
          if (qseq[column] == dseq[row])
            matches++;
          column--;
          row--;
          op = 3;
        }
      }
      aligned += column + 1 + row + 1;
      diffs[b] = aligned - matches;
      alignlengths[b] = aligned;
    }
  }
}

/* ------------------------------------------------------------------ */
/* qgram parity profiles (reference src/qgram.cc:68-96)                */
/* ------------------------------------------------------------------ */

/* profiles: [n, 16] uint64, zeroed by caller. */
void qgram_profiles_native(const uint8_t *padded, const int64_t *lengths,
                           int64_t n, int64_t width, uint64_t *profiles) {
  for (int64_t s = 0; s < n; s++) {
    const uint8_t *row = padded + s * width;
    uint64_t *prof = profiles + s * 16;
    int64_t len = lengths[s];
    unsigned qgram = 0;
    for (int64_t p = 0; p < len; p++) {
      qgram = ((qgram << 2) | row[p]) & 1023;
      if (p >= 4)
        prof[qgram >> 6] ^= 1ULL << (qgram & 63);
    }
  }
}

/* arena (offset-based) variant: no padded matrix required. */
void qgram_profiles_arena(const uint8_t *arena, const int64_t *offsets,
                          const int64_t *lengths, int64_t n,
                          uint64_t *profiles) {
  for (int64_t s = 0; s < n; s++) {
    const uint8_t *row = arena + offsets[s];
    uint64_t *prof = profiles + s * 16;
    int64_t len = lengths[s];
    unsigned qgram = 0;
    for (int64_t p = 0; p < len; p++) {
      qgram = ((qgram << 2) | row[p]) & 1023;
      if (p >= 4)
        prof[qgram >> 6] ^= 1ULL << (qgram & 63);
    }
  }
}

/* ------------------------------------------------------------------ */
/* d>=2 per-(sub)seed candidate screens (reference src/algo.cc:384-531,*/
/* src/qgram.cc:239-264) — pool scan + qgram lower bound in one pass   */
/* ------------------------------------------------------------------ */

#if defined(__AVX512F__)
#include <immintrin.h>
#endif
#if defined(__AVX512VPOPCNTDQ__) && defined(__AVX512F__)
/* the 128-byte qgram parity profile is exactly two 512-bit lanes:
 * xor + vpopcntq + horizontal add */
static inline int64_t qgram_diffbits(const uint64_t *a, const uint64_t *b) {
  __m512i x0 = _mm512_xor_si512(_mm512_loadu_si512((const void *)a),
                                _mm512_loadu_si512((const void *)b));
  __m512i x1 = _mm512_xor_si512(_mm512_loadu_si512((const void *)(a + 8)),
                                _mm512_loadu_si512((const void *)(b + 8)));
  __m512i p = _mm512_add_epi64(_mm512_popcnt_epi64(x0),
                               _mm512_popcnt_epi64(x1));
  return (int64_t)_mm512_reduce_add_epi64(p);
}
#else
static inline int64_t qgram_diffbits(const uint64_t *a, const uint64_t *b) {
  int64_t bits = 0;
  for (int w = 0; w < 16; w++)
    bits += __builtin_popcountll(a[w] ^ b[w]);
  return bits;
}
#endif

static inline int64_t qgram_mindiff_one(const uint64_t *a, const uint64_t *b) {
  return (qgram_diffbits(a, b) + 9) / 10; /* ceil(diffbits/(2*qgram_len)) */
}



/* Gen-1 screen: walk the pool, apply the abundance rule, store the
 * exact qgram bound per (filtered) pool slot, record survivors <= d.
 * Returns the survivor count; n_pool_out gets the filtered pool size.
 *
 * Three branch-light passes: the data-dependent abundance filter is
 * isolated in a compaction pass so the qgram pass runs branch-free —
 * the unconditional xor+vpopcnt pipeline sustains ~0.5ns/element,
 * ~20x the branchy fused loop. out_ids doubles as the compacted
 * amplicon scratch (hits are a prefix rewrite of it). */
static int64_t d2_gen1_screen_core(
    const uint64_t *restrict profiles, const int64_t *restrict order,
    const int64_t *restrict abundances, int64_t *restrict diffest,
    int64_t swarmed, int64_t n, int64_t seed_amp, int64_t seed_ab,
    int no_break, int64_t d, int64_t *restrict out_positions,
    int64_t *restrict out_ids, int64_t *restrict n_pool_out,
    const uint64_t *restrict fold) {
  const uint64_t *seed_prof = profiles + seed_amp * 16;
  int64_t k = 0, hits = 0;
  /* pass 1: abundance-rule compaction */
  if (no_break) {
    for (int64_t i = swarmed; i < n; i++)
      out_ids[k++] = order[i];
  } else {
    for (int64_t i = swarmed; i < n; i++) {
      int64_t amp = order[i];
      out_ids[k] = amp;
      k += abundances[amp] <= seed_ab;
    }
  }
  /* pass 2: qgram bound for the compacted list. The pool scan is
   * memory-bandwidth-bound if it touches the 128-byte profiles
   * (~17 GB/s single-core here), so far elements are rejected from a
   * 16-byte XOR-FOLD sketch that stays L2-resident: fold(a)^fold(b) =
   * fold(a^b), and each folded bit is the XOR of 8 profile bits, so
   * popcount(fold diff) is a LOWER bound of the true diff bits — and
   * a tight one (~115 of ~300 for far pairs; near-exact for near
   * pairs). diffest then stores ceil(fold_bits/10) for far elements —
   * a parity-safe under-estimate: the subseed filter can only pass
   * MORE elements than the reference's, and every extra one fails the
   * subseed qgram check precisely because (by the Hamming triangle
   * inequality and radius >= edit distance to the swarm seed) a
   * subseed-accepted target always satisfies the exact filter. */
  if (fold != NULL) {
    const uint64_t sf0 = fold[2 * seed_amp], sf1 = fold[2 * seed_amp + 1];
    const int64_t bb = 10 * d;
    for (int64_t j = 0; j < k; j++) {
      const int64_t amp = out_ids[j];
      int64_t fb = __builtin_popcountll(sf0 ^ fold[2 * amp]) +
                   __builtin_popcountll(sf1 ^ fold[2 * amp + 1]);
      diffest[swarmed + j] =
          (fb > bb) ? (fb + 9) / 10
                    : qgram_mindiff_one(seed_prof, profiles + amp * 16);
    }
  } else {
    for (int64_t j = 0; j < k; j++) {
      if (j + 16 < k)
        __builtin_prefetch(profiles + out_ids[j + 16] * 16, 0, 1);
      diffest[swarmed + j] =
          qgram_mindiff_one(seed_prof, profiles + out_ids[j] * 16);
    }
  }
  /* pass 3: collect survivors (rare, branch is predictable) */
  for (int64_t j = 0; j < k; j++) {
    if (diffest[swarmed + j] <= d) {
      out_positions[hits] = swarmed + j;
      out_ids[hits] = out_ids[j];
      hits++;
    }
  }
  *n_pool_out = k;
  return hits;
}

int64_t d2_gen1_screen(const uint64_t *profiles, const int64_t *order,
                       const int64_t *abundances, int64_t *diffest,
                       int64_t swarmed, int64_t n, int64_t seed_amp,
                       int64_t seed_ab, int no_break, int64_t d,
                       int64_t *out_positions, int64_t *out_ids,
                       int64_t *n_pool_out) {
  return d2_gen1_screen_core(profiles, order, abundances, diffest, swarmed,
                             n, seed_amp, seed_ab, no_break, d, out_positions,
                             out_ids, n_pool_out, NULL);
}

/* Subseed screen: diffestimate bound + abundance rule + qgram bound.
 * The diffest filter passes a small fraction of the pool, so the scan
 * is vectorized: AVX-512 compares 8 bounds per step and only mask-set
 * lanes run the fuller checks (fold sketch first, profile last). */
static int64_t d2_subseed_screen_core(
    const uint64_t *restrict profiles, const int64_t *restrict order,
    const int64_t *restrict abundances, const int64_t *restrict diffest,
    int64_t swarmed, int64_t n, int64_t subseed_amp, int64_t bound,
    int64_t subseed_ab, int no_break, int64_t d,
    int64_t *restrict out_positions, int64_t *restrict out_ids,
    const uint64_t *restrict fold) {
  const uint64_t *sub_prof = profiles + subseed_amp * 16;
  const uint64_t sf0 = fold != NULL ? fold[2 * subseed_amp] : 0;
  const uint64_t sf1 = fold != NULL ? fold[2 * subseed_amp + 1] : 0;
  const int64_t bits_bound = 10 * d;
  int64_t hits = 0;
  int64_t i = swarmed;
#if defined(__AVX512F__)
  {
    const __m512i vbound = _mm512_set1_epi64(bound);
    for (; i + 8 <= n; i += 8) {
      __mmask8 m = _mm512_cmple_epi64_mask(
          _mm512_loadu_si512((const void *)(diffest + i)), vbound);
      while (m) {
        const int b = __builtin_ctz((unsigned)m);
        m = (__mmask8)(m & (m - 1));
        const int64_t pos = i + b;
        const int64_t amp = order[pos];
        if (!no_break && abundances[amp] > subseed_ab)
          continue;
        if (fold != NULL &&
            __builtin_popcountll(sf0 ^ fold[2 * amp]) +
                    __builtin_popcountll(sf1 ^ fold[2 * amp + 1]) >
                bits_bound)
          continue;
        if (qgram_diffbits(sub_prof, profiles + amp * 16) <= bits_bound) {
          out_positions[hits] = pos;
          out_ids[hits] = amp;
          hits++;
        }
      }
    }
  }
#endif
  for (; i < n; i++) {
    if (diffest[i] > bound)
      continue;
    int64_t amp = order[i];
    if (!no_break && abundances[amp] > subseed_ab)
      continue;
    if (fold != NULL &&
        __builtin_popcountll(sf0 ^ fold[2 * amp]) +
                __builtin_popcountll(sf1 ^ fold[2 * amp + 1]) >
            bits_bound)
      continue;
    if (qgram_diffbits(sub_prof, profiles + amp * 16) <= bits_bound) {
      out_positions[hits] = i;
      out_ids[hits] = amp;
      hits++;
    }
  }
  return hits;
}

int64_t d2_subseed_screen(const uint64_t *profiles, const int64_t *order,
                          const int64_t *abundances, const int64_t *diffest,
                          int64_t swarmed, int64_t n, int64_t subseed_amp,
                          int64_t bound, int64_t subseed_ab, int no_break,
                          int64_t d, int64_t *out_positions,
                          int64_t *out_ids) {
  return d2_subseed_screen_core(profiles, order, abundances, diffest,
                                swarmed, n, subseed_amp, bound, subseed_ab,
                                no_break, d, out_positions, out_ids, NULL);
}

/* ------------------------------------------------------------------ */
/* d=1 uclust writer (reference src/algod1.cc:852-934)                 */
/* ------------------------------------------------------------------ */

/* Returns bytes written or -1 when out_cap is insufficient. Scratch:
 * dirs >= longest^2, Hbuf/Ebuf >= longest, raw >= 2*longest+2,
 * cigar >= 8*2*longest+16. cluster_base offsets the C/S/H cluster
 * numbering (threaded ranges pass the count of non-attached swarms
 * before their range). */
/* ------------------------------------------------------------------ */
/* 16-lane batch of the uclust writer's banded aligner: the writer     */
/* replicates the reference's scalar nw() tie-break universe           */
/* (src/nw.cc), which differs from the search kernels' — so this is a  */
/* separate lane-parallel forward pass with nw_align_banded's exact    */
/* recurrences and direction bits. Lanes are independent (member,      */
/* seed) pairs gathered across swarms; per-lane scalar backtrack +     */
/* CIGAR RLE reads the lane-strided direction tile. Accepted results   */
/* are byte-identical to nw_align_banded's (the band-exit bound proof  */
/* holds per lane); rejected lanes escalate through the existing       */
/* scalar path.                                                        */
/* ------------------------------------------------------------------ */

#if defined(__AVX512F__) && defined(__AVX512BW__)
/* scratch (caller): qT/dT [maxlen*16], Hcol/Ecol [maxq] __m512i,
 * dirs_t [maxd * Bmax * 16], raw [2*maxlen + 2] per lane reused.
 * out3s[l*3+..] = diff, alen, cigar_len for accepted lanes;
 * cigars + l*cigar_stride receives the NUL-terminated cigar.
 * accepted[l]: 1 = result filled, 0 = escalate via the scalar path. */
static void uclust_align_batch16(
    const uint8_t *const *dseqs, const int64_t *dlens,
    const uint8_t *const *qseqs, const int64_t *qlens, int nlanes,
    int64_t mismatch, int64_t go, int64_t ge, int64_t w, uint8_t *dirs_t,
    uint8_t *qT, uint8_t *dT, __m512i *Hcol, __m512i *Ecol, char *raw,
    char *cigars, int64_t cigar_stride, int64_t *out3s, int *accepted) {
  const int64_t Q = go + ge, R = ge;
  int32_t qlen32[16], dlen32[16], wL32[16], wR32[16];
  int64_t maxq = 0, maxd = 0, wLmax = 0, wRmax = 0;
  uint16_t active = 0;
  for (int l = 0; l < 16; l++) {
    accepted[l] = 0;
    int64_t ql = l < nlanes ? qlens[l] : 0;
    int64_t dl = l < nlanes ? dlens[l] : 0;
    qlen32[l] = 0;
    dlen32[l] = 0;
    wL32[l] = 0;
    wR32[l] = 0;
    if (ql <= 0 || dl <= 0)
      continue;
    int64_t F = ql - dl;
    int64_t wL = w + (F < 0 ? -F : 0);
    int64_t wR = w + (F > 0 ? F : 0);
    active |= (uint16_t)(1u << l);
    qlen32[l] = (int32_t)ql;
    dlen32[l] = (int32_t)dl;
    wL32[l] = (int32_t)wL;
    wR32[l] = (int32_t)wR;
    if (ql > maxq)
      maxq = ql;
    if (dl > maxd)
      maxd = dl;
    if (wL > wLmax)
      wLmax = wL;
    if (wR > wRmax)
      wRmax = wR;
  }
  if (!active)
    return;
  const int64_t Bmax = wLmax + wRmax + 1;

  for (int l = 0; l < nlanes; l++) {
    if (!(active >> l & 1))
      continue;
    const uint8_t *q = qseqs[l];
    for (int64_t p = 0; p < qlen32[l]; p++)
      qT[p * 16 + l] = q[p];
    const uint8_t *dd = dseqs[l];
    for (int64_t p = 0; p < dlen32[l]; p++)
      dT[p * 16 + l] = dd[p];
  }

  const __m512i INFV = _mm512_set1_epi32(BAND_INF32);
  const __m512i QV = _mm512_set1_epi32((int32_t)Q);
  const __m512i RV = _mm512_set1_epi32((int32_t)R);
  const __m512i MMV = _mm512_set1_epi32((int32_t)mismatch);
  const __m512i qlenv = _mm512_loadu_si512((const void *)qlen32);
  const __m512i dlenv = _mm512_loadu_si512((const void *)dlen32);
  const __m512i wLv = _mm512_loadu_si512((const void *)wL32);
  const __m512i wRv = _mm512_loadu_si512((const void *)wR32);
  const __m512i qlm1 = _mm512_sub_epi32(qlenv, _mm512_set1_epi32(1));
  const __m512i dlm1 = _mm512_sub_epi32(dlenv, _mm512_set1_epi32(1));

  /* top boundary: Hbuf[c] = go+(c+1)ge for c <= min(wR, qlen-1),
   * INF elsewhere (per lane) */
  for (int64_t c = 0; c < maxq; c++) {
    const __m512i cv = _mm512_set1_epi32((int32_t)c);
    const __mmask16 m = _mm512_kand(_mm512_cmple_epi32_mask(cv, wRv),
                                    _mm512_cmplt_epi32_mask(cv, qlenv));
    Hcol[c] = _mm512_mask_mov_epi32(
        INFV, m, _mm512_set1_epi32((int32_t)(go + (c + 1) * ge)));
    Ecol[c] = _mm512_mask_mov_epi32(
        INFV, m, _mm512_set1_epi32((int32_t)(2 * go + (c + 2) * ge)));
  }

  __m512i cstarv = INFV;
  for (int64_t r = 0; r < maxd; r++) {
    const __m512i rv = _mm512_set1_epi32((int32_t)r);
    const __mmask16 m_rowlive = _mm512_cmplt_epi32_mask(rv, dlenv);
    const __mmask16 m_lastrow = _mm512_cmpeq_epi32_mask(rv, dlm1);
    const __m512i dvec = _mm512_cvtepu8_epi32(
        _mm_loadu_si128((const __m128i *)(dT + r * 16)));
    const __m512i bval =
        _mm512_set1_epi32((int32_t)(r == 0 ? 0 : go + r * ge));
    const __m512i tinit =
        _mm512_set1_epi32((int32_t)(2 * go + (r + 2) * ge));
    /* per-lane band columns this row */
    const __m512i cstartv = _mm512_max_epi32(_mm512_sub_epi32(rv, wLv),
                                             _mm512_setzero_si512());
    const __m512i cendv =
        _mm512_min_epi32(qlm1, _mm512_add_epi32(rv, wRv));
    /* T starts at the boundary only when the band touches column 0 */
    __m512i Tv = _mm512_mask_mov_epi32(
        INFV, _mm512_cmple_epi32_mask(rv, wLv), tinit);
    int64_t clo = r - wLmax > 0 ? r - wLmax : 0;
    int64_t chi = r + wRmax < maxq - 1 ? r + wRmax : maxq - 1;
    uint8_t *dirrow = dirs_t + r * Bmax * 16;
    /* diag-in for the first visited column: H[r-1][clo-1] when the
     * global band has left column 0 (the scalar's prev_H), else the
     * c == 0 boundary handled inside the loop */
    __m512i prevH = clo > 0 ? Hcol[clo - 1] : bval;
    for (int64_t c = clo; c <= chi; c++) {
      const __m512i cv = _mm512_set1_epi32((int32_t)c);
      const __mmask16 inb = _mm512_kand(
          _mm512_kand(_mm512_cmpge_epi32_mask(cv, cstartv),
                      _mm512_cmple_epi32_mask(cv, cendv)),
          m_rowlive);
      const __m512i qvec = _mm512_cvtepu8_epi32(
          _mm_loadu_si128((const __m128i *)(qT + c * 16)));
      const __m512i diag_in = c == 0 ? bval : prevH;
      const __mmask16 m_eq = _mm512_cmpeq_epi32_mask(dvec, qvec);
      const __m512i diag = _mm512_add_epi32(
          diag_in, _mm512_mask_mov_epi32(MMV, m_eq, _mm512_setzero_si512()));
      const __m512i left = Ecol[c];
      const __m512i pre = _mm512_min_epi32(diag, left);
      const __m512i top = Tv;
      const __m512i newH = _mm512_min_epi32(pre, top);
      /* direction bits, verbatim nw_align_banded semantics */
      const __mmask16 b1 = _mm512_cmplt_epi32_mask(top, diag);
      const __m512i after_top = _mm512_min_epi32(diag, top);
      const __mmask16 b2 = _mm512_cmple_epi32_mask(left, after_top);
      const __m512i diag2 = _mm512_add_epi32(newH, QV);
      const __m512i left2 = _mm512_add_epi32(left, RV);
      const __m512i top2 = _mm512_add_epi32(top, RV);
      const __mmask16 b4 = _mm512_cmplt_epi32_mask(top2, diag2);
      const __mmask16 b8 = _mm512_cmplt_epi32_mask(left2, diag2);
      __m512i bits = _mm512_maskz_set1_epi32(b1, 1);
      bits = _mm512_mask_add_epi32(bits, b2, bits, _mm512_set1_epi32(2));
      bits = _mm512_mask_add_epi32(bits, b4, bits, _mm512_set1_epi32(4));
      bits = _mm512_mask_add_epi32(bits, b8, bits, _mm512_set1_epi32(8));
      _mm_storeu_si128(
          (__m128i *)(dirrow + (c - (r - wLmax)) * 16),
          _mm512_cvtepi32_epi8(bits));
      /* masked state updates: untouched columns keep last row's
       * values, exactly like the scalar's partial sweep */
      prevH = Hcol[c];
      Hcol[c] = _mm512_mask_mov_epi32(Hcol[c], inb, newH);
      Ecol[c] = _mm512_mask_mov_epi32(Ecol[c], inb,
                                      _mm512_min_epi32(diag2, left2));
      const __m512i open2 = _mm512_add_epi32(pre, QV);
      Tv = _mm512_mask_mov_epi32(
          Tv, inb, _mm512_min_epi32(_mm512_add_epi32(top, RV), open2));
      const __mmask16 m_score = _mm512_kand(
          _mm512_kand(m_lastrow, _mm512_cmpeq_epi32_mask(cv, qlm1)), inb);
      cstarv = _mm512_mask_mov_epi32(cstarv, m_score, newH);
    }
  }

  int32_t cstars[16];
  _mm512_storeu_si512((void *)cstars, cstarv);
  for (int l = 0; l < nlanes; l++) {
    if (!(active >> l & 1))
      continue;
    const int64_t qlen = qlen32[l], dlen = dlen32[l];
    const int64_t wL = wL32[l], wR = wR32[l];
    const int64_t B_l = wL + wR + 1;
    if (B_l >= qlen)
      continue; /* band covers the matrix: scalar path decides */
    const int64_t absF = qlen >= dlen ? qlen - dlen : dlen - qlen;
    if ((int64_t)cstars[l] >= go + ge * (2 * (w + 1) + absF))
      continue; /* band exit: escalate via the scalar path */
    /* backtrack — same decision order as nw_align_banded; the tile is
     * indexed by diagonal offset + wLmax, lane-strided */
    const uint8_t *qseq = qseqs[l];
    const uint8_t *dseq = dseqs[l];
    int64_t column = qlen, row = dlen;
    int64_t pos = qlen + dlen;
    const int64_t total = pos;
    int64_t matches = 0;
    char operation = 0;
    int ok = 1;
    while (column > 0 && row > 0) {
      const int64_t r1 = row - 1;
      const int64_t joff = (column - 1) - r1 + wLmax;
      if ((column - 1) < r1 - wL || (column - 1) > r1 + wR || joff < 0 ||
          joff >= Bmax) {
        ok = 0; /* defensive: cannot happen when the bound held */
        break;
      }
      const uint8_t cell = dirs_t[(r1 * Bmax + joff) * 16 + l];
      if (operation == 'I' && (cell & 8)) {
        row--;
        raw[--pos] = 'I';
      } else if (operation == 'D' && (cell & 4)) {
        column--;
        raw[--pos] = 'D';
      } else if (cell & 2) {
        row--;
        raw[--pos] = 'I';
        operation = 'I';
      } else if (cell & 1) {
        column--;
        raw[--pos] = 'D';
        operation = 'D';
      } else {
        if (qseq[column - 1] == dseq[row - 1])
          matches++;
        column--;
        row--;
        raw[--pos] = 'M';
        operation = 'M';
      }
    }
    if (!ok)
      continue;
    while (column > 0) {
      column--;
      raw[--pos] = 'D';
    }
    while (row > 0) {
      row--;
      raw[--pos] = 'I';
    }
    const int64_t alen = total - pos;
    char *cigar = cigars + l * cigar_stride;
    int64_t clen = 0;
    int64_t i = pos;
    while (i < total) {
      const char ch = raw[i];
      int64_t cnt = 1;
      while (i + cnt < total && raw[i + cnt] == ch)
        cnt++;
      if (cnt > 1)
        clen += emit_u64((uint64_t)cnt, cigar + clen);
      cigar[clen++] = ch;
      i += cnt;
    }
    cigar[clen] = 0;
    out3s[l * 3 + 0] = alen - matches;
    out3s[l * 3 + 1] = alen;
    out3s[l * 3 + 2] = clen;
    accepted[l] = 1;
  }
}
#endif /* AVX512 */

/* Per-range cache of batch-aligned H-line results: slot m - m0 holds
 * (diff, alen, cigar) when the 16-lane band-4 pass accepted that
 * member; -1 slots take the writer's scalar ladder unchanged. An
 * accepted batch result is byte-identical to the scalar bw=4 rung
 * (same recurrences, bits and band-exit bound), so consulting the
 * cache cannot change the output. */
typedef struct {
  int64_t m0;
  int32_t *clen; /* per member slot: cigar length, -1 = unresolved */
  int32_t *meta; /* per member slot: diff, alen */
  int64_t *coff; /* per member slot: arena offset of the cigar */
  char *arena;
  int64_t arena_len, arena_cap;
} uclust_batch_t;

static void uclust_batch_free(uclust_batch_t *ub) {
  free(ub->clen);
  free(ub->meta);
  free(ub->coff);
  free(ub->arena);
  memset(ub, 0, sizeof(*ub));
}

static void uclust_batch_prepass(
    uclust_batch_t *ub, const uint8_t *codes, const int64_t *seq_off,
    const int64_t *seq_len, const int64_t *members, const int64_t *bounds,
    const uint8_t *attached, int64_t nswarms, const int64_t *swarm_seed,
    int64_t mismatch, int64_t go, int64_t ge, char *raw) {
  memset(ub, 0, sizeof(*ub));
#if defined(__AVX512F__) && defined(__AVX512BW__)
  enum { BW = 4, FCAP = 16, LCAP = 4096 };
  const int64_t Bcap = 2 * BW + 2 * FCAP + 1;
  const int64_t CSTRIDE = 4 * LCAP + 32;
  const int64_t total = nswarms > 0 ? bounds[nswarms] - bounds[0] : 0;
  if (total < 64)
    return; /* batch + scratch setup not worth it */
  const int64_t pen = mismatch > go + ge ? mismatch : go + ge;
  if (pen <= 0 || pen >= 65536)
    return; /* int32 headroom proof: values <= INF + ~(2L+B)*pen */
  const int64_t m0 = bounds[0];

  int32_t *clen = (int32_t *)malloc((size_t)total * 4);
  int32_t *meta = (int32_t *)malloc((size_t)total * 8);
  int64_t *coff = (int64_t *)malloc((size_t)total * 8);
  uint8_t *qT = (uint8_t *)malloc(LCAP * 16);
  uint8_t *dT = (uint8_t *)malloc(LCAP * 16);
  __m512i *Hcol = (__m512i *)aligned_alloc(64, LCAP * 64);
  __m512i *Ecol = (__m512i *)aligned_alloc(64, LCAP * 64);
  uint8_t *dirs_t = (uint8_t *)malloc((size_t)(LCAP * Bcap * 16));
  char *cig16 = (char *)malloc((size_t)(16 * CSTRIDE));
  const uint8_t **pd =
      (const uint8_t **)malloc((size_t)total * sizeof(void *));
  const uint8_t **pq =
      (const uint8_t **)malloc((size_t)total * sizeof(void *));
  int64_t *pdl = (int64_t *)malloc((size_t)total * 8);
  int64_t *pql = (int64_t *)malloc((size_t)total * 8);
  int64_t *pm = (int64_t *)malloc((size_t)total * 8);
  char *arena = (char *)malloc(1 << 16);
  if (!clen || !meta || !coff || !qT || !dT || !Hcol || !Ecol || !dirs_t ||
      !cig16 || !pd || !pq || !pdl || !pql || !pm || !arena)
    goto fail;
  memset(clen, 0xff, (size_t)total * 4); /* all slots -1 */

  /* collect the members the substitution fast path won't cover */
  int64_t npend = 0;
  for (int64_t s = 0; s < nswarms; s++) {
    if (attached[s])
      continue;
    const int64_t seed = swarm_seed[s];
    const uint8_t *qseq = codes + seq_off[seed];
    const int64_t qlen = seq_len[seed];
    if (qlen > LCAP)
      continue;
    for (int64_t m = bounds[s] + 1; m < bounds[s + 1]; m++) {
      const int64_t amp = members[m];
      const int64_t dlen = seq_len[amp];
      if (dlen == qlen) {
        const uint8_t *ds = codes + seq_off[amp];
        int64_t h = 0;
        for (int64_t p = 0; p < qlen; p++)
          h += ds[p] != qseq[p];
        if (h * mismatch < 2 * (go + ge))
          continue; /* emission's fast path owns it */
      }
      const int64_t F = qlen - dlen;
      const int64_t aF = F < 0 ? -F : F;
      if (aF > FCAP || dlen > LCAP || dlen <= 0)
        continue;
      if (2 * BW + aF + 1 >= qlen)
        continue; /* band covers the matrix: scalar path decides */
      pd[npend] = codes + seq_off[amp];
      pdl[npend] = dlen;
      pq[npend] = qseq;
      pql[npend] = qlen;
      pm[npend] = m;
      npend++;
    }
  }

  for (int64_t i = 0; i < npend; i += 16) {
    const int nl = npend - i < 16 ? (int)(npend - i) : 16;
    int64_t out3s[48];
    int acc[16];
    uclust_align_batch16(pd + i, pdl + i, pq + i, pql + i, nl, mismatch, go,
                         ge, BW, dirs_t, qT, dT, Hcol, Ecol, raw, cig16,
                         CSTRIDE, out3s, acc);
    for (int l = 0; l < nl; l++) {
      if (!acc[l])
        continue;
      const int64_t cl = out3s[l * 3 + 2];
      if (ub->arena_len + cl + 1 > (arena ? ub->arena_cap : 0)) {
        int64_t nc = ub->arena_cap > 0 ? ub->arena_cap : 1 << 16;
        while (ub->arena_len + cl + 1 > nc)
          nc *= 2;
        char *nb = (char *)realloc(arena, (size_t)nc);
        if (!nb)
          goto fail;
        arena = nb;
        ub->arena_cap = nc;
      }
      const int64_t bi = pm[i + l] - m0;
      memcpy(arena + ub->arena_len, cig16 + l * CSTRIDE, (size_t)cl + 1);
      clen[bi] = (int32_t)cl;
      meta[bi * 2 + 0] = (int32_t)out3s[l * 3 + 0];
      meta[bi * 2 + 1] = (int32_t)out3s[l * 3 + 1];
      coff[bi] = ub->arena_len;
      ub->arena_len += cl + 1;
    }
  }

  if (getenv("SWARM_UC_DEBUG")) {
    int64_t hits = 0;
    for (int64_t i = 0; i < total; i++)
      hits += clen[i] >= 0;
    fprintf(stderr, "[uc_batch] total=%lld pend=%lld accepted=%lld\n",
            (long long)total, (long long)npend, (long long)hits);
  }
  free(qT);
  free(dT);
  free(Hcol);
  free(Ecol);
  free(dirs_t);
  free(cig16);
  free(pd);
  free(pq);
  free(pdl);
  free(pql);
  free(pm);
  ub->m0 = m0;
  ub->clen = clen;
  ub->meta = meta;
  ub->coff = coff;
  ub->arena = arena;
  return;
fail:
  free(clen);
  free(meta);
  free(coff);
  free(qT);
  free(dT);
  free(Hcol);
  free(Ecol);
  free(dirs_t);
  free(cig16);
  free(pd);
  free(pq);
  free(pdl);
  free(pql);
  free(pm);
  free(arena);
  memset(ub, 0, sizeof(*ub));
#else
  (void)codes;
  (void)seq_off;
  (void)seq_len;
  (void)members;
  (void)bounds;
  (void)attached;
  (void)nswarms;
  (void)swarm_seed;
  (void)mismatch;
  (void)go;
  (void)ge;
  (void)raw;
#endif
}

static int64_t uclust_range_emit(
    const uint8_t *codes, const int64_t *seq_off, const int64_t *seq_len,
    const uint8_t *hdr_arena, const int64_t *hdr_off, const int64_t *hdr_len,
    const int32_t *ab_start, const int32_t *ab_end, const int64_t *abundance,
    int64_t append_ab, int usearch,
    const int64_t *members, const int64_t *bounds, const uint8_t *attached,
    int64_t nswarms, const int64_t *swarm_seed, const int64_t *swarm_size,
    int64_t mismatch, int64_t go, int64_t ge, int64_t cluster_base,
    uint8_t *dirs, int64_t *Hbuf, int64_t *Ebuf, char *raw, char *cigar,
    char *out, int64_t out_cap, const uclust_batch_t *ub) {
  int64_t w = 0;
  int64_t cluster_no = cluster_base;
  char seed_id[1 << 16];
  int64_t pid_key[256];
  char pid_str[256][8];
  int pid_len[256];
  for (int i = 0; i < 256; i++)
    pid_key[i] = -1;
  for (int64_t s = 0; s < nswarms; s++) {
    if (attached[s])
      continue;
    int64_t seed = swarm_seed[s];
    if (hdr_len[seed] + 32 > (1 << 16))
      return -2; /* pathological header length: caller falls back */
    int64_t sid_len = emit_id(hdr_arena + hdr_off[seed], hdr_len[seed],
                              ab_start[seed], ab_end[seed], abundance[seed],
                              append_ab, usearch, seed_id);
    if (w + 2 * sid_len + 128 > out_cap)
      return -1;
    out[w++] = 'C';
    out[w++] = '\t';
    w += emit_u64((uint64_t)cluster_no, out + w);
    out[w++] = '\t';
    w += emit_u64((uint64_t)swarm_size[s], out + w);
    memcpy(out + w, "\t*\t*\t*\t*\t*\t", 11);
    w += 11;
    memcpy(out + w, seed_id, (size_t)sid_len);
    w += sid_len;
    memcpy(out + w, "\t*\nS\t", 5);
    w += 5;
    w += emit_u64((uint64_t)cluster_no, out + w);
    out[w++] = '\t';
    w += emit_u64((uint64_t)seq_len[seed], out + w);
    memcpy(out + w, "\t*\t*\t*\t*\t*\t", 11);
    w += 11;
    memcpy(out + w, seed_id, (size_t)sid_len);
    w += sid_len;
    out[w++] = '\t';
    out[w++] = '*';
    out[w++] = '\n';

    const uint8_t *qseq = codes + seq_off[seed];
    int64_t qlen = seq_len[seed];
    for (int64_t m = bounds[s] + 1; m < bounds[s + 1]; m++) {
      int64_t amp = members[m];
      int64_t out3[3];
      int done = 0;
      /* substitution-only fast path: at equal lengths, any alignment
       * with an indel pays >= 2*(go+ge), so when hamming*mismatch is
       * strictly below that the all-M alignment is the UNIQUE cost
       * optimum — the DP and its tie-breaks are forced, the cigar is
       * "<L>M" and diff = hamming. Covers every pure-substitution
       * member at ~20ns instead of a banded DP. */
      if (seq_len[amp] == qlen) {
        const uint8_t *ds = codes + seq_off[amp];
        int64_t h = 0;
        for (int64_t p = 0; p < qlen; p++)
          h += ds[p] != qseq[p];
        if (h * mismatch < 2 * (go + ge)) {
          out3[0] = h;
          out3[1] = qlen;
          int64_t cl = emit_u64((uint64_t)qlen, cigar);
          cigar[cl++] = 'M';
          cigar[cl] = 0;
          out3[2] = cl;
          done = 1;
        }
      }
      /* 16-lane batch pre-pass cache: byte-identical to the bw=4
       * scalar rung below, so a hit just skips that DP */
      if (!done && ub->clen != NULL && ub->clen[m - ub->m0] >= 0) {
        const int64_t bi = m - ub->m0;
        out3[0] = ub->meta[bi * 2 + 0];
        out3[1] = ub->meta[bi * 2 + 1];
        out3[2] = ub->clen[bi];
        memcpy(cigar, ub->arena + ub->coff[bi], (size_t)out3[2] + 1);
        done = 1;
      }
      /* swarm members sit a few edits from their seed: a narrow banded
       * DP (output-identical by the band-exit cost bound, see
       * nw_align_banded) covers almost every pair; escalate, then fall
       * back to the full matrix. Starting at bw=4 nearly halves the
       * DP cells of the common case (members are 1-3 generations from
       * the seed); deep-generation members escalate. */
      for (int64_t bw = 4; !done && bw <= 64; bw *= 4)
        done = nw_align_banded(codes + seq_off[amp], seq_len[amp], qseq,
                               qlen, mismatch, go, ge, bw, dirs, Hbuf,
                               Ebuf, raw, cigar, out3);
      if (!done)
        nw_align(codes + seq_off[amp], seq_len[amp], qseq, qlen, mismatch,
                 go, ge, dirs, Hbuf, Ebuf, raw, cigar, out3);
      double percentid = 100.0 * (double)(out3[1] - out3[0]) / (double)out3[1];
      if (w + hdr_len[amp] + sid_len + out3[2] + 128 > out_cap)
        return -1;
      out[w++] = 'H';
      out[w++] = '\t';
      w += emit_u64((uint64_t)cluster_no, out + w);
      out[w++] = '\t';
      w += emit_u64((uint64_t)seq_len[amp], out + w);
      out[w++] = '\t';
      /* %.1f byte-exactly via glibc, memoized: (diff, alen) pairs
       * repeat heavily (members are 1-3 edits from their seed) */
      {
        int64_t pk = (out3[0] << 32) | out3[1];
        int slot = (int)(((uint64_t)pk * 0x9E3779B97F4A7C15ULL) >> 56);
        if (pid_key[slot] != pk) {
          pid_key[slot] = pk;
          pid_len[slot] = sprintf(pid_str[slot], "%.1f", percentid);
        }
        memcpy(out + w, pid_str[slot], (size_t)pid_len[slot]);
        w += pid_len[slot];
      }
      memcpy(out + w, "\t+\t0\t0\t", 7);
      w += 7;
      if (out3[0] > 0) {
        memcpy(out + w, cigar, (size_t)out3[2]);
        w += out3[2];
      } else {
        out[w++] = '=';
      }
      out[w++] = '\t';
      w += emit_id(hdr_arena + hdr_off[amp], hdr_len[amp], ab_start[amp],
                   ab_end[amp], abundance[amp], append_ab, usearch, out + w);
      out[w++] = '\t';
      memcpy(out + w, seed_id, (size_t)sid_len);
      w += sid_len;
      out[w++] = '\n';
    }
    cluster_no++;
  }
  return w;
}

int64_t write_uclust_d1_range(
    const uint8_t *codes, const int64_t *seq_off, const int64_t *seq_len,
    const uint8_t *hdr_arena, const int64_t *hdr_off, const int64_t *hdr_len,
    const int32_t *ab_start, const int32_t *ab_end, const int64_t *abundance,
    int64_t append_ab, int usearch,
    const int64_t *members, const int64_t *bounds, const uint8_t *attached,
    int64_t nswarms, const int64_t *swarm_seed, const int64_t *swarm_size,
    int64_t mismatch, int64_t go, int64_t ge, int64_t cluster_base,
    uint8_t *dirs, int64_t *Hbuf, int64_t *Ebuf, char *raw, char *cigar,
    char *out, int64_t out_cap) {
  uclust_batch_t ub;
  uclust_batch_prepass(&ub, codes, seq_off, seq_len, members, bounds,
                       attached, nswarms, swarm_seed, mismatch, go, ge, raw);
  int64_t w = uclust_range_emit(
      codes, seq_off, seq_len, hdr_arena, hdr_off, hdr_len, ab_start, ab_end,
      abundance, append_ab, usearch, members, bounds, attached, nswarms,
      swarm_seed, swarm_size, mismatch, go, ge, cluster_base, dirs, Hbuf,
      Ebuf, raw, cigar, out, out_cap, &ub);
  uclust_batch_free(&ub);
  return w;
}

int64_t write_uclust_d1(
    const uint8_t *codes, const int64_t *seq_off, const int64_t *seq_len,
    const uint8_t *hdr_arena, const int64_t *hdr_off, const int64_t *hdr_len,
    const int32_t *ab_start, const int32_t *ab_end, const int64_t *abundance,
    int64_t append_ab, int usearch,
    const int64_t *members, const int64_t *bounds, const uint8_t *attached,
    int64_t nswarms, const int64_t *swarm_seed, const int64_t *swarm_size,
    int64_t mismatch, int64_t go, int64_t ge,
    uint8_t *dirs, int64_t *Hbuf, int64_t *Ebuf, char *raw, char *cigar,
    char *out, int64_t out_cap) {
  return write_uclust_d1_range(
      codes, seq_off, seq_len, hdr_arena, hdr_off, hdr_len, ab_start, ab_end,
      abundance, append_ab, usearch, members, bounds, attached, nswarms,
      swarm_seed, swarm_size, mismatch, go, ge, 0, dirs, Hbuf, Ebuf, raw,
      cigar, out, out_cap);
}

/* d=1 network dump (reference src/algod1.cc:755-788); the CSR edge
 * list arrives sorted by (from, to), so per-amplicon targets are
 * already ascending. Returns bytes written or -1 on short buffer. */
int64_t write_network_d1(
    const uint8_t *hdr_arena, const int64_t *hdr_off, const int64_t *hdr_len,
    const int32_t *ab_start, const int32_t *ab_end, const int64_t *abundance,
    int64_t append_ab, int usearch,
    const int64_t *link_start, const int64_t *link_count,
    const int64_t *edges_to, int64_t n, char *out, int64_t out_cap) {
  int64_t w = 0;
  for (int64_t amp = 0; amp < n; amp++) {
    int64_t cnt = link_count[amp];
    if (cnt == 0)
      continue;
    char amp_id[1 << 16];
    if (hdr_len[amp] + 32 > (1 << 16))
      return -2;
    int64_t aid_len = emit_id(hdr_arena + hdr_off[amp], hdr_len[amp],
                              ab_start[amp], ab_end[amp], abundance[amp],
                              append_ab, usearch, amp_id);
    const int64_t *tgts = edges_to + link_start[amp];
    for (int64_t e = 0; e < cnt; e++) {
      int64_t tgt = tgts[e];
      if (w + aid_len + hdr_len[tgt] + 34 > out_cap)
        return -1;
      memcpy(out + w, amp_id, (size_t)aid_len);
      w += aid_len;
      out[w++] = '\t';
      w += emit_id(hdr_arena + hdr_off[tgt], hdr_len[tgt], ab_start[tgt],
                   ab_end[tgt], abundance[tgt], append_ab, usearch, out + w);
      out[w++] = '\n';
    }
  }
  return w;
}

/* ------------------------------------------------------------------ */
/* libstdc++-exact std::sort for the d>=2 seeds vector                 */
/* ------------------------------------------------------------------ */

/* The reference sorts its per-swarm seed list with std::sort and a
 * comparator whose tie branch tests `strcmp(...) == -1`
 * (src/algo.cc:161-183). glibc strcmp returns the difference of the
 * first differing unsigned bytes, so two equal-mass seeds compare
 * "equal" in BOTH directions unless that difference is exactly -1 —
 * the comparator is not a strict weak order, and the final order of
 * such ties is whatever GCC's introsort leaves behind. Byte parity
 * therefore requires replicating the exact introsort of
 * bits/stl_algo.h + stl_heap.h (GCC 12): median-of-3 quicksort above
 * 16 elements, heapsort at depth limit 2*floor(log2 n), one final
 * insertion-sort pass. */

typedef struct {
  int64_t mass;
  int64_t seed;
} seedrec_t;

typedef struct {
  const uint8_t *arena;
  const int64_t *off;
  const int64_t *len;
} hdrctx_t;

/* glibc strcmp semantics on length-delimited headers (headers never
 * contain NUL; the implicit terminator ends the shorter one) */
static int hdr_strcmp(const hdrctx_t *c, int64_t x, int64_t y) {
  const uint8_t *a = c->arena + c->off[x];
  const uint8_t *b = c->arena + c->off[y];
  int64_t la = c->len[x], lb = c->len[y];
  int64_t n = la < lb ? la : lb;
  for (int64_t i = 0; i < n; i++)
    if (a[i] != b[i])
      return (int)a[i] - (int)b[i];
  if (la == lb)
    return 0;
  return la < lb ? -(int)b[n] : (int)a[n];
}

/* the reference comparator (src/algo.cc:165-179) */
static int seeds_lt(const hdrctx_t *c, seedrec_t lhs, seedrec_t rhs) {
  if (lhs.mass > rhs.mass)
    return 1;
  if (lhs.mass < rhs.mass)
    return 0;
  return hdr_strcmp(c, lhs.seed, rhs.seed) == -1;
}

/* stl_heap.h __push_heap */
static void seeds_push_heap(const hdrctx_t *c, seedrec_t *first, int64_t hole,
                            int64_t top, seedrec_t value) {
  int64_t parent = (hole - 1) / 2;
  while (hole > top && seeds_lt(c, first[parent], value)) {
    first[hole] = first[parent];
    hole = parent;
    parent = (hole - 1) / 2;
  }
  first[hole] = value;
}

/* stl_heap.h __adjust_heap: sift the hole down to a leaf, then back up */
static void seeds_adjust_heap(const hdrctx_t *c, seedrec_t *first,
                              int64_t hole, int64_t len, seedrec_t value) {
  const int64_t top = hole;
  int64_t second = hole;
  while (second < (len - 1) / 2) {
    second = 2 * (second + 1);
    if (seeds_lt(c, first[second], first[second - 1]))
      second--;
    first[hole] = first[second];
    hole = second;
  }
  if ((len & 1) == 0 && second == (len - 2) / 2) {
    second = 2 * (second + 1);
    first[hole] = first[second - 1];
    hole = second - 1;
  }
  seeds_push_heap(c, first, hole, top, value);
}

/* stl_heap.h __pop_heap */
static void seeds_pop_heap(const hdrctx_t *c, seedrec_t *first,
                           seedrec_t *last, seedrec_t *result) {
  seedrec_t value = *result;
  *result = *first;
  seeds_adjust_heap(c, first, 0, last - first, value);
}

/* stl_heap.h __make_heap */
static void seeds_make_heap(const hdrctx_t *c, seedrec_t *first,
                            seedrec_t *last) {
  if (last - first < 2)
    return;
  const int64_t len = last - first;
  int64_t parent = (len - 2) / 2;
  while (1) {
    seeds_adjust_heap(c, first, parent, len, first[parent]);
    if (parent == 0)
      return;
    parent--;
  }
}

/* __partial_sort(first, last, last): __heap_select degenerates to
 * __make_heap (its scan loop is empty when middle == last) */
static void seeds_heapsort(const hdrctx_t *c, seedrec_t *first,
                           seedrec_t *last) {
  seeds_make_heap(c, first, last);
  while (last - first > 1) {
    --last;
    seeds_pop_heap(c, first, last, last);
  }
}

/* stl_algo.h __unguarded_linear_insert */
static void seeds_unguarded_linear_insert(const hdrctx_t *c, seedrec_t *last) {
  seedrec_t val = *last;
  seedrec_t *next = last - 1;
  while (seeds_lt(c, val, *next)) {
    *last = *next;
    last = next;
    --next;
  }
  *last = val;
}

/* stl_algo.h __insertion_sort */
static void seeds_insertion_sort(const hdrctx_t *c, seedrec_t *first,
                                 seedrec_t *last) {
  if (first == last)
    return;
  for (seedrec_t *i = first + 1; i != last; ++i) {
    if (seeds_lt(c, *i, *first)) {
      seedrec_t val = *i;
      memmove(first + 1, first, (size_t)(i - first) * sizeof(seedrec_t));
      *first = val;
    } else {
      seeds_unguarded_linear_insert(c, i);
    }
  }
}

#define SEEDS_SORT_THRESHOLD 16

/* stl_algo.h __move_median_to_first */
static void seeds_move_median_to_first(const hdrctx_t *c, seedrec_t *result,
                                       seedrec_t *a, seedrec_t *b,
                                       seedrec_t *d) {
#define SEEDS_SWAP(x)                                                         \
  do {                                                                        \
    seedrec_t t = *result;                                                    \
    *result = *(x);                                                           \
    *(x) = t;                                                                 \
  } while (0)
  if (seeds_lt(c, *a, *b)) {
    if (seeds_lt(c, *b, *d))
      SEEDS_SWAP(b);
    else if (seeds_lt(c, *a, *d))
      SEEDS_SWAP(d);
    else
      SEEDS_SWAP(a);
  } else if (seeds_lt(c, *a, *d))
    SEEDS_SWAP(a);
  else if (seeds_lt(c, *b, *d))
    SEEDS_SWAP(d);
  else
    SEEDS_SWAP(b);
#undef SEEDS_SWAP
}

/* stl_algo.h __unguarded_partition(_pivot) */
static seedrec_t *seeds_partition_pivot(const hdrctx_t *c, seedrec_t *first,
                                        seedrec_t *last) {
  seedrec_t *mid = first + (last - first) / 2;
  seeds_move_median_to_first(c, first, first + 1, mid, last - 1);
  seedrec_t *pivot = first;
  seedrec_t *lo = first + 1;
  seedrec_t *hi = last;
  while (1) {
    while (seeds_lt(c, *lo, *pivot))
      ++lo;
    --hi;
    while (seeds_lt(c, *pivot, *hi))
      --hi;
    if (!(lo < hi))
      return lo;
    seedrec_t t = *lo;
    *lo = *hi;
    *hi = t;
    ++lo;
  }
}

/* stl_algo.h __introsort_loop */
static void seeds_introsort_loop(const hdrctx_t *c, seedrec_t *first,
                                 seedrec_t *last, int depth) {
  while (last - first > SEEDS_SORT_THRESHOLD) {
    if (depth == 0) {
      seeds_heapsort(c, first, last);
      return;
    }
    --depth;
    seedrec_t *cut = seeds_partition_pivot(c, first, last);
    seeds_introsort_loop(c, cut, last, depth);
    last = cut;
  }
}

/* std::sort(seeds) as the reference compiles it. mass/seed are
 * parallel arrays, permuted in place. Returns 0, or -1 on alloc
 * failure (caller falls back to the Python mirror). */
int sort_seeds_stdcxx(int64_t *mass, int64_t *seed, int64_t n,
                      const uint8_t *hdr_arena, const int64_t *hdr_off,
                      const int64_t *hdr_len) {
  if (n < 2)
    return 0;
  hdrctx_t ctx = {hdr_arena, hdr_off, hdr_len};
  seedrec_t *recs = (seedrec_t *)malloc((size_t)n * sizeof(seedrec_t));
  if (recs == NULL)
    return -1;
  for (int64_t i = 0; i < n; i++) {
    recs[i].mass = mass[i];
    recs[i].seed = seed[i];
  }
  /* std::__lg(n) * 2 */
  int lg = 63 - __builtin_clzll((unsigned long long)n);
  seeds_introsort_loop(&ctx, recs, recs + n, 2 * lg);
  /* __final_insertion_sort */
  if (n > SEEDS_SORT_THRESHOLD) {
    seeds_insertion_sort(&ctx, recs, recs + SEEDS_SORT_THRESHOLD);
    for (seedrec_t *i = recs + SEEDS_SORT_THRESHOLD; i != recs + n; ++i)
      seeds_unguarded_linear_insert(&ctx, i);
  } else {
    seeds_insertion_sort(&ctx, recs, recs + n);
  }
  for (int64_t i = 0; i < n; i++) {
    mass[i] = recs[i].mass;
    seed[i] = recs[i].seed;
  }
  free(recs);
  return 0;
}

/* ------------------------------------------------------------------ */
/* reference-binary-faithful d>=2 alignment kernel                     */
/* ------------------------------------------------------------------ */

/* Byte-replication of the reference's search8/search16 kernels
 * INCLUDING their compiled-in left-boundary artifact.
 *
 * The reference sources intend per-channel H0/F0 re-initialization via
 * byte/word lane stores through pointer aliasing into __m128i locals
 * (src/search16.cc "load" branch, src/search8.cc:831-833). Compiled at
 * -O2 with the release Makefile, GCC keeps those vector accumulators in
 * registers across the loop epilogue while the masked block reads the
 * stale stack slot: only the FIRST 4-row block of each target sees the
 * stored 2*(go+ge) left-edge F boundary (and 0 H boundary); every later
 * block's left-edge boundaries come from a pair of global accumulators
 * that gain 4*gapextend per 4-row block since the START OF THE SEARCH
 * CALL, saturating at 255 (8-bit) / 65535 (16-bit):
 *
 *   F0(i+1) = sat(F0(i) + 4R)        F0(0) = 0
 *   H0(i+1) = satsub(sat(F0(i) + 3R), Q)
 *
 * (verified against the compiled binary with an instrumented build; see
 * tests/test_artifact_nw.py). The boundary a target's k-th block gets
 * therefore depends on the GLOBAL block index at which that block ran,
 * which in turn depends on how the 16 (8-bit) / 8 (16-bit) channels of
 * the multiplexed kernel were scheduled over the whole target list. We
 * simulate that scheduler (the easy/non-easy refill protocol of
 * search16.cc's main loop) to learn each target's start iteration, then
 * run a per-target DP with saturating unsigned arithmetic and the
 * per-block boundaries, and the shared backtrack of utils/backtrack.h.
 */

static inline uint32_t sat_add_u(uint32_t a, uint32_t b, uint32_t SAT) {
  uint32_t s = a + b;
  return s > SAT ? SAT : s;
}
static inline uint32_t sat_sub_u(uint32_t a, uint32_t b) {
  return a > b ? a - b : 0;
}
static inline uint32_t min_u(uint32_t a, uint32_t b) { return a < b ? a : b; }

/* One query vs the FULL ordered target list of one search_do call.
 * compute[b] == 0 skips the DP for that target (screened out by a
 * conservative bound) but the target still participates in scheduling.
 * dirs: caller scratch [dlen_max_blocks*4 * qlen]; HEbuf: [2*qlen];
 * start_iter: [B]; junk: [2 * (total_blocks + 2)]. */
void nw_diffs_refsched(const uint8_t *qseq, int64_t qlen,
                       const uint8_t *dseqs, const int64_t *dlens,
                       int64_t dlen_max, int64_t B, const uint8_t *compute,
                       int64_t mismatch, int64_t go, int64_t ge,
                       int64_t bit_mode, uint8_t *dirs, uint32_t *HEbuf,
                       int64_t *start_iter, uint32_t *junk,
                       int64_t *scores, int64_t *diffs,
                       int64_t *alignlengths) {
  const int channels = bit_mode == 8 ? 16 : 8;
  const uint32_t SAT = bit_mode == 8 ? 255U : 65535U;
  /* the reference casts the penalties into the lane type (truncation,
   * not saturation) before the kernel runs */
  const uint32_t Q = (uint32_t)(go + ge) & SAT;
  const uint32_t R = (uint32_t)ge & SAT;
  const uint32_t V_MM = (uint32_t)mismatch & SAT;
  const uint32_t F0_FIRST = (uint32_t)(2 * (go + ge)) & SAT;

  /* ---- scheduler: start iteration of every target ---- */
  {
    int64_t ch_target[16];
    int64_t ch_remaining[16];
    for (int c = 0; c < channels; c++) {
      ch_target[c] = -1;
      ch_remaining[c] = 0;
    }
    int easy = 0;
    int64_t next = 0, done_ct = 0, iter = 0;
    uint32_t F0 = 0, H0 = 0;
    junk[0] = 0;
    junk[1] = 0;
    while (done_ct < B) {
      if (!easy) {
        int any_finish = 0;
        for (int c = 0; c < channels; c++) {
          if (ch_target[c] >= 0 && ch_remaining[c] > 0) {
            ch_remaining[c] -= ch_remaining[c] < 4 ? ch_remaining[c] : 4;
            if (ch_remaining[c] == 0)
              any_finish = 1;
          } else {
            if (ch_target[c] >= 0) {
              done_ct++;
              ch_target[c] = -1;
            }
            if (next < B) {
              ch_target[c] = next;
              start_iter[next] = iter;
              ch_remaining[c] = dlens[next];
              next++;
              ch_remaining[c] -= ch_remaining[c] < 4 ? ch_remaining[c] : 4;
              if (ch_remaining[c] == 0)
                any_finish = 1;
            }
          }
        }
        easy = !any_finish;
        if (done_ct == B)
          break;
      } else {
        int any_finish = 0;
        for (int c = 0; c < channels; c++) {
          if (ch_target[c] >= 0 && ch_remaining[c] > 0) {
            ch_remaining[c] -= ch_remaining[c] < 4 ? ch_remaining[c] : 4;
            if (ch_remaining[c] == 0)
              any_finish = 1;
          }
        }
        easy = !any_finish;
      }
      /* the block for this iteration runs with junk[2*iter..], then the
       * epilogue advances the registers */
      uint32_t t3 = sat_add_u(sat_add_u(sat_add_u(F0, R, SAT), R, SAT), R, SAT);
      H0 = sat_sub_u(t3, Q);
      F0 = sat_add_u(t3, R, SAT);
      iter++;
      junk[2 * iter] = F0;
      junk[2 * iter + 1] = H0;
    }
  }

  /* ---- per-target DP + backtrack ---- */
  uint32_t *Hbuf = HEbuf;
  uint32_t *Ebuf = HEbuf + qlen;
  for (int64_t b = 0; b < B; b++) {
    if (compute != NULL && !compute[b]) {
      scores[b] = -1;
      diffs[b] = (int64_t)SAT;
      alignlengths[b] = 0;
      continue;
    }
    const uint8_t *dseq = dseqs + b * dlen_max;
    const int64_t dlen = dlens[b];
    const int64_t s0 = start_iter[b];
    /* masked first-block restore: H_top[i] = MQ(i), E[i] = MQ(i)+MQ0,
     * with MQ chained saturating from Q by R per column */
    {
      uint32_t MQ = Q;
      for (int64_t i = 0; i < qlen; i++) {
        Hbuf[i] = MQ;
        Ebuf[i] = sat_add_u(sat_add_u(0, MQ, SAT), Q, SAT);
        MQ = sat_add_u(MQ, R, SAT);
      }
    }
    uint32_t score = 0;
    uint32_t f0_k = 0, hchain = 0;
    for (int64_t row = 0; row < dlen; row++) {
      const int64_t k = row >> 2;
      const int j = (int)(row & 3);
      if (j == 0) {
        if (k == 0) {
          f0_k = F0_FIRST;
          hchain = 0; /* H0 lane store */
        } else {
          f0_k = junk[2 * (s0 + k)];
          hchain = junk[2 * (s0 + k) + 1];
        }
      } else if (j == 1) {
        hchain = sat_sub_u(f0_k, Q);
      } else {
        hchain = sat_add_u(hchain, R, SAT);
      }
      /* F entering column 0 for this sub-row: f0_k advanced j times */
      uint32_t F = f0_k;
      for (int jj = 0; jj < j; jj++)
        F = sat_add_u(F, R, SAT);
      uint32_t diag_in = hchain;
      const uint8_t dch = dseq[row];
      uint8_t *dirrow = dirs + row * qlen;
      for (int64_t i = 0; i < qlen; i++) {
        /* onestep_16/8: order and saturation are load-bearing */
        uint32_t H = sat_add_u(diag_in, dch == qseq[i] ? 0 : V_MM, SAT);
        const uint32_t W = H;
        H = min_u(H, F);
        uint8_t bits = (W == H) ? 1 : 0; /* BIT_UP */
        const uint32_t E_in = Ebuf[i];
        H = min_u(H, E_in);
        if (H == E_in)
          bits |= 2; /* BIT_LEFT */
        const uint32_t N = H;
        H = sat_add_u(H, Q, SAT);
        F = sat_add_u(F, R, SAT);
        uint32_t E = sat_add_u(E_in, R, SAT);
        F = min_u(H, F);
        if (H == F)
          bits |= 4; /* BIT_EXTUP */
        E = min_u(H, E);
        if (H == E)
          bits |= 8; /* BIT_EXTLEFT */
        dirrow[i] = bits;
        diag_in = Hbuf[i]; /* N(row-1, i) for the next column */
        Hbuf[i] = N;
        Ebuf[i] = E;
      }
      if (row + 1 == dlen)
        score = Hbuf[qlen - 1];
    }
    scores[b] = (int64_t)score;
    if (score >= SAT) {
      diffs[b] = (int64_t)SAT;
      alignlengths[b] = 0;
      continue;
    }
    /* utils/backtrack.h */
    {
      int64_t column = qlen - 1, row = dlen - 1;
      int64_t aligned = 0, matches = 0;
      int op = 0;
      while (column >= 0 && row >= 0) {
        aligned++;
        uint8_t cell = dirs[row * qlen + column];
        if (op == 1 && !(cell & 8)) {
          row--;
        } else if (op == 2 && !(cell & 4)) {
          column--;
        } else if (cell & 2) {
          row--;
          op = 1;
        } else if (!(cell & 1)) {
          column--;
          op = 2;
        } else {
          if (qseq[column] == dseq[row])
            matches++;
          column--;
          row--;
          op = 3;
        }
      }
      aligned += column + 1 + row + 1;
      diffs[b] = aligned - matches;
      alignlengths[b] = aligned;
    }
  }
}

/* ------------------------------------------------------------------ */
/* d>=2 clustering engine (the full seed/subseed loop in native code)  */
/* ------------------------------------------------------------------ */

/* Mirrors models/general.py:algo_run's loop (itself a re-derivation of
 * the reference's array-rotation engine, src/algo.cc:384-602) with the
 * screens and alignment kernels inlined, so the per-(sub)seed work has
 * no interpreter or FFI overhead. Python keeps DB handling, output
 * formatting and progress; this returns the final partition arrays,
 * per-swarm stats and the -i structure records. */

/* ideal-boundary DP + backtrack for one pair (search8 semantics — the
 * 8-bit kernel of the reference binary compiles as intended; see
 * docs/PARITY.md sect. 3) */
static void nw_pair_ideal(const uint8_t *qseq, int64_t qlen,
                          const uint8_t *dseq, int64_t dlen, int64_t mismatch,
                          int64_t Q, int64_t R, int64_t go, int64_t ge,
                          int64_t sat_max, uint8_t *dirs, int64_t *Hbuf,
                          int64_t *Ebuf, int64_t *score_out,
                          int64_t *diff_out, int64_t *alen_out) {
  for (int64_t i = 0; i < qlen; i++) {
    Hbuf[i] = Q + i * R;
    Ebuf[i] = 2 * Q + i * R;
  }
  int64_t score = 0;
  for (int64_t row = 0; row < dlen; row++) {
    uint8_t dch = dseq[row];
    int64_t diag_boundary = row == 0 ? 0 : go + row * ge;
    int64_t F = 2 * go + (row + 2) * ge;
    int64_t prev_H = 0;
    uint8_t *dirrow = dirs + row * qlen;
    for (int64_t i = 0; i < qlen; i++) {
      int64_t diag_in = i == 0 ? diag_boundary : prev_H;
      int64_t diag = diag_in + (dch == qseq[i] ? 0 : mismatch);
      int64_t E_in = Ebuf[i];
      int64_t pre = diag < E_in ? diag : E_in;
      int64_t Hnew = pre < F ? pre : F;
      uint8_t bits = 0;
      if (diag <= F)
        bits |= 1;
      {
        int64_t m = diag < F ? diag : F;
        if (E_in <= m)
          bits |= 2;
      }
      int64_t hq = Hnew + Q;
      if (hq <= F + R)
        bits |= 4;
      if (hq <= E_in + R)
        bits |= 8;
      dirrow[i] = bits;
      prev_H = Hbuf[i];
      Hbuf[i] = Hnew;
      Ebuf[i] = hq < E_in + R ? hq : E_in + R;
      int64_t openF = pre + Q;
      F = F + R < openF ? F + R : openF;
    }
    if (row + 1 == dlen)
      score = Hbuf[qlen - 1];
  }
  *score_out = score;
  if (score >= sat_max) {
    *diff_out = sat_max;
    *alen_out = 0;
    return;
  }
  int64_t column = qlen - 1, row = dlen - 1;
  int64_t aligned = 0, matches = 0;
  int op = 0;
  while (column >= 0 && row >= 0) {
    aligned++;
    uint8_t cell = dirs[row * qlen + column];
    if (op == 1 && !(cell & 8))
      row--;
    else if (op == 2 && !(cell & 4))
      column--;
    else if (cell & 2) {
      row--;
      op = 1;
    } else if (!(cell & 1)) {
      column--;
      op = 2;
    } else {
      if (qseq[column] == dseq[row])
        matches++;
      column--;
      row--;
      op = 3;
    }
  }
  aligned += column + 1 + row + 1;
  *diff_out = aligned - matches;
  *alen_out = aligned;
}

/* artifact-boundary DP + backtrack for one 16-bit target whose first
 * block ran at global iteration s0 (junk = the (F0,H0) register stream
 * of the search call; see nw_diffs_refsched) */
static void nw_pair_artifact(const uint8_t *qseq, int64_t qlen,
                             const uint8_t *dseq, int64_t dlen, uint32_t V_MM,
                             uint32_t Q, uint32_t R, uint32_t F0_FIRST,
                             uint32_t SAT, int64_t s0, const uint32_t *junk,
                             uint8_t *dirs, uint32_t *Hbuf, uint32_t *Ebuf,
                             int64_t *score_out, int64_t *diff_out,
                             int64_t *alen_out) {
  {
    uint32_t MQ = Q;
    for (int64_t i = 0; i < qlen; i++) {
      Hbuf[i] = MQ;
      Ebuf[i] = sat_add_u(sat_add_u(0, MQ, SAT), Q, SAT);
      MQ = sat_add_u(MQ, R, SAT);
    }
  }
  uint32_t score = 0;
  uint32_t f0_k = 0, hchain = 0;
  for (int64_t row = 0; row < dlen; row++) {
    const int64_t k = row >> 2;
    const int j = (int)(row & 3);
    if (j == 0) {
      if (k == 0) {
        f0_k = F0_FIRST;
        hchain = 0;
      } else {
        f0_k = junk[2 * (s0 + k)];
        hchain = junk[2 * (s0 + k) + 1];
      }
    } else if (j == 1) {
      hchain = sat_sub_u(f0_k, Q);
    } else {
      hchain = sat_add_u(hchain, R, SAT);
    }
    uint32_t F = f0_k;
    for (int jj = 0; jj < j; jj++)
      F = sat_add_u(F, R, SAT);
    uint32_t diag_in = hchain;
    const uint8_t dch = dseq[row];
    uint8_t *dirrow = dirs + row * qlen;
    for (int64_t i = 0; i < qlen; i++) {
      uint32_t H = sat_add_u(diag_in, dch == qseq[i] ? 0 : V_MM, SAT);
      const uint32_t W = H;
      H = min_u(H, F);
      uint8_t bits = (W == H) ? 1 : 0;
      const uint32_t E_in = Ebuf[i];
      H = min_u(H, E_in);
      if (H == E_in)
        bits |= 2;
      const uint32_t N = H;
      H = sat_add_u(H, Q, SAT);
      F = sat_add_u(F, R, SAT);
      uint32_t E = sat_add_u(E_in, R, SAT);
      F = min_u(H, F);
      if (H == F)
        bits |= 4;
      E = min_u(H, E);
      if (H == E)
        bits |= 8;
      dirrow[i] = bits;
      diag_in = Hbuf[i];
      Hbuf[i] = N;
      Ebuf[i] = E;
    }
    if (row + 1 == dlen)
      score = Hbuf[qlen - 1];
  }
  *score_out = (int64_t)score;
  if (score >= SAT) {
    *diff_out = (int64_t)SAT;
    *alen_out = 0;
    return;
  }
  int64_t column = qlen - 1, row = dlen - 1;
  int64_t aligned = 0, matches = 0;
  int op = 0;
  while (column >= 0 && row >= 0) {
    aligned++;
    uint8_t cell = dirs[row * qlen + column];
    if (op == 1 && !(cell & 8))
      row--;
    else if (op == 2 && !(cell & 4))
      column--;
    else if (cell & 2) {
      row--;
      op = 1;
    } else if (!(cell & 1)) {
      column--;
      op = 2;
    } else {
      if (qseq[column] == dseq[row])
        matches++;
      column--;
      row--;
      op = 3;
    }
  }
  aligned += column + 1 + row + 1;
  *diff_out = aligned - matches;
  *alen_out = aligned;
}

/* scheduler of the reference's channel-multiplexed search loop:
 * fills start_iter[] per target and the (F0,H0) junk stream; returns
 * the iteration count (junk has 2*(iters+1) valid entries) */
static int64_t ref_schedule(const int64_t *ids, const int64_t *lengths,
                            int64_t B, int channels, uint32_t Q, uint32_t R,
                            uint32_t SAT, int64_t *start_iter,
                            uint32_t *junk) {
  int64_t ch_target[16];
  int64_t ch_remaining[16];
  for (int c = 0; c < channels; c++) {
    ch_target[c] = -1;
    ch_remaining[c] = 0;
  }
  int easy = 0;
  int64_t next = 0, done_ct = 0, iter = 0;
  uint32_t F0 = 0, H0 = 0;
  junk[0] = 0;
  junk[1] = 0;
  while (done_ct < B) {
    int any_finish = 0;
    if (!easy) {
      for (int c = 0; c < channels; c++) {
        if (ch_target[c] >= 0 && ch_remaining[c] > 0) {
          ch_remaining[c] -= ch_remaining[c] < 4 ? ch_remaining[c] : 4;
          if (ch_remaining[c] == 0)
            any_finish = 1;
        } else {
          if (ch_target[c] >= 0) {
            done_ct++;
            ch_target[c] = -1;
          }
          if (next < B) {
            ch_target[c] = next;
            start_iter[next] = iter;
            ch_remaining[c] = lengths[ids[next]];
            next++;
            ch_remaining[c] -= ch_remaining[c] < 4 ? ch_remaining[c] : 4;
            if (ch_remaining[c] == 0)
              any_finish = 1;
          }
        }
      }
      easy = !any_finish;
      if (done_ct == B)
        break;
    } else {
      for (int c = 0; c < channels; c++) {
        if (ch_target[c] >= 0 && ch_remaining[c] > 0) {
          ch_remaining[c] -= ch_remaining[c] < 4 ? ch_remaining[c] : 4;
          if (ch_remaining[c] == 0)
            any_finish = 1;
        }
      }
      easy = !any_finish;
    }
    uint32_t t3 = sat_add_u(sat_add_u(sat_add_u(F0, R, SAT), R, SAT), R, SAT);
    H0 = sat_sub_u(t3, Q);
    F0 = sat_add_u(t3, R, SAT);
    iter++;
    junk[2 * iter] = F0;
    junk[2 * iter + 1] = H0;
  }
  return iter;
}

/* growable scratch for the clustering engine */
static int64_t band_for_exact(int64_t cutoff, int64_t go, int64_t ge);
static void nw_pair_ideal_banded(const uint8_t *qseq, int64_t qlen,
                                 const uint8_t *dseq, int64_t dlen,
                                 int64_t mismatch, int64_t Q, int64_t R,
                                 int64_t go, int64_t ge, int64_t sat_max,
                                 int64_t B, uint8_t *dirs, int64_t *Hbuf,
                                 int64_t *Ebuf, int64_t *score_out,
                                 int64_t *diff_out, int64_t *alen_out);

#define D2_BATCH_MAX_WIDTH 96 /* wider bands (huge d) take the scalar path */
#if defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
static void d2_pair_diff_batch16(const uint8_t *const *qs,
                                 const int64_t *qlens,
                                 const uint8_t *const *ds,
                                 const int64_t *dlens, int nlanes,
                                 int64_t mismatch, int64_t go, int64_t ge,
                                 int64_t d, int64_t B, uint8_t *dirs_t,
                                 uint8_t *qT, uint8_t *dT, __m512i *HEv,
                                 int64_t *diffs_out);
#endif

typedef struct {
  int64_t dirs_cap;
  int64_t d; /* difference threshold: selects the banded 8-bit DP */
  const uint64_t *profiles;
  const uint8_t *arena;      /* offset-based codes (no padded matrix:
                                one 67 Mnt sequence must not inflate
                                every row — reference arena layout,
                                src/db.cc:439-442) */
  const int64_t *offsets;
  const int64_t *lengths;
  int64_t mismatch, go, ge, Q, R;
  int64_t bit_mode;
  uint8_t *dirs;     /* [maxlen*maxlen] */
  int64_t *Hb, *Eb;  /* [maxlen] (ideal) */
  uint32_t *Hu, *Eu; /* [maxlen] (artifact) */
  int64_t *start_iter;
  uint32_t *junk;
  int64_t junk_cap; /* uint32 pairs capacity */
  /* 16-lane AVX512 batch scratch (NULL => scalar kernels) */
  uint8_t *batch_dirs; /* [maxlen * width * 16] */
  uint8_t *batch_qT;   /* [maxlen * 16] */
  uint8_t *batch_dT;   /* [maxlen * 16] */
  void *batch_HEv;     /* [2 * width] x 64B, 64-aligned */
} alignctx_t;

/* diffs for one search_do call: ids[0..B) in pool order */
static int align_targets(alignctx_t *cx, int64_t seed_amp,
                         const int64_t *ids, int64_t B, int64_t *diffs) {
  const uint8_t *q = cx->arena + cx->offsets[seed_amp];
  const int64_t qlen = cx->lengths[seed_amp];
  int64_t score, alen;
  /* direction scratch sized by this call's largest pair AND the path
   * that will actually run (lazy: a lone multi-Mnt sequence must not
   * reserve maxlen^2 upfront, and the banded 8-bit path only needs
   * dlen*(2*band+1) — qlen*dmax for two near-identical multi-Mnt
   * sequences would be terabytes) */
  {
    int64_t dmax = 1;
    for (int64_t b = 0; b < B; b++)
      if (cx->lengths[ids[b]] > dmax)
        dmax = cx->lengths[ids[b]];
    int64_t rowlen = qlen;
    if (cx->bit_mode == 8) {
      const int64_t cutoff =
          cx->d * (cx->mismatch > cx->Q ? cx->mismatch : cx->Q);
      const int64_t band = band_for_exact(cutoff, cx->go, cx->ge);
      const int64_t width = 2 * band + 1;
      /* banded rows are width wide; the full-matrix fallback only runs
       * when width >= qlen, where qlen*dmax <= width*dmax anyway */
      if (width < rowlen)
        rowlen = width;
    }
    int64_t need = rowlen * dmax;
    if (need > cx->dirs_cap) {
      uint8_t *nd = (uint8_t *)realloc(cx->dirs, (size_t)need);
      if (nd == NULL)
        return -1;
      cx->dirs = nd;
      cx->dirs_cap = need;
    }
  }
  if (cx->bit_mode == 8) {
    const int64_t cutoff =
        cx->d * (cx->mismatch > cx->Q ? cx->mismatch : cx->Q);
    const int64_t band = band_for_exact(cutoff, cx->go, cx->ge);
    const int64_t width = 2 * band + 1;
#if defined(__AVX512F__) && defined(__AVX512BW__)
    if (width < qlen && width <= D2_BATCH_MAX_WIDTH &&
        cx->batch_dirs != NULL) {
      /* 16 targets per AVX512 batch, same query in every lane's q slot
       * (see d2_pair_diff_batch16). The kernel's accept set and diffs
       * equal nw_pair_ideal_banded's: score > cutoff <=> diff > d
       * (each difference costs at most max(mismatch, Q)), and callers
       * only consume diffs <= d. Rejected slots get 255 exactly like
       * the saturation path. */
      const uint8_t *lq[16], *ld[16];
      int64_t lql[16], ldl[16], dres[16];
      int64_t slot_b[16];
      int nl = 0;
      for (int64_t b = 0; b < B; b++) {
        const int64_t dlen = cx->lengths[ids[b]];
        int64_t ldd = qlen > dlen ? qlen - dlen : dlen - qlen;
        if (ldd > band) {
          diffs[b] = 255;
          continue;
        }
        lq[nl] = q; lql[nl] = qlen;
        ld[nl] = cx->arena + cx->offsets[ids[b]];
        ldl[nl] = dlen;
        slot_b[nl] = b;
        nl++;
        if (nl == 16) {
          d2_pair_diff_batch16(lq, lql, ld, ldl, nl, cx->mismatch, cx->go,
                               cx->ge, cx->d, band, cx->batch_dirs,
                               cx->batch_qT, cx->batch_dT,
                               (__m512i *)cx->batch_HEv, dres);
          for (int t = 0; t < nl; t++)
            diffs[slot_b[t]] = dres[t] < 0 ? 255 : dres[t];
          nl = 0;
        }
      }
      if (nl > 0) {
        d2_pair_diff_batch16(lq, lql, ld, ldl, nl, cx->mismatch, cx->go,
                             cx->ge, cx->d, band, cx->batch_dirs,
                             cx->batch_qT, cx->batch_dT,
                             (__m512i *)cx->batch_HEv, dres);
        for (int t = 0; t < nl; t++)
          diffs[slot_b[t]] = dres[t] < 0 ? 255 : dres[t];
      }
      return 0;
    }
#endif
    for (int64_t b = 0; b < B; b++) {
      const int64_t dlen = cx->lengths[ids[b]];
      int64_t ld = qlen > dlen ? qlen - dlen : dlen - qlen;
      if (ld > band) {
        /* more gaps than the band allows => cost > cutoff => diff > d;
         * rejected pairs' diffs are never consumed */
        diffs[b] = 255;
        continue;
      }
      if (width < qlen) {
        nw_pair_ideal_banded(q, qlen, cx->arena + cx->offsets[ids[b]], dlen,
                             cx->mismatch, cx->Q, cx->R, cx->go, cx->ge, 255,
                             band, cx->dirs, cx->Hb, cx->Eb, &score,
                             &diffs[b], &alen);
      } else {
        nw_pair_ideal(q, qlen, cx->arena + cx->offsets[ids[b]], dlen,
                      cx->mismatch, cx->Q, cx->R, cx->go, cx->ge, 255,
                      cx->dirs, cx->Hb, cx->Eb, &score, &diffs[b], &alen);
      }
    }
    return 0;
  }
  /* 16-bit artifact path: scheduler over the full list */
  int64_t total_blocks = 0;
  for (int64_t b = 0; b < B; b++)
    total_blocks += (cx->lengths[ids[b]] + 3) / 4;
  if (total_blocks + 2 > cx->junk_cap) {
    int64_t cap = cx->junk_cap * 2;
    if (cap < total_blocks + 2)
      cap = total_blocks + 2;
    uint32_t *nj = (uint32_t *)realloc(cx->junk, (size_t)cap * 2 * 4);
    if (nj == NULL)
      return -1;
    cx->junk = nj;
    cx->junk_cap = cap;
  }
  const uint32_t SAT = 65535U;
  const uint32_t Qu = (uint32_t)cx->Q & SAT;
  const uint32_t Ru = (uint32_t)cx->R & SAT;
  const uint32_t MMu = (uint32_t)cx->mismatch & SAT;
  const uint32_t F0F = (uint32_t)(2 * cx->Q) & SAT;
  ref_schedule(ids, cx->lengths, B, 8, Qu, Ru, SAT, cx->start_iter, cx->junk);
  for (int64_t b = 0; b < B; b++) {
    nw_pair_artifact(q, qlen, cx->arena + cx->offsets[ids[b]],
                     cx->lengths[ids[b]], MMu, Qu, Ru, F0F, SAT,
                     cx->start_iter[b], cx->junk, cx->dirs, cx->Hu, cx->Eu,
                     &score, &diffs[b], &alen);
  }
  return 0;
}

/* memmove rotation of one array: move a[target] to a[pos], shifting
 * [pos, target) one slot right */
static inline void rotate_one(int64_t *a, int64_t pos, int64_t target) {
  int64_t tmp = a[target];
  memmove(a + pos + 1, a + pos, (size_t)(target - pos) * 8);
  a[pos] = tmp;
}

#include <time.h>
static double _now(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

/* The full clustering loop. Returns the swarm count, or -1 on alloc
 * failure. See the Python-side wrapper for the array contracts. */
int64_t algo_cluster(
    const uint64_t *profiles, const uint8_t *arena, const int64_t *offsets,
    const int64_t *lengths, const int64_t *abundances, int64_t n, int64_t d,
    int64_t mismatch, int64_t go, int64_t ge, int64_t bit_mode, int no_break,
    int want_structure, int64_t *order, int64_t *diffest,
    int64_t *swarmid_arr, int64_t *gen_arr, int64_t *rad_arr,
    int64_t *swarm_seed, int64_t *swarm_size, int64_t *swarm_copies,
    int64_t *swarm_singletons, int64_t *swarm_maxgen, int64_t *swarm_maxrad,
    int64_t *swarm_bound, int64_t *struct_parent, int64_t *struct_child,
    int64_t *struct_diff, int64_t *struct_gen, int64_t *summary_out) {
  int64_t maxlen = 1;
  for (int64_t i = 0; i < n; i++)
    if (lengths[i] > maxlen)
      maxlen = lengths[i];

  alignctx_t cx;
  cx.dirs_cap = 0;
  cx.profiles = profiles;
  cx.arena = arena;
  cx.offsets = offsets;
  cx.lengths = lengths;
  cx.mismatch = mismatch;
  cx.go = go;
  cx.ge = ge;
  cx.Q = go + ge;
  cx.R = ge;
  cx.bit_mode = bit_mode;
  cx.d = d;
  cx.dirs = NULL;
  {
    int64_t cutoff8 = d * (mismatch > go + ge ? mismatch : go + ge);
    int64_t w8 = 2 * band_for_exact(cutoff8, go, ge) + 1;
    if (w8 > maxlen)
      maxlen = w8;
  }
  cx.Hb = (int64_t *)malloc((size_t)maxlen * 8);
  cx.Eb = (int64_t *)malloc((size_t)maxlen * 8);
  cx.Hu = (uint32_t *)malloc((size_t)maxlen * 4);
  cx.Eu = (uint32_t *)malloc((size_t)maxlen * 4);
  cx.start_iter = (int64_t *)malloc((size_t)(n > 0 ? n : 1) * 8);
  cx.junk_cap = 4096;
  cx.junk = (uint32_t *)malloc((size_t)cx.junk_cap * 2 * 4);
  cx.batch_dirs = NULL;
  cx.batch_qT = NULL;
  cx.batch_dT = NULL;
  cx.batch_HEv = NULL;
#if defined(__AVX512F__) && defined(__AVX512BW__)
  if (bit_mode == 8) {
    int64_t cutoff8 = d * (mismatch > go + ge ? mismatch : go + ge);
    int64_t w8 = 2 * band_for_exact(cutoff8, go, ge) + 1;
    if (w8 <= D2_BATCH_MAX_WIDTH && maxlen < (BAND_INF32 >> 6)) {
      cx.batch_dirs = (uint8_t *)malloc((size_t)(maxlen * w8 * 16));
      cx.batch_qT = (uint8_t *)malloc((size_t)maxlen * 16);
      cx.batch_dT = (uint8_t *)malloc((size_t)maxlen * 16);
      cx.batch_HEv = aligned_alloc(64, (size_t)(2 * w8) * 64);
      if (cx.batch_dirs == NULL || cx.batch_qT == NULL ||
          cx.batch_dT == NULL || cx.batch_HEv == NULL) {
        free(cx.batch_dirs); free(cx.batch_qT); free(cx.batch_dT);
        free(cx.batch_HEv);
        cx.batch_dirs = NULL; cx.batch_qT = NULL;
        cx.batch_dT = NULL; cx.batch_HEv = NULL;
      }
    }
  }
#endif
  /* 16-byte XOR-fold sketches, L2-resident for ~100k amplicons */
  uint64_t *fold = (uint64_t *)malloc((size_t)(n > 0 ? n : 1) * 16);
  if (fold != NULL)
    for (int64_t a = 0; a < n; a++) {
      uint64_t f0 = 0, f1 = 0;
      const uint64_t *p = profiles + a * 16;
      for (int w = 0; w < 16; w += 2) {
        f0 ^= p[w];
        f1 ^= p[w + 1];
      }
      fold[2 * a] = f0;
      fold[2 * a + 1] = f1;
    }
  int64_t *tpos = (int64_t *)malloc((size_t)(n > 0 ? n : 1) * 8);
  int64_t *tids = (int64_t *)malloc((size_t)(n > 0 ? n : 1) * 8);
  int64_t *tdiffs = (int64_t *)malloc((size_t)(n > 0 ? n : 1) * 8);
  if (cx.Hb == NULL || cx.Eb == NULL || cx.Hu == NULL ||
      cx.Eu == NULL || cx.start_iter == NULL || cx.junk == NULL ||
      tpos == NULL || tids == NULL || tdiffs == NULL || fold == NULL) {
    free(cx.dirs); free(cx.Hb); free(cx.Eb); free(cx.Hu); free(cx.Eu);
  free(cx.batch_dirs); free(cx.batch_qT); free(cx.batch_dT);
  free(cx.batch_HEv);
    free(cx.start_iter); free(cx.junk); free(tpos); free(tids); free(tdiffs);
    free(fold);
    return -1;
  }

  int64_t largestswarm = 0, maxgenerations = 0, swarmid = 0;
  int64_t seeded = 0, swarmed = 0, struct_count = 0;
  int64_t cnt_g1 = 0, cnt_sub = 0, cnt_align = 0; /* comparison counters */
  /* per-call timing diagnostics (locals: repeated in-process runs must
   * not accumulate, and file-scope would not be thread-safe) */
  double t_screen = 0, t_align = 0, t_sub2 = 0;
  int64_t n_aligns = 0, n_g1 = 0;

  while (seeded < n) {
    swarmid++;
    int64_t swarmsize = 1, copies = 0, singletons = 0;
    int64_t maxradius = 0, maxgen = 1;

    int64_t seedindex = seeded;
    seeded++;
    swarmid_arr[seedindex] = swarmid;
    int64_t seedampliconid = order[seedindex];
    int64_t abundance = abundances[seedampliconid];
    copies += abundance;
    if (abundance == 1)
      singletons++;
    swarmed++;

    int64_t n_pool;
    double _t0 = _now();
    int64_t hits = d2_gen1_screen_core(profiles, order, abundances, diffest,
                                       swarmed, n, seedampliconid, abundance,
                                       no_break, d, tpos, tids, &n_pool,
                                       fold);
    t_screen += _now() - _t0; n_g1 += n - swarmed;
    cnt_g1 += n_pool;
    if (hits > 0) {
      _t0 = _now();
      if (align_targets(&cx, seedampliconid, tids, hits, tdiffs) != 0)
        goto fail;
      t_align += _now() - _t0; n_aligns += hits; cnt_align += hits;
      for (int64_t t = 0; t < hits; t++) {
        int64_t diff = tdiffs[t];
        if (diff > d)
          continue;
        int64_t target = tpos[t];
        if (target > swarmed) {
          rotate_one(order, swarmed, target);
          rotate_one(diffest, swarmed, target);
          rotate_one(swarmid_arr, swarmed, target);
          rotate_one(gen_arr, swarmed, target);
          rotate_one(rad_arr, swarmed, target);
        }
        swarmid_arr[swarmed] = swarmid;
        gen_arr[swarmed] = 1;
        rad_arr[swarmed] = diff;
        if (diff > maxradius)
          maxradius = diff;
        int64_t poolampliconid = order[swarmed];
        if (want_structure) {
          struct_parent[struct_count] = seedampliconid;
          struct_child[struct_count] = poolampliconid;
          struct_diff[struct_count] = diff;
          struct_gen[struct_count] = 1;
          struct_count++;
        }
        int64_t ab = abundances[poolampliconid];
        copies += ab;
        if (ab == 1)
          singletons++;
        swarmsize++;
        swarmed++;
      }

      while (seeded < swarmed) {
        int64_t subseed_pos = seeded;
        int64_t subseed_amp = order[subseed_pos];
        int64_t subseed_radius = rad_arr[subseed_pos];
        int64_t subseed_generation = gen_arr[subseed_pos];
        seeded++;
        int64_t subseedab = abundances[subseed_amp];

        _t0 = _now();
        int64_t shits = d2_subseed_screen_core(
            profiles, order, abundances, diffest, swarmed, n, subseed_amp,
            subseed_radius + d, subseedab, no_break, d, tpos, tids, fold);
        t_sub2 += _now() - _t0;
        cnt_sub += n - swarmed;
        if (shits == 0)
          continue;
        _t0 = _now();
        if (align_targets(&cx, subseed_amp, tids, shits, tdiffs) != 0)
          goto fail;
        t_align += _now() - _t0; n_aligns += shits; cnt_align += shits;
        for (int64_t t = 0; t < shits; t++) {
          int64_t diff = tdiffs[t];
          if (diff > d)
            continue;
          int64_t target = tpos[t];
          int64_t targetampliconid = order[target];
          int64_t pos = swarmed;
          while (pos > seeded && order[pos - 1] > targetampliconid &&
                 gen_arr[pos - 1] > subseed_generation)
            pos--;
          if (target > pos) {
            rotate_one(order, pos, target);
            rotate_one(diffest, pos, target);
            rotate_one(swarmid_arr, pos, target);
            rotate_one(gen_arr, pos, target);
            rotate_one(rad_arr, pos, target);
          }
          swarmid_arr[pos] = swarmid;
          gen_arr[pos] = subseed_generation + 1;
          if (subseed_generation + 1 > maxgen)
            maxgen = subseed_generation + 1;
          rad_arr[pos] = subseed_radius + diff;
          if (subseed_radius + diff > maxradius)
            maxradius = subseed_radius + diff;
          int64_t poolampliconid = order[pos];
          if (want_structure) {
            struct_parent[struct_count] = subseed_amp;
            struct_child[struct_count] = poolampliconid;
            struct_diff[struct_count] = diff;
            struct_gen[struct_count] = subseed_generation + 1;
            struct_count++;
          }
          int64_t ab = abundances[poolampliconid];
          copies += ab;
          if (ab == 1)
            singletons++;
          swarmsize++;
          swarmed++;
        }
      }
    }

    if (swarmsize > largestswarm)
      largestswarm = swarmsize;
    if (maxgen > maxgenerations)
      maxgenerations = maxgen;
    swarm_seed[swarmid - 1] = seedampliconid;
    swarm_size[swarmid - 1] = swarmsize;
    swarm_copies[swarmid - 1] = copies;
    swarm_singletons[swarmid - 1] = singletons;
    swarm_maxgen[swarmid - 1] = maxgen;
    swarm_maxrad[swarmid - 1] = maxradius;
    swarm_bound[swarmid - 1] = seeded;
  }

  summary_out[0] = largestswarm;
  summary_out[1] = maxgenerations;
  summary_out[2] = struct_count;
  summary_out[3] = cnt_g1;   /* gen-1 qgram screen comparisons */
  summary_out[4] = cnt_sub;  /* subseed pool-scan comparisons */
  summary_out[5] = cnt_align; /* exact alignments */
  if (getenv("SWARM_TPU_TIMING") != NULL)
    fprintf(stderr,
            "[algo_cluster] g1 %.2fs (%lld elems) sub %.2fs align %.2fs "
            "(%lld pairs)\n",
            t_screen, (long long)n_g1, t_sub2, t_align, (long long)n_aligns);
  free(cx.dirs); free(cx.Hb); free(cx.Eb); free(cx.Hu); free(cx.Eu);
  free(cx.batch_dirs); free(cx.batch_qT); free(cx.batch_dT);
  free(cx.batch_HEv);
  free(cx.start_iter); free(cx.junk); free(tpos); free(tids); free(tdiffs);
  free(fold);
  return swarmid;
fail:
  free(cx.dirs); free(cx.Hb); free(cx.Eb); free(cx.Hu); free(cx.Eu);
  free(cx.batch_dirs); free(cx.batch_qT); free(cx.batch_dT);
  free(cx.batch_HEv);
  free(cx.start_iter); free(cx.junk); free(tpos); free(tids); free(tdiffs);
  free(fold);
  return -1;
}

/* exported for differential tests: see nw_diffs_banded_batch below */

/* ------------------------------------------------------------------ */
/* banded ideal-mode DP (8-bit / search8 semantics)                    */
/* ------------------------------------------------------------------ */

/* Band soundness for BIT-IDENTICAL results (not just accept/reject):
 * every comparison the backtrack can consult involves values up to
 * H + Q + R with H <= cutoff on the walked path, so out-of-band cells
 * may be treated as +INF only if any path through them costs MORE than
 * cutoff + Q + R. A path leaving the band pays at least
 * gapopen + B*gapextend, so we need go + B*ge > cutoff + Q + R
 * (see band_for_exact below). Pairs whose |qlen-dlen| > B are rejected
 * outright (their cost > cutoff implies diff > d, and rejected pairs'
 * reported diffs are never consumed). Only the 8-bit kernel may be
 * banded: the 16-bit artifact's junk left boundary can leak cheap
 * paths through out-of-band cells.
 */

#define BAND_INF (1LL << 40)

static int64_t band_for_exact(int64_t cutoff, int64_t go, int64_t ge) {
  /* smallest B with go + B*ge > cutoff + (go+ge) + ge */
  int64_t need = cutoff + go + 2 * ge + 1 - go;
  int64_t B = (need + ge - 1) / ge;
  return B < 1 ? 1 : B;
}

/* dirs layout: [dlen][2B+1], slot = col - row + B. */
static void nw_pair_ideal_banded(const uint8_t *qseq, int64_t qlen,
                                 const uint8_t *dseq, int64_t dlen,
                                 int64_t mismatch, int64_t Q, int64_t R,
                                 int64_t go, int64_t ge, int64_t sat_max,
                                 int64_t B, uint8_t *dirs, int64_t *Hbuf,
                                 int64_t *Ebuf, int64_t *score_out,
                                 int64_t *diff_out, int64_t *alen_out) {
  const int64_t width = 2 * B + 1;
  /* slot k of row -1 carries H[-1][i-1] and E entering row 0 at
   * column i-1, where i = k - B at row 0 */
  for (int64_t k = 0; k < width; k++) {
    int64_t im1 = k - B - 1;
    Hbuf[k] = im1 >= 0 && im1 < qlen ? Q + im1 * R : BAND_INF;
    Ebuf[k] = im1 >= 0 && im1 < qlen ? 2 * Q + im1 * R : BAND_INF;
  }
  int64_t score = BAND_INF;
  if (width <= 192) {
    /* three-pass rows: the original cell loop chains every cell's
     * min/select work through the serial F recurrence (~21 cycles per
     * cell measured). Splitting each row into (A) a dependency-free
     * gather of diag/E_in/pre, (B) the minimal scalar F chain, and
     * (C) a dependency-free bits/store pass lets the compiler
     * vectorize A and C over the band — identical arithmetic,
     * identical direction bits, ~4x fewer cycles per cell. */
    int64_t diag_a[192], ein_a[192], pre_a[192], fv_a[192];
    for (int64_t row = 0; row < dlen; row++) {
      uint8_t *dirrow = dirs + row * width;
      const uint8_t dch = dseq[row];
      int64_t kstart = B - row > 0 ? B - row : 0;
      int64_t kend = qlen - 1 - row + B; /* last slot with i < qlen */
      if (kend > width - 1)
        kend = width - 1;
      /* pass A: diagonal and left inputs (previous-row values only) */
      for (int64_t k = kstart; k <= kend; k++) {
        const int64_t diag_in = Hbuf[k];
        const int64_t i = row + k - B;
        diag_a[k] = diag_in >= BAND_INF
                        ? BAND_INF
                        : diag_in + (dch == qseq[i] ? 0 : mismatch);
        ein_a[k] = k + 1 < width ? Ebuf[k + 1] : BAND_INF;
        pre_a[k] = diag_a[k] < ein_a[k] ? diag_a[k] : ein_a[k];
      }
      if (kstart == B - row && kstart <= kend) {
        /* slot with i == 0: boundary diagonal replaces Hbuf */
        const int64_t diag_in = row == 0 ? 0 : go + row * ge;
        const int64_t k = kstart;
        diag_a[k] = diag_in + (dch == qseq[0] ? 0 : mismatch);
        pre_a[k] = diag_a[k] < ein_a[k] ? diag_a[k] : ein_a[k];
      }
      /* slots past the query end: INF, as the original wrote them —
       * but only AFTER pass A has consumed the previous row's
       * Ebuf[k+1] at the band edge (the original reads, then writes
       * one iteration later) */
      for (int64_t k = kend + 1; k < width; k++) {
        Hbuf[k] = BAND_INF;
        Ebuf[k] = BAND_INF;
      }
      /* pass B: the serial F chain, nothing else */
      {
        int64_t F = kstart == B - row ? 2 * go + (row + 2) * ge : BAND_INF;
        for (int64_t k = kstart; k <= kend; k++) {
          fv_a[k] = F;
          const int64_t openF = pre_a[k] + Q;
          F = F + R < openF ? F + R : openF;
          if (F > BAND_INF)
            F = BAND_INF;
        }
      }
      /* pass C: cell results and direction bits */
      for (int64_t k = kstart; k <= kend; k++) {
        const int64_t diag = diag_a[k];
        const int64_t E_in = ein_a[k];
        const int64_t F = fv_a[k];
        const int64_t pre = pre_a[k];
        const int64_t Hnew = pre < F ? pre : F;
        uint8_t bits = 0;
        if (diag <= F)
          bits |= 1;
        {
          const int64_t m = diag < F ? diag : F;
          if (E_in <= m)
            bits |= 2;
        }
        const int64_t hq = Hnew + Q;
        if (hq <= F + R)
          bits |= 4;
        if (hq <= E_in + R)
          bits |= 8;
        dirrow[k] = bits;
        Hbuf[k] = Hnew;
        const int64_t Enew = hq < E_in + R ? hq : E_in + R;
        Ebuf[k] = Enew > BAND_INF ? BAND_INF : Enew;
      }
      if (row == dlen - 1) {
        const int64_t ks = qlen - 1 - row + B;
        if (ks >= kstart && ks <= kend)
          score = Hbuf[ks];
      }
    }
  } else {
    for (int64_t row = 0; row < dlen; row++) {
    uint8_t *dirrow = dirs + row * width;
    int64_t F = BAND_INF; /* running F along the row (within the band) */
    for (int64_t k = 0; k < width; k++) {
      const int64_t i = row + k - B;
      if (i < 0)
        continue; /* slot ahead of the query start this row */
      if (i >= qlen) {
        Hbuf[k] = BAND_INF;
        Ebuf[k] = BAND_INF;
        continue;
      }
      /* same slot one row up is (i-1, row-1): the diagonal */
      int64_t diag_in;
      if (i == 0) {
        diag_in = row == 0 ? 0 : go + row * ge;
        F = 2 * go + (row + 2) * ge; /* F boundary enters at column 0 */
      } else {
        diag_in = Hbuf[k];
      }
      const int64_t diag =
          (diag_in >= BAND_INF ? BAND_INF
                               : diag_in + (dseq[row] == qseq[i] ? 0 : mismatch));
      /* up (i, row-1): slot k+1 one row up (not yet overwritten) */
      const int64_t E_in = k + 1 < width ? Ebuf[k + 1] : BAND_INF;
      int64_t pre = diag < E_in ? diag : E_in;
      int64_t Hnew = pre < F ? pre : F;
      uint8_t bits = 0;
      if (diag <= F)
        bits |= 1;
      {
        int64_t m = diag < F ? diag : F;
        if (E_in <= m)
          bits |= 2;
      }
      int64_t hq = Hnew + Q;
      if (hq <= F + R)
        bits |= 4;
      if (hq <= E_in + R)
        bits |= 8;
      dirrow[k] = bits;
      Hbuf[k] = Hnew; /* becomes the diagonal of (i+1, row+1) */
      int64_t Enew = hq < E_in + R ? hq : E_in + R;
      Ebuf[k] = Enew > BAND_INF ? BAND_INF : Enew; /* read at k+1 next row */
      int64_t openF = pre + Q;
      F = F + R < openF ? F + R : openF;
      if (F > BAND_INF)
        F = BAND_INF;
      if (row == dlen - 1 && i == qlen - 1)
        score = Hnew;
    }
    }
  }
  *score_out = score >= BAND_INF ? BAND_INF : score;
  if (score >= sat_max || score >= BAND_INF) {
    *diff_out = sat_max;
    *alen_out = 0;
    return;
  }
  int64_t column = qlen - 1, row = dlen - 1;
  int64_t aligned = 0, matches = 0;
  int op = 0;
  while (column >= 0 && row >= 0) {
    aligned++;
    int64_t slot = column - row + B;
    uint8_t cell = slot >= 0 && slot < width ? dirs[row * width + slot] : 0;
    if (op == 1 && !(cell & 8))
      row--;
    else if (op == 2 && !(cell & 4))
      column--;
    else if (cell & 2) {
      row--;
      op = 1;
    } else if (!(cell & 1)) {
      column--;
      op = 2;
    } else {
      if (qseq[column] == dseq[row])
        matches++;
      column--;
      row--;
      op = 3;
    }
  }
  aligned += column + 1 + row + 1;
  *diff_out = aligned - matches;
  *alen_out = aligned;
}


/* Test wrapper: banded ideal DP over a batch (scratch caller-owned:
 * dirs [dlen_max*(2B+1)], Hbuf/Ebuf [2B+1]). */
void nw_diffs_banded_batch(const uint8_t *qseq, int64_t qlen,
                           const uint8_t *dseqs, const int64_t *dlens,
                           int64_t dlen_max, int64_t B, int64_t mismatch,
                           int64_t go, int64_t ge, int64_t band,
                           uint8_t *dirs, int64_t *Hbuf, int64_t *Ebuf,
                           int64_t *scores, int64_t *diffs,
                           int64_t *alignlengths) {
  for (int64_t b = 0; b < B; b++) {
    nw_pair_ideal_banded(qseq, qlen, dseqs + b * dlen_max, dlens[b], mismatch,
                         go + ge, ge, go, ge, 255, band, dirs, Hbuf, Ebuf,
                         &scores[b], &diffs[b], &alignlengths[b]);
  }
}

/* ------------------------------------------------------------------ */
/* host d=1 network builder (variant hashing + hash table)             */
/* ------------------------------------------------------------------ */

/* The device engines build the d=1 network with a sorted key join;
 * this is the latency-optimized HOST equivalent for small inputs and
 * the no-device fallback (re-derivation of the same contract as
 * ops/neighbors.py:build_network — every unordered pair at edit
 * distance exactly 1, expanded to ordered edges under the abundance
 * rule, sorted by (from, to)). Positional Zobrist hashing with
 * prefix/shifted-suffix split gives O(1) per variant: substitutions
 * flip one table entry; a deletion at p is pre[p] ^ sufshift[p+1]
 * where sufshift accumulates Z[q-1][s_q] backwards. Insertions are
 * the target side's deletions. Hash hits verify with a two-pointer
 * distance-1 check, so hash collisions cannot create edges. */

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

static inline uint64_t zpos(int64_t pos, int c) {
  return splitmix64(((uint64_t)pos << 2) | (uint64_t)c);
}

/* position-major zpos table: [maxlen+2][4] fits L1 for amplicon-scale
 * lengths and turns three multiplies per lookup into one load */
static uint64_t *zpos_table(int64_t maxlen) {
  uint64_t *t = (uint64_t *)malloc((size_t)(maxlen + 2) * 4 * 8);
  if (t == NULL)
    return NULL;
  for (int64_t p = 0; p < maxlen + 2; p++)
    for (int c = 0; c < 4; c++)
      t[4 * p + c] = zpos(p, c);
  return t;
}
#define ZPT(t, p, c) ((t)[4 * (p) + (c)])

static int dist1_check(const uint8_t *a, int64_t la, const uint8_t *b,
                       int64_t lb) {
  if (la == lb) {
    int64_t diffs = 0;
    for (int64_t i = 0; i < la; i++)
      if (a[i] != b[i] && ++diffs > 1)
        return 0;
    return diffs == 1;
  }
  if (la < lb) {
    const uint8_t *t = a;
    a = b;
    b = t;
    int64_t tl = la;
    la = lb;
    lb = tl;
  }
  if (la != lb + 1)
    return 0;
  int64_t i = 0;
  while (i < lb && a[i] == b[i])
    i++;
  /* skip one char of the longer */
  return memcmp(a + i + 1, b + i, (size_t)(lb - i)) == 0;
}

/* Returns the ordered edge count, or -1 when caps are too small
 * (caller doubles and retries), or -2 on alloc failure. */
int64_t d1_network_native(const uint8_t *arena, const int64_t *offsets,
                          const int64_t *lengths, int64_t n,
                          const int64_t *abundances, int no_break,
                          int64_t *ef_out, int64_t *et_out,
                          int64_t cap_out) {
  if (n == 0)
    return 0;
  int64_t maxlen = 1;
  for (int64_t i = 0; i < n; i++)
    if (lengths[i] > maxlen)
      maxlen = lengths[i];

  uint64_t *seqhash = (uint64_t *)malloc((size_t)n * 8);
  int64_t cap_tab = 1;
  while (cap_tab < 2 * n)
    cap_tab <<= 1;
  /* membership bitset (~64 bits/seq): almost every variant probe
   * misses, and a one-bit test beats walking the open-addressed slot
   * array. Fill matters more than footprint: at 8 bits/seq ~8% of
   * probes false-hit into a table walk (the dominant cost at 10k);
   * 64 bits/seq stays L2-resident through the probe engine's whole
   * range (n < 64k -> <= 512 KB) and cuts walks 8x (25.6 -> 12.4 ms
   * at 10k x 150) */
  int64_t bset_bits = 1;
  while (bset_bits < 64 * n)
    bset_bits <<= 1;
  uint64_t bmask = (uint64_t)(bset_bits - 1);
  uint64_t *bset = (uint64_t *)calloc((size_t)(bset_bits >> 6) + 1, 8);
  int64_t *slots = (int64_t *)malloc((size_t)cap_tab * 8);
  uint64_t *pre = (uint64_t *)malloc((size_t)(maxlen + 1) * 8);
  uint64_t *sufshift = (uint64_t *)malloc((size_t)(maxlen + 1) * 8);
  int64_t pair_cap = 4 * n + 64;
  uint64_t *pairs = (uint64_t *)malloc((size_t)pair_cap * 8);
  /* L1-resident zpos table: the 4L substitution probes per amplicon
   * each cost two splitmix64 evaluations (4 multiplies) as calls;
   * as loads they are one L1 hit each (code 4 aliases 4*(p+1)+0 by
   * the (pos<<2)|c bit layout, which the +2 sizing covers) */
  uint64_t *zt = zpos_table(maxlen);
  if (seqhash == NULL || slots == NULL || pre == NULL || sufshift == NULL ||
      pairs == NULL || bset == NULL || zt == NULL) {
    free(seqhash); free(slots); free(pre); free(sufshift); free(pairs);
    free(bset); free(zt);
    return -2;
  }
  for (int64_t i = 0; i < cap_tab; i++)
    slots[i] = -1;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t *s = arena + offsets[i];
    uint64_t h = 0;
    for (int64_t p = 0; p < lengths[i]; p++)
      h ^= ZPT(zt, p, s[p]);
    seqhash[i] = h;
    uint64_t slot = h & (uint64_t)(cap_tab - 1);
    while (slots[slot] >= 0)
      slot = (slot + 1) & (uint64_t)(cap_tab - 1);
    slots[slot] = i;
    uint64_t hb = h & bmask;
    bset[hb >> 6] |= 1ULL << (hb & 63);
  }

  int64_t n_pairs = 0;
  int rc = 0;
  for (int64_t a = 0; a < n && rc == 0; a++) {
    const uint8_t *s = arena + offsets[a];
    const int64_t L = lengths[a];
    const uint64_t full = seqhash[a];
    pre[0] = 0;
    for (int64_t p = 0; p < L; p++)
      pre[p + 1] = pre[p] ^ ZPT(zt, p, s[p]);
    sufshift[L] = 0;
    for (int64_t p = L - 1; p >= 1; p--)
      sufshift[p] = sufshift[p + 1] ^ ZPT(zt, p - 1, s[p]);

    /* probe hv; verify dist-1 on hash match. Two branch-light passes
     * (3 substitutions per position, then the deletions): probe ORDER
     * is free because pairs are deduped through one canonical qsort
     * below. The rare bitset hit takes the slow table walk. */
#define D1_PROBE(hv_expr)                                                   \
    do {                                                                    \
      const uint64_t hv = (hv_expr);                                        \
      const uint64_t hb = hv & bmask;                                       \
      if (((bset[hb >> 6] >> (hb & 63)) & 1)) {                             \
        uint64_t slot = hv & (uint64_t)(cap_tab - 1);                       \
        while (slots[slot] >= 0) {                                          \
          int64_t b = slots[slot];                                          \
          slot = (slot + 1) & (uint64_t)(cap_tab - 1);                      \
          if (b == a || seqhash[b] != hv)                                   \
            continue;                                                       \
          if (!dist1_check(s, L, arena + offsets[b], lengths[b]))           \
            continue;                                                       \
          uint64_t key = a < b ? ((uint64_t)a << 32) | (uint64_t)b          \
                               : ((uint64_t)b << 32) | (uint64_t)a;         \
          if (n_pairs >= pair_cap) {                                        \
            int64_t nc2 = pair_cap * 2;                                     \
            uint64_t *np_ = (uint64_t *)realloc(pairs, (size_t)nc2 * 8);    \
            if (np_ == NULL) {                                              \
              rc = -2;                                                      \
              break;                                                        \
            }                                                               \
            pairs = np_;                                                    \
            pair_cap = nc2;                                                 \
          }                                                                 \
          pairs[n_pairs++] = key;                                           \
        }                                                                   \
      }                                                                     \
    } while (0)

    for (int64_t p = 0; p < L && rc == 0; p++) {
      /* base = hash with position p's code XORed out, hoisted over
       * the three substitution probes */
      /* the three other codes (alphabet 0..3) from a tiny lookup,
       * fully unrolled (a c==oc skip test mispredicts on random DNA;
       * a wraparound add costs 3 ops per probe). Probing the exact
       * three substitutions from BOTH sides finds each pair twice;
       * the canonical-key dedup keeps the edge set identical. */
      static const uint8_t OTHER[4][3] = {
          {1, 2, 3}, {0, 2, 3}, {0, 1, 3}, {0, 1, 2}};
      const uint64_t *zrow = zt + 4 * p;
      const uint8_t *ot = OTHER[s[p]];
      const uint64_t base = full ^ zrow[s[p]];
      D1_PROBE(base ^ zrow[ot[0]]);
      D1_PROBE(base ^ zrow[ot[1]]);
      D1_PROBE(base ^ zrow[ot[2]]);
    }
    if (L > 1)
      for (int64_t p = 0; p < L && rc == 0; p++)
        D1_PROBE(pre[p] ^ sufshift[p + 1]);
#undef D1_PROBE
  }
  free(zt);
  free(pre);
  free(sufshift);
  free(slots);
  free(seqhash);
  free(bset);
  if (rc != 0) {
    free(pairs);
    return rc;
  }

  /* dedup unordered pairs */
  int cmp_u64(const void *x, const void *y);
  qsort(pairs, (size_t)n_pairs, 8, cmp_u64);
  int64_t m = 0;
  for (int64_t i = 0; i < n_pairs; i++)
    if (i == 0 || pairs[i] != pairs[i - 1])
      pairs[m++] = pairs[i];

  /* ordered edges under the abundance rule, sorted by (from, to):
   * emit per 'from' in two sweeps (pairs are sorted by (lo, hi), so a
   * stable expansion needs a final sort) */
  int64_t cnt = 0;
  for (int64_t i = 0; i < m; i++) {
    int64_t lo = (int64_t)(pairs[i] >> 32);
    int64_t hi = (int64_t)(pairs[i] & 0xFFFFFFFFULL);
    if (no_break || abundances[lo] >= abundances[hi]) {
      if (cnt >= cap_out) {
        free(pairs);
        return -1;
      }
      ef_out[cnt] = lo;
      et_out[cnt] = hi;
      cnt++;
    }
    if (no_break || abundances[hi] >= abundances[lo]) {
      if (cnt >= cap_out) {
        free(pairs);
        return -1;
      }
      ef_out[cnt] = hi;
      et_out[cnt] = lo;
      cnt++;
    }
  }
  free(pairs);
  /* sort edges by (from, to): reuse the packed-key trick */
  uint64_t *packed = (uint64_t *)malloc((size_t)(cnt > 0 ? cnt : 1) * 8);
  if (packed == NULL)
    return -2;
  for (int64_t i = 0; i < cnt; i++)
    packed[i] = ((uint64_t)ef_out[i] << 32) | (uint64_t)et_out[i];
  qsort(packed, (size_t)cnt, 8, cmp_u64);
  for (int64_t i = 0; i < cnt; i++) {
    ef_out[i] = (int64_t)(packed[i] >> 32);
    et_out[i] = (int64_t)(packed[i] & 0xFFFFFFFFULL);
  }
  free(packed);
  return cnt;
}

int cmp_u64(const void *x, const void *y) {
  uint64_t a = *(const uint64_t *)x, b = *(const uint64_t *)y;
  return a < b ? -1 : a > b ? 1 : 0;
}

/* ------------------------------------------------------------------ */
/* d>=2 network engine (device qgram join + host exact diffs + graph   */
/* clustering)                                                         */
/* ------------------------------------------------------------------ */

/* The device d>=2 formulation splits the reference's per-seed loop
 * (src/algo.cc:329-708) into (a) a bulk candidate-pair screen on the
 * device (ops/d2_network.py: all-pairs qgram Hamming distance as an
 * int8 matmul), (b) exact per-pair diffs here or on the device, and (c) a graph-driven
 * replay of the clustering loop (algo_cluster_graph) whose attachment
 * ordering is identical to algo_cluster's because pool elements always
 * remain in ascending-amplicon-id order (the initial order is the
 * identity and rotations preserve relative pool order), so iterating a
 * subseed's id-sorted adjacency equals scanning the pool by position. */

#include <pthread.h>

typedef struct {
  const uint8_t *arena;
  const int64_t *offsets;
  const int64_t *lengths;
  const int64_t *abundances;
  const int64_t *pa;
  const int64_t *pb;
  int64_t P;
  int64_t d, mismatch, go, ge;
  int no_break;
  int64_t band;
  int64_t dlen_max;
  int64_t *diff_ab;
  int64_t *diff_ba;
  int64_t lo, hi; /* pair range for this worker */
  int fail;
} d2pairs_job_t;

/* One directed exact diff (query q -> target t), banded ideal-mode DP
 * with an early reject: row minima of the cost DP are non-decreasing
 * (every extension adds nonnegative cost), so once the running row
 * minimum exceeds cutoff the backtracked path's diff must exceed d
 * (a path with diff <= d costs <= cutoff = d*max(mm, go+ge)). */
static int64_t d2_pair_diff_one(const uint8_t *qseq, int64_t qlen,
                                const uint8_t *dseq, int64_t dlen,
                                int64_t mismatch, int64_t go, int64_t ge,
                                int64_t d, int64_t B, uint8_t *dirs,
                                int64_t *Hbuf, int64_t *Ebuf) {
  int64_t cutoff = d * (mismatch > go + ge ? mismatch : go + ge);
  if (qlen - dlen > B || dlen - qlen > B)
    return -1;
  const int64_t width = 2 * B + 1;
  const int64_t Q = go + ge, R = ge;
  for (int64_t k = 0; k < width; k++) {
    int64_t im1 = k - B - 1;
    Hbuf[k] = im1 >= 0 && im1 < qlen ? Q + im1 * R : BAND_INF;
    Ebuf[k] = im1 >= 0 && im1 < qlen ? 2 * Q + im1 * R : BAND_INF;
  }
  int64_t score = BAND_INF;
  for (int64_t row = 0; row < dlen; row++) {
    uint8_t *dirrow = dirs + row * width;
    int64_t F = BAND_INF;
    int64_t rowmin = BAND_INF;
    for (int64_t k = 0; k < width; k++) {
      const int64_t i = row + k - B;
      if (i < 0)
        continue;
      if (i >= qlen) {
        Hbuf[k] = BAND_INF;
        Ebuf[k] = BAND_INF;
        continue;
      }
      int64_t diag_in;
      if (i == 0) {
        diag_in = row == 0 ? 0 : go + row * ge;
        F = 2 * go + (row + 2) * ge;
      } else {
        diag_in = Hbuf[k];
      }
      const int64_t diag =
          (diag_in >= BAND_INF ? BAND_INF
                               : diag_in + (dseq[row] == qseq[i] ? 0 : mismatch));
      const int64_t E_in = k + 1 < width ? Ebuf[k + 1] : BAND_INF;
      int64_t pre = diag < E_in ? diag : E_in;
      int64_t Hnew = pre < F ? pre : F;
      uint8_t bits = 0;
      if (diag <= F)
        bits |= 1;
      {
        int64_t m = diag < F ? diag : F;
        if (E_in <= m)
          bits |= 2;
      }
      int64_t hq = Hnew + Q;
      if (hq <= F + R)
        bits |= 4;
      if (hq <= E_in + R)
        bits |= 8;
      dirrow[k] = bits;
      Hbuf[k] = Hnew;
      int64_t Enew = hq < E_in + R ? hq : E_in + R;
      Ebuf[k] = Enew > BAND_INF ? BAND_INF : Enew;
      int64_t openF = pre + Q;
      F = F + R < openF ? F + R : openF;
      if (F > BAND_INF)
        F = BAND_INF;
      if (Hnew < rowmin)
        rowmin = Hnew;
      if (row == dlen - 1 && i == qlen - 1)
        score = Hnew;
    }
    if (rowmin > cutoff)
      return -1; /* reject: no acceptable pair can cost this much */
  }
  if (score > cutoff)
    return -1;
  /* backtrack (same priorities as nw_pair_ideal_banded) */
  int64_t column = qlen - 1, row = dlen - 1;
  int64_t aligned = 0, matches = 0;
  int op = 0;
  while (column >= 0 && row >= 0) {
    aligned++;
    int64_t slot = column - row + B;
    uint8_t cell = slot >= 0 && slot < width ? dirs[row * width + slot] : 0;
    if (op == 1 && !(cell & 8))
      row--;
    else if (op == 2 && !(cell & 4))
      column--;
    else if (cell & 2) {
      row--;
      op = 1;
    } else if (!(cell & 1)) {
      column--;
      op = 2;
    } else {
      if (qseq[column] == dseq[row])
        matches++;
      column--;
      row--;
      op = 3;
    }
  }
  aligned += column + 1 + row + 1;
  int64_t diff = aligned - matches;
  return diff <= d ? diff : -1;
}

/* ------------------------------------------------------------------ */
/* 16-lane banded DP: independent (query, target) jobs ride the AVX512 */
/* int32 lanes in lock step — the reference's channel idea             */
/* (src/search8.cc: 16 channels x 8-bit) recast with one pair per      */
/* lane, transposed sequence tiles, and the ideal pure-pair semantics. */
/* Forward recurrences, clamps and direction bits are copied verbatim  */
/* from d2_pair_diff_one; the per-lane scalar backtrack reads the      */
/* lane-strided direction tile. ~16x the scalar kernel's throughput    */
/* (measured 6-16 ns/cell scalar; the vector path retires ~25 vector   */
/* ops per 16-cell row step).                                          */
/* ------------------------------------------------------------------ */

#if defined(__AVX512F__) && defined(__AVX512BW__)

/* diffs_out[l]: exact tie-broken diff when <= d, else -1.
 * Scratch (caller): dirs_t [maxd * width * 16], qT/dT [maxlen * 16],
 * HEv [2 * width] __m512i-aligned int32 x 16 (Hb rows then Eb rows).
 * Lanes with qlen 0 are inactive. */
static void d2_pair_diff_batch16(const uint8_t *const *qs,
                                 const int64_t *qlens,
                                 const uint8_t *const *ds,
                                 const int64_t *dlens, int nlanes,
                                 int64_t mismatch, int64_t go, int64_t ge,
                                 int64_t d, int64_t B, uint8_t *dirs_t,
                                 uint8_t *qT, uint8_t *dT, __m512i *HEv,
                                 int64_t *diffs_out) {
  const int64_t width = 2 * B + 1;
  const int64_t Q = go + ge, R = ge;
  const int64_t cutoff = d * (mismatch > Q ? mismatch : Q);
  int32_t qlen32[16], dlen32[16];
  int64_t maxq = 0, maxd = 0;
  uint16_t active = 0;
  for (int l = 0; l < 16; l++) {
    int64_t ql = l < nlanes ? qlens[l] : 0;
    int64_t dl = l < nlanes ? dlens[l] : 0;
    if (ql > 0 && dl > 0 && !(ql - dl > B || dl - ql > B)) {
      active |= (uint16_t)(1u << l);
      if (ql > maxq)
        maxq = ql;
      if (dl > maxd)
        maxd = dl;
      qlen32[l] = (int32_t)ql;
      dlen32[l] = (int32_t)dl;
    } else {
      qlen32[l] = 0;
      dlen32[l] = 0;
      if (l < nlanes)
        diffs_out[l] = -1;
    }
  }
  if (!active)
    return;

  /* transposed tiles: qT[p*16 + l] = qs[l][p]. Only active lanes'
   * columns are written — stale bytes in other columns (or past a
   * lane's length) are only ever read under lane masks that discard
   * the result, and per-call zero-fill of the full 16 x maxlen tile
   * dominated small batches (the seed loop averages 2-3 lanes). */
  for (int l = 0; l < nlanes; l++) {
    if (!(active >> l & 1))
      continue;
    const uint8_t *q = qs[l];
    for (int64_t p = 0; p < qlen32[l]; p++)
      qT[p * 16 + l] = q[p];
    const uint8_t *dd = ds[l];
    for (int64_t p = 0; p < dlen32[l]; p++)
      dT[p * 16 + l] = dd[p];
  }

  const __m512i INFV = _mm512_set1_epi32(BAND_INF32);
  const __m512i QV = _mm512_set1_epi32((int32_t)Q);
  const __m512i RV = _mm512_set1_epi32((int32_t)R);
  const __m512i MMV = _mm512_set1_epi32((int32_t)mismatch);
  const __m512i CUTV = _mm512_set1_epi32((int32_t)cutoff);
  const __m512i qlenv = _mm512_loadu_si512((const void *)qlen32);
  const __m512i dlenv = _mm512_loadu_si512((const void *)dlen32);
  const __m512i qlm1 = _mm512_sub_epi32(qlenv, _mm512_set1_epi32(1));
  const __m512i dlm1 = _mm512_sub_epi32(dlenv, _mm512_set1_epi32(1));

  __m512i *Hb = HEv, *Eb = HEv + width;
  for (int64_t k = 0; k < width; k++) {
    int64_t im1 = k - B - 1;
    if (im1 >= 0) {
      /* lanes with im1 < qlen get the boundary, others INF */
      __m512i val = _mm512_set1_epi32((int32_t)(Q + im1 * R));
      __m512i val2 = _mm512_set1_epi32((int32_t)(2 * Q + im1 * R));
      __mmask16 m = _mm512_cmplt_epi32_mask(_mm512_set1_epi32((int32_t)im1),
                                            qlenv);
      Hb[k] = _mm512_mask_mov_epi32(INFV, m, val);
      Eb[k] = _mm512_mask_mov_epi32(INFV, m, val2);
    } else {
      Hb[k] = INFV;
      Eb[k] = INFV;
    }
  }

  __m512i scorev = INFV;
  uint16_t rejected = 0, scored = 0;
  for (int64_t row = 0; row < maxd; row++) {
    const __m512i dvec = _mm512_cvtepu8_epi32(
        _mm_loadu_si128((const __m128i *)(dT + row * 16)));
    const __m512i rowv = _mm512_set1_epi32((int32_t)row);
    const __mmask16 m_lastrow = _mm512_cmpeq_epi32_mask(rowv, dlm1);
    const __mmask16 m_rowlive = _mm512_cmplt_epi32_mask(rowv, dlenv);
    const __m512i bval = _mm512_set1_epi32(
        (int32_t)(row == 0 ? 0 : go + row * ge));
    const __m512i fboundary =
        _mm512_set1_epi32((int32_t)(2 * go + (row + 2) * ge));
    __m512i Fv = INFV;
    __m512i rowminv = INFV;
    uint8_t *dirrow = dirs_t + row * width * 16;
    int64_t kstart = B - row > 0 ? B - row : 0;
    int64_t kend = maxq - 1 - row + B;
    if (kend > width - 1)
      kend = width - 1;
    for (int64_t k = kstart; k <= kend; k++) {
      const int64_t i = row + k - B;
      const __m512i iv = _mm512_set1_epi32((int32_t)i);
      const __mmask16 m_valid = _mm512_cmplt_epi32_mask(iv, qlenv);
      __m512i diag_in;
      if (i == 0) {
        diag_in = bval;
        Fv = fboundary;
      } else {
        diag_in = Hb[k];
      }
      const __m512i qvec = _mm512_cvtepu8_epi32(
          _mm_loadu_si128((const __m128i *)(qT + i * 16)));
      const __mmask16 m_inf =
          _mm512_cmpge_epi32_mask(diag_in, INFV);
      const __mmask16 m_eq = _mm512_cmpeq_epi32_mask(dvec, qvec);
      __m512i add = _mm512_mask_mov_epi32(MMV, m_eq, _mm512_setzero_si512());
      __m512i diag = _mm512_mask_mov_epi32(_mm512_add_epi32(diag_in, add),
                                           m_inf, INFV);
      const __m512i E_in = k + 1 < width ? Eb[k + 1] : INFV;
      const __m512i pre = _mm512_min_epi32(diag, E_in);
      const __m512i Hnew = _mm512_min_epi32(pre, Fv);
      /* direction bits, verbatim semantics */
      const __mmask16 b1 = _mm512_cmple_epi32_mask(diag, Fv);
      const __m512i mdf = _mm512_min_epi32(diag, Fv);
      const __mmask16 b2 = _mm512_cmple_epi32_mask(E_in, mdf);
      const __m512i hq = _mm512_add_epi32(Hnew, QV);
      const __m512i FR = _mm512_add_epi32(Fv, RV);
      const __m512i ER = _mm512_add_epi32(E_in, RV);
      const __mmask16 b4 = _mm512_cmple_epi32_mask(hq, FR);
      const __mmask16 b8 = _mm512_cmple_epi32_mask(hq, ER);
      __m512i bits = _mm512_maskz_set1_epi32(b1, 1);
      bits = _mm512_mask_add_epi32(bits, b2, bits, _mm512_set1_epi32(2));
      bits = _mm512_mask_add_epi32(bits, b4, bits, _mm512_set1_epi32(4));
      bits = _mm512_mask_add_epi32(bits, b8, bits, _mm512_set1_epi32(8));
      _mm_storeu_si128((__m128i *)(dirrow + k * 16),
                       _mm512_cvtepi32_epi8(bits));
      /* state updates: lanes past their query end freeze to INF
       * (exactly what the scalar loop writes there) */
      Hb[k] = _mm512_mask_mov_epi32(INFV, m_valid, Hnew);
      __m512i Enew = _mm512_min_epi32(hq, ER);
      Enew = _mm512_min_epi32(Enew, INFV);
      Eb[k] = _mm512_mask_mov_epi32(INFV, m_valid, Enew);
      const __m512i openF = _mm512_add_epi32(pre, QV);
      __m512i Fnew = _mm512_min_epi32(_mm512_add_epi32(Fv, RV), openF);
      Fnew = _mm512_min_epi32(Fnew, INFV);
      Fv = _mm512_mask_mov_epi32(Fv, m_valid, Fnew);
      rowminv = _mm512_mask_min_epi32(rowminv, m_valid, rowminv, Hnew);
      /* score capture at (dlen-1, qlen-1) per lane */
      const __mmask16 m_score = _mm512_kand(
          _mm512_kand(m_lastrow, _mm512_cmpeq_epi32_mask(iv, qlm1)),
          m_valid);
      scorev = _mm512_mask_mov_epi32(scorev, m_score, Hnew);
      scored |= (uint16_t)m_score;
    }
    /* early reject: a live row whose minimum exceeds the cutoff can
     * never come back down (costs are nondecreasing along any path) */
    rejected |= (uint16_t)(_mm512_cmpgt_epi32_mask(rowminv, CUTV) &
                           m_rowlive & active);
    if ((uint16_t)((rejected | scored) & active) == active)
      break;
  }

  int32_t scores[16];
  _mm512_storeu_si512((void *)scores, scorev);
  for (int l = 0; l < nlanes; l++) {
    if (!(active >> l & 1))
      continue;
    if ((rejected >> l & 1) || scores[l] > cutoff) {
      diffs_out[l] = -1;
      continue;
    }
    /* backtrack (same priorities as d2_pair_diff_one) */
    const uint8_t *qseq = qs[l];
    const uint8_t *dseq = ds[l];
    int64_t column = qlen32[l] - 1, row = dlen32[l] - 1;
    int64_t aligned = 0, matches = 0;
    int op = 0;
    while (column >= 0 && row >= 0) {
      aligned++;
      int64_t slot = column - row + B;
      uint8_t cell = slot >= 0 && slot < width
                         ? dirs_t[(row * width + slot) * 16 + l]
                         : 0;
      if (op == 1 && !(cell & 8))
        row--;
      else if (op == 2 && !(cell & 4))
        column--;
      else if (cell & 2) {
        row--;
        op = 1;
      } else if (!(cell & 1)) {
        column--;
        op = 2;
      } else {
        if (qseq[column] == dseq[row])
          matches++;
        column--;
        row--;
        op = 3;
      }
    }
    aligned += column + 1 + row + 1;
    int64_t diff = aligned - matches;
    diffs_out[l] = diff <= d ? diff : -1;
  }
}
#endif /* AVX512 */

static void *d2_pairs_worker(void *argp) {
  d2pairs_job_t *j = (d2pairs_job_t *)argp;
  const int64_t width = 2 * j->band + 1;
  uint8_t *dirs = (uint8_t *)malloc((size_t)(j->dlen_max * width));
  int64_t *Hbuf = (int64_t *)malloc((size_t)width * 8);
  int64_t *Ebuf = (int64_t *)malloc((size_t)width * 8);
  if (dirs == NULL || Hbuf == NULL || Ebuf == NULL) {
    free(dirs);
    free(Hbuf);
    free(Ebuf);
    j->fail = 1;
    return NULL;
  }
#if defined(__AVX512F__) && defined(__AVX512BW__)
  if (width <= D2_BATCH_MAX_WIDTH && j->dlen_max < (BAND_INF32 >> 6) &&
      getenv("SWARM_TPU_D2_BATCH_OFF") == NULL) {
    uint8_t *dirs_t = (uint8_t *)malloc((size_t)(j->dlen_max * width * 16));
    uint8_t *qT = (uint8_t *)malloc((size_t)j->dlen_max * 16);
    uint8_t *dT = (uint8_t *)malloc((size_t)j->dlen_max * 16);
    __m512i *HEv = (__m512i *)aligned_alloc(64, (size_t)(2 * width) * 64);
    if (dirs_t != NULL && qT != NULL && dT != NULL && HEv != NULL) {
      const uint8_t *lq[16], *ld[16];
      int64_t lql[16], ldl[16], diffs[16];
      int64_t *slots[16];
      int nl = 0;
      for (int64_t i = j->lo; i < j->hi; i++) {
        int64_t a = j->pa[i], b = j->pb[i];
        const uint8_t *sa = j->arena + j->offsets[a];
        const uint8_t *sb = j->arena + j->offsets[b];
        int need_ab = j->no_break || j->abundances[a] >= j->abundances[b];
        int need_ba = j->no_break || j->abundances[b] >= j->abundances[a];
        if (need_ab) {
          lq[nl] = sa; lql[nl] = j->lengths[a];
          ld[nl] = sb; ldl[nl] = j->lengths[b];
          slots[nl] = &j->diff_ab[i];
          nl++;
        } else {
          j->diff_ab[i] = -1;
        }
        if (nl == 16) {
          d2_pair_diff_batch16(lq, lql, ld, ldl, nl, j->mismatch, j->go,
                               j->ge, j->d, j->band, dirs_t, qT, dT, HEv,
                               diffs);
          for (int t = 0; t < nl; t++)
            *slots[t] = diffs[t];
          nl = 0;
        }
        if (need_ba) {
          lq[nl] = sb; lql[nl] = j->lengths[b];
          ld[nl] = sa; ldl[nl] = j->lengths[a];
          slots[nl] = &j->diff_ba[i];
          nl++;
        } else {
          j->diff_ba[i] = -1;
        }
        if (nl == 16) {
          d2_pair_diff_batch16(lq, lql, ld, ldl, nl, j->mismatch, j->go,
                               j->ge, j->d, j->band, dirs_t, qT, dT, HEv,
                               diffs);
          for (int t = 0; t < nl; t++)
            *slots[t] = diffs[t];
          nl = 0;
        }
      }
      if (nl > 0) {
        d2_pair_diff_batch16(lq, lql, ld, ldl, nl, j->mismatch, j->go, j->ge,
                             j->d, j->band, dirs_t, qT, dT, HEv, diffs);
        for (int t = 0; t < nl; t++)
          *slots[t] = diffs[t];
      }
      free(dirs_t); free(qT); free(dT); free(HEv);
      free(dirs); free(Hbuf); free(Ebuf);
      return NULL;
    }
    free(dirs_t); free(qT); free(dT); free(HEv);
  }
#endif
  for (int64_t i = j->lo; i < j->hi; i++) {
    int64_t a = j->pa[i], b = j->pb[i];
    int64_t la = j->lengths[a], lb = j->lengths[b];
    const uint8_t *sa = j->arena + j->offsets[a];
    const uint8_t *sb = j->arena + j->offsets[b];
    int need_ab = j->no_break || j->abundances[a] >= j->abundances[b];
    int need_ba = j->no_break || j->abundances[b] >= j->abundances[a];
    j->diff_ab[i] =
        need_ab ? d2_pair_diff_one(sa, la, sb, lb, j->mismatch, j->go,
                                   j->ge, j->d, j->band, dirs, Hbuf, Ebuf)
                : -1;
    j->diff_ba[i] =
        need_ba ? d2_pair_diff_one(sb, lb, sa, la, j->mismatch, j->go,
                                   j->ge, j->d, j->band, dirs, Hbuf, Ebuf)
                : -1;
  }
  free(dirs);
  free(Hbuf);
  free(Ebuf);
  return NULL;
}

/* Exact diffs for both needed directions of each candidate pair.
 * diff_ab[i] = diffs for query pa[i] vs target pb[i] when the
 * abundance rule admits that direction and diff <= d, else -1 (and
 * symmetrically diff_ba). Deterministic: output position i depends
 * only on pair i. Returns 0, or -1 on allocation failure. */
int64_t d2_diffs_pairs(const uint8_t *arena, const int64_t *offsets,
                       const int64_t *lengths, const int64_t *abundances,
                       const int64_t *pa, const int64_t *pb, int64_t P,
                       int64_t d, int64_t mismatch, int64_t go, int64_t ge,
                       int no_break, int64_t nthreads, int64_t *diff_ab,
                       int64_t *diff_ba) {
  if (P == 0)
    return 0;
  int64_t cutoff = d * (mismatch > go + ge ? mismatch : go + ge);
  int64_t band = band_for_exact(cutoff, go, ge);
  int64_t dlen_max = 1;
  for (int64_t i = 0; i < P; i++) {
    if (lengths[pa[i]] > dlen_max)
      dlen_max = lengths[pa[i]];
    if (lengths[pb[i]] > dlen_max)
      dlen_max = lengths[pb[i]];
  }
  if (nthreads < 1)
    nthreads = 1;
  if (nthreads > P)
    nthreads = P;
  if (nthreads > 64)
    nthreads = 64;
  d2pairs_job_t jobs[64];
  pthread_t tids[64];
  int joinable[64] = {0};
  int64_t chunk = (P + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; t++) {
    d2pairs_job_t *j = &jobs[t];
    j->arena = arena;
    j->offsets = offsets;
    j->lengths = lengths;
    j->abundances = abundances;
    j->pa = pa;
    j->pb = pb;
    j->P = P;
    j->d = d;
    j->mismatch = mismatch;
    j->go = go;
    j->ge = ge;
    j->no_break = no_break;
    j->band = band;
    j->dlen_max = dlen_max;
    j->diff_ab = diff_ab;
    j->diff_ba = diff_ba;
    j->lo = t * chunk;
    j->hi = (t + 1) * chunk < P ? (t + 1) * chunk : P;
    j->fail = 0;
    if (j->lo >= j->hi)
      continue;
    /* the last chunk runs inline; a failed spawn also runs inline */
    if (t < nthreads - 1 && pthread_create(&tids[t], NULL, d2_pairs_worker,
                                           j) == 0)
      joinable[t] = 1;
    else
      d2_pairs_worker(j);
  }
  for (int64_t t = 0; t < nthreads; t++)
    if (joinable[t])
      pthread_join(tids[t], NULL);
  for (int64_t t = 0; t < nthreads; t++)
    if (jobs[t].fail)
      return -1;
  return 0;
}

/* Graph-driven replay of algo_cluster: identical outputs, but
 * candidate discovery reads a precomputed directed adjacency (CSR,
 * targets ascending) instead of running qgram screens + alignments.
 * adj edges carry the exact accepted diff (<= d) for that direction.
 * pos_of must enter as the inverse of order (the identity).
 *
 * O(E log E), no rotations. The reference's insertion moves
 * (src/algo.cc:205-256) are stable extractions from a pool that is
 * always in ascending amplicon order, so (a) the next seed is simply
 * the smallest unswarmed amplicon, and (b) each generation's final
 * layout is its claimed members sorted ascending by amplicon id;
 * claim order (which fixes per-edge parent/diff and structure-row
 * order) is: generation members in that sorted order, each member's
 * adjacency in ascending target order. We therefore claim per
 * generation into a batch, emit structure rows at claim time, sort
 * the batch by id, and append — byte-identical output arrays. */
typedef struct {
  int64_t id;
  int64_t rad;
} graph_child_t;

static int graph_child_cmp(const void *x, const void *y) {
  const graph_child_t *a = (const graph_child_t *)x;
  const graph_child_t *b = (const graph_child_t *)y;
  return a->id < b->id ? -1 : (a->id > b->id ? 1 : 0);
}

int64_t algo_cluster_graph(
    const int64_t *adj_start, const int64_t *adj_count, const int64_t *adj_to,
    const int64_t *adj_diff, const int64_t *abundances, int64_t n,
    int want_structure, int64_t *order, int64_t *pos_of,
    int64_t *swarmid_arr, int64_t *gen_arr, int64_t *rad_arr,
    int64_t *swarm_seed, int64_t *swarm_size, int64_t *swarm_copies,
    int64_t *swarm_singletons, int64_t *swarm_maxgen, int64_t *swarm_maxrad,
    int64_t *swarm_bound, int64_t *struct_parent, int64_t *struct_child,
    int64_t *struct_diff, int64_t *struct_gen, int64_t *summary_out) {
  int64_t largestswarm = 0, maxgenerations = 0, swarmid = 0;
  int64_t swarmed = 0, struct_count = 0;

  /* pos_of doubles as the swarmed flag: -1 = claimed. order enters as
   * the identity (abundance order), so the next seed is the smallest
   * unclaimed id — a monotone cursor finds all seeds in O(n) total. */
  graph_child_t *batch =
      (graph_child_t *)malloc((size_t)(n > 0 ? n : 1) * sizeof(graph_child_t));
  if (batch == NULL)
    return -1;
  int64_t cursor = 0;

  while (swarmed < n) {
    while (pos_of[cursor] < 0)
      cursor++;
    int64_t seedampliconid = cursor;
    swarmid++;
    int64_t swarmsize = 1, copies = 0, singletons = 0;
    int64_t maxradius = 0, maxgen = 1;

    pos_of[seedampliconid] = -1;
    order[swarmed] = seedampliconid;
    swarmid_arr[swarmed] = swarmid;
    gen_arr[swarmed] = 0;
    rad_arr[swarmed] = 0;
    int64_t gen_begin = swarmed;
    swarmed++;
    int64_t abundance = abundances[seedampliconid];
    copies += abundance;
    if (abundance == 1)
      singletons++;

    int64_t gen_number = 0;
    while (gen_begin < swarmed) {
      int64_t gen_end = swarmed;
      int64_t nchild = 0;
      /* claim order: generation members ascending by id (their final
       * layout), each adjacency in ascending target order — identical
       * to the reference's subseed scan (src/algo.cc:505-602) */
      for (int64_t i = gen_begin; i < gen_end; i++) {
        int64_t u = order[i];
        int64_t urad = rad_arr[i];
        int64_t s = adj_start[u];
        int64_t e = s + adj_count[u];
        for (int64_t k = s; k < e; k++) {
          int64_t v = adj_to[k];
          if (pos_of[v] < 0)
            continue; /* already swarmed (or the seed itself) */
          int64_t diff = adj_diff[k];
          pos_of[v] = -1;
          batch[nchild].id = v;
          batch[nchild].rad = urad + diff;
          nchild++;
          if (want_structure) {
            struct_parent[struct_count] = u;
            struct_child[struct_count] = v;
            struct_diff[struct_count] = diff;
            struct_gen[struct_count] = gen_number + 1;
            struct_count++;
          }
          if (urad + diff > maxradius)
            maxradius = urad + diff;
          int64_t ab = abundances[v];
          copies += ab;
          if (ab == 1)
            singletons++;
          swarmsize++;
        }
      }
      if (nchild == 0)
        break;
      gen_number++;
      if (gen_number > maxgen)
        maxgen = gen_number;
      qsort(batch, (size_t)nchild, sizeof(graph_child_t), graph_child_cmp);
      for (int64_t j = 0; j < nchild; j++) {
        order[swarmed] = batch[j].id;
        swarmid_arr[swarmed] = swarmid;
        gen_arr[swarmed] = gen_number;
        rad_arr[swarmed] = batch[j].rad;
        swarmed++;
      }
      gen_begin = gen_end;
    }

    if (swarmsize > largestswarm)
      largestswarm = swarmsize;
    if (maxgen > maxgenerations)
      maxgenerations = maxgen;
    swarm_seed[swarmid - 1] = seedampliconid;
    swarm_size[swarmid - 1] = swarmsize;
    swarm_copies[swarmid - 1] = copies;
    swarm_singletons[swarmid - 1] = singletons;
    swarm_maxgen[swarmid - 1] = maxgen;
    swarm_maxrad[swarmid - 1] = maxradius;
    swarm_bound[swarmid - 1] = swarmed;
  }
  free(batch);

  summary_out[0] = largestswarm;
  summary_out[1] = maxgenerations;
  summary_out[2] = struct_count;
  summary_out[3] = 0;
  summary_out[4] = 0;
  summary_out[5] = 0;
  return swarmid;
}

/* ------------------------------------------------------------------ */
/* d=1 seeds (-w) writer (reference src/algod1.cc:936-975)             */
/* ------------------------------------------------------------------ */

/* print_id_with_new_abundance (src/db.cc:1000-1026) */
static int64_t emit_id_newab(const uint8_t *hdr, int64_t hlen, int32_t ab_s,
                             int32_t ab_e, int64_t ab, int usearch,
                             char *out) {
  if (usearch) {
    memcpy(out, hdr, (size_t)ab_s);
    int64_t w = ab_s;
    if (ab_s > 0)
      out[w++] = ';';
    memcpy(out + w, "size=", 5);
    w += 5;
    w += emit_u64((uint64_t)ab, out + w);
    out[w++] = ';';
    memcpy(out + w, hdr + ab_e, (size_t)(hlen - ab_e));
    return w + (hlen - ab_e);
  }
  memcpy(out, hdr, (size_t)ab_s);
  int64_t w = ab_s;
  out[w++] = '_';
  w += emit_u64((uint64_t)ab, out + w);
  return w;
}

typedef struct {
  int64_t mass;
  const uint8_t *hdr;
  int64_t hlen;
  int64_t idx;
} seed_order_t;

/* (-mass, header bytes) ascending; headers are unique (dup-ID fatal at
 * load), the idx tiebreak only guards qsort's unstable ordering */
static int seeds_order_cmp(const void *x, const void *y) {
  const seed_order_t *a = (const seed_order_t *)x;
  const seed_order_t *b = (const seed_order_t *)y;
  if (a->mass != b->mass)
    return a->mass > b->mass ? -1 : 1;
  size_t m = (size_t)(a->hlen < b->hlen ? a->hlen : b->hlen);
  int c = memcmp(a->hdr, b->hdr, m);
  if (c)
    return c;
  if (a->hlen != b->hlen)
    return a->hlen < b->hlen ? -1 : 1;
  return a->idx < b->idx ? -1 : (a->idx > b->idx ? 1 : 0);
}

/* Returns bytes written, -1 on short buffer, -2 on alloc failure.
 * Also stores the number of emitted records in *n_written. */
int64_t write_seeds_d1(
    const uint8_t *hdr_arena, const int64_t *hdr_off, const int64_t *hdr_len,
    const int32_t *ab_start, const int32_t *ab_end,
    const uint8_t *codes, const int64_t *seq_off, const int64_t *seq_len,
    const int64_t *swarm_seed, const int64_t *swarm_mass,
    const uint8_t *attached, int64_t nswarms, int usearch,
    char *out, int64_t out_cap, int64_t *n_written) {
  static const char ACGT[4] = {'A', 'C', 'G', 'T'};
  seed_order_t *ord =
      (seed_order_t *)malloc((size_t)(nswarms > 0 ? nswarms : 1) *
                             sizeof(seed_order_t));
  if (ord == NULL)
    return -2;
  for (int64_t i = 0; i < nswarms; i++) {
    int64_t seed = swarm_seed[i];
    ord[i].mass = swarm_mass[i];
    ord[i].hdr = hdr_arena + hdr_off[seed];
    ord[i].hlen = hdr_len[seed];
    ord[i].idx = i;
  }
  qsort(ord, (size_t)nswarms, sizeof(seed_order_t), seeds_order_cmp);
  int64_t w = 0;
  int64_t k = 0;
  for (int64_t i = 0; i < nswarms; i++) {
    int64_t s = ord[i].idx;
    if (attached[s])
      continue;
    int64_t seed = swarm_seed[s];
    if (w + hdr_len[seed] + seq_len[seed] + 64 > out_cap) {
      free(ord);
      return -1;
    }
    out[w++] = '>';
    w += emit_id_newab(hdr_arena + hdr_off[seed], hdr_len[seed],
                       ab_start[seed], ab_end[seed], ord[i].mass, usearch,
                       out + w);
    out[w++] = '\n';
    const uint8_t *sq = codes + seq_off[seed];
    int64_t L = seq_len[seed];
    for (int64_t p = 0; p < L; p++)
      out[w++] = ACGT[sq[p] > 3 ? 3 : sq[p]];
    out[w++] = '\n';
    k++;
  }
  free(ord);
  *n_written = k;
  return w;
}

/* ------------------------------------------------------------------ */
/* threaded host tails: -t honored on the uclust writer and the d=1    */
/* network probe phase (reference pthread-pool roles:                  */
/* src/utils/threads.h:30-163, src/algod1.cc:641-669 and 852-934)      */
/* ------------------------------------------------------------------ */

typedef struct {
  const uint8_t *codes;
  const int64_t *seq_off, *seq_len;
  const uint8_t *hdr_arena;
  const int64_t *hdr_off, *hdr_len;
  const int32_t *ab_start, *ab_end;
  const int64_t *abundance;
  int64_t append_ab;
  int usearch;
  const int64_t *members, *bounds;
  const uint8_t *attached;
  const int64_t *swarm_seed, *swarm_size;
  int64_t mismatch, go, ge, longest;
  int64_t s_begin, s_end, cluster_base;
  char *out;
  int64_t out_cap;
  int64_t written; /* bytes, or -2 pathological header, -3 alloc */
} uclust_task_t;

static void *uclust_worker(void *arg) {
  uclust_task_t *t = (uclust_task_t *)arg;
  int64_t L = t->longest > 0 ? t->longest : 1;
  uint8_t *dirs = (uint8_t *)malloc((size_t)(L * L));
  int64_t *Hbuf = (int64_t *)malloc((size_t)(L + 1) * 8);
  int64_t *Ebuf = (int64_t *)malloc((size_t)(L + 1) * 8);
  char *raw = (char *)malloc((size_t)(2 * L + 4));
  char *cigar = (char *)malloc((size_t)(16 * L + 32));
  if (!dirs || !Hbuf || !Ebuf || !raw || !cigar) {
    free(dirs); free(Hbuf); free(Ebuf); free(raw); free(cigar);
    t->written = -3;
    return NULL;
  }
  for (;;) {
    int64_t w = write_uclust_d1_range(
        t->codes, t->seq_off, t->seq_len, t->hdr_arena, t->hdr_off,
        t->hdr_len, t->ab_start, t->ab_end, t->abundance, t->append_ab,
        t->usearch, t->members, t->bounds + t->s_begin,
        t->attached + t->s_begin, t->s_end - t->s_begin,
        t->swarm_seed + t->s_begin, t->swarm_size + t->s_begin,
        t->mismatch, t->go, t->ge, t->cluster_base,
        dirs, Hbuf, Ebuf, raw, cigar, t->out, t->out_cap);
    if (w == -1) {
      int64_t nc = t->out_cap * 2;
      char *nb = (char *)realloc(t->out, (size_t)nc);
      if (nb == NULL) {
        t->written = -3;
        break;
      }
      t->out = nb;
      t->out_cap = nc;
      continue;
    }
    t->written = w;
    break;
  }
  free(dirs); free(Hbuf); free(Ebuf); free(raw); free(cigar);
  return NULL;
}

/* Byte-identical to the single-thread writer for every nthreads:
 * contiguous swarm ranges balanced by member count, per-range cluster
 * numbering rebased by the count of preceding non-attached swarms,
 * buffers concatenated in range order. Returns bytes written, or
 * -1 when out_cap is too small (caller doubles), -2 on pathological
 * headers (caller falls back to the Python writer), -3 on alloc
 * failure. */
int64_t write_uclust_d1_mt(
    const uint8_t *codes, const int64_t *seq_off, const int64_t *seq_len,
    const uint8_t *hdr_arena, const int64_t *hdr_off, const int64_t *hdr_len,
    const int32_t *ab_start, const int32_t *ab_end, const int64_t *abundance,
    int64_t append_ab, int usearch,
    const int64_t *members, const int64_t *bounds, const uint8_t *attached,
    int64_t nswarms, const int64_t *swarm_seed, const int64_t *swarm_size,
    int64_t mismatch, int64_t go, int64_t ge, int64_t longest,
    int64_t nthreads, char *out, int64_t out_cap) {
  if (nthreads < 1)
    nthreads = 1;
  if (nthreads > 64)
    nthreads = 64;
  if (nthreads > nswarms)
    nthreads = nswarms > 0 ? nswarms : 1;

  /* contiguous ranges balanced by member count */
  int64_t total_members = nswarms > 0 ? bounds[nswarms] - bounds[0] : 0;
  uclust_task_t tasks[64];
  pthread_t tids[64];
  int64_t s = 0;
  int64_t cluster_base = 0;
  for (int64_t t = 0; t < nthreads; t++) {
    int64_t target = bounds[0] + (total_members * (t + 1)) / nthreads;
    int64_t e = s;
    while (e < nswarms && (bounds[e] < target || e == s))
      e++;
    if (t == nthreads - 1)
      e = nswarms;
    uclust_task_t *tk = &tasks[t];
    tk->codes = codes; tk->seq_off = seq_off; tk->seq_len = seq_len;
    tk->hdr_arena = hdr_arena; tk->hdr_off = hdr_off; tk->hdr_len = hdr_len;
    tk->ab_start = ab_start; tk->ab_end = ab_end; tk->abundance = abundance;
    tk->append_ab = append_ab; tk->usearch = usearch;
    tk->members = members; tk->bounds = bounds; tk->attached = attached;
    tk->swarm_seed = swarm_seed; tk->swarm_size = swarm_size;
    tk->mismatch = mismatch; tk->go = go; tk->ge = ge; tk->longest = longest;
    tk->s_begin = s; tk->s_end = e; tk->cluster_base = cluster_base;
    int64_t range_members = e > s ? bounds[e] - bounds[s] : 0;
    tk->out_cap = 256 + range_members * (128 + 3 * longest);
    tk->out = (char *)malloc((size_t)tk->out_cap);
    tk->written = tk->out ? 0 : -3;
    for (int64_t x = s; x < e; x++)
      if (!attached[x])
        cluster_base++;
    s = e;
  }

  int created[64];
  for (int64_t t = 0; t < nthreads; t++) {
    created[t] = 0;
    if (tasks[t].written == -3) /* out-buffer alloc failed: never run */
      continue;
    if (t < nthreads - 1 &&
        pthread_create(&tids[t], NULL, uclust_worker, &tasks[t]) == 0)
      created[t] = 1;
    else
      uclust_worker(&tasks[t]); /* last task or create failure: inline */
  }
  for (int64_t t = 0; t < nthreads; t++)
    if (created[t])
      pthread_join(tids[t], NULL);

  int64_t total = 0;
  int64_t err = 0;
  for (int64_t t = 0; t < nthreads; t++) {
    if (tasks[t].written < 0)
      err = tasks[t].written;
    else
      total += tasks[t].written;
  }
  if (!err && total > out_cap)
    err = -1;
  if (!err) {
    int64_t w = 0;
    for (int64_t t = 0; t < nthreads; t++) {
      memcpy(out + w, tasks[t].out, (size_t)tasks[t].written);
      w += tasks[t].written;
    }
  }
  for (int64_t t = 0; t < nthreads; t++)
    free(tasks[t].out);
  return err ? err : total;
}

/* threaded d=1 probe phase: the table/bitset build stays serial (it is
 * a small fraction of the work), the 4L-probes-per-amplicon scan is
 * partitioned over contiguous amplicon ranges with private pair
 * buffers, then pairs are merged before the shared dedup/expand tail */
typedef struct {
  const uint8_t *arena;
  const int64_t *offsets, *lengths;
  int64_t a0, a1, maxlen, cap_tab;
  const uint64_t *seqhash;
  const int64_t *slots;
  const uint64_t *bset;
  uint64_t bmask;
  uint64_t *pairs;
  int64_t n_pairs, pair_cap;
  int rc;
} d1probe_task_t;

static void *d1probe_worker(void *arg) {
  d1probe_task_t *t = (d1probe_task_t *)arg;
  uint64_t *pre = (uint64_t *)malloc((size_t)(t->maxlen + 1) * 8);
  uint64_t *sufshift = (uint64_t *)malloc((size_t)(t->maxlen + 1) * 8);
  uint64_t *zt = zpos_table(t->maxlen);
  if (!pre || !sufshift || !zt) {
    free(pre); free(sufshift); free(zt);
    t->rc = -2;
    return NULL;
  }
  for (int64_t a = t->a0; a < t->a1 && t->rc == 0; a++) {
    const uint8_t *s = t->arena + t->offsets[a];
    const int64_t L = t->lengths[a];
    const uint64_t full = t->seqhash[a];
    pre[0] = 0;
    for (int64_t p = 0; p < L; p++)
      pre[p + 1] = pre[p] ^ ZPT(zt, p, s[p]);
    sufshift[L] = 0;
    for (int64_t p = L - 1; p >= 1; p--)
      sufshift[p] = sufshift[p + 1] ^ ZPT(zt, p - 1, s[p]);

    /* same two branch-light passes as the single-thread builder
     * (d1_network_native): exact substitutions from both sides plus
     * deletions; order is free under the caller's canonical dedup */
#define D1_PROBE_MT(hv_expr)                                                \
    do {                                                                    \
      const uint64_t hv = (hv_expr);                                        \
      const uint64_t hb = hv & t->bmask;                                    \
      if (((t->bset[hb >> 6] >> (hb & 63)) & 1)) {                          \
        uint64_t slot = hv & (uint64_t)(t->cap_tab - 1);                    \
        while (t->slots[slot] >= 0) {                                       \
          int64_t b = t->slots[slot];                                       \
          slot = (slot + 1) & (uint64_t)(t->cap_tab - 1);                   \
          if (b == a || t->seqhash[b] != hv)                                \
            continue;                                                       \
          if (!dist1_check(s, L, t->arena + t->offsets[b], t->lengths[b]))  \
            continue;                                                       \
          uint64_t key = a < b ? ((uint64_t)a << 32) | (uint64_t)b          \
                               : ((uint64_t)b << 32) | (uint64_t)a;         \
          if (t->n_pairs >= t->pair_cap) {                                  \
            int64_t nc2 = t->pair_cap * 2;                                  \
            uint64_t *np_ = (uint64_t *)realloc(t->pairs, (size_t)nc2 * 8); \
            if (np_ == NULL) {                                              \
              t->rc = -2;                                                   \
              break;                                                        \
            }                                                               \
            t->pairs = np_;                                                 \
            t->pair_cap = nc2;                                              \
          }                                                                 \
          t->pairs[t->n_pairs++] = key;                                     \
        }                                                                   \
      }                                                                     \
    } while (0)

    for (int64_t p = 0; p < L && t->rc == 0; p++) {
      static const uint8_t OTHER[4][3] = {
          {1, 2, 3}, {0, 2, 3}, {0, 1, 3}, {0, 1, 2}};
      const uint64_t *zrow = zt + 4 * p;
      const uint8_t *ot = OTHER[s[p]];
      const uint64_t base = full ^ zrow[s[p]];
      D1_PROBE_MT(base ^ zrow[ot[0]]);
      D1_PROBE_MT(base ^ zrow[ot[1]]);
      D1_PROBE_MT(base ^ zrow[ot[2]]);
    }
    if (L > 1)
      for (int64_t p = 0; p < L && t->rc == 0; p++)
        D1_PROBE_MT(pre[p] ^ sufshift[p + 1]);
#undef D1_PROBE_MT
  }
  free(pre);
  free(sufshift);
  free(zt);
  return NULL;
}

int64_t d1_network_native_mt(const uint8_t *arena, const int64_t *offsets,
                             const int64_t *lengths, int64_t n,
                             const int64_t *abundances, int no_break,
                             int64_t nthreads, int64_t *ef_out,
                             int64_t *et_out, int64_t cap_out) {
  if (n == 0)
    return 0;
  if (nthreads < 1)
    nthreads = 1;
  if (nthreads > 64)
    nthreads = 64;
  if (nthreads > n)
    nthreads = n;

  int64_t maxlen = 1;
  for (int64_t i = 0; i < n; i++)
    if (lengths[i] > maxlen)
      maxlen = lengths[i];

  uint64_t *seqhash = (uint64_t *)malloc((size_t)n * 8);
  int64_t cap_tab = 1;
  while (cap_tab < 2 * n)
    cap_tab <<= 1;
  int64_t bset_bits = 1;
  while (bset_bits < 8 * n)
    bset_bits <<= 1;
  uint64_t bmask = (uint64_t)(bset_bits - 1);
  uint64_t *bset = (uint64_t *)calloc((size_t)(bset_bits >> 6) + 1, 8);
  int64_t *slots = (int64_t *)malloc((size_t)cap_tab * 8);
  if (seqhash == NULL || slots == NULL || bset == NULL) {
    free(seqhash); free(slots); free(bset);
    return -2;
  }
  for (int64_t i = 0; i < cap_tab; i++)
    slots[i] = -1;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t *s = arena + offsets[i];
    uint64_t h = 0;
    for (int64_t p = 0; p < lengths[i]; p++)
      h ^= zpos(p, s[p]);
    seqhash[i] = h;
    uint64_t slot = h & (uint64_t)(cap_tab - 1);
    while (slots[slot] >= 0)
      slot = (slot + 1) & (uint64_t)(cap_tab - 1);
    slots[slot] = i;
    uint64_t hb = h & bmask;
    bset[hb >> 6] |= 1ULL << (hb & 63);
  }

  d1probe_task_t tasks[64];
  pthread_t tids[64];
  int created[64];
  for (int64_t t = 0; t < nthreads; t++) {
    d1probe_task_t *tk = &tasks[t];
    tk->arena = arena; tk->offsets = offsets; tk->lengths = lengths;
    tk->a0 = (n * t) / nthreads;
    tk->a1 = (n * (t + 1)) / nthreads;
    tk->maxlen = maxlen; tk->cap_tab = cap_tab;
    tk->seqhash = seqhash; tk->slots = slots;
    tk->bset = bset; tk->bmask = bmask;
    tk->pair_cap = 4 * (tk->a1 - tk->a0) + 64;
    tk->pairs = (uint64_t *)malloc((size_t)tk->pair_cap * 8);
    tk->n_pairs = 0;
    tk->rc = tk->pairs ? 0 : -2;
    created[t] = 0;
    if (tk->rc != 0)
      continue;
    if (t < nthreads - 1 &&
        pthread_create(&tids[t], NULL, d1probe_worker, tk) == 0)
      created[t] = 1;
    else
      d1probe_worker(tk);
  }
  for (int64_t t = 0; t < nthreads; t++)
    if (created[t])
      pthread_join(tids[t], NULL);
  free(slots);
  free(seqhash);
  free(bset);

  int64_t n_pairs = 0;
  int rc = 0;
  for (int64_t t = 0; t < nthreads; t++) {
    if (tasks[t].rc != 0)
      rc = tasks[t].rc;
    n_pairs += tasks[t].n_pairs;
  }
  uint64_t *pairs = (uint64_t *)malloc((size_t)(n_pairs > 0 ? n_pairs : 1) * 8);
  if (pairs == NULL)
    rc = -2;
  if (rc == 0) {
    int64_t w = 0;
    for (int64_t t = 0; t < nthreads; t++) {
      memcpy(pairs + w, tasks[t].pairs, (size_t)tasks[t].n_pairs * 8);
      w += tasks[t].n_pairs;
    }
  }
  for (int64_t t = 0; t < nthreads; t++)
    free(tasks[t].pairs);
  if (rc != 0) {
    free(pairs);
    return rc;
  }

  int cmp_u64(const void *x, const void *y);
  qsort(pairs, (size_t)n_pairs, 8, cmp_u64);
  int64_t m = 0;
  for (int64_t i = 0; i < n_pairs; i++)
    if (i == 0 || pairs[i] != pairs[i - 1])
      pairs[m++] = pairs[i];

  int64_t cnt = 0;
  for (int64_t i = 0; i < m; i++) {
    int64_t lo = (int64_t)(pairs[i] >> 32);
    int64_t hi = (int64_t)(pairs[i] & 0xFFFFFFFFULL);
    if (no_break || abundances[lo] >= abundances[hi]) {
      if (cnt >= cap_out) {
        free(pairs);
        return -1;
      }
      ef_out[cnt] = lo;
      et_out[cnt] = hi;
      cnt++;
    }
    if (no_break || abundances[hi] >= abundances[lo]) {
      if (cnt >= cap_out) {
        free(pairs);
        return -1;
      }
      ef_out[cnt] = hi;
      et_out[cnt] = lo;
      cnt++;
    }
  }
  free(pairs);
  /* pairs are (lo, hi)-sorted; the ordered expansion emits both
   * directions in lo-major order, so a final (from, to) sort is needed
   * exactly as in d1_network_native */
  uint64_t *packed = (uint64_t *)malloc((size_t)(cnt > 0 ? cnt : 1) * 8);
  if (packed == NULL)
    return -2;
  for (int64_t i = 0; i < cnt; i++)
    packed[i] = ((uint64_t)ef_out[i] << 32) | (uint64_t)et_out[i];
  qsort(packed, (size_t)cnt, 8, cmp_u64);
  for (int64_t i = 0; i < cnt; i++) {
    ef_out[i] = (int64_t)(packed[i] >> 32);
    et_out[i] = (int64_t)(packed[i] & 0xFFFFFFFFULL);
  }
  free(packed);
  return cnt;
}

/* exact dist<=1 verification of candidate pairs against the arena
 * (host tail of the width-bucketed d=1 join, where no full-width
 * device code table exists) */
void verify_dist1_pairs(const uint8_t *arena, const int64_t *offsets,
                        const int64_t *lengths, const int64_t *pa,
                        const int64_t *pb, int64_t P, uint8_t *good) {
  for (int64_t i = 0; i < P; i++) {
    int64_t a = pa[i], b = pb[i];
    if (a < 0 || b < 0) {
      good[i] = 0;
      continue;
    }
    good[i] = (uint8_t)dist1_check(arena + offsets[a], lengths[a],
                                   arena + offsets[b], lengths[b]);
  }
}

/* ------------------------------------------------------------------ */
/* host d=1 sort-join: the device engine's symmetric-delete join       */
/* (keys = full hash + deletion hash per run start) realized with an   */
/* LSD radix sort — cache-oblivious sequential passes instead of the   */
/* probe engine's random table walks, which fall off a cliff once the  */
/* table outgrows L2 (measured 18s at 1M amplicons vs ~4s here)        */
/* ------------------------------------------------------------------ */

/* packed key: top 40 bits of the Zobrist hash | 24-bit owner id.
 * 40 hash bits suffice: runs are grouped on the hash prefix and every
 * candidate pair is verified exactly, so prefix collisions only cost
 * a few million extra dist1_check calls at 1M amplicons — in exchange
 * the radix traffic halves (8-byte entries) and only the 40 hash bits
 * need sorting (4 x 10-bit passes, counters L1-resident). */
#define D1SJ_OWNER_BITS 24
#define D1SJ_OWNER_MASK ((1ULL << D1SJ_OWNER_BITS) - 1)

/* MSD top-12-bit partition + per-bucket 3x8-bit LSD over the next 24
 * bits — only the top 36 hash bits are sorted (L1-resident buckets at
 * ~28k keys/bucket for 114M keys); the 4 bits above the owner field
 * stay unsorted, so runs group on a 36-bit prefix and the exact
 * verifier absorbs the few extra collisions. Ends in `a`. */
static void radix_sort_keys40(uint64_t *a, uint64_t *tmp, int64_t n) {
  enum { MSD = 4096 };
  int64_t start[MSD + 1];
  {
    int64_t count[MSD];
    memset(count, 0, sizeof count);
    int shift = D1SJ_OWNER_BITS + 28;
    for (int64_t i = 0; i < n; i++)
      count[(a[i] >> shift) & (MSD - 1)]++;
    int64_t pos = 0;
    for (int b = 0; b < MSD; b++) {
      start[b] = pos;
      pos += count[b];
    }
    start[MSD] = pos;
    int64_t fill[MSD];
    memcpy(fill, start, sizeof fill);
    for (int64_t i = 0; i < n; i++)
      tmp[fill[(a[i] >> shift) & (MSD - 1)]++] = a[i];
  }
  for (int b = 0; b < MSD; b++) {
    int64_t lo = start[b];
    int64_t nb = start[b + 1] - lo;
    if (nb <= 1) {
      if (nb == 1)
        a[lo] = tmp[lo];
      continue;
    }
    uint64_t *src = tmp + lo;
    uint64_t *dst = a + lo;
    for (int pass = 0; pass < 3; pass++) { /* odd passes: ends in a */
      int shift = D1SJ_OWNER_BITS + 4 + 8 * pass;
      int64_t count[256];
      memset(count, 0, sizeof count);
      for (int64_t i = 0; i < nb; i++)
        count[(src[i] >> shift) & 0xFF]++;
      int64_t pos = 0;
      for (int d = 0; d < 256; d++) {
        int64_t c = count[d];
        count[d] = pos;
        pos += c;
      }
      for (int64_t i = 0; i < nb; i++)
        dst[count[(src[i] >> shift) & 0xFF]++] = src[i];
      uint64_t *t = src;
      src = dst;
      dst = t;
    }
  }
}

int64_t d1_network_sortjoin(const uint8_t *arena, const int64_t *offsets,
                            const int64_t *lengths, int64_t n,
                            const int64_t *abundances, int no_break,
                            int64_t *ef_out, int64_t *et_out,
                            int64_t cap_out) {
  if (n == 0)
    return 0;
  if (n >= (int64_t)1 << D1SJ_OWNER_BITS)
    return -3; /* caller falls back to the probe engine */
  int64_t maxlen = 1;
  int64_t total_keys = 0;
  for (int64_t i = 0; i < n; i++) {
    if (lengths[i] > maxlen)
      maxlen = lengths[i];
    total_keys += lengths[i] + 1; /* upper bound (run starts <= L) */
  }

  uint64_t *keys = (uint64_t *)malloc((size_t)total_keys * 8);
  uint64_t *tmp = (uint64_t *)malloc((size_t)total_keys * 8);
  uint64_t *pre = (uint64_t *)malloc((size_t)(maxlen + 1) * 8);
  uint64_t *sufshift = (uint64_t *)malloc((size_t)(maxlen + 1) * 8);
  uint64_t *zpt = zpos_table(maxlen);
  if (keys == NULL || tmp == NULL || pre == NULL || sufshift == NULL ||
      zpt == NULL) {
    free(keys); free(tmp); free(pre); free(sufshift); free(zpt);
    return -2;
  }

  double _t0 = _now();
  int64_t m = 0;
  for (int64_t a = 0; a < n; a++) {
    const uint8_t *s = arena + offsets[a];
    const int64_t L = lengths[a];
    pre[0] = 0;
    for (int64_t p = 0; p < L; p++)
      pre[p + 1] = pre[p] ^ ZPT(zpt, p, s[p]);
    keys[m++] = (pre[L] & ~D1SJ_OWNER_MASK) | (uint64_t)a; /* full hash */
    if (L > 1) {
      sufshift[L] = 0;
      for (int64_t p = L - 1; p >= 1; p--)
        sufshift[p] = sufshift[p + 1] ^ ZPT(zpt, p - 1, s[p]);
      /* deletion keys at run starts only (del_p == del_runstart(p)) */
      for (int64_t p = 0; p < L; p++) {
        if (p > 0 && s[p] == s[p - 1])
          continue;
        keys[m++] = ((pre[p] ^ sufshift[p + 1]) & ~D1SJ_OWNER_MASK)
                    | (uint64_t)a;
      }
    }
  }
  free(pre);
  free(sufshift);
  free(zpt);

  double _t1 = _now();
  radix_sort_keys40(keys, tmp, m);
  free(tmp);
  double _t2 = _now();

  /* run scan: all cross pairs within each equal-prefix run */
  int64_t pair_cap = 4 * n + 64;
  uint64_t *pairs = (uint64_t *)malloc((size_t)pair_cap * 8);
  if (pairs == NULL) {
    free(keys);
    return -2;
  }
  int64_t n_pairs = 0;
  int rc = 0;
  int64_t i = 0;
  while (i < m && rc == 0) {
    /* runs group on the SORTED prefix (top 36 bits) */
    uint64_t prefix = keys[i] >> (D1SJ_OWNER_BITS + 4);
    int64_t j = i + 1;
    while (j < m && (keys[j] >> (D1SJ_OWNER_BITS + 4)) == prefix)
      j++;
    for (int64_t x = i; x < j && rc == 0; x++) {
      int64_t a = (int64_t)(keys[x] & D1SJ_OWNER_MASK);
      for (int64_t y = x + 1; y < j; y++) {
        int64_t b = (int64_t)(keys[y] & D1SJ_OWNER_MASK);
        if (a == b)
          continue;
        if (!dist1_check(arena + offsets[a], lengths[a],
                         arena + offsets[b], lengths[b]))
          continue;
        uint64_t key = a < b ? ((uint64_t)a << 32) | (uint64_t)b
                             : ((uint64_t)b << 32) | (uint64_t)a;
        if (n_pairs >= pair_cap) {
          int64_t nc2 = pair_cap * 2;
          uint64_t *np_ = (uint64_t *)realloc(pairs, (size_t)nc2 * 8);
          if (np_ == NULL) {
            rc = -2;
            break;
          }
          pairs = np_;
          pair_cap = nc2;
        }
        pairs[n_pairs++] = key;
      }
    }
    i = j;
  }
  free(keys);
  if (rc != 0) {
    free(pairs);
    return rc;
  }
  if (getenv("SWARM_TPU_TIMING") != NULL)
    fprintf(stderr, "[d1sj] keys=%lld keygen %.2fs radix %.2fs scan %.2fs\n",
            (long long)m, _t1 - _t0, _t2 - _t1, _now() - _t2);

  int cmp_u64(const void *x, const void *y);
  qsort(pairs, (size_t)n_pairs, 8, cmp_u64);
  int64_t mu = 0;
  for (int64_t k = 0; k < n_pairs; k++)
    if (k == 0 || pairs[k] != pairs[k - 1])
      pairs[mu++] = pairs[k];

  int64_t cnt = 0;
  for (int64_t k = 0; k < mu; k++) {
    int64_t lo = (int64_t)(pairs[k] >> 32);
    int64_t hi = (int64_t)(pairs[k] & 0xFFFFFFFFULL);
    if (no_break || abundances[lo] >= abundances[hi]) {
      if (cnt >= cap_out) {
        free(pairs);
        return -1;
      }
      ef_out[cnt] = lo;
      et_out[cnt] = hi;
      cnt++;
    }
    if (no_break || abundances[hi] >= abundances[lo]) {
      if (cnt >= cap_out) {
        free(pairs);
        return -1;
      }
      ef_out[cnt] = hi;
      et_out[cnt] = lo;
      cnt++;
    }
  }
  free(pairs);
  uint64_t *packed = (uint64_t *)malloc((size_t)(cnt > 0 ? cnt : 1) * 8);
  if (packed == NULL)
    return -2;
  for (int64_t k = 0; k < cnt; k++)
    packed[k] = ((uint64_t)ef_out[k] << 32) | (uint64_t)et_out[k];
  qsort(packed, (size_t)cnt, 8, cmp_u64);
  for (int64_t k = 0; k < cnt; k++) {
    ef_out[k] = (int64_t)(packed[k] >> 32);
    et_out[k] = (int64_t)(packed[k] & 0xFFFFFFFFULL);
  }
  free(packed);
  return cnt;
}


/* ------------------------------------------------------------------ */
/* host fastidious graft join (reference src/algod1.cc:374-552's role) */
/* — the d=1 radix sort-join idea applied to the variant-hash join:    */
/* both sides' canonical microvariant hashes (7L+4 per amplicon) into  */
/* one radix sort, cross-side pairs per equal-hash run, exact midpoint */
/* verification. Counting matches models/d1.py:_graft_join: one event  */
/* per verified (heavy variant instance, light variant instance) pair. */
/* ------------------------------------------------------------------ */

#define GJ_IDX_BITS 28
#define GJ_IDX_MASK ((1ULL << GJ_IDX_BITS) - 1)

/* MSD top-9-bit partition, then per-bucket LSD over the remaining 27
 * bits: after the single GB-scale scatter every later pass works on a
 * ~m/512-key slice that stays cache-resident — the flat LSD version
 * paid a TLB-hostile 512-stream scatter across the whole array on
 * every pass (measured 2-3x slower at 200M keys). Result lands back
 * in `a`. */
/* MSD 12-bit partition + two 12-bit LSD passes per bucket (36 bits
 * total, 3 GB-scale passes instead of 4). Returns the buffer holding
 * the sorted keys (a or tmp); the caller frees both. */
static uint64_t *radix_sort_keys36(uint64_t *a, uint64_t *tmp, int64_t n) {
  enum { MSD = 4096 };
  int64_t start[MSD + 1];
  {
    int64_t count[MSD];
    memset(count, 0, sizeof count);
    int shift = GJ_IDX_BITS + 24;
    for (int64_t i = 0; i < n; i++)
      count[(a[i] >> shift) & (MSD - 1)]++;
    int64_t pos = 0;
    for (int b = 0; b < MSD; b++) {
      start[b] = pos;
      pos += count[b];
    }
    start[MSD] = pos;
    int64_t fill[MSD];
    memcpy(fill, start, sizeof fill);
    for (int64_t i = 0; i < n; i++)
      tmp[fill[(a[i] >> shift) & (MSD - 1)]++] = a[i];
  }
  /* per bucket: LSD low-12 (tmp -> a) then high-12 (a -> tmp); both
   * passes work on ~n/4096 keys, cache-resident */
  for (int b = 0; b < MSD; b++) {
    int64_t lo = start[b];
    int64_t nb = start[b + 1] - lo;
    if (nb <= 1)
      continue;
    uint64_t *src = tmp + lo;
    uint64_t *dst = a + lo;
    for (int pass = 0; pass < 2; pass++) {
      int shift = GJ_IDX_BITS + 12 * pass;
      int64_t count[4096];
      memset(count, 0, sizeof count);
      for (int64_t i = 0; i < nb; i++)
        count[(src[i] >> shift) & 0xFFF]++;
      int64_t pos = 0;
      for (int d = 0; d < 4096; d++) {
        int64_t c = count[d];
        count[d] = pos;
        pos += c;
      }
      for (int64_t i = 0; i < nb; i++)
        dst[count[(src[i] >> shift) & 0xFFF]++] = src[i];
      uint64_t *t = src;
      src = dst;
      dst = t;
    }
  }
  return tmp; /* even inner passes: sorted data ends in tmp */
}

/* emit the canonical 1-edit variant hashes of amp a (the enumeration
 * of ops/neighbors.py:variant_hashes — each variant SEQUENCE exactly
 * once): 3L substitutions, deletions at run starts, 3L insertions
 * after p with base != s_p, 4 head insertions. meta: (var_kind << 30 |
 * pos << 2 | base_sel) packed per key for exact re-materialization. */
static int64_t gj_emit_variants(const uint64_t *zpt, const uint8_t *s,
                                int64_t L, uint64_t full,
                                uint64_t *pre, uint64_t *sufshift,
                                uint64_t *sufins, uint64_t *keys,
                                uint32_t *meta_amp, uint32_t *meta_slot,
                                int64_t m, uint32_t amp, uint32_t side) {
  pre[0] = 0;
  for (int64_t p = 0; p < L; p++)
    pre[p + 1] = pre[p] ^ ZPT(zpt, p, s[p]);
  sufshift[L] = 0;
  for (int64_t p = L - 1; p >= 1; p--)
    sufshift[p] = sufshift[p + 1] ^ ZPT(zpt, p - 1, s[p]);
  sufins[L] = 0;
  for (int64_t p = L - 1; p >= 0; p--)
    sufins[p] = sufins[p + 1] ^ ZPT(zpt, p + 1, s[p]);

#define GJ_PUSH(h, kind, pos, sel)                                          \
  do {                                                                      \
    keys[m] = (((h) >> 28) << GJ_IDX_BITS) | (uint64_t)m;                   \
    meta_amp[m] = amp | (side << 31);                                       \
    meta_slot[m] = ((uint32_t)(kind) << 24) | ((uint32_t)(pos) << 2)        \
                   | (uint32_t)(sel);                                       \
    m++;                                                                    \
  } while (0)

  for (int64_t p = 0; p < L; p++) {
    int oc = s[p];
    for (int v = 0; v < 3; v++) {
      int c = oc + 1 + v;
      if (c > 3)
        c -= 4;
      uint64_t h = full ^ ZPT(zpt, p, oc) ^ ZPT(zpt, p, c);
      GJ_PUSH(h, 0, p, c);
    }
    if (L > 1 && (p == 0 || s[p] != s[p - 1]))
      GJ_PUSH(pre[p] ^ sufshift[p + 1], 1, p, 0);
    for (int v = 0; v < 3; v++) {
      int c = oc + 1 + v;
      if (c > 3)
        c -= 4;
      uint64_t h = pre[p + 1] ^ ZPT(zpt, p + 1, c) ^ sufins[p + 1];
      GJ_PUSH(h, 2, p + 1, c);
    }
  }
  for (int c = 0; c < 4; c++)
    GJ_PUSH(ZPT(zpt, 0, c) ^ sufins[0], 2, 0, c);
#undef GJ_PUSH
  return m;
}

/* materialize variant (kind, pos, base) of s into out; returns len */
static int64_t gj_materialize(const uint8_t *s, int64_t L, uint32_t mslot,
                              uint8_t *out) {
  uint32_t kind = mslot >> 24;
  int64_t p = (mslot >> 2) & 0x3FFFFF;
  uint8_t b = (uint8_t)(mslot & 3);
  if (kind == 0) { /* substitution at p */
    memcpy(out, s, (size_t)L);
    out[p] = b;
    return L;
  }
  if (kind == 1) { /* deletion at p */
    memcpy(out, s, (size_t)p);
    memcpy(out + p, s + p + 1, (size_t)(L - p - 1));
    return L - 1;
  }
  /* insertion at position p */
  memcpy(out, s, (size_t)p);
  out[p] = b;
  memcpy(out + p + 1, s + p, (size_t)(L - p));
  return L + 1;
}

/* Returns the verified-pair count; fills graft_cand[l] = min heavy.
 * graft_cand must arrive filled with -1. Errors: -2 alloc, -3 key
 * space exceeded (caller falls back). */
int64_t graft_join_native(const uint8_t *arena, const int64_t *offsets,
                          const int64_t *lengths, int64_t n,
                          const int64_t *heavy_ids, int64_t n_heavy,
                          const int64_t *light_ids, int64_t n_light,
                          int64_t *graft_cand) {
  int64_t maxlen = 1;
  int64_t total_keys = 0;
  for (int64_t i = 0; i < n_heavy; i++) {
    int64_t L = lengths[heavy_ids[i]];
    if (L > maxlen)
      maxlen = L;
    total_keys += 7 * L + 4;
  }
  for (int64_t i = 0; i < n_light; i++) {
    int64_t L = lengths[light_ids[i]];
    if (L > maxlen)
      maxlen = L;
    total_keys += 7 * L + 4;
  }
  if (total_keys >= (int64_t)1 << GJ_IDX_BITS || maxlen >= (int64_t)1 << 22)
    return -3; /* key space or meta pos field exceeded */

  uint64_t *keys = (uint64_t *)malloc((size_t)total_keys * 8);
  uint64_t *tmp = (uint64_t *)malloc((size_t)total_keys * 8);
  uint32_t *meta_amp = (uint32_t *)malloc((size_t)total_keys * 4);
  uint32_t *meta_slot = (uint32_t *)malloc((size_t)total_keys * 4);
  uint64_t *pre = (uint64_t *)malloc((size_t)(maxlen + 2) * 8);
  uint64_t *sufshift = (uint64_t *)malloc((size_t)(maxlen + 2) * 8);
  uint64_t *sufins = (uint64_t *)malloc((size_t)(maxlen + 2) * 8);
  uint8_t *va = (uint8_t *)malloc((size_t)(maxlen + 2));
  uint8_t *vb = (uint8_t *)malloc((size_t)(maxlen + 2));
  uint64_t *zpt = zpos_table(maxlen);
  if (!keys || !tmp || !meta_amp || !meta_slot || !pre || !sufshift ||
      !sufins || !va || !vb || !zpt) {
    free(keys); free(tmp); free(meta_amp); free(meta_slot);
    free(pre); free(sufshift); free(sufins); free(va); free(vb); free(zpt);
    return -2;
  }

  double _gt0 = _now();
  int64_t m = 0;
  for (int64_t i = 0; i < n_heavy; i++) {
    int64_t a = heavy_ids[i];
    const uint8_t *s = arena + offsets[a];
    int64_t L = lengths[a];
    uint64_t full = 0;
    for (int64_t p = 0; p < L; p++)
      full ^= ZPT(zpt, p, s[p]);
    m = gj_emit_variants(zpt, s, L, full, pre, sufshift, sufins, keys,
                         meta_amp, meta_slot, m, (uint32_t)a, 1U);
  }
  for (int64_t i = 0; i < n_light; i++) {
    int64_t a = light_ids[i];
    const uint8_t *s = arena + offsets[a];
    int64_t L = lengths[a];
    uint64_t full = 0;
    for (int64_t p = 0; p < L; p++)
      full ^= ZPT(zpt, p, s[p]);
    m = gj_emit_variants(zpt, s, L, full, pre, sufshift, sufins, keys,
                         meta_amp, meta_slot, m, (uint32_t)a, 0U);
  }

  double _gt1 = _now();
  uint64_t *sorted = radix_sort_keys36(keys, tmp, m);
  double _gt2 = _now();

  int64_t count = 0;
  int64_t _nverify = 0;
  int64_t i = 0;
  while (i < m) {
    uint64_t prefix = sorted[i] >> GJ_IDX_BITS;
    int64_t j = i + 1;
    while (j < m && (sorted[j] >> GJ_IDX_BITS) == prefix)
      j++;
    if (j - i >= 2) {
      for (int64_t x = i; x < j; x++) {
        uint64_t kx = sorted[x] & GJ_IDX_MASK;
        if (!(meta_amp[kx] >> 31))
          continue; /* want heavy on the x side */
        int64_t ha = (int64_t)(meta_amp[kx] & 0x7FFFFFFFU);
        int64_t la_len = -1;
        for (int64_t y = i; y < j; y++) {
          uint64_t ky = sorted[y] & GJ_IDX_MASK;
          if (meta_amp[ky] >> 31)
            continue; /* want light on the y side */
          int64_t la = (int64_t)(meta_amp[ky] & 0x7FFFFFFFU);
          if (la_len < 0)
            la_len = gj_materialize(arena + offsets[ha], lengths[ha],
                                    meta_slot[kx], va);
          _nverify++;
          int64_t lb_len = gj_materialize(arena + offsets[la], lengths[la],
                                          meta_slot[ky], vb);
          if (la_len != lb_len ||
              memcmp(va, vb, (size_t)la_len) != 0)
            continue;
          count++;
          if (graft_cand[la] < 0 || ha < graft_cand[la])
            graft_cand[la] = ha;
        }
      }
    }
    i = j;
  }
  if (getenv("SWARM_TPU_TIMING") != NULL)
    fprintf(stderr,
            "[graftC] keys=%lld keygen %.2fs radix %.2fs scan %.2fs "
            "(verify calls %lld)\n",
            (long long)m, _gt1 - _gt0, _gt2 - _gt1, _now() - _gt2,
            (long long)_nverify);
  free(keys);
  free(tmp);
  free(meta_amp);
  free(meta_slot);
  free(pre);
  free(sufshift);
  free(sufins);
  free(va);
  free(vb);
  free(zpt);
  return count;
}

/* ------------------------------------------------------------------ */
/* Asymmetric probe variant of the graft join: the side with FEWER     */
/* variant keys goes into an open-addressing hash table behind a       */
/* cache-resident bitset prefilter (the reference Bloom filter's role, */
/* src/algod1.cc:374-552); the bigger side's variants are enumerated   */
/* per amplicon into a reused strip and probe the table on the fly —   */
/* no big-side key array and no GB-scale radix passes. At 200k heavy   */
/* x 108 light this replaces a 14s single-core radix sort of 203M      */
/* keys with ~1s of bit tests. Counting and graft_cand semantics are   */
/* identical to graft_join_native (one event per verified (heavy       */
/* instance, light instance) pair; min heavy id per light).            */
/* ------------------------------------------------------------------ */

int64_t graft_probe_native(const uint8_t *arena, const int64_t *offsets,
                           const int64_t *lengths, int64_t n,
                           const int64_t *heavy_ids, int64_t n_heavy,
                           const int64_t *light_ids, int64_t n_light,
                           int64_t *graft_cand) {
  (void)n;
  int64_t maxlen = 1;
  int64_t keys_h = 0, keys_l = 0;
  for (int64_t i = 0; i < n_heavy; i++) {
    int64_t L = lengths[heavy_ids[i]];
    if (L > maxlen)
      maxlen = L;
    keys_h += 7 * L + 4;
  }
  for (int64_t i = 0; i < n_light; i++) {
    int64_t L = lengths[light_ids[i]];
    if (L > maxlen)
      maxlen = L;
    keys_l += 7 * L + 4;
  }
  int table_is_heavy = keys_h <= keys_l;
  const int64_t *t_ids = table_is_heavy ? heavy_ids : light_ids;
  int64_t t_n = table_is_heavy ? n_heavy : n_light;
  int64_t t_keys = table_is_heavy ? keys_h : keys_l;
  const int64_t *b_ids = table_is_heavy ? light_ids : heavy_ids;
  int64_t b_n = table_is_heavy ? n_light : n_heavy;
  if (t_keys >= (int64_t)1 << GJ_IDX_BITS || maxlen >= (int64_t)1 << 22)
    return -3;

  int64_t strip_cap = 7 * maxlen + 4;
  uint64_t *tkeys = (uint64_t *)malloc((size_t)(t_keys ? t_keys : 1) * 8);
  uint32_t *t_amp = (uint32_t *)malloc((size_t)(t_keys ? t_keys : 1) * 4);
  uint32_t *t_slot = (uint32_t *)malloc((size_t)(t_keys ? t_keys : 1) * 4);
  uint64_t *bkeys = (uint64_t *)malloc((size_t)strip_cap * 8);
  uint32_t *b_amp = (uint32_t *)malloc((size_t)strip_cap * 4);
  uint32_t *b_slot = (uint32_t *)malloc((size_t)strip_cap * 4);
  uint64_t *pre = (uint64_t *)malloc((size_t)(maxlen + 2) * 8);
  uint64_t *sufshift = (uint64_t *)malloc((size_t)(maxlen + 2) * 8);
  uint64_t *sufins = (uint64_t *)malloc((size_t)(maxlen + 2) * 8);
  uint8_t *va = (uint8_t *)malloc((size_t)(maxlen + 2));
  uint8_t *vb = (uint8_t *)malloc((size_t)(maxlen + 2));
  uint64_t *zpt = zpos_table(maxlen);
  if (!tkeys || !t_amp || !t_slot || !bkeys || !b_amp || !b_slot || !pre ||
      !sufshift || !sufins || !va || !vb || !zpt) {
    free(tkeys); free(t_amp); free(t_slot); free(bkeys); free(b_amp);
    free(b_slot); free(pre); free(sufshift); free(sufins); free(va);
    free(vb); free(zpt);
    return -2;
  }

  double _gt0 = _now();
  int64_t m = 0;
  for (int64_t i = 0; i < t_n; i++) {
    int64_t a = t_ids[i];
    const uint8_t *s = arena + offsets[a];
    int64_t L = lengths[a];
    uint64_t full = 0;
    for (int64_t p = 0; p < L; p++)
      full ^= ZPT(zpt, p, s[p]);
    m = gj_emit_variants(zpt, s, L, full, pre, sufshift, sufins, tkeys,
                         t_amp, t_slot, m, (uint32_t)a,
                         table_is_heavy ? 1U : 0U);
  }

  /* open addressing, power-of-2 slots, load factor <= 0.5; an entry
   * packs (key36 << GJ_IDX_BITS | table index); empty = all-ones */
  int64_t slots = 1024;
  while (slots < 2 * m)
    slots <<= 1;
  uint64_t *tab = (uint64_t *)malloc((size_t)slots * 8);
  /* bitset prefilter at ~128 bits per key (<1% set), clamped to stay
   * cache-resident: at 110k keys that is a 2 MB bitset with a 0.7%
   * hit rate — 16 bits per key measured 5% hits = 10.4M table-cluster
   * scans at 200k amplicons, most of the probe wall */
  int64_t bbits = 1 << 16;
  while (bbits < 128 * m && bbits < ((int64_t)1 << 26))
    bbits <<= 1;
  uint64_t *bset = (uint64_t *)calloc((size_t)(bbits >> 6), 8);
  if (!tab || !bset) {
    free(tab); free(bset); free(tkeys); free(t_amp); free(t_slot);
    free(bkeys); free(b_amp); free(b_slot); free(pre); free(sufshift);
    free(sufins); free(va); free(vb); free(zpt);
    return -2;
  }
  memset(tab, 0xFF, (size_t)slots * 8);
  uint64_t smask = (uint64_t)slots - 1;
  uint64_t bmask = (uint64_t)bbits - 1;
  for (int64_t k = 0; k < m; k++) {
    uint64_t key36 = tkeys[k] >> GJ_IDX_BITS;
    uint64_t j = key36 & smask;
    while (tab[j] != UINT64_MAX)
      j = (j + 1) & smask;
    tab[j] = (key36 << GJ_IDX_BITS) | (uint64_t)k;
    uint64_t bb = key36 & bmask;
    bset[bb >> 6] |= 1ULL << (bb & 63);
  }

  /* qgram prescreen: dist(x, y) <= 2 requires <= 20 differing parity
   * bits (each edit flips at most 2*5 = 10 qgram parities; reference
   * bound src/qgram.cc:247-252). A graft link needs a shared gen-1
   * variant, i.e. dist(big, table_amp) <= 2 for SOME table amplicon,
   * so when the table side has few amplicons a t_n x 2x512-bit
   * popcount screen per big-side amplicon skips the 7L+4 keygen +
   * bitset probes for everything not near any table-side sequence —
   * the overwhelming majority in the lopsided shapes -f produces.
   * Soundness of the bound keeps the candidate COUNT exact: skipped
   * amplicons contribute zero verified variant matches. */
  int use_screen = t_n > 0 && (double)t_n * (double)b_n <= 4e8;
  uint64_t *tprof = NULL;
  if (use_screen) {
    tprof = (uint64_t *)calloc((size_t)t_n * 16, 8);
    if (tprof == NULL)
      use_screen = 0;
    else
      for (int64_t i = 0; i < t_n; i++) {
        const uint8_t *s = arena + offsets[t_ids[i]];
        int64_t L = lengths[t_ids[i]];
        uint64_t *prof = tprof + i * 16;
        unsigned q = 0;
        for (int64_t p = 0; p < L; p++) {
          q = ((q << 2) | s[p]) & 1023;
          if (p >= 4)
            prof[q >> 6] ^= 1ULL << (q & 63);
        }
      }
  }
  double _gt1 = _now();

  int64_t count = 0;
  int64_t _nverify = 0, _nhits = 0, _nscreened = 0;
  uint64_t bp[16];
  for (int64_t i = 0; i < b_n; i++) {
    int64_t a = b_ids[i];
    const uint8_t *s = arena + offsets[a];
    int64_t L = lengths[a];
    if (use_screen) {
      memset(bp, 0, sizeof(bp));
      unsigned q = 0;
      for (int64_t p = 0; p < L; p++) {
        q = ((q << 2) | s[p]) & 1023;
        if (p >= 4)
          bp[q >> 6] ^= 1ULL << (q & 63);
      }
      int near = 0;
      for (int64_t t = 0; t < t_n; t++)
        if (qgram_diffbits(tprof + t * 16, bp) <= 20) {
          near = 1;
          break;
        }
      if (!near) {
        _nscreened++;
        continue;
      }
    }
    uint64_t full = 0;
    for (int64_t p = 0; p < L; p++)
      full ^= ZPT(zpt, p, s[p]);
    int64_t mb = gj_emit_variants(zpt, s, L, full, pre, sufshift, sufins,
                                  bkeys, b_amp, b_slot, 0, (uint32_t)a,
                                  table_is_heavy ? 0U : 1U);
    for (int64_t x = 0; x < mb; x++) {
      uint64_t key36 = bkeys[x] >> GJ_IDX_BITS;
      uint64_t bb = key36 & bmask;
      if (!(bset[bb >> 6] >> (bb & 63) & 1))
        continue;
      _nhits++;
      int64_t xa_len = -1;
      for (uint64_t j = key36 & smask; tab[j] != UINT64_MAX;
           j = (j + 1) & smask) {
        if ((tab[j] >> GJ_IDX_BITS) != key36)
          continue;
        int64_t k = (int64_t)(tab[j] & GJ_IDX_MASK);
        int64_t ta = (int64_t)(t_amp[k] & 0x7FFFFFFFU);
        if (xa_len < 0)
          xa_len = gj_materialize(s, L, b_slot[x], va);
        _nverify++;
        int64_t tb_len = gj_materialize(arena + offsets[ta], lengths[ta],
                                        t_slot[k], vb);
        if (xa_len != tb_len || memcmp(va, vb, (size_t)xa_len) != 0)
          continue;
        count++;
        int64_t ha = table_is_heavy ? ta : a;
        int64_t la = table_is_heavy ? a : ta;
        if (graft_cand[la] < 0 || ha < graft_cand[la])
          graft_cand[la] = ha;
      }
    }
  }
  if (getenv("SWARM_TPU_TIMING") != NULL)
    fprintf(stderr,
            "[graftP] table=%lld keys, big=%lld amps: build %.2fs probe "
            "%.2fs (qgram-screened %lld, bitset hits %lld, verify calls "
            "%lld)\n",
            (long long)m, (long long)b_n, _gt1 - _gt0, _now() - _gt1,
            (long long)_nscreened, (long long)_nhits, (long long)_nverify);
  free(tprof);
  free(tab);
  free(bset);
  free(tkeys);
  free(t_amp);
  free(t_slot);
  free(bkeys);
  free(b_amp);
  free(b_slot);
  free(pre);
  free(sufshift);
  free(sufins);
  free(va);
  free(vb);
  free(zpt);
  return count;
}

/* ------------------------------------------------------------------ */
/* fastidious variant accounting (reference src/algod1.cc:1436-1472):  */
/* the log lines need the exact number of variants the reference       */
/* would generate, sum over amplicons of 6L + 4 + runs(seq).           */
/* ------------------------------------------------------------------ */

int64_t variant_count_total(const uint8_t *arena, const int64_t *offsets,
                            const int64_t *lengths, const int64_t *ids,
                            int64_t n_ids) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_ids; i++) {
    int64_t a = ids[i];
    const uint8_t *s = arena + offsets[a];
    int64_t L = lengths[a];
    if (L <= 0)
      continue;
    int64_t runs = 1;
    for (int64_t p = 1; p < L; p++)
      runs += s[p] != s[p - 1];
    total += 6 * L + 4 + runs;
  }
  return total;
}

/* ------------------------------------------------------------------ */
/* d=1 edge finishing: unique verified pairs (a < b, sorted by (a,b)) */
/* -> ordered edges under the abundance rule, sorted by (from, to).   */
/* Replaces the numpy two-direction expand + lexsort on the host tail */
/* (~0.15s at 1M amplicons; this is three linear passes).             */
/* ------------------------------------------------------------------ */

int64_t d1_finish_edges(const int64_t *ga, const int64_t *gb, int64_t m,
                        const int64_t *abundances, int no_break, int64_t n,
                        int64_t *ef_out, int64_t *et_out) {
  if (m == 0)
    return 0;
  /* direction a->b in input order is already sorted by (a, b);
   * direction b->a needs a stable counting sort by b (within equal b
   * the input's ascending a gives ascending 'to') */
  int64_t *cnt = (int64_t *)calloc((size_t)(n + 1), 8);
  int64_t *e2f = (int64_t *)malloc((size_t)m * 8);
  int64_t *e2t = (int64_t *)malloc((size_t)m * 8);
  if (cnt == NULL || e2f == NULL || e2t == NULL) {
    free(cnt); free(e2f); free(e2t);
    return -2;
  }
  int64_t m2 = 0;
  for (int64_t i = 0; i < m; i++)
    if (no_break || abundances[gb[i]] >= abundances[ga[i]])
      cnt[gb[i] + 1]++;
  for (int64_t v = 0; v < n; v++)
    cnt[v + 1] += cnt[v];
  for (int64_t i = 0; i < m; i++) {
    if (!(no_break || abundances[gb[i]] >= abundances[ga[i]]))
      continue;
    int64_t pos = cnt[gb[i]]++;
    e2f[pos] = gb[i];
    e2t[pos] = ga[i];
    m2++;
  }
  /* merge the two sorted streams by (from, to) */
  int64_t i1 = 0, i2 = 0, w = 0;
  while (1) {
    /* advance stream 1 past filtered entries */
    while (i1 < m && !(no_break || abundances[ga[i1]] >= abundances[gb[i1]]))
      i1++;
    if (i1 >= m && i2 >= m2)
      break;
    int take1;
    if (i1 >= m)
      take1 = 0;
    else if (i2 >= m2)
      take1 = 1;
    else
      take1 = ga[i1] < e2f[i2] ||
              (ga[i1] == e2f[i2] && gb[i1] <= e2t[i2]);
    if (take1) {
      ef_out[w] = ga[i1];
      et_out[w] = gb[i1];
      i1++;
    } else {
      ef_out[w] = e2f[i2];
      et_out[w] = e2t[i2];
      i2++;
    }
    w++;
  }
  free(cnt);
  free(e2f);
  free(e2t);
  return w;
}
