// fastx.cpp — the port's host-side FASTA/FASTQ parser, batch packer and
// encoder (the port's own copy of the JAX package's native/fastx.cpp; same
// C API, same output bytes). Built with g++ at first use by io/native.py.
//
// Parser: mmap the file (or inflate a .gz with zlib), find record boundaries,
// and emit encoded sequence bytes (A=0 C=1 G=2 T=3, other=4, case-folded)
// plus per-record offsets and names, with the per-base work done in C++ on
// all cores so Python never touches per-base data.
//
// Design: two passes.
//   pass 1: locate records sequentially (a memchr line walk; FASTQ records
//     are 4-line records whose quality line has the sequence's length, so an
//     '@' inside qualities is never taken for a record start);
//   pass 2 (parallel): each thread encodes its records' sequence bytes into
//     the output buffer at precomputed offsets (multi-line FASTA concatenated,
//     CR dropped).
//
// Exposed C API (ctypes): fx_parse / fx_free, mq_pack2_batch,
// mq_pack2_batch_mixed, mq_encode.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>
#include <zlib.h>

namespace {

struct Buf {
    const uint8_t* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool owned = false;  // heap (gz-inflated) vs mmap
};

bool load_file(const char* path, Buf& b) {
    size_t n = std::strlen(path);
    bool gz = n > 3 && std::strcmp(path + n - 3, ".gz") == 0;
    if (gz) {
        gzFile f = gzopen(path, "rb");
        if (!f) return false;
        size_t cap = 64 << 20, len = 0;
        uint8_t* out = (uint8_t*)std::malloc(cap);
        for (;;) {
            if (len + (16 << 20) > cap) {
                cap *= 2;
                out = (uint8_t*)std::realloc(out, cap);
            }
            int got = gzread(f, out + len, 16 << 20);
            if (got < 0) { gzclose(f); std::free(out); return false; }
            len += (size_t)got;
            if (got == 0) break;
        }
        gzclose(f);
        b.data = out; b.size = len; b.owned = true;
        return true;
    }
    int fd = open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return false; }
    void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) { close(fd); return false; }
    madvise(p, (size_t)st.st_size, MADV_SEQUENTIAL);
    b.data = (const uint8_t*)p; b.size = (size_t)st.st_size; b.fd = fd;
    return true;
}

void unload(Buf& b) {
    if (b.owned) std::free((void*)b.data);
    else if (b.data) munmap((void*)b.data, b.size);
    if (b.fd >= 0) close(b.fd);
}

uint8_t g_code[256];
struct CodeInit {
    CodeInit() {
        std::memset(g_code, 4, sizeof(g_code));
        g_code['A'] = g_code['a'] = 0;
        g_code['C'] = g_code['c'] = 1;
        g_code['G'] = g_code['g'] = 2;
        g_code['T'] = g_code['t'] = 3;
    }
} g_code_init;

struct Rec {
    size_t name_beg, name_end;  // byte range of the record id (first word)
    size_t seq_beg, seq_end;    // byte range covering the sequence lines
};

#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

// ASCII bases -> codes (A/a=0 C/c=1 G/g=2 T/t=3 other=4), vectorized where
// available; every bulk encode (genome contigs, parser pass 2) goes through
// here, at memory speed where a numpy table lookup is an order slower.
void encode_span(const uint8_t* src, size_t n, uint8_t* dst) {
    size_t i = 0;
#if defined(__AVX512BW__)
    const __m512i vcase = _mm512_set1_epi8(0x20);
    const __m512i v1 = _mm512_set1_epi8(1), v2 = _mm512_set1_epi8(2),
                  v3 = _mm512_set1_epi8(3), v4 = _mm512_set1_epi8(4);
    for (; i + 64 <= n; i += 64) {
        __m512i v = _mm512_loadu_si512((const void*)(src + i));
        __m512i f = _mm512_or_si512(v, vcase);
        __mmask64 mA = _mm512_cmpeq_epi8_mask(f, _mm512_set1_epi8('a'));
        __mmask64 mC = _mm512_cmpeq_epi8_mask(f, _mm512_set1_epi8('c'));
        __mmask64 mG = _mm512_cmpeq_epi8_mask(f, _mm512_set1_epi8('g'));
        __mmask64 mT = _mm512_cmpeq_epi8_mask(f, _mm512_set1_epi8('t'));
        __m512i code = _mm512_mask_mov_epi8(v4, mA, _mm512_setzero_si512());
        code = _mm512_mask_mov_epi8(code, mC, v1);
        code = _mm512_mask_mov_epi8(code, mG, v2);
        code = _mm512_mask_mov_epi8(code, mT, v3);
        _mm512_storeu_si512((void*)(dst + i), code);
    }
#endif
    for (; i < n; i++) dst[i] = g_code[src[i]];
}

// Locate records sequentially (cheap memchr line walk), then encode in parallel.
struct Parsed {
    std::vector<Rec> recs;
    bool fastq = false;
};

void locate(const Buf& b, Parsed& out) {
    const uint8_t* d = b.data;
    size_t n = b.size;
    size_t i = 0;
    while (i < n && (d[i] == '\n' || d[i] == '\r')) i++;
    if (i >= n) return;
    out.fastq = d[i] == '@';
    while (i < n) {
        if (d[i] != '>' && d[i] != '@') break;  // malformed; stop
        Rec r;
        size_t j = i + 1;
        while (j < n && d[j] != '\n' && d[j] != ' ' && d[j] != '\t' && d[j] != '\r') j++;
        r.name_beg = i + 1;
        r.name_end = j;
        const uint8_t* nl = (const uint8_t*)memchr(d + j, '\n', n - j);
        size_t line_end = nl ? (size_t)(nl - d) : n;
        size_t s = line_end + 1;
        if (out.fastq) {
            const uint8_t* e = (const uint8_t*)memchr(d + s, '\n', s < n ? n - s : 0);
            size_t seq_end = e ? (size_t)(e - d) : n;
            r.seq_beg = s;
            r.seq_end = seq_end;
            // skip '+' line and quality line
            size_t p = seq_end + 1;
            const uint8_t* pl = p < n ? (const uint8_t*)memchr(d + p, '\n', n - p) : nullptr;
            size_t q = pl ? (size_t)(pl - d) + 1 : n;
            size_t qlen = seq_end - s;  // quality length == seq length
            i = q + qlen;
            while (i < n && (d[i] == '\n' || d[i] == '\r')) i++;
        } else {
            size_t e = s;
            while (e < n) {
                if (d[e] == '>') break;
                const uint8_t* enl = (const uint8_t*)memchr(d + e, '\n', n - e);
                e = enl ? (size_t)(enl - d) + 1 : n;
            }
            r.seq_beg = s;
            r.seq_end = e;
            i = e;
        }
        if (r.seq_beg > n) r.seq_beg = n;
        if (r.seq_end > n) r.seq_end = n;
        out.recs.push_back(r);
    }
}

}  // namespace

extern "C" {

struct FxResult {
    uint8_t* codes;      // encoded sequence bytes, concatenated
    int64_t* rec_off;    // [n+1] offsets into codes
    char* names;         // record ids, '\0'-separated, concatenated
    int64_t* name_off;   // [n+1] offsets into names
    int64_t n_records;
    int64_t total_len;
};

int fx_parse(const char* path, int n_threads, FxResult* out) {
    Buf b;
    if (!load_file(path, b)) return -1;
    Parsed ps;
    locate(b, ps);
    size_t n = ps.recs.size();
    out->n_records = (int64_t)n;
    out->rec_off = (int64_t*)std::malloc((n + 1) * sizeof(int64_t));
    out->name_off = (int64_t*)std::malloc((n + 1) * sizeof(int64_t));

    // compute per-record encoded lengths (exclude newlines for FASTA)
    std::vector<size_t> seqlen(n), namelen(n);
    {
        std::vector<std::thread> th;
        std::atomic<size_t> next{0};
        int T = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
        auto work = [&]() {
            size_t i;
            while ((i = next.fetch_add(64)) < n) {
                size_t hi = i + 64 < n ? i + 64 : n;
                for (size_t r = i; r < hi; r++) {
                    const Rec& rec = ps.recs[r];
                    size_t cnt = 0;
                    for (size_t p = rec.seq_beg; p < rec.seq_end; p++) {
                        uint8_t c = b.data[p];
                        cnt += (c != '\n' && c != '\r');
                    }
                    seqlen[r] = cnt;
                    namelen[r] = rec.name_end - rec.name_beg;
                }
            }
        };
        for (int t = 0; t < T; t++) th.emplace_back(work);
        for (auto& t : th) t.join();
    }
    size_t total = 0, ntotal = 0;
    for (size_t r = 0; r < n; r++) {
        out->rec_off[r] = (int64_t)total;
        out->name_off[r] = (int64_t)ntotal;
        total += seqlen[r];
        ntotal += namelen[r] + 1;
    }
    out->rec_off[n] = (int64_t)total;
    out->name_off[n] = (int64_t)ntotal;
    out->total_len = (int64_t)total;
    out->codes = (uint8_t*)std::malloc(total ? total : 1);
    out->names = (char*)std::malloc(ntotal ? ntotal : 1);

    {
        std::vector<std::thread> th;
        std::atomic<size_t> next{0};
        int T = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
        auto work = [&]() {
            size_t i;
            while ((i = next.fetch_add(64)) < n) {
                size_t hi = i + 64 < n ? i + 64 : n;
                for (size_t r = i; r < hi; r++) {
                    const Rec& rec = ps.recs[r];
                    uint8_t* dst = out->codes + out->rec_off[r];
                    // encode line spans vectorized (newlines located by
                    // memchr, not per-byte branches)
                    size_t p = rec.seq_beg;
                    while (p < rec.seq_end) {
                        const uint8_t* nl = (const uint8_t*)memchr(
                            b.data + p, '\n', rec.seq_end - p);
                        size_t e = nl ? (size_t)(nl - b.data) : rec.seq_end;
                        size_t span = e - p;
                        if (memchr(b.data + p, '\r', span) == nullptr) {
                            encode_span(b.data + p, span, dst);
                            dst += span;
                        } else {  // CR anywhere: per-byte (matches pass 1)
                            for (size_t q = p; q < e; q++)
                                if (b.data[q] != '\r') *dst++ = g_code[b.data[q]];
                        }
                        p = e + 1;
                    }
                    char* nd = out->names + out->name_off[r];
                    std::memcpy(nd, b.data + rec.name_beg, namelen[r]);
                    nd[namelen[r]] = '\0';
                }
            }
        };
        for (int t = 0; t < T; t++) th.emplace_back(work);
        for (auto& t : th) t.join();
    }
    unload(b);
    return 0;
}

// mq_pack2_batch — fused batch assembly + 2-bit packing for the upload.
//
// One pass per read batch in place of "copy each row into a padded [B, L]
// buffer, then pack it": read each record's codes (0..4) straight from the
// parser's buffer, emit 2-bit bases into p2 [B, L/4] and the non-ACGT bitmask
// into mask [B, L/8] (numpy packbits order, big-endian within a byte). The
// mask marks ONLY in-read non-ACGT bases; row padding past lens[b] is rebuilt
// on the device from the lengths (ops/seeding.unpack2), so for N-free batches,
// the common case, the mask is all zero and its upload (1/3 of the batch's
// bytes) is skipped.
//
// rows: array of B host addresses (uint64) of contiguous uint8 code buffers;
// address 0 = empty row. lens: [B] int32, lens[b] <= L, L % 8 == 0.
// Returns -1 on error, else 1 if any mask bit is set (batch contains an
// ambiguous base), 0 otherwise.
#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

// bit-reversal within a byte: the mask format puts input byte i+k at bit
// (7-k) of mask byte (i>>3) (numpy packbits big-endian), but vector
// movemask puts byte k at bit k
static const struct Bitrev8 {
    uint8_t t[256];
    Bitrev8() {
        for (int i = 0; i < 256; i++) {
            uint8_t r = 0;
            for (int b = 0; b < 8; b++) r |= (uint8_t)(((i >> b) & 1) << (7 - b));
            t[i] = r;
        }
    }
} g_bitrev;

static uint8_t pack2_row(const uint8_t* row, int32_t len, int32_t L,
                         uint8_t* pp, uint8_t* mm, bool raw) {
    // raw=true: row holds ASCII bases, table-encoded inline (bit-identical
    // to encoding first, then packing), so no read is encoded on its own
    // before it is packed; raw=false: row holds codes 0..4.
    uint8_t any_n = 0;
    int32_t i = 0;
#if defined(__AVX512BW__)
    // vector path: 64 bases per iteration — classify (case-folded compares
    // for raw, c&3 / c>=4 for codes), 2-bit pack via maddubs(1,4) +
    // madd(1,16) + epi32->epi8 narrowing, invalid bitmask via movepi8_mask
    // with per-byte bit reversal; the scalar code below is the tail and the
    // path of CPUs without AVX-512BW.
    uint64_t anyinv = 0;
    const __m512i vcase = _mm512_set1_epi8(0x20);
    const __m512i v1 = _mm512_set1_epi8(1), v2 = _mm512_set1_epi8(2),
                  v3 = _mm512_set1_epi8(3);
    const __m512i mul14 = _mm512_set1_epi16(0x0401);   // bytes {1,4} LSB-first
    const __m512i mul116 = _mm512_set1_epi32(0x00100001);  // u16s {1,16}
    int32_t len64 = len & ~63;
    for (; i < len64; i += 64) {
        __m512i v = _mm512_loadu_si512((const void*)(row + i));
        __m512i code;
        uint64_t inv;
        if (raw) {
            __m512i f = _mm512_or_si512(v, vcase);
            __mmask64 mA = _mm512_cmpeq_epi8_mask(f, _mm512_set1_epi8('a'));
            __mmask64 mC = _mm512_cmpeq_epi8_mask(f, _mm512_set1_epi8('c'));
            __mmask64 mG = _mm512_cmpeq_epi8_mask(f, _mm512_set1_epi8('g'));
            __mmask64 mT = _mm512_cmpeq_epi8_mask(f, _mm512_set1_epi8('t'));
            code = _mm512_maskz_mov_epi8(mC, v1);
            code = _mm512_mask_mov_epi8(code, mG, v2);
            code = _mm512_mask_mov_epi8(code, mT, v3);
            inv = ~(uint64_t)(mA | mC | mG | mT);
        } else {
            code = _mm512_and_si512(v, v3);  // c&3 (code 4 packs as 0)
            inv = (uint64_t)_mm512_cmpge_epu8_mask(v, _mm512_set1_epi8(4));
        }
        __m512i p16 = _mm512_maddubs_epi16(code, mul14);   // c0 + 4*c1
        __m512i p32 = _mm512_madd_epi16(p16, mul116);      // + 16*c2 + 64*c3
        __m128i packed = _mm512_cvtepi32_epi8(p32);        // 16 output bytes
        _mm_storeu_si128((__m128i*)(pp + (i >> 2)), packed);
        anyinv |= inv;
        uint8_t* mo = mm + (i >> 3);
        for (int j = 0; j < 8; j++)
            mo[j] = g_bitrev.t[(inv >> (8 * j)) & 0xFF];
    }
    any_n |= (uint8_t)(anyinv != 0);
#endif
    int32_t len8 = len & ~7;
    for (; i < len8; i += 8) {
        const uint8_t* s = row + i;
        uint8_t c[8];
        if (raw)
            for (int k = 0; k < 8; k++) c[k] = g_code[s[k]];
        else
            std::memcpy(c, s, 8);
        pp[i >> 2] = (uint8_t)((c[0] & 3) | ((c[1] & 3) << 2) |
                               ((c[2] & 3) << 4) | ((c[3] & 3) << 6));
        pp[(i >> 2) + 1] = (uint8_t)((c[4] & 3) | ((c[5] & 3) << 2) |
                                     ((c[6] & 3) << 4) | ((c[7] & 3) << 6));
        uint8_t m = 0;
        for (int k = 0; k < 8; k++) m |= (uint8_t)((c[k] >= 4) << (7 - k));
        mm[i >> 3] = m;
        any_n |= m;
    }
    if (i < L) {
        // partial group: remaining bases, then zero bits for padding
        uint8_t pb0 = 0, pb1 = 0, m = 0;
        for (int k = 0; k < 8 && i + k < len; k++) {
            uint8_t c = raw ? g_code[row[i + k]] : row[i + k];
            if (k < 4) pb0 |= (uint8_t)((c & 3) << (2 * k));
            else pb1 |= (uint8_t)((c & 3) << (2 * (k - 4)));
            m |= (uint8_t)((c >= 4) << (7 - k));
        }
        pp[i >> 2] = pb0;
        pp[(i >> 2) + 1] = pb1;
        mm[i >> 3] = m;
        any_n |= m;
        i += 8;
        // rest of the row: p2 bits 0, mask bits 0 (padding comes from lens)
        std::memset(pp + (i >> 2), 0, (size_t)((L / 4) - (i >> 2)));
        std::memset(mm + (i >> 3), 0, (size_t)((L / 8) - (i >> 3)));
    }
    return any_n;
}

int mq_pack2_batch(const uint64_t* rows, const int32_t* lens, int32_t B,
                   int32_t L, uint8_t* p2, uint8_t* mask) {
    if (L % 8) return -1;
    int64_t p2w = L / 4, mw = L / 8;
    uint8_t any_n = 0;
    for (int32_t b = 0; b < B; b++) {
        const uint8_t* row = (const uint8_t*)(uintptr_t)rows[b];
        int32_t len = row ? lens[b] : 0;
        if (len > L) len = L;
        any_n |= pack2_row(row, len, L, p2 + (int64_t)b * p2w,
                           mask + (int64_t)b * mw, false);
    }
    return any_n ? 1 : 0;
}

// mq_pack2_batch_mixed — as mq_pack2_batch, but rows[b] with flags[b]=1 hold
// RAW ASCII base bytes, table-encoded inline (A/a=0 C/c=1 G/g=2 T/t=3
// other=4, the parser's encoding), so the streaming Mapper packs read bytes
// straight from the input.
int mq_pack2_batch_mixed(const uint64_t* rows, const int32_t* lens,
                         const uint8_t* flags, int32_t B, int32_t L,
                         uint8_t* p2, uint8_t* mask) {
    if (L % 8) return -1;
    int64_t p2w = L / 4, mw = L / 8;
    uint8_t any_n = 0;
    for (int32_t b = 0; b < B; b++) {
        const uint8_t* row = (const uint8_t*)(uintptr_t)rows[b];
        int32_t len = row ? lens[b] : 0;
        if (len > L) len = L;
        any_n |= pack2_row(row, len, L, p2 + (int64_t)b * p2w,
                           mask + (int64_t)b * mw, flags[b] != 0);
    }
    return any_n ? 1 : 0;
}

// mq_encode — bulk ASCII bases -> codes (genome contigs).
void mq_encode(const uint8_t* src, int64_t n, uint8_t* dst) {
    encode_span(src, (size_t)n, dst);
}

void fx_free(FxResult* r) {
    std::free(r->codes);
    std::free(r->rec_off);
    std::free(r->names);
    std::free(r->name_off);
    r->codes = nullptr;
}

}  // extern "C"
