// Native FASTQ/FASTA streaming reader + 2-bit base-code packer.
//
// Fills fixed-shape [batch, max_len] uint8 code matrices (A=0 C=1 G=2 T/U=3,
// other=4) directly from gzip or plain files, splitting long reads into
// overlapping segments (overlap k-1) exactly like the Python fallback in
// io/fastq.py.  This is the host feed for the device sketch kernel; the
// reference's equivalent is the kseq-based streaming in
// src/fastq_kmer.cpp:65-187.
//
// Fast paths (the host feed bounds end-to-end counting on small hosts):
//   * whole-file gzip decompression via libdeflate when available and the
//     compressed file is small enough (VGF_WHOLE_MAX env, default 1 GiB) --
//     ~2-3x faster inflate than zlib streaming, then parsing runs over a
//     plain memory buffer;
//   * otherwise chunked gzread with memchr line scanning (no per-line gzgets
//     calls); header/'+'/quality lines are skipped without copying.
//
// Build: g++ -O3 -shared -fPIC -o libvgfastq.so fastq_reader.cpp -lz
//        [-DVGF_USE_LIBDEFLATE -ldeflate]
//
// C API (ctypes):
//   void* vgf_open(const char* path);
//   long  vgf_next_batch(void* h, unsigned char* out, long batch,
//                        long max_len, long k, long* bases_out);
//         -> rows filled (0 at EOF; out is pre-filled with 4 by caller)
//   void  vgf_close(void* h);

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifdef VGF_USE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

unsigned char code_table[256];

struct TableInit {
    TableInit() {
        memset(code_table, 4, sizeof(code_table));
        code_table['A'] = code_table['a'] = 0;
        code_table['C'] = code_table['c'] = 1;
        code_table['G'] = code_table['g'] = 2;
        code_table['T'] = code_table['t'] = 3;
        code_table['U'] = code_table['u'] = 3;
    }
} table_init;

constexpr size_t kChunk = 4u << 20;  // gzread chunk

struct Reader {
    gzFile fp = nullptr;
    bool is_fasta = false;

    // decompressed data window: either a rolling gzread chunk or the whole
    // file (libdeflate / plain small file)
    std::vector<char> buf;
    size_t pos = 0;   // parse cursor within buf[0..len)
    size_t len = 0;
    bool whole = false;  // buf holds the entire file; no refills

    std::string seq;      // current read being split into segments
    size_t seg_start = 0;
    size_t run_end = 0;   // end of the current ACGT run (packed API only)
    bool have_seq = false;

    bool fill() {
        if (whole) return false;
        // move leftover to front
        if (pos < len) {
            memmove(buf.data(), buf.data() + pos, len - pos);
        }
        len -= pos;
        pos = 0;
        if (buf.size() < len + kChunk) buf.resize(len + kChunk);
        int got = gzread(fp, buf.data() + len, (unsigned)kChunk);
        if (got <= 0) return false;
        len += (size_t)got;
        return true;
    }

    // next line [start, end) within buf; returns false at EOF.  The span is
    // only valid until the next fill(), so callers copy what they keep.
    bool next_line(size_t& s, size_t& e) {
        for (;;) {
            char* nl = (char*)memchr(buf.data() + pos, '\n', len - pos);
            if (nl) {
                s = pos;
                e = (size_t)(nl - buf.data());
                pos = e + 1;
                return true;
            }
            size_t tail = len - pos;
            if (!fill()) {
                if (tail == 0 && len == pos) return false;
                s = pos;
                e = len;
                pos = len;
                return s < e;
            }
        }
    }

    bool skip_line() {
        size_t s, e;
        return next_line(s, e);
    }

    // fetch the next whole read sequence into `seq`; false at EOF
    bool next_record() {
        size_t s, e;
        if (!is_fasta) {
            // FASTQ: @header / seq / + / quals
            if (!skip_line()) return false;            // header
            if (!next_line(s, e)) return false;        // sequence
            seq.assign(buf.data() + s, e - s);
            skip_line();                               // '+'
            skip_line();                               // quals
            return true;
        }
        // FASTA: accumulate until next '>'
        seq.clear();
        for (;;) {
            if (!next_line(s, e)) return !seq.empty();
            if (e > s && buf[s] == '>') {
                if (!seq.empty()) return true;
                continue;  // leading header
            }
            seq.append(buf.data() + s, e - s);
        }
    }
};

bool load_whole_gzip(Reader* r, const char* path) {
#ifdef VGF_USE_LIBDEFLATE
    size_t max_comp = 1u << 30;
    if (const char* env = getenv("VGF_WHOLE_MAX")) {
        max_comp = (size_t)strtoull(env, nullptr, 10);
    }
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long fsize = ftell(f);
    if (fsize <= 18 || (size_t)fsize > max_comp) { fclose(f); return false; }
    std::vector<char> comp((size_t)fsize);
    fseek(f, 0, SEEK_SET);
    if (fread(comp.data(), 1, comp.size(), f) != comp.size()) {
        fclose(f);
        return false;
    }
    fclose(f);
    if ((unsigned char)comp[0] != 0x1f || (unsigned char)comp[1] != 0x8b) {
        return false;  // plain file: let the gzread path handle it
    }

    libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    if (!d) return false;
    // gzip members decompress in sequence (ISIZE footer seeds the estimate;
    // grow-and-retry covers multi-member files and >4 GiB streams)
    size_t in_off = 0;
    size_t out_len = 0;
    uint32_t isize;
    memcpy(&isize, comp.data() + comp.size() - 4, 4);
    size_t cap = (size_t)isize + (4u << 20);
    r->buf.resize(cap);
    while (in_off < comp.size()) {
        for (;;) {
            size_t actual_in = 0, actual_out = 0;
            libdeflate_result res = libdeflate_gzip_decompress_ex(
                d, comp.data() + in_off, comp.size() - in_off,
                r->buf.data() + out_len, r->buf.size() - out_len,
                &actual_in, &actual_out);
            if (res == LIBDEFLATE_SUCCESS) {
                in_off += actual_in;
                out_len += actual_out;
                break;
            }
            if (res == LIBDEFLATE_INSUFFICIENT_SPACE) {
                r->buf.resize(r->buf.size() * 2 + (16u << 20));
                continue;
            }
            libdeflate_free_decompressor(d);
            return false;  // corrupt: fall back to zlib streaming
        }
        // tolerate trailing garbage/padding that is not another member
        if (comp.size() - in_off < 18 ||
            (unsigned char)comp[in_off] != 0x1f) {
            break;
        }
    }
    libdeflate_free_decompressor(d);
    r->len = out_len;
    r->pos = 0;
    r->whole = true;
    return true;
#else
    (void)r;
    (void)path;
    return false;
#endif
}

}  // namespace

extern "C" {

// which inflater this build links: "libdeflate" or "zlib"
const char* vgf_inflate_backend() {
#ifdef VGF_USE_LIBDEFLATE
    return "libdeflate";
#else
    return "zlib";
#endif
}

void* vgf_open(const char* path) {
    Reader* r = new Reader();
    if (load_whole_gzip(r, path)) {
        // parsed from memory; no gzFile needed
    } else {
        r->whole = false;
        r->fp = gzopen(path, "rb");
        if (!r->fp) {
            delete r;
            return nullptr;
        }
        gzbuffer(r->fp, 1u << 20);
        if (!r->fill()) { /* empty file: next_line handles EOF */ }
    }
    r->is_fasta = (r->len > r->pos && r->buf[r->pos] == '>');
    if (r->is_fasta) r->skip_line();  // consume the first header line
    return r;
}

long vgf_next_batch(void* handle, unsigned char* out, long batch,
                    long max_len, long k, long* bases_out) {
    Reader* r = static_cast<Reader*>(handle);
    long row = 0;
    long bases = 0;
    const long step = max_len - (k - 1);
    while (row < batch) {
        if (!r->have_seq) {
            if (!r->next_record()) break;
            r->seg_start = 0;
            r->have_seq = true;
            bases += (long)r->seq.size();
        }
        const std::string& s = r->seq;
        long n = (long)s.size();
        long start = (long)r->seg_start;
        long len = n - start;
        if (len > max_len) len = max_len;
        unsigned char* dst = out + row * max_len;
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(s.data()) + start;
        for (long i = 0; i < len; ++i) dst[i] = code_table[src[i]];
        ++row;
        if (start + max_len >= n) {
            r->have_seq = false;
        } else {
            r->seg_start = start + step;
        }
    }
    *bases_out = bases;
    return row;
}

// Packed variant: each row is max_len/4 bytes of 2-bit base codes followed
// by a u16-LE valid-length (the wire format of ops/kmer.unpack_2bit).  Reads
// are split BOTH at non-ACGT bases (hard split: the sketch's N-reset means
// no k-mer spans an N, so segments carry exactly the same k-mer set) and at
// max_len (overlapping split, overlap k-1, as vgf_next_batch).  Segments
// shorter than k emit no k-mers and are dropped.  2-bit packing moves 4x
// fewer host-to-device bytes than one code per byte.
//
//   long vgf_next_batch_packed(void* h, unsigned char* out /*[batch, max_len/4+2]*/,
//                              long batch, long max_len, long k, long* bases_out);
//   -> rows filled (0 at EOF; caller pre-fills out with 0)
long vgf_next_batch_packed(void* handle, unsigned char* out, long batch,
                           long max_len, long k, long* bases_out) {
    Reader* r = static_cast<Reader*>(handle);
    const long row_bytes = max_len / 4 + 2;
    const long step = max_len - (k - 1);
    long row = 0;
    long bases = 0;
    while (row < batch) {
        if (!r->have_seq) {
            if (!r->next_record()) break;
            r->seg_start = 0;   // scan cursor within the read
            r->run_end = 0;     // no current ACGT run
            r->have_seq = true;
            bases += (long)r->seq.size();
        }
        const unsigned char* s =
            reinterpret_cast<const unsigned char*>(r->seq.data());
        const long n = (long)r->seq.size();
        long seg = (long)r->seg_start;
        long run_end = (long)r->run_end;
        if (run_end <= seg) {
            // find the next ACGT run [seg, run_end)
            while (seg < n && code_table[s[seg]] >= 4) ++seg;
            if (seg >= n) { r->have_seq = false; continue; }
            run_end = seg;
            while (run_end < n && code_table[s[run_end]] < 4) ++run_end;
            if (run_end - seg < k) {  // too short to emit: skip the run
                r->seg_start = (size_t)run_end;
                r->run_end = (size_t)run_end;
                continue;
            }
            r->run_end = (size_t)run_end;
        }
        long len = run_end - seg;
        if (len > max_len) len = max_len;
        unsigned char* dst = out + row * row_bytes;
        long i = 0;
        for (; i + 4 <= len; i += 4) {
            dst[i / 4] = (unsigned char)(code_table[s[seg + i]]
                       | (code_table[s[seg + i + 1]] << 2)
                       | (code_table[s[seg + i + 2]] << 4)
                       | (code_table[s[seg + i + 3]] << 6));
        }
        if (i < len) {
            unsigned char b = 0;
            for (long j = 0; i + j < len; ++j) {
                b |= (unsigned char)(code_table[s[seg + i + j]] << (2 * j));
            }
            dst[i / 4] = b;
        }
        dst[max_len / 4] = (unsigned char)(len & 0xFF);
        dst[max_len / 4 + 1] = (unsigned char)((len >> 8) & 0xFF);
        ++row;
        if (seg + max_len >= run_end) {
            r->seg_start = (size_t)run_end;  // run done; scan onward
        } else {
            r->seg_start = (size_t)(seg + step);
        }
        if ((long)r->seg_start >= n) r->have_seq = false;
    }
    *bases_out = bases;
    return row;
}

void vgf_close(void* handle) {
    Reader* r = static_cast<Reader*>(handle);
    if (r->fp) gzclose(r->fp);
    delete r;
}

}  // extern "C"
