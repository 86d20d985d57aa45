// fastseq: native FASTA scanning/encoding for the streaming query path.
//
// The TPU-native analog of the reference's genesis FastaInputIterator +
// 4-bit encoder (reference: src/seq/MSA_Stream.cpp, src/io/encoding.hpp):
// the host-side bottleneck at 100k+ query scale is turning FASTA text into
// padded code matrices; this does one mmap pass with table-driven encoding
// straight into the caller's numpy buffers. Loaded via ctypes
// (epa_ng_tpu_torch/io/native.py) with a pure-python fallback.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Reader {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
};

// advance past one fasta record starting at p ('>' expected); returns
// pointers/lengths for label and the sequence spans (line by line)
inline const char* find_nl(const char* p, const char* end) {
  const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
  return nl ? nl : end;
}

// True when any of n bytes is whitespace or a control byte (<= ' ').
inline bool has_space(const uint8_t* s, int64_t n) {
  uint8_t any = 0;
  for (int64_t i = 0; i < n; ++i) any |= (s[i] <= ' ');
  return any != 0;
}

// FNV-style 64-bit hash of a row of codes read as little-endian 8-byte
// words, the last one zero-padded: core/chunk.py::code_hashes is the same
// hash in numpy.
inline uint64_t row_hash(const uint8_t* row, int64_t n) {
  const uint64_t prime = 0x100000001B3ull;
  uint64_t h = 0xCBF29CE484222325ull;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    memcpy(&w, row + i, 8);
    h = (h * prime) ^ w;
  }
  if (i < n) {
    uint64_t w = 0;
    memcpy(&w, row + i, n - i);
    h = (h * prime) ^ w;
  }
  return h;
}

}  // namespace

extern "C" {

void* fs_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* r = new Reader();
  r->fd = fd;
  r->data = static_cast<const char*>(mem);
  r->size = static_cast<size_t>(st.st_size);
  r->pos = 0;
  return r;
}

void fs_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return;
  if (r->data) munmap(const_cast<char*>(r->data), r->size);
  if (r->fd >= 0) close(r->fd);
  delete r;
}

// One info prepass: counts sequences, checks equal widths, AND-accumulates
// the all-gap column mask. Gap chars follow genesis'
// nucleic_acid_codes_undetermined() set "NOX.-?", matched case-
// insensitively (the rule the reference's MSA_Info prepass applies,
// src/seq/MSA_Info.hpp:53).
// Returns 0 on success; -1 io error; -2 width mismatch; -3 not fasta.
// gap_mask (caller-allocated, >= n_sites bytes) may be null.
long fs_info(const char* path, int64_t* n_seqs, int64_t* n_sites,
             uint8_t* gap_mask, int64_t mask_cap) {
  auto* r = static_cast<Reader*>(fs_open(path));
  if (!r) return -1;
  const char* p = r->data;
  const char* end = r->data + r->size;
  int64_t count = 0;
  int64_t sites = 0;
  bool mask_init = false;

  while (p < end && (*p == '\n' || *p == '\r')) p++;
  if (p < end && *p != '>') {
    fs_close(r);
    return -3;
  }
  while (p < end) {
    if (*p != '>') break;
    p = find_nl(p, end);  // skip label line
    if (p < end) p++;
    int64_t slen = 0;
    while (p < end && *p != '>') {
      const char* nl = find_nl(p, end);
      for (const char* q = p; q < nl; ++q) {
        char c = *q;
        if (c == '\r' || c == ' ' || c == '\t') continue;
        bool gap = (c == '-' || c == '?' || c == '.' ||
                    c == 'N' || c == 'n' || c == 'O' || c == 'o' ||
                    c == 'X' || c == 'x');
        if (gap_mask && slen < mask_cap) {
          if (!mask_init) {
            gap_mask[slen] = gap ? 1 : 0;
          } else if (!gap) {
            gap_mask[slen] = 0;
          }
        }
        slen++;
      }
      p = nl < end ? nl + 1 : end;
    }
    mask_init = true;
    if (sites == 0) {
      sites = slen;
    } else if (slen != sites) {
      fs_close(r);
      return -2;
    }
    count++;
  }
  *n_seqs = count;
  *n_sites = sites;
  fs_close(r);
  return 0;
}

// Skip n records from the current position.
long fs_skip(void* handle, int64_t n) {
  auto* r = static_cast<Reader*>(handle);
  const char* p = r->data + r->pos;
  const char* end = r->data + r->size;
  while (p < end && (*p == '\n' || *p == '\r')) p++;
  int64_t skipped = 0;
  while (p < end && skipped < n) {
    if (*p != '>') break;
    p = find_nl(p, end);
    if (p < end) p++;
    while (p < end && *p != '>') {
      p = find_nl(p, end);
      if (p < end) p++;
    }
    skipped++;
  }
  r->pos = p - r->data;
  return skipped;
}

// Read up to max_seqs records into a finished chunk, in one pass.
//
// code_map (256 entries) takes a byte to its code; 0xFF marks an invalid
// byte. Columns with mask[i] != 0 are dropped (premasking); cols lists the
// kept input columns in order (out_sites of them). For each record it
// writes a row of out_sites codes into codes_out, the row's valid range
// (begin, span) over its kept columns into ranges_out, trimming the
// literal '-' alone (the rule of core/chunk.py::ranges_from_rows, on the
// byte, not the code: '?' and '-' share a code but not a range), and the
// FNV-style hash of the row's codes into hash_out (row_hash above). Labels
// go NUL-terminated back-to-back into labels_out.
//
// A record that is one line of exactly in_sites bytes, none of them
// whitespace or a control byte, takes a gather over cols; every other
// record (multi-line, CRLF, blanks, spaces or tabs) takes the byte loop.
// Both give the same bytes and the same errors on the same record.
//
// meta (5 entries) receives: [0] label bytes used, [1] records gathered,
// [2] records through the byte loop, and after -4 the first invalid byte's
// [3] record (within this call) and [4] value.
// Returns the number of records read, or -2 width mismatch, -4 invalid
// byte, -5 labels_out too small.
long fs_read_encoded(void* handle, int64_t max_seqs, int64_t in_sites,
                     int64_t out_sites, const uint8_t* code_map,
                     const uint8_t* mask, const int32_t* cols,
                     uint8_t* codes_out, int32_t* ranges_out,
                     uint64_t* hash_out, char* labels_out,
                     int64_t labels_cap, int64_t* meta) {
  auto* r = static_cast<Reader*>(handle);
  const char* p = r->data + r->pos;
  const char* end = r->data + r->size;
  int64_t nread = 0;
  int64_t label_off = 0;
  int64_t n_gather = 0;
  int64_t n_loop = 0;
  long rc = 0;

  while (p < end && (*p == '\n' || *p == '\r')) p++;
  while (p < end && nread < max_seqs) {
    if (*p != '>') break;
    const char* lstart = p + 1;
    const char* nl = find_nl(p, end);
    const char* lend = nl;
    while (lend > lstart && (lend[-1] == '\r')) lend--;
    int64_t llen = lend - lstart;
    if (label_off + llen + 1 > labels_cap) {
      rc = -5;
      break;
    }
    memcpy(labels_out + label_off, lstart, llen);
    labels_out[label_off + llen] = '\0';
    label_off += llen + 1;

    p = nl < end ? nl + 1 : end;
    uint8_t* row = codes_out + nread * out_sites;
    int64_t first = -1;
    int64_t last = -1;
    nl = find_nl(p, end);
    const char* next = nl < end ? nl + 1 : end;
    if (nl - p == in_sites && (next == end || *next == '>') &&
        !has_space(reinterpret_cast<const uint8_t*>(p), in_sites)) {
      // one clean line of the full width: visit the kept columns only
      const auto* line = reinterpret_cast<const uint8_t*>(p);
      uint8_t bad = 0;
      for (int64_t j = 0; j < out_sites; ++j) {
        uint8_t c = line[cols[j]];
        uint8_t code = code_map[c];
        row[j] = code;
        bad |= (code == 0xFF);
        bool ng = c != '-';
        last = ng ? j : last;
        first = (ng && first < 0) ? j : first;
      }
      if (bad) {
        int64_t j = 0;
        while (row[j] != 0xFF) j++;
        meta[3] = nread;
        meta[4] = line[cols[j]];
        rc = -4;
        break;
      }
      p = next;
      n_gather++;
    } else {
      int64_t in_col = 0;
      int64_t out_col = 0;
      while (p < end && *p != '>' && rc == 0) {
        nl = find_nl(p, end);
        for (const char* q = p; q < nl; ++q) {
          char c = *q;
          if (c == '\r' || c == ' ' || c == '\t') continue;
          if (in_col >= in_sites) {
            rc = -2;
            break;
          }
          bool keep = !mask || !mask[in_col];
          in_col++;
          if (!keep) continue;
          uint8_t code = code_map[static_cast<uint8_t>(c)];
          if (code == 0xFF) {
            meta[3] = nread;
            meta[4] = static_cast<uint8_t>(c);
            rc = -4;
            break;
          }
          if (out_col >= out_sites) {
            rc = -2;
            break;
          }
          if (c != '-') {
            if (first < 0) first = out_col;
            last = out_col;
          }
          row[out_col++] = code;
        }
        p = nl < end ? nl + 1 : end;
      }
      if (rc == 0 && (out_col != out_sites || in_col != in_sites)) rc = -2;
      if (rc != 0) break;
      n_loop++;
    }
    ranges_out[2 * nread] = first < 0 ? 0 : static_cast<int32_t>(first);
    ranges_out[2 * nread + 1] =
        first < 0 ? 0 : static_cast<int32_t>(last + 1 - first);
    hash_out[nread] = row_hash(row, out_sites);
    nread++;
  }
  meta[0] = label_off;
  meta[1] = n_gather;
  meta[2] = n_loop;
  if (rc != 0) return rc;
  r->pos = p - r->data;
  return nread;
}

}  // extern "C"
