// Shared BGZF + BAM record machinery for the native IO/encode paths.
// From-scratch implementation against the BGZF/BAM specs (zlib only);
// see bamio.cpp for the ReadSet fetch API and region_encode.cpp for the
// fused fetch+encode path.
#pragma once
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <string>
#include <vector>
#include <dlfcn.h>
#include <zlib.h>

namespace pep {

// Optional libdeflate backend for BGZF block inflate (~2-3x faster than
// zlib on short blocks). Resolved once via dlopen; zlib is the fallback,
// so the build has no hard dependency on libdeflate headers or libs.
struct LibDeflateApi {
  void* (*alloc_dec)(void) = nullptr;
  int (*decompress)(void*, const void*, size_t, void*, size_t, size_t*) =
      nullptr;
  void (*free_dec)(void*) = nullptr;
  void* (*alloc_comp)(int) = nullptr;
  size_t (*compress)(void*, const void*, size_t, void*, size_t) = nullptr;
  void (*free_comp)(void*) = nullptr;
  bool ok = false;       // decompression available
  bool ok_comp = false;  // compression available
  LibDeflateApi() {
    void* h = dlopen("libdeflate.so.0", RTLD_NOW);
    if (!h) h = dlopen("libdeflate.so", RTLD_NOW);
    if (!h) return;
    alloc_dec = (decltype(alloc_dec))dlsym(h, "libdeflate_alloc_decompressor");
    decompress =
        (decltype(decompress))dlsym(h, "libdeflate_deflate_decompress");
    free_dec = (decltype(free_dec))dlsym(h, "libdeflate_free_decompressor");
    ok = alloc_dec && decompress && free_dec;
    alloc_comp = (decltype(alloc_comp))dlsym(h, "libdeflate_alloc_compressor");
    compress = (decltype(compress))dlsym(h, "libdeflate_deflate_compress");
    free_comp = (decltype(free_comp))dlsym(h, "libdeflate_free_compressor");
    ok_comp = alloc_comp && compress && free_comp;
  }
};

inline const LibDeflateApi& libdeflate_api() {
  static LibDeflateApi api;
  return api;
}

constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_N = 3, OP_S = 4, OP_H = 5,
              OP_P = 6, OP_EQ = 7, OP_X = 8;
constexpr uint16_t FLAG_REVERSE = 16, FLAG_UNMAPPED = 4, FLAG_SECONDARY = 256,
                   FLAG_QCFAIL = 512, FLAG_DUP = 1024,
                   FLAG_SUPPLEMENTARY = 2048;

inline const char* SEQ_NT16() { return "=ACMGRSVTWYHKDBN"; }

struct BGZFCursor {
  FILE* fh = nullptr;
  std::vector<uint8_t> block;
  size_t block_off = 0;
  int64_t coffset = -1;
  int64_t next_coffset = 0;
  // reused across blocks: one inflateInit per cursor, one scratch buffer
  std::vector<uint8_t> scratch;
  z_stream zs{};
  bool zs_ready = false;
  void* ldef = nullptr;  // per-cursor libdeflate decompressor (thread-safe)

  ~BGZFCursor() {
    if (zs_ready) inflateEnd(&zs);
    if (ldef) libdeflate_api().free_dec(ldef);
  }

  bool load_block(int64_t coff) {
    // the common pattern is sequential blocks; skip the seek when the
    // stdio position is already there (keeps the read buffer warm)
    if (coff != next_coffset || coffset < 0) {
      if (fseeko(fh, coff, SEEK_SET) != 0) return false;
    }
    uint8_t hdr[18];
    if (fread(hdr, 1, 18, fh) != 18) return false;
    if (hdr[0] != 0x1f || hdr[1] != 0x8b) return false;
    uint16_t xlen = hdr[10] | (hdr[11] << 8);
    std::vector<uint8_t> extra(xlen);
    memcpy(extra.data(), hdr + 12, xlen < 6 ? xlen : 6);
    if (xlen > 6 && fread(extra.data() + 6, 1, xlen - 6, fh) != xlen - 6)
      return false;
    int bsize = -1;
    for (size_t i = 0; i + 4 <= extra.size();) {
      uint8_t si1 = extra[i], si2 = extra[i + 1];
      uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2)
        bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
      i += 4 + slen;
    }
    if (bsize < 0) return false;
    // file position is now coff + 12 + xlen: read cdata + footer in one go
    size_t cdata_len = bsize - 12 - xlen - 8;
    scratch.resize(cdata_len + 8);
    if (fread(scratch.data(), 1, cdata_len + 8, fh) != cdata_len + 8)
      return false;
    const uint8_t* footer = scratch.data() + cdata_len;
    uint32_t isize = footer[4] | (footer[5] << 8) | (footer[6] << 16)
                     | ((uint32_t)footer[7] << 24);
    block.resize(isize);
    if (isize > 0) {
      const LibDeflateApi& api = libdeflate_api();
      if (!ldef && api.ok) ldef = api.alloc_dec();
      if (ldef) {
        size_t actual = 0;
        if (api.decompress(ldef, scratch.data(), cdata_len, block.data(),
                           isize, &actual) != 0 ||
            actual != isize)
          return false;
      } else {
        // libdeflate absent, or its decompressor allocation failed
        // (transient OOM): fall through to the zlib path either way.
        if (!zs_ready) {
          if (inflateInit2(&zs, -15) != Z_OK) return false;
          zs_ready = true;
        } else if (inflateReset(&zs) != Z_OK) {
          return false;
        }
        zs.next_in = scratch.data();
        zs.avail_in = (uInt)cdata_len;
        zs.next_out = block.data();
        zs.avail_out = isize;
        if (inflate(&zs, Z_FINISH) != Z_STREAM_END) return false;
      }
    }
    coffset = coff;
    next_coffset = coff + bsize;
    block_off = 0;
    return true;
  }

  bool seek_virtual(uint64_t voff) {
    int64_t coff = (int64_t)(voff >> 16);
    uint16_t uoff = (uint16_t)(voff & 0xFFFF);
    if (coff != coffset && !load_block(coff)) return false;
    if (uoff > block.size()) return false;
    block_off = uoff;
    return true;
  }

  uint64_t virtual_offset() const {
    if (block_off >= block.size() && coffset >= 0)
      return ((uint64_t)next_coffset) << 16;
    return (((uint64_t)coffset) << 16) | (uint64_t)block_off;
  }

  bool read(uint8_t* dst, size_t n) {
    size_t got = 0;
    while (got < n) {
      if (block_off >= block.size()) {
        if (!load_block(next_coffset)) return false;
        if (block.empty()) {
          if (block_off >= block.size() && feof(fh)) return false;
          continue;
        }
      }
      size_t take = std::min(n - got, block.size() - block_off);
      memcpy(dst + got, block.data() + block_off, take);
      block_off += take;
      got += take;
    }
    return true;
  }
};

// One parsed BAM record (owning buffers reused across records by caller).
struct BamRecord {
  int32_t ref_id = 0;
  int64_t pos = 0;
  uint8_t mapq = 0;
  uint16_t flag = 0;
  std::string name;
  std::vector<std::pair<int, int>> cigar;  // (op, len)
  std::vector<char> seq;
  std::vector<uint8_t> qual;
  int hp = 0;
  int64_t ref_span = 0;
};

inline int parse_hp_tag(const uint8_t* aux, size_t n) {
  size_t i = 0;
  while (i + 4 <= n) {
    const uint8_t* tag = aux + i;
    uint8_t typ = aux[i + 2];
    i += 3;
    long val = 0;
    switch (typ) {
      case 'c': val = (int8_t)aux[i]; i += 1; break;
      case 'C': val = aux[i]; i += 1; break;
      case 's': { int16_t v; memcpy(&v, aux + i, 2); val = v; i += 2; } break;
      case 'S': { uint16_t v; memcpy(&v, aux + i, 2); val = v; i += 2; } break;
      case 'i': { int32_t v; memcpy(&v, aux + i, 4); val = v; i += 4; } break;
      case 'I': { uint32_t v; memcpy(&v, aux + i, 4); val = v; i += 4; } break;
      case 'A': i += 1; continue;
      case 'f': i += 4; continue;
      case 'Z': case 'H': { while (i < n && aux[i] != 0) i++; i++; continue; }
      case 'B': {
        uint8_t sub = aux[i];
        uint32_t count;
        memcpy(&count, aux + i + 1, 4);
        int size = (sub == 'c' || sub == 'C') ? 1
                   : (sub == 's' || sub == 'S') ? 2 : 4;
        i += 5 + (size_t)count * size;
        continue;
      }
      default: return 0;
    }
    if (tag[0] == 'H' && tag[1] == 'P') return (int)val;
  }
  return 0;
}

// Parse the record HEAD (ids, flags, name, cigar -> ref_span) only; the
// caller can then span-filter before paying for sequence/qual decode.
// Returns the byte offset where seq data starts (for parse_record_body).
inline size_t parse_record_head(const std::vector<uint8_t>& raw,
                                BamRecord& rec) {
  memcpy(&rec.ref_id, raw.data(), 4);
  int32_t rpos;
  memcpy(&rpos, raw.data() + 4, 4);
  rec.pos = rpos;
  uint8_t l_read_name = raw[8];
  rec.mapq = raw[9];
  uint16_t n_cigar;
  memcpy(&n_cigar, raw.data() + 12, 2);
  memcpy(&rec.flag, raw.data() + 14, 2);
  size_t off = 32;
  rec.name.assign((const char*)raw.data() + off, l_read_name - 1);
  off += l_read_name;
  rec.cigar.clear();
  rec.ref_span = 0;
  for (int k = 0; k < n_cigar; k++) {
    uint32_t v;
    memcpy(&v, raw.data() + off + 4ull * k, 4);
    int op = v & 0xF, len = v >> 4;
    rec.cigar.emplace_back(op, len);
    if (op == OP_M || op == OP_D || op == OP_N || op == OP_EQ || op == OP_X)
      rec.ref_span += len;
  }
  return off + 4ull * n_cigar;
}

// Nibble-pair LUT: one table lookup emits the two bases of a sequence byte.
inline const uint16_t* seq_pair_lut() {
  static const auto t = [] {
    std::vector<uint16_t> t(256);
    for (int b = 0; b < 256; b++) {
      char two[2] = {SEQ_NT16()[b >> 4], SEQ_NT16()[b & 0xF]};
      memcpy(&t[b], two, 2);
    }
    return t;
  }();
  return t.data();
}

// Decode seq/qual/aux (the expensive part) after the head.
inline void parse_record_body(const std::vector<uint8_t>& raw, size_t off,
                              BamRecord& rec) {
  int32_t l_seq;
  memcpy(&l_seq, raw.data() + 16, 4);
  rec.seq.resize(l_seq);
  const uint8_t* sb = raw.data() + off;
  const uint16_t* SEQ2 = seq_pair_lut();
  {
    char* dst = rec.seq.data();
    const int pairs = l_seq / 2;
    for (int k = 0; k < pairs; k++)
      memcpy(dst + 2 * k, &SEQ2[sb[k]], 2);
    if (l_seq & 1) dst[l_seq - 1] = SEQ_NT16()[sb[l_seq / 2] >> 4];
  }
  off += (l_seq + 1) / 2;
  rec.qual.assign(raw.data() + off, raw.data() + off + l_seq);
  off += l_seq;
  rec.hp = parse_hp_tag(raw.data() + off, raw.size() - off);
}

// Parse one record body (after the 4-byte block_size) into rec.
inline void parse_record(const std::vector<uint8_t>& raw, BamRecord& rec) {
  parse_record_body(raw, parse_record_head(raw, rec), rec);
}

// Iterate the raw records (the bytes after the 4-byte block_size) in the
// chunk list that lie on want_ref, start before `stop` and pass the
// flag/mapq filters: fn(raw). Whether a record reaches `start` is the
// caller's test. The filters of bam_reader.py _iter_region_records +
// get_reads.
template <typename Fn>
void for_each_raw_record(const char* bam_path, const uint64_t* chunks,
                         int n_chunks, int32_t want_ref, int64_t stop,
                         bool include_suppl, int min_mapq, Fn fn) {
  FILE* fh = fopen(bam_path, "rb");
  if (!fh) return;
  BGZFCursor cur;
  cur.fh = fh;
  std::vector<uint8_t> raw;
  for (int c = 0; c < n_chunks; c++) {
    uint64_t vbeg = chunks[2 * c], vend = chunks[2 * c + 1];
    if (!cur.seek_virtual(vbeg)) continue;
    while (cur.virtual_offset() < vend) {
      uint8_t szb[4];
      if (!cur.read(szb, 4)) break;
      int32_t block_size;
      memcpy(&block_size, szb, 4);
      if (block_size <= 0) break;
      raw.resize(block_size);
      if (!cur.read(raw.data(), block_size)) break;
      int32_t ref_id;
      memcpy(&ref_id, raw.data(), 4);
      if (ref_id != want_ref) continue;
      int32_t rpos;
      memcpy(&rpos, raw.data() + 4, 4);
      if (rpos >= stop) break;  // next chunk
      uint16_t flag;
      memcpy(&flag, raw.data() + 14, 2);
      if (flag & (FLAG_QCFAIL | FLAG_DUP | FLAG_SECONDARY | FLAG_UNMAPPED))
        continue;
      if (!include_suppl && (flag & FLAG_SUPPLEMENTARY)) continue;
      if (raw[9] < min_mapq) continue;
      fn(raw);
    }
  }
  fclose(fh);
}

// Iterate records in the chunk list; calls fn(rec) for records on want_ref
// overlapping [start, stop) that pass flag/mapq filters. Mirrors
// bam_reader.py _iter_region_records + get_reads filters.
template <typename Fn>
void for_each_record(const char* bam_path, const uint64_t* chunks,
                     int n_chunks, int32_t want_ref, int64_t start,
                     int64_t stop, bool include_suppl, int min_mapq, Fn fn) {
  BamRecord rec;
  for_each_raw_record(
      bam_path, chunks, n_chunks, want_ref, stop, include_suppl, min_mapq,
      [&](const std::vector<uint8_t>& raw) {
        // head first: records ending before the window skip the (10x more
        // expensive) sequence/quality decode entirely
        size_t body_off = parse_record_head(raw, rec);
        if (rec.pos + rec.ref_span <= start) return;
        parse_record_body(raw, body_off, rec);
        fn(rec);
      });
}

// Trimmed read view (indices into the record's own buffers after trim).
struct TrimmedReadN {
  int64_t pos = -1, pos_end = -1;
  std::vector<std::pair<int, int>> cigar;
  std::vector<char> seq;
  std::vector<uint8_t> qual;
  uint16_t flag = 0;
  uint8_t mapq = 0;
  int hp = 0;
};

// Mirrors bam_reader.py trim_read (stop INCLUSIVE).
inline bool trim_record(const BamRecord& rec, int64_t start, int64_t stop,
                        TrimmedReadN& out) {
  out.pos = -1;
  out.pos_end = -1;
  out.cigar.clear();
  out.seq.clear();
  out.qual.clear();
  int64_t current_pos = rec.pos;
  int64_t read_index = 0;
  for (auto [op, length] : rec.cigar) {
    if (current_pos > stop) break;
    if (op == OP_M || op == OP_EQ || op == OP_X) {
      int64_t skip = 0;
      if (current_pos < start) {
        skip = std::min<int64_t>(start - current_pos, length);
        read_index += skip;
        current_pos += skip;
      }
      int64_t n = length - skip;
      int64_t kept = std::min<int64_t>(n, stop - current_pos + 1);
      if (kept > 0) {
        if (out.pos == -1) { out.pos = current_pos; out.pos_end = out.pos; }
        out.seq.insert(out.seq.end(), rec.seq.begin() + read_index,
                       rec.seq.begin() + read_index + kept);
        out.qual.insert(out.qual.end(), rec.qual.begin() + read_index,
                        rec.qual.begin() + read_index + kept);
        out.cigar.emplace_back(op, (int)kept);
        out.pos_end += kept;
      }
      read_index += n;
      current_pos += n;
    } else if (op == OP_S || op == OP_I) {
      if (start <= current_pos && current_pos <= stop && out.pos != -1) {
        out.seq.insert(out.seq.end(), rec.seq.begin() + read_index,
                       rec.seq.begin() + read_index + length);
        out.qual.insert(out.qual.end(), rec.qual.begin() + read_index,
                        rec.qual.begin() + read_index + length);
        out.cigar.emplace_back(op, length);
      }
      read_index += length;
    } else if (op == OP_N || op == OP_D) {
      if (start <= current_pos && current_pos <= stop && out.pos != -1) {
        int64_t kept = std::min<int64_t>(length, stop - current_pos + 1);
        if (kept > 0) {
          out.cigar.emplace_back(op, (int)kept);
          out.pos_end += kept;
        }
      }
      current_pos += length;
    } else if (op == OP_P) {
      current_pos += length;
    }
  }
  if (out.seq.empty()) return false;
  out.flag = rec.flag;
  out.mapq = rec.mapq;
  out.hp = rec.hp;
  return true;
}

// numpy-MT19937-compatible RNG (RandomState parity for reservoir
// downsampling; shared by region_encode.cpp and polish_encode.cpp)
struct NumpyMT {
  uint32_t mt[624];
  int mti = 625;

  void init_genrand(uint32_t s) {
    mt[0] = s;
    for (mti = 1; mti < 624; mti++)
      mt[mti] = 1812433253u * (mt[mti - 1] ^ (mt[mti - 1] >> 30)) + mti;
  }

  void init_by_array(const uint32_t* key, int key_length) {
    init_genrand(19650218u);
    int i = 1, j = 0;
    int k = 624 > key_length ? 624 : key_length;
    for (; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525u))
              + key[j] + j;
      i++; j++;
      if (i >= 624) { mt[0] = mt[623]; i = 1; }
      if (j >= key_length) j = 0;
    }
    for (k = 623; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941u)) - i;
      i++;
      if (i >= 624) { mt[0] = mt[623]; i = 1; }
    }
    mt[0] = 0x80000000u;
    mti = 624;
  }

  uint32_t next32() {
    uint32_t y;
    if (mti >= 624) {
      for (int kk = 0; kk < 624 - 397; kk++) {
        y = (mt[kk] & 0x80000000u) | (mt[kk + 1] & 0x7fffffffu);
        mt[kk] = mt[kk + 397] ^ (y >> 1) ^ ((y & 1) ? 0x9908b0dfu : 0);
      }
      for (int kk = 624 - 397; kk < 623; kk++) {
        y = (mt[kk] & 0x80000000u) | (mt[kk + 1] & 0x7fffffffu);
        mt[kk] = mt[kk + (397 - 624)] ^ (y >> 1) ^ ((y & 1) ? 0x9908b0dfu : 0);
      }
      y = (mt[623] & 0x80000000u) | (mt[0] & 0x7fffffffu);
      mt[623] = mt[396] ^ (y >> 1) ^ ((y & 1) ? 0x9908b0dfu : 0);
      mti = 0;
    }
    y = mt[mti++];
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= (y >> 18);
    return y;
  }

  // numpy random_bounded_uint64 (distributions.c): masked rejection; 32-bit
  // draws when the range fits, 64-bit (hi-word-first) otherwise.
  uint64_t bounded(uint64_t rng) {  // inclusive upper bound
    if (rng == 0) return 0;
    uint64_t mask = rng;
    mask |= mask >> 1;  mask |= mask >> 2;  mask |= mask >> 4;
    mask |= mask >> 8;  mask |= mask >> 16; mask |= mask >> 32;
    if (rng <= 0xffffffffULL) {
      while (true) {
        uint64_t v = next32() & mask;
        if (v <= rng) return v;
      }
    }
    while (true) {
      uint64_t hi = next32(), lo = next32();
      uint64_t v = ((hi << 32) | lo) & mask;
      if (v <= rng) return v;
    }
  }
};

}  // namespace pep
