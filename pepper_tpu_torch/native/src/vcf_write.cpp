// Native 5-file VCF sink: BGZF writer + tabix builder + record formatter.
//
// Byte-identical twin of the Python engine (pepper_tpu/io/vcf.py:
// BGZFWriter, _TabixBuilder, IndexedVcfWriter, VCFWriteEngine.write_site's
// single-candidate path) — CI-enforced by fuzz differential tests
// (tests/test_vcf_native.py) and by the staged-vs-streamed byte-identity
// suite (staged runs keep the Python engine). Both sides use zlib at the
// same parameters, so compressed bytes match exactly.
//
// Float formatting parity: Python's round(x, 3) and format(x, ".6g") are
// correctly-rounded decimal conversions; glibc's printf/strtod are too,
// so round -> "%.3f" + strtod, and format -> "%.6g".
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>
#include <zlib.h>

#include "bam_common.h"

namespace {

constexpr size_t FLUSH_AT = 65280;   // BGZFWriter._FLUSH_AT

// Deflate one BGZF payload with libdeflate (~2.5x faster than zlib at
// the same level); returns cdata length, or -1 when libdeflate is
// unavailable or the result does not fit `cap`. BOTH the C++ sink and
// the Python BGZFWriter (via the bgzf_deflate_block export) route every
// block through this one function, so the two engines stay byte-identical
// whichever backend the process resolves.
int64_t bgzf_try_libdeflate(const uint8_t* in, size_t n, uint8_t* out,
                            size_t cap) {
  const pep::LibDeflateApi& api = pep::libdeflate_api();
  if (!api.ok_comp) return -1;
  static thread_local void* comp = nullptr;
  if (!comp) comp = api.alloc_comp(6);
  if (!comp) return -1;
  size_t r = api.compress(comp, in, n, out, cap);
  return r == 0 ? -1 : (int64_t)r;
}
constexpr uint8_t EOF_MARKER[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00};

struct BgzfOut {
  FILE* fh = nullptr;
  std::string path;
  std::vector<uint8_t> buf;
  int64_t coffset = 0;
  bool closed = false;

  bool open(const char* p) {
    path = p;
    fh = fopen(p, "wb");
    return fh != nullptr;
  }

  int64_t virtual_offset() const {
    return (coffset << 16) | (int64_t)buf.size();
  }

  bool write_block(const uint8_t* data, size_t n) {
    std::vector<uint8_t> cdata(65536);
    size_t clen;
    int64_t r = bgzf_try_libdeflate(data, n, cdata.data(), cdata.size());
    if (r > 0) {
      clen = (size_t)r;
    } else {
      // zlib.compressobj(6, DEFLATED, -15) twin: level 6, raw, memLevel 8
      z_stream zs{};
      if (deflateInit2(&zs, 6, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY)
          != Z_OK)
        return false;
      cdata.resize(deflateBound(&zs, n) + 16);
      zs.next_in = const_cast<uint8_t*>(data);
      zs.avail_in = (uInt)n;
      zs.next_out = cdata.data();
      zs.avail_out = (uInt)cdata.size();
      if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
        deflateEnd(&zs);
        return false;
      }
      clen = cdata.size() - zs.avail_out;
      deflateEnd(&zs);
    }
    size_t block_size = clen + 12 + 6 + 8;
    if (block_size > 65536) return false;
    uint8_t hdr[18] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0,  // MTIME=0
                       0,    0xff, 6, 0,              // XFL=0 OS=0xFF XLEN=6
                       66,   67,   2, 0, 0, 0};       // BC subfield
    uint16_t bs1 = (uint16_t)(block_size - 1);
    memcpy(hdr + 16, &bs1, 2);
    uint32_t crc = crc32(0, data, (uInt)n);
    uint32_t isize = (uint32_t)n;
    if (fwrite(hdr, 1, 18, fh) != 18) return false;
    if (clen && fwrite(cdata.data(), 1, clen, fh) != clen) return false;
    if (fwrite(&crc, 4, 1, fh) != 1) return false;
    if (fwrite(&isize, 4, 1, fh) != 1) return false;
    coffset += (int64_t)block_size;
    return true;
  }

  bool write(const uint8_t* data, size_t n) {
    buf.insert(buf.end(), data, data + n);
    while (buf.size() >= FLUSH_AT) {
      if (!write_block(buf.data(), FLUSH_AT)) return false;
      buf.erase(buf.begin(), buf.begin() + FLUSH_AT);
    }
    return true;
  }

  bool close() {
    if (closed) return true;
    closed = true;
    bool ok = true;
    if (!buf.empty()) {
      ok = write_block(buf.data(), buf.size());
      buf.clear();
    }
    if (ok) ok = fwrite(EOF_MARKER, 1, 28, fh) == 28;
    fclose(fh);
    fh = nullptr;
    return ok;
  }

  void abort() {
    if (fh) fclose(fh);
    fh = nullptr;
    closed = true;
    remove(path.c_str());
  }
};

inline int reg2bin(int64_t beg, int64_t end) {
  end -= 1;
  if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (int)(beg >> 14);
  if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (int)(beg >> 17);
  if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (int)(beg >> 20);
  if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (int)(beg >> 23);
  if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (int)(beg >> 26);
  return 0;
}

struct TabixBuilder {
  std::vector<std::string> names;
  std::map<std::string, int> name_idx;
  std::vector<std::map<uint32_t, std::vector<std::pair<uint64_t, uint64_t>>>>
      bins;
  std::vector<std::map<int64_t, uint64_t>> linear;
  std::string last_name;
  int last_ref = -1;

  void add(const char* contig, int64_t beg, int64_t end, uint64_t v_start,
           uint64_t v_end) {
    int ref;
    if (last_ref >= 0 && last_name == contig) {
      ref = last_ref;
    } else {
      auto it = name_idx.find(contig);
      if (it == name_idx.end()) {
        ref = (int)names.size();
        name_idx[contig] = ref;
        names.push_back(contig);
        bins.emplace_back();
        linear.emplace_back();
      } else {
        ref = it->second;
      }
      last_name = contig;
      last_ref = ref;
    }
    uint32_t b = (uint32_t)reg2bin(beg, end);
    auto& chunks = bins[ref][b];
    if (!chunks.empty() && chunks.back().second == v_start)
      chunks.back().second = v_end;
    else
      chunks.emplace_back(v_start, v_end);
    for (int64_t w = beg >> 14; w <= (end - 1) >> 14; w++)
      linear[ref].emplace(w, v_start);   // setdefault: first write wins
  }

  bool write(const char* path) const {
    std::vector<uint8_t> payload;
    auto put = [&](const void* p, size_t n) {
      payload.insert(payload.end(), (const uint8_t*)p,
                     (const uint8_t*)p + n);
    };
    auto put_i32 = [&](int32_t v) { put(&v, 4); };
    put("TBI\x01", 4);
    size_t names_blob = 0;
    for (const auto& n : names) names_blob += n.size() + 1;
    int32_t hdr[8] = {(int32_t)names.size(), 2, 1, 2, 0, '#', 0,
                      (int32_t)names_blob};
    put(hdr, 32);
    for (const auto& n : names) put(n.c_str(), n.size() + 1);
    for (size_t ref = 0; ref < names.size(); ref++) {
      put_i32((int32_t)bins[ref].size());
      for (const auto& [bin_id, chunks] : bins[ref]) {  // map: sorted keys
        uint32_t b = bin_id;
        put(&b, 4);
        put_i32((int32_t)chunks.size());
        for (const auto& [cb, ce] : chunks) {
          put(&cb, 8);
          put(&ce, 8);
        }
      }
      const auto& lin = linear[ref];
      int64_t n_intv = lin.empty() ? 0 : (lin.rbegin()->first + 1);
      put_i32((int32_t)n_intv);
      uint64_t prev = 0;
      for (int64_t w = 0; w < n_intv; w++) {
        auto it = lin.find(w);
        if (it != lin.end()) prev = it->second;
        put(&prev, 8);
      }
    }
    BgzfOut bw;
    if (!bw.open(path)) return false;
    bool ok = bw.write(payload.data(), payload.size());
    return bw.close() && ok;
  }
};

struct VcfFile {
  BgzfOut out;
  TabixBuilder tabix;
  int64_t voffset = 0;   // IndexedVcfWriter._voffset chain

  bool write_record(const char* contig, int64_t beg, int64_t end,
                    const char* line, size_t len) {
    int64_t v_start = voffset;
    if (!out.write((const uint8_t*)line, len)) return false;
    voffset = out.virtual_offset();
    tabix.add(contig, beg, end, (uint64_t)v_start, (uint64_t)voffset);
    return true;
  }
};

struct VcfSink {
  VcfFile files[5];   // full, pepper, vc, vc_snp, vc_indel
  int64_t totals[5] = {0, 0, 0, 0, 0};
  double snp_q, snp_q_lc, indel_q, indel_q_lc;
  bool failed = false;
};

// Python float-formatting twins --------------------------------------------
inline double py_round3(double x) {
  // round(x, 3): correctly-rounded decimal at 3 places, back to double
  char tmp[64];
  snprintf(tmp, sizeof(tmp), "%.3f", x);
  return strtod(tmp, nullptr);
}

inline int fmt_g6(char* dst, double v) {
  // format(v, ".6g")... python strips nothing; printf %g matches
  return snprintf(dst, 32, "%.6g", v);
}

}  // namespace

extern "C" {

// Python BGZFWriter's fast path: raw-deflate one BGZF payload through the
// same libdeflate backend as the C++ sink (identical bytes either side).
// Returns cdata length, or -1 (caller falls back to zlib level 6 — which
// is also what this process's C++ sink falls back to).
int64_t bgzf_deflate_block(const uint8_t* in, int64_t n, uint8_t* out,
                           int64_t cap) {
  return bgzf_try_libdeflate(in, (size_t)n, out, (size_t)cap);
}

void* vcf_sink_create(const char* const* paths5, const char* header,
                      int64_t header_len, double snp_q, double snp_q_lc,
                      double indel_q, double indel_q_lc) {
  auto* s = new VcfSink();
  s->snp_q = snp_q;
  s->snp_q_lc = snp_q_lc;
  s->indel_q = indel_q;
  s->indel_q_lc = indel_q_lc;
  for (int i = 0; i < 5; i++) {
    if (!s->files[i].out.open(paths5[i]) ||
        !s->files[i].out.write((const uint8_t*)header, header_len)) {
      // same cleanup as vcf_sink_abort for files already opened: close
      // their FILE* handles and remove the partial .vcf.gz outputs
      for (int j = 0; j <= i; j++) s->files[j].out.abort();
      delete s;
      return nullptr;
    }
    s->files[i].voffset = s->files[i].out.virtual_offset();
  }
  return s;
}

// Batched single-candidate sites (the overwhelmingly common case), already
// position-sorted and de-duplicated against the engine's last_position.
// Parity: VCFWriteEngine.write_site + candidate_list_to_variant's
// single-candidate fast path (io/vcf.py).
// pg: 0/1/2 (first-max genotype). gt_prob: predictions[pg]. nap:
// max(p1, p2). Returns 0 on success.
int vcf_sink_write_batch(
    void* handle, int64_t n, const char* contig,
    const int64_t* pos, const int32_t* ref_off, const char* ref_buf,
    const int32_t* alt_off, const char* alt_buf, const uint8_t* pg,
    const int32_t* depth, const int32_t* support, const double* gt_prob,
    const double* nap, const uint8_t* in_repeat) {
  auto* s = (VcfSink*)handle;
  char line[512];
  std::vector<char> big;   // fallback for very long alleles
  for (int64_t i = 0; i < n; i++) {
    const char* ref = ref_buf + ref_off[i];
    int ref_len = ref_off[i + 1] - ref_off[i];
    const char* alt = alt_buf + alt_off[i];
    int alt_len = alt_off[i + 1] - alt_off[i];
    int g = pg[i];
    double gt_qual = g ? gt_prob[i] : nap[i];
    int64_t ref_start = pos[i];
    int64_t ref_end = ref_start + ref_len;
    double q = 1.0 - gt_qual;
    if (q < 1e-9) q = 1e-9;
    long qual = (long)(-10.0 * log10(q));
    if (qual < 1) qual = 1;
    bool is_snp = (ref_len > alt_len ? ref_len : alt_len) == 1;
    double cutoff = is_snp ? (in_repeat[i] ? s->snp_q_lc : s->snp_q)
                           : (in_repeat[i] ? s->indel_q_lc : s->indel_q);
    bool failed_variant = (double)qual <= cutoff;
    bool is_ref_call = (g == 0);
    bool selected = is_ref_call || failed_variant;
    int dp = depth[i] > 1 ? depth[i] : 1;
    double vaf = py_round3((double)support[i] / (double)dp);
    int g1 = g == 2 ? 1 : 0, g2 = g == 0 ? 0 : 1;
    char nap_s[32], vaf_s[32];
    fmt_g6(nap_s, nap[i]);
    fmt_g6(vaf_s, vaf);
    int len = snprintf(
        line, sizeof(line),
        "%s\t%lld\t.\t%.*s\t%.*s\t%ld\t%s\t.\tGT:AP:GQ:DP:AD:VAF:REP\t"
        "%d/%d:%s:%ld:%d:%d:%s:%c\n",
        contig, (long long)(ref_start + 1), ref_len, ref, alt_len, alt,
        qual, is_ref_call ? "refCall" : "PASS", g1, g2, nap_s, qual,
        depth[i], support[i], vaf_s, in_repeat[i] ? '1' : '0');
    const char* lp = line;
    if (len >= (int)sizeof(line)) {   // oversized alleles: heap buffer
      big.resize(len + 2);
      len = snprintf(
          big.data(), big.size(),
          "%s\t%lld\t.\t%.*s\t%.*s\t%ld\t%s\t.\tGT:AP:GQ:DP:AD:VAF:REP\t"
          "%d/%d:%s:%ld:%d:%d:%s:%c\n",
          contig, (long long)(ref_start + 1), ref_len, ref, alt_len, alt,
          qual, is_ref_call ? "refCall" : "PASS", g1, g2, nap_s, qual,
          depth[i], support[i], vaf_s, in_repeat[i] ? '1' : '0');
      lp = big.data();
    }
    if (!s->files[0].write_record(contig, ref_start, ref_end, lp, len))
      return 1;
    s->totals[0] += 1;
    if (selected) {
      int idx = is_snp ? 3 : 4;
      if (!s->files[idx].write_record(contig, ref_start, ref_end, lp, len))
        return 1;
      s->totals[idx] += 1;
      if (!s->files[2].write_record(contig, ref_start, ref_end, lp, len))
        return 1;
      s->totals[2] += 1;
    } else {
      if (!s->files[1].write_record(contig, ref_start, ref_end, lp, len))
        return 1;
      s->totals[1] += 1;
    }
  }
  return 0;
}

// Raw pre-formatted record (Python handles rare multi-candidate sites):
// writes `line` to every file in files_mask (bit i = file i) and adds the
// per-file totals.
int vcf_sink_write_raw(void* handle, int files_mask, const char* contig,
                       int64_t beg, int64_t end, const char* line,
                       int64_t len) {
  auto* s = (VcfSink*)handle;
  for (int i = 0; i < 5; i++) {
    if (!(files_mask & (1 << i))) continue;
    if (!s->files[i].write_record(contig, beg, end, line, (size_t)len))
      return 1;
    s->totals[i] += 1;
  }
  return 0;
}

void vcf_sink_totals(void* handle, int64_t* out5) {
  auto* s = (VcfSink*)handle;
  for (int i = 0; i < 5; i++) out5[i] = s->totals[i];
}

// Flush + EOF-mark the 5 streams and write their .tbi files. Returns 0 on
// success.
int vcf_sink_close(void* handle) {
  auto* s = (VcfSink*)handle;
  int rc = 0;
  for (int i = 0; i < 5; i++) {
    if (!s->files[i].out.close()) rc = 1;
    std::string tbi = s->files[i].out.path + ".tbi";
    if (!s->files[i].tabix.write(tbi.c_str())) rc = 1;
  }
  delete s;
  return rc;
}

void vcf_sink_abort(void* handle) {
  auto* s = (VcfSink*)handle;
  for (int i = 0; i < 5; i++) {
    std::string tbi = s->files[i].out.path + ".tbi";
    s->files[i].out.abort();
    remove(tbi.c_str());
  }
  delete s;
}

}  // extern "C"
