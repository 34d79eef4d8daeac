// Native BAM region fetch: BGZF inflate + record parse + region trim.
//
// The hot path of stage 1 (SURVEY.md §3.5 #1): the reference implements this
// in C++/htslib (pepper_variant/modules/cpp/bam_handler.cpp). This is a
// from-scratch implementation against the BAM/BGZF specs using zlib only
// (shared machinery in bam_common.h). Trim semantics mirror
// pepper_tpu/io/bam_reader.py::trim_read exactly; the Python reader is the
// semantic oracle in tests/test_native_io.py.
//
// C ABI: the caller (ctypes) passes the BGZF chunk list from the .bai and
// receives one flat ReadSet of trimmed reads (struct-of-arrays) for
// zero-copy numpy views.
#include "bam_common.h"

namespace {

struct Builder {
  std::vector<int64_t> pos, pos_end, seq_offset, cigar_offset, bad_offset,
      name_offset;
  std::vector<int32_t> mapq, flags, hp, seq_len, cigar_len, bad_len, name_len,
      cigar_lens, bad_buf;
  std::vector<uint8_t> cigar_ops, qual_buf;
  std::vector<char> seq_buf, name_buf;
};

}  // namespace

extern "C" {

typedef struct {
  int32_t n_reads;
  int64_t *pos, *pos_end, *seq_offset, *cigar_offset, *bad_offset, *name_offset;
  int32_t *mapq, *flags, *hp, *seq_len, *cigar_len, *bad_len, *name_len;
  int32_t *cigar_lens, *bad_buf;
  uint8_t *cigar_ops, *qual_buf;
  char *seq_buf, *name_buf;
  int64_t seq_buf_len, cigar_buf_len, bad_buf_len, name_buf_len;
} ReadSet;

static int64_t* dup64(const std::vector<int64_t>& v) {
  auto* p = (int64_t*)malloc(v.size() * sizeof(int64_t) + 1);
  memcpy(p, v.data(), v.size() * sizeof(int64_t));
  return p;
}
static int32_t* dup32(const std::vector<int32_t>& v) {
  auto* p = (int32_t*)malloc(v.size() * sizeof(int32_t) + 1);
  memcpy(p, v.data(), v.size() * sizeof(int32_t));
  return p;
}
static uint8_t* dup8(const std::vector<uint8_t>& v) {
  auto* p = (uint8_t*)malloc(v.size() + 1);
  memcpy(p, v.data(), v.size());
  return p;
}
static char* dupc(const std::vector<char>& v) {
  auto* p = (char*)malloc(v.size() + 1);
  memcpy(p, v.data(), v.size());
  return p;
}

void readset_free(ReadSet* rs) {
  if (!rs) return;
  free(rs->pos); free(rs->pos_end); free(rs->seq_offset);
  free(rs->cigar_offset); free(rs->bad_offset); free(rs->name_offset);
  free(rs->mapq); free(rs->flags); free(rs->hp); free(rs->seq_len);
  free(rs->cigar_len); free(rs->bad_len); free(rs->name_len);
  free(rs->cigar_lens); free(rs->bad_buf); free(rs->cigar_ops);
  free(rs->qual_buf); free(rs->seq_buf); free(rs->name_buf);
  free(rs);
}

ReadSet* bam_fetch_region(const char* bam_path, const uint64_t* chunks,
                          int n_chunks, int32_t want_ref, int64_t start,
                          int64_t stop, int include_suppl, int min_mapq,
                          int min_baseq) {
  Builder b;
  pep::TrimmedReadN tr;
  pep::for_each_record(
      bam_path, chunks, n_chunks, want_ref, start, stop, include_suppl != 0,
      min_mapq, [&](const pep::BamRecord& rec) {
        if (!pep::trim_record(rec, start, stop, tr)) return;
        size_t seq0 = b.seq_buf.size();
        size_t cig0 = b.cigar_ops.size();
        size_t bad0 = b.bad_buf.size();
        for (size_t k = 0; k < tr.seq.size(); k++) {
          char base = tr.seq[k];
          if (tr.qual[k] < min_baseq ||
              (base != 'A' && base != 'C' && base != 'G' && base != 'T'))
            b.bad_buf.push_back((int32_t)k);
        }
        b.bad_buf.push_back((int32_t)tr.seq.size() + 1);  // python sentinel
        b.seq_buf.insert(b.seq_buf.end(), tr.seq.begin(), tr.seq.end());
        b.qual_buf.insert(b.qual_buf.end(), tr.qual.begin(), tr.qual.end());
        for (auto [op, len] : tr.cigar) {
          b.cigar_ops.push_back((uint8_t)op);
          b.cigar_lens.push_back(len);
        }
        b.pos.push_back(tr.pos);
        b.pos_end.push_back(tr.pos_end);
        b.mapq.push_back(tr.mapq);
        b.flags.push_back(tr.flag);
        b.hp.push_back(tr.hp);
        b.seq_offset.push_back((int64_t)seq0);
        b.seq_len.push_back((int32_t)tr.seq.size());
        b.cigar_offset.push_back((int64_t)cig0);
        b.cigar_len.push_back((int32_t)(b.cigar_ops.size() - cig0));
        b.bad_offset.push_back((int64_t)bad0);
        b.bad_len.push_back((int32_t)(b.bad_buf.size() - bad0));
        b.name_offset.push_back((int64_t)b.name_buf.size());
        b.name_len.push_back((int32_t)rec.name.size());
        b.name_buf.insert(b.name_buf.end(), rec.name.begin(), rec.name.end());
      });

  auto* rs = (ReadSet*)calloc(1, sizeof(ReadSet));
  rs->n_reads = (int32_t)b.pos.size();
  rs->pos = dup64(b.pos);
  rs->pos_end = dup64(b.pos_end);
  rs->seq_offset = dup64(b.seq_offset);
  rs->cigar_offset = dup64(b.cigar_offset);
  rs->bad_offset = dup64(b.bad_offset);
  rs->name_offset = dup64(b.name_offset);
  rs->mapq = dup32(b.mapq);
  rs->flags = dup32(b.flags);
  rs->hp = dup32(b.hp);
  rs->seq_len = dup32(b.seq_len);
  rs->cigar_len = dup32(b.cigar_len);
  rs->bad_len = dup32(b.bad_len);
  rs->name_len = dup32(b.name_len);
  rs->cigar_lens = dup32(b.cigar_lens);
  rs->bad_buf = dup32(b.bad_buf);
  rs->cigar_ops = dup8(b.cigar_ops);
  rs->qual_buf = dup8(b.qual_buf);
  rs->seq_buf = dupc(b.seq_buf);
  rs->name_buf = dupc(b.name_buf);
  rs->seq_buf_len = (int64_t)b.seq_buf.size();
  rs->cigar_buf_len = (int64_t)b.cigar_ops.size();
  rs->bad_buf_len = (int64_t)b.bad_buf.size();
  rs->name_buf_len = (int64_t)b.name_buf.size();
  return rs;
}

}  // extern "C"
