// Fused native region encoder: BAM fetch -> trim -> event walk -> count
// matrix -> site thresholds -> candidate windows (+ train labels).
//
// This is the pipeline's hot path (SURVEY.md §3.5). Semantics are a direct
// port of the Python implementation (pepper_tpu/encode/events.py +
// region_encoder.py), which is the tested oracle; tests/test_native_encode.py
// asserts bit-equality between the two on randomized data. The Python layer
// stays authoritative for semantics; this file exists for speed (it also
// avoids materializing per-read Python objects entirely).
//
// Downsampling reproduces numpy RandomState(seed).randint(0, i+1) exactly:
// MT19937 seeded with init_by_array([seed]) + masked-rejection bounded
// draws (the legacy numpy algorithm), so native and Python paths pick the
// same reads.
#include "bam_common.h"

#include <array>
#include <atomic>
#include <chrono>
#include <cmath>
#include <map>
#include <memory>

namespace {

using pep::TrimmedReadN;
using pep::NumpyMT;


// ---------------------------------------------------------------- constants
constexpr int MAXV = 125, MINV = -125;
constexpr int BASE_INDEX_START = 11, BASE_INDEX_SIZE = 14;
constexpr int FWD_START = 7, REV_START = 18;

inline bool ref_ok(char b) {
  return b == 'A' || b == 'C' || b == 'G' || b == 'T';
}

inline int ref_value(char b) {
  switch (b) {
    case 'A': return 1;
    case 'C': return 2;
    case 'G': return 3;
    case 'T': return 4;
    default: return 5;
  }
}

// region_summary.cpp:201-230 / events.py feature_index
// base -> column offset within a strand block (A=1..T=4, I=5, D=6, other=7)
struct BaseOffsetTable {
  int8_t t[256];
  constexpr BaseOffsetTable() : t() {
    for (int i = 0; i < 256; i++) t[i] = 7;
    t[(unsigned char)'A'] = 1; t[(unsigned char)'C'] = 2;
    t[(unsigned char)'G'] = 3; t[(unsigned char)'T'] = 4;
    t[(unsigned char)'I'] = 5; t[(unsigned char)'D'] = 6;
  }
};
constexpr BaseOffsetTable BASE_OFFSET;

inline int feature_index(char ref_base, char base, bool rev) {
  if (!ref_ok(ref_base)) return -1;
  return (rev ? REV_START : FWD_START) + BASE_OFFSET.t[(unsigned char)base];
}

struct AlleleCount { int total = 0, fwd = 0, rev = 0; };

struct TruthRec {
  int64_t pos_start, pos_end;
  std::string ref, alt;
};

// region_encoder.py _truth_candidate_string
static std::string truth_candidate_string(const TruthRec& r) {
  std::string allele, other;
  char atype;
  if (r.ref.size() > r.alt.size()) { allele = r.ref; other = r.alt; atype = '3'; }
  else if (r.ref.size() < r.alt.size()) { allele = r.alt; other = r.ref; atype = '2'; }
  else { allele = r.alt; other = r.ref; atype = '1'; }
  if (allele.size() > 1 && other.size() > 1) {
    size_t min_len = std::min(allele.size(), other.size());
    allele = allele.substr(0, allele.size() - min_len + 1);
  }
  return std::string(1, atype) + allele;
}

const char* BASE_LABELS[28] = {
    "RR", "RA", "RC", "RT", "RG", "R*", "R#", "AA", "AC", "AT", "AG", "A*",
    "A#", "CC", "CT", "CG", "C*", "C#", "TT", "TG", "T*", "T#", "GG", "G*",
    "G#", "**", "*#", "##"};

static int get_label_index(char h1, char h2) {
  h1 = toupper(h1); h2 = toupper(h2);
  for (int i = 0; i < 28; i++) {
    char a = BASE_LABELS[i][0], b = BASE_LABELS[i][1];
    if ((h1 == a && h2 == b) || (h2 == a && h1 == b)) return i;
  }
  return 0;
}

static int type_label_index(int t1, int t2) {
  static const int table[4][4] = {
      {0, 1, 2, 3}, {1, 4, 5, 6}, {2, 5, 7, 8}, {3, 6, 8, 9}};
  return table[t1][t2];
}

struct Out {
  std::vector<int64_t> positions;
  std::vector<int32_t> depths, type_labels, base_labels, cand_freqs,
      cand_offsets;
  std::vector<char> cand_buf;
  std::vector<int8_t> images;
};

// Always-on section timers (5 steady_clock reads per region — noise next
// to the ~10ms regions they measure). Summed across threads; drained from
// Python via encode_prof_get for the bench's encode breakdown.
std::atomic<int64_t> g_ns_fetch{0}, g_ns_walk{0}, g_ns_site{0},
    g_ns_windows{0}, g_calls{0};

struct SectionTimer {
  std::chrono::steady_clock::time_point t;
  SectionTimer() : t(std::chrono::steady_clock::now()) {}
  void lap(std::atomic<int64_t>& acc) {
    auto now = std::chrono::steady_clock::now();
    acc.fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(now - t).count(),
        std::memory_order_relaxed);
    t = now;
  }
};

}  // namespace

extern "C" {

typedef struct {
  int32_t n;
  int64_t* positions;
  int32_t* depths;
  int32_t* type_labels;
  int32_t* base_labels;
  int32_t* cand_freqs;
  int32_t* cand_offsets;  // n+1
  char* cand_buf;
  // int8 with numpy-astype wrap semantics: every downstream consumer
  // (HDF5 image store, device transfer) is int8, and wrapping commutes
  // with the midpoint sign flips (mod-256), so converting at the render
  // saves 4x the memory traffic of the old int32 buffer
  int8_t* images;  // n * (window+1) * features
  int64_t cand_buf_len;
  int32_t window1, features;
} EncodeResult;

// Drain the cumulative encode section timers (seconds): [fetch+trim,
// event walk, transpose+thresholds+labels, window render, n_calls].
void encode_prof_get(double* out5) {
  out5[0] = g_ns_fetch.exchange(0) * 1e-9;
  out5[1] = g_ns_walk.exchange(0) * 1e-9;
  out5[2] = g_ns_site.exchange(0) * 1e-9;
  out5[3] = g_ns_windows.exchange(0) * 1e-9;
  out5[4] = (double)g_calls.exchange(0);
}

void encode_result_free(EncodeResult* r) {
  if (!r) return;
  free(r->positions); free(r->depths); free(r->type_labels);
  free(r->base_labels); free(r->cand_freqs); free(r->cand_offsets);
  free(r->cand_buf); free(r->images);
  free(r);
}

EncodeResult* encode_region(
    const char* bam_path, const uint64_t* chunks, int n_chunks,
    int32_t ref_id, int64_t fetch_start, int64_t fetch_stop,
    int64_t region_start, int64_t region_end, const char* ref_seq_c,
    int include_suppl, int min_mapq,
    double min_snp_baseq, double min_indel_baseq, double snp_freq,
    double ins_freq, double del_freq, double min_cov, double snp_cand_freq,
    double indel_cand_freq, double cand_support, int skip_indels,
    int64_t cand_region_start, int64_t cand_region_end, int window_size,
    int feature_size, int train_mode,
    // downsampling (reservoir, numpy RandomState parity)
    int64_t max_reads, double downsample_rate, uint32_t random_seed,
    // truth records per haplotype (flattened strings)
    int n_t1, const int64_t* t1_pos, const int64_t* t1_end,
    const int32_t* t1_ref_off, const char* t1_ref_buf,
    const int32_t* t1_alt_off, const char* t1_alt_buf,
    int n_t2, const int64_t* t2_pos, const int64_t* t2_end,
    const int32_t* t2_ref_off, const char* t2_ref_buf,
    const int32_t* t2_alt_off, const char* t2_alt_buf) {
  const int64_t L = region_end - region_start + 1;
  const std::string ref_seq(ref_seq_c);
  const int win1 = window_size + 1;
  const int half = window_size / 2;
  SectionTimer prof;
  g_calls.fetch_add(1, std::memory_order_relaxed);

  // ---- fetch + trim (+ reservoir downsample on the raw fetched reads) ----
  std::vector<TrimmedReadN> reads;
  {
    std::vector<TrimmedReadN> all;
    TrimmedReadN tr;
    pep::for_each_record(
        bam_path, chunks, n_chunks, ref_id, fetch_start, fetch_stop,
        include_suppl != 0, min_mapq, [&](const pep::BamRecord& rec) {
          if (pep::trim_record(rec, fetch_start, fetch_stop, tr))
            all.push_back(std::move(tr));  // trim_record re-clears tr
        });
    int64_t total = (int64_t)all.size();
    int64_t allowed = (int64_t)std::min<double>(
        (double)max_reads, downsample_rate * (double)total);
    if (total > allowed) {
      NumpyMT mt;
      // RandomState(int_seed) seeds with plain init_genrand, NOT
      // init_by_array (verified against numpy's raw output stream)
      mt.init_genrand(random_seed);
      mt.mti = 624;
      std::vector<int64_t> sample_idx;
      for (int64_t i = 0; i < total; i++) {
        if ((int64_t)sample_idx.size() < allowed) {
          sample_idx.push_back(i);
        } else {
          int64_t j = (int64_t)mt.bounded((uint64_t)i);  // randint(0, i+1)
          if (j < allowed) sample_idx[j] = i;
        }
      }
      reads.reserve(sample_idx.size());
      for (int64_t i : sample_idx) reads.push_back(std::move(all[i]));
    } else {
      reads = std::move(all);
    }
  }

  prof.lap(g_ns_fetch);

  // ---- event accumulation (port of events.py read_events) ----
  // Accumulate column-major: the per-base walk updates 2-3 fixed columns,
  // so columnar layout turns them into sequential streams (the row-major
  // matrix touches a 104-byte row per base). Transposed to row-major once
  // after the walk; downstream logic is unchanged.
  const int64_t stride = L + 1;
  // int16 counters: every count is bounded by max_reads (5000), and the
  // narrower type doubles the elements per vector op in the walk sweeps
  std::vector<int16_t> cmat((size_t)feature_size * stride, 0);
  auto col = [&](int c) { return cmat.data() + (size_t)c * stride; };
  std::vector<uint8_t> rok(L);
  for (int64_t i = 0; i < L; i++) rok[i] = ref_ok(ref_seq[i]) ? 1 : 0;
  std::vector<int16_t> coverage(L, 0), snp_count(L, 0), insert_count(L, 0),
      delete_count(L, 0);
  // SNP alleles on ACGT read bases dominate (one per mismatch); keep them
  // in flat per-position counters and reserve the string-keyed map for
  // indels and exotic bases. Merged lexicographically at extraction.
  std::vector<std::array<int32_t, 12>> snp_cnt(L);  // [base*3 + {tot,fwd,rev}]
  memset(snp_cnt.data(), 0, snp_cnt.size() * sizeof(snp_cnt[0]));
  std::vector<std::map<std::string, AlleleCount>> alleles(L);

  auto base_code = [](char b) -> int {
    switch (b) {
      case 'A': return 0;
      case 'C': return 1;
      case 'G': return 2;
      case 'T': return 3;
      default: return -1;
    }
  };
  auto add_allele = [&](int64_t idx, const std::string& cand, bool rev) {
    auto& e = alleles[idx][cand];
    e.total += 1;
    if (rev) e.rev += 1; else e.fwd += 1;
  };
  auto add_snp_allele = [&](int64_t idx, char base, bool rev) {
    int bc = base_code(base);
    if (bc < 0) {
      add_allele(idx, std::string("1") + base, rev);
      return;
    }
    auto& e = snp_cnt[idx];
    e[bc * 3] += 1;
    e[bc * 3 + (rev ? 2 : 1)] += 1;
  };

  // span-sized scratch masks for the vectorized M-op passes (pass/mismatch
  // per base); sized to the longest span on demand, reused across reads
  std::vector<uint8_t> mbuf, mmbuf;
  // Matching passing bases always decrement the column of the REFERENCE
  // letter at that position — read-independent, so they are accumulated
  // per position (by strand) during the walk and scattered into the
  // strand columns once per region afterwards. Only mismatching /
  // non-ACGT read bases touch their data-dependent column in the walk.
  std::vector<int16_t> refhit_fwd(L, 0), refhit_rev(L, 0);
  for (const auto& read : reads) {
    if (read.mapq <= 0) continue;
    const bool rev = (read.flag & pep::FLAG_REVERSE) != 0;
    const int start_col = rev ? REV_START : FWD_START;
    const int ref_col = rev ? 15 : 4;
    int64_t read_index = 0;
    int64_t ref_position = read.pos;
    const auto& cig = read.cigar;
    for (size_t ci = 0; ci < cig.size(); ci++) {
      auto [op, length] = cig[ci];
      if (ref_position > region_end) break;
      if (op == pep::OP_M || op == pep::OP_EQ || op == pep::OP_X) {
        int64_t skip = 0;
        if (ref_position < region_start) {
          skip = std::min<int64_t>(region_start - ref_position, length);
          read_index += skip;
          ref_position += skip;
        }
        int64_t n = length - skip;
        if (n <= 0) continue;
        int64_t n_in = std::min<int64_t>(n, region_end - ref_position + 1);
        // integer threshold: quals are integers, so bq < t  <=>  bq < ceil(t)
        const int bq_thr = (int)std::ceil(min_snp_baseq);
        const char* sp = read.seq.data() + read_index;
        const uint8_t* qp = read.qual.data() + read_index;
        const int64_t idx0 = ref_position - region_start;
        const int8_t* off = BASE_OFFSET.t;
        const int strand_start = rev ? REV_START : FWD_START;
        // the last in-region base anchors a following IN/DEL: its ref
        // column is skipped (region_summary.cpp anchor rule); peel that
        // base out so the hot loop stays branch-light
        const bool last_anchors =
            (n_in > 0 && n_in == n && ci != cig.size() - 1 &&
             (cig[ci + 1].first == pep::OP_I ||
              cig[ci + 1].first == pep::OP_D));
        const int64_t n_main = last_anchors ? n_in - 1 : n_in;
        int16_t* refc = col(ref_col) + idx0;
        int16_t* covp = coverage.data() + idx0;
        int16_t* snpp = snp_count.data() + idx0;
        const char* rp = ref_seq.data() + idx0;
        const uint8_t* rkp = rok.data() + idx0;
        int16_t* strand_cols[8];
        for (int o = 0; o < 8; o++)
          strand_cols[o] = col(strand_start + o) + idx0;
        // The span loop is restructured into branch-free passes that g++
        // auto-vectorizes (the original per-base scatter was the single
        // hottest loop in the pipeline); only mismatches (~error rate) and
        // non-ACGT read bases fall back to scalar handling. Semantics are
        // bit-identical (tests/test_native_encode.py).
        if ((int64_t)mbuf.size() < n_main) {
          mbuf.resize(n_main);
          mmbuf.resize(n_main);
        }
        uint8_t* m = mbuf.data();
        uint8_t* mm = mmbuf.data();
        int16_t* rh = (rev ? refhit_rev : refhit_fwd).data() + idx0;
        // single-purpose passes, NOT one fused loop: g++ auto-vectorizes
        // each of these simple sweeps, while the fused equivalent (5
        // output streams, mixed u8/i32) measured ~1.5x SLOWER — the spans
        // are L1-resident so extra sweeps are cheap, vector width is not
        for (int64_t k = 0; k < n_main; k++)
          m[k] = (uint8_t)(qp[k] >= bq_thr);
        for (int64_t k = 0; k < n_main; k++) covp[k] += m[k];
        for (int64_t k = 0; k < n_main; k++) refc[k] -= m[k];
        for (int64_t k = 0; k < n_main; k++)
          mm[k] = (uint8_t)(m[k] & (uint8_t)(sp[k] != rp[k]));
        for (int64_t k = 0; k < n_main; k++) snpp[k] += mm[k];
        // matching passing bases: batched per-position (scattered into
        // the ref letter's strand column after the walk)
        for (int64_t k = 0; k < n_main; k++)
          rh[k] += (int16_t)((uint8_t)(m[k] ^ mm[k]) & rkp[k]);
        // mismatching / non-ACGT read bases: scalar (rare)
        for (int64_t k = 0; k < n_main; k++) {
          if (mm[k]) {
            add_snp_allele(idx0 + k, sp[k], rev);
            if (rkp[k]) strand_cols[off[(unsigned char)sp[k]]][k] -= 1;
          }
        }
        if (last_anchors) {
          const int64_t k = n_in - 1;
          if ((int)qp[k] >= bq_thr) {
            covp[k] += 1;  // ref column skipped for the anchor base
            const char base = sp[k];
            if (rkp[k]) strand_cols[off[(unsigned char)base]][k] -= 1;
            if (base != rp[k]) {
              snpp[k] += 1;
              add_snp_allele(idx0 + k, base, rev);
            }
          }
        }
        read_index += n;
        ref_position += n;
      } else if (op == pep::OP_I) {
        int64_t anchor = ref_position - 1;
        if (anchor >= region_start && anchor <= region_end &&
            read_index - 1 >= 0) {
          int64_t aidx = anchor - region_start;
          int64_t alen = length + 1;
          int64_t s0 = read_index - 1;
          double qsum = 0;
          for (int64_t k = 0; k < alen; k++) qsum += read.qual[s0 + k];
          if (qsum >= min_indel_baseq * alen &&
              read.qual[s0] < min_snp_baseq)
            coverage[aidx] += 1;
          std::string cand = "2" + std::string(read.seq.data() + s0, alen);
          if ((int64_t)cand.size() <= 61 && qsum >= min_indel_baseq * alen) {
            if (rok[aidx])
              col((rev ? REV_START : FWD_START) + 5)[aidx] -= 1;  // 'I'
            insert_count[aidx] += 1;
            add_allele(aidx, cand, rev);
          }
        }
        read_index += length;
      } else if (op == pep::OP_D) {
        int64_t anchor = ref_position - 1;
        if (anchor >= region_start && anchor <= region_end) {
          int64_t aidx = anchor - region_start;
          if (rok[aidx])
            col((rev ? REV_START : FWD_START) + 6)[aidx] -= 1;  // 'D'
          int64_t take = std::min<int64_t>(length + 1, L - aidx);
          std::string cand = "3" + ref_seq.substr(aidx, take);
          if ((int64_t)cand.size() <= 61) {
            delete_count[aidx] += 1;
            add_allele(aidx, cand, rev);
          }
        }
        int64_t lo = std::max(ref_position, region_start);
        int64_t hi = std::min(ref_position + length - 1, region_end);
        int16_t* starc = col((rev ? REV_START : FWD_START) + 7);  // '*'
        for (int64_t p = lo; p <= hi; p++) {
          int64_t idx = p - region_start;
          if (rok[idx]) starc[idx] -= 1;
        }
        ref_position += length;
      } else if (op == pep::OP_N || op == pep::OP_P) {
        // REF_SKIP/PAD fall through to SOFT_CLIP (reference switch quirk)
        ref_position += length;
        read_index += length;
      } else if (op == pep::OP_S) {
        read_index += length;
      }
    }
  }

  // scatter the batched match counts into the ref letter's strand column
  // (one pass over the region instead of one update per read base)
  {
    const int8_t* off = BASE_OFFSET.t;
    for (int64_t i = 0; i < L; i++) {
      const int o = off[(unsigned char)ref_seq[i]];
      if (refhit_fwd[i]) col(FWD_START + o)[i] -= refhit_fwd[i];
      if (refhit_rev[i]) col(REV_START + o)[i] -= refhit_rev[i];
    }
  }
  prof.lap(g_ns_walk);

  // ---- transpose the columnar accumulator into the row-major matrix ----
  std::vector<int32_t> matrix((size_t)(L + 1) * feature_size, 0);
  {
    std::vector<const int16_t*> cp(feature_size);
    for (int c = 0; c < feature_size; c++) cp[c] = col(c);
    for (int64_t i = 0; i < L; i++) {
      int32_t* row = matrix.data() + (size_t)i * feature_size;
      row[0] = ref_value(ref_seq[i]);
      for (int c = 1; c < feature_size; c++) row[c] = cp[c][i];
    }
  }

  // ---- site thresholds + clamp (region_encoder.py generate_summary) ----
  std::vector<int64_t> filtered;
  std::vector<uint8_t> snp_pass(L, 0), ins_pass(L, 0), del_pass(L, 0);
  for (int64_t i = 0; i < L; i++) {
    double cov = std::max(1.0, (double)coverage[i]);
    bool sp = snp_count[i] / cov >= snp_freq;
    bool ip = insert_count[i] / cov >= ins_freq;
    bool dp = delete_count[i] / cov >= del_freq;
    if (sp || ip || dp) {
      int64_t pos = region_start + i;
      if (pos >= cand_region_start && pos <= cand_region_end &&
          coverage[i] >= min_cov) {
        filtered.push_back(i);
        if (sp) snp_pass[i] = 1;
        if (ip) ins_pass[i] = 1;
        if (dp) del_pass[i] = 1;
      }
    }
    for (int j = BASE_INDEX_START; j < BASE_INDEX_START + BASE_INDEX_SIZE; j++) {
      int32_t& v = matrix[(size_t)i * feature_size + j];
      v = std::min(std::max(v, (int32_t)MINV), (int32_t)MAXV);
    }
  }

  // ---- train labels (region_encoder.py generate_labels) ----
  std::vector<TruthRec> truth[2];
  std::vector<uint8_t> labels_hp[2];
  std::vector<int32_t> types_hp[2];
  std::vector<std::vector<int32_t>> truth_at[2];
  std::vector<int32_t> labels, labels_type;
  if (train_mode) {
    auto load = [&](int n, const int64_t* tp, const int64_t* te,
                    const int32_t* ro, const char* rb, const int32_t* ao,
                    const char* ab, int h) {
      for (int i = 0; i < n; i++)
        truth[h].push_back(TruthRec{
            tp[i], te[i],
            std::string(rb + ro[i], ro[i + 1] - ro[i]),
            std::string(ab + ao[i], ao[i + 1] - ao[i])});
    };
    load(n_t1, t1_pos, t1_end, t1_ref_off, t1_ref_buf, t1_alt_off, t1_alt_buf, 0);
    load(n_t2, t2_pos, t2_end, t2_ref_off, t2_ref_buf, t2_alt_off, t2_alt_buf, 1);
    for (int h = 0; h < 2; h++) {
      labels_hp[h].assign(L + 1, '*');
      types_hp[h].assign(L + 1, 0);
      truth_at[h].assign(L + 1, {});
      for (int64_t i = 0; i < L; i++) labels_hp[h][i] = 'R';
      for (size_t r = 0; r < truth[h].size(); r++) {
        const TruthRec& rec = truth[h][r];
        int64_t idx = rec.pos_start - region_start;
        if (rec.ref.size() > rec.alt.size()) {
          if (idx >= 0 && idx < L) {
            types_hp[h][idx] = 3;
            labels_hp[h][idx] = '#';
            truth_at[h][idx].push_back((int32_t)r);
          }
        } else if (rec.ref.size() < rec.alt.size()) {
          if (idx >= 0 && idx < L) {
            types_hp[h][idx] = 2;
            labels_hp[h][idx] = '*';
            truth_at[h][idx].push_back((int32_t)r);
          }
        } else {
          if (idx >= 0 && idx < L) {
            types_hp[h][idx] = 1;
            truth_at[h][idx].push_back((int32_t)r);
          }
          for (int64_t pos = rec.pos_start; pos < rec.pos_end; pos++) {
            if (pos >= region_start && pos <= region_end) {
              int64_t i = pos - region_start;
              char alt_base = rec.alt[pos - rec.pos_start];
              labels_hp[h][i] = (ref_seq[i] == alt_base) ? 'R' : alt_base;
            }
          }
        }
      }
    }
    labels.assign(L + 1, 0);
    labels_type.assign(L + 1, 0);
    for (int64_t i = 0; i <= L; i++) {
      labels[i] = get_label_index((char)labels_hp[0][i], (char)labels_hp[1][i]);
      labels_type[i] = type_label_index(types_hp[0][i], types_hp[1][i]);
    }
  }

  prof.lap(g_ns_site);

  // ---- candidate windows ----
  // Two passes: count gate-passing alleles, then render each window
  // directly into the result buffers (no staging copy, no vector growth).
  std::vector<std::pair<std::string, AlleleCount>> site;
  static const char* SNP_KEYS[4] = {"1A", "1C", "1G", "1T"};
  auto collect_site = [&](int64_t idx) {
    // merged lexicographic view of the site map + flat SNP counters
    site.clear();
    for (const auto& [cand, ac] : alleles[idx]) site.emplace_back(cand, ac);
    const auto& e = snp_cnt[idx];
    for (int bc = 0; bc < 4; bc++)
      if (e[bc * 3] > 0)
        site.emplace_back(SNP_KEYS[bc], AlleleCount{e[bc * 3], e[bc * 3 + 1],
                                                    e[bc * 3 + 2]});
    std::sort(site.begin(), site.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
  };
  auto gate = [&](int64_t idx, const std::string& cand, const AlleleCount& ac,
                  int depth) {
    char ctype = cand[0];
    double freq = ac.total / std::max(1.0, (double)depth);
    if (ac.total < cand_support) return false;
    if (ctype != '1' && freq < indel_cand_freq) return false;
    if (ctype == '1' && freq < snp_cand_freq) return false;
    if (ctype != '1' && skip_indels) return false;
    if ((ctype == '1' && !snp_pass[idx]) ||
        (ctype == '2' && !ins_pass[idx]) ||
        (ctype == '3' && !del_pass[idx]))
      return false;
    return true;
  };

  int64_t n_cands = 0, cand_bytes = 0;
  for (int64_t idx : filtered) {
    int depth = std::min<int32_t>(coverage[idx], MAXV);
    collect_site(idx);
    for (const auto& [cand, ac] : site)
      if (gate(idx, cand, ac, depth)) {
        n_cands++;
        cand_bytes += (int64_t)cand.size();
      }
  }

  auto* r = (EncodeResult*)calloc(1, sizeof(EncodeResult));
  if (!r) return nullptr;
  r->n = (int32_t)n_cands;
  r->window1 = win1;
  r->features = feature_size;
  r->positions = (int64_t*)malloc((size_t)n_cands * 8 + 1);
  r->depths = (int32_t*)malloc((size_t)n_cands * 4 + 1);
  r->type_labels = (int32_t*)malloc((size_t)n_cands * 4 + 1);
  r->base_labels = (int32_t*)malloc((size_t)n_cands * 4 + 1);
  r->cand_freqs = (int32_t*)malloc((size_t)n_cands * 4 + 1);
  r->cand_offsets = (int32_t*)malloc(((size_t)n_cands + 1) * 4 + 1);
  r->cand_buf = (char*)malloc((size_t)cand_bytes + 1);
  r->images =
      (int8_t*)malloc((size_t)n_cands * win1 * feature_size + 1);
  if (!r->positions || !r->depths || !r->type_labels || !r->base_labels ||
      !r->cand_freqs || !r->cand_offsets || !r->cand_buf || !r->images) {
    encode_result_free(r);  // frees whichever members did allocate
    return nullptr;
  }
  r->cand_offsets[0] = 0;
  r->cand_buf_len = cand_bytes;

  int64_t ci = 0, cb = 0;
  for (int64_t idx : filtered) {
    int64_t pos = region_start + idx;
    int depth = std::min<int32_t>(coverage[idx], MAXV);
    collect_site(idx);
    for (const auto& [cand, ac] : site) {
      if (!gate(idx, cand, ac, depth)) continue;
      char ctype = cand[0];

      int base_label = 0, type_label = 0;
      if (train_mode) {
        bool found[2] = {false, false};
        for (int h = 0; h < 2; h++)
          for (int32_t t : truth_at[h][idx])
            if (truth_candidate_string(truth[h][t]) == cand) found[h] = true;
        type_label =
            (found[0] && found[1]) ? 2 : ((found[0] || found[1]) ? 1 : 0);
        base_label = labels[idx];
      }

      int8_t* img = r->images + (size_t)ci * win1 * feature_size;
      memset(img, 0, (size_t)win1 * feature_size);
      int64_t lo = idx - half;
      int64_t src_lo = std::max<int64_t>(lo, 0);
      int64_t src_hi = std::min<int64_t>(idx + half, L) + 1;
      if (src_hi > src_lo) {
        const int32_t* src = matrix.data() + (size_t)src_lo * feature_size;
        int8_t* dst = img + (src_lo - lo) * feature_size;
        const int64_t cnt = (src_hi - src_lo) * feature_size;
        for (int64_t k = 0; k < cnt; k++) dst[k] = (int8_t)src[k];
      }

      char ref_base = ref_seq[idx];
      int mid = half;
      int fwd_c = std::min(ac.fwd, MAXV), rev_c = std::min(ac.rev, MAXV);
      auto M = [&](int row, int c) -> int8_t& {
        return img[(size_t)row * feature_size + c];
      };
      if (ctype == '1') {
        int ffi = feature_index(ref_base, cand[1], false);
        int rfi = feature_index(ref_base, cand[1], true);
        M(mid, 1) = ref_value(cand[1]);
        M(mid, 5) = fwd_c;
        M(mid, 16) = rev_c;
        if (ffi >= 0) { M(mid, ffi) = -M(mid, ffi); M(mid, rfi) = -M(mid, rfi); }
      } else if (ctype == '2') {
        int ffi = feature_index(ref_base, 'I', false);
        int rfi = feature_index(ref_base, 'I', true);
        M(mid, 2) = std::min((int)cand.size() - 1, MAXV);
        M(mid, 6) = fwd_c;
        M(mid, 17) = rev_c;
        if (ffi >= 0) { M(mid, ffi) = -M(mid, ffi); M(mid, rfi) = -M(mid, rfi); }
      } else {
        int del_len = (int)cand.size() - 1;
        int end_index = std::min(mid + del_len - 1, window_size - 1);
        int ffi = feature_index(ref_base, 'D', false);
        int rfi = feature_index(ref_base, 'D', true);
        M(mid, 3) = std::min(del_len, MAXV);
        M(mid, 7) = fwd_c;
        M(mid, 18) = rev_c;
        if (ffi >= 0) { M(mid, ffi) = -M(mid, ffi); M(mid, rfi) = -M(mid, rfi); }
        int sfi = feature_index(ref_base, '*', false);
        int sri = feature_index(ref_base, '*', true);
        for (int w = mid + 1; w <= end_index; w++) {
          M(w, 3) = std::min(del_len, MAXV);
          M(w, 7) = fwd_c;
          M(w, 18) = rev_c;
          if (sfi >= 0) { M(w, sfi) = -M(w, sfi); M(w, sri) = -M(w, sri); }
        }
      }

      r->positions[ci] = pos;
      r->depths[ci] = depth;
      r->type_labels[ci] = type_label;
      r->base_labels[ci] = base_label;
      r->cand_freqs[ci] = std::min(ac.total, MAXV);
      memcpy(r->cand_buf + cb, cand.data(), cand.size());
      cb += (int64_t)cand.size();
      r->cand_offsets[ci + 1] = (int32_t)cb;
      ci++;
    }
  }
  // The count pass and the render pass must stay in exact lockstep (same
  // collect_site/gate outcomes); if a future edit makes them diverge, fail
  // cleanly instead of silently overrunning the preallocated buffers.
  if (ci != n_cands || cb != cand_bytes) {
    encode_result_free(r);
    return nullptr;
  }
  prof.lap(g_ns_windows);
  return r;
}

}  // extern "C"


// ---------------------------------------------------------------------------
// PEPPER-HP fused encoder — port of the tested oracle
// pepper_tpu/encode/region_encoder_hp.py (48-feature dual-haplotype windows;
// see that file's docstring for the HP-specific semantics preserved here).
// ---------------------------------------------------------------------------

namespace {

struct AlleleCountHP { int total = 0, f1 = 0, f2 = 0, r1 = 0, r2 = 0; };

inline int feature_index_hp(char ref_base, char base, bool rev, int block) {
  if (!ref_ok(ref_base)) return -1;
  int start = (block == 1) ? (rev ? 18 : 7) : (rev ? 40 : 29);
  switch (base) {
    case 'A': return start + 1;
    case 'C': return start + 2;
    case 'G': return start + 3;
    case 'T': return start + 4;
    case 'I': return start + 5;
    case 'D': return start + 6;
    default: return start + 7;
  }
}

}  // namespace

extern "C" EncodeResult* encode_region_hp(
    const char* bam_path, const uint64_t* chunks, int n_chunks,
    int32_t ref_id, int64_t fetch_start, int64_t fetch_stop,
    int64_t region_start, int64_t region_end, const char* ref_seq_c,
    int include_suppl, int min_mapq,
    double min_snp_baseq, double min_indel_baseq, double snp_freq,
    double ins_freq, double del_freq, double min_cov, double snp_cand_freq,
    double indel_cand_freq, double cand_support, int skip_indels,
    int64_t cand_region_start, int64_t cand_region_end, int window_size,
    int feature_size, int train_mode,
    int64_t max_reads, double downsample_rate, uint32_t random_seed,
    int n_t1, const int64_t* t1_pos, const int64_t* t1_end,
    const int32_t* t1_ref_off, const char* t1_ref_buf,
    const int32_t* t1_alt_off, const char* t1_alt_buf,
    int n_t2, const int64_t* t2_pos, const int64_t* t2_end,
    const int32_t* t2_ref_off, const char* t2_ref_buf,
    const int32_t* t2_alt_off, const char* t2_alt_buf) {
  const int64_t L = region_end - region_start + 1;
  const std::string ref_seq(ref_seq_c);
  const int win1 = window_size + 1;
  const int half = window_size / 2;

  // ---- fetch + trim + reservoir (identical to encode_region) ----
  std::vector<TrimmedReadN> reads;
  {
    std::vector<TrimmedReadN> all;
    TrimmedReadN tr;
    pep::for_each_record(
        bam_path, chunks, n_chunks, ref_id, fetch_start, fetch_stop,
        include_suppl != 0, min_mapq, [&](const pep::BamRecord& rec) {
          if (pep::trim_record(rec, fetch_start, fetch_stop, tr))
            all.push_back(std::move(tr));  // trim_record re-clears tr
        });
    int64_t total = (int64_t)all.size();
    int64_t allowed = (int64_t)std::min<double>(
        (double)max_reads, downsample_rate * (double)total);
    if (total > allowed) {
      NumpyMT mt;
      mt.init_genrand(random_seed);
      mt.mti = 624;
      std::vector<int64_t> sample_idx;
      for (int64_t i = 0; i < total; i++) {
        if ((int64_t)sample_idx.size() < allowed) {
          sample_idx.push_back(i);
        } else {
          int64_t j = (int64_t)mt.bounded((uint64_t)i);
          if (j < allowed) sample_idx[j] = i;
        }
      }
      reads.reserve(sample_idx.size());
      for (int64_t i : sample_idx) reads.push_back(std::move(all[i]));
    } else {
      reads = std::move(all);
    }
  }

  std::vector<int32_t> matrix((size_t)(L + 1) * feature_size, 0);
  for (int64_t i = 0; i < L; i++)
    matrix[(size_t)i * feature_size] = ref_value(ref_seq[i]);
  std::vector<int16_t> coverage(L, 0), snp_count(L, 0), insert_count(L, 0),
      delete_count(L, 0);
  std::vector<std::map<std::string, AlleleCountHP>> alleles(L);

  auto add_allele = [&](int64_t idx, const std::string& cand, bool rev,
                        int hp_tag) {
    auto& e = alleles[idx][cand];
    e.total += 1;
    if (hp_tag == 0 || hp_tag == 1) { if (rev) e.r1 += 1; else e.f1 += 1; }
    if (hp_tag == 0 || hp_tag == 2) { if (rev) e.r2 += 1; else e.f2 += 1; }
  };

  for (const auto& read : reads) {
    if (read.mapq <= 0) continue;
    const bool rev = (read.flag & pep::FLAG_REVERSE) != 0;
    const int hp = read.hp;
    const bool b1 = (hp == 0 || hp == 1), b2 = (hp == 0 || hp == 2);
    int64_t read_index = 0;
    int64_t ref_position = read.pos;
    const auto& cig = read.cigar;
    for (size_t ci = 0; ci < cig.size(); ci++) {
      auto [op, length] = cig[ci];
      if (ref_position > region_end) break;
      if (op == pep::OP_M || op == pep::OP_EQ || op == pep::OP_X) {
        for (int64_t k = 0; k < length; k++) {
          if (ref_position >= region_start && ref_position <= region_end) {
            int64_t idx = ref_position - region_start;
            char base = read.seq[read_index];
            char rbase = ref_seq[idx];
            double bq = read.qual[read_index];
            if (bq >= min_snp_baseq) {
              coverage[idx] += 1;
              if (b1) matrix[(size_t)idx * feature_size + (rev ? 15 : 4)] -= 1;
              if (b2) matrix[(size_t)idx * feature_size + (rev ? 37 : 26)] -= 1;
              if (rbase != base) {
                snp_count[idx] += 1;
                add_allele(idx, std::string("1") + base, rev, hp);
              } else {
                if (b1) {
                  int fi = feature_index_hp(rbase, base, rev, 1);
                  if (fi >= 0) matrix[(size_t)idx * feature_size + fi] -= 1;
                }
                if (b2) {
                  int fi = feature_index_hp(rbase, base, rev, 2);
                  if (fi >= 0) matrix[(size_t)idx * feature_size + fi] -= 1;
                }
              }
            }
          }
          read_index += 1;
          ref_position += 1;
        }
      } else if (op == pep::OP_I) {
        int64_t anchor = ref_position - 1;
        if (anchor >= region_start && anchor <= region_end &&
            read_index - 1 >= 0) {
          int64_t aidx = anchor - region_start;
          std::string alt(read.seq.data() + read_index - 1, length + 1);
          double qsum = 0;
          for (int64_t k = 0; k < length; k++)
            qsum += read.qual[read_index + k];
          if (qsum < min_indel_baseq * length &&
              read.qual[read_index - 1] >= min_snp_baseq)
            coverage[aidx] -= 1;
          std::string cand = "2" + alt;
          if ((int64_t)cand.size() <= 61 && qsum >= min_indel_baseq * length) {
            if (b1) {
              int fi = feature_index_hp(ref_seq[aidx], 'I', rev, 1);
              if (fi >= 0) matrix[(size_t)aidx * feature_size + fi] += 1;
            }
            if (b2) {
              int fi = feature_index_hp(ref_seq[aidx], 'I', rev, 2);
              if (fi >= 0) matrix[(size_t)aidx * feature_size + fi] += 1;
            }
            insert_count[aidx] += 1;
            add_allele(aidx, cand, rev, hp);
          }
        }
        read_index += length;
      } else if (op == pep::OP_D) {
        int64_t anchor = ref_position - 1;
        if (anchor >= region_start && anchor <= region_end) {
          int64_t aidx = anchor - region_start;
          if (b1) {
            int fi = feature_index_hp(ref_seq[aidx], 'D', rev, 1);
            if (fi >= 0) matrix[(size_t)aidx * feature_size + fi] += 1;
          }
          if (b2) {
            int fi = feature_index_hp(ref_seq[aidx], 'D', rev, 2);
            if (fi >= 0) matrix[(size_t)aidx * feature_size + fi] += 1;
          }
          int64_t take = std::min<int64_t>(length + 1, L - aidx);
          std::string cand = "3" + ref_seq.substr(aidx, take);
          if ((int64_t)cand.size() <= 61) {
            delete_count[aidx] += 1;
            add_allele(aidx, cand, rev, hp);
          }
        }
        int64_t lo = std::max(ref_position, region_start);
        int64_t hi = std::min(ref_position + length - 1, region_end);
        for (int64_t p = lo; p <= hi; p++) {
          int64_t idx = p - region_start;
          if (b1) {
            int fi = feature_index_hp(ref_seq[idx], '*', rev, 1);
            if (fi >= 0) matrix[(size_t)idx * feature_size + fi] += 1;
          }
          if (b2) {
            int fi = feature_index_hp(ref_seq[idx], '*', rev, 2);
            if (fi >= 0) matrix[(size_t)idx * feature_size + fi] += 1;
          }
        }
        ref_position += length;
      } else if (op == pep::OP_N || op == pep::OP_P) {
        ref_position += length;
        read_index += length;
      } else if (op == pep::OP_S) {
        read_index += length;
      }
    }
  }

  // thresholds + clamp ALL columns
  std::vector<int64_t> filtered;
  std::vector<uint8_t> snp_pass(L, 0), ins_pass(L, 0), del_pass(L, 0);
  for (int64_t i = 0; i < L; i++) {
    double cov = std::max(1.0, (double)coverage[i]);
    bool sp = snp_count[i] / cov >= snp_freq;
    bool ip = insert_count[i] / cov >= ins_freq;
    bool dp = delete_count[i] / cov >= del_freq;
    if (sp || ip || dp) {
      int64_t pos = region_start + i;
      if (pos >= cand_region_start && pos <= cand_region_end &&
          coverage[i] >= min_cov) {
        filtered.push_back(i);
        if (sp) snp_pass[i] = 1;
        if (ip) ins_pass[i] = 1;
        if (dp) del_pass[i] = 1;
      }
    }
    for (int j = 0; j < feature_size; j++) {
      int32_t& v = matrix[(size_t)i * feature_size + j];
      v = std::min(std::max(v, (int32_t)MINV), (int32_t)MAXV);
    }
  }

  // train labels (same shape as the base encoder)
  std::vector<TruthRec> truth[2];
  std::vector<uint8_t> labels_hp[2];
  std::vector<int32_t> types_hp[2];
  std::vector<std::vector<int32_t>> truth_at[2];
  std::vector<int32_t> labels, labels_type;
  if (train_mode) {
    auto load = [&](int n, const int64_t* tp, const int64_t* te,
                    const int32_t* ro, const char* rb, const int32_t* ao,
                    const char* ab, int h) {
      for (int i = 0; i < n; i++)
        truth[h].push_back(TruthRec{
            tp[i], te[i],
            std::string(rb + ro[i], ro[i + 1] - ro[i]),
            std::string(ab + ao[i], ao[i + 1] - ao[i])});
    };
    load(n_t1, t1_pos, t1_end, t1_ref_off, t1_ref_buf, t1_alt_off, t1_alt_buf, 0);
    load(n_t2, t2_pos, t2_end, t2_ref_off, t2_ref_buf, t2_alt_off, t2_alt_buf, 1);
    for (int h = 0; h < 2; h++) {
      labels_hp[h].assign(L + 1, '*');
      types_hp[h].assign(L + 1, 0);
      truth_at[h].assign(L + 1, {});
      for (int64_t i = 0; i < L; i++) labels_hp[h][i] = 'R';
      for (size_t r = 0; r < truth[h].size(); r++) {
        const TruthRec& rec = truth[h][r];
        int64_t idx = rec.pos_start - region_start;
        if (rec.ref.size() > rec.alt.size()) {
          if (idx >= 0 && idx < L) {
            types_hp[h][idx] = 3;
            labels_hp[h][idx] = '#';
            truth_at[h][idx].push_back((int32_t)r);
          }
        } else if (rec.ref.size() < rec.alt.size()) {
          if (idx >= 0 && idx < L) {
            types_hp[h][idx] = 2;
            labels_hp[h][idx] = '*';
            truth_at[h][idx].push_back((int32_t)r);
          }
        } else {
          if (idx >= 0 && idx < L) {
            types_hp[h][idx] = 1;
            truth_at[h][idx].push_back((int32_t)r);
          }
          for (int64_t pos = rec.pos_start; pos < rec.pos_end; pos++) {
            if (pos >= region_start && pos <= region_end) {
              int64_t i = pos - region_start;
              char alt_base = rec.alt[pos - rec.pos_start];
              labels_hp[h][i] = (ref_seq[i] == alt_base) ? 'R' : alt_base;
            }
          }
        }
      }
    }
    labels.assign(L + 1, 0);
    labels_type.assign(L + 1, 0);
    for (int64_t i = 0; i <= L; i++) {
      labels[i] = get_label_index((char)labels_hp[0][i], (char)labels_hp[1][i]);
      labels_type[i] = type_label_index(types_hp[0][i], types_hp[1][i]);
    }
  }

  // candidate windows (21x48; per-HP supports at the midpoint, no sign flips)
  Out out;
  out.cand_offsets.push_back(0);
  std::vector<int8_t> image((size_t)win1 * feature_size);
  for (int64_t idx : filtered) {
    int64_t pos = region_start + idx;
    int depth = std::min<int32_t>(coverage[idx], MAXV);
    for (const auto& [cand, ac] : alleles[idx]) {
      char ctype = cand[0];
      double freq = ac.total / std::max(1.0, (double)depth);
      if (ac.total < cand_support) continue;
      if (ctype != '1' && freq < indel_cand_freq) continue;
      if (ctype == '1' && freq < snp_cand_freq) continue;
      if (ctype != '1' && skip_indels) continue;
      if ((ctype == '1' && !snp_pass[idx]) ||
          (ctype == '2' && !ins_pass[idx]) ||
          (ctype == '3' && !del_pass[idx]))
        continue;

      int base_label = 0, type_label = 0;
      if (train_mode) {
        bool found[2] = {false, false};
        for (int h = 0; h < 2; h++)
          for (int32_t r : truth_at[h][idx])
            if (truth_candidate_string(truth[h][r]) == cand) found[h] = true;
        type_label = (found[0] && found[1]) ? 2
                     : ((found[0] || found[1]) ? 1 : 0);
        base_label = labels[idx];
      }

      std::fill(image.begin(), image.end(), (int8_t)0);
      int64_t lo = idx - half;
      int64_t src_lo = std::max<int64_t>(lo, 0);
      int64_t src_hi = std::min<int64_t>(idx + half, L) + 1;
      if (src_hi > src_lo) {
        const int32_t* src = matrix.data() + (size_t)src_lo * feature_size;
        int8_t* dst = image.data() + (src_lo - lo) * feature_size;
        const int64_t cnt = (src_hi - src_lo) * feature_size;
        for (int64_t k = 0; k < cnt; k++) dst[k] = (int8_t)src[k];
      }

      int mid = half;
      auto M = [&](int r, int c) -> int8_t& {
        return image[(size_t)r * feature_size + c];
      };
      int c1 = std::min(ac.f1, MAXV), c2 = std::min(ac.f2, MAXV);
      int c3 = std::min(ac.r1, MAXV), c4 = std::min(ac.r2, MAXV);
      if (ctype == '1') {
        M(mid, 1) = ref_value(cand[1]);
        M(mid, 5) = c1;  M(mid, 27) = c2;
        M(mid, 16) = c3; M(mid, 38) = c4;
      } else if (ctype == '2') {
        M(mid, 2) = std::min((int)cand.size() - 1, MAXV);
        M(mid, 6) = c1;  M(mid, 28) = c2;
        M(mid, 17) = c3; M(mid, 39) = c4;
      } else {
        M(mid, 3) = std::min((int)cand.size() - 1, MAXV);
        M(mid, 7) = c1;  M(mid, 29) = c2;
        M(mid, 18) = c3; M(mid, 40) = c4;
      }

      out.positions.push_back(pos);
      out.depths.push_back(depth);
      out.type_labels.push_back(type_label);
      out.base_labels.push_back(base_label);
      out.cand_freqs.push_back(std::min(ac.total, MAXV));
      out.cand_buf.insert(out.cand_buf.end(), cand.begin(), cand.end());
      out.cand_offsets.push_back((int32_t)out.cand_buf.size());
      out.images.insert(out.images.end(), image.begin(), image.end());
    }
  }

  auto* r = (EncodeResult*)calloc(1, sizeof(EncodeResult));
  if (!r) return nullptr;
  r->n = (int32_t)out.positions.size();
  r->window1 = win1;
  r->features = feature_size;
  auto cp64 = [](const std::vector<int64_t>& v) -> int64_t* {
    auto* p = (int64_t*)malloc(v.size() * 8 + 1);
    if (p) memcpy(p, v.data(), v.size() * 8);
    return p;
  };
  auto cp32 = [](const std::vector<int32_t>& v) -> int32_t* {
    auto* p = (int32_t*)malloc(v.size() * 4 + 1);
    if (p) memcpy(p, v.data(), v.size() * 4);
    return p;
  };
  r->positions = cp64(out.positions);
  r->depths = cp32(out.depths);
  r->type_labels = cp32(out.type_labels);
  r->base_labels = cp32(out.base_labels);
  r->cand_freqs = cp32(out.cand_freqs);
  r->cand_offsets = cp32(out.cand_offsets);
  auto cp8 = [](const std::vector<int8_t>& v) -> int8_t* {
    auto* p = (int8_t*)malloc(v.size() + 1);
    if (p) memcpy(p, v.data(), v.size());
    return p;
  };
  r->images = cp8(out.images);
  r->cand_buf = (char*)malloc(out.cand_buf.size() + 1);
  if (!r->positions || !r->depths || !r->type_labels || !r->base_labels ||
      !r->cand_freqs || !r->cand_offsets || !r->images || !r->cand_buf) {
    encode_result_free(r);
    return nullptr;
  }
  memcpy(r->cand_buf, out.cand_buf.data(), out.cand_buf.size());
  r->cand_buf_len = (int64_t)out.cand_buf.size();
  return r;
}
