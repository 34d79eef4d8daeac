// Fused native polish pileup encoder: BAM fetch -> trim -> reservoir
// downsample -> (optional) banded realignment -> 10-feature pileup with
// insert-column expansion -> coverage-normalized uint8 image.
//
// Semantics are a port of the tested Python oracle
// (pepper_tpu/polish/summary.py::PolishSummary, itself parity with the
// reference pepper/modules/src/pileup_summary/summary_generator.cpp:47-306);
// tests/test_polish_native.py asserts bit-equality between the two on
// randomized data. Quirks preserved:
//   - feature order A/C/G/T REVERSE first (cols 0-3), forward 4-7, gap
//     rev(8)/fwd(9) (summary_generator.cpp:16-32);
//   - N/P ops treated as DELETE (case fallthrough :103);
//   - a D op of length k bumps coverage by k at the op's START position
//     only (:110);
//   - normalization count/max(1,cov)*254 truncates like numpy's
//     float64 -> uint8 cast (toward zero, then modulo 256).
//
// The realignment pass reuses the banded-Gotoh aligner (align.cpp) in
// process — replacing the Python path's per-read ctypes round trips (the
// role of the reference's in-loop ReadAligner.align_reads_to_reference,
// pepper/modules/python/AlignmentSummarizer.py:328-334).
#include "bam_common.h"

#include <algorithm>
#include <atomic>
#include <chrono>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" int ssw_align_one_banded(const char* ref, int32_t ref_len,
                                    const char* query, int32_t query_len,
                                    int32_t hint, int32_t band,
                                    int32_t* out_ref_offset, uint8_t* out_ops,
                                    int32_t* out_lens, int32_t cap);
extern "C" int ssw_align_one_auto(const char* ref, int32_t ref_len,
                                  const char* query, int32_t query_len,
                                  int32_t hint, int32_t band,
                                  int32_t* out_ref_offset, uint8_t* out_ops,
                                  int32_t* out_lens, int32_t cap);

namespace {

using pep::NumpyMT;
using pep::TrimmedReadN;

constexpr int N_FEATURES = 10;
constexpr double MAX_COLOR = 254.0;

// summary.py get_feature_index: ACGT -> 0-3 (reverse) / 4-7 (forward),
// anything else -> 8 (reverse) / 9 (forward)
inline int feature_index(char base, bool rev) {
  switch (toupper((unsigned char)base)) {
    case 'A': return rev ? 0 : 4;
    case 'C': return rev ? 1 : 5;
    case 'G': return rev ? 2 : 6;
    case 'T': return rev ? 3 : 7;
    default: return rev ? 8 : 9;
  }
}

// numpy float64 -> uint8 element cast: truncate toward zero, wrap mod 256
inline uint8_t np_u8(double v) { return (uint8_t)(int64_t)v; }

constexpr uint16_t FLAG_REVERSE = 16;

// always-on section timers (same pattern as region_encode.cpp): drained
// from Python via polish_prof_get for the bench's polish wall breakdown
std::atomic<int64_t> g_pns_fetch{0}, g_pns_realign{0}, g_pns_pileup{0},
    g_pcalls{0};

struct PSectionTimer {
  std::chrono::steady_clock::time_point t;
  PSectionTimer() : t(std::chrono::steady_clock::now()) {}
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

// Drain the cumulative polish-encode section timers (seconds):
// [fetch+trim+downsample, realign, pileup+render, n_calls].
void polish_prof_get(double* out4) {
  out4[0] = g_pns_fetch.exchange(0) * 1e-9;
  out4[1] = g_pns_realign.exchange(0) * 1e-9;
  out4[2] = g_pns_pileup.exchange(0) * 1e-9;
  out4[3] = (double)g_pcalls.exchange(0);
}

typedef struct {
  int64_t n;          // expanded (position, insert_index) rows
  uint8_t* image;     // n * 10
  int64_t* positions;
  int32_t* indices;
  int64_t n_reads;    // reads in the pileup after downsampling
} PolishEncodeResult;

void polish_encode_result_free(PolishEncodeResult* r) {
  if (!r) return;
  free(r->image);
  free(r->positions);
  free(r->indices);
  free(r);
}

// Shared post-fetch body: reservoir downsample -> realign -> pileup ->
// image render. `reads` are already trimmed to [rs, re] (inclusive).
static PolishEncodeResult* encode_from_reads(
    std::vector<TrimmedReadN>& reads, int64_t rs, int64_t re,
    const char* ref_seq, int64_t ref_len, int realign_flag, int band,
    int64_t max_reads, uint32_t random_seed) {
  const int64_t L = re - rs + 1;
  PSectionTimer prof;
  g_pcalls.fetch_add(1, std::memory_order_relaxed);

  // ---- reservoir downsample (AlignmentSummarizer.py:311-323; fixed
  // numpy RandomState seed, cap = the polish package's MAX_READS) ----
  const int64_t total = (int64_t)reads.size();
  if (total > max_reads) {
    NumpyMT mt;
    mt.init_genrand(random_seed);
    mt.mti = 624;
    std::vector<int64_t> sample_idx;
    for (int64_t i = 0; i < total; i++) {
      if ((int64_t)sample_idx.size() < max_reads) {
        sample_idx.push_back(i);
      } else {
        int64_t j = (int64_t)mt.bounded((uint64_t)i);
        if (j < max_reads) sample_idx[j] = i;
      }
    }
    std::vector<TrimmedReadN> sampled(sample_idx.size());
    for (size_t k = 0; k < sample_idx.size(); k++)
      sampled[k] = std::move(reads[sample_idx[k]]);
    reads = std::move(sampled);
  }

  prof.lap(g_pns_fetch);

  // ---- realignment (polish/realign.py semantics: banded around the BAM
  // anchor, full-matrix fallback, keep-original on failure) ----
  if (realign_flag && ref_len > 0) {
    constexpr int32_t CAP = 4096;
    std::vector<uint8_t> ops(CAP);
    std::vector<int32_t> lens(CAP);
    for (auto& read : reads) {
      const int32_t qlen = (int32_t)read.seq.size();
      const int64_t hint = read.pos - rs;
      int32_t ref_off = 0;
      int n = 0;
      if (band > 0 && hint >= -(int64_t)qlen && hint <= ref_len) {
        n = ssw_align_one_auto(ref_seq, (int32_t)ref_len, read.seq.data(),
                               qlen, (int32_t)hint, band, &ref_off,
                               ops.data(), lens.data(), CAP);
      }
      if (n <= 0) {
        n = ssw_align_one_banded(ref_seq, (int32_t)ref_len, read.seq.data(),
                                 qlen, 0, 0, &ref_off, ops.data(),
                                 lens.data(), CAP);
      }
      if (n <= 0) continue;  // keep original alignment
      read.cigar.clear();
      int64_t ref_span = 0;
      for (int i = 0; i < n; i++) {
        read.cigar.emplace_back((int)ops[i], (int)lens[i]);
        if (ops[i] == pep::OP_M || ops[i] == pep::OP_D ||
            ops[i] == pep::OP_N || ops[i] == pep::OP_EQ ||
            ops[i] == pep::OP_X)
          ref_span += lens[i];
      }
      read.pos = rs + ref_off;
      read.pos_end = read.pos + ref_span;
    }
  }

  prof.lap(g_pns_realign);

  // ---- pileup (summary.py iterate_over_read) ----
  std::vector<std::array<double, N_FEATURES>> base(
      (size_t)L, std::array<double, N_FEATURES>{});
  std::vector<double> coverage((size_t)L, 0.0);
  std::vector<int64_t> longest_insert((size_t)L, 0);
  // insert counts keyed (position_index, insert_index, feature)
  std::unordered_map<uint64_t, double> inserts;
  auto ins_key = [](int64_t idx, int64_t ii, int feat) -> uint64_t {
    return ((uint64_t)idx << 32) | ((uint64_t)ii << 8) | (uint64_t)feat;
  };

  for (const auto& read : reads) {
    if (read.mapq == 0) continue;  // summary_generator.cpp:374 mapq > 0
    const bool rev = (read.flag & FLAG_REVERSE) != 0;
    int64_t read_index = 0;
    int64_t ref_position = read.pos;
    for (auto [op, length] : read.cigar) {
      if (ref_position > re) break;
      if (op == pep::OP_M || op == pep::OP_EQ || op == pep::OP_X) {
        int64_t start_i = 0;
        if (ref_position < rs) {
          start_i = std::min<int64_t>(rs - ref_position, length);
          read_index += start_i;
          ref_position += start_i;
        }
        const int64_t n = length - start_i;
        const int64_t lo = ref_position;
        const int64_t hi = std::min<int64_t>(ref_position + n - 1, re);
        for (int64_t p = lo; p <= hi; p++) {
          const int64_t idx = p - rs;
          const char b = read.seq[(size_t)(read_index + (p - lo))];
          base[idx][feature_index(b, rev)] += 1.0;
          coverage[idx] += 1.0;
        }
        read_index += n;
        ref_position += n;
      } else if (op == pep::OP_I) {
        const int64_t anchor = ref_position - 1;
        if (rs <= anchor && anchor <= re) {
          const int64_t aidx = anchor - rs;
          for (int64_t i = 0; i < length; i++) {
            const char b = read.seq[(size_t)(read_index + i)];
            inserts[ins_key(aidx, i, feature_index(b, rev))] += 1.0;
          }
          longest_insert[aidx] = std::max<int64_t>(longest_insert[aidx],
                                                   length);
        }
        read_index += length;
      } else if (op == pep::OP_D || op == pep::OP_N || op == pep::OP_P) {
        const int64_t lo = std::max<int64_t>(ref_position, rs);
        const int64_t hi = std::min<int64_t>(ref_position + length - 1, re);
        if (hi >= lo) {
          const int col = rev ? 8 : 9;  // feature_index('*', rev)
          for (int64_t p = lo; p <= hi; p++) base[p - rs][col] += 1.0;
          // quirk: coverage bumps at the op start, once per deleted base
          if (rs <= ref_position && ref_position <= re)
            coverage[ref_position - rs] += (double)(hi - lo + 1);
        }
        ref_position += length;
      } else if (op == pep::OP_S) {
        read_index += length;
      }  // OP_H: nothing
    }
  }

  // ---- emit image + genomic positions (summary.py _generate_image /
  // generate_summary) ----
  int64_t n_rows = L;
  for (int64_t i = 0; i < L; i++) n_rows += longest_insert[i];

  auto* out = (PolishEncodeResult*)calloc(1, sizeof(PolishEncodeResult));
  if (!out) return nullptr;
  out->n = n_rows;
  out->n_reads = (int64_t)reads.size();
  out->image = (uint8_t*)malloc((size_t)n_rows * N_FEATURES);
  out->positions = (int64_t*)malloc((size_t)n_rows * sizeof(int64_t));
  out->indices = (int32_t*)malloc((size_t)n_rows * sizeof(int32_t));
  if (!out->image || !out->positions || !out->indices) {
    polish_encode_result_free(out);
    return nullptr;
  }

  int64_t row = 0;
  for (int64_t i = 0; i < L; i++) {
    const double cov = std::max(1.0, coverage[i]);
    uint8_t* px = out->image + row * N_FEATURES;
    for (int j = 0; j < N_FEATURES; j++)
      px[j] = np_u8(base[i][j] / cov * MAX_COLOR);
    out->positions[row] = rs + i;
    out->indices[row] = 0;
    row++;
    for (int64_t ii = 0; ii < longest_insert[i]; ii++) {
      px = out->image + row * N_FEATURES;
      for (int j = 0; j < N_FEATURES; j++) {
        auto it = inserts.find(ins_key(i, ii, j));
        px[j] = np_u8((it == inserts.end() ? 0.0 : it->second) / cov
                      * MAX_COLOR);
      }
      out->positions[row] = rs + i;
      out->indices[row] = (int32_t)(ii + 1);
      row++;
    }
  }
  prof.lap(g_pns_pileup);
  return out;
}

// ref_seq is anchored at region_start and covers at least
// [region_start, region_end + safe_bases) for the realignment pass; the
// pileup itself never reads it. Region bounds are INCLUSIVE (the Python
// PolishSummary(ref_start, ref_end) convention).
PolishEncodeResult* polish_encode_region(
    const char* bam_path, const uint64_t* chunks, int n_chunks,
    int32_t ref_id, int64_t region_start, int64_t region_end,
    const char* ref_seq, int64_t ref_len, int realign_flag, int band,
    int64_t max_reads, uint32_t random_seed) {
  const int64_t rs = region_start, re = region_end;
  if (re - rs + 1 <= 0) return nullptr;
  PSectionTimer prof;

  // ---- fetch + trim (AlignmentSummarizer.py:300-306: suppl excluded,
  // mapq/baseq filters 0) ----
  std::vector<TrimmedReadN> reads;
  {
    TrimmedReadN tr;
    pep::for_each_record(
        bam_path, chunks, n_chunks, ref_id, rs, re,
        /*include_suppl=*/false, /*min_mapq=*/0,
        [&](const pep::BamRecord& rec) {
          if (pep::trim_record(rec, rs, re, tr))
            reads.push_back(std::move(tr));
        });
  }
  prof.lap(g_pns_fetch);
  return encode_from_reads(reads, rs, re, ref_seq, ref_len, realign_flag,
                           band, max_reads, random_seed);
}

// Multi-interval variant: ONE fetch + decode over the whole span, then
// per-interval trim + downsample + realign + pileup from the in-memory
// records. With ~10x-read-length intervals (the polish geometry: 1 kb
// intervals, 8-10 kb reads) the per-interval fetch decodes every read
// ~9 times; this entry removes that amplification. Outputs are
// bit-identical to per-interval polish_encode_region calls
// (tests/test_polish_native.py): records arrive in the same BAM
// coordinate order, and the per-interval filters replicate
// for_each_record's (pos < end, pos + ref_span > start).
//
// ref_seq is anchored at ref_anchor (= span start); ref_lens[i] is the
// per-interval realignment reference length exactly as the per-interval
// caller would pass it.
PolishEncodeResult** polish_encode_multi(
    const char* bam_path, const uint64_t* chunks, int n_chunks,
    int32_t ref_id, int64_t span_start, int64_t span_end, int n_iv,
    const int64_t* starts, const int64_t* ends, const char* ref_seq,
    int64_t ref_anchor, const int64_t* ref_lens, int realign_flag,
    int band, int64_t max_reads, uint32_t random_seed) {
  PSectionTimer prof;
  std::vector<pep::BamRecord> recs;
  pep::for_each_record(
      bam_path, chunks, n_chunks, ref_id, span_start, span_end,
      /*include_suppl=*/false, /*min_mapq=*/0,
      [&](const pep::BamRecord& rec) { recs.push_back(rec); });
  auto** out =
      (PolishEncodeResult**)calloc((size_t)n_iv, sizeof(PolishEncodeResult*));
  if (!out) return nullptr;
  prof.lap(g_pns_fetch);
  for (int i = 0; i < n_iv; i++) {
    const int64_t rs = starts[i], re = ends[i];
    if (re - rs + 1 <= 0) continue;
    PSectionTimer tprof;
    std::vector<TrimmedReadN> reads;
    TrimmedReadN tr;
    for (const auto& rec : recs) {
      // for_each_record's window filters, replicated per interval
      if (rec.pos >= re) continue;
      if (rec.pos + rec.ref_span <= rs) continue;
      if (pep::trim_record(rec, rs, re, tr)) reads.push_back(std::move(tr));
    }
    tprof.lap(g_pns_fetch);
    const int64_t off = rs - ref_anchor;
    out[i] = encode_from_reads(reads, rs, re, ref_seq + off, ref_lens[i],
                               realign_flag, band, max_reads, random_seed);
  }
  return out;
}

void polish_encode_multi_free(PolishEncodeResult** arr, int n) {
  if (!arr) return;
  for (int i = 0; i < n; i++) polish_encode_result_free(arr[i]);
  free(arr);
}

}  // extern "C"
