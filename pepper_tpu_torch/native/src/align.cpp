// Local read-to-reference realignment (polish path).
//
// The reference uses a DeepVariant-derived two-pass realigner: k-mer index
// fast pass, then striped Smith-Waterman fallback
// (pepper/modules/src/local_reassembly/aligner.cpp, ssw.c). This is a
// from-scratch affine-gap local aligner (Gotoh DP with traceback) using the
// same scoring constants (match 4, mismatch 6, gap open 8, extend 2 —
// aligner.h:22-28). Produces a new (pos, CIGAR) per read with soft-clipped
// unaligned ends; same contract as ReadAligner.align_reads_to_reference.
//
// Performance model (replaces the reference's SIMD-striped SW): reads come
// BAM-anchored, so instead of the full query x ref matrix the DP runs in a
// band of +/-`band` around the read's existing diagonal — O(q * band)
// cells instead of O(q * r) — with all scratch in thread_local buffers
// (zero allocation per read). band <= 0 falls back to the full matrix.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int MATCH = 4, MISMATCH = 6, GAP_OPEN = 8, GAP_EXT = 2;
constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_S = 4;
constexpr int32_t NEG = -1000000;

// traceback packing: bits 0-1 = H source (0 stop, 1 diag, 2 E, 3 F),
// bit 2 = E extends, bit 3 = F extends
inline uint8_t pack_tb(uint8_t h_src, bool e_ext, bool f_ext) {
  return h_src | (e_ext ? 4 : 0) | (f_ext ? 8 : 0);
}

struct Scratch {
  std::vector<int32_t> h_prev, h_cur, e_prev, e_cur;
  std::vector<uint8_t> tb;  // (query_len+1) * band_width
};

thread_local Scratch g_scratch;

}  // namespace

extern "C" {

// Aligns one query to the reference window. `hint` is the expected ref
// offset of the query start (read.pos - window_start); `band` is the
// half-width of the DP band around that diagonal (<= 0 => full matrix).
// Outputs: new 0-based ref offset (into ref), cigar ops/lens written into
// caller buffers (cap = max ops), returns number of ops (0 => no
// alignment / keep original).
int ssw_align_one_banded(const char* ref, int32_t ref_len, const char* query,
                         int32_t query_len, int32_t hint, int32_t band,
                         int32_t* out_ref_offset, uint8_t* out_ops,
                         int32_t* out_lens, int32_t cap) {
  if (ref_len <= 0 || query_len <= 0) return 0;
  if (band <= 0) {
    // full matrix == band covering every diagonal
    hint = (ref_len - query_len) / 2;
    band = (ref_len + query_len) / 2 + 2;
  }
  const int32_t W = 2 * band + 1;  // banded row width; k = j - i - hint + band
  Scratch& s = g_scratch;
  s.h_prev.assign(W + 2, 0);
  s.h_cur.assign(W + 2, 0);
  s.e_prev.assign(W + 2, NEG);
  s.e_cur.assign(W + 2, NEG);
  if ((int64_t)(query_len + 1) * W > (int64_t)s.tb.capacity())
    s.tb.reserve((size_t)(query_len + 1) * W);
  s.tb.assign((size_t)(query_len + 1) * W, 0);
  // index helpers: row arrays are offset by +1 so k-1/k+1 never underflow
  auto tb_at = [&](int i, int k) -> uint8_t& {
    return s.tb[(size_t)i * W + k];
  };

  // row 0 (i = 0): H = 0 along the top (local alignment), E/F = NEG.
  // h_prev[k+1] holds H(i-1, j) where k = j - i - hint + band for row i.
  // For row i, previous row's k index of (i-1, j) is k+1; of (i-1, j-1), k.
  int32_t best = 0, bi = 0, bk = 0;
  for (int i = 1; i <= query_len; i++) {
    const char qc = query[i - 1];
    const int32_t j_lo = std::max(1, i + hint - band);
    const int32_t j_hi = std::min(ref_len, i + hint + band);
    if (j_lo > j_hi) break;  // band exited the reference
    const int32_t k_lo = j_lo - i - hint + band;
    const int32_t k_hi = j_hi - i - hint + band;
    // cells outside [k_lo, k_hi] are invalid this row; NEG them including
    // the +1 sentinel slot (index W+1) read as (i-1, j) at the band's top
    for (int32_t k = 0; k < k_lo; k++) {
      s.h_cur[k + 1] = NEG;
      s.e_cur[k + 1] = NEG;
    }
    for (int32_t k = k_hi + 1; k <= W; k++) {
      s.h_cur[k + 1] = NEG;
      s.e_cur[k + 1] = NEG;
    }
    // left neighbors of the first in-band cell: column 0 is the local-
    // alignment edge (H = 0, F open from it); a band edge is unreachable
    int32_t f_left = NEG;              // F(i, j_lo - 1)
    int32_t h_left = (j_lo == 1) ? 0 : NEG;  // H(i, j_lo - 1)
    for (int32_t j = j_lo, k = k_lo; j <= j_hi; j++, k++) {
      const int32_t h_im1_j = s.h_prev[k + 1 + 1];   // (i-1, j)   -> k+1
      const int32_t e_im1_j = s.e_prev[k + 1 + 1];
      // (i-1, j-1) -> k; always inside the previous row's band except at
      // the matrix edge j-1 == 0 where H = 0 (local alignment)
      const int32_t h_im1_jm1 = (j == 1) ? 0 : s.h_prev[k + 1];

      const int32_t e_ext = e_im1_j - GAP_EXT;
      const int32_t e_open = h_im1_j - GAP_OPEN;
      const int32_t e = e_ext >= e_open ? e_ext : e_open;
      const int32_t f_ext = f_left - GAP_EXT;
      const int32_t f_open = h_left - GAP_OPEN;
      const int32_t f = f_ext >= f_open ? f_ext : f_open;
      const int32_t diag =
          h_im1_jm1 + (qc == ref[j - 1] ? MATCH : -MISMATCH);
      int32_t h = diag;
      uint8_t src = 1;
      if (e > h) { h = e; src = 2; }
      if (f > h) { h = f; src = 3; }
      if (h <= 0) { h = 0; src = 0; }
      s.e_cur[k + 1] = e;
      s.h_cur[k + 1] = h;
      tb_at(i, k) = pack_tb(src, e_ext >= e_open, f_ext >= f_open);
      if (h > best) { best = h; bi = i; bk = k; }
      f_left = f;
      h_left = h;
    }
    std::swap(s.h_prev, s.h_cur);
    std::swap(s.e_prev, s.e_cur);
  }
  if (best <= 0) return 0;

  // traceback from (bi, bk): k = j - i - hint + band
  std::vector<std::pair<uint8_t, int32_t>> rev_ops;
  auto push = [&](uint8_t op) {
    if (!rev_ops.empty() && rev_ops.back().first == op)
      rev_ops.back().second++;
    else
      rev_ops.emplace_back(op, 1);
  };
  int i = bi, k = bk;
  int state = 0;  // 0 = H, 1 = E, 2 = F
  while (i > 0) {
    int32_t j = i + hint - band + k;
    if (j <= 0) break;
    uint8_t t = tb_at(i, k);
    if (state == 0) {
      uint8_t src = t & 3;
      if (src == 0) break;
      if (src == 1) { push(OP_M); i--; }                 // diag: k stays
      else if (src == 2) state = 1;
      else state = 2;
    } else if (state == 1) {
      push(OP_I);
      bool ext = t & 4;
      i--; k++;                                          // (i-1, j) -> k+1
      if (!ext) state = 0;
      if (k >= W) break;                                 // band edge
    } else {
      push(OP_D);
      bool ext = t & 8;
      k--;                                               // (i, j-1) -> k-1
      if (!ext) state = 0;
      if (k < 0) break;
    }
  }
  const int32_t q_start = i;                 // soft-clipped prefix length
  const int32_t q_end_clip = query_len - bi;
  const int32_t j_start = i + hint - band + k;
  if (j_start < 0) return 0;
  *out_ref_offset = j_start;

  int n = 0;
  if (q_start > 0) {
    if (n >= cap) return 0;
    out_ops[n] = OP_S; out_lens[n] = q_start; n++;
  }
  for (auto it = rev_ops.rbegin(); it != rev_ops.rend(); ++it) {
    if (n >= cap) return 0;
    out_ops[n] = it->first; out_lens[n] = it->second; n++;
  }
  if (q_end_clip > 0) {
    if (n >= cap) return 0;
    out_ops[n] = OP_S; out_lens[n] = q_end_clip; n++;
  }
  return n;
}

// Back-compat entry: full-matrix alignment (old signature).
int ssw_align_one(const char* ref, int32_t ref_len, const char* query,
                  int32_t query_len, int32_t* out_ref_offset,
                  uint8_t* out_ops, int32_t* out_lens, int32_t cap) {
  return ssw_align_one_banded(ref, ref_len, query, query_len, 0, 0,
                              out_ref_offset, out_ops, out_lens, cap);
}

// ---------------------------------------------------------------------------
// k-mer seed fast pass (the role of the reference's k-mer-index read ->
// haplotype matcher, pepper/modules/src/local_reassembly/aligner.h:152-190,
// with striped SW only as fallback). Here:
//   1. hash the window's k-mers (k=16, 2-bit packed, open addressing);
//   2. vote read k-mers onto diagonals (ref_pos - read_pos);
//   3. one dominant diagonal -> gapless Kadane extension; accepted when it
//      covers >= 90% of the overlap with <= 12% mismatches (no-indel reads
//      are the majority at ONT error rates — they skip the DP entirely);
//   4. otherwise the seed diagonals bound the band: banded Gotoh runs with
//      band = observed diagonal spread + margin instead of the caller's
//      full band. Seed-less reads fall back to the caller's hint/band.
// Identical contract to ssw_align_one_banded.

namespace {

constexpr int KK = 16, SEED_STRIDE = 8, MAX_VOTES = 512;

inline int base2(char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return -1;
  }
}

struct SeedScratch {
  std::vector<uint64_t> key;   // table keys (kmer | occupied bit)
  std::vector<int32_t> pos1, pos2;
  std::vector<int32_t> votes;
  uint32_t mask = 0;
  int32_t indexed_len = -1;
  uint64_t indexed_hash = 0;
};
thread_local SeedScratch g_seed;

// Build (or reuse) the ref k-mer index in `s`. The polish encoder aligns
// ~30 reads per interval against the SAME reference window — rebuilding
// the index per read was ~25% of the realign slice, so the index is
// cached keyed on (ref_len, FNV-1a hash of the window) and rebuilt only
// when the window changes. Hashing 1-2 kb costs ~0.1 us vs the ~15 us
// build; a content key cannot go stale the way a pointer key could
// (freed buffers get reallocated at the same address). Contents are
// identical either way (bit-equal CIGARs).
static void build_seed_index(SeedScratch& s, const char* ref,
                             int32_t ref_len) {
  uint64_t hash = 1469598103934665603ull;   // FNV-1a 64
  for (int32_t j = 0; j < ref_len; j++)
    hash = (hash ^ (uint8_t)ref[j]) * 1099511628211ull;
  if (s.indexed_hash == hash && s.indexed_len == ref_len) return;
  uint32_t tbl = 64;
  while ((int64_t)tbl < 2 * (int64_t)(ref_len - KK + 1)) tbl <<= 1;
  const uint32_t mask = tbl - 1;
  s.key.assign(tbl, 0);
  s.pos1.assign(tbl, -1);
  s.pos2.assign(tbl, -1);
  s.mask = mask;
  uint64_t kmer = 0;
  int run = 0;
  constexpr uint64_t KMASK = (1ull << (2 * KK)) - 1;
  for (int32_t j = 0; j < ref_len; j++) {
    int b = base2(ref[j]);
    if (b < 0) { run = 0; kmer = 0; continue; }
    kmer = ((kmer << 2) | (uint64_t)b) & KMASK;
    if (++run < KK) continue;
    const uint64_t keyv = kmer | (1ull << 63);
    uint32_t h = (uint32_t)((kmer * 0x9e3779b97f4a7c15ull) >> 40) & mask;
    while (true) {
      if (!s.key[h]) { s.key[h] = keyv; s.pos1[h] = j - KK + 1; break; }
      if (s.key[h] == keyv) {
        if (s.pos2[h] < 0) s.pos2[h] = j - KK + 1;
        break;  // keep at most 2 occurrences (repeats vote ambiguously)
      }
      h = (h + 1) & mask;
    }
  }
  s.indexed_hash = hash;
  s.indexed_len = ref_len;
}

}  // namespace

int ssw_align_one_auto(const char* ref, int32_t ref_len, const char* query,
                       int32_t query_len, int32_t hint, int32_t band,
                       int32_t* out_ref_offset, uint8_t* out_ops,
                       int32_t* out_lens, int32_t cap) {
  if (ref_len < 2 * KK || query_len < 2 * KK || band <= 0)
    return ssw_align_one_banded(ref, ref_len, query, query_len, hint, band,
                                out_ref_offset, out_ops, out_lens, cap);

  // ---- index ref k-mers (cached across calls on the same window) --------
  SeedScratch& s = g_seed;
  build_seed_index(s, ref, ref_len);
  const uint32_t mask = s.mask;

  // ---- vote read k-mers onto diagonals ----------------------------------
  s.votes.clear();
  constexpr uint64_t KMASK = (1ull << (2 * KK)) - 1;
  uint64_t kmer = 0;
  int run = 0;
  int next_sample = KK - 1;
  for (int32_t i = 0; i < query_len; i++) {
    int b = base2(query[i]);
    if (b < 0) { run = 0; kmer = 0; continue; }
    kmer = ((kmer << 2) | (uint64_t)b) & KMASK;
    if (++run < KK || i < next_sample) continue;
    next_sample = i + SEED_STRIDE;
    const uint64_t keyv = kmer | (1ull << 63);
    uint32_t h = (uint32_t)((kmer * 0x9e3779b97f4a7c15ull) >> 40) & mask;
    while (s.key[h]) {
      if (s.key[h] == keyv) {
        const int32_t i0 = i - KK + 1;
        s.votes.push_back(s.pos1[h] - i0);
        if (s.pos2[h] >= 0 && s.votes.size() < MAX_VOTES)
          s.votes.push_back(s.pos2[h] - i0);
        break;
      }
      h = (h + 1) & mask;
    }
    if ((int)s.votes.size() >= MAX_VOTES) break;
  }
  if (s.votes.size() < 3)
    return ssw_align_one_banded(ref, ref_len, query, query_len, hint, band,
                                out_ref_offset, out_ops, out_lens, cap);

  // ---- dominant diagonal ------------------------------------------------
  std::sort(s.votes.begin(), s.votes.end());
  int best_cnt = 1, cur = 1, mode = s.votes[0];
  for (size_t v = 1; v < s.votes.size(); v++) {
    cur = (s.votes[v] == s.votes[v - 1]) ? cur + 1 : 1;
    if (cur > best_cnt) { best_cnt = cur; mode = s.votes[v]; }
  }

  if (best_cnt * 5 >= (int)s.votes.size() * 4) {
    // single diagonal: gapless local extension (Kadane, +MATCH/-MISMATCH)
    const int32_t d = mode;
    const int32_t i_lo = std::max(0, -d);
    const int32_t i_hi = std::min(query_len, ref_len - d);
    int64_t sum = 0, best_sum = 0;
    int32_t seg_start = i_lo, best_start = i_lo, best_end = i_lo;
    int32_t mism = 0, best_mism = 0, seg_mism = 0;
    for (int32_t i = i_lo; i < i_hi; i++) {
      const bool m = query[i] == ref[i + d];
      sum += m ? MATCH : -MISMATCH;
      seg_mism += m ? 0 : 1;
      if (sum <= 0) { sum = 0; seg_start = i + 1; seg_mism = 0; }
      else if (sum > best_sum) {
        best_sum = sum; best_start = seg_start; best_end = i + 1;
        best_mism = seg_mism;
      }
    }
    (void)mism;
    const int32_t blen = best_end - best_start;
    if (best_sum > 0 && blen * 10 >= (i_hi - i_lo) * 9 &&
        best_mism * 100 <= blen * 12) {
      int n = 0;
      if (best_start > 0) {
        if (n >= cap) return 0;
        out_ops[n] = OP_S; out_lens[n] = best_start; n++;
      }
      if (n >= cap) return 0;
      out_ops[n] = OP_M; out_lens[n] = blen; n++;
      if (best_end < query_len) {
        if (n >= cap) return 0;
        out_ops[n] = OP_S; out_lens[n] = query_len - best_end; n++;
      }
      *out_ref_offset = best_start + d;
      return n;
    }
  }

  // ---- seeds bound the band: small-band DP around the seed diagonals ----
  const int32_t d_lo = s.votes.front(), d_hi = s.votes.back();
  const int32_t center = (d_lo + d_hi) / 2;
  const int32_t small = std::min(band, (d_hi - d_lo) / 2 + 16);
  int n = ssw_align_one_banded(ref, ref_len, query, query_len, center, small,
                               out_ref_offset, out_ops, out_lens, cap);
  if (n > 0) return n;
  return ssw_align_one_banded(ref, ref_len, query, query_len, hint, band,
                              out_ref_offset, out_ops, out_lens, cap);
}

}  // extern "C"
