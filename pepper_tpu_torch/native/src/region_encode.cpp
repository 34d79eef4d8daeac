// Fused native region encoder: BAM fetch of the window -> event walk into
// count columns -> image rows + site thresholds -> candidate windows
// (+ train labels).
//
// This is the pipeline's hot path (SURVEY.md §3.5). Semantics are a direct
// port of the Python implementation (pepper_tpu/encode/events.py +
// region_encoder.py), which is the tested oracle; tests/test_native_encode.py
// and tests/test_torch_native_encode.py assert bit-equality between the two
// on randomized data. The Python layer stays authoritative for semantics;
// this file exists for speed (it also avoids materializing per-read Python
// objects entirely).
//
// Data flow of encode_region, each read base and each window touched once,
// in scratch memory each thread keeps across regions (Workspace):
//   fetch   only the part of each record inside the fetch window is decoded,
//           straight into one arena of bases, qualities and CIGAR ops
//           (what pep::trim_record would keep);
//   walk    each kept base adds one to its (strand, letter) count column;
//           indels and other letters add allele events that point into the
//           arena or the reference (no strings, no maps);
//   site    the columns become the row-major int8 image rows, tile by tile,
//           with the site thresholds in the same pass;
//   render  each filtered site's alleles (letter counts + sorted events)
//           pass the gates once; the result is sized from that list and its
//           windows copied from the rows.
//
// Downsampling reproduces numpy RandomState(seed).randint(0, i+1) exactly:
// MT19937 seeded with init_by_array([seed]) + masked-rejection bounded
// draws (the legacy numpy algorithm), so native and Python paths pick the
// same reads.
#include "bam_common.h"

#include <cmath>
#include <ctime>
#include <map>
#include <memory>
#ifdef __SSE2__
#include <emmintrin.h>
#endif
#ifdef __SSSE3__
#include <tmmintrin.h>
#endif

namespace {

using pep::TrimmedReadN;
using pep::NumpyMT;


// ---------------------------------------------------------------- constants
constexpr int MAXV = 125, MINV = -125;
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

// letter code of a base: its index in LETTERS (A=0, C=1, G=2, T=3), any
// other character 4
constexpr char LETTERS[] = "ACGT";
struct LetterTable {
  uint8_t t[256];
  constexpr LetterTable() : t() {
    for (int i = 0; i < 256; i++) t[i] = 4;
    for (int l = 0; l < 4; l++) t[(unsigned char)LETTERS[l]] = (uint8_t)l;
  }
};
constexpr LetterTable LETTER;

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

// one haplotype's truth records, as encode_region receives them
struct TruthArgs {
  int n;
  const int64_t *pos, *end;
  const int32_t *ref_off, *alt_off;
  const char *ref_buf, *alt_buf;
};

// Train labels of a region (region_encoder.py generate_labels): the truth
// records of both haplotypes, the base label of each position and, per
// position, the records that start there.
struct Labels {
  std::vector<TruthRec> truth[2];
  std::vector<std::vector<int32_t>> truth_at[2];
  std::vector<int32_t> labels;

  Labels(const TruthArgs* hap, int64_t region_start, int64_t L,
         const char* ref_seq) {
    std::vector<uint8_t> labels_hp[2];
    for (int h = 0; h < 2; h++) {
      const TruthArgs& t = hap[h];
      for (int i = 0; i < t.n; i++)
        truth[h].push_back(TruthRec{
            t.pos[i], t.end[i],
            std::string(t.ref_buf + t.ref_off[i], t.ref_off[i + 1] - t.ref_off[i]),
            std::string(t.alt_buf + t.alt_off[i], t.alt_off[i + 1] - t.alt_off[i])});
      labels_hp[h].assign(L + 1, '*');
      truth_at[h].assign(L + 1, {});
      for (int64_t i = 0; i < L; i++) labels_hp[h][i] = 'R';
      for (size_t r = 0; r < truth[h].size(); r++) {
        const TruthRec& rec = truth[h][r];
        int64_t idx = rec.pos_start - region_start;
        if (rec.ref.size() > rec.alt.size()) {
          if (idx >= 0 && idx < L) {
            labels_hp[h][idx] = '#';
            truth_at[h][idx].push_back((int32_t)r);
          }
        } else if (rec.ref.size() < rec.alt.size()) {
          if (idx >= 0 && idx < L) {
            labels_hp[h][idx] = '*';
            truth_at[h][idx].push_back((int32_t)r);
          }
        } else {
          if (idx >= 0 && idx < L) truth_at[h][idx].push_back((int32_t)r);
          for (int64_t pos = rec.pos_start; pos < rec.pos_end; pos++) {
            if (pos >= region_start && pos < region_start + L) {
              int64_t i = pos - region_start;
              char alt_base = rec.alt[pos - rec.pos_start];
              labels_hp[h][i] = (ref_seq[i] == alt_base) ? 'R' : alt_base;
            }
          }
        }
      }
    }
    labels.assign(L + 1, 0);
    for (int64_t i = 0; i <= L; i++)
      labels[i] = get_label_index((char)labels_hp[0][i], (char)labels_hp[1][i]);
  }

  // type label of candidate `cand` at position idx: how many haplotypes
  // hold a truth record with that candidate string
  int type_label(int64_t idx, const std::string& cand) const {
    bool found[2] = {false, false};
    for (int h = 0; h < 2; h++)
      for (int32_t t : truth_at[h][idx])
        if (truth_candidate_string(truth[h][t]) == cand) found[h] = true;
    return (found[0] && found[1]) ? 2 : ((found[0] || found[1]) ? 1 : 0);
  }
};

double thread_cpu_s() {
  timespec ts;
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

// Growable buffer whose new slots are left uninitialised (the decode
// overwrites them; std::vector::resize would zero them first).
template <typename T>
struct PodBuf {
  std::unique_ptr<T[]> p;
  size_t n = 0, cap = 0;
  T* grow(size_t k) {
    if (n + k > cap) {
      size_t c = std::max(n + k, 2 * cap + 4096);
      std::unique_ptr<T[]> q(new T[c]);
      if (n) memcpy(q.get(), p.get(), n * sizeof(T));
      p = std::move(q);
      cap = c;
    }
    T* out = p.get() + n;
    n += k;
    return out;
  }
  T* data() const { return p.get(); }
};

// A record's part inside the fetch window: pep::trim_record's output, as
// offsets into the workspace's arena.
struct WindowRead {
  int64_t pos, pos_end;     // the kept reference span [pos, pos_end)
  int64_t seq_off, seq_len;  // into Workspace::seq and ::qual
  int64_t cig_off, n_cig;   // into Workspace::cigar (BAM packing: len<<4|op)
  uint16_t flag;
  uint8_t mapq;
};

// One allele observation: candidate type ('1' SNP, '2' insert, '3'
// delete) and the key's bytes after it, in the arena or the reference.
struct Event {
  const char* key;
  int32_t idx, len;
  char kind;
  uint8_t rev;
};

// std::string order of (kind + key)
inline bool key_less(char ka, const char* a, int la, char kb, const char* b,
                     int lb) {
  if (ka != kb) return (unsigned char)ka < (unsigned char)kb;
  int c = memcmp(a, b, (size_t)std::min(la, lb));
  return c != 0 ? c < 0 : la < lb;
}

struct Allele {
  const char* key;
  int32_t len;
  char kind;
  AlleleCount ac;
};

struct Site {
  int32_t idx, depth;
  bool snp, ins, del;        // which thresholds the site passed
  int16_t fwd[4], rev[4];    // its passing A, C, G, T bases by strand
};

struct Cand {
  const char* key;
  int32_t idx, len, depth;
  char kind;
  AlleleCount ac;
};

// The walk's int16 columns, one value per region position. Per strand s
// (0 forward, 1 reverse): passing read bases by letter (A, C, G, T),
// passing ACGT anchor bases, and the image columns the walk changes
// directly: the strand's ref column (other letters), I, D and '*'. The
// image rows are derived from these.
enum : int {
  C_LETTER = 0,   // + 4 * s + letter
  C_ANCHOR = 8,   // + s
  C_COV = 10, C_SNP = 11, C_INS = 12, C_DEL = 13,
  C_DIRECT = 14,  // + 4 * s + {0 ref, 1 I, 2 D, 3 '*'}
  N_COLS = 22
};

struct Workspace {
  PodBuf<char> seq;
  PodBuf<uint8_t> qual;
  PodBuf<uint32_t> cigar;
  std::vector<WindowRead> reads;
  std::vector<int64_t> keep;
  std::vector<int16_t> cols;  // N_COLS columns of `stride` positions
  int64_t stride = 0;
  std::vector<uint8_t> code;       // a read's letter codes by position
  std::vector<uint8_t> read_code;  // ... and by base of the read
  std::vector<int8_t> rows;   // (L + 1) x features: the windows' source
  std::vector<Event> events, bucketed;
  std::vector<Site> sites;
  std::vector<int32_t> slot;  // position -> 1 + its site; 0 elsewhere
  std::vector<int32_t> bucket;
  std::vector<Allele> alleles;
  std::vector<Cand> cands;

  // size for a region of L positions and zero the columns
  void reset(int64_t L, int features) {
    seq.n = qual.n = cigar.n = 0;
    reads.clear();
    keep.clear();
    events.clear();
    sites.clear();
    cands.clear();
    if (L + 1 > stride) {
      stride = L + 1;
      cols.assign((size_t)N_COLS * stride, 0);
      slot.assign(stride, 0);
      code.resize(stride);
    } else {
      std::fill(cols.begin(), cols.end(), (int16_t)0);
    }
    rows.resize((size_t)(L + 1) * features);
  }
  int16_t* col(int c) { return cols.data() + (size_t)c * stride; }
};

Workspace& workspace() {
  thread_local Workspace w;
  return w;
}

// d[0..k): the bases from..from+k of a BAM sequence (two 4-bit codes a
// byte, high nibble first)
inline void decode_bases(const uint8_t* sb, int64_t from, int64_t k,
                         char* d) {
  const char* NT16 = pep::SEQ_NT16();
  int64_t i = 0;
  if (from & 1) { d[0] = NT16[sb[from / 2] & 0xF]; i = 1; }
  const uint8_t* s = sb + (from + i) / 2;
#ifdef __SSSE3__
  // 32 bases a step: each nibble looks itself up in the 16-letter table
  const __m128i lut = _mm_loadu_si128((const __m128i*)NT16);
  const __m128i low = _mm_set1_epi8(0x0F);
  for (; i + 32 <= k; i += 32, s += 16) {
    const __m128i v = _mm_loadu_si128((const __m128i*)s);
    const __m128i hi =
        _mm_shuffle_epi8(lut, _mm_and_si128(_mm_srli_epi16(v, 4), low));
    const __m128i lo = _mm_shuffle_epi8(lut, _mm_and_si128(v, low));
    _mm_storeu_si128((__m128i*)(d + i), _mm_unpacklo_epi8(hi, lo));
    _mm_storeu_si128((__m128i*)(d + i + 16), _mm_unpackhi_epi8(hi, lo));
  }
#endif
  const uint16_t* SEQ2 = pep::seq_pair_lut();
  for (; i + 1 < k; i += 2, s++) memcpy(d + i, &SEQ2[*s], 2);
  if (i < k) d[i] = NT16[*s >> 4];
}

// pep::trim_record on the raw record (stop INCLUSIVE), decoding only the
// kept bases and qualities, straight into the arena. False (and nothing
// kept) if no base of the record lies in [start, stop].
bool decode_window(const std::vector<uint8_t>& raw, int64_t start,
                   int64_t stop, Workspace& ws) {
  int32_t rpos, l_seq;
  memcpy(&rpos, raw.data() + 4, 4);
  memcpy(&l_seq, raw.data() + 16, 4);
  const uint8_t l_read_name = raw[8];
  uint16_t n_cigar;
  memcpy(&n_cigar, raw.data() + 12, 2);
  const uint8_t* cig = raw.data() + 32 + l_read_name;
  const uint8_t* sb = cig + 4ull * n_cigar;
  const uint8_t* qb = sb + (l_seq + 1) / 2;
  WindowRead rd;
  rd.pos = -1;
  rd.seq_off = (int64_t)ws.seq.n;
  rd.cig_off = (int64_t)ws.cigar.n;
  rd.flag = (uint16_t)(raw[14] | (raw[15] << 8));
  rd.mapq = raw[9];
  bool in_bounds = true;
  auto keep_bases = [&](int64_t from, int64_t k) {
    if (k <= 0) return;
    if (from + k > l_seq) {  // a record shorter than its CIGAR: dropped
      in_bounds = false;
      return;
    }
    decode_bases(sb, from, k, ws.seq.grow(k));
    memcpy(ws.qual.grow(k), qb + from, k);
  };
  int64_t current_pos = rpos, read_index = 0;
  for (int c = 0; c < n_cigar; c++) {
    uint32_t v;
    memcpy(&v, cig + 4ull * c, 4);
    const int op = v & 0xF;
    const int64_t length = v >> 4;
    if (current_pos > stop) break;
    if (op == pep::OP_M || op == pep::OP_EQ || op == pep::OP_X) {
      int64_t skip = 0;
      if (current_pos < start) {
        skip = std::min<int64_t>(start - current_pos, length);
        read_index += skip;
        current_pos += skip;
      }
      const int64_t n = length - skip;
      const int64_t kept = std::min<int64_t>(n, stop - current_pos + 1);
      if (kept > 0) {
        if (rd.pos == -1) rd.pos = rd.pos_end = current_pos;
        rd.pos_end += kept;
        keep_bases(read_index, kept);
        *ws.cigar.grow(1) = (uint32_t)(kept << 4) | (uint32_t)op;
      }
      read_index += n;
      current_pos += n;
    } else if (op == pep::OP_S || op == pep::OP_I) {
      if (start <= current_pos && current_pos <= stop && rd.pos != -1) {
        keep_bases(read_index, length);
        *ws.cigar.grow(1) = v;
      }
      read_index += length;
    } else if (op == pep::OP_N || op == pep::OP_D) {
      if (start <= current_pos && current_pos <= stop && rd.pos != -1) {
        const int64_t kept = std::min<int64_t>(length, stop - current_pos + 1);
        if (kept > 0) {
          *ws.cigar.grow(1) = (uint32_t)(kept << 4) | (uint32_t)op;
          rd.pos_end += kept;
        }
      }
      current_pos += length;
    } else if (op == pep::OP_P) {
      current_pos += length;
    }
  }
  if (rd.pos == -1 || !in_bounds) {  // nothing kept: take back what was
    ws.seq.n = ws.qual.n = (size_t)rd.seq_off;
    ws.cigar.n = (size_t)rd.cig_off;
    return false;
  }
  rd.n_cig = (int64_t)ws.cigar.n - rd.cig_off;
  rd.seq_len = (int64_t)ws.seq.n - rd.seq_off;
  ws.reads.push_back(rd);
  return true;
}

// out[j][i] = in[i][j] for a 16 x 16 block of bytes; rows of `in` lie
// `is` apart, rows of `out` `os` apart
inline void transpose16(const int8_t* in, size_t is, int8_t* out,
                        size_t os) {
#ifdef __SSE2__
  __m128i a[16], b[16];
  for (int i = 0; i < 16; i++)
    a[i] = _mm_loadu_si128((const __m128i*)(in + i * is));
  for (int i = 0; i < 8; i++) {
    b[2 * i] = _mm_unpacklo_epi8(a[2 * i], a[2 * i + 1]);
    b[2 * i + 1] = _mm_unpackhi_epi8(a[2 * i], a[2 * i + 1]);
  }
  for (int i = 0; i < 4; i++)
    for (int k = 0; k < 2; k++) {
      a[4 * i + 2 * k] = _mm_unpacklo_epi16(b[4 * i + k], b[4 * i + k + 2]);
      a[4 * i + 2 * k + 1] =
          _mm_unpackhi_epi16(b[4 * i + k], b[4 * i + k + 2]);
    }
  for (int i = 0; i < 2; i++)
    for (int k = 0; k < 4; k++) {
      b[8 * i + 2 * k] = _mm_unpacklo_epi32(a[8 * i + k], a[8 * i + k + 4]);
      b[8 * i + 2 * k + 1] =
          _mm_unpackhi_epi32(a[8 * i + k], a[8 * i + k + 4]);
    }
  for (int k = 0; k < 8; k++) {
    a[2 * k] = _mm_unpacklo_epi64(b[k], b[k + 8]);
    a[2 * k + 1] = _mm_unpackhi_epi64(b[k], b[k + 8]);
  }
  for (int j = 0; j < 16; j++)
    _mm_storeu_si128((__m128i*)(out + j * os), a[j]);
#else
  for (int i = 0; i < 16; i++)
    for (int j = 0; j < 16; j++) out[j * os + i] = in[i * is + j];
#endif
}

}  // namespace

extern "C" {

typedef struct {
  int32_t n;
  int64_t* positions;
  int32_t* depths;
  int32_t* type_labels;
  int32_t* base_labels;
  int32_t* cand_freqs;
  char* cand_buf;  // the n candidate strings, separated by '\n'
  // int8 with numpy-astype wrap semantics: every downstream consumer
  // (HDF5 image store, device transfer) is int8, and wrapping commutes
  // with the midpoint sign flips (mod-256)
  int8_t* images;  // n * (window+1) * features
  int64_t cand_buf_len;
  int32_t window1, features;
  // thread CPU seconds of encode_region's sections: fetch, walk, site,
  // render (encode_region_hp leaves them zero)
  double seconds[4];
  void* block;  // the one allocation every array above lies in
  int64_t block_len;
} EncodeResult;

void encode_result_free(EncodeResult* r) {
  if (!r) return;
  free(r->block);
  free(r);
}

}  // extern "C"

namespace {

// One allocation holds a result's arrays: numpy borrows them as views, and
// encode_result_free runs when the last view goes.
EncodeResult* alloc_result(int64_t n, int64_t cand_bytes, int win1,
                           int features) {
  auto up = [](size_t x) { return (x + 63) & ~(size_t)63; };
  const size_t depths = up((size_t)n * 8);
  const size_t type_labels = up(depths + (size_t)n * 4);
  const size_t base_labels = up(type_labels + (size_t)n * 4);
  const size_t cand_freqs = up(base_labels + (size_t)n * 4);
  const size_t images = up(cand_freqs + (size_t)n * 4);
  const size_t cand_buf = up(images + (size_t)n * win1 * features);
  const size_t total = cand_buf + (size_t)cand_bytes + 1;
  auto* r = (EncodeResult*)calloc(1, sizeof(EncodeResult));
  if (!r) return nullptr;
  char* b = (char*)aligned_alloc(64, up(total));
  if (!b) {
    free(r);
    return nullptr;
  }
  r->block = b;
  r->block_len = (int64_t)total;
  r->n = (int32_t)n;
  r->window1 = win1;
  r->features = features;
  r->positions = (int64_t*)b;
  r->depths = (int32_t*)(b + depths);
  r->type_labels = (int32_t*)(b + type_labels);
  r->base_labels = (int32_t*)(b + base_labels);
  r->cand_freqs = (int32_t*)(b + cand_freqs);
  r->images = (int8_t*)(b + images);
  r->cand_buf = b + cand_buf;
  r->cand_buf_len = cand_bytes;
  return r;
}

// The image's columns 0..25; wider images get zero columns after them.
constexpr int FEATURES = 26;

// What the sections of encode_region read of its arguments.
struct Params {
  int64_t region_start, region_end, L;
  const char* ref;
  double min_snp_baseq, min_indel_baseq, snp_freq, ins_freq, del_freq,
      min_cov, snp_cand_freq, indel_cand_freq, cand_support;
  bool skip_indels;
  int64_t cand_region_start, cand_region_end;
  int window_size, features;
};

// fetch: the window's part of each record, then the reservoir's choice
void fetch_reads(
    const char* bam_path, const uint64_t* chunks, int n_chunks,
    int32_t ref_id, int64_t fetch_start, int64_t fetch_stop,
    bool include_suppl, int min_mapq, int64_t max_reads,
    double downsample_rate, uint32_t random_seed, Workspace& ws) {
  pep::for_each_raw_record(
      bam_path, chunks, n_chunks, ref_id, fetch_stop, include_suppl,
      min_mapq, [&](const std::vector<uint8_t>& raw) {
        decode_window(raw, fetch_start, fetch_stop, ws);
      });
  const int64_t total = (int64_t)ws.reads.size();
  const int64_t allowed = (int64_t)std::min<double>(
      (double)max_reads, downsample_rate * (double)total);
  if (total <= allowed) {
    for (int64_t i = 0; i < total; i++) ws.keep.push_back(i);
    return;
  }
  NumpyMT mt;
  // RandomState(int_seed) seeds with plain init_genrand, NOT
  // init_by_array (verified against numpy's raw output stream)
  mt.init_genrand(random_seed);
  mt.mti = 624;
  for (int64_t i = 0; i < total; i++) {
    if ((int64_t)ws.keep.size() < allowed) {
      ws.keep.push_back(i);
    } else {
      int64_t j = (int64_t)mt.bounded((uint64_t)i);  // randint(0, i+1)
      if (j < allowed) ws.keep[j] = i;
    }
  }
}

// out[i]: the letter code of base i (LETTER: 0-3 A, C, G, T; 4 another
// letter) where its quality passes, else 5. Returns whether any passing
// base is another letter.
inline bool letter_codes(const char* __restrict seq,
                         const uint8_t* __restrict qual, int64_t n,
                         int bq_thr, uint8_t* __restrict out) {
  if (bq_thr > 255) {  // no base passes
    memset(out, 5, n);
    return false;
  }
  const uint8_t thr = (uint8_t)std::max(bq_thr, 0);
  uint8_t other = 0;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t b = (uint8_t)seq[i];
    // LETTER's mapping as four compares, which vectorise (a table lookup
    // a base made the walk 2-3x slower on the card's host)
    uint8_t code = 4;
    code = b == (uint8_t)LETTERS[0] ? 0 : code;
    code = b == (uint8_t)LETTERS[1] ? 1 : code;
    code = b == (uint8_t)LETTERS[2] ? 2 : code;
    code = b == (uint8_t)LETTERS[3] ? 3 : code;
    const uint8_t v = qual[i] >= thr ? code : 5;
    out[i] = v;
    other |= v == 4;
  }
  return other != 0;
}

// letter[l][p] += (code[p] == l) for the letters l of A, C, G, T, whose
// columns lie `stride` apart from `letter`
inline void add_codes(const uint8_t* __restrict code,
                      int16_t* __restrict letter, int64_t stride, int64_t lo,
                      int64_t hi) {
  int16_t* __restrict la = letter;
  int16_t* __restrict lc = letter + stride;
  int16_t* __restrict lg = letter + 2 * stride;
  int16_t* __restrict lt = letter + 3 * stride;
  for (int64_t p = lo; p < hi; p++) {
    const uint8_t c = code[p];
    la[p] += c == 0;
    lc[p] += c == 1;
    lg[p] += c == 2;
    lt[p] += c == 3;
  }
}

// walk (port of events.py read_events). A read first writes the letter
// code of each of its passing M bases at its position (0-3 A, C, G, T; 4
// another letter; 5 none), then adds its codes to its strand's letter
// columns in one pass over its span; the image's count columns are sums of
// these (build_rows). Only anchors, indels and bases other than ACGT take
// a step of their own.
void walk_reads(const Params& a, Workspace& ws) {
  const int64_t region_start = a.region_start, region_end = a.region_end;
  const char* ref = a.ref;
  const int bq_thr = (int)std::ceil(a.min_snp_baseq);  // quals are integers
  int16_t* cov_c = ws.col(C_COV);
  int16_t* snp_c = ws.col(C_SNP);
  int16_t* ins_c = ws.col(C_INS);
  int16_t* del_c = ws.col(C_DEL);
  uint8_t* code = ws.code.data();
  for (int64_t ri : ws.keep) {
    const WindowRead& rd = ws.reads[ri];
    if (rd.mapq <= 0) continue;
    const int s = (rd.flag & pep::FLAG_REVERSE) ? 1 : 0;
    int16_t* anchor_c = ws.col(C_ANCHOR + s);
    int16_t* d_ref = ws.col(C_DIRECT + 4 * s);
    int16_t* d_ins = ws.col(C_DIRECT + 4 * s + 1);
    int16_t* d_del = ws.col(C_DIRECT + 4 * s + 2);
    int16_t* d_star = ws.col(C_DIRECT + 4 * s + 3);
    const char* seq = ws.seq.data() + rd.seq_off;
    const uint8_t* qual = ws.qual.data() + rd.seq_off;
    const uint32_t* cig = ws.cigar.data() + rd.cig_off;
    const int64_t span_lo = std::max(rd.pos, region_start) - region_start;
    const int64_t span_hi =
        std::min(rd.pos_end, region_end + 1) - region_start;
    if (span_hi > span_lo) memset(code + span_lo, 5, span_hi - span_lo);
    if ((int64_t)ws.read_code.size() < rd.seq_len)
      ws.read_code.resize(rd.seq_len);
    const uint8_t* rc = ws.read_code.data();
    const bool other = letter_codes(seq, qual, rd.seq_len, bq_thr,
                                    ws.read_code.data());
    int64_t read_index = 0;
    int64_t ref_position = rd.pos;
    for (int64_t ci = 0; ci < rd.n_cig; ci++) {
      const int op = cig[ci] & 0xF;
      const int64_t length = cig[ci] >> 4;
      if (ref_position > region_end) break;
      if (op == pep::OP_M || op == pep::OP_EQ || op == pep::OP_X) {
        int64_t skip = 0;
        if (ref_position < region_start) {
          skip = std::min<int64_t>(region_start - ref_position, length);
          read_index += skip;
          ref_position += skip;
        }
        const int64_t n = length - skip;
        if (n <= 0) continue;
        const int64_t n_in =
            std::min<int64_t>(n, region_end - ref_position + 1);
        const char* sp = seq + read_index;
        const int64_t idx0 = ref_position - region_start;
        uint8_t* cp = code + idx0;
        memcpy(cp, rc + read_index, n_in);
        // the last in-region base anchors a following IN/DEL: its ref
        // column is skipped (region_summary.cpp anchor rule)
        const bool last_anchors =
            n_in > 0 && n_in == n && ci != rd.n_cig - 1 &&
            ((cig[ci + 1] & 0xF) == pep::OP_I ||
             (cig[ci + 1] & 0xF) == pep::OP_D);
        if (last_anchors && cp[n_in - 1] < 4) anchor_c[idx0 + n_in - 1] += 1;
        // passing bases other than ACGT (rare): their own columns and a
        // "1<base>" allele where they differ from the reference
        for (int64_t k = 0; other && k < n_in; k++) {
          if (cp[k] != 4) continue;
          const int64_t idx = idx0 + k;
          cov_c[idx] += 1;
          if (!(last_anchors && k == n_in - 1)) d_ref[idx] -= 1;
          // BASE_OFFSET: the letter D takes the deletion's column, every
          // other one the '*' column
          if (ref_ok(ref[idx])) (sp[k] == 'D' ? d_del : d_star)[idx] -= 1;
          if (sp[k] != ref[idx]) {
            snp_c[idx] += 1;
            ws.events.push_back(Event{sp + k, (int32_t)idx, 1, '1',
                                      (uint8_t)s});
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
          for (int64_t k = 0; k < alen; k++) qsum += qual[s0 + k];
          if (qsum >= a.min_indel_baseq * alen && qual[s0] < a.min_snp_baseq)
            cov_c[aidx] += 1;
          if (1 + alen <= 61 && qsum >= a.min_indel_baseq * alen) {
            if (ref_ok(ref[aidx])) d_ins[aidx] -= 1;  // 'I'
            ins_c[aidx] += 1;
            ws.events.push_back(Event{seq + s0, (int32_t)aidx,
                                      (int32_t)alen, '2', (uint8_t)s});
          }
        }
        read_index += length;
      } else if (op == pep::OP_D) {
        int64_t anchor = ref_position - 1;
        if (anchor >= region_start && anchor <= region_end) {
          int64_t aidx = anchor - region_start;
          if (ref_ok(ref[aidx])) d_del[aidx] -= 1;  // 'D'
          int64_t take = std::min<int64_t>(length + 1, a.L - aidx);
          if (1 + take <= 61) {
            del_c[aidx] += 1;
            ws.events.push_back(Event{ref + aidx, (int32_t)aidx,
                                      (int32_t)take, '3', (uint8_t)s});
          }
        }
        int64_t lo = std::max(ref_position, region_start);
        int64_t hi = std::min(ref_position + length - 1, region_end);
        for (int64_t p = lo; p <= hi; p++) {
          int64_t idx = p - region_start;
          if (ref_ok(ref[idx])) d_star[idx] -= 1;  // '*'
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
    add_codes(code, ws.col(C_LETTER + 4 * s), ws.stride, span_lo, span_hi);
  }
}

// site (region_encoder.py generate_summary): tile by tile, the columns of
// a block of positions become their int8 rows (numpy astype wrap; the
// count columns 11-24 clamped first), and the positions that pass the
// site thresholds become sites. Every sum is taken mod 2^16, as the int16
// counters it replaces were.
void build_rows(const Params& a, Workspace& ws) {
  constexpr int TILE = 64;
  // column-major tile (32 columns: 26 and zero padding for the 16 x 16
  // transposes) and its row-major transpose
  alignas(16) int8_t tile[32][TILE];
  alignas(16) int8_t trows[TILE][32];
  int32_t cov_t[TILE], snp_t[TILE];
  uint8_t rl_t[TILE], pass_t[TILE];
  memset(tile, 0, sizeof(tile));
  const int16_t* f[4];
  const int16_t* r[4];
  for (int l = 0; l < 4; l++) {
    f[l] = ws.col(C_LETTER + l);
    r[l] = ws.col(C_LETTER + 4 + l);
  }
  const int16_t* anch_f = ws.col(C_ANCHOR);
  const int16_t* anch_r = ws.col(C_ANCHOR + 1);
  const int16_t* dir[8];
  for (int d = 0; d < 8; d++) dir[d] = ws.col(C_DIRECT + d);
  const int16_t* cov_c = ws.col(C_COV);
  const int16_t* snp_c = ws.col(C_SNP);
  const int16_t* ins_c = ws.col(C_INS);
  const int16_t* del_c = ws.col(C_DEL);
  auto wrap = [](int v) { return (int8_t)v; };
  auto clamp = [](int v) {
    return (int8_t)std::min(std::max((int)(int16_t)v, MINV), MAXV);
  };
  const int F = a.features;
  for (int64_t p0 = 0; p0 < a.L; p0 += TILE) {
    const int T = (int)std::min<int64_t>(TILE, a.L - p0);
    for (int j = 0; j < T; j++) rl_t[j] = LETTER.t[(unsigned char)a.ref[p0 + j]];
    for (int j = 0; j < T; j++) {
      const int64_t p = p0 + j;
      const int rl = rl_t[j];
      const int ok = rl < 4;
      const int f0 = f[0][p], f1 = f[1][p], f2 = f[2][p], f3 = f[3][p];
      const int r0 = r[0][p], r1 = r[1][p], r2 = r[2][p], r3 = r[3][p];
      const int tf = f0 + f1 + f2 + f3, tr = r0 + r1 + r2 + r3;
      const int match = (rl == 0) * (f0 + r0) + (rl == 1) * (f1 + r1) +
                        (rl == 2) * (f2 + r2) + (rl == 3) * (f3 + r3);
      cov_t[j] = (int16_t)(cov_c[p] + tf + tr);
      snp_t[j] = (int16_t)(snp_c[p] + tf + tr - match);
      tile[0][j] = wrap(rl + 1);  // ref_value
      tile[4][j] = wrap(dir[0][p] - (tf - anch_f[p]));
      tile[8][j] = ok ? wrap(-f0) : 0;
      tile[9][j] = ok ? wrap(-f1) : 0;
      tile[10][j] = ok ? wrap(-f2) : 0;
      tile[11][j] = ok ? clamp(-f3) : 0;
      tile[12][j] = clamp(dir[1][p]);
      tile[13][j] = clamp(dir[2][p]);
      tile[14][j] = clamp(dir[3][p]);
      tile[15][j] = clamp(dir[4][p] - (tr - anch_r[p]));
      tile[19][j] = ok ? clamp(-r0) : 0;
      tile[20][j] = ok ? clamp(-r1) : 0;
      tile[21][j] = ok ? clamp(-r2) : 0;
      tile[22][j] = ok ? clamp(-r3) : 0;
      tile[23][j] = clamp(dir[5][p]);
      tile[24][j] = clamp(dir[6][p]);
      tile[25][j] = wrap(dir[7][p]);
    }
    for (int jb = 0; jb < TILE; jb += 16)
      for (int cb = 0; cb < 32; cb += 16)
        transpose16(&tile[cb][jb], TILE, &trows[jb][cb], 32);
    for (int j = 0; j < T; j++) {
      int8_t* row = ws.rows.data() + (size_t)(p0 + j) * F;
      memcpy(row, trows[j], FEATURES);
      memset(row + FEATURES, 0, F - FEATURES);
    }
    for (int j = 0; j < T; j++) {
      const double cov = std::max(1.0, (double)cov_t[j]);
      pass_t[j] = (uint8_t)((snp_t[j] / cov >= a.snp_freq) |
                            ((ins_c[p0 + j] / cov >= a.ins_freq) << 1) |
                            ((del_c[p0 + j] / cov >= a.del_freq) << 2));
    }
    for (int j = 0; j < T; j++) {
      if (!pass_t[j]) continue;
      const int64_t p = p0 + j, pos = a.region_start + p;
      if (pos < a.cand_region_start || pos > a.cand_region_end ||
          cov_t[j] < a.min_cov)
        continue;
      Site st{(int32_t)p, std::min<int32_t>(cov_t[j], MAXV),
              (pass_t[j] & 1) != 0, (pass_t[j] & 2) != 0,
              (pass_t[j] & 4) != 0, {}, {}};
      for (int l = 0; l < 4; l++) {
        st.fwd[l] = f[l][p];
        st.rev[l] = r[l][p];
      }
      ws.sites.push_back(st);
    }
  }
  memset(ws.rows.data() + (size_t)a.L * F, 0, F);  // the zero row L
}

// A site's alleles in the order of the oracle's string-keyed dict (the
// letters that differ from the reference, from the site's letter counts,
// and its events, sorted and counted by key) through the candidate gates,
// once. Returns the bytes of the candidate strings.
int64_t gate_sites(const Params& a, Workspace& ws) {
  // the events of each site, in a run of their own
  const size_t n_sites = ws.sites.size();
  for (size_t k = 0; k < n_sites; k++)
    ws.slot[ws.sites[k].idx] = (int32_t)k + 1;
  ws.bucket.assign(n_sites + 2, 0);
  for (const Event& e : ws.events)
    if (int32_t k = ws.slot[e.idx]) ws.bucket[k + 1]++;
  for (size_t k = 1; k < ws.bucket.size(); k++)
    ws.bucket[k] += ws.bucket[k - 1];
  ws.bucketed.resize(ws.bucket[n_sites + 1]);
  for (const Event& e : ws.events)
    if (int32_t k = ws.slot[e.idx]) ws.bucketed[ws.bucket[k]++] = e;
  // site k's run is now [bucket[k], bucket[k + 1])
  for (const Site& st : ws.sites) ws.slot[st.idx] = 0;

  auto ev_less = [](const Event& x, const Event& y) {
    return key_less(x.kind, x.key, x.len, y.kind, y.key, y.len);
  };
  int64_t cand_bytes = 0;
  for (size_t k = 0; k < n_sites; k++) {
    const Site& st = ws.sites[k];
    const int rl = LETTER.t[(unsigned char)a.ref[st.idx]];
    auto& al = ws.alleles;
    al.clear();
    for (int l = 0; l < 4; l++)
      if (l != rl && st.fwd[l] + st.rev[l] > 0)  // rl is 4 off ACGT
        al.push_back(Allele{LETTERS + l, 1, '1',
                            {st.fwd[l] + st.rev[l], st.fwd[l], st.rev[l]}});
    Event* b = ws.bucketed.data() + ws.bucket[k];
    Event* e = ws.bucketed.data() + ws.bucket[k + 1];
    std::sort(b, e, ev_less);
    for (Event* run = b; run != e;) {
      Allele al_run{run->key, run->len, run->kind, {}};
      for (; run != e && run->kind == al_run.kind && run->len == al_run.len &&
             memcmp(run->key, al_run.key, al_run.len) == 0;
           run++) {
        al_run.ac.total += 1;
        if (run->rev) al_run.ac.rev += 1; else al_run.ac.fwd += 1;
      }
      al.push_back(al_run);
    }
    std::sort(al.begin(), al.end(), [](const Allele& x, const Allele& y) {
      return key_less(x.kind, x.key, x.len, y.kind, y.key, y.len);
    });
    for (const Allele& al_k : al) {
      const char kind = al_k.kind;
      const AlleleCount& ac = al_k.ac;
      double freq = ac.total / std::max(1.0, (double)st.depth);
      if (ac.total < a.cand_support) continue;
      if (kind != '1' && freq < a.indel_cand_freq) continue;
      if (kind == '1' && freq < a.snp_cand_freq) continue;
      if (kind != '1' && a.skip_indels) continue;
      if ((kind == '1' && !st.snp) || (kind == '2' && !st.ins) ||
          (kind == '3' && !st.del))
        continue;
      ws.cands.push_back(Cand{al_k.key, st.idx, al_k.len, st.depth, kind, ac});
      cand_bytes += 1 + al_k.len;
    }
  }
  const int64_t n = (int64_t)ws.cands.size();
  return n > 1 ? cand_bytes + n - 1 : cand_bytes;  // '\n' separators
}

// render: the result, each candidate's window copied from the rows with
// its allele's marks at the midpoint
EncodeResult* render(const Params& a, const Workspace& ws,
                     const Labels* labels, int64_t cand_bytes) {
  const int64_t n = (int64_t)ws.cands.size();
  const int F = a.features, window_size = a.window_size;
  const int win1 = window_size + 1, half = window_size / 2;
  EncodeResult* r = alloc_result(n, cand_bytes, win1, F);
  if (!r) return nullptr;
  char* cb = r->cand_buf;
  std::string cand;
  for (int64_t ci = 0; ci < n; ci++) {
    const Cand& c = ws.cands[ci];
    const int64_t idx = c.idx;
    int base_label = 0, type_label = 0;
    if (labels) {
      cand.assign(1, c.kind);
      cand.append(c.key, c.len);
      type_label = labels->type_label(idx, cand);
      base_label = labels->labels[idx];
    }

    int8_t* img = r->images + (size_t)ci * win1 * F;
    const int64_t lo = idx - half;
    const int64_t src_lo = std::max<int64_t>(lo, 0);
    const int64_t src_hi = std::min<int64_t>(idx + half, a.L) + 1;
    const size_t head = (size_t)(src_lo - lo) * F;
    const size_t body = (size_t)(src_hi - src_lo) * F;
    memset(img, 0, head);
    memcpy(img + head, ws.rows.data() + (size_t)src_lo * F, body);
    memset(img + head + body, 0, (size_t)win1 * F - head - body);

    const char ref_base = a.ref[idx];
    const int mid = half;
    const int fwd_c = std::min(c.ac.fwd, MAXV), rev_c = std::min(c.ac.rev, MAXV);
    auto M = [&](int row, int col) -> int8_t& {
      return img[(size_t)row * F + col];
    };
    if (c.kind == '1') {
      int ffi = feature_index(ref_base, c.key[0], false);
      int rfi = feature_index(ref_base, c.key[0], true);
      M(mid, 1) = ref_value(c.key[0]);
      M(mid, 5) = fwd_c;
      M(mid, 16) = rev_c;
      if (ffi >= 0) { M(mid, ffi) = -M(mid, ffi); M(mid, rfi) = -M(mid, rfi); }
    } else if (c.kind == '2') {
      int ffi = feature_index(ref_base, 'I', false);
      int rfi = feature_index(ref_base, 'I', true);
      M(mid, 2) = std::min(c.len, MAXV);
      M(mid, 6) = fwd_c;
      M(mid, 17) = rev_c;
      if (ffi >= 0) { M(mid, ffi) = -M(mid, ffi); M(mid, rfi) = -M(mid, rfi); }
    } else {
      int del_len = c.len;
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

    r->positions[ci] = a.region_start + idx;
    r->depths[ci] = c.depth;
    r->type_labels[ci] = type_label;
    r->base_labels[ci] = base_label;
    r->cand_freqs[ci] = std::min(c.ac.total, MAXV);
    if (ci) *cb++ = '\n';
    *cb++ = c.kind;
    memcpy(cb, c.key, c.len);
    cb += c.len;
  }
  return r;
}

}  // namespace

extern "C" EncodeResult* encode_region(
    const char* bam_path, const uint64_t* chunks, int n_chunks,
    int32_t ref_id, int64_t fetch_start, int64_t fetch_stop,
    int64_t region_start, int64_t region_end, const char* ref_seq,
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
  if (feature_size < FEATURES) return nullptr;
  const Params a{region_start, region_end, region_end - region_start + 1,
                 ref_seq, min_snp_baseq, min_indel_baseq, snp_freq, ins_freq,
                 del_freq, min_cov, snp_cand_freq, indel_cand_freq,
                 cand_support, skip_indels != 0, cand_region_start,
                 cand_region_end, window_size, feature_size};
  // thread CPU seconds of the sections: fetch, walk, site, render
  double seconds[4];
  double t_lap = thread_cpu_s();
  auto lap = [&](int section) {
    const double now = thread_cpu_s();
    seconds[section] = now - t_lap;
    t_lap = now;
  };
  Workspace& ws = workspace();
  ws.reset(a.L, feature_size);

  fetch_reads(bam_path, chunks, n_chunks, ref_id, fetch_start, fetch_stop,
              include_suppl != 0, min_mapq, max_reads, downsample_rate,
              random_seed, ws);
  lap(0);
  walk_reads(a, ws);
  lap(1);
  build_rows(a, ws);
  std::unique_ptr<Labels> labels;
  if (train_mode) {
    const TruthArgs hap[2] = {
        {n_t1, t1_pos, t1_end, t1_ref_off, t1_alt_off, t1_ref_buf, t1_alt_buf},
        {n_t2, t2_pos, t2_end, t2_ref_off, t2_alt_off, t2_ref_buf, t2_alt_buf}};
    labels.reset(new Labels(hap, region_start, a.L, ref_seq));
  }
  lap(2);
  const int64_t cand_bytes = gate_sites(a, ws);
  EncodeResult* r = render(a, ws, labels.get(), cand_bytes);
  if (!r) return nullptr;
  lap(3);
  memcpy(r->seconds, seconds, sizeof(seconds));
  return r;
}


// ---------------------------------------------------------------------------
// PEPPER-HP fused encoder — port of the tested oracle
// pepper_tpu/encode/region_encoder_hp.py (48-feature dual-haplotype windows;
// see that file's docstring for the HP-specific semantics preserved here).
// ---------------------------------------------------------------------------

namespace {

struct Out {
  std::vector<int64_t> positions;
  std::vector<int32_t> depths, type_labels, base_labels, cand_freqs;
  std::vector<char> cand_buf;  // the candidates, separated by '\n'
  std::vector<int8_t> images;
};

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
  std::unique_ptr<Labels> labels;
  if (train_mode) {
    const TruthArgs hap[2] = {
        {n_t1, t1_pos, t1_end, t1_ref_off, t1_alt_off, t1_ref_buf, t1_alt_buf},
        {n_t2, t2_pos, t2_end, t2_ref_off, t2_alt_off, t2_ref_buf, t2_alt_buf}};
    labels.reset(new Labels(hap, region_start, L, ref_seq.c_str()));
  }

  // candidate windows (21x48; per-HP supports at the midpoint, no sign flips)
  Out out;
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
      if (labels) {
        type_label = labels->type_label(idx, cand);
        base_label = labels->labels[idx];
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
      if (!out.cand_buf.empty()) out.cand_buf.push_back('\n');
      out.cand_buf.insert(out.cand_buf.end(), cand.begin(), cand.end());
      out.images.insert(out.images.end(), image.begin(), image.end());
    }
  }

  const int64_t n = (int64_t)out.positions.size();
  EncodeResult* r = alloc_result(n, (int64_t)out.cand_buf.size(), win1,
                                 feature_size);
  if (!r) return nullptr;
  memcpy(r->positions, out.positions.data(), n * 8);
  memcpy(r->depths, out.depths.data(), n * 4);
  memcpy(r->type_labels, out.type_labels.data(), n * 4);
  memcpy(r->base_labels, out.base_labels.data(), n * 4);
  memcpy(r->cand_freqs, out.cand_freqs.data(), n * 4);
  memcpy(r->images, out.images.data(), out.images.size());
  memcpy(r->cand_buf, out.cand_buf.data(), out.cand_buf.size());
  return r;
}
