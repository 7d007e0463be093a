// refpack: native index-construction library for hsa-tpu.
//
// Plain C ABI (loaded from Python via ctypes — pybind11 is unavailable in
// this environment, SURVEY.md §7.1).  Covers the reference lineage's index
// build path (`bwtindex.c`: fasta→pac→bwt→sa) minus FASTA parsing, which the
// Python layer handles: suffix array (SA-IS), BWT + primary, sampled-SA mark
// structures, and 2-bit packing.
//
// All functions return 0 on success, negative on error.  Caller allocates
// all output buffers (numpy arrays on the Python side).

#include <cstdint>
#include <cstring>

#include "sais.hpp"

extern "C" {

int rp_version() { return 1; }

// SA of text+$ (n+1 entries).  Chooses int32 internally when n+1 < 2^31.
int rp_suffix_array64(const uint8_t* text, int64_t n, int64_t* sa_out) {
  if (n < 0) return -1;
  if (n + 2 < (int64_t)1 << 31) {
    std::vector<int32_t> sa32((size_t)n + 1);
    refpack::suffix_array<int32_t>(text, (int32_t)n, sa32.data());
    for (int64_t i = 0; i <= n; ++i) sa_out[i] = sa32[(size_t)i];
  } else {
    refpack::suffix_array<int64_t>(text, n, sa_out);
  }
  return 0;
}

// Test hook: always use the int64 SA-IS instantiation (the production entry
// only selects it for n+2 >= 2^31; this keeps the big-genome path covered by
// small tests).
int rp_suffix_array64_force(const uint8_t* text, int64_t n, int64_t* sa_out) {
  if (n < 0) return -1;
  refpack::suffix_array<int64_t>(text, n, sa_out);
  return 0;
}

// Stored BWT (sentinel row removed, length n) + primary rank.
// text codes 0..3; sa has n+1 entries.
int rp_bwt_from_sa(const uint8_t* text, const int64_t* sa, int64_t n,
                   uint8_t* bwt_out, int64_t* primary_out) {
  int64_t j = 0, primary = -1;
  for (int64_t r = 0; r <= n; ++r) {
    int64_t p = sa[r];
    if (p == 0) {
      primary = r;
    } else {
      bwt_out[j++] = text[p - 1];
    }
  }
  if (primary < 0 || j != n) return -1;
  *primary_out = primary;
  return 0;
}

// Fused build: SA + BWT + primary + text-position-sampled SA marks.
//   marks_out: one byte per rank r in 0..n, 1 iff sa[r] % sa_intv == 0
//   samples_out: SA values of marked ranks in rank order (caller sizes it
//                at (n / sa_intv) + 2; actual count returned via n_samples)
// sa_out may be NULL if the full SA is not wanted (it is still computed
// internally).
int rp_build(const uint8_t* text, int64_t n, int64_t sa_intv,
             int64_t* sa_out, uint8_t* bwt_out, int64_t* primary_out,
             uint8_t* marks_out, int64_t* samples_out, int64_t* n_samples_out) {
  std::vector<int64_t> sa_buf;
  int64_t* sa = sa_out;
  if (!sa) {
    sa_buf.resize((size_t)n + 1);
    sa = sa_buf.data();
  }
  if (rp_suffix_array64(text, n, sa) != 0) return -1;
  if (rp_bwt_from_sa(text, sa, n, bwt_out, primary_out) != 0) return -2;
  int64_t ns = 0;
  for (int64_t r = 0; r <= n; ++r) {
    if (sa[r] % sa_intv == 0) {
      marks_out[r] = 1;
      samples_out[ns++] = sa[r];
    } else {
      marks_out[r] = 0;
    }
  }
  *n_samples_out = ns;
  return 0;
}

// 2-bit pack codes (0..3) little-end-first within each byte: 4 codes/byte.
// The packed form is the `.pac` analog (lineage: bntseq.c).
int rp_pack_2bit(const uint8_t* codes, int64_t n, uint8_t* packed_out) {
  int64_t nb = (n + 3) / 4;
  std::memset(packed_out, 0, (size_t)nb);
  for (int64_t i = 0; i < n; ++i)
    packed_out[i >> 2] |= (uint8_t)((codes[i] & 3) << ((i & 3) << 1));
  return 0;
}

int rp_unpack_2bit(const uint8_t* packed, int64_t n, uint8_t* codes_out) {
  for (int64_t i = 0; i < n; ++i)
    codes_out[i] = (packed[i >> 2] >> ((i & 3) << 1)) & 3;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FASTQ batch reader (lineage: kseq.h + bwaseqio.c roles).
// Parses records out of an in-memory (typically mmap'd) buffer directly into
// the search engine's batch layout: codes [max_reads x max_len] filled with
// PAD=5, plus name/qual byte ranges into the buffer (zero-copy for Python).
// ---------------------------------------------------------------------------

namespace {
struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    for (int i = 0; i < 256; ++i) t[i] = 4;
    t['A'] = t['a'] = 0;
    t['C'] = t['c'] = 1;
    t['G'] = t['g'] = 2;
    t['T'] = t['t'] = 3;
  }
};
const CodeTable kCodes;

inline const char* find_nl(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p;
}
}  // namespace

extern "C" {

// Returns #reads parsed (>=0) or -1 on malformed input. *pos_io advances to
// the first unconsumed byte. Over-long reads are truncated to max_len (true
// length still reported in lens_out, capped at 1<<20).
int rp_fastq_batch(const char* buf, int64_t buflen, int64_t* pos_io,
                   int32_t max_reads, int32_t max_len,
                   uint8_t* codes_out, int32_t* lens_out,
                   int64_t* name_off, int32_t* name_len,
                   int64_t* qual_off, int32_t* qual_len) {
  const char* base = buf;
  const char* p = buf + *pos_io;
  const char* end = buf + buflen;
  int n = 0;
  while (n < max_reads) {
    const char* rec_start = p;
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    if (*p != '@') return -1;
    const char* h = p + 1;
    const char* he = find_nl(h, end);
    if (he >= end) { p = rec_start; break; }  // incomplete record: stop
    const char* hs_end = h;
    while (hs_end < he && *hs_end != ' ' && *hs_end != '\t' && *hs_end != '\r')
      ++hs_end;
    const char* s = he + 1;
    const char* se = find_nl(s, end);
    if (se >= end) { p = rec_start; break; }
    const char* plus = se + 1;
    if (plus >= end || *plus != '+') { p = rec_start; break; }
    const char* pe = find_nl(plus, end);
    if (pe >= end) { p = rec_start; break; }
    const char* q = pe + 1;
    int64_t slen = se - s;
    if (slen > 0 && s[slen - 1] == '\r') --slen;
    if (q + slen > end) { p = rec_start; break; }
    const char* qe = q + slen;

    name_off[n] = h - base;
    name_len[n] = (int32_t)(hs_end - h);
    qual_off[n] = q - base;
    qual_len[n] = (int32_t)slen;
    int32_t L = (int32_t)(slen < max_len ? slen : max_len);
    uint8_t* row = codes_out + (int64_t)n * max_len;
    for (int32_t i = 0; i < L; ++i) row[i] = kCodes.t[(uint8_t)s[i]];
    for (int32_t i = L; i < max_len; ++i) row[i] = 5;  // PAD
    lens_out[n] = (int32_t)(slen < (1 << 20) ? slen : (1 << 20));
    ++n;
    p = qe;
    if (p < end && *p == '\r') ++p;
    if (p < end && *p == '\n') ++p;
  }
  *pos_io = p - base;
  return n;
}

}  // extern "C"

#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Pigeon-engine batch packer (host side of hsa_tpu_torch.search.pigeon).
//
// Packs a forward-strand codes matrix (both strands emitted here) into the
// fused uint32 upload buffer of pack_pigeon_upload: regions
//   [segs4 R*S4][soff|slen R][kmer|ok<<24|short<<25 R]
//   [rw B2*RW][nmask B2*RW][lens|md<<16 B2]
// with R = n_seg*B2, lanes seg-major (r = s*B2 + lane), lane j in [0,B)
// forward and lane B+j its reverse complement.  Bit-for-bit equal to the
// numpy packer, pack_pigeon_batch + pack_pigeon_upload
// (tests/test_torch_pigeon.py); threaded scalar code.


extern "C" int rp_pigeon_pack(
    const uint8_t* codes, const int32_t* lens, const int32_t* md,
    int64_t B, int64_t Lmax, int32_t n_seg, int32_t K, int32_t tail,
    uint32_t* buf) {
  if (B <= 0 || Lmax <= 0 || n_seg <= 0) return -1;
  const int64_t B2 = 2 * B;
  const int64_t seg_max = (Lmax + n_seg - 1) / n_seg + 1;
  int64_t SL;
  if (K > 0) {
    SL = seg_max - K < (int64_t)tail ? seg_max - K : (int64_t)tail;
    if (SL < 1) SL = 1;
  } else {
    SL = seg_max > 1 ? seg_max : 1;
  }
  const int64_t RW = (Lmax + 15) / 16 + 1;
  const int64_t S4 = (SL + 3) / 4;
  const int64_t R = (int64_t)n_seg * B2;
  uint32_t* segs4 = buf;
  uint32_t* soff_len = segs4 + R * S4;
  uint32_t* kmer_fl = soff_len + R;
  uint32_t* rw = kmer_fl + R;
  uint32_t* nmask = rw + B2 * RW;
  uint32_t* lens_md = nmask + B2 * RW;

  uint32_t pow4[16];
  pow4[0] = 1;
  for (int i = 1; i < 16; ++i) pow4[i] = pow4[i - 1] * 4;

  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<uint8_t> segbytes(SL);
    for (int64_t lane = lo; lane < hi; ++lane) {
      const int64_t j = lane % B;
      const bool rc = lane >= B;
      const int32_t L = lens[j];
      const uint8_t* row = codes + j * Lmax;
      auto get = [&](int64_t i) -> uint8_t {
        uint8_t c = row[rc ? (L - 1 - i) : i];
        return (rc && c <= 3) ? (uint8_t)(3 - c) : c;
      };
      // packed read words + N mask
      for (int64_t w = 0; w < RW; ++w) {
        uint32_t rwv = 0, nmv = 0;
        const int64_t base = w * 16;
        for (int b16 = 0; b16 < 16; ++b16) {
          const int64_t p = base + b16;
          if (p < L) {
            const uint8_t c = get(p);
            if (c <= 3) rwv |= (uint32_t)c << (2 * b16);
            else nmv |= 1u << (2 * b16);
          }
        }
        rw[lane * RW + w] = rwv;
        nmask[lane * RW + w] = nmv;
      }
      lens_md[lane] = (uint32_t)L | ((uint32_t)md[j] << 16);
      // per-segment anchors
      for (int32_t s = 0; s < n_seg; ++s) {
        const int64_t r = (int64_t)s * B2 + lane;
        const int64_t a = (int64_t)L * s / n_seg;
        const int64_t b = (int64_t)L * (s + 1) / n_seg;
        const int64_t w = b - a;
        for (int64_t t = 0; t < SL; ++t) segbytes[t] = 5;  // PAD
        int64_t slen = 0, soff = a;
        uint32_t kmer = 0, ok = 0, sshort = 0;
        if (K > 0) {
          if (w >= K) {
            ok = 1;
            for (int32_t t = 0; t < K; ++t) {
              const uint8_t c = get(b - 1 - t);
              if (c > 3) { ok = 0; break; }
              kmer += (uint32_t)c * pow4[K - 1 - t];
            }
          }
          sshort = (w > 0 && w < K) ? 1u : 0u;
          if (ok) {
            const int64_t A = w < (int64_t)(K + tail) ? w : (int64_t)(K + tail);
            slen = A - K;
            soff = b - A;
            const int64_t nt = slen < SL ? slen : SL;
            for (int64_t t = 0; t < nt; ++t) segbytes[t] = get(b - 1 - K - t);
          } else {
            kmer = 0;
          }
        } else {
          const int64_t nt = (w < SL ? w : SL);
          for (int64_t t = 0; t < nt; ++t) segbytes[t] = get(b - 1 - t);
          slen = w > 0 ? w : 0;
        }
        for (int64_t t4 = 0; t4 < S4; ++t4) {
          uint32_t v = 0;
          for (int q = 0; q < 4; ++q) {
            const int64_t t = t4 * 4 + q;
            if (t < SL) v |= (uint32_t)segbytes[t] << (8 * q);
          }
          segs4[r * S4 + t4] = v;
        }
        soff_len[r] = (uint32_t)soff | ((uint32_t)slen << 16);
        kmer_fl[r] = kmer | (ok << 24) | (sshort << 25);
      }
    }
  };

  const int nthreads = B2 > 4096 ? 8 : 1;
  if (nthreads == 1) {
    work(0, B2);
  } else {
    std::vector<std::thread> ts;
    const int64_t step = (B2 + nthreads - 1) / nthreads;
    for (int i = 0; i < nthreads; ++i) {
      const int64_t lo = i * step;
      const int64_t hi = lo + step < B2 ? lo + step : B2;
      if (lo < hi) ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Banded global DP (hsa_tpu.resolve.cigar.banded_global, scalar port).
//
// Exact mirror of the numpy reference — same BIG sentinel, band clipping,
// affine recurrences, free-end-column selection (first minimum), and the
// M > D > I traceback tie-break — so CIGARs are byte-identical (fuzzed in
// tests/test_refpack.py).  ops_out bytes: 0=M, 1=I, 2=D, in read order.

static int banded_core(
    const uint8_t* read, int32_t L, const uint8_t* ref, int32_t G,
    int32_t s_mm, int32_t s_gapo, int32_t s_gape, int32_t band,
    uint8_t* ops_out, int32_t* n_ops, int32_t* cost_out, int32_t* jend_out) {
  if (L < 0 || G < 0) return -1;
  if (band < 1) band = 1;
  const int32_t BIG = 1 << 28;
  const int64_t W = (int64_t)G + 1;
  std::vector<int32_t> m((L + 1) * W, BIG), ins((L + 1) * W, BIG),
      dele((L + 1) * W, BIG);
  auto M = [&](int64_t i, int64_t j) -> int32_t& { return m[i * W + j]; };
  auto I = [&](int64_t i, int64_t j) -> int32_t& { return ins[i * W + j]; };
  auto D = [&](int64_t i, int64_t j) -> int32_t& { return dele[i * W + j]; };
  M(0, 0) = 0;
  {
    const int64_t jmax = G < (int64_t)L + band ? G : (int64_t)L + band;
    for (int64_t j = 1; j <= jmax; ++j) D(0, j) = s_gapo + (j - 1) * s_gape;
    const int64_t imax = L < band ? L : band;
    for (int64_t i = 1; i <= imax; ++i) I(i, 0) = s_gapo + (i - 1) * s_gape;
  }
  for (int64_t i = 1; i <= L; ++i) {
    int64_t jlo = i - band > 1 ? i - band : 1;
    int64_t jhi = i + band < G ? i + band : G;
    if (jlo > jhi) continue;
    for (int64_t j = jlo; j <= jhi; ++j) {
      int32_t sub = (read[i - 1] > 3 || read[i - 1] != ref[j - 1]) ? s_mm : 0;
      int32_t bp = M(i - 1, j - 1);
      if (I(i - 1, j - 1) < bp) bp = I(i - 1, j - 1);
      if (D(i - 1, j - 1) < bp) bp = D(i - 1, j - 1);
      M(i, j) = bp + sub;
      int32_t iv = M(i - 1, j) + s_gapo;
      int32_t iv2 = I(i - 1, j) + s_gape;
      I(i, j) = iv < iv2 ? iv : iv2;
      int32_t dv = M(i, j - 1) + s_gapo;
      int32_t dv2 = D(i, j - 1) + s_gape;
      D(i, j) = dv < dv2 ? dv : dv2;
    }
  }
  // free end in ref: best over all states and end columns (first min)
  int64_t jend = 0;
  int32_t best = BIG + 1;
  for (int64_t j = 0; j <= G; ++j) {
    int32_t t = M(L, j);
    if (I(L, j) < t) t = I(L, j);
    if (D(L, j) < t) t = D(L, j);
    if (t < best) { best = t; jend = j; }
  }
  *cost_out = best;
  *jend_out = (int32_t)jend;
  // traceback, M > D > I preference
  int64_t i = L, j = jend;
  int32_t state;
  {
    int32_t vals[3] = {M(L, jend), D(L, jend), I(L, jend)};
    state = 0;
    if (vals[1] < vals[state]) state = 1;
    if (vals[2] < vals[state]) state = 2;
  }
  int32_t n = 0;
  while (i > 0 || j > 0) {
    if (i == 0) { ops_out[n++] = 2; --j; continue; }
    if (j == 0) { ops_out[n++] = 1; --i; continue; }
    if (state == 0) {
      int32_t sub = (read[i - 1] > 3 || read[i - 1] != ref[j - 1]) ? s_mm : 0;
      int32_t target = M(i, j) - sub;
      int32_t prev[3] = {M(i - 1, j - 1), D(i - 1, j - 1), I(i - 1, j - 1)};
      for (int s = 0; s < 3; ++s)
        if (prev[s] == target) { state = s; break; }
      ops_out[n++] = 0; --i; --j;
    } else if (state == 1) {
      state = (M(i, j - 1) + s_gapo == D(i, j)) ? 0 : 1;
      ops_out[n++] = 2; --j;
    } else {
      state = (M(i - 1, j) + s_gapo == I(i, j)) ? 0 : 2;
      ops_out[n++] = 1; --i;
    }
  }
  // ops were emitted back-to-front; reverse
  for (int32_t a = 0, b = n - 1; a < b; ++a, --b) {
    uint8_t t = ops_out[a]; ops_out[a] = ops_out[b]; ops_out[b] = t;
  }
  *n_ops = n;
  return 0;
}

extern "C" int rp_banded_global(
    const uint8_t* read, int32_t L, const uint8_t* ref, int32_t G,
    int32_t s_mm, int32_t s_gapo, int32_t s_gape, int32_t band,
    uint8_t* ops_out, int32_t* n_ops, int32_t* cost_out, int32_t* jend_out) {
  return banded_core(read, L, ref, G, s_mm, s_gapo, s_gape, band,
                     ops_out, n_ops, cost_out, jend_out);
}

// ---------------------------------------------------------------------------
// Batched banded DP + record stats (the gapped record cores of
// hsa_tpu.resolve.samse/sampe).  One call replaces thousands of per-record
// ctypes round trips (~40us each — they dominated gapped-config host
// resolution), and the textual CIGAR, MD tag, NM, and gap-base count are
// emitted here so the Python record loop does f-string assembly only.
// Semantics mirror resolve.cigar.cigar_stats exactly (fuzz-tested).

static inline int32_t put_u32(uint8_t* dst, uint32_t v) {
  char tmp[12];
  int32_t k = 0;
  if (v == 0) tmp[k++] = '0';
  while (v) { tmp[k++] = (char)('0' + v % 10); v /= 10; }
  for (int32_t a = 0; a < k; ++a) dst[a] = (uint8_t)tmp[k - 1 - a];
  return k;
}

static const char kBase[6] = {'A', 'C', 'G', 'T', 'N', 'N'};

static void banded_batch_range(
    const uint8_t* reads, const int64_t* r_off, const int32_t* r_len,
    const uint8_t* text, const int64_t* g_off, const int32_t* g_len,
    int32_t lo, int32_t hi, int32_t s_mm, int32_t s_gapo, int32_t s_gape,
    const int32_t* band, uint8_t* cig_txt, int32_t cig_cap, int32_t* cig_n,
    uint8_t* md_txt, int32_t md_cap, int32_t* md_n,
    int32_t* nm_out, int32_t* glen_out, int32_t* gapb_out, int* err) {
  std::vector<uint8_t> ops;
  for (int32_t it = lo; it < hi; ++it) {
    const uint8_t* rd = reads + r_off[it];
    const uint8_t* rf = text + g_off[it];
    const int32_t L = r_len[it], G = g_len[it];
    ops.resize((size_t)L + G + 2);
    int32_t n_ops = 0, cost = 0, jend = 0;
    int rc = banded_core(rd, L, rf, G, s_mm, s_gapo, s_gape, band[it],
                         ops.data(), &n_ops, &cost, &jend);
    if (rc != 0) { *err = rc; return; }
    glen_out[it] = jend;
    // one pass over ops: RLE cigar text + MD + NM + gap bases
    uint8_t* ct = cig_txt + (int64_t)it * cig_cap;
    uint8_t* mt = md_txt + (int64_t)it * md_cap;
    int32_t cn = 0, mn = 0, nm = 0, gapb = 0;
    int32_t i = 0, j = 0, match_run = 0;
    int32_t p = 0;
    while (p < n_ops) {
      int32_t q = p;
      const uint8_t op = ops[p];
      while (q < n_ops && ops[q] == op) ++q;
      const int32_t run = q - p;
      if (cn + 14 > cig_cap || mn + 14 + run > md_cap) { *err = -3; return; }
      cn += put_u32(ct + cn, (uint32_t)run);
      if (op == 0) {          // M
        ct[cn++] = 'M';
        for (int32_t t = 0; t < run; ++t, ++i, ++j) {
          if (rd[i] <= 3 && rd[i] == rf[j]) { ++match_run; continue; }
          ++nm;
          if (mn + 14 > md_cap) { *err = -3; return; }
          mn += put_u32(mt + mn, (uint32_t)match_run);
          mt[mn++] = (uint8_t)kBase[rf[j] < 4 ? rf[j] : 4];
          match_run = 0;
        }
      } else if (op == 1) {   // I (consumes read)
        ct[cn++] = 'I';
        nm += run; gapb += run; i += run;
      } else {                // D (consumes ref)
        ct[cn++] = 'D';
        nm += run; gapb += run;
        mn += put_u32(mt + mn, (uint32_t)match_run);
        match_run = 0;
        mt[mn++] = '^';
        for (int32_t t = 0; t < run; ++t, ++j)
          mt[mn++] = (uint8_t)kBase[rf[j] < 4 ? rf[j] : 4];
      }
      p = q;
    }
    if (mn + 12 > md_cap) { *err = -3; return; }
    mn += put_u32(mt + mn, (uint32_t)match_run);
    cig_n[it] = cn;
    md_n[it] = mn;
    nm_out[it] = nm;
    gapb_out[it] = gapb;
  }
}

extern "C" int rp_banded_batch(
    const uint8_t* reads, const int64_t* r_off, const int32_t* r_len,
    const uint8_t* text, const int64_t* g_off, const int32_t* g_len,
    int32_t n, int32_t s_mm, int32_t s_gapo, int32_t s_gape,
    const int32_t* band,
    uint8_t* cig_txt, int32_t cig_cap, int32_t* cig_n,
    uint8_t* md_txt, int32_t md_cap, int32_t* md_n,
    int32_t* nm_out, int32_t* glen_out, int32_t* gapb_out) {
  if (n < 0) return -1;
  int errs[8] = {0};
  const int nthreads = n > 512 ? 8 : 1;
  if (nthreads == 1) {
    banded_batch_range(reads, r_off, r_len, text, g_off, g_len, 0, n,
                       s_mm, s_gapo, s_gape, band, cig_txt, cig_cap, cig_n,
                       md_txt, md_cap, md_n, nm_out, glen_out, gapb_out,
                       &errs[0]);
  } else {
    std::vector<std::thread> ts;
    const int32_t step = (n + nthreads - 1) / nthreads;
    for (int i = 0; i < nthreads; ++i) {
      const int32_t lo = i * step;
      const int32_t hi = lo + step < n ? lo + step : n;
      if (lo >= hi) break;
      ts.emplace_back(banded_batch_range, reads, r_off, r_len, text, g_off,
                      g_len, lo, hi, s_mm, s_gapo, s_gape, band, cig_txt,
                      cig_cap, cig_n, md_txt, md_cap, md_n, nm_out, glen_out,
                      gapb_out, &errs[i]);
    }
    for (auto& t : ts) t.join();
  }
  for (int i = 0; i < nthreads && i < 8; ++i)
    if (errs[i] != 0) return errs[i];
  return 0;
}

// ---------------------------------------------------------------------------
// Glocal DP (free ref start/end, full read) — the mate-rescue aligner.
// Exact twin of hsa_tpu.resolve.sampe.fit_in_window (tested equal):
// row 0 of M is 0 at every column (free start anywhere in the window),
// cost is min over states at row L with the FIRST minimal end column,
// traceback prefers M > D > I and matches by value equality.
// Lineage role: bwa_paired_sw / stdaln.c (SURVEY.md §3.4).
// ---------------------------------------------------------------------------

static int glocal_core(
    const uint8_t* read, int32_t L, const uint8_t* win, int32_t G,
    int32_t s_mm, int32_t s_gapo, int32_t s_gape,
    uint8_t* ops_out, int32_t ops_cap, int32_t* n_ops,
    int32_t* cost_out, int32_t* start_out) {
  if (L < 0 || G < 0) return -1;
  const int32_t BIG = 1 << 28;
  const int64_t W = (int64_t)G + 1;
  std::vector<int32_t> m((L + 1) * W, BIG), ins((L + 1) * W, BIG),
      dele((L + 1) * W, BIG);
  auto M = [&](int64_t i, int64_t j) -> int32_t& { return m[i * W + j]; };
  auto I = [&](int64_t i, int64_t j) -> int32_t& { return ins[i * W + j]; };
  auto D = [&](int64_t i, int64_t j) -> int32_t& { return dele[i * W + j]; };
  for (int64_t j = 0; j <= G; ++j) M(0, j) = 0;   // free start
  for (int64_t i = 1; i <= L; ++i) {
    // ins column 0 first (the only j=0 state that updates)
    {
      int32_t iv = M(i - 1, 0) + s_gapo;
      int32_t iv2 = I(i - 1, 0) + s_gape;
      I(i, 0) = iv < iv2 ? iv : iv2;
    }
    for (int64_t j = 1; j <= G; ++j) {
      int32_t sub = (read[i - 1] > 3 || read[i - 1] != win[j - 1]) ? s_mm : 0;
      int32_t bp = M(i - 1, j - 1);
      if (I(i - 1, j - 1) < bp) bp = I(i - 1, j - 1);
      if (D(i - 1, j - 1) < bp) bp = D(i - 1, j - 1);
      M(i, j) = bp + sub;
      int32_t iv = M(i - 1, j) + s_gapo;
      int32_t iv2 = I(i - 1, j) + s_gape;
      I(i, j) = iv < iv2 ? iv : iv2;
      int32_t dv = M(i, j - 1) + s_gapo;
      int32_t dv2 = D(i, j - 1) + s_gape;
      D(i, j) = dv < dv2 ? dv : dv2;
    }
  }
  int64_t jend = 0;
  int32_t best = M(L, 0);
  if (I(L, 0) < best) best = I(L, 0);
  if (D(L, 0) < best) best = D(L, 0);
  for (int64_t j = 1; j <= G; ++j) {
    int32_t t = M(L, j);
    if (I(L, j) < t) t = I(L, j);
    if (D(L, j) < t) t = D(L, j);
    if (t < best) { best = t; jend = j; }   // strict: FIRST min wins
  }
  *cost_out = best;
  if (best >= BIG) { *n_ops = 0; *start_out = -1; return 0; }
  // traceback (state order m > dele > ins, matching np.argmin order)
  int64_t i = L, j = jend;
  int32_t state = 0;
  {
    int32_t vals[3] = {M(L, jend), D(L, jend), I(L, jend)};
    if (vals[1] < vals[state]) state = 1;
    if (vals[2] < vals[state]) state = 2;
  }
  int32_t n = 0;
  while (i > 0) {
    if (n >= ops_cap) return -2;
    if (j == 0) { ops_out[n++] = 1; --i; continue; }   // I
    if (state == 0) {
      int32_t sub = (read[i - 1] > 3 || read[i - 1] != win[j - 1]) ? s_mm : 0;
      int32_t target = M(i, j) - sub;
      int32_t prev[3] = {M(i - 1, j - 1), D(i - 1, j - 1), I(i - 1, j - 1)};
      for (int s = 0; s < 3; ++s)
        if (prev[s] == target) { state = s; break; }
      ops_out[n++] = 0; --i; --j;                      // M
    } else if (state == 1) {
      state = (M(i, j - 1) + s_gapo == D(i, j)) ? 0 : 1;
      ops_out[n++] = 2; --j;                           // D
    } else {
      state = (M(i - 1, j) + s_gapo == I(i, j)) ? 0 : 2;
      ops_out[n++] = 1; --i;                           // I
    }
  }
  for (int32_t a = 0, b = n - 1; a < b; ++a, --b) {
    uint8_t t = ops_out[a]; ops_out[a] = ops_out[b]; ops_out[b] = t;
  }
  *n_ops = n;
  *start_out = (int32_t)j;
  return 0;
}

static void glocal_batch_range(
    const uint8_t* reads, const int64_t* r_off, const int32_t* r_len,
    const uint8_t* text, const int64_t* w_off, const int32_t* w_len,
    int32_t lo, int32_t hi, int32_t s_mm, int32_t s_gapo, int32_t s_gape,
    uint8_t* ops_out, int32_t ops_cap, int32_t* n_ops,
    int32_t* cost_out, int32_t* start_out, int* err) {
  for (int32_t i = lo; i < hi; ++i) {
    int rc = glocal_core(reads + r_off[i], r_len[i], text + w_off[i],
                         w_len[i], s_mm, s_gapo, s_gape,
                         ops_out + (int64_t)i * ops_cap, ops_cap,
                         n_ops + i, cost_out + i, start_out + i);
    if (rc != 0) { *err = rc; return; }
  }
}

extern "C" int rp_glocal_batch(
    const uint8_t* reads, const int64_t* r_off, const int32_t* r_len,
    const uint8_t* text, const int64_t* w_off, const int32_t* w_len,
    int32_t n, int32_t s_mm, int32_t s_gapo, int32_t s_gape,
    uint8_t* ops_out, int32_t ops_cap, int32_t* n_ops,
    int32_t* cost_out, int32_t* start_out) {
  if (n < 0) return -1;
  int errs[8] = {0};
  const int nthreads = n > 64 ? 8 : 1;
  if (nthreads == 1) {
    glocal_batch_range(reads, r_off, r_len, text, w_off, w_len, 0, n,
                       s_mm, s_gapo, s_gape, ops_out, ops_cap, n_ops,
                       cost_out, start_out, &errs[0]);
  } else {
    std::vector<std::thread> ts;
    const int32_t step = (n + nthreads - 1) / nthreads;
    for (int i = 0; i < nthreads; ++i) {
      const int32_t lo = i * step;
      const int32_t hi = lo + step < n ? lo + step : n;
      if (lo >= hi) break;
      ts.emplace_back(glocal_batch_range, reads, r_off, r_len, text, w_off,
                      w_len, lo, hi, s_mm, s_gapo, s_gape, ops_out, ops_cap,
                      n_ops, cost_out, start_out, &errs[i]);
    }
    for (auto& t : ts) t.join();
  }
  for (int i = 0; i < nthreads && i < 8; ++i)
    if (errs[i] != 0) return errs[i];
  return 0;
}
