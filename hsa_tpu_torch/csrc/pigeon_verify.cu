// The pigeonhole engine's verify stages: the ungapped window verify and the
// one-run gapped screen of the pool's candidates.
//
// Replaces device work that hsa_tpu leaves to XLA inside the jitted
// pigeon_search (hsa_tpu/search/pigeon.py:669-876: the window fetch,
// diag_words, the ungapped XOR/popcount verify, the scatter-min n2, and the
// gapped screen's diag_prefix, upd_class and top-GC_SLOTS select), which
// the port's plain torch ran as about 1,200 launches a batch
// (kernels/verify.py: window_verify_plain, gapped_screen_plain).
//
// Layout (the plain versions' inputs): text rows int32 [nt, 8], 128 2-bit
// bases a row behind an all-zero lead row; combo int64 [B, 4 RW + 1]: a
// read's packed words rw, valid mask vm, N mask nm and seed mask sm (RW
// words each, DW = RW - 1 of them carry bases) and lens | md << 16; the
// pool's int64 vectors (values in [0, 2^32), read as their low 32-bit
// words) and bool masks.  A window word t packs the text bases from
// pstart - G + 16 t; diagonal d starts d bases further.
//
// window_verify.  What bounds it: bytes: the candidate's read row (up to
// 4 x 10 words of 8 bytes) and its window's text words, the outputs; about
// 15 integer operations a window word.  Design: one thread a candidate;
// the window words are formed as they stream (two text words in
// registers), XORed against the read's words of the central diagonal G and
// popcounted, so nothing of the window reaches memory; the per-read best
// count n2 is one atomicMin a candidate (min is exact in any order).
//
// gapped_screen.  What bounds it: operations: a candidate scores 4
// placements at each of its 16 DW read positions for each g = 1..G, some
// 60 integer operations a position and g; the bytes are one read row and
// one window a candidate.  Design: one thread a pool-2 candidate; its
// window is rebuilt from the text rows (no window matrix in device memory,
// unlike the plain version's gather of WW); for each g the mismatch and
// seed words of the three diagonals G, G + g and G - g are formed in local
// arrays, and one pass over the positions keeps the exclusive prefix
// counts as running sums (a look-ahead stream of g positions gives the
// insertions' shifted prefixes), so no prefix array exists; each class's
// minimum key, the GC_SLOTS best classes (the lowest class among equal
// keys) and the overflow flag follow in registers.  Every lane is
// computed, dead ones included, exactly as the plain version computes it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kPat = 0x55555555u;
constexpr int kThreads = 128;
constexpr int kMaxDW = 10;
constexpr int kMaxG = 7;
constexpr int kSlots = 4;                     // GC_SLOTS
constexpr int kBigNmm = 0x3FFF;
constexpr long long kBigKey = 0xFFFFFFFFLL;

struct Pool {
  const int32_t* text;        // [nt, 8]
  long long nt;
  const unsigned* combo;      // low words: a row is 2 (4 RW + 1) words
  long long B;
  int RW, DW;
  const unsigned* pstart;     // low words of int64
  const unsigned* pread;
  const bool* fetch_ok;
};

// one read row's words: rw[w] is combo word w of the row (int64 low word)
struct Row {
  const unsigned* p;
  __device__ unsigned at(int w) const { return p[2 * w]; }
};

__device__ __forceinline__ Row read_row(const Pool& s, long long pr) {
  pr = min(max(pr, 0LL), s.B - 1);
  return Row{s.combo + 2 * pr * (4 * s.RW + 1)};
}

// word j of the fetched run of text rows r0, r0 + 1, ... (each row clamped
// to the table, as the plain gather clamps it)
__device__ __forceinline__ unsigned text_word(const Pool& s, long long r0,
                                              int j) {
  const long long r = min(r0 + (j >> 3), s.nt - 1);
  return (unsigned)__ldg(s.text + r * 8 + (j & 7));
}

// the window's start, in lead-padded base coordinates (0 when not fetched)
struct Window {
  long long r0;
  int ws, sh;
};

__device__ __forceinline__ Window window_at(unsigned pstart, bool ok, int G) {
  const unsigned long long startf =
      ok ? (((unsigned long long)pstart + 128 - G) & 0xFFFFFFFFull) : 0ull;
  Window w;
  w.r0 = (long long)(startf >> 7);
  w.ws = (int)((startf >> 4) & 7);
  w.sh = (int)(2 * (startf & 15));
  return w;
}

__device__ __forceinline__ unsigned funnel(unsigned lo, unsigned hi, int sh) {
  return sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
}

// mismatch pairs of a diagonal's word against the read's word w
__device__ __forceinline__ unsigned mismatch(unsigned diag, const Row& row,
                                             int RW, int w) {
  const unsigned x = diag ^ row.at(w);
  return (((x | (x >> 1)) & kPat) | row.at(2 * RW + w)) & row.at(RW + w);
}

__global__ void __launch_bounds__(kThreads)
window_verify_kernel(Pool s, const bool* pvalid, long long P, int G,
                     int max_seed_diff, bool* valid_o, long long* pos_o,
                     uint8_t* nmm_o, long long* n2) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  const unsigned ps = s.pstart[2 * i];
  const long long pr = (long long)s.pread[2 * i];
  const Row row = read_row(s, pr);
  const unsigned pmd = row.at(4 * s.RW) >> 16;
  const Window win = window_at(ps, s.fetch_ok[i], G);
  // window words t and t + 1 as they stream; diagonal G's word t needs both
  unsigned tw0 = text_word(s, win.r0, win.ws);
  unsigned tw1 = text_word(s, win.r0, win.ws + 1);
  unsigned ww = funnel(tw0, tw1, win.sh);
  int nmm = 0, seed = 0;
  for (int t = 0; t < s.DW; ++t) {
    const unsigned tw2 = text_word(s, win.r0, win.ws + t + 2);
    const unsigned ww1 = funnel(tw1, tw2, win.sh);
    const unsigned diag = G ? (ww >> (2 * G)) | (ww1 << (32 - 2 * G)) : ww;
    const unsigned mm = mismatch(diag, row, s.RW, t);
    nmm += __popc(mm);
    seed += __popc(mm & row.at(3 * s.RW + t));
    tw1 = tw2;
    ww = ww1;
  }
  const bool ok = pvalid[i] && (unsigned)nmm <= pmd && seed <= max_seed_diff;
  valid_o[i] = ok;
  pos_o[i] = ok ? (long long)ps : 0;
  nmm_o[i] = (uint8_t)nmm;
  atomicMin(n2 + min(max(pr, 0LL), s.B - 1),
            (long long)(ok ? nmm : kBigNmm));
}

struct Scores {
  int s_mm, s_gapo, s_gape, seed_len, skip, max_seed_diff;
};

// the class key of a placement's best count (upd_class)
__device__ __forceinline__ long long class_key(int best, int g,
                                               const Scores& sc) {
  if (!(best < kBigNmm)) return kBigKey;
  const long long nb = best;
  return ((nb * sc.s_mm + (sc.s_gapo + sc.s_gape * (g - 1))) * 256)
         | (long long)(g << 4) | nb;
}

__device__ __forceinline__ unsigned low_pairs(int g) {  // pairs below g
  return g >= 16 ? 0xFFFFFFFFu : ((1u << (2 * g)) - 1u);
}

__global__ void __launch_bounds__(kThreads)
gapped_screen_kernel(Pool s, long long P, const unsigned* gidx, long long GP,
                     const long long* n_gate, int G, long long n, Scores sc,
                     long long* g_key, long long* g_q, long long* g_read,
                     bool* g_drop) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= GP) return;
  const bool in_g = j < *n_gate;
  const long long g2 = min((long long)gidx[2 * j], P - 1);
  const unsigned ps = s.pstart[2 * g2];
  const long long pr = (long long)s.pread[2 * g2];
  const Row row = read_row(s, pr);
  const unsigned lm = row.at(4 * s.RW);
  const int lens = (int)(lm & 0xFFFF);
  const int md = (int)(lm >> 16);
  const int RW = s.RW, DW = s.DW, LT = 16 * DW;
  const Window win = window_at(ps, s.fetch_ok[g2], G);

  unsigned WW[kMaxDW + 1];
  {
    unsigned lo = text_word(s, win.r0, win.ws);
    for (int t = 0; t <= DW; ++t) {
      const unsigned hi = text_word(s, win.r0, win.ws + t + 1);
      WW[t] = funnel(lo, hi, win.sh);
      lo = hi;
    }
  }
  // mismatch and seed words of diagonal d
  auto diag_mm = [&](int d, unsigned* mm, unsigned* sd, int& tm, int& ts) {
    tm = ts = 0;
    for (int w = 0; w < DW; ++w) {
      const unsigned dw =
          d ? (WW[w] >> (2 * d)) | (WW[w + 1] << (32 - 2 * d)) : WW[w];
      mm[w] = mismatch(dw, row, RW, w);
      sd[w] = mm[w] & row.at(3 * RW + w);
      tm += __popc(mm[w]);
      ts += __popc(sd[w]);
    }
  };
  unsigned mG[kMaxDW], sG[kMaxDW], mP[kMaxDW], sP[kMaxDW], mM[kMaxDW],
      sM[kMaxDW];
  int TG, TSG;
  diag_mm(G, mG, sG, TG, TSG);

  long long key[2 * kMaxG + 1];
  for (int c = 0; c <= 2 * G; ++c) key[c] = kBigKey;
  const int seed_start = lens - sc.seed_len;
  const int msd = sc.max_seed_diff;

  for (int g = 1; g <= G; ++g) {
    int TP, TSP, TM, TSM;
    diag_mm(G + g, mP, sP, TP, TSP);
    diag_mm(G - g, mM, sM, TM, TSM);
    const bool feas = g <= md;
    const unsigned lowg = low_pairs(g);
    // exclusive prefixes at t of diagonals G, G + g, G - g, and at t + g of
    // G and G - g (the insertions' shifted prefixes)
    int cG = 0, cS = 0, cP = 0, cPs = 0, cM = 0, cMs = 0;
    int hG = __popc(mG[0] & lowg), hGs = __popc(sG[0] & lowg);
    int hM = __popc(mM[0] & lowg), hMs = __popc(sM[0] & lowg);
    int b1 = kBigNmm, b2 = kBigNmm, b3 = kBigNmm, b4 = kBigNmm;
    for (int w = 0; w < DW; ++w) {
      unsigned aG = mG[w], aS = sG[w], aP = mP[w], aPs = sP[w], aM = mM[w],
               aMs = sM[w];
      // the look-ahead streams: word w of a diagonal g positions on
      const bool nxt = w + 1 < DW;
      unsigned lG = (mG[w] >> (2 * g)) | (nxt ? mG[w + 1] << (32 - 2 * g) : 0u);
      unsigned lGs = (sG[w] >> (2 * g)) | (nxt ? sG[w + 1] << (32 - 2 * g) : 0u);
      unsigned lM = (mM[w] >> (2 * g)) | (nxt ? mM[w + 1] << (32 - 2 * g) : 0u);
      unsigned lMs = (sM[w] >> (2 * g)) | (nxt ? sM[w + 1] << (32 - 2 * g) : 0u);
#pragma unroll 4
      for (int q = 0; q < 16; ++q) {
        const int t = 16 * w + q;
        if (feas) {
          const bool ahead = t + g < LT;
          const int shG = ahead ? hG : kBigNmm, shGs = ahead ? hGs : kBigNmm;
          const int shM = ahead ? hM : kBigNmm, shMs = ahead ? hMs : kBigNmm;
          const bool tm = t >= sc.skip && t <= lens - sc.skip;
          const bool tm_i = t >= sc.skip - 1 && t <= lens - sc.skip - g;
          const int gseed = t > seed_start ? g : 0;
          const int iseed = min(max(t + g - seed_start, 0), g);
          // deletion after the anchor
          int v = cG + (TP - cP);
          if (tm && v + g <= md && cS + (TSP - cPs) + gseed <= msd)
            b1 = min(b1, v);
          // deletion before the anchor
          v = cM + (TG - cG);
          if (tm && v + g <= md && cMs + (TSG - cS) + gseed <= msd)
            b2 = min(b2, v);
          // insertion after the anchor
          v = cG + (TM - shM);
          if (tm_i && v + g <= md && cS + (TSM - shMs) + iseed <= msd)
            b3 = min(b3, v);
          // insertion before the anchor
          v = cP + (TG - shG);
          if (tm_i && v + g <= md && cPs + (TSG - shGs) + iseed <= msd)
            b4 = min(b4, v);
        }
        cG += aG & 1; cS += aS & 1; cP += aP & 1; cPs += aPs & 1;
        cM += aM & 1; cMs += aMs & 1;
        hG += lG & 1; hGs += lGs & 1; hM += lM & 1; hMs += lMs & 1;
        aG >>= 2; aS >>= 2; aP >>= 2; aPs >>= 2; aM >>= 2; aMs >>= 2;
        lG >>= 2; lGs >>= 2; lM >>= 2; lMs >>= 2;
      }
    }
    // the in-text tests of each placement's start (q_ok, wrapping at 2^32)
    const unsigned lens_u = (unsigned)lens;
    const bool q_ok0 = (long long)ps < n &&
                       (long long)(unsigned)(ps + lens_u + g) <= n;
    const unsigned q2 = ps - (unsigned)g;
    const bool q_ok2 = (long long)q2 < n &&
                       (long long)(unsigned)(q2 + lens_u + g) <= n;
    const unsigned plen_g = lens_u - (unsigned)g;
    const bool q_ok3 = (long long)ps < n &&
                       (long long)(unsigned)(ps + plen_g) <= n;
    const unsigned q3 = ps + (unsigned)g;
    const bool q_ok4 = (long long)q3 < n &&
                       (long long)(unsigned)(q3 + plen_g) <= n;
    key[G] = min(key[G], class_key(q_ok0 ? b1 : kBigNmm, g, sc));
    key[G - g] = min(key[G - g], class_key(q_ok2 ? b2 : kBigNmm, g, sc));
    key[G] = min(key[G], class_key(q_ok3 ? b3 : kBigNmm, g, sc));
    key[G + g] = min(key[G + g], class_key(q_ok4 ? b4 : kBigNmm, g, sc));
  }

  // the GC_SLOTS best classes: the least key << 4 | class, its class taken
  // out after each pick
  const int ncl = 2 * G + 1;
  long long ok_[kSlots], oq[kSlots];
  const int picks = min(kSlots, ncl);
  for (int p = 0; p < kSlots; ++p) {
    ok_[p] = kBigKey;
    oq[p] = 0;
  }
  for (int p = 0; p < picks; ++p) {
    long long bv = 0;
    for (int c = 0; c < ncl; ++c) {
      const long long v = key[c] * 16 | c;
      if (c == 0 || v < bv) bv = v;
    }
    const int c = (int)(bv & 15);
    ok_[p] = key[c];
    oq[p] = (long long)(unsigned)(ps + (unsigned)(c - G));
    key[c] = kBigKey;
  }
  bool drop = false;
  if (ncl > kSlots) {
    long long rem = key[0];
    for (int c = 1; c < ncl; ++c) rem = min(rem, key[c]);
    drop = in_g && rem != kBigKey && (rem >> 8) <= (ok_[0] >> 8) + sc.s_mm;
  }
  for (int p = 0; p < kSlots; ++p) {
    g_key[j * kSlots + p] = in_g ? ok_[p] : kBigKey;
    g_q[j * kSlots + p] = oq[p];
  }
  g_read[j] = in_g ? pr : s.B;
  g_drop[j] = drop;
}

Pool make_pool(const void* text, long long nt, const void* combo, long long B,
               long long RW, const void* pstart, const void* pread,
               const void* fetch_ok) {
  Pool s;
  s.text = static_cast<const int32_t*>(text);
  s.nt = nt;
  s.combo = static_cast<const unsigned*>(combo);
  s.B = B;
  s.RW = (int)RW;
  s.DW = (int)RW - 1;
  s.pstart = static_cast<const unsigned*>(pstart);
  s.pread = static_cast<const unsigned*>(pread);
  s.fetch_ok = static_cast<const bool*>(fetch_ok);
  return s;
}

bool bad_shape(long long nt, long long B, long long RW, int G) {
  return nt <= 0 || B <= 0 || RW < 2 || RW - 1 > kMaxDW || G < 0 || G > kMaxG;
}

}  // namespace

// text: int32 [nt, 8]; combo: int64 [B, 4 RW + 1]; pstart, pread: int64
// [P]; fetch_ok, pvalid: bool [P]; out: valid bool [P], pos int64 [P], nmm
// uint8 [P], n2 int64 [B] (set to 0x3FFF by the caller).  Returns the CUDA
// error of the launch (0 when it was taken).
extern "C" int hsa_window_verify(const void* text, long long nt,
                                 const void* combo, long long B, long long RW,
                                 const void* pstart, const void* pread,
                                 const void* fetch_ok, const void* pvalid,
                                 long long P, int G, int max_seed_diff,
                                 void* valid_o, void* pos_o, void* nmm_o,
                                 void* n2, cudaStream_t stream) {
  if (P <= 0 || bad_shape(nt, B, RW, G)) return (int)cudaErrorInvalidValue;
  const long long grid = (P + kThreads - 1) / kThreads;
  window_verify_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      make_pool(text, nt, combo, B, RW, pstart, pread, fetch_ok),
      static_cast<const bool*>(pvalid), P, G, max_seed_diff,
      static_cast<bool*>(valid_o), static_cast<long long*>(pos_o),
      static_cast<uint8_t*>(nmm_o), static_cast<long long*>(n2));
  return (int)cudaGetLastError();
}

// gidx: int64 [GP] pool indices (filled with P past n_gate); n_gate: int64
// [1] on the card; out: g_key, g_q int64 [GP, 4], g_read int64 [GP], g_drop
// bool [GP].  Returns the CUDA error of the launch (0 when it was taken).
extern "C" int hsa_gapped_screen(const void* text, long long nt,
                                 const void* combo, long long B, long long RW,
                                 const void* pstart, const void* pread,
                                 const void* fetch_ok, long long P,
                                 const void* gidx, long long GP,
                                 const void* n_gate, int G, long long n,
                                 int s_mm, int s_gapo, int s_gape,
                                 int seed_len, int skip, int max_seed_diff,
                                 void* g_key, void* g_q, void* g_read,
                                 void* g_drop, cudaStream_t stream) {
  if (GP <= 0 || P <= 0 || G < 1 || bad_shape(nt, B, RW, G))
    return (int)cudaErrorInvalidValue;
  const Scores sc{s_mm, s_gapo, s_gape, seed_len, skip, max_seed_diff};
  const long long grid = (GP + kThreads - 1) / kThreads;
  gapped_screen_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      make_pool(text, nt, combo, B, RW, pstart, pread, fetch_ok), P,
      static_cast<const unsigned*>(gidx), GP,
      static_cast<const long long*>(n_gate), G, n, sc,
      static_cast<long long*>(g_key), static_cast<long long*>(g_q),
      static_cast<long long*>(g_read), static_cast<bool*>(g_drop));
  return (int)cudaGetLastError();
}
