// Per-column top-K selection with carried payloads: the beam engine's
// frontier select and hit-buffer merge, two launches per beam step.
//
// Replaces the Pallas kernel hsa_tpu/kernels/select.py:_build_select (its
// body `kern`) behind select_topk.  Semantics oracle: select_topk_reference
// in the same file, and select_topk_plain in hsa_tpu_torch/kernels/select.py.
//
// Layout: row-major [C, B] int32 matrices, candidate slots on rows and one
// column per read strand.  A valid key is `score << 14 | row`, unique within
// its column; SENT (0x7FFF0000) and above marks an invalid slot.  With a
// window, a key whose score is above window[b] is invalid too.
//
// Outputs per column b:
//   okey[s, b], s < K : the s-th smallest valid key, SENT once they run out
//   okey[K, b]        : accum[b] + max(nvalid - K, 0)   (32-bit wrap)
//   out_p[s, b]       : payload p of the row picked for slot s, 0 when the
//                       slot is invalid
// Payloads are raw 32-bit patterns, moved unchanged.
//
// What bounds it: bytes.  The function must read the C*B keys once, write
// (4K+1)*B words and fetch up to 3K payload words per column.  A fetched
// word is 4 compulsory bytes, but it costs a 32-byte sector because
// neighbouring columns pick different rows; at the beam's frontier shape
// ([576, 32768], K = 64) that is about 310 MB with sectors and under half of
// it without, either way under 0.1 ms of the card's memory rate, and the
// selection below is some tens of integer operations per valid key on top.
//
// Design: the keys are read ONCE.
//   1. A block of 512 threads owns a tile of TX = 16 neighbouring columns
//      (8 when C is too tall for 16 to fit in shared memory; the tall
//      variant below when even 8 do not fit).  Thread
//      (x, y) reads rows y, y + R, ... of column x (R = 512 / TX), so a
//      warp's load is whole 32-byte sectors of two rows, four loads in
//      flight per thread.  The window test is applied on the way in, and
//      each valid key is appended with its row to the column's list in
//      shared memory (a shared-memory atomic counter per column; the order
//      does not matter because keys are unique).  At the frontier shape a
//      tile takes 82 KB, so two blocks share an SM and one block's loads
//      overlap the other's ranking.
//   2. One warp per column.  Where the column has more than K valid keys,
//      the warp finds the K-th smallest by bisection on the key's value
//      (each round counts the keys at or below the midpoint, n / 32 per
//      lane and one warp reduction; at most 31 rounds, about 20 for the
//      beam's scores) and moves the K keys at or below it to the front of
//      the list with a ballot.  Then the min(n, K) keys left are ranked by
//      counting: the rank of a key is the number of smaller keys, exact
//      because keys are unique.  A key of rank s goes to slot s of an
//      output tile staged in shared memory, with its row.  Slots n..K-1
//      get SENT and no row; the drop row gets accum + max(n - K, 0).
//   3. The [K+1, TX] key tile is written out by rows (coalesced), and the
//      winners' payloads are fetched from global memory by the staged rows,
//      min(n, K) loads per payload and column, and written out by rows too.
// Column lists are [TX][cap] with cap = 1 (mod 32) and the staged tiles have
// a row stride of TX + 1, so neither the appends, the ranking reads nor the
// staged writes pile up on one shared-memory bank.
//
// Tall columns (the beam's frontier above W = 355, C = 9W, K = W; its merge
// above W of about 700): a tile of 8 columns of C keys no longer fits in a
// block's shared memory, so the tall kernel keeps no list of C keys.  It
// finds each column's K-th key by a radix select over coalesced reads of the
// keys, and orders what it keeps by a counting sort:
//   1. A block of 512 threads owns a tile of `cols` neighbouring columns (8,
//      or 4, 2, 1 where 8 do not fit or would leave half of the SMs without
//      a block).  Threads read a row's columns together, 16 bytes a thread
//      where the width and alignment allow, eight loads in flight.
//   2. Histogram pass: the block counts each column's valid keys by the
//      score's low 10 bits (1,024 bins a column) and takes the column's
//      least and greatest score.  Where a column's scores span fewer than
//      1,024 values (the beam's do: its frontier is windowed) the bins read
//      from the least score up are the exact score histogram, and a prefix
//      sum finds the score of the K-th key: `below` keys of lower scores
//      (< K) and `cnt` of that score.  Otherwise the select starts from the
//      whole 31-bit range with below = 0, cnt = n.
//   3. While below + cnt exceeds the column's list (`ls` entries), a pass
//      histograms the next 10 bits of the keys inside the boundary bin and
//      moves into the bin that holds the K-th key (at most two more passes
//      for the 14 low bits, four from the top).
//   4. Emit pass: the block appends each column's keys at or below the
//      boundary bin's top (all valid keys where n <= K) with their rows to
//      the column's list, one shared-memory atomic a warp and column.
//   5. One warp a column sorts the at most ls kept keys, with their rows, by
//      a stable LSD counting sort of the key minus the least key, at most 5
//      bits a digit (the beam's keys: four passes).  Lane l counts and
//      places its share of the list with counters of its own (32 x 33 a
//      warp, padded), so a digit's keys go in lane order and no atomic or
//      vote is needed.
//      Keys are unique, so the order is the whole key's, whatever the order
//      the keys were kept in.
//   6. Slot s < min(n, K) gets the s-th kept key, the rest SENT and payload
//      0; the block writes its columns by rows (consecutive threads,
//      consecutive columns) and fetches each payload by the kept key's row.
// Each read of the keys is whole sectors.  What is left beyond the bound
// (measured by hsa_select_topk_trace, which times each phase of each
// block): the payloads' 32-byte sectors (a sector fetched for one 4-byte
// pick), the second read of the keys (from L2 only in part), the sort, and
// the phases of a block running one after another (one block an SM: two,
// of 256 threads or of 64 registers, made every phase slower).
// Splitting a tile's rows over a thread-block cluster, with histograms
// summed through distributed shared memory, was measured and cut: narrower
// tiles fill the card at less cost at every measured shape.
//
// The variant and its plan are chosen by the wrapper (hsa_tpu_torch/kernels/
// select.py:_plan: a tile of 16 or 8 columns where its lists of C keys fit,
// by the same byte count as smem_bytes below, else the tall kernel's cols
// and ls, by tall_smem_bytes) and checked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSent = 0x7FFF0000;
constexpr int kKeyShift = 14;
constexpr int kMaxPay = 3;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLoads = 4;                 // key loads in flight per thread
constexpr size_t kMaxSmem = 232448;       // 227 KB: the most a block may ask
// the tall kernel: bins of a select digit (kDigit bits) and a histogram
// row (padded: the sort's 32 x 33 counters), the widest tile, the sort's
// digit, the key loads in flight a thread, and the phase marks of
// hsa_select_topk_trace (start, histogram pass, select, emit, sort,
// write-out)
constexpr int kDigit = 10;
constexpr int kBins = 1 << kDigit;
constexpr int kHist = kBins + kBins / 32;
constexpr int kMaxCols = 8;
constexpr int kSortBits = 5;
constexpr int kTallLoads = 8;
constexpr int kMarks = 6;
// per-column words of the tall kernel: the valid count and score range,
// the boundary bin [Lo, Lo + 2^Lg) with the keys below it and in it,
// whether it fits the list, the kept keys, and which list holds them sorted
enum { kN, kSMin, kSMax, kLo, kLg, kBelow, kCnt, kDone, kTot, kRes,
       kFields };

// Where the tall kernel writes its phase marks ([blocks][kMarks] ns of the
// card's global timer); null, the default, writes none.  For measurement
// only (chip_smoke.py --select-only): no caller of the wrapper sets it.
__device__ long long* g_trace = nullptr;

struct Payloads {
  const int32_t* in[kMaxPay];
  int32_t* out[kMaxPay];
};

__device__ __forceinline__ bool is_valid(int32_t k, bool has_win, int32_t win) {
  return k < kSent && !(has_win && (k >> kKeyShift) > win);
}

// Entries per column list: at least C, and 1 modulo 32.
__host__ __device__ inline int list_cap(int C) { return ((C + 31) / 32) * 32 + 1; }

// Shared memory of one block of the tiled kernel, in bytes: a tile of TX =
// 16 or 8 columns.
inline size_t smem_bytes(int TX, int C, int K) {
  return sizeof(int32_t) * ((size_t)2 * TX * list_cap(C)
                            + (size_t)(2 * K + 1) * (TX + 1) + TX);
}

// Entries a tall column list takes: at least ls, and 1 modulo 32.
__host__ __device__ inline int tall_stride(int ls) {
  return ((ls + 31) / 32) * 32 + 1;
}

// Shared memory of one block of the tall kernel, in bytes: a histogram and
// two lists of keys and rows a column, and the per-column words.
inline size_t tall_smem_bytes(int cols, int ls) {
  return sizeof(int32_t) * ((size_t)cols * kHist
                            + (size_t)4 * cols * tall_stride(ls)
                            + (size_t)kFields * kMaxCols);
}

template <int TX>
__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const int32_t* __restrict__ key, Payloads pay, int n_pay,
                   const int32_t* __restrict__ window,
                   const int32_t* __restrict__ accum,
                   int32_t* __restrict__ okey, int C, int B, int K) {
  extern __shared__ int32_t smem[];
  constexpr int R = kThreads / TX;        // row slices
  constexpr int TS = TX + 1;              // row stride of the staged tiles
  const int cap = list_cap(C);
  int32_t* skey = smem;                   // [TX][cap] valid keys per column
  int32_t* srow = skey + TX * cap;        // [TX][cap] and their rows
  int32_t* tkey = srow + TX * cap;        // [K + 1][TS] staged output keys
  int32_t* trow = tkey + (K + 1) * TS;    // [K][TS] staged winner rows
  int* cnt = trow + K * TS;               // [TX] valid keys per column

  const int x = threadIdx.x % TX, y = threadIdx.x / TX;
  const int col0 = blockIdx.x * TX;
  const int col = col0 + x;
  const bool live = col < B;
  const size_t ld = (size_t)B;

  if (threadIdx.x < TX) cnt[threadIdx.x] = 0;
  __syncthreads();

  // 1. read the tile's keys once; append the valid ones to their column
  if (live) {
    const bool has_win = window != nullptr;
    const int32_t win = has_win ? window[col] : 0;
    const int32_t* src = key + col;
    int32_t* ck = skey + x * cap;
    int32_t* cr = srow + x * cap;
    for (int c = y; c < C; c += kLoads * R) {
      int32_t k[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int cc = c + u * R;
        k[u] = cc < C ? src[cc * ld] : kSent;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (is_valid(k[u], has_win, win)) {
          const int pos = atomicAdd(&cnt[x], 1);
          ck[pos] = k[u];
          cr[pos] = c + u * R;
        }
      }
    }
  }
  __syncthreads();

  // 2. one warp per column: keep the K smallest, rank them, stage them
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int xc = warp; xc < TX && col0 + xc < B; xc += kWarps) {
    const int n = cnt[xc];
    const int m = min(n, K);
    int32_t* ck = skey + xc * cap;
    int32_t* cr = srow + xc * cap;
    if (n > K) {
      // the K-th smallest key, by bisection on the value between the
      // column's least and greatest key: count(key <= hi) >= K > count(key < lo)
      int32_t lo = 0x7FFFFFFF, hi = 0;
      for (int i = lane; i < n; i += 32) {
        lo = min(lo, ck[i]);
        hi = max(hi, ck[i]);
      }
      lo = __reduce_min_sync(kFull, lo);
      hi = __reduce_max_sync(kFull, hi);
      while (lo < hi) {
        const int32_t mid = lo + (hi - lo) / 2;
        int c = 0;
        for (int i = lane; i < n; i += 32) c += ck[i] <= mid;
        c = __reduce_add_sync(kFull, c);
        if (c >= K) hi = mid; else lo = mid + 1;
      }
      // move the K keys <= lo to the front of the list, in place: a pass
      // reads 32 entries, then writes at or before the first of them
      int kept = 0;
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        const int32_t k = i < n ? ck[i] : 0x7FFFFFFF;
        const int32_t r = i < n ? cr[i] : 0;
        const bool keep = k <= lo;
        const unsigned mask = __ballot_sync(kFull, keep);
        __syncwarp();               // every lane has read before any writes
        if (keep) {
          const int p = kept + __popc(mask & ((1u << lane) - 1u));
          ck[p] = k;
          cr[p] = r;
        }
        kept += __popc(mask);
        __syncwarp();
      }
    }
    // the rank of a key is the number of smaller keys among the m kept
    for (int i = lane; i < m; i += 32) {
      const int32_t own = ck[i];
      int rank = 0;
#pragma unroll 4
      for (int j = 0; j < m; ++j) rank += ck[j] < own;
      tkey[rank * TS + xc] = own;
      trow[rank * TS + xc] = cr[i];
    }
    for (int s = n + lane; s < K; s += 32) {
      tkey[s * TS + xc] = kSent;
      trow[s * TS + xc] = -1;
    }
    if (lane == 0) {
      const uint32_t acc = accum != nullptr ? (uint32_t)accum[col0 + xc] : 0u;
      tkey[K * TS + xc] = (int32_t)(acc + (uint32_t)max(n - K, 0));
    }
  }
  __syncthreads();

  // 3. write the staged tile by rows; fetch the winners' payloads
  if (live) {
    for (int s = y; s <= K; s += R) okey[s * ld + col] = tkey[s * TS + x];
    for (int s = y; s < K; s += R) {
      const int r = trow[s * TS + x];
      int32_t v[kMaxPay];
#pragma unroll
      for (int p = 0; p < kMaxPay; ++p)
        v[p] = (p < n_pay && r >= 0) ? pay.in[p][r * ld + col] : 0;
#pragma unroll
      for (int p = 0; p < kMaxPay; ++p)
        if (p < n_pay) pay.out[p][s * ld + col] = v[p];
    }
  }
}

// The tall kernel (see the note above).  `cols` columns a block, `ls`
// entries a list.
template <int VEC>
__global__ void __launch_bounds__(kThreads, 1)
select_topk_tall_kernel(const int32_t* __restrict__ key, Payloads pay,
                        int n_pay, const int32_t* __restrict__ window,
                        const int32_t* __restrict__ accum,
                        int32_t* __restrict__ okey, int C, int B, int K,
                        int cols, int ls) {
  extern __shared__ int32_t smem[];
  const int LSP = tall_stride(ls);
  int32_t* hist = smem;                   // [cols][kHist] digit counts
  int32_t* akey = hist + cols * kHist;    // [cols][LSP] list A: kept keys
  int32_t* arow = akey + cols * LSP;      //   and their rows
  int32_t* bkey = arow + cols * LSP;      // [cols][LSP] list B: the sort's
  int32_t* brow = bkey + cols * LSP;      //   other half
  int* st = brow + cols * LSP;            // [kFields][kMaxCols] per column
  auto S = [st](int f, int x) -> int& { return st[f * kMaxCols + x]; };
  // with tracing on, each block's time at the end of each phase
  long long* const trace = g_trace;
  auto mark = [&](int i) {
    if (trace == nullptr) return;
    __syncthreads();
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (threadIdx.x == 0) trace[(size_t)blockIdx.x * kMarks + i] = t;
  };
  mark(0);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below_lanes = (1u << lane) - 1u;
  const int col0 = (int)blockIdx.x * cols;
  const size_t ld = (size_t)B;

  // the sweeps' layout: thread (g, y) reads VEC columns g*VEC.. of rows
  // y, y + R, ...; lanes of one g are the lanes equal to it modulo GX
  const int GX = cols / VEC, R = kThreads / GX;
  const int g = tid % GX, y = tid / GX, xb = g * VEC;
  const bool live = col0 + xb < B;        // VEC = 4 only where B % 4 == 0
  unsigned gmask = 0;
  for (int l = lane % GX; l < 32; l += GX) gmask |= 1u << l;
  const bool has_win = window != nullptr;
  int32_t win[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    win[v] = (has_win && live) ? window[col0 + xb + v] : 0;

  // the keys of rows c0 + u * R + y, u < kTallLoads, into k (SENT past the
  // rows and the columns)
  auto load_keys = [&](int c0, int32_t (&k)[kTallLoads][VEC]) {
#pragma unroll
    for (int u = 0; u < kTallLoads; ++u) {
      const int c = c0 + u * R + y;
      const bool in = live && c < C;
      if constexpr (VEC == 4) {
        int4 q = make_int4(kSent, kSent, kSent, kSent);
        if (in) q = *reinterpret_cast<const int4*>(key + c * ld + col0 + xb);
        k[u][0] = q.x; k[u][1] = q.y; k[u][2] = q.z; k[u][3] = q.w;
      } else {
        k[u][0] = in ? key[c * ld + col0 + xb] : kSent;
      }
    }
  };
  // op(v, x, key, row, valid) for every key slot of the thread's rows, by
  // every thread the same number of times (op may use warp votes)
  auto sweep = [&](auto&& op) {
    for (int c0 = 0; c0 < C; c0 += R * kTallLoads) {
      int32_t k[kTallLoads][VEC];
      load_keys(c0, k);
#pragma unroll
      for (int u = 0; u < kTallLoads; ++u)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          op(v, xb + v, k[u][v], c0 + u * R + y,
             is_valid(k[u][v], has_win, win[v]));
    }
  };

  // the first bin, in the order base, base + 1, ... (mod kBins) over nb
  // bins of column x, at which the running count reaches `need`: sets the
  // bin's place, the count before it and its own count (one warp)
  auto find = [&](int x, int nb, int base, int need, int& at, int& before,
                  int& own) {
    int carry = 0;
    for (int p0 = 0; p0 < nb; p0 += 32) {
      const int p = p0 + lane;
      const int v = p < nb ? hist[x * kHist + ((base + p) & (kBins - 1))] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned hit = __ballot_sync(kFull, carry + incl >= need);
      if (hit) {
        const int j = __ffs(hit) - 1;
        at = p0 + j;
        before = carry + __shfl_sync(kFull, incl - v, j);
        own = __shfl_sync(kFull, v, j);
        return;
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
    at = before = own = 0;                // not reached: the bins hold `need`
  };

  auto clear_hist = [&]() {
    for (int i = tid; i < cols * kHist; i += kThreads) hist[i] = 0;
  };

  // 1-2. the histogram of the score's low 10 bits, and the score range
  clear_hist();
  if (tid < cols) {
    S(kN, tid) = 0;
    S(kSMin, tid) = 0x7FFFFFFF;
    S(kSMax, tid) = -1;
    S(kTot, tid) = 0;
  }
  __syncthreads();
  {
    int n[VEC], mn[VEC], mx[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) n[v] = 0, mn[v] = 0x7FFFFFFF, mx[v] = -1;
    sweep([&](int v, int x, int32_t k, int, bool ok) {
      if (ok) {
        const int s = k >> kKeyShift;
        atomicAdd(&hist[x * kHist + (s & (kBins - 1))], 1);
        ++n[v];
        mn[v] = min(mn[v], s);
        mx[v] = max(mx[v], s);
      }
    });
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      for (int o = 16; o >= GX; o >>= 1) {
        n[v] += __shfl_xor_sync(kFull, n[v], o);
        mn[v] = min(mn[v], __shfl_xor_sync(kFull, mn[v], o));
        mx[v] = max(mx[v], __shfl_xor_sync(kFull, mx[v], o));
      }
      if (lane < GX && live && n[v]) {
        atomicAdd(&S(kN, xb + v), n[v]);
        atomicMin(&S(kSMin, xb + v), mn[v]);
        atomicMax(&S(kSMax, xb + v), mx[v]);
      }
    }
  }
  mark(1);
  __syncthreads();
  for (int x = warp; x < cols; x += kWarps) {
    const int n = S(kN, x), smin = S(kSMin, x), smax = S(kSMax, x);
    int lo = 0, lg = 31, below = 0, cnt = n;
    if (n > K && smax - smin < kBins) {
      int at, before, own;
      find(x, kBins, smin, K, at, before, own);
      lo = (smin + at) << kKeyShift;
      lg = kKeyShift;
      below = before;
      cnt = own;
    }
    if (lane == 0) {
      S(kLo, x) = lo;
      S(kLg, x) = lg;
      S(kBelow, x) = below;
      S(kCnt, x) = cnt;
      S(kDone, x) = n <= K || below + cnt <= ls;
    }
  }

  // 3. into the boundary bin, 10 bits a pass, until its keys fit the list
  for (;;) {
    __syncthreads();
    bool more = false;
    for (int x = 0; x < cols; ++x) more |= !S(kDone, x);
    if (!more) break;                     // uniform over the block
    int32_t lo[VEC];
    int lg[VEC], sh[VEC];
    bool seek[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int x = xb + v;
      lo[v] = S(kLo, x);
      lg[v] = S(kLg, x);
      sh[v] = lg[v] - min(kDigit, lg[v]);
      seek[v] = !S(kDone, x);
    }
    __syncthreads();
    clear_hist();
    __syncthreads();
    sweep([&](int v, int x, int32_t k, int, bool ok) {
      const unsigned d = (unsigned)(k - lo[v]);
      if (ok && seek[v] && (d >> lg[v]) == 0u)
        atomicAdd(&hist[x * kHist + (int)(d >> sh[v])], 1);
    });
    __syncthreads();
    for (int x = warp; x < cols; x += kWarps) {
      if (S(kDone, x)) continue;
      const int lgx = S(kLg, x);
      const int db = min(kDigit, lgx), shx = lgx - db;
      int at, before, own;
      find(x, 1 << db, 0, K - S(kBelow, x), at, before, own);
      __syncwarp();
      if (lane == 0) {
        S(kLo, x) += at << shx;
        S(kLg, x) = shx;
        S(kBelow, x) += before;
        S(kCnt, x) = own;
        S(kDone, x) = S(kBelow, x) + own <= ls;
      }
    }
  }

  mark(2);
  // 4. the emit pass: each column's keys at or below the bin's top
  {
    int32_t top[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      top[v] = (int32_t)((unsigned)S(kLo, xb + v)
                         + ((1u << S(kLg, xb + v)) - 1u));
    sweep([&](int v, int x, int32_t k, int row, bool ok) {
      const bool keep = ok && k <= top[v];
      const unsigned m = __ballot_sync(kFull, keep) & gmask;
      const int leader = m ? __ffs(m) - 1 : lane;
      int base = 0;
      if (keep && lane == leader) base = atomicAdd(&S(kTot, x), __popc(m));
      base = __shfl_sync(kFull, base, leader);
      if (keep) {
        const int pos = base + __popc(m & below_lanes);
        akey[x * LSP + pos] = k;
        arow[x * LSP + pos] = row;
      }
    });
  }
  __syncthreads();
  mark(3);
  // 5. one warp a column: a stable LSD counting sort of its list, at most
  //    kSortBits a digit.  Lane l sorts its share [l * per, (l + 1) * per)
  //    of the list with counters of its own, so a digit's keys go in lane
  //    order, each lane's in list order: stable, with no atomics or votes
  for (int x = warp; x < cols; x += kWarps) {
    const int n = S(kTot, x);
    int32_t* sk = akey + x * LSP;
    int32_t* sr = arow + x * LSP;
    int32_t* dk = bkey + x * LSP;
    int32_t* dr = brow + x * LSP;
    int mn = 0x7FFFFFFF, mx = 0;
    for (int i = lane; i < n; i += 32) {
      mn = min(mn, sk[i]);
      mx = max(mx, sk[i]);
    }
    mn = __reduce_min_sync(kFull, mn);
    mx = __reduce_max_sync(kFull, mx);
    const int bits = n > 1 && mx > mn ? 32 - __clz(mx - mn) : 0;
    const int passes = (bits + kSortBits - 1) / kSortBits;
    const int dw = passes ? (bits + passes - 1) / passes : 0;
    const int nb = 1 << dw, mask = nb - 1;
    // lane l's counter of bin b at l * 33 + b (the column's histogram row)
    int* cnt = hist + x * kHist;
    int* own = cnt + lane * 33;
    const int per = (n + 31) / 32;
    const int i0 = min(n, lane * per), i1 = min(n, i0 + per);
    for (int p = 0; p < passes; ++p) {
      const int shift = p * dw;
      for (int b = 0; b < nb; ++b) own[b] = 0;
      for (int i = i0; i < i1; ++i) ++own[((sk[i] - mn) >> shift) & mask];
      __syncwarp();
      // lane b < nb: bin b's count over the lanes, a warp scan of those,
      // then each lane's start in bin b
      int tot = 0;
      if (lane < nb)
        for (int l = 0; l < 32; ++l) tot += cnt[l * 33 + lane];
      int incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      if (lane < nb) {
        int run = incl - tot;
        for (int l = 0; l < 32; ++l) {
          const int c = cnt[l * 33 + lane];
          cnt[l * 33 + lane] = run;
          run += c;
        }
      }
      __syncwarp();
      for (int i = i0; i < i1; ++i) {
        const int32_t k = sk[i];
        const int pos = own[((k - mn) >> shift) & mask]++;
        dk[pos] = k;
        dr[pos] = sr[i];
      }
      __syncwarp();
      int32_t* t;
      t = sk; sk = dk; dk = t;
      t = sr; sr = dr; dr = t;
    }
    if (lane == 0) S(kRes, x) = passes & 1;
  }
  __syncthreads();
  mark(4);

  // 6. the slots by rows, each payload fetched by its row
  {
    const int step = kThreads / cols;     // cols divides kThreads
    const int x = tid % cols, s0 = tid / cols, col = col0 + x;
    if (col < B) {
      const int32_t* rk = (S(kRes, x) ? bkey : akey) + x * LSP;
      const int32_t* rr = (S(kRes, x) ? brow : arow) + x * LSP;
      const int n = S(kN, x), m = min(S(kTot, x), K);
      for (int s1 = s0; s1 < K; s1 += 4 * step) {
        int32_t kk[4], v[4][kMaxPay];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = s1 + u * step;
          const bool got = s < m;
          const int r = got ? rr[s] : 0;
          kk[u] = got ? rk[s] : kSent;
#pragma unroll
          for (int p = 0; p < kMaxPay; ++p)
            v[u][p] = (p < n_pay && got) ? pay.in[p][r * ld + col] : 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = s1 + u * step;
          if (s >= K) break;
          okey[s * ld + col] = kk[u];
#pragma unroll
          for (int p = 0; p < kMaxPay; ++p)
            if (p < n_pay) pay.out[p][s * ld + col] = v[u][p];
        }
      }
      if (s0 == 0) {
        const uint32_t acc = accum != nullptr ? (uint32_t)accum[col] : 0u;
        okey[K * ld + col] = (int32_t)(acc + (uint32_t)max(n - K, 0));
      }
    }
  }
  mark(5);
}

// Raises the block's shared-memory limit once per kernel; a second thread
// that races here only repeats the call.
template <typename Kernel>
int raise_smem(Kernel kernel, bool& raised) {
  if (raised) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  raised = true;
  return 0;
}

template <int TX>
int launch(const int32_t* key, const Payloads& pay, int n_pay,
           const int32_t* window, const int32_t* accum, int32_t* okey, int C,
           int B, int K, cudaStream_t stream) {
  static bool raised = false;
  if (const int err = raise_smem(select_topk_kernel<TX>, raised)) return err;
  select_topk_kernel<TX><<<(B + TX - 1) / TX, kThreads, smem_bytes(TX, C, K),
                           stream>>>(key, pay, n_pay, window, accum, okey, C,
                                     B, K);
  return (int)cudaGetLastError();
}

// The tall kernel: a block each of the ceil(B / cols) tiles.
template <int VEC>
int launch_tall(const int32_t* key, const Payloads& pay, int n_pay,
                const int32_t* window, const int32_t* accum, int32_t* okey,
                int C, int B, int K, int cols, int ls, cudaStream_t stream) {
  static bool raised = false;
  if (const int err = raise_smem(select_topk_tall_kernel<VEC>, raised))
    return err;
  select_topk_tall_kernel<VEC><<<(B + cols - 1) / cols, kThreads,
                                 tall_smem_bytes(cols, ls), stream>>>(
      key, pay, n_pay, window, accum, okey, C, B, K, cols, ls);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).  `window` and `accum` may be null; unused payload pointers are
// ignored.  `tx` is the wrapper's plan: 16 or 8, the tiled kernel's columns a
// block; or, for the tall kernel, -(cols | ls << 4) with cols in {1, 2, 4,
// 8} columns a block and ls >= K entries a column list.  Returns
// cudaErrorInvalidValue for any other plan or one whose shared memory does
// not fit a block.
extern "C" int hsa_select_topk(const void* key, int n_pay,
                               const void* in0, const void* in1, const void* in2,
                               void* out0, void* out1, void* out2,
                               const void* window, const void* accum,
                               void* okey, int C, int B, int K, int tx,
                               void* stream) {
  if (n_pay < 0 || n_pay > kMaxPay || C < 1 || B < 1 || K < 1 || K > C)
    return (int)cudaErrorInvalidValue;
  const int cols = tx < 0 ? (-tx) & 15 : 0;
  const int ls = tx < 0 ? (-tx) >> 4 : 0;
  if (tx < 0) {
    const bool pow2 = cols > 0 && cols <= kMaxCols && !(cols & (cols - 1));
    if (!pow2 || ls < K || tall_smem_bytes(cols, ls) > kMaxSmem)
      return (int)cudaErrorInvalidValue;
  } else if ((tx != 16 && tx != 8) || smem_bytes(tx, C, K) > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  Payloads pay;
  pay.in[0] = (const int32_t*)in0;
  pay.in[1] = (const int32_t*)in1;
  pay.in[2] = (const int32_t*)in2;
  pay.out[0] = (int32_t*)out0;
  pay.out[1] = (int32_t*)out1;
  pay.out[2] = (int32_t*)out2;
  const int32_t* k = (const int32_t*)key;
  const int32_t* w = (const int32_t*)window;
  const int32_t* a = (const int32_t*)accum;
  int32_t* o = (int32_t*)okey;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tx == 16) return launch<16>(k, pay, n_pay, w, a, o, C, B, K, st);
  if (tx == 8) return launch<8>(k, pay, n_pay, w, a, o, C, B, K, st);
  // 16-byte loads where every row of the tile starts 16-byte aligned
  if (cols % 4 == 0 && B % 4 == 0 && (uintptr_t)key % 16 == 0)
    return launch_tall<4>(k, pay, n_pay, w, a, o, C, B, K, cols, ls, st);
  return launch_tall<1>(k, pay, n_pay, w, a, o, C, B, K, cols, ls, st);
}

// Turns the tall kernel's phase marks on (`buf`: int64 [blocks][6], the
// global timer in ns at the start and at the end of its histogram pass,
// select, emit, sort and write-out) or off (null) for the launches that
// follow.  For measurement only (chip_smoke.py --select-only); returns the
// CUDA error.
extern "C" int hsa_select_topk_trace(void* buf) {
  long long* p = (long long*)buf;
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));
}
