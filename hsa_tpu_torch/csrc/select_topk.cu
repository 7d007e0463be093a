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
// above W of about 700): a tile of 8 columns no longer fits in a block's
// shared memory, so a block of the tall variant owns ONE column, and all 16
// warps work on it:
//   1. thread t reads rows t, t + 512, ...; each warp appends its valid keys
//      with one shared-memory atomic (a ballot, then a prefix popcount).
//   2. Where n > K, the block bisects to the K-th smallest key as above, each
//      round a count over all 512 threads, summed over the warps through
//      shared memory; the K keys at or below it are appended, in any order,
//      to a second list of K entries.
//   3. Each of the min(n, K) kept keys is ranked by counting smaller keys, by
//      512 threads at once, and written to row `rank` of the output with its
//      payloads, fetched by its row; slots n..K-1 get SENT and 0.
// At 9W < 2^14 (the beam's key limit) and K = W the two lists take at most
// 160,276 bytes.  A warp's key load touches 32 rows of one column, a sector
// each; making these shapes fast is later work.
//
// The variant is chosen by the wrapper (hsa_tpu_torch/kernels/select.py:
// _plan, the same rule as smem_bytes below: the widest tile of 16, 8 or 1
// columns that fits) and checked here.

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

struct Payloads {
  const int32_t* in[kMaxPay];
  int32_t* out[kMaxPay];
};

__device__ __forceinline__ bool is_valid(int32_t k, bool has_win, int32_t win) {
  return k < kSent && !(has_win && (k >> kKeyShift) > win);
}

// Entries per column list: at least C, and 1 modulo 32.
__host__ __device__ inline int list_cap(int C) { return ((C + 31) / 32) * 32 + 1; }

// Shared memory of one block, in bytes: a tile of TX = 16 or 8 columns, or
// the tall variant's one column (TX = 1).
inline size_t smem_bytes(int TX, int C, int K) {
  if (TX == 1)
    return sizeof(int32_t) * ((size_t)2 * list_cap(C) + (size_t)2 * K
                              + 2 * kWarps + 2);
  return sizeof(int32_t) * ((size_t)2 * TX * list_cap(C)
                            + (size_t)(2 * K + 1) * (TX + 1) + TX);
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

// Tall columns: one column a block, all warps on it (see the note above).
__global__ void __launch_bounds__(kThreads)
select_topk_tall_kernel(const int32_t* __restrict__ key, Payloads pay,
                        int n_pay, const int32_t* __restrict__ window,
                        const int32_t* __restrict__ accum,
                        int32_t* __restrict__ okey, int C, int B, int K) {
  extern __shared__ int32_t smem[];
  const int cap = list_cap(C);
  int32_t* skey = smem;                   // [cap] valid keys of the column
  int32_t* srow = skey + cap;             // [cap] and their rows
  int32_t* kkey = srow + cap;             // [K] the K smallest, any order
  int32_t* krow = kkey + K;               // [K] and their rows
  int32_t* part = krow + K;               // [2 * kWarps] per-warp partials
  int* cnt = part + 2 * kWarps;           // [2] list length, kept count

  const int col = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const size_t ld = (size_t)B;
  if (tid < 2) cnt[tid] = 0;
  __syncthreads();

  // 1. read the column once; each warp appends its valid keys
  const bool has_win = window != nullptr;
  const int32_t win = has_win ? window[col] : 0;
  for (int c0 = 0; c0 < C; c0 += kLoads * kThreads) {
    int32_t k[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int cc = c0 + u * kThreads + tid;
      k[u] = cc < C ? key[cc * ld + col] : kSent;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const bool v = is_valid(k[u], has_win, win);
      const unsigned mask = __ballot_sync(kFull, v);
      int base = 0;
      if (lane == 0 && mask) base = atomicAdd(&cnt[0], __popc(mask));
      base = __shfl_sync(kFull, base, 0);
      if (v) {
        const int pos = base + __popc(mask & below);
        skey[pos] = k[u];
        srow[pos] = c0 + u * kThreads + tid;
      }
    }
  }
  __syncthreads();
  const int n = cnt[0];
  const int m = min(n, K);
  const int32_t* rk = skey;
  const int32_t* rr = srow;

  // 2. more than K: bisect to the K-th smallest key over the whole block
  //    (lo and hi are the same in every thread, so the loop is uniform),
  //    then append the K keys at or below it to the second list
  if (n > K) {
    int32_t lo = 0x7FFFFFFF, hi = 0;
    for (int i = tid; i < n; i += kThreads) {
      lo = min(lo, skey[i]);
      hi = max(hi, skey[i]);
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      part[warp] = lo;
      part[kWarps + warp] = hi;
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      lo = min(lo, part[w]);
      hi = max(hi, part[kWarps + w]);
    }
    __syncthreads();
    while (lo < hi) {
      const int32_t mid = lo + (hi - lo) / 2;
      int c = 0;
      for (int i = tid; i < n; i += kThreads) c += skey[i] <= mid;
      c = __reduce_add_sync(kFull, c);
      if (lane == 0) part[warp] = c;
      __syncthreads();
      int total = 0;
      for (int w = 0; w < kWarps; ++w) total += part[w];
      __syncthreads();             // every thread has read before the next round
      if (total >= K) hi = mid; else lo = mid + 1;
    }
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + tid;
      const bool keep = i < n && skey[i] <= lo;
      const unsigned mask = __ballot_sync(kFull, keep);
      int base = 0;
      if (lane == 0 && mask) base = atomicAdd(&cnt[1], __popc(mask));
      base = __shfl_sync(kFull, base, 0);
      if (keep) {
        const int pos = base + __popc(mask & below);
        kkey[pos] = skey[i];
        krow[pos] = srow[i];
      }
    }
    __syncthreads();
    rk = kkey;
    rr = krow;
  }

  // 3. rank the m kept keys by counting smaller ones; write each to its row
  for (int i = tid; i < m; i += kThreads) {
    const int32_t own = rk[i];
    int rank = 0;
#pragma unroll 4
    for (int j = 0; j < m; ++j) rank += rk[j] < own;
    const int r = rr[i];
    okey[rank * ld + col] = own;
    for (int p = 0; p < n_pay; ++p)
      pay.out[p][rank * ld + col] = pay.in[p][r * ld + col];
  }
  for (int s = n + tid; s < K; s += kThreads) {
    okey[s * ld + col] = kSent;
    for (int p = 0; p < n_pay; ++p) pay.out[p][s * ld + col] = 0;
  }
  if (tid == 0) {
    const uint32_t acc = accum != nullptr ? (uint32_t)accum[col] : 0u;
    okey[K * ld + col] = (int32_t)(acc + (uint32_t)max(n - K, 0));
  }
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
  const size_t smem = smem_bytes(TX, C, K);
  static bool raised = false;
  if constexpr (TX == 1) {
    if (const int err = raise_smem(select_topk_tall_kernel, raised)) return err;
    select_topk_tall_kernel<<<B, kThreads, smem, stream>>>(
        key, pay, n_pay, window, accum, okey, C, B, K);
  } else {
    if (const int err = raise_smem(select_topk_kernel<TX>, raised)) return err;
    select_topk_kernel<TX><<<(B + TX - 1) / TX, kThreads, smem, stream>>>(
        key, pay, n_pay, window, accum, okey, C, B, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).  `window` and `accum` may be null; unused payload pointers are
// ignored.  `tx` is the wrapper's plan (16, 8 or 1 columns a block); returns
// cudaErrorInvalidValue when it is none of those or its shared memory does
// not fit a block.
extern "C" int hsa_select_topk(const void* key, int n_pay,
                               const void* in0, const void* in1, const void* in2,
                               void* out0, void* out1, void* out2,
                               const void* window, const void* accum,
                               void* okey, int C, int B, int K, int tx,
                               void* stream) {
  if (n_pay < 0 || n_pay > kMaxPay || C < 1 || B < 1 || K < 1 || K > C ||
      (tx != 16 && tx != 8 && tx != 1) || smem_bytes(tx, C, K) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
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
  return launch<1>(k, pay, n_pay, w, a, o, C, B, K, st);
}
