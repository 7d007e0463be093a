// Batched glocal affine-gap min-cost DP: the mate-rescue screen.
//
// Replaces the Pallas kernel hsa_tpu/kernels/sw.py:_glocal_kernel behind
// glocal_screen_pallas.  Semantics oracle: glocal_screen in the same file,
// and glocal_screen_plain in hsa_tpu_torch/kernels/sw.py.
//
// Each job r aligns the whole read reads[r, :lens[r]] (codes 0..4, 4 = N
// mismatches everything) against windows[r, :wlens[r]] (codes 0..3) with a
// free start and end in the window.  Costs: s_mm per mismatch, s_gapo +
// (g-1)*s_gape per gap of length g.  Per window column j = 1..W the DP keeps
// m (last op a match), ins (read base against no window base) and del
// (window base against no read base); column 0 keeps m0 and ins0.  One row
// per read base:
//
//   m'[j]   = min(m[j-1], ins[j-1], del[j-1]) + sub(i, j)   (column 0: m0,
//             ins0, BIG)
//   ins'[j] = min(m[j] + s_gapo, ins[j] + s_gape)
//   del'[j] = j*s_gape + min_{j' < j}(m'[j'] - j'*s_gape + s_gapo - s_gape)
//             (BIG + s_gape at j = 1)
//   ins0'   = min(m0 + s_gapo, ins0 + s_gape);  m0' = BIG
//
// Out: cost[r] = min(min(ins0, m0), min_j min(m, ins, del)[j]) and end[r],
// the window column where it is reached: 0 (a whole-read insertion) wins
// ties, then the first column at the minimum.
//
// Design: one block of kThreads threads per job; each thread owns a run of
// consecutive window columns.  The read, the window and the three DP rows
// live in shared memory ((L + 4G) int32).  Per row a thread updates m and
// ins over its columns left to right, keeping the old values of the column
// on its left in registers, and folds its columns' deletion terms into one
// minimum; a block scan (__shfl_up_sync within each warp, warp totals in
// shared memory) turns those into exclusive prefix minima, from which each
// thread writes its columns' del.  Three barriers per row; int32 throughout.
//
// What bounds it: the serial row loop, L rows of about 25 integer
// instructions per column as written here (the recurrence itself needs 11:
// compare and select for sub, two min and an add for m', two adds and a min
// for ins', and add, min, add for del') plus the scan and three barriers,
// all in shared memory; device memory is read once per job ((L + G) int32) and written
// once (two int32).  At the rescue shapes (L = 150, G = 576) a thread owns
// 5 columns, so a row is short and the barriers and the scan weigh as much
// as the arithmetic.  Packing several jobs into one block, or anti-diagonal
// wavefronts, would keep more threads busy between barriers; left to later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kBig = 1 << 28;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kDefaultSmem = 40 * 1024;   // below the 48 KB default, with
                                             // room for the static arrays

// Exclusive block-wide prefix minimum of one value per thread; kBig before
// thread 0.  Every thread of the block must call it.
__device__ __forceinline__ int32_t block_excl_min(int32_t x, int32_t* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = min(incl, y);
  }
  int32_t excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = kBig;
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl = min(excl, part[w]);
  __syncthreads();                              // part is reused next row
  return excl;
}

// (value, column) pairs: the smaller value wins, then the smaller column.
__device__ __forceinline__ void min_pair(int32_t& v, int32_t& c, int32_t v2,
                                         int32_t c2) {
  if (v2 < v || (v2 == v && c2 < c)) {
    v = v2;
    c = c2;
  }
}

__global__ void __launch_bounds__(kThreads)
glocal_screen_kernel(const int32_t* __restrict__ reads,
                     const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ windows,
                     const int32_t* __restrict__ wlens,
                     int32_t* __restrict__ cost_out,
                     int32_t* __restrict__ end_out, int L, int G, int s_mm,
                     int s_gapo, int s_gape) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t part[kWarps];
  __shared__ int32_t best_v[kWarps], best_c[kWarps];
  const int r = blockIdx.x;
  const int n_rows = max(0, min(lens[r], L));
  const int W = max(0, min(wlens[r], G));
  int32_t* rd = smem;          // [L]  the read
  int32_t* win = rd + L;       // [G]  the window
  int32_t* m = win + G;        // [G]  index j - 1 holds column j
  int32_t* ins = m + G;
  int32_t* del = ins + G;

  const int32_t* rrow = reads + (size_t)r * L;
  const int32_t* wrow = windows + (size_t)r * G;
  for (int i = threadIdx.x; i < n_rows; i += kThreads) rd[i] = rrow[i];
  for (int j = threadIdx.x; j < W; j += kThreads) {
    win[j] = wrow[j];
    m[j] = 0;                  // row 0: free start at every column
    ins[j] = kBig;
    del[j] = kBig;
  }
  // this thread's columns: indices [j0, j1), i.e. columns j0 + 1 .. j1
  const int per = (W + kThreads - 1) / kThreads;
  const int j0 = min(W, (int)threadIdx.x * per);
  const int j1 = min(W, j0 + per);
  const int32_t dconst = s_gapo - s_gape;
  int32_t m0 = 0, ins0 = kBig;   // column 0, the same in every thread
  __syncthreads();

  for (int i = 0; i < n_rows; ++i) {
    const int32_t rb = rd[i];
    // the previous row's values of the column left of this thread's first
    int32_t pm = kBig, pi = kBig, pd = kBig;
    if (j0 == 0) {
      pm = m0;
      pi = ins0;
    } else if (j0 < j1) {
      pm = m[j0 - 1];
      pi = ins[j0 - 1];
      pd = del[j0 - 1];
    }
    __syncthreads();           // every left neighbour read before any write
    int32_t run = kBig;        // min of this thread's deletion terms
    for (int j = j0; j < j1; ++j) {
      const int32_t om = m[j], oi = ins[j], od = del[j];
      const int32_t sub = (rb <= 3 && rb == win[j]) ? 0 : s_mm;
      const int32_t mn = min(min(pm, pi), pd) + sub;
      m[j] = mn;
      ins[j] = min(om + s_gapo, oi + s_gape);
      run = min(run, mn - (j + 1) * s_gape + dconst);
      pm = om;
      pi = oi;
      pd = od;
    }
    int32_t before = block_excl_min(run, part);
    for (int j = j0; j < j1; ++j) {
      const int32_t ramp = (j + 1) * s_gape;
      del[j] = before + ramp;
      before = min(before, m[j] - ramp + dconst);
    }
    ins0 = min(m0 + s_gapo, ins0 + s_gape);
    m0 = kBig;
    __syncthreads();           // this row written before the next reads it
  }

  // best column: per thread, per warp (shuffles), then across warps
  int32_t bv = kBig, bc = G + 1;
  for (int j = j0; j < j1; ++j)
    min_pair(bv, bc, min(min(m[j], ins[j]), del[j]), j + 1);
  for (int d = 16; d > 0; d >>= 1)
    min_pair(bv, bc, __shfl_down_sync(kFull, bv, d),
             __shfl_down_sync(kFull, bc, d));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    best_v[warp] = bv;
    best_c[warp] = bc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) min_pair(bv, bc, best_v[w], best_c[w]);
    const int32_t end0 = min(ins0, m0);
    cost_out[r] = min(bv, end0);
    end_out[r] = end0 <= bv ? 0 : bc;
  }
}

}  // namespace

// Launches one block per job on `stream` and returns the CUDA error of the
// launch (0 on success).  All arrays are row-major int32 on the device:
// reads [R, L], lens [R], windows [R, G], wlens [R]; cost and end [R].
extern "C" int hsa_glocal_screen(const void* reads, const void* lens,
                                 const void* windows, const void* wlens,
                                 void* cost, void* end, int R, int L, int G,
                                 int s_mm, int s_gapo, int s_gape,
                                 void* stream) {
  if (R < 1 || L < 0 || G < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)L + 4 * (size_t)G) * sizeof(int32_t);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        glocal_screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  glocal_screen_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)reads, (const int32_t*)lens, (const int32_t*)windows,
      (const int32_t*)wlens, (int32_t*)cost, (int32_t*)end, L, G, s_mm,
      s_gapo, s_gape);
  return (int)cudaGetLastError();
}
