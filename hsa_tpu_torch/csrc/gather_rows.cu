// Row gather from device memory: out[i] = tab[clamp(q[i], 0, nb - 1)] for
// rows of W 32-bit words (W = 8: the FM index's fused occ row of 32 bytes;
// W = 32: 128-byte rows).
//
// Replaces the per-row DMA gathers of the TPU probes, which differ only in
// how Mosaic was asked to keep PIPE row copies in flight (Mosaic refused some
// forms, hence the variants):
//   tools/gather_probe.py:151 test_dma (pallas_call :191), PIPE 8, ring
//   tools/gather_probe2.py:96 test_dmapipe (:134), PIPE 8 and 32
//   tools/gather_probe3.py:90 test_orig (:121), :131 test_pow2 (:161),
//     :171 test_unroll (:210), :220 test_grid (:245), :255 test_scoped
//     (:290), :300 test_wide (:337, W = 32)
//   tools/sync_probe.py:135 test_dma (:178), PIPE 16
// On the card they are one kernel whose launch differs only in `tile` (the
// rows of a block; test_grid's CHUNK) and the row width W.  A block keeps
// all of its tile's row loads in flight at once, so the probes' PIPE has
// nothing left to set here.
//
// What bounds it: bytes.  The function reads NQ indices (4 bytes each), one
// 32-byte sector per distinct row of 32 bytes (four per row of 128), and
// writes NQ rows.  The rows are random, so nothing is shared between
// neighbouring queries and every row read is a separate trip to memory
// (device memory or, for a table that fits, the 50 MB L2).  At the card's
// ~3.35 TB/s and about 1 us a trip, some 3.4 MB (over 100,000 rows of 32
// bytes) must be in flight across the card to reach the rate, and each row
// waits for its index: two dependent trips, then the store.
//
// Design: a block a tile of `tile` consecutive queries, a thread a row of it,
// the grid all of the tiles:
//   - One index load a row: thread j loads row j's index (coalesced across
//     the warp) and the warp's T = W / 4 lanes of a row take it by shuffle.
//   - Each lane then loads its T 16-byte pieces of the warp's 32 rows (piece
//     p = j * 32 + lane: row p / T, part p % T), all T in flight at once,
//     and stores them: a warp's stores of one round are 512 contiguous bytes
//     (a tile's output rows are consecutive).  The stores are st.global.cs,
//     evict-first, so that the output does not push table rows out of L2.
// A persistent grid whose blocks kept the cp.async row copies of several
// tiles in flight in a shared-memory ring was no faster on an H100 80GB
// HBM3 (700 W): equal at 131,072 rows, slower at 2^20 rows warm, faster
// only at 2^20 rows with the L2 flushed (PERF.md, section 6).
// The launch plan (tile, threads, grid) is made in kernels/gather.py
// (rows_plan) and checked here.  Indices are clamped to the table, as the FM
// primitives' gathers are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

template <int T>
__global__ void __launch_bounds__(kMaxThreads)
gather_rows_kernel(const int4* __restrict__ tab, int nb,
                   const int32_t* __restrict__ q, int nq, int tile,
                   int4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row0 = threadIdx.x & ~31;  // the warp's first row of the tile
  const long long t0 = (long long)blockIdx.x * tile;
  const int n = (int)min((long long)tile, nq - t0);
  int32_t raw = 0;
  if ((int)threadIdx.x < n) raw = __ldcs(q + t0 + threadIdx.x);
  int4 v[T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const int p = j * 32 + lane;
    const int b = min(max(__shfl_sync(0xffffffffu, raw, p / T), 0), nb - 1);
    if (row0 + p / T < n) v[j] = __ldg(tab + (long long)b * T + p % T);
  }
  int4* dst = out + (t0 + row0) * T;
#pragma unroll
  for (int j = 0; j < T; ++j)
    if (row0 + (j * 32 + lane) / T < n) __stcs(dst + j * 32 + lane, v[j]);
}

template <int T>
int launch(const int4* tab, int nb, const int32_t* q, int nq, int tile,
           int threads, int grid, int4* out, cudaStream_t stream) {
  gather_rows_kernel<T><<<grid, threads, 0, stream>>>(tab, nb, q, nq, tile,
                                                      out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).  `tab` is [nb, w] int32 with w = 8 or 32, 16-byte aligned; `q` is
// [nq] int32; `out` is [nq, w] int32, 16-byte aligned.  The plan (from
// kernels/gather.py:rows_plan) is checked: 1 <= tile <= 1024, threads = tile
// rounded up to a warp, grid = the tiles.
extern "C" int hsa_gather_rows(const void* tab, int nb, int w, const void* q,
                               int nq, int tile, int threads, int grid,
                               void* out, void* stream) {
  if (nb < 1 || nq < 1 || tile < 1 || tile > kMaxThreads ||
      threads != (tile + 31) / 32 * 32 || grid != (nq + tile - 1LL) / tile)
    return (int)cudaErrorInvalidValue;
  const int4* t = (const int4*)tab;
  const int32_t* qq = (const int32_t*)q;
  int4* o = (int4*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (w == 8) return launch<2>(t, nb, qq, nq, tile, threads, grid, o, st);
  if (w == 32) return launch<8>(t, nb, qq, nq, tile, threads, grid, o, st);
  return (int)cudaErrorInvalidValue;
}
