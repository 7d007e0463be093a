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
// On the card they are launch parameters of this one kernel: `pipe` (the
// rows whose loads a thread keeps in flight before it stores any, the
// counterpart of PIPE outstanding DMAs), `chunk` (the queries of one block;
// test_grid's CHUNK) and the row width W.
//
// What bounds it: bytes.  The function reads NQ indices (4 bytes each), one
// 32-byte sector per distinct row of 32 bytes (four per row of 128), and
// writes NQ rows.  The rows are random, so nothing is shared between
// neighbouring queries and every row read is a separate trip to memory
// (device memory or, for a table that fits, the 50 MB L2).  At the card's
// ~3.35 TB/s and several hundred ns a trip, tens of thousands of row loads
// must be in flight across the card to reach the rate.
//
// Design (a simple kernel that is right; a TMA bulk-copy ring with mbarriers,
// one copy per row with the barrier as its semaphore, is a later design):
//   - T = W / 4 neighbouring threads own one row, each moving 16 bytes: one
//     int4 load through the read-only non-coherent path, one int4 store.
//   - A thread issues the loads of `pipe` rows into registers before it
//     stores any of them, so pipe x (threads / T) rows are in flight per
//     block.
//   - The rows of one step are spread over the block's thread groups
//     (row = base + k * groups + g), so the stores of step k are contiguous
//     across a warp.
//   - A block takes `chunk` consecutive queries and walks them in steps of
//     groups x pipe rows; its width is the fewest warps that give every
//     group `pipe` rows of the chunk, at most 256 threads.
// Indices are clamped to the table, as the FM primitives' gathers are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

template <int T, int PIPE>
__global__ void __launch_bounds__(kMaxThreads)
gather_rows_kernel(const int4* __restrict__ tab, int nb,
                   const int32_t* __restrict__ q, int nq, int chunk,
                   int4* __restrict__ out) {
  const int groups = blockDim.x / T;
  const int g = threadIdx.x / T;
  const int part = threadIdx.x % T;
  const long long c0 = (long long)blockIdx.x * chunk;
  const int n = (int)min((long long)chunk, (long long)nq - c0);
  for (int base = 0; base < n; base += groups * PIPE) {
    int4 v[PIPE];
#pragma unroll
    for (int k = 0; k < PIPE; ++k) {
      const int r = base + k * groups + g;
      if (r < n) {
        const int b = min(max(__ldg(q + c0 + r), 0), nb - 1);
        v[k] = __ldg(tab + (long long)b * T + part);
      }
    }
#pragma unroll
    for (int k = 0; k < PIPE; ++k) {
      const int r = base + k * groups + g;
      if (r < n) out[(c0 + r) * T + part] = v[k];
    }
  }
}

template <int T, int PIPE>
int launch(const int4* tab, int nb, const int32_t* q, int nq, int chunk,
           int4* out, cudaStream_t stream) {
  const long long groups_needed = ((long long)chunk + PIPE - 1) / PIPE;
  long long threads = (groups_needed * T + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long blocks = ((long long)nq + chunk - 1) / chunk;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  gather_rows_kernel<T, PIPE><<<(unsigned)blocks, (unsigned)threads, 0,
                                 stream>>>(tab, nb, q, nq, chunk, out);
  return (int)cudaGetLastError();
}

template <int T>
int launch_pipe(const int4* tab, int nb, const int32_t* q, int nq, int pipe,
                int chunk, int4* out, cudaStream_t stream) {
  switch (pipe) {
    case 1: return launch<T, 1>(tab, nb, q, nq, chunk, out, stream);
    case 2: return launch<T, 2>(tab, nb, q, nq, chunk, out, stream);
    case 4: return launch<T, 4>(tab, nb, q, nq, chunk, out, stream);
    case 8: return launch<T, 8>(tab, nb, q, nq, chunk, out, stream);
    case 16: return launch<T, 16>(tab, nb, q, nq, chunk, out, stream);
    case 32: return launch<T, 32>(tab, nb, q, nq, chunk, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).  `tab` is [nb, w] int32 with w = 8 or 32, 16-byte aligned; `q` is
// [nq] int32; `out` is [nq, w] int32.  pipe is 1, 2, 4, 8, 16 or 32.
extern "C" int hsa_gather_rows(const void* tab, int nb, int w, const void* q,
                               int nq, int pipe, int chunk, void* out,
                               void* stream) {
  if (nb < 1 || nq < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  const int4* t = (const int4*)tab;
  const int32_t* qq = (const int32_t*)q;
  int4* o = (int4*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (w == 8) return launch_pipe<2>(t, nb, qq, nq, pipe, chunk, o, st);
  if (w == 32) return launch_pipe<8>(t, nb, qq, nq, pipe, chunk, o, st);
  return (int)cudaErrorInvalidValue;
}
