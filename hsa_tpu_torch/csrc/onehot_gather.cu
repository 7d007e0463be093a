// One-hot gather: out[i, w] = uint32(float32(tab[r, w])) with
// r = clamp(q[i], 0, R - 1), for a table of R rows of 8 32-bit words.
//
// Replaces tools/gather_probe2.py:189 test_onehot (pallas_call :210), whose
// body builds the one-hot [Q, R] float32 matrix of q and multiplies it by the
// table converted to float32 on the MXU, then converts back to uint32.  The
// product picks one table value per output, so the result is that value
// rounded to float32 (values of 2^24 and more lose low bits) and back.
//
// What bounds it: bytes.  A one-hot row holds a single 1, so the product is a
// gather: the function reads Q indices (4 bytes each) and one 32-byte row of
// the table per distinct index, and writes Q rows of 32 bytes.  At the
// probe's shapes (Q = 16,384; R = 512 and 2,048) that is about 0.6 MB, under
// a microsecond at 3.35 TB/s, so the launch bounds it there; at Q = 2^20 it
// is 37.8 MB, 11.3 us.
//
// Design: no product and no staging.  The first design on this card (kept
// measurable by chip_smoke.py --baseline) did the product exactly with int8
// mma.sync over four byte planes of the table, which every block restaged
// into its shared memory first: 128 blocks read 2 MB (R = 512) or 8 MB
// (R = 2,048) of table for 16 or 64 KB of rows, and each warp walked all
// R / 32 k-tiles, R times the work of the gather, so its time grew with R
// (device 8.5 and 14.6 us at Q = 16,384 on an H100 80GB HBM3 at 700 W,
// against a launch floor of about 5 us), and its planes capped R at 7,232
// rows.  A wgmma product would still do R times the gather's work (69 us at
// the int8 peak for R = 2,048 and Q = 2^20, against the 11.3 us bytes
// bound), and staging the table by TMA would still read R x 32 bytes a
// block.  So each block reads only the rows its queries name, from where
// the table already is:
//   - A block a tile of `tile` consecutive queries, two lanes a row, each
//     lane 16 of the row's 32 bytes.  Lane l < 16 of a warp loads the index
//     of the warp's row l (one coalesced 64-byte load, evict-first), and
//     lane l takes row l / 2's by shuffle.
//   - Each lane loads its half row with ld.global.nc.  The kernel uses no
//     shared memory and asks for the largest L1 carveout, so a table of the
//     probes' sizes (16 to 231 KB) sits in L1 and L2 after its first touch.
//   - Epilogue: each word rounded through float32 as the probe's body does
//     (__uint2float_rn, nearest, then __float2uint_rn, which saturates at
//     2^32 - 1), then a 16-byte st.global.cs (evict-first), so that the
//     output does not push the table out of L2.  A warp's stores are 512
//     contiguous bytes.
// R has no limit but int's.  The launch plan (tile, threads, grid) is made in
// kernels/gather.py (onehot_plan) and checked here.
// Measured (H100 80GB HBM3, 700 W; chip_smoke.py --probes-only --baseline,
// device time of queued calls): 5.7-5.9 us at Q = 16,384 for R = 512, 2,048
// and 7,233 alike, against a launch floor of 5.2 us (the first design: 8.5
// and 14.8 us); 18.8 us at R = 2,048 and Q = 2^20, 1.7x the bytes bound
// (the first design: 296 us).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLanesARow = 2;          // lanes that share a row of 32 bytes

__device__ __forceinline__ uint32_t round_f32(uint32_t w) {
  return __float2uint_rn(__uint2float_rn(w));
}

__global__ void __launch_bounds__(kMaxThreads)
onehot_gather_kernel(const uint4* __restrict__ tab, int R,
                     const int32_t* __restrict__ q, int Q, int tile,
                     uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = threadIdx.x / kLanesARow;               // of the tile
  const int wrow0 = (threadIdx.x & ~31) / kLanesARow;     // the warp's first
  const long long t0 = (long long)blockIdx.x * tile;
  const int n = (int)min((long long)tile, Q - t0);
  int32_t raw = 0;
  if (lane < 32 / kLanesARow && wrow0 + lane < n)
    raw = __ldcs(q + t0 + wrow0 + lane);
  const int r = min(max(__shfl_sync(0xffffffffu, raw, lane / kLanesARow), 0),
                    R - 1);
  if (row >= n) return;
  const int half = lane % kLanesARow;
  uint4 v = __ldg(tab + (long long)r * kLanesARow + half);
  v.x = round_f32(v.x);
  v.y = round_f32(v.y);
  v.z = round_f32(v.z);
  v.w = round_f32(v.w);
  __stcs(out + (t0 + row) * kLanesARow + half, v);
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).  `tab` is [R, 8] int32 (32-bit patterns), 16-byte aligned; `q`
// [Q] int32; `out` [Q, 8] int32, 16-byte aligned.  The plan (from
// kernels/gather.py:onehot_plan) is checked: 1 <= tile, threads = 2 x tile
// rounded up to a warp and at most 1,024, grid = the tiles.
extern "C" int hsa_onehot_gather(const void* tab, int R, const void* q, int Q,
                                 int tile, int threads, int grid, void* out,
                                 void* stream) {
  if (R < 1 || Q < 1 || tile < 1 || tile > kMaxThreads / kLanesARow ||
      threads != (kLanesARow * tile + 31) / 32 * 32 ||
      grid != (Q + tile - 1LL) / tile)
    return (int)cudaErrorInvalidValue;
  // a hint, asked once: all of the SM's unified memory that a block does not
  // claim as shared memory (none here) serves as L1; a second thread that
  // races here only repeats the call
  static bool carved = false;
  if (!carved) {
    const cudaError_t err = cudaFuncSetAttribute(
        onehot_gather_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxL1);
    if (err != cudaSuccess) return (int)err;
    carved = true;
  }
  onehot_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)tab, R, (const int32_t*)q, Q, tile, (uint4*)out);
  return (int)cudaGetLastError();
}
