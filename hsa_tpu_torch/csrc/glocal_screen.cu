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
// What bounds it on an H100: integer instruction throughput.  Device memory
// is touched once per job ((L + G) int32 in, two int32 out: microseconds for
// a batch), while the recurrence is L x G cells of a dozen dependent integer
// operations.  A
// scheduler starts one warp instruction a clock; its integer pipe (compare,
// select, min) takes one every two clocks, its multiply-add pipe (which also
// adds integers) another.  An SM moves only 32 words of shared memory a
// clock, so a DP row kept in shared memory is bound by its own loads and
// stores, and a block that shares a row pays barriers around a row that is a
// handful of columns per thread.
//
// Design: one warp per job, the DP state in registers; the row loop touches
// no shared memory and has no block barrier.
//
// - Lane l owns CPL consecutive columns (CPL a template parameter, even
//   values 2..24, the smallest that covers the window), so the column loops
//   unroll and every register index is static.  Warps of a block work on
//   different jobs and never wait for each other.
// - Per column a lane keeps m, ins and t = min(m, ins, del) of the last row,
//   and the window code: del itself is never needed again once t is known.
//   All three are kept less k*s_gape (k the column's index within the lane),
//   which takes the ramp j*s_gape out of the deletion terms: the lane's
//   deletion run-minimum is a plain minimum of its m' (one three-way minimum
//   per two columns) and del' needs no multiply or per-column constant.
// - Per row: one shuffle brings the read's base (32 bases are loaded at a
//   time, one per lane), one brings t of the left lane's last column (lane
//   0: column 0's min(m0, ins0)); a pass over the lane's columns gives m',
//   ins' and the run-minimum; a five-step warp prefix-minimum (shuffles
//   only; a lane below the shuffle distance gets its own value back, and
//   the minimum is idempotent, so no lane test) gives each lane the deletion
//   cost entering its first column; a second pass gives t'.
// - Fused integer instructions of sm_90 (__vimin3_s32, __viaddmin_s32): per
//   cell a compare and a select for the substitution, an add for m', an add
//   and an add-min for ins', half a three-way minimum for the run, a
//   three-way minimum for t' and an add-min for the deletion carry: 7.5
//   instructions where the recurrence written out needs 11 operations, and
//   the two adds among them run on the multiply-add pipe (see pass 1).
// - A window wider than 32 x 24 columns is cut into column tiles of equal
//   width, run left to right by the same warp: a tile leaves, per row, t of
//   its last column in the row before and the deletion cost entering the
//   next tile's first column, in a scratch array of 2 L int32 per warp in
//   device memory (the wrapper allocates it, only for such windows), written
//   and read 32 rows at a time, one row per lane, so that the row loop sees
//   shuffles only.  Shared memory would bound L; this way any L and G is
//   taken, and warps then loop over jobs so that the scratch stays bounded.
// - The window's codes reach the lanes through a per-warp staging tile in
//   shared memory (coalesced loads, odd row stride), once per job and tile.
// - Columns past wlens[r] are computed and ignored: a column depends only on
//   columns to its left, and the final (value, column) minimum skips them.
//
// Registers and occupancy (nvcc 12.8 -Xptxas -v, sm_90a): CPL = 18, the
// rescue's windows of up to 576 columns, takes 128 registers a thread and
// no spill (125 with the tiles' hand-over), so 4 blocks of 4 warps fit an SM
// (16 resident warps, 4 per scheduler); CPL of 20 and more take up to 166
// and run 3 blocks.  A row of the CPL = 18 loop is 177 instructions: 110 on
// the integer pipe (37 add-min, 26 three-way min, 19 compare, 19 select, 9
// others), 57 adds and moves on the multiply-add pipe, 8 shuffles.  The
// integer pipe (16 lanes a scheduler) is what binds; measured times stand in
// PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kBig = 1 << 28;
constexpr int kWarps = 4;                    // per block, each on its own job
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kNoBase = 5;               // a window code no read base has
// Tiles of equal width that cover more than 32 x 24 columns are at least 14
// columns a lane wide (two tiles over 769 columns), so narrower tiled
// kernels are not built.
constexpr int kMinTiledCpl = 14;

// blocks per SM that the register cap must allow
constexpr int min_blocks(int cpl) { return cpl <= 18 ? 4 : 3; }

// (value, column) pairs: the smaller value wins, then the smaller column.
__device__ __forceinline__ void min_pair(int32_t& v, int32_t& c, int32_t v2,
                                         int32_t c2) {
  if (v2 < v || (v2 == v && c2 < c)) {
    v = v2;
    c = c2;
  }
}

// TILED: the window spans several column tiles (n_tiles > 1); without it the
// row loop carries none of the tiles' hand-over.  sub_hit and sub_miss are
// -s_gape and s_mm - s_gape, handed in by the entry point (see pass 1).
template <int CPL, bool TILED>
__global__ void __launch_bounds__(kThreads, min_blocks(CPL))
glocal_screen_kernel(const int32_t* __restrict__ reads,
                     const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ windows,
                     const int32_t* __restrict__ wlens,
                     int32_t* __restrict__ cost_out,
                     int32_t* __restrict__ end_out,
                     int32_t* __restrict__ scratch, int R, int L, int G,
                     int n_tiles, int s_gapo, int s_gape, int sub_hit,
                     int sub_miss) {
  constexpr int kStride = CPL | 1;           // odd: no bank conflicts
  constexpr int kTile = 32 * CPL;
  __shared__ int32_t stage[kWarps][32 * kStride];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int warp = blockIdx.x * kWarps + wib;
  const int n_warps = gridDim.x * kWarps;
  int32_t* const stg = stage[wib];
  int32_t* const edge_t = scratch + (size_t)warp * 2 * L;   // [L] t of the
  int32_t* const edge_d = edge_t + L;     // last column; [L] deletion carry
  const int32_t dconst = s_gapo - s_gape;
  const int32_t lane_ramp = lane * CPL * s_gape;
  if (!TILED) n_tiles = 1;

  for (int r = warp; r < R; r += n_warps) {
    const int n_rows = max(0, min(lens[r], L));
    const int W = max(0, min(wlens[r], G));
    const int32_t* rrow = reads + (size_t)r * L;
    const int32_t* wrow = windows + (size_t)r * G;
    int32_t bv = kBig, bc = G + 1;           // best (value, column) so far
    int32_t m0 = 0, ins0 = kBig;             // column 0

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int tile0 = tile * kTile;        // columns tile0 + 1 .. + kTile
      if (tile > 0 && tile0 >= W) break;     // nothing valid to the right
      const bool more = tile + 1 < n_tiles;

      // window codes: coalesced into the staging tile, then each lane its run
      for (int x = lane; x < kTile; x += 32) {
        int32_t w = tile0 + x < W ? wrow[tile0 + x] : kNoBase;
        stg[(x / CPL) * kStride + x % CPL] = w > 3 ? kNoBase : w;
      }
      __syncwarp();
      int32_t win[CPL], m[CPL], in[CPL], t[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        win[k] = stg[lane * kStride + k];
        m[k] = -k * s_gape;                  // row 0: free start everywhere,
        in[k] = kBig - k * s_gape;           // less the column's ramp
        t[k] = -k * s_gape;
      }
      __syncwarp();
      m0 = 0;
      ins0 = kBig;

      int32_t rd_next = lane < n_rows ? rrow[lane] : 4;
      for (int i0 = 0; i0 < n_rows; i0 += 32) {
        const int32_t rd = rd_next;
        rd_next = i0 + 32 + lane < n_rows ? rrow[i0 + 32 + lane] : 4;
        int32_t in_t = 0, in_d = 0, out_t = 0, out_d = 0;
        if (tile > 0 && i0 + lane < n_rows) {
          in_t = edge_t[i0 + lane];
          in_d = edge_d[i0 + lane];
        }
        const int nn = min(32, n_rows - i0);
        for (int ii = 0; ii < nn; ++ii) {
          int32_t rb = __shfl_sync(kFull, rd, ii);
          rb = rb <= 3 ? rb : 4;
          // t of the column left of this lane's first, and the deletion
          // cost entering the tile's first column
          int32_t diag = __shfl_up_sync(kFull, t[CPL - 1], 1) + CPL * s_gape;
          int32_t seed = kBig + s_gape;
          if (tile > 0) {
            const int32_t et = __shfl_sync(kFull, in_t, ii);
            seed = __shfl_sync(kFull, in_d, ii);
            if (lane == 0) diag = et + s_gape;
          } else if (lane == 0) {
            diag = min(m0, ins0) + s_gape;
          }
          // pass 1: m', ins' and the lane's deletion run-minimum.  The two
          // substitution terms come as kernel arguments: derived here from
          // s_mm and s_gape, the compiler folds select and add into a
          // three-operand add on the integer pipe, which is the busy one;
          // kept apart, the add can run on the multiply-add pipe
          int32_t run = 0;                   // min of the lane's m' (CPL even)
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            const int32_t mn = diag + (rb == win[k] ? sub_hit : sub_miss);
            diag = t[k];
            in[k] = __viaddmin_s32(m[k], s_gapo, in[k] + s_gape);
            m[k] = mn;
            if (k == 1) run = min(m[0], mn);
            else if (k & 1) run = __vimin3_s32(run, m[k - 1], mn);
          }
          // the deletion cost entering each lane's first column: an
          // exclusive prefix-minimum over the lanes, the seed before lane 0
          int32_t incl = min(run + dconst - lane_ramp, seed);
#pragma unroll
          for (int d = 1; d < 32; d <<= 1)
            incl = min(incl, __shfl_up_sync(kFull, incl, d));
          int32_t carry = __shfl_up_sync(kFull, incl, 1);
          if (lane == 0) carry = seed;
          carry += lane_ramp;
          if (more) {          // what the next tile's first column needs in
                               // this row: t of the row before, del' of this
            const int32_t lt = __shfl_sync(kFull, t[CPL - 1], 31);
            const int32_t ld = __shfl_sync(kFull, incl, 31);
            if (lane == ii) {
              out_t = lt + (CPL - 1) * s_gape;
              out_d = ld + kTile * s_gape;
            }
          }
          // pass 2: t' = min(m', ins', del'), del' = carry (+ the ramp)
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            t[k] = __vimin3_s32(m[k], in[k], carry);
            carry = __viaddmin_s32(m[k], dconst, carry);
          }
          ins0 = min(m0 + s_gapo, ins0 + s_gape);
          m0 = kBig;
        }
        if (more && lane < nn) {
          edge_t[i0 + lane] = out_t;
          edge_d[i0 + lane] = out_d;
        }
      }

      // this lane's best valid column of the tile; columns rise with k
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int col = tile0 + lane * CPL + k + 1;
        const int32_t v = t[k] + k * s_gape;
        if (col <= W && v < bv) {
          bv = v;
          bc = col;
        }
      }
    }

    for (int d = 16; d > 0; d >>= 1)
      min_pair(bv, bc, __shfl_down_sync(kFull, bv, d),
               __shfl_down_sync(kFull, bc, d));
    if (lane == 0) {
      const int32_t end0 = min(ins0, m0);
      cost_out[r] = min(bv, end0);
      end_out[r] = end0 <= bv ? 0 : bc;
    }
  }
}

template <int CPL>
cudaError_t launch(const int32_t* reads, const int32_t* lens,
                   const int32_t* windows, const int32_t* wlens,
                   int32_t* cost, int32_t* end, int32_t* scratch, int R, int L,
                   int G, int n_tiles, int n_warps, int s_mm, int s_gapo,
                   int s_gape, cudaStream_t stream) {
  const int blocks = (n_warps + kWarps - 1) / kWarps;
  if (n_tiles > 1) {
    if constexpr (CPL >= kMinTiledCpl)
      glocal_screen_kernel<CPL, true><<<blocks, kThreads, 0, stream>>>(
          reads, lens, windows, wlens, cost, end, scratch, R, L, G, n_tiles,
          s_gapo, s_gape, -s_gape, s_mm - s_gape);
    else
      return cudaErrorInvalidValue;
  } else {
    glocal_screen_kernel<CPL, false><<<blocks, kThreads, 0, stream>>>(
        reads, lens, windows, wlens, cost, end, scratch, R, L, G, n_tiles,
        s_gapo, s_gape, -s_gape, s_mm - s_gape);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches n_warps warps (4 a block) on `stream`, warp w on jobs w, w +
// n_warps, ..., and returns the CUDA error of the launch (0 on success).
// All arrays are row-major int32 on the device: reads [R, L], lens [R],
// windows [R, G], wlens [R]; cost and end [R].  A job's window is cut into
// n_tiles column tiles of 32 * cpl columns (cpl even, 2..24, and 14..24
// with more than one tile; n_tiles * 32 * cpl >= G).  With more than one
// tile, scratch holds 2 * L int32 for each launched warp (n_warps rounded up
// to a multiple of 4); else it may be null.
extern "C" int hsa_glocal_screen(const void* reads, const void* lens,
                                 const void* windows, const void* wlens,
                                 void* cost, void* end, void* scratch, int R,
                                 int L, int G, int cpl, int n_tiles,
                                 int n_warps, int s_mm, int s_gapo, int s_gape,
                                 void* stream) {
  if (R < 1 || L < 0 || G < 0 || n_tiles < 1 || n_warps < 1 ||
      (long long)n_tiles * 32 * cpl < G || (n_tiles > 1 && !scratch))
    return (int)cudaErrorInvalidValue;
#define HSA_GLOCAL_CASE(C)                                                   \
  case C:                                                                    \
    return (int)launch<C>(                                                   \
        (const int32_t*)reads, (const int32_t*)lens, (const int32_t*)windows, \
        (const int32_t*)wlens, (int32_t*)cost, (int32_t*)end,                \
        (int32_t*)scratch, R, L, G, n_tiles, n_warps, s_mm, s_gapo, s_gape,  \
        (cudaStream_t)stream)
  switch (cpl) {
    HSA_GLOCAL_CASE(2);
    HSA_GLOCAL_CASE(4);
    HSA_GLOCAL_CASE(6);
    HSA_GLOCAL_CASE(8);
    HSA_GLOCAL_CASE(10);
    HSA_GLOCAL_CASE(12);
    HSA_GLOCAL_CASE(14);
    HSA_GLOCAL_CASE(16);
    HSA_GLOCAL_CASE(18);
    HSA_GLOCAL_CASE(20);
    HSA_GLOCAL_CASE(22);
    HSA_GLOCAL_CASE(24);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HSA_GLOCAL_CASE
}
