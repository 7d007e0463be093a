// One-hot gather on the tensor cores: out[i, w] = uint32(float32(tab[r, w]))
// with r = clamp(q[i], 0, R - 1), for a table of R rows of 8 32-bit words.
//
// Replaces tools/gather_probe2.py:189 test_onehot (pallas_call :210), whose
// body builds the one-hot [Q, R] float32 matrix of q and multiplies it by the
// table converted to float32 on the MXU, then converts back to uint32.  The
// product picks one table value per output, so the result is that value
// rounded to float32 (values of 2^24 and more lose low bits) and back.
//
// What bounds it: at the probe's shapes (Q = 16,384 queries, R = 512 and
// 2,048) neither resource does much work.  Bytes: 4Q of indices, 32Q of
// output, 32R of table, under 1 MB.  Tensor-core work: the one-hot product
// done exactly in int8 is 2 x Q x R x 32 operations (a [Q, R] by [R, 32]
// product over four byte planes of the 8 words), 0.54 and 2.15 GOP, 0.3 and
// 1.1 us at 1,979 TOP/s.  So launch latency and the staging of the table
// into every block's shared memory bound it at these shapes.
//
// Design: mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32, exact.
//   - B (32 table rows x 8 words) is one byte plane of the table.  Each block
//     stages the table once into shared memory as four planes of [8][R + 16]
//     bytes (byte p of each word, a word's rows contiguous, so a B fragment
//     register is one 32-bit load of four rows; the 16-byte pad puts the 8
//     words of a fragment on distinct banks): 33 KB at R = 512, 66 KB at
//     R = 2,048.  Rows are padded to a multiple of 32 with zeros.
//   - A (16 queries x 32 table rows) is the one-hot block, built in registers
//     from q and never stored: a thread's four registers hold rows g and
//     g + 8 at columns 4t..4t+3 and 16+4t..16+4t+3, so a register is
//     1 << 8d when its query's row is column 4t + d (+ 16) of this k-tile,
//     else 0.
//   - C/D are s32.  Each output byte is exact (one 1 times a byte, plus
//     zeros), so the word is joined from its four byte planes exactly and
//     then rounded through float32 as the probe's body does
//     (__uint2float_rn, then __float2uint_rn, which saturates at 2^32 - 1).
// A warp takes 16 queries at a time, walks the R / 32 k-tiles and issues
// four MMAs a tile, one per byte plane.  wgmma is a later design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 16;                 // bytes after each plane row
constexpr int kMaxSmem = 232448;
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four one-hot bytes: byte d is 1 when 0 <= d < 4
__device__ __forceinline__ uint32_t onehot4(int d) {
  return (unsigned)d < 4u ? 1u << (8 * d) : 0u;
}

__global__ void __launch_bounds__(kThreads)
onehot_gather_kernel(const uint32_t* __restrict__ tab, int R, int Rp,
                     const int32_t* __restrict__ q, int Q,
                     uint32_t* __restrict__ out) {
  extern __shared__ uint32_t planes[];  // [4][8][ldw] words
  const int ldw = (Rp + kPad) / 4;
  // stage: job (w, r4) packs rows 4 r4 .. 4 r4 + 3 of word w, byte plane p
  // of each into one 32-bit word of plane p (row 4 r4 in the lowest byte)
  for (int j = threadIdx.x; j < 8 * (Rp / 4); j += blockDim.x) {
    const int w = j & 7, r4 = j >> 3;
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * r4 + i;
      x[i] = r < R ? __ldg(tab + (size_t)r * 8 + w) : 0u;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t v = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) v |= ((x[i] >> (8 * p)) & 0xFFu) << (8 * i);
      planes[(p * 8 + w) * ldw + r4] = v;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (long long tile = (long long)blockIdx.x * kWarps + warp; tile * 16 < Q;
       tile += (long long)gridDim.x * kWarps) {
    const long long i0 = tile * 16 + g, i1 = i0 + 8;
    // a row no k-tile holds for the padding queries of the last tile
    const int qa = i0 < Q ? min(max(__ldg(q + i0), 0), R - 1) : -64;
    const int qb = i1 < Q ? min(max(__ldg(q + i1), 0), R - 1) : -64;
    int acc[4][4] = {};
    for (int k0 = 0; k0 < Rp; k0 += 32) {
      uint32_t a[4];
      a[0] = onehot4(qa - k0 - 4 * t);
      a[1] = onehot4(qb - k0 - 4 * t);
      a[2] = onehot4(qa - k0 - 16 - 4 * t);
      a[3] = onehot4(qb - k0 - 16 - 4 * t);
      const uint32_t* col = planes + g * ldw + k0 / 4 + t;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        mma_u8(acc[p], a, col[p * 8 * ldw], col[p * 8 * ldw + 4]);
    }
    // acc[p][0..1]: query i0, words 2t and 2t + 1; acc[p][2..3]: query i1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = i < 2 ? i0 : i1;
      if (row >= Q) continue;
      const uint32_t word = (uint32_t)acc[0][i] | (uint32_t)acc[1][i] << 8 |
                            (uint32_t)acc[2][i] << 16 |
                            (uint32_t)acc[3][i] << 24;
      out[row * 8 + 2 * t + (i & 1)] =
          __float2uint_rn(__uint2float_rn(word));
    }
  }
}

// the most table rows whose four padded byte planes fit in kMaxSmem
constexpr int kMaxRows = (kMaxSmem / 32 - kPad) / 32 * 32;

}  // namespace

// The largest R that hsa_onehot_gather takes (7,232).
extern "C" int hsa_onehot_gather_max_rows() { return kMaxRows; }

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).  `tab` is [R, 8] int32 (32-bit patterns), 16-byte aligned; `q`
// [Q] int32; `out` [Q, 8] int32.  Returns cudaErrorInvalidValue when the
// staged planes do not fit in a block's shared memory (R above kMaxRows).
extern "C" int hsa_onehot_gather(const void* tab, int R, const void* q, int Q,
                                 void* out, void* stream) {
  if (R < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  if (R > kMaxRows) return (int)cudaErrorInvalidValue;
  const int Rp = (R + 31) / 32 * 32;
  const int smem = 4 * 8 * (Rp + kPad);
  // raised once; a second thread that races here only repeats the call
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        onehot_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const long long tiles = ((long long)Q + 15) / 16;
  long long blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  onehot_gather_kernel<<<(unsigned)blocks, kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)tab, R, Rp, (const int32_t*)q, Q, (uint32_t*)out);
  return (int)cudaGetLastError();
}
