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
// Design: one thread per column, so a warp reads 32 neighbouring columns of
// one row and every load coalesces.  A first pass counts the valid keys and
// writes the drop row; then min(K, nvalid) rounds each scan the column for
// the smallest valid key strictly above the previous pick.  Keys are unique
// within a column, so no slot needs marking and nothing is kept per column
// beyond the previous pick.
//
// What bounds it: the column scans, (1 + min(K, nvalid)) * C loads per column.
// At the beam's frontier shape ([576, 32768] int32, K = 64) the key matrix
// is 75 MB, above the 50 MB L2, so a scan round streams it from device
// memory; the early stop at nvalid is what keeps sparse columns cheap.
// Staging a tile of columns in shared memory, or splitting a column's rows
// across a warp, would cut that traffic and is left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSent = 0x7FFF0000;
constexpr int kKeyShift = 14;
constexpr int kMaxPay = 3;
constexpr int kThreads = 64;

struct Payloads {
  const int32_t* in[kMaxPay];
  int32_t* out[kMaxPay];
};

__device__ __forceinline__ bool is_valid(int32_t k, bool has_win, int32_t win) {
  return k < kSent && !(has_win && (k >> kKeyShift) > win);
}

__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const int32_t* __restrict__ key, Payloads pay, int n_pay,
                   const int32_t* __restrict__ window,
                   const int32_t* __restrict__ accum,
                   int32_t* __restrict__ okey, int C, int B, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t ld = (size_t)B;
  const int32_t* col = key + b;
  const bool has_win = window != nullptr;
  const int32_t win = has_win ? window[b] : 0;

  int nvalid = 0;
  for (int c = 0; c < C; ++c) nvalid += is_valid(col[c * ld], has_win, win);
  const uint32_t acc = accum != nullptr ? (uint32_t)accum[b] : 0u;
  okey[K * ld + b] = (int32_t)(acc + (uint32_t)max(nvalid - K, 0));

  const int picks = min(K, nvalid);
  int32_t prev = -1;
  for (int s = 0; s < picks; ++s) {
    int32_t best = 0x7FFFFFFF;
    int arg = 0;
    for (int c = 0; c < C; ++c) {
      const int32_t k = col[c * ld];
      if (k > prev && k < best && is_valid(k, has_win, win)) {
        best = k;
        arg = c;
      }
    }
    okey[s * ld + b] = best;
    for (int p = 0; p < n_pay; ++p) pay.out[p][s * ld + b] = pay.in[p][arg * ld + b];
    prev = best;
  }
  for (int s = picks; s < K; ++s) {
    okey[s * ld + b] = kSent;
    for (int p = 0; p < n_pay; ++p) pay.out[p][s * ld + b] = 0;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `window` and `accum` may be null; unused payload pointers are ignored.
extern "C" int hsa_select_topk(const void* key, int n_pay,
                               const void* in0, const void* in1, const void* in2,
                               void* out0, void* out1, void* out2,
                               const void* window, const void* accum,
                               void* okey, int C, int B, int K, void* stream) {
  if (n_pay < 0 || n_pay > kMaxPay || C < 1 || B < 1 || K < 1 || K > C)
    return (int)cudaErrorInvalidValue;
  Payloads pay;
  pay.in[0] = (const int32_t*)in0;
  pay.in[1] = (const int32_t*)in1;
  pay.in[2] = (const int32_t*)in2;
  pay.out[0] = (int32_t*)out0;
  pay.out[1] = (int32_t*)out1;
  pay.out[2] = (int32_t*)out2;
  const int blocks = (B + kThreads - 1) / kThreads;
  select_topk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)key, pay, n_pay, (const int32_t*)window,
      (const int32_t*)accum, (int32_t*)okey, C, B, K);
  return (int)cudaGetLastError();
}
