// One FM backward step over the fused rank-indexed occ rows: for each lane
// and each end p of its interval [k, l] (p = k and p = l + 1),
//   occ(a, p) = row[a] + (matches of base a among the row's 2-bit symbols
//               below p & 31) - (the primary's dummy slot, for a = 0),
// read from the 32-byte row p >> 5 (words 0-3: the counts before the block,
// words 4-5: its 32 symbols), and then k' = C[a] + occ(a, k), l' = C[a] +
// occ(a, l + 1) - 1, for one base a a lane (`extend`) or all four
// (`extend4_flat`).
//
// Replaces hsa_tpu/search/fm.py:182-230 (occ_lt4_flat, occ_lt, extend,
// extend4_flat over _gather_rows, _word_masks, _count_base, _primary_corr):
// device work that hsa_tpu leaves to XLA inside its jitted searches, and
// that the port's plain torch ran as about 110 launches a call
// (search/fm.py: extend_plain, extend4_flat_plain).
//
// What bounds it: bytes.  A lane reads its inputs and two rows of 32 bytes
// at random (one sector each), and writes 2 or 8 results; a few dozen
// integer operations a lane.  At the main path's sizes (B = 16K-4M lanes)
// the rows are the traffic, and below some 100,000 lanes the launch is.
//
// Design: one thread a lane computes both ends, so the whole step is one
// launch: the row of each end comes in as two 16-byte loads issued before
// any use, the counts are two popcounts a base, and the results go out
// coalesced (row-major [2, B] or [8, B]).  The lanes' inputs are the int64
// tensors of the torch code read as their low 32-bit words (values in
// [0, 2^32): the port's bit patterns), at any stride, so the wrapper copies
// nothing; p = l + 1 is formed in 64 bits, as the torch code forms it.
// Every row index is clamped to the table as fm._gather_rows clamps it, so
// dead lanes with arbitrary ranks read a real row and do not fault.
// Sharded (a rank's own row range of the global table): the global row is
// clamped to the global table, less the shard's first row; a lane whose row
// the shard does not hold writes 0, and the wrapper's one all_reduce merges
// the owner's count (int32 bit patterns, C not added: fm.py adds it after
// the merge).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kPat = 0x55555555u;
constexpr int kThreads = 256;

struct Step {
  const int4* rows;         // [nrows, 8] 32-bit words, 32 bytes a row
  long long nrows;
  const long long* C;       // C[0..3]
  const unsigned* a;        // low words of the int64 lanes, or null (four)
  const unsigned* k;
  const unsigned* l;
  long long sa, sk, sl;     // strides in 32-bit words
  long long B;
  long long p_blk, p_off;   // the primary's block and slot
  long long offset, grows;  // sharded: the shard's first row, global rows
  int sharded;
};

// PAT-patterned pairs below v symbols (v in [0, 16]) of one symbol word
__device__ __forceinline__ unsigned pair_mask(int v) {
  return v > 0 ? (kPat >> (2 * (16 - v))) : 0u;
}

struct End {
  int4 lo, hi;              // words 0-3 and 4-7 of the row
  unsigned m0, m1;          // symbol masks of words 4 and 5
  int corr;                 // the primary's slot lies below p in this block
  int own;
};

__device__ __forceinline__ End load_end(const Step& s, unsigned long long p) {
  End e;
  const long long b = (long long)(p >> 5);
  const int off = (int)(p & 31);
  long long r;
  if (s.sharded) {
    const long long local = min(b, s.grows - 1) - s.offset;
    e.own = local >= 0 && local < s.nrows;
    r = min(max(local, 0LL), s.nrows - 1);
  } else {
    e.own = 1;
    r = min(b, s.nrows - 1);
  }
  e.lo = __ldg(s.rows + 2 * r);
  e.hi = __ldg(s.rows + 2 * r + 1);
  const int v0 = min(off, 16);
  e.m0 = pair_mask(v0);
  e.m1 = pair_mask(off - v0);
  e.corr = (b == s.p_blk) && (off > s.p_off);
  return e;
}

__device__ __forceinline__ long long occ(const End& e, int a) {
  const unsigned pat = (unsigned)a * kPat;
  const unsigned n4 = ~((unsigned)e.hi.x ^ pat);
  const unsigned n5 = ~((unsigned)e.hi.y ^ pat);
  const int in_block = __popc(n4 & (n4 >> 1) & e.m0)
                       + __popc(n5 & (n5 >> 1) & e.m1);
  const unsigned cnt = a == 0 ? (unsigned)e.lo.x : a == 1 ? (unsigned)e.lo.y
                       : a == 2 ? (unsigned)e.lo.z : (unsigned)e.lo.w;
  return (long long)cnt + in_block - (a == 0 ? e.corr : 0);
}

template <bool kFour>
__global__ void __launch_bounds__(kThreads)
fm_extend_kernel(Step s, void* out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= s.B) return;
  const unsigned long long pk = s.k[i * s.sk];
  const unsigned long long pl = (unsigned long long)s.l[i * s.sl] + 1;
  const End ek = load_end(s, pk);
  const End el = load_end(s, pl);
  if (s.sharded) {
    int32_t* o = static_cast<int32_t*>(out);
    if (kFour) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        o[a * s.B + i] = ek.own ? (int32_t)(uint32_t)occ(ek, a) : 0;
        o[(4 + a) * s.B + i] = el.own ? (int32_t)(uint32_t)occ(el, a) : 0;
      }
    } else {
      const int a = min(max((int)s.a[i * s.sa], 0), 3);
      o[i] = ek.own ? (int32_t)(uint32_t)occ(ek, a) : 0;
      o[s.B + i] = el.own ? (int32_t)(uint32_t)occ(el, a) : 0;
    }
    return;
  }
  long long* o = static_cast<long long*>(out);
  if (kFour) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const long long Ca = s.C[a];
      o[a * s.B + i] = Ca + occ(ek, a);
      o[(4 + a) * s.B + i] = Ca + occ(el, a) - 1;
    }
  } else {
    const int a = min(max((int)s.a[i * s.sa], 0), 3);
    const long long Ca = s.C[a];
    o[i] = Ca + occ(ek, a);
    o[s.B + i] = Ca + occ(el, a) - 1;
  }
}

}  // namespace

// rows: int32 [nrows, 8], 16-byte aligned; C: int64 [>= 4]; a, k, l: the
// int64 lanes (a null for all four bases), with their strides in int64
// elements; out: int64 [2 or 8, B] unsharded, int32 [2 or 8, B] sharded.
// Returns the CUDA error of the launch (0 when it was taken).
extern "C" int hsa_fm_extend(const void* rows, long long nrows, const void* C,
                             const void* a, long long sa, const void* k,
                             long long sk, const void* l, long long sl,
                             long long B, long long primary, long long offset,
                             long long grows, int sharded, void* out,
                             cudaStream_t stream) {
  if (B <= 0 || nrows <= 0 || (reinterpret_cast<uintptr_t>(rows) & 15))
    return (int)cudaErrorInvalidValue;
  Step s;
  s.rows = static_cast<const int4*>(rows);
  s.nrows = nrows;
  s.C = static_cast<const long long*>(C);
  s.a = static_cast<const unsigned*>(a);
  s.k = static_cast<const unsigned*>(k);
  s.l = static_cast<const unsigned*>(l);
  s.sa = 2 * sa;
  s.sk = 2 * sk;
  s.sl = 2 * sl;
  s.B = B;
  s.p_blk = primary >> 5;
  s.p_off = primary & 31;
  s.offset = offset;
  s.grows = grows;
  s.sharded = sharded;
  const long long grid = (B + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (a == nullptr)
    fm_extend_kernel<true><<<(unsigned)grid, kThreads, 0, stream>>>(s, out);
  else
    fm_extend_kernel<false><<<(unsigned)grid, kThreads, 0, stream>>>(s, out);
  return (int)cudaGetLastError();
}
