// Row gather from a table staged on chip: out[i] = tab[clamp(q[i], 0, nb-1)]
// for rows of 8 32-bit words (32 bytes), with the whole table first copied
// into the shared memories of a group of blocks.
//
// Replaces the TPU probes' gathers from a table held in VMEM, the TPU core's
// on-chip memory of many megabytes:
//   tools/gather_probe.py:206 test_vmemtake (pallas_call :217), 1 MB table
//   tools/gather_probe2.py:150 test_rowloop (:174), a serial row loop, 1 MB
//   tools/gather_probe2.py:226 test_vmemsize (:237), tab[0:8] from tables of
//     2 to 96 MB: the capacity bisect
//   tools/sync_probe.py:195 test_vmemtake (:210), 1 MB and 4 MB
//
// What bounds it: on-chip capacity first.  A block has at most 232,448 bytes
// of shared memory (7,264 rows), and the probes' tables are 1 MB and more.
// So the table is cut into `cs` slices (1 to 16), one a block.  What the chip
// can hold at once is what its largest co-scheduled cluster of blocks holds:
// sixteen blocks need the non-portable cluster size (about 3.6 MB), if the
// card can co-schedule them, which cudaOccupancyMaxActiveClusters says.  A
// larger table does not fit on chip: the host wrapper asks
// hsa_table_take_capacity and refuses it before any launch.
// Beyond capacity the bytes bound it: NQ indices, NQ rows written, and a
// 32-byte sector per distinct row read.  Each group of `cs` blocks stages
// the whole table (from L2 after the first), and each block of a group reads
// the group's indices: groups x table bytes and (cs - 1) x 4 x NQ bytes
// beyond the bound, from L2.
//
// Design (the launch plan, kernels/gather.py:take_plan, picks the slices,
// their rows and the number of groups; checked here).  Block b holds slice
// b % cs for group b / cs:
//   1. One thread of each block arms an mbarrier with its slice's bytes and
//      issues bulk copies (cp.async.bulk, the copy engine) of the slice into
//      its shared memory: no registers, no round trips.  The mbarrier sits in
//      the slice's last row, so a block still holds 7,264 rows: that row is
//      loaded by hand once the barrier has completed and been invalidated.
//   2. Meanwhile every thread loads the indices of its first queries.
//   3. The threads wait on the mbarrier: the block's slice is in place.
//   4. Take.  Each group takes a contiguous share of the queries.  Every
//      block of the group scans the whole share (kUnroll indices a thread
//      at once, coalesced, the next kUnroll loaded ahead) and moves the
//      whole 32-byte rows of the queries whose rows its own slice holds,
//      from its shared memory to the output (st.global.cs, evict-first; one
//      full sector a row).
// No thread reads another block's shared memory: on an H100 80GB HBM3 (700
// W), reads through a cluster's distributed shared memory (each thread four
// rows at once, each from its owner block) took some 6-9 us a round of four
// rows a thread, while an index that each block of a group scans again is a
// read from L2.  So the blocks of a group need not run together, and the
// grid is a plain one: launched as clusters of `cs` blocks, the same kernel
// was as fast or slower (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;             // bytes a block may use
constexpr int kRowBytes = 32;
constexpr int kMaxRows = kMaxSmem / kRowBytes;  // 7,264 rows a block
constexpr int kMaxCluster = 16;
constexpr int kUnroll = 8;                   // queries a thread has in flight
constexpr int kPiece = 32768;                // bytes of one bulk copy

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
table_take_kernel(const int4* __restrict__ tab, int nb, int rows, int cs,
                  const int32_t* __restrict__ q, int nq,
                  int4* __restrict__ out) {
  extern __shared__ __align__(16) int4 slice[];  // rows rows of two int4
  // block b holds slice b % cs of the table for group b / cs of the queries
  const int r0 = (int)(blockIdx.x % (unsigned)cs) * rows;
  const int nr = max(0, min(nb - r0, rows));
  const bool full = nr == rows;      // the barrier's row is a table row
  const int bulk = min(nr, rows - 1);  // rows the copy engine stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(slice + 2 * (rows - 1));
  if (threadIdx.x == 0) bar_init(bar);
  __syncthreads();
  int4 lastrow[2];
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)bulk * kRowBytes;
    bar_expect(bar, bytes);
    const char* src = reinterpret_cast<const char*>(tab + 2LL * r0);
    char* dst = reinterpret_cast<char*>(slice);
    for (uint32_t off = 0; off < bytes; off += kPiece)
      bulk_copy(dst + off, src + off, min((uint32_t)kPiece, bytes - off), bar);
    if (full) {
      lastrow[0] = __ldg(tab + 2LL * (r0 + rows - 1));
      lastrow[1] = __ldg(tab + 2LL * (r0 + rows - 1) + 1);
    }
  }
  // the group's share of the queries, [lo, hi); every block of the group
  // scans all of it and takes the queries whose rows its slice holds
  const unsigned groups = gridDim.x / cs;  // 32-bit divisions (nq < 2^31)
  const unsigned per = ((unsigned)nq + groups - 1) / groups;
  const long long lo = (long long)(blockIdx.x / (unsigned)cs) * per;
  const long long hi = min((long long)nq, lo + per);
  constexpr int kStep = kUnroll * kThreads;
  int32_t idx[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {  // while the slice arrives
    const long long i = lo + threadIdx.x + u * kThreads;
    idx[u] = 0;
    if (i < hi) idx[u] = __ldg(q + i);
  }
  bar_wait(bar);
  __syncthreads();  // every thread is past the wait: the barrier may go
  if (threadIdx.x == 0) {
    bar_inval(bar);
    if (full) {
      slice[2 * (rows - 1)] = lastrow[0];
      slice[2 * (rows - 1) + 1] = lastrow[1];
    }
  }
  __syncthreads();
  for (long long base = lo + threadIdx.x; base < hi; base += kStep) {
    int32_t nxt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + kStep + u * kThreads;
      nxt[u] = 0;
      if (i < hi) nxt[u] = __ldg(q + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      const int local = min(max(idx[u], 0), nb - 1) - r0;
      if (i < hi && (unsigned)local < (unsigned)nr) {
        const int4 a = slice[2 * local];
        const int4 b = slice[2 * local + 1];
        __stcs(out + 2 * i, a);
        __stcs(out + 2 * i + 1, b);
      }
      idx[u] = nxt[u];
    }
  }
}

cudaError_t raise_attributes() {
  // raised once; a second thread that races here only repeats the calls
  static bool raised = false;
  if (raised) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      table_take_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(table_take_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  raised = true;
  return cudaSuccess;
}

// how many clusters of `cs` blocks with `smem` bytes each the card can hold
// at once (0: such a cluster cannot be scheduled at all)
cudaError_t active_clusters(int cs, int smem, int* n) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  *n = 0;
  return cudaOccupancyMaxActiveClusters(n, table_take_kernel, &cfg);
}

}  // namespace

// The most rows of 32 bytes that one cluster of this card can stage: the
// largest cluster size (1..16, powers of two) that the card can schedule
// with a full 232,448 bytes of shared memory a block, times 7,264 rows.
// Returns the CUDA error (0 on success).
extern "C" int hsa_table_take_capacity(int* max_rows) {
  *max_rows = 0;
  cudaError_t err = raise_attributes();
  if (err != cudaSuccess) return (int)err;
  for (int cs = kMaxCluster; cs >= 1; cs /= 2) {
    int n = 0;
    err = active_clusters(cs, kMaxSmem, &n);
    if (err != cudaSuccess) {
      cudaGetLastError();  // a refused size is an answer, not a fault
      continue;
    }
    if (n >= 1) {
      *max_rows = cs * kMaxRows;
      return 0;
    }
  }
  return 0;
}

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).  `tab` is [nb, 8] int32, 16-byte aligned; `q` [nq] int32; `out`
// [nq, 8] int32.  The plan (kernels/gather.py:take_plan) is checked: cs = 1,
// 2, 4, 8 or 16 slices of `rows` rows that cover the table (rows <= 7,264,
// rows = ceil(nb / cs)) and 1 <= groups.
extern "C" int hsa_table_take(const void* tab, int nb, const void* q, int nq,
                              int cs, int rows, int groups, void* out,
                              void* stream) {
  if (nb < 1 || nq < 1 || cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) ||
      rows < 1 || rows > kMaxRows || rows != (nb + cs - 1) / cs ||
      groups < 1 || (long long)groups * cs > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = raise_attributes();
  if (err != cudaSuccess) return (int)err;
  table_take_kernel<<<groups * cs, kThreads, rows * kRowBytes,
                      (cudaStream_t)stream>>>(
      (const int4*)tab, nb, rows, cs, (const int32_t*)q, nq, (int4*)out);
  return (int)cudaGetLastError();
}
