// Row gather from a table staged on chip: out[i] = tab[clamp(q[i], 0, nb-1)]
// for rows of 8 32-bit words (32 bytes), with the whole table first copied
// into the shared memory of one thread-block cluster.
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
// So the table is spread over a cluster of blocks on neighbouring SMs, each
// holding one slice, and every thread reads any slice through distributed
// shared memory.  Eight blocks are a portable cluster (about 1.8 MB of
// table); sixteen need the non-portable cluster size (about 3.6 MB) and the
// card must be able to co-schedule them, which cudaOccupancyMaxActiveClusters
// says before the launch.  A larger table does not fit on chip at all: the
// host wrapper asks hsa_table_take_capacity and refuses it before any launch.
// Beyond capacity the bytes bound it: NQ indices, NQ rows written, and a
// 32-byte sector per distinct row read (the staging reads the whole table once
// per cluster, from L2 after the first).
//
// Design: the smallest power-of-two cluster whose slices fit (ceil(nb / cs)
// rows a block, one block an SM at full shared memory).
//   1. Each block of the cluster copies its slice of the table into its
//      dynamic shared memory with int4 loads.
//   2. cluster.sync(): every slice is in place.
//   3. Each thread takes 16-byte halves of output rows, strided over the grid:
//      the owner block of row r is r / slice, and the half is read from its
//      shared memory through cluster.map_shared_rank and stored.
//   4. cluster.sync() again, so that no block leaves while another may still
//      read its slice.
// The grid is a few clusters (enough that every thread has a few rows to
// move, at most as many as the card co-schedules); each stages the table.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;             // bytes a block may use
constexpr int kRowBytes = 32;
constexpr int kMaxRows = kMaxSmem / kRowBytes;  // 7,264 rows a block
constexpr int kMaxCluster = 16;
constexpr int kPerThread = 8;                // int4 halves a thread moves

__global__ void __launch_bounds__(kThreads, 1)
table_take_kernel(const int4* __restrict__ tab, int nb, int rows_per_block,
                  const int32_t* __restrict__ q, int nq,
                  int4* __restrict__ out) {
  extern __shared__ int4 slice[];  // rows_per_block rows of two int4
  cg::cluster_group cluster = cg::this_cluster();
  const int r0 = (int)cluster.block_rank() * rows_per_block;
  const int nr = max(0, min(nb - r0, rows_per_block));
  for (int i = threadIdx.x; i < 2 * nr; i += blockDim.x)
    slice[i] = __ldg(tab + 2LL * r0 + i);
  cluster.sync();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < 2LL * nq; j += stride) {
    const int r = min(max(__ldg(q + (j >> 1)), 0), nb - 1);
    const int owner = r / rows_per_block;
    const int4* src = cluster.map_shared_rank(slice, owner);
    out[j] = src[2 * (r - owner * rows_per_block) + (int)(j & 1)];
  }
  cluster.sync();
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
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
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
// [nq, 8] int32.  Returns cudaErrorInvalidValue when the table does not fit
// in any cluster the card can schedule (the wrapper refuses it before).
extern "C" int hsa_table_take(const void* tab, int nb, const void* q, int nq,
                              void* out, void* stream) {
  if (nb < 1 || nq < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_attributes();
  if (err != cudaSuccess) return (int)err;
  for (int cs = 1; cs <= kMaxCluster; cs *= 2) {
    const int rows = (nb + cs - 1) / cs;
    if (rows > kMaxRows) continue;
    const int smem = rows * kRowBytes;
    int n = 0;
    err = active_clusters(cs, smem, &n);
    if (err != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if (n < 1) continue;
    const long long want =
        (2LL * nq + (long long)cs * kThreads * kPerThread - 1) /
        ((long long)cs * kThreads * kPerThread);
    const int ncl = (int)(want < n ? (want < 1 ? 1 : want) : n);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(ncl * cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, table_take_kernel, (const int4*)tab, nb,
                             rows, (const int32_t*)q, nq, (int4*)out);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
