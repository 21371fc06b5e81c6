// Dense grouped int64 sums for Hopper (sm_90a).
//
// Replaces the TPU kernel ballista_tpu/kernels/pallas_agg.py
// (dense_grouped_sums, body _kernel, limbs _limbs): per-group sums of K
// int64 value columns over live rows, plus the per-group count of live
// rows. A row counts only when it is live and 0 <= gid < G.
//
// What differs from the TPU kernel. The TPU has no 64-bit vector
// arithmetic, so it splits every value into five 13-bit limbs and sums
// them with a one-hot [BLOCK, G]^T @ [BLOCK, 5K+1] f32 matmul per block.
// The H100 has native int64 arithmetic and 64-bit atomics, so this kernel
// adds the values themselves: a grid-stride loop over rows, per-block
// [G, K+1] accumulators in shared memory (atomicAdd on unsigned long long),
// then one global atomicAdd per non-zero cell into the [G, K+1] output,
// which the caller zeroes. One launch takes at most kMaxCols value
// columns; at G = 256 that is 256 * 65 * 8 = 133,120 B of shared memory,
// above the 48 KB a block gets by default and under the 227 KB it may opt
// into on the H100, so the launch opts in when it needs to. The caller
// splits wider inputs, and inputs whose accumulators would not fit, into
// launches over fewer columns.
//
// Exactness. Addition of unsigned 64-bit integers is addition mod 2^64,
// which is associative and commutative, and int64 two's complement has
// the same bits. So whatever order the atomics run in, every sum is
// bit-identical to the TPU kernel's limb recombination, wraparound
// included.
//
// Bound. Each row is read once: gids (4 B), live (1 B) and K values
// (8 B each), 61 B a row at K = 7; the output is negligible. At TPC-H q1
// SF1 (6 scan batches of 2^20 rows, 6,291,456 slots) that is 0.38 GB, or
// 0.11 ms at 3.35 TB/s. The kernel is far from that bound at small G: all
// threads of a block add into the same G * (K+1) shared words (6 groups
// in q1), so the shared-memory atomics serialize. Warp-level
// pre-reduction or per-warp private accumulators would fix that; this
// version stays simple and right.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 64;  // value columns one launch takes
constexpr size_t kDefaultSharedBytes = 48 * 1024;

struct ColumnPointers {
  const long long* p[kMaxCols];
};

__global__ void dense_grouped_sums_kernel(const int32_t* __restrict__ gids,
                                          const uint8_t* __restrict__ live,
                                          ColumnPointers cols, long long n,
                                          int k, int g,
                                          unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long acc[];
  const int c = k + 1;
  const int cells = g * c;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0ULL;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const int gid = gids[row];
    if (!live[row] || gid < 0 || gid >= g) continue;
    unsigned long long* cell = acc + gid * c;
    for (int j = 0; j < k; ++j) {
      atomicAdd(cell + j, (unsigned long long)cols.p[j][row]);
    }
    atomicAdd(cell + k, 1ULL);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long v = acc[i];
    if (v != 0ULL) atomicAdd(out + i, v);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns a CUDA error code: 0 when
// the launch was accepted, else cudaErrorInvalidValue for bad arguments,
// the error of opting into more shared memory, or cudaGetLastError().
// `cols` is a HOST array of k device pointers, each to n contiguous int64
// values; `out` is a zeroed device [g, k+1] int64 array. The
// [g, k+1] accumulators must fit dense_grouped_sums_max_shared_bytes().
int dense_grouped_sums_launch(const void* gids, const void* live,
                              const void* const* cols, long long n, int k,
                              int g, void* out, int blocks, int threads,
                              void* stream) {
  if (k < 0 || k > kMaxCols || g <= 0 || n < 0 || blocks <= 0 ||
      threads <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  ColumnPointers ptrs;
  for (int j = 0; j < kMaxCols; ++j) {
    ptrs.p[j] = j < k ? static_cast<const long long*>(cols[j]) : nullptr;
  }
  const size_t shared_bytes = (size_t)g * (size_t)(k + 1) * sizeof(unsigned long long);
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_grouped_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dense_grouped_sums_kernel<<<blocks, threads, shared_bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gids), static_cast<const uint8_t*>(live),
      ptrs, n, k, g, static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

int dense_grouped_sums_max_cols(void) { return kMaxCols; }

// The shared memory one block of `device` may opt into, in bytes (0 when
// the device cannot be queried).
int dense_grouped_sums_max_shared_bytes(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

}  // extern "C"
