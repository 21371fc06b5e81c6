// Dense grouped int64 sums for Hopper (sm_90a).
//
// Replaces the TPU kernel ballista_tpu/kernels/pallas_agg.py
// (dense_grouped_sums, body _kernel, limbs _limbs): per-group sums of K
// int64 value columns over live rows, plus the per-group count of live
// rows. A row counts only when it is live and 0 <= gid < G. It also finds
// the first live row of each group, which the JAX package computes with
// jax.ops.segment_min beside its Pallas call
// (ballista_tpu/kernels/aggregate.py, _dense_grouped_pallas).
//
// What differs from the TPU kernel. The TPU has no 64-bit vector
// arithmetic, so it splits every value into five 13-bit limbs and sums
// them with a one-hot [BLOCK, G]^T @ [BLOCK, 5K+1] f32 matmul per block.
// The H100 adds int64 natively, so this kernel adds the values
// themselves.
//
// What bounds it. Each row is read once: gids (4 B), live (1 B) and K
// values (8 B each), 61 B a row at K = 7; the [G, K+1] sums and the [G]
// first rows written are negligible. At TPC-H q1 SF1 (6,291,456 slots)
// that is 0.38 GB, or 0.11 ms at 3.35 TB/s. So the kernel is bound by
// bytes, as long as nothing else stalls it. Two things did in the first
// version, which added every row into one [G, K+1] table of shared
// words per block:
//
// - Atomic contention. q1 has 6 groups (4 live), so the 32 lanes of a
//   warp hit about 3 words per column and each warp-wide atomic was
//   replayed many times. Here shared memory holds R replicas of the
//   table, laid out [G, K+1, R] with the replica fastest, and thread t
//   adds into replica t mod R. R is a power of two up to 32, the largest
//   whose accumulators fit the shared memory the launch may use at the
//   occupancy it wants (the wrapper chooses it). At R = 32 no two lanes of
//   a warp ever share a word; R = 1 is the old layout. Each 64-bit add is
//   two native 32-bit shared atomics with a carry (add64 below), not the
//   compare-and-swap loop nvcc makes of a 64-bit one: at G = 256, where R
//   is 4 and 8 lanes share each word, that loop kept the kernel far from
//   its bound. The epilogue sums the R replicas of each cell
//   inside the block and issues one global atomicAdd per non-zero cell.
// - Few bytes in flight. Each thread now takes VEC = 4 consecutive rows a
//   step: gids as one int4, the live flags as one 32-bit word, each value
//   column as two longlong2, all issued before any row is tested. Dead and
//   out-of-range rows are then skipped at the atomics, not around the
//   loads. A ragged tail goes row by row. VEC is a template parameter: the
//   wrapper launches VEC = 1 of the same kernel when a pointer is not
//   aligned for the vector loads.
//
// The grid is persistent: the wrapper launches as many blocks as fit on
// the card at once (dense_grouped_sums_blocks_per_sm), each looping over
// rows with a grid stride, so the epilogue's global atomics stay near
// blocks x cells.
//
// The first live row of each group. Computing it apart (a scatter-min)
// reads gids and live a second time, and contends on G words through
// global atomics as the first version did on shared ones. Here every
// replica also keeps the least live row it saw, in a [G, R] table. A
// thread's rows arrive in increasing order, so a compare before the
// shared atomicMin skips almost every atomic; the epilogue takes the
// minimum over the replicas and issues one global atomicMin per group
// into `first`, which the caller fills with n (no live row).
//
// Exactness. Addition of unsigned 64-bit integers is addition mod 2^64,
// which is associative and commutative, and int64 two's complement has
// the same bits. So whatever order the atomics run in, however the
// replicas split them, and with every wrap of a low half carried once,
// every sum is bit-identical to the TPU kernel's limb recombination,
// wraparound included. The minimum is exact too.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 64;      // value columns one launch takes
constexpr int kColsPerPass = 8;   // value columns loaded together
constexpr int kMaxThreads = 256;  // threads a block may have
constexpr int kMaxReplicas = 32;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

struct ColumnPointers {
  const long long* p[kMaxCols];
};

__device__ __forceinline__ void load_values(const long long* col,
                                            long long row0,
                                            unsigned long long (&v)[4]) {
  const longlong2* p = reinterpret_cast<const longlong2*>(col + row0);
  const longlong2 a = __ldg(p);
  const longlong2 b = __ldg(p + 1);
  v[0] = (unsigned long long)a.x;
  v[1] = (unsigned long long)a.y;
  v[2] = (unsigned long long)b.x;
  v[3] = (unsigned long long)b.y;
}

__device__ __forceinline__ void load_values(const long long* col,
                                            long long row0,
                                            unsigned long long (&v)[1]) {
  v[0] = (unsigned long long)__ldg(col + row0);
}

// Adds v to a shared 64-bit word exactly, mod 2^64. Hopper has no native
// 64-bit add on shared memory: atomicAdd on unsigned long long compiles to
// a compare-and-swap loop (ATOMS.CAST.SPIN.64) that lanes on one word
// retry in turn. Two native 32-bit atomics do the same sum: the low half
// returns its old value, so the add that wraps it carries into the high
// half itself.
__device__ __forceinline__ void add64(unsigned long long* word,
                                      unsigned long long v) {
  unsigned int* w = reinterpret_cast<unsigned int*>(word);  // little-endian
  const unsigned int lo = (unsigned int)v;
  const unsigned int old = atomicAdd(w, lo);
  const unsigned int hi =
      (unsigned int)(v >> 32) + ((unsigned int)(old + lo) < old ? 1u : 0u);
  if (hi != 0u) atomicAdd(w + 1, hi);
}

// Adds rows [row0, row0 + V) into this thread's replica `rep` of the
// shared accumulators `acc` ([g, k+1, r]) and, when `low` is set, of the
// first-row table `low` ([g, r]).
template <int V>
__device__ __forceinline__ void add_rows(
    const int32_t* __restrict__ gids, const uint8_t* __restrict__ live,
    const ColumnPointers& cols, long long row0, int k, int g, int r, int rep,
    unsigned long long* acc, unsigned long long* low) {
  int gid[V];
  uint32_t alive;
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(gids + row0));
    gid[0] = q.x;
    gid[1] = q.y;
    gid[2] = q.z;
    gid[3] = q.w;
    alive = __ldg(reinterpret_cast<const unsigned int*>(live + row0));
  } else {
    gid[0] = __ldg(gids + row0);
    alive = __ldg(live + row0);
  }
  bool ok[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    ok[e] = ((alive >> (8 * e)) & 0xffu) != 0u && gid[e] >= 0 && gid[e] < g;
  }
  const int c = k + 1;
  for (int j0 = 0; j0 < k; j0 += kColsPerPass) {
    unsigned long long v[kColsPerPass][V];
#pragma unroll
    for (int jj = 0; jj < kColsPerPass; ++jj) {
      if (j0 + jj < k) load_values(cols.p[j0 + jj], row0, v[jj]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (!ok[e]) continue;
      unsigned long long* cell = acc + ((size_t)gid[e] * c + j0) * r + rep;
#pragma unroll
      for (int jj = 0; jj < kColsPerPass; ++jj) {
        if (j0 + jj < k) add64(cell + (size_t)jj * r, v[jj][e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (!ok[e]) continue;
    add64(acc + ((size_t)gid[e] * c + k) * r + rep, 1ULL);
    if (low != nullptr) {
      // a stale read only costs an atomic: the word never grows
      unsigned long long* f = low + (size_t)gid[e] * r + rep;
      const unsigned long long row = (unsigned long long)(row0 + e);
      if (row < *f) atomicMin(f, row);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads) dense_grouped_sums_kernel(
    const int32_t* __restrict__ gids, const uint8_t* __restrict__ live,
    ColumnPointers cols, long long n, int k, int g, int r,
    unsigned long long* __restrict__ out,
    unsigned long long* __restrict__ first) {
  extern __shared__ unsigned long long smem[];
  const int cells = g * (k + 1);
  unsigned long long* acc = smem;  // [g, k+1, r]
  unsigned long long* low = first != nullptr ? smem + (size_t)cells * r
                                             : nullptr;  // [g, r]
  const unsigned long long none = (unsigned long long)n;
  for (int i = threadIdx.x; i < cells * r; i += blockDim.x) acc[i] = 0ULL;
  if (low != nullptr) {
    for (int i = threadIdx.x; i < g * r; i += blockDim.x) low[i] = none;
  }
  __syncthreads();

  const int rep = threadIdx.x & (r - 1);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long steps = n / V;
  for (long long s = tid; s < steps; s += stride) {
    add_rows<V>(gids, live, cols, s * V, k, g, r, rep, acc, low);
  }
  if constexpr (V > 1) {  // the ragged tail, after every vector row
    for (long long row = steps * V + tid; row < n; row += stride) {
      add_rows<1>(gids, live, cols, row, k, g, r, rep, acc, low);
    }
  }
  __syncthreads();

  // Thread i reads the replicas of cell i starting at replica i mod r, so
  // neighbouring threads start on different banks.
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long* a = acc + (size_t)i * r;
    unsigned long long s = 0ULL;
    for (int t = 0; t < r; ++t) s += a[(t + i) & (r - 1)];
    if (s != 0ULL) atomicAdd(out + i, s);
  }
  if (low != nullptr) {
    for (int i = threadIdx.x; i < g; i += blockDim.x) {
      const unsigned long long* a = low + (size_t)i * r;
      unsigned long long m = none;
      for (int t = 0; t < r; ++t) m = min(m, a[(t + i) & (r - 1)]);
      if (m < none) atomicMin(first + i, m);
    }
  }
}

const void* kernel_for(int vec) {
  if (vec == 4) return reinterpret_cast<const void*>(dense_grouped_sums_kernel<4>);
  if (vec == 1) return reinterpret_cast<const void*>(dense_grouped_sums_kernel<1>);
  return nullptr;
}

cudaError_t allow_shared(const void* fn, size_t bytes) {
  if (bytes <= kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns a CUDA error code: 0 when
// the launch was accepted, else cudaErrorInvalidValue for bad arguments,
// the error of opting into more shared memory, or cudaGetLastError().
// `cols` is a HOST array of k device pointers, each to n contiguous int64
// values; `out` is a zeroed device [g, k+1] int64 array; `first` is a
// device [g] int64 array filled with n, or null to skip the first rows.
// `replicas` is a power of two up to 32; `vec` is 4 (gids, cols 16-byte
// and live 4-byte aligned) or 1. The accumulators, g * (k+1) * replicas
// words plus g * replicas with `first`, must fit
// dense_grouped_sums_max_shared_bytes().
int dense_grouped_sums_launch(const void* gids, const void* live,
                              const void* const* cols, long long n, int k,
                              int g, int replicas, int vec, void* out,
                              void* first, int blocks, int threads,
                              void* stream) {
  const void* fn = kernel_for(vec);
  if (fn == nullptr || k < 0 || k > kMaxCols || g <= 0 || n < 0 ||
      blocks <= 0 || threads <= 0 || threads > kMaxThreads ||
      replicas <= 0 || replicas > kMaxReplicas ||
      (replicas & (replicas - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  ColumnPointers ptrs;
  for (int j = 0; j < kMaxCols; ++j) {
    ptrs.p[j] = j < k ? static_cast<const long long*>(cols[j]) : nullptr;
    if (vec == 4 && j < k && !aligned(cols[j], 16)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (vec == 4 && (!aligned(gids, 16) || !aligned(live, 4))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t words = (size_t)g * (size_t)(k + 1 + (first != nullptr ? 1 : 0));
  const size_t shared_bytes = words * (size_t)replicas * sizeof(unsigned long long);
  const cudaError_t err = allow_shared(fn, shared_bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g32 = static_cast<const int32_t*>(gids);
  const auto* l8 = static_cast<const uint8_t*>(live);
  auto* o = static_cast<unsigned long long*>(out);
  auto* f = static_cast<unsigned long long*>(first);
  if (vec == 4) {
    dense_grouped_sums_kernel<4><<<blocks, threads, shared_bytes, s>>>(
        g32, l8, ptrs, n, k, g, replicas, o, f);
  } else {
    dense_grouped_sums_kernel<1><<<blocks, threads, shared_bytes, s>>>(
        g32, l8, ptrs, n, k, g, replicas, o, f);
  }
  return (int)cudaGetLastError();
}

// Blocks of `threads` threads and `shared_bytes` of dynamic shared memory
// that fit on one SM of the current device at once, for the VEC = `vec`
// instantiation; a negative CUDA error code on failure.
int dense_grouped_sums_blocks_per_sm(int vec, int threads,
                                     long long shared_bytes) {
  const void* fn = kernel_for(vec);
  if (fn == nullptr || threads <= 0 || threads > kMaxThreads ||
      shared_bytes < 0) {
    return -(int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_shared(fn, (size_t)shared_bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      (size_t)shared_bytes);
  if (err != cudaSuccess) return -(int)err;
  return blocks;
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

const char* dense_grouped_sums_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
