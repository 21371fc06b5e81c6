// Delimited-text parse for Hopper (sm_90a): the row split, the typed
// fields, and the per-row steps of dictionary-encoding utf8 columns.
//
// Replaces no TPU kernel. The JAX package parses .tbl and CSV text on the
// host (ballista_tpu/native/tblscan.cpp), and so did the port
// (ballista_tpu_torch/native/tblscan.cpp, which stays the CPU device's
// path). On a CUDA device a scan now reads the file's bytes into pinned
// chunks, copies them to one device buffer, and parses them here
// (kernels/tbl_parse.py drives these kernels and holds their plain torch
// twin).
//
// Semantics: bit for bit those of tblscan.cpp's parse_span and
// parse_field. A row starts at a byte that is not '\n' and follows a
// '\n' (or is the first byte of the body, after the CSV header); it ends
// at the next '\n' or at the end of the file, so empty lines are skipped
// and the last row may lack its newline. Fields split on the delimiter up
// to the row's end; a row with fewer fields gives empty fields, and what
// lies after the schema's last field (TPC-H's trailing '|') is ignored.
// An empty field is NULL for every kind but utf8, whose empty value is "".
//
// What bounds it: the file's bytes. Each is read once by the split's two
// passes (four 16-byte loads a thread of 64 aligned bytes) and once by the
// field walk; lineitem at SF1 (744 MB) reads in 0.22 ms at 3.35 TB/s. The
// design keeps every kernel free of cooperation inside a block: the split
// writes one count per 64-byte segment, a prefix sum over those counts
// (torch.cumsum, 1/64 of the bytes) gives each segment its first row, and
// the second pass writes the row starts in order. The field walk is one
// thread per row: neighbouring threads read neighbouring rows, so a warp's
// byte loads fall in a few kilobytes that L1 holds while the warp walks.
// The utf8 steps (compare every row with its hash group's representative,
// gather the distinct values into one blob) are one thread per row or per
// value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSegmentBytes = 64;  // bytes one split thread owns
constexpr unsigned char kNewline = '\n';
constexpr unsigned long long kFnvOffset = 0xCBF29CE484222325ull;
constexpr unsigned long long kFnvPrime = 0x100000001B3ull;

// Column kinds, as io/native.py numbers them (float, 5, stays on the host).
constexpr int kInt64 = 0;
constexpr int kInt32 = 1;
constexpr int kDecimal = 2;
constexpr int kDate32 = 3;
constexpr int kUtf8 = 4;
constexpr int kBoolean = 6;

// Bit j set when byte lo + j starts a row. The buffer is padded to a
// multiple of 64 bytes, so the four 16-byte loads never leave it; bytes
// at or past `size` are padding and start nothing.
__device__ __forceinline__ unsigned long long row_start_mask(
    const unsigned char* data, long long lo, long long begin,
    long long size) {
  const uint4* v = reinterpret_cast<const uint4*>(data + lo);
  unsigned int w[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 x = v[i];
    w[4 * i] = x.x;
    w[4 * i + 1] = x.y;
    w[4 * i + 2] = x.z;
    w[4 * i + 3] = x.w;
  }
  unsigned int prev = lo > 0 ? data[lo - 1] : kNewline;
  unsigned long long mask = 0;
#pragma unroll
  for (int j = 0; j < kSegmentBytes; ++j) {
    const unsigned int b = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    const long long q = lo + j;
    if (q >= begin && q < size && b != kNewline && prev == kNewline) {
      mask |= 1ull << j;
    }
    prev = b;
  }
  return mask;
}

__global__ void count_row_starts(const unsigned char* data, long long begin,
                                 long long size, long long segments,
                                 int* counts) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= segments) return;
  counts[i] = __popcll(row_start_mask(data, i * kSegmentBytes, begin, size));
}

// `inclusive` is the inclusive prefix sum of count_row_starts' counts.
__global__ void write_row_starts(const unsigned char* data, long long begin,
                                 long long size, long long segments,
                                 const long long* inclusive,
                                 long long* starts) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= segments) return;
  const long long lo = i * kSegmentBytes;
  unsigned long long mask = row_start_mask(data, lo, begin, size);
  long long out = inclusive[i] - __popcll(mask);
  while (mask != 0) {
    const int j = __ffsll(static_cast<long long>(mask)) - 1;
    starts[out++] = lo + j;
    mask &= mask - 1;
  }
}

__device__ __forceinline__ bool digit(unsigned char c, unsigned int& d) {
  d = static_cast<unsigned int>(c) - '0';
  return d <= 9;
}

__device__ __forceinline__ long long pow10_ll(int n) {
  long long p = 1;
  while (n-- > 0) p *= 10;
  return p;
}

// Howard Hinnant's civil-days algorithm, as tblscan.cpp has it.
__device__ __forceinline__ long long days_from_civil(int y, int m, int d) {
  y -= m <= 2;
  const int era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097LL + static_cast<int>(doe) - 719468;
}

// tblscan.cpp reads the date's digits as (signed) chars without checking
__device__ __forceinline__ int date_digits(const unsigned char* p, int n) {
  int v = 0;
  for (int i = 0; i < n; ++i) {
    v = v * 10 + (static_cast<int>(static_cast<signed char>(p[i])) - '0');
  }
  return v;
}

// Integer arithmetic is unsigned, so that overflow wraps as the host's
// does in practice, without undefined behaviour.
__device__ bool parse_integer(const unsigned char* s, const unsigned char* e,
                              long long& out) {
  bool neg = false;
  if (s < e && (*s == '-' || *s == '+')) neg = (*s == '-'), ++s;
  unsigned long long v = 0;
  unsigned int d;
  for (; s < e; ++s) {
    if (!digit(*s, d)) return false;
    v = v * 10 + d;
  }
  out = static_cast<long long>(neg ? 0ull - v : v);
  return true;
}

// decimal(scale) as a scaled integer: rounding on the first truncated
// digit only, short fractions padded
__device__ bool parse_decimal(const unsigned char* s, const unsigned char* e,
                              int scale, long long& out) {
  bool neg = false;
  if (s < e && (*s == '-' || *s == '+')) neg = (*s == '-'), ++s;
  unsigned long long ip = 0;
  unsigned int d;
  for (; s < e && *s != '.'; ++s) {
    if (!digit(*s, d)) return false;
    ip = ip * 10 + d;
  }
  unsigned long long fp = 0;
  int fdigits = 0;
  if (s < e && *s == '.') {
    ++s;
    for (; s < e && fdigits < scale; ++s, ++fdigits) {
      if (!digit(*s, d)) return false;
      fp = fp * 10 + d;
    }
    if (s < e && *s >= '5' && *s <= '9') ++fp;
  }
  while (fdigits < scale) fp *= 10, ++fdigits;
  const unsigned long long v =
      ip * static_cast<unsigned long long>(pow10_ll(scale)) + fp;
  out = static_cast<long long>(neg ? 0ull - v : v);
  return true;
}

// The port's physical types: int64 for int64 and decimal, one byte for
// boolean, int32 (cut as static_cast<int32_t> does) for the rest.
__device__ __forceinline__ void store(int kind, long long column, long long r,
                                      long long v) {
  if (kind == kInt64 || kind == kDecimal) {
    reinterpret_cast<long long*>(column)[r] = v;
  } else if (kind == kBoolean) {
    reinterpret_cast<unsigned char*>(column)[r] = static_cast<unsigned char>(v);
  } else {
    reinterpret_cast<int*>(column)[r] = static_cast<int>(v);
  }
}

// One thread per row: walk the row's fields once, parse the wanted ones.
// Per schema column `ci`: kinds[ci] (-1 = stepped over), scales[ci], and
// device addresses (0 where unused) of its outputs: values[ci] (the
// values in the port's physical type, see store; int64 field starts of
// utf8), lens[ci] and hashes[ci] (utf8: int32 lengths and
// 64-bit FNV-1a hashes of the field's bytes), valid[ci] (non-utf8: one
// byte a row, 0 for NULL). nulls[ci] is set to 1 when the column saw a
// NULL. A field that does not parse sets *err to the least
// (row start << 16 | column) of any failure, and the row stops there.
__global__ void parse_rows(const unsigned char* data, long long size,
                           const long long* starts, long long n, int ncols,
                           unsigned char delim, const int* kinds,
                           const int* scales, const long long* values,
                           const long long* lens, const long long* hashes,
                           const long long* valid, int* nulls,
                           unsigned long long* err) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long row = starts[r];
  long long p = row;
  bool at_end = false;  // the row's newline (or the file's end) is reached
  for (int ci = 0; ci < ncols; ++ci) {
    const int kind = __ldg(kinds + ci);
    long long e = p;
    const long long s = p;
    if (!at_end) {
      while (e < size) {
        const unsigned char c = __ldg(data + e);
        if (c == kNewline || c == delim) break;
        ++e;
      }
      if (e < size && __ldg(data + e) != kNewline) {
        p = e + 1;  // step over the delimiter
      } else {
        p = e;
        at_end = true;
      }
    }
    if (kind < 0) continue;
    const unsigned char* fs = data + s;
    const unsigned char* fe = data + e;
    if (kind == kUtf8) {
      unsigned long long h = kFnvOffset;
      for (const unsigned char* q = fs; q < fe; ++q) {
        h = (h ^ __ldg(q)) * kFnvPrime;
      }
      reinterpret_cast<long long*>(values[ci])[r] = s;
      reinterpret_cast<int*>(lens[ci])[r] = static_cast<int>(e - s);
      reinterpret_cast<unsigned long long*>(hashes[ci])[r] = h;
      continue;
    }
    unsigned char* vrow = reinterpret_cast<unsigned char*>(valid[ci]) + r;
    if (s == e) {  // an empty non-string field is NULL
      nulls[ci] = 1;
      *vrow = 0;
      store(kind, values[ci], r, 0);
      continue;
    }
    *vrow = 1;
    long long v = 0;
    bool ok = true;
    switch (kind) {
      case kInt64:
      case kInt32:
        ok = parse_integer(fs, fe, v);
        break;
      case kDecimal:
        ok = parse_decimal(fs, fe, __ldg(scales + ci), v);
        break;
      case kDate32:
        if (e - s < 10) {
          ok = false;
        } else {
          v = days_from_civil(date_digits(fs, 4), date_digits(fs + 5, 2),
                              date_digits(fs + 8, 2));
        }
        break;
      case kBoolean: {
        unsigned int c0 = *fs;
        if (c0 >= 'A' && c0 <= 'Z') c0 += 'a' - 'A';
        if (c0 == 't' || c0 == '1') {
          v = 1;
        } else if (c0 == 'f' || c0 == '0') {
          v = 0;
        } else {
          ok = false;
        }
        break;
      }
      default:
        ok = false;
    }
    if (!ok) {
      atomicMin(err, (static_cast<unsigned long long>(row) << 16) |
                         static_cast<unsigned long long>(ci & 0xFFFF));
      return;
    }
    store(kind, values[ci], r, v);
  }
}

// flags[r] = 1 (and *mismatches counts it) when row r's bytes differ from
// those of rep[gid[r]], the representative of its hash group.
__global__ void verify_groups(const unsigned char* data,
                              const long long* fstart, const int* flen,
                              const long long* gid, const long long* rep,
                              long long n, unsigned char* flags,
                              unsigned long long* mismatches) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long q = rep[gid[r]];
  const int len = flen[r];
  bool same = len == flen[q];
  if (same && q != r) {
    const unsigned char* a = data + fstart[r];
    const unsigned char* b = data + fstart[q];
    for (int j = 0; j < len; ++j) {
      if (__ldg(a + j) != __ldg(b + j)) {
        same = false;
        break;
      }
    }
  }
  flags[r] = same ? 0 : 1;
  if (!same) atomicAdd(mismatches, 1ull);
}

// out[offsets[i] .. offsets[i] + flen[rows[i]]) = the bytes of row rows[i]
__global__ void gather_values(const unsigned char* data,
                              const long long* fstart, const int* flen,
                              const long long* rows, const long long* offsets,
                              long long k, unsigned char* out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const long long r = rows[i];
  const unsigned char* src = data + fstart[r];
  unsigned char* dst = out + offsets[i];
  const int len = flen[r];
  for (int j = 0; j < len; ++j) dst[j] = __ldg(src + j);
}

inline unsigned int grid_for(long long items, int threads) {
  return static_cast<unsigned int>((items + threads - 1) / threads);
}

inline int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Each launcher queues its kernel on `stream` and returns a CUDA error
// code: 0 when the launch was accepted, cudaErrorInvalidValue for bad
// arguments, else cudaGetLastError(). Pointers are device addresses.
// `data` holds the file's bytes, padded with at least 64 bytes past the
// last whole 64-byte segment; it is 16-byte aligned.

int tbl_count_row_starts(const void* data, long long begin, long long size,
                         long long segments, void* counts, int threads,
                         void* stream) {
  if (segments <= 0 || threads <= 0 || begin < 0 || size < 0 ||
      (reinterpret_cast<uintptr_t>(data) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  count_row_starts<<<grid_for(segments, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(data), begin, size, segments,
      static_cast<int*>(counts));
  return launched();
}

int tbl_write_row_starts(const void* data, long long begin, long long size,
                         long long segments, const void* inclusive,
                         void* starts, int threads, void* stream) {
  if (segments <= 0 || threads <= 0 || begin < 0 || size < 0 ||
      (reinterpret_cast<uintptr_t>(data) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  write_row_starts<<<grid_for(segments, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(data), begin, size, segments,
      static_cast<const long long*>(inclusive),
      static_cast<long long*>(starts));
  return launched();
}

int tbl_parse_rows(const void* data, long long size, const void* starts,
                   long long n, int ncols, int delim, const void* kinds,
                   const void* scales, const void* values, const void* lens,
                   const void* hashes, const void* valid, void* nulls,
                   void* err, int threads, void* stream) {
  if (n <= 0 || ncols <= 0 || threads <= 0 || delim < 0 || delim > 255) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  parse_rows<<<grid_for(n, threads), threads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(data), size,
      static_cast<const long long*>(starts), n, ncols,
      static_cast<unsigned char>(delim), static_cast<const int*>(kinds),
      static_cast<const int*>(scales), static_cast<const long long*>(values),
      static_cast<const long long*>(lens),
      static_cast<const long long*>(hashes),
      static_cast<const long long*>(valid), static_cast<int*>(nulls),
      static_cast<unsigned long long*>(err));
  return launched();
}

int tbl_verify_groups(const void* data, const void* fstart, const void* flen,
                      const void* gid, const void* rep, long long n,
                      void* flags, void* mismatches, int threads,
                      void* stream) {
  if (n <= 0 || threads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  verify_groups<<<grid_for(n, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(data),
      static_cast<const long long*>(fstart), static_cast<const int*>(flen),
      static_cast<const long long*>(gid), static_cast<const long long*>(rep),
      n, static_cast<unsigned char*>(flags),
      static_cast<unsigned long long*>(mismatches));
  return launched();
}

int tbl_gather_values(const void* data, const void* fstart, const void* flen,
                      const void* rows, const void* offsets, long long k,
                      void* out, int threads, void* stream) {
  if (k <= 0 || threads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gather_values<<<grid_for(k, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(data),
      static_cast<const long long*>(fstart), static_cast<const int*>(flen),
      static_cast<const long long*>(rows),
      static_cast<const long long*>(offsets), k,
      static_cast<unsigned char*>(out));
  return launched();
}

const char* tbl_parse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
