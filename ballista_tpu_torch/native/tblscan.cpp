// Native delimited-text scanner for ballista-tpu.
//
// The role DataFusion's Rust CSV reader plays for the reference engine's
// scans (reference: rust/client/src/context.rs:88-108 read_csv;
// rust/benchmarks/tpch/src/main.rs:128-155 .tbl registration): parse
// '|'/','-delimited files into typed columnar buffers at native speed.
//
// Exposed as a C API consumed from Python via ctypes (no pybind11 in the
// build environment). One pass over an mmap'd file; per-column typed
// vectors; string columns are dictionary-encoded with a SORTED dictionary
// so codes are ordinal (the engine's comparison kernels rely on this).
//
// Column kinds: 0=int64 1=int32 2=decimal(scale)->int64 3=date32(days)
//               4=utf8 dict codes (int32) 5=float32 6=boolean(int32)
//               -1 = skip column.
// NOTE: no quote handling — callers route quoted CSV through the Python
// reader and use this scanner for unquoted formats (TPC-H .tbl).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Column {
  int kind = -1;
  int scale = 0;
  std::vector<int64_t> i64;
  std::vector<int32_t> i32;
  std::vector<float> f32;
  // utf8: raw codes (pre-sort), dictionary arena
  std::unordered_map<std::string, int32_t> dict_map;
  std::vector<std::string> dict_values;
  // 1-byte values (status flags etc.) hit this O(1) table instead of a
  // per-row string construction + hash lookup; kept consistent with
  // dict_map so mixed-length columns stay correct
  int32_t char1[256];
  // SQL NULLs: empty non-string fields parse as NULL (CSV convention,
  // matching the reference's Arrow readers). valid is tracked per row;
  // has_null lets the wrapper skip materializing all-valid bitmaps.
  std::vector<uint8_t> valid;
  bool has_null = false;
  Column() { for (auto& v : char1) v = -1; }
};

struct Table {
  std::vector<Column> cols;
  int64_t num_rows = 0;
  std::string error;
};

inline int64_t days_from_civil(int y, int m, int d) {
  // Howard Hinnant's civil-days algorithm (public domain)
  y -= m <= 2;
  const int era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097LL + static_cast<int>(doe) - 719468;
}

inline int64_t pow10_i(int n) {
  int64_t p = 1;
  while (n-- > 0) p *= 10;
  return p;
}

inline size_t col_size(const Column& c) {
  switch (c.kind) {
    case 0: case 2: return c.i64.size();
    case 1: case 3: case 4: case 6: return c.i32.size();
    case 5: return c.f32.size();
  }
  return 0;
}

// parse one field [s, e) into column c
inline bool parse_field(Column& c, const char* s, const char* e) {
  if (s == e && c.kind >= 0 && c.kind != 4) {
    // empty non-string field -> SQL NULL (utf8 keeps "" as a value,
    // the unquoted-format convention). Validity tracking starts lazily
    // at the first NULL: backfill earlier rows as valid, and the row
    // loop resizes with 1s after each subsequent parse.
    if (!c.has_null) {
      c.valid.assign(col_size(c), 1);
      c.has_null = true;
    }
    switch (c.kind) {
      case 0: case 2: c.i64.push_back(0); break;
      case 1: case 3: case 6: c.i32.push_back(0); break;
      case 5: c.f32.push_back(0.0f); break;
    }
    c.valid.push_back(0);
    return true;
  }
  switch (c.kind) {
    case 0: case 1: {  // int64 / int32
      bool neg = false;
      if (s < e && (*s == '-' || *s == '+')) neg = (*s == '-'), ++s;
      int64_t v = 0;
      for (; s < e; ++s) {
        if (*s < '0' || *s > '9') return false;
        v = v * 10 + (*s - '0');
      }
      if (neg) v = -v;
      if (c.kind == 0) c.i64.push_back(v);
      else c.i32.push_back(static_cast<int32_t>(v));
      return true;
    }
    case 2: {  // decimal -> scaled int64
      bool neg = false;
      if (s < e && (*s == '-' || *s == '+')) neg = (*s == '-'), ++s;
      int64_t ip = 0;
      for (; s < e && *s != '.'; ++s) {
        if (*s < '0' || *s > '9') return false;
        ip = ip * 10 + (*s - '0');
      }
      int64_t fp = 0;
      int fdigits = 0;
      if (s < e && *s == '.') {
        ++s;
        for (; s < e && fdigits < c.scale; ++s, ++fdigits) {
          if (*s < '0' || *s > '9') return false;
          fp = fp * 10 + (*s - '0');
        }
        // round on the first truncated digit
        if (s < e && *s >= '5' && *s <= '9') ++fp;
      }
      while (fdigits < c.scale) fp *= 10, ++fdigits;
      int64_t v = ip * pow10_i(c.scale) + fp;
      c.i64.push_back(neg ? -v : v);
      return true;
    }
    case 3: {  // date32: YYYY-MM-DD
      if (e - s < 10) return false;
      auto num = [&](const char* p, int n) {
        int v = 0;
        for (int i = 0; i < n; ++i) v = v * 10 + (p[i] - '0');
        return v;
      };
      int y = num(s, 4), m = num(s + 5, 2), d = num(s + 8, 2);
      c.i32.push_back(static_cast<int32_t>(days_from_civil(y, m, d)));
      return true;
    }
    case 4: {  // utf8 dict
      if (e - s == 1) {
        int32_t cached = c.char1[static_cast<unsigned char>(*s)];
        if (cached >= 0) {
          c.i32.push_back(cached);
          return true;
        }
      }
      std::string key(s, static_cast<size_t>(e - s));
      auto it = c.dict_map.find(key);
      int32_t code;
      if (it == c.dict_map.end()) {
        code = static_cast<int32_t>(c.dict_values.size());
        c.dict_map.emplace(key, code);
        c.dict_values.push_back(std::move(key));
      } else {
        code = it->second;
      }
      if (e - s == 1) c.char1[static_cast<unsigned char>(*s)] = code;
      c.i32.push_back(code);
      return true;
    }
    case 5: {  // float32
      char buf[64];
      size_t n = std::min<size_t>(static_cast<size_t>(e - s), 63);
      memcpy(buf, s, n);
      buf[n] = 0;
      c.f32.push_back(strtof(buf, nullptr));
      return true;
    }
    case 6: {  // boolean: true/false/t/f/1/0 (case-insensitive)
      char c0 = (s < e) ? static_cast<char>(tolower(*s)) : 0;
      if (c0 == 't' || c0 == '1') c.i32.push_back(1);
      else if (c0 == 'f' || c0 == '0') c.i32.push_back(0);
      else return false;
      return true;
    }
    default:
      return true;  // skipped column
  }
}

// Parse rows of [start-boundary after `from`, first row at/after `to`)
// into t's columns. Returns false (with t->error set) on a parse error.
// `data`/`end` bound the whole mapping; `from`==data means "begin at the
// top" (header handling is the caller's job).
bool parse_span(Table* t, const char* data, const char* end,
                const char* from, const char* to, char delim, int ncols) {
  const char* p = from;
  if (from != data) {
    // row ownership rule: a row belongs to the span containing its
    // first byte (probe for the newline ending the previous row)
    p = from - 1;
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    p = (nl == nullptr) ? end : nl + 1;
  }
  int64_t row = 0;
  while (p < to) {  // a row that BEGINS before `to` parses to its EOL
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (nl == nullptr) nl = end;
    if (p == nl) {  // empty line
      ++p;
      continue;
    }
    const char* row_start = p;
    for (int ci = 0; ci < ncols; ++ci) {
      const char* fe = static_cast<const char*>(
          memchr(p, delim, static_cast<size_t>(nl - p)));
      if (fe == nullptr) fe = nl;
      Column& c = t->cols[static_cast<size_t>(ci)];
      if (c.kind >= 0) {
        if (!parse_field(c, p, fe)) {
          // `row` counts from the span start, which is meaningless to a
          // reader of a ranged/multithreaded scan; the absolute byte
          // offsets of the failing row and of the span locate the error
          // in the file regardless of which sub-span hit it
          char msg[224];
          snprintf(msg, sizeof msg,
                   "parse error at row %lld of span (row byte offset "
                   "%lld, span starts at byte %lld) col %d (kind %d)",
                   static_cast<long long>(row),
                   static_cast<long long>(row_start - data),
                   static_cast<long long>(from - data), ci, c.kind);
          t->error = msg;
          return false;
        }
        if (c.has_null) c.valid.resize(col_size(c), 1);
      }
      p = fe < nl ? fe + 1 : nl;  // consume field delimiter
    }
    p = nl < end ? nl + 1 : end;
    ++row;
  }
  t->num_rows = row;
  return true;
}

// Append src's parsed rows onto dst (same column layout). utf8 codes are
// remapped into dst's dictionary space; validity lengths are normalized.
void append_table(Table& dst, Table& src, int ncols) {
  for (int ci = 0; ci < ncols; ++ci) {
    Column& d = dst.cols[static_cast<size_t>(ci)];
    Column& s = src.cols[static_cast<size_t>(ci)];
    if (d.kind < 0) continue;
    const size_t d_rows = col_size(d);
    const size_t s_rows = col_size(s);
    if (d.kind == 4) {
      std::vector<int32_t> remap(s.dict_values.size());
      for (size_t i = 0; i < s.dict_values.size(); ++i) {
        auto it = d.dict_map.find(s.dict_values[i]);
        if (it == d.dict_map.end()) {
          int32_t code = static_cast<int32_t>(d.dict_values.size());
          d.dict_map.emplace(s.dict_values[i], code);
          d.dict_values.push_back(s.dict_values[i]);
          remap[i] = code;
        } else {
          remap[i] = it->second;
        }
      }
      d.i32.reserve(d.i32.size() + s.i32.size());
      for (int32_t code : s.i32) d.i32.push_back(remap[code]);
      // the 1-byte fast cache maps to dst codes already; leave it
    } else {
      d.i64.insert(d.i64.end(), s.i64.begin(), s.i64.end());
      d.i32.insert(d.i32.end(), s.i32.begin(), s.i32.end());
      d.f32.insert(d.f32.end(), s.f32.begin(), s.f32.end());
    }
    if (s.has_null && !d.has_null) {
      d.valid.assign(d_rows, 1);
      d.has_null = true;
    }
    if (d.has_null) {
      if (s.has_null) {
        d.valid.insert(d.valid.end(), s.valid.begin(), s.valid.end());
      } else {
        d.valid.insert(d.valid.end(), s_rows, 1);
      }
    }
  }
  dst.num_rows += src.num_rows;
}

void sort_dictionary(Column& c) {
  // sort dict; remap codes so they stay ordinal
  const size_t n = c.dict_values.size();
  std::vector<int32_t> order(n);
  for (size_t i = 0; i < n; ++i) order[i] = static_cast<int32_t>(i);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return c.dict_values[a] < c.dict_values[b];
  });
  std::vector<int32_t> remap(n);
  std::vector<std::string> sorted(n);
  for (size_t i = 0; i < n; ++i) {
    remap[order[i]] = static_cast<int32_t>(i);
    sorted[i] = std::move(c.dict_values[order[i]]);
  }
  c.dict_values = std::move(sorted);
  for (auto& code : c.i32) code = remap[code];
  c.dict_map.clear();
}

}  // namespace

extern "C" {

// Returns an opaque Table*; on fatal error returns a Table with error set
// (check tbl_error). wanted: indices of columns to materialize; others are
// parsed-past. delimiter: e.g. '|'; skip_header: 1 to drop first line.
//
// Byte-range scans (offset/max_bytes) enable bounded-RAM streaming over
// arbitrarily large files and parallel chunk workers: an offset > 0
// starts at the first line boundary AFTER offset, and parsing runs to
// the first line boundary at/after offset+max_bytes (max_bytes < 0 =
// EOF). Adjacent ranges therefore partition the file's rows exactly.
void* tbl_open_range_mt(const char* path, int ncols, const int32_t* kinds,
                        const int32_t* scales, const int32_t* wanted,
                        int nwanted, char delimiter, int skip_header,
                        int64_t offset, int64_t max_bytes, int nthreads) {
  auto init_table = [&](Table* t) {
    t->cols.resize(static_cast<size_t>(ncols));
    std::vector<char> want(static_cast<size_t>(ncols), 0);
    for (int i = 0; i < nwanted; ++i)
      want[static_cast<size_t>(wanted[i])] = 1;
    for (int i = 0; i < ncols; ++i) {
      t->cols[static_cast<size_t>(i)].kind =
          want[static_cast<size_t>(i)] ? kinds[i] : -1;
      t->cols[static_cast<size_t>(i)].scale = scales[i];
    }
  };
  auto* t = new Table();
  init_table(t);

  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    t->error = std::string("open failed: ") + strerror(errno);
    return t;
  }
  struct stat st;
  fstat(fd, &st);
  size_t size = static_cast<size_t>(st.st_size);
  if (size == 0 || offset >= static_cast<int64_t>(size)) {
    close(fd);
    return t;
  }
  const char* data = static_cast<const char*>(
      mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) {
    t->error = std::string("mmap failed: ") + strerror(errno);
    return t;
  }
  const char* end = data + size;
  const char* from = data + offset;  // span rule handles row alignment
  const char* stop = end;            // parse rows that BEGIN before stop
  if (max_bytes >= 0 && offset + max_bytes < static_cast<int64_t>(size)) {
    stop = data + offset + max_bytes;
  }
  if (skip_header && offset == 0) {
    const char* p = data;
    while (p < end && *p != '\n') ++p;
    from = (p < end) ? p + 1 : end;
    // the header consumed the span's data==from anchor; fake a non-top
    // start so parse_span's boundary probe lands on the header's newline
    if (from == end) stop = from;
  }

  const int64_t span_bytes = stop - from;
  int nt = nthreads;
  if (nt < 1) nt = 1;
  // a thread needs enough bytes to amortize merge cost (env override is
  // for tests exercising the merge on small inputs)
  int64_t min_per = 16 << 20;
  const char* mp = getenv("TBLSCAN_MIN_THREAD_BYTES");
  if (mp != nullptr && atoll(mp) > 0) min_per = atoll(mp);
  if (span_bytes / min_per < nt)
    nt = static_cast<int>(span_bytes / min_per);
  if (nt < 1) nt = 1;

  // offset==0 starts row-aligned (top of file, or just past the header),
  // so parse_span's boundary probe is skipped by passing data==from;
  // offset>0 must probe for the previous row's newline
  const bool aligned = (offset == 0);
  if (nt == 1) {
    if (!parse_span(t, aligned ? from : data, end, from, stop, delimiter,
                    ncols)) {
      munmap(const_cast<char*>(data), size);
      return t;
    }
  } else {
    std::vector<Table> parts(static_cast<size_t>(nt));
    std::vector<pthread_t> threads(static_cast<size_t>(nt));
    struct Job {
      Table* t;
      const char* data;
      const char* end;
      const char* from;
      const char* to;
      char delim;
      int ncols;
    };
    std::vector<Job> jobs(static_cast<size_t>(nt));
    const int64_t per = span_bytes / nt;
    for (int i = 0; i < nt; ++i) {
      auto& part = parts[static_cast<size_t>(i)];
      init_table(&part);
      const char* lo = from + per * i;
      const char* hi = (i == nt - 1) ? stop : from + per * (i + 1);
      // only an aligned first sub-span may skip the boundary probe
      jobs[static_cast<size_t>(i)] = {
          &part, (i == 0 && aligned) ? lo : data, end, lo, hi, delimiter,
          ncols};
    }
    auto run = [](void* arg) -> void* {
      auto* j = static_cast<Job*>(arg);
      parse_span(j->t, j->data, j->end, j->from, j->to, j->delim, j->ncols);
      return nullptr;
    };
    for (int i = 0; i < nt; ++i)
      pthread_create(&threads[static_cast<size_t>(i)], nullptr, run,
                     &jobs[static_cast<size_t>(i)]);
    for (int i = 0; i < nt; ++i)
      pthread_join(threads[static_cast<size_t>(i)], nullptr);
    for (int i = 0; i < nt; ++i) {
      if (!parts[static_cast<size_t>(i)].error.empty()) {
        t->error = parts[static_cast<size_t>(i)].error;
        munmap(const_cast<char*>(data), size);
        return t;
      }
    }
    for (int i = 0; i < nt; ++i)
      append_table(*t, parts[static_cast<size_t>(i)], ncols);
  }
  munmap(const_cast<char*>(data), size);
  for (auto& c : t->cols)
    if (c.kind == 4) sort_dictionary(c);
  return t;
}

void* tbl_open_range(const char* path, int ncols, const int32_t* kinds,
                     const int32_t* scales, const int32_t* wanted,
                     int nwanted, char delimiter, int skip_header,
                     int64_t offset, int64_t max_bytes) {
  return tbl_open_range_mt(path, ncols, kinds, scales, wanted, nwanted,
                           delimiter, skip_header, offset, max_bytes, 1);
}

void* tbl_open(const char* path, int ncols, const int32_t* kinds,
               const int32_t* scales, const int32_t* wanted, int nwanted,
               char delimiter, int skip_header) {
  return tbl_open_range(path, ncols, kinds, scales, wanted, nwanted,
                        delimiter, skip_header, 0, -1);
}

const char* tbl_error(void* h) {
  auto* t = static_cast<Table*>(h);
  return t->error.empty() ? nullptr : t->error.c_str();
}

int64_t tbl_num_rows(void* h) { return static_cast<Table*>(h)->num_rows; }

// fill int64 buffer (kind 0 and 2)
int tbl_fill_i64(void* h, int col, int64_t* out) {
  auto& c = static_cast<Table*>(h)->cols[static_cast<size_t>(col)];
  if (c.i64.empty() && static_cast<Table*>(h)->num_rows > 0) return -1;
  memcpy(out, c.i64.data(), c.i64.size() * sizeof(int64_t));
  return 0;
}

// fill int32 buffer (kinds 1, 3, 4)
int tbl_fill_i32(void* h, int col, int32_t* out) {
  auto& c = static_cast<Table*>(h)->cols[static_cast<size_t>(col)];
  if (c.i32.empty() && static_cast<Table*>(h)->num_rows > 0) return -1;
  memcpy(out, c.i32.data(), c.i32.size() * sizeof(int32_t));
  return 0;
}

int tbl_fill_f32(void* h, int col, float* out) {
  auto& c = static_cast<Table*>(h)->cols[static_cast<size_t>(col)];
  if (c.f32.empty() && static_cast<Table*>(h)->num_rows > 0) return -1;
  memcpy(out, c.f32.data(), c.f32.size() * sizeof(float));
  return 0;
}

int64_t tbl_dict_count(void* h, int col) {
  return static_cast<int64_t>(
      static_cast<Table*>(h)->cols[static_cast<size_t>(col)].dict_values.size());
}

int64_t tbl_dict_total_bytes(void* h, int col) {
  int64_t n = 0;
  for (auto& s :
       static_cast<Table*>(h)->cols[static_cast<size_t>(col)].dict_values)
    n += static_cast<int64_t>(s.size());
  return n;
}

// out: concatenated utf8 bytes; offsets: dict_count+1 entries
int tbl_fill_dict(void* h, int col, char* out, int64_t* offsets) {
  auto& c = static_cast<Table*>(h)->cols[static_cast<size_t>(col)];
  int64_t off = 0;
  size_t i = 0;
  for (auto& s : c.dict_values) {
    offsets[i++] = off;
    memcpy(out + off, s.data(), s.size());
    off += static_cast<int64_t>(s.size());
  }
  offsets[i] = off;
  return 0;
}

// 1 when the column saw at least one NULL (empty field); 0 = all valid
// (the wrapper can then skip materializing a bitmap entirely)
int tbl_has_null(void* h, int col) {
  return static_cast<Table*>(h)->cols[static_cast<size_t>(col)].has_null ? 1 : 0;
}

// fill per-row validity bytes (1 = valid, 0 = NULL); num_rows entries.
// Only meaningful when tbl_has_null returns 1.
int tbl_fill_valid(void* h, int col, uint8_t* out) {
  auto* t = static_cast<Table*>(h);
  auto& c = t->cols[static_cast<size_t>(col)];
  if (!c.has_null) return -1;
  if (static_cast<int64_t>(c.valid.size()) != t->num_rows) return -1;
  memcpy(out, c.valid.data(), c.valid.size());
  return 0;
}

void tbl_close(void* h) { delete static_cast<Table*>(h); }

}  // extern "C"
