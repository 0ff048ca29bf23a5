// Native CSV parser — the engine's host-side data loader.
//
// Plays the role the arrow::csv::Reader (native Rust) played for the
// reference (reference: src/execution/datasource.rs:33-58), feeding the
// columnar ingest path: typed numeric columns parsed straight into
// caller-allocated buffers, string columns returned as (offset, length)
// pairs into the input buffer for zero-copy extraction, with validity
// tracking for empty fields.
//
// Parallelism model:
//   * row indexing uses the quote-parity invariant: a byte is inside a
//     quoted section iff the count of '"' before it is odd (the "" escape
//     is two quotes = two parity flips = net zero, so the invariant holds
//     with no lookahead). Chunks count quotes independently, a prefix-xor
//     gives each chunk's starting parity, then chunks scan for row-
//     boundary newlines independently — all memchr-driven (SIMD).
//   * field parsing splits the indexed rows across threads.
//   * dictionary encoding builds per-thread local vocabularies and codes,
//     then merges and remaps.
// The index is built ONCE and shared between the row-count and parse
// steps through an opaque handle (the old two-scan ctypes API cost a
// second full-buffer pass).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libdftpu_csv.so csv_parser.cpp -lpthread

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <charconv>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

// dtype codes shared with Python (datafusion_tpu/io/native.py)
enum DType : int32_t {
  DT_BOOL = 0,
  DT_I8 = 1,
  DT_I16 = 2,
  DT_I32 = 3,
  DT_I64 = 4,
  DT_U8 = 5,
  DT_U16 = 6,
  DT_U32 = 7,
  DT_U64 = 8,
  DT_F32 = 9,
  DT_F64 = 10,
  DT_UTF8 = 11,
  DT_DATE32 = 12,  // days since 1970-01-01, parsed from YYYY-MM-DD
  DT_TS64 = 13,    // seconds since epoch, parsed from YYYY-MM-DD[ |T]HH:MM:SS[.frac]
};

// Howard Hinnant's days_from_civil (public domain algorithm)
inline int32_t days_from_civil(int y, int m, int d) {
  y -= m <= 2;
  const int era = (y >= 0 ? y : y - 399) / 400;
  const int yoe = y - era * 400;
  const int doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const int doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

// Parse YYYY-MM-DD (strict) into days since epoch.
inline bool parse_date32(const char* b, int64_t len, int32_t* out) {
  if (len != 10 || b[4] != '-' || b[7] != '-') return false;
  int y = 0, m = 0, d = 0;
  auto r1 = std::from_chars(b, b + 4, y);
  auto r2 = std::from_chars(b + 5, b + 7, m);
  auto r3 = std::from_chars(b + 8, b + 10, d);
  if (r1.ec != std::errc() || r2.ec != std::errc() || r3.ec != std::errc())
    return false;
  if (m < 1 || m > 12 || d < 1 || d > 31) return false;
  *out = days_from_civil(y, m, d);
  return true;
}

// Parse YYYY-MM-DD[ |T]HH:MM:SS[.frac] (or a bare date = midnight) into
// seconds since epoch; fractional seconds truncate.
inline bool parse_ts64(const char* b, int64_t len, int64_t* out) {
  int32_t days = 0;
  if (len < 10 || !parse_date32(b, 10, &days)) return false;
  int64_t secs = (int64_t)days * 86400;
  if (len == 10) { *out = secs; return true; }
  if (len < 19 || (b[10] != ' ' && b[10] != 'T') || b[13] != ':' || b[16] != ':')
    return false;
  int h = 0, mi = 0, sec = 0;
  auto r1 = std::from_chars(b + 11, b + 13, h);
  auto r2 = std::from_chars(b + 14, b + 16, mi);
  auto r3 = std::from_chars(b + 17, b + 19, sec);
  if (r1.ec != std::errc() || r2.ec != std::errc() || r3.ec != std::errc())
    return false;
  if (h > 23 || mi > 59 || sec > 60) return false;
  if (len > 19 && b[19] != '.') return false;  // only a fraction may follow
  for (int64_t i = 20; i < len; ++i)
    if (b[i] < '0' || b[i] > '9') return false;
  *out = secs + h * 3600 + mi * 60 + sec;
  return true;
}

struct Field {
  const char* ptr;
  int64_t len;
};

struct CsvIndex {
  std::vector<int64_t> row_starts;  // includes the header row if present
};

int resolve_threads(int num_threads, int64_t work_items) {
  int nt = num_threads > 0 ? num_threads
                           : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if ((int64_t)nt > work_items) nt = work_items > 0 ? (int)work_items : 1;
  return nt;
}

// Count '"' bytes in [b, e) with memchr (SIMD-paced).
int64_t count_quotes(const char* b, const char* e) {
  int64_t n = 0;
  while (b < e) {
    const char* q = (const char*)memchr(b, '"', (size_t)(e - b));
    if (q == nullptr) break;
    n++;
    b = q + 1;
  }
  return n;
}

// Record p+1 for every '\n' at even quote parity within [b, e), offsets
// relative to `base`. `start_odd` is the quote parity entering the range.
void scan_rows(const char* base, const char* b, const char* e, bool start_odd,
               std::vector<int64_t>& out) {
  bool odd = start_odd;
  const char* pos = b;
  while (pos < e) {
    const char* q = (const char*)memchr(pos, '"', (size_t)(e - pos));
    const char* seg_end = q ? q : e;
    if (!odd) {
      const char* p = pos;
      while (p < seg_end) {
        const char* nl = (const char*)memchr(p, '\n', (size_t)(seg_end - p));
        if (nl == nullptr) break;
        out.push_back((int64_t)(nl + 1 - base));
        p = nl + 1;
      }
    }
    if (q == nullptr) break;
    odd = !odd;
    pos = q + 1;
  }
}

// Build the full row index (parallel parity scan; see file header).
void build_index(const char* buf, int64_t len, int num_threads, CsvIndex* idx) {
  idx->row_starts.clear();
  if (len <= 0) return;
  int nt = resolve_threads(num_threads, (len + (1 << 20) - 1) >> 20);
  std::vector<int64_t> chunk_begin(nt + 1);
  for (int t = 0; t <= nt; t++) chunk_begin[t] = len * t / nt;

  // pass A: quotes per chunk
  std::vector<int64_t> quotes(nt, 0);
  {
    std::vector<std::thread> th;
    for (int t = 0; t < nt; t++)
      th.emplace_back([&, t] {
        quotes[t] =
            count_quotes(buf + chunk_begin[t], buf + chunk_begin[t + 1]);
      });
    for (auto& x : th) x.join();
  }
  std::vector<char> start_odd(nt, 0);
  for (int t = 1; t < nt; t++)
    start_odd[t] = start_odd[t - 1] ^ (char)(quotes[t - 1] & 1);

  // pass B: row boundaries per chunk
  std::vector<std::vector<int64_t>> parts(nt);
  {
    std::vector<std::thread> th;
    for (int t = 0; t < nt; t++)
      th.emplace_back([&, t] {
        scan_rows(buf, buf + chunk_begin[t], buf + chunk_begin[t + 1],
                  start_odd[t] != 0, parts[t]);
      });
    for (auto& x : th) x.join();
  }

  size_t total = 1;  // offset 0
  for (auto& p : parts) total += p.size();
  idx->row_starts.reserve(total);
  idx->row_starts.push_back(0);
  for (auto& p : parts)
    idx->row_starts.insert(idx->row_starts.end(), p.begin(), p.end());

  // a '\n' at the very end produces a start == len: drop it; also drop a
  // trailing line of pure '\r'/'\n' whitespace
  while (!idx->row_starts.empty()) {
    int64_t last = idx->row_starts.back();
    bool empty = true;
    for (int64_t j = last; j < len; j++) {
      if (buf[j] != '\r' && buf[j] != '\n') {
        empty = false;
        break;
      }
    }
    if (empty)
      idx->row_starts.pop_back();
    else
      break;
  }
}

// Split one row into fields (quote-aware). Returns number parsed.
int split_row(const char* buf, int64_t start, int64_t buf_len, Field* fields,
              int max_fields) {
  int nf = 0;
  int64_t i = start;
  while (nf < max_fields) {
    // one field
    if (i < buf_len && buf[i] == '"') {
      // quoted field: contents between quotes ("" stays; Python unescapes)
      int64_t fstart = ++i;
      while (i < buf_len) {
        if (buf[i] == '"') {
          if (i + 1 < buf_len && buf[i + 1] == '"') {
            i += 2;
            continue;
          }
          break;
        }
        i++;
      }
      fields[nf].ptr = buf + fstart;
      fields[nf].len = i - fstart;
      nf++;
      if (i < buf_len) i++;  // closing quote
    } else {
      int64_t fstart = i;
      while (i < buf_len && buf[i] != ',' && buf[i] != '\n' && buf[i] != '\r') i++;
      fields[nf].ptr = buf + fstart;
      fields[nf].len = i - fstart;
      nf++;
    }
    if (i >= buf_len || buf[i] == '\n' || buf[i] == '\r') break;
    if (buf[i] == ',') i++;
  }
  return nf;
}

template <typename T>
bool parse_int(const Field& f, T* out) {
  const char* b = f.ptr;
  const char* e = f.ptr + f.len;
  auto res = std::from_chars(b, e, *out);
  return res.ec == std::errc();
}

bool parse_f64(const Field& f, double* out) {
  auto res = std::from_chars(f.ptr, f.ptr + f.len, *out);
  return res.ec == std::errc();
}

void parse_rows(const char* buf, int64_t buf_len, const int64_t* row_starts,
                int64_t row_begin, int64_t row_end, int ncols,
                const int32_t* dtypes, void** out_bufs, uint8_t** valid_bufs) {
  std::vector<Field> fields(ncols);
  for (int64_t r = row_begin; r < row_end; r++) {
    int nf = split_row(buf, row_starts[r], buf_len, fields.data(), ncols);
    for (int c = 0; c < ncols; c++) {
      Field f = (c < nf) ? fields[c] : Field{buf, 0};
      bool ok = f.len > 0;
      switch (dtypes[c]) {
        case DT_BOOL: {
          bool v = ok && (f.len >= 1) && (f.ptr[0] == 't' || f.ptr[0] == 'T' || f.ptr[0] == '1');
          ((uint8_t*)out_bufs[c])[r] = v ? 1 : 0;
          break;
        }
        case DT_I8: { int8_t v = 0; ok = ok && parse_int(f, &v); ((int8_t*)out_bufs[c])[r] = v; break; }
        case DT_I16: { int16_t v = 0; ok = ok && parse_int(f, &v); ((int16_t*)out_bufs[c])[r] = v; break; }
        case DT_I32: { int32_t v = 0; ok = ok && parse_int(f, &v); ((int32_t*)out_bufs[c])[r] = v; break; }
        case DT_I64: { int64_t v = 0; ok = ok && parse_int(f, &v); ((int64_t*)out_bufs[c])[r] = v; break; }
        case DT_U8: { uint8_t v = 0; ok = ok && parse_int(f, &v); ((uint8_t*)out_bufs[c])[r] = v; break; }
        case DT_U16: { uint16_t v = 0; ok = ok && parse_int(f, &v); ((uint16_t*)out_bufs[c])[r] = v; break; }
        case DT_U32: { uint32_t v = 0; ok = ok && parse_int(f, &v); ((uint32_t*)out_bufs[c])[r] = v; break; }
        case DT_U64: { uint64_t v = 0; ok = ok && parse_int(f, &v); ((uint64_t*)out_bufs[c])[r] = v; break; }
        case DT_F32: { double v = 0; ok = ok && parse_f64(f, &v); ((float*)out_bufs[c])[r] = (float)v; break; }
        case DT_F64: { double v = 0; ok = ok && parse_f64(f, &v); ((double*)out_bufs[c])[r] = v; break; }
        case DT_DATE32: {
          int32_t v = 0;
          ok = ok && parse_date32(f.ptr, f.len, &v);
          ((int32_t*)out_bufs[c])[r] = v;
          break;
        }
        case DT_TS64: {
          int64_t v = 0;
          ok = ok && parse_ts64(f.ptr, f.len, &v);
          ((int64_t*)out_bufs[c])[r] = v;
          break;
        }
        case DT_UTF8: {
          // (offset, length) pair into the input buffer
          int64_t* dst = (int64_t*)out_bufs[c];
          dst[2 * r] = f.ptr - buf;
          dst[2 * r + 1] = f.len;
          ok = true;  // empty string is a valid string
          break;
        }
      }
      if (valid_bufs[c] != nullptr) valid_bufs[c][r] = ok ? 1 : 0;
    }
  }
}

int64_t parse_with_index(const char* buf, int64_t len, const CsvIndex* idx,
                         int has_header, int ncols, const int32_t* dtypes,
                         void** out_bufs, uint8_t** valid_bufs,
                         int num_threads) {
  const int64_t* starts = idx->row_starts.data();
  int64_t nrows = (int64_t)idx->row_starts.size();
  if (has_header && nrows > 0) {
    starts += 1;
    nrows -= 1;
  }
  if (nrows == 0) return 0;
  int nt = resolve_threads(num_threads, nrows);
  std::vector<std::thread> threads;
  int64_t chunk = (nrows + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t b = t * chunk;
    int64_t e = std::min(nrows, b + chunk);
    if (b >= e) break;
    threads.emplace_back(parse_rows, buf, len, starts, b, e, ncols, dtypes,
                         out_bufs, valid_bufs);
  }
  for (auto& th : threads) th.join();
  return nrows;
}

}  // namespace

extern "C" {

// Build the row index once (parallel). Returns an opaque handle and
// writes the DATA row count (header excluded when has_header).
void* dftpu_csv_index(const char* buf, int64_t len, int has_header,
                      int num_threads, int64_t* nrows_out) {
  CsvIndex* idx = new CsvIndex();
  build_index(buf, len, num_threads, idx);
  int64_t n = (int64_t)idx->row_starts.size();
  if (has_header && n > 0) n -= 1;
  if (nrows_out != nullptr) *nrows_out = n;
  return idx;
}

void dftpu_csv_index_free(void* idx) { delete (CsvIndex*)idx; }

// Parse into caller-allocated buffers using a previously built index.
//   out_bufs[c]: numeric → typed array [nrows]; UTF8 → int64 array
//                [nrows*2] receiving (offset, length) into `buf`
//   valid_bufs[c]: uint8 [nrows] or null
// Returns parsed row count or -1 on error.
int64_t dftpu_csv_parse_indexed(const char* buf, int64_t len, void* idx,
                                int has_header, int ncols,
                                const int32_t* dtypes, void** out_bufs,
                                uint8_t** valid_bufs, int num_threads) {
  if (idx == nullptr) return -1;
  return parse_with_index(buf, len, (const CsvIndex*)idx, has_header, ncols,
                          dtypes, out_bufs, valid_bufs, num_threads);
}

// Compatibility single-shot entry points (two full scans; prefer the
// index API above).
int64_t dftpu_csv_count_rows(const char* buf, int64_t len, int has_header) {
  CsvIndex idx;
  build_index(buf, len, 0, &idx);
  int64_t n = (int64_t)idx.row_starts.size();
  if (has_header && n > 0) n -= 1;
  return n;
}

int64_t dftpu_csv_parse(const char* buf, int64_t len, int has_header,
                        int ncols, const int32_t* dtypes, void** out_bufs,
                        uint8_t** valid_bufs, int num_threads) {
  CsvIndex idx;
  build_index(buf, len, num_threads, &idx);
  return parse_with_index(buf, len, &idx, has_header, ncols, dtypes, out_bufs,
                          valid_bufs, num_threads);
}

// Dictionary-encode a UTF8 column parsed to (offset, length) pairs:
// codes[r] gets the byte-order-sorted vocab code (UTF-8 byte order ==
// Unicode code-point order, matching Python str comparison); vocab_pairs
// gets (offset, length) per unique string in sorted order (caller
// allocates nrows*2 worst case). Returns the unique count. Replaces a
// per-row Python decode loop + np.unique over object strings (the 5M-row
// ingest hotspot). Parallel: per-thread local vocab + codes, then a
// sequential merge of the (small) local vocabs and a parallel remap.
int64_t dftpu_csv_dict_encode(const char* buf, const int64_t* pairs,
                              int64_t n, int32_t* codes,
                              int64_t* vocab_pairs) {
  int nt = resolve_threads(0, n / 65536);
  std::vector<int64_t> begin(nt + 1);
  for (int t = 0; t <= nt; t++) begin[t] = n * t / nt;

  std::vector<std::vector<std::string_view>> local_uniq(nt);
  {
    std::vector<std::thread> th;
    for (int t = 0; t < nt; t++)
      th.emplace_back([&, t] {
        std::unordered_map<std::string_view, int32_t> map;
        map.reserve(4096);
        auto& uniq = local_uniq[t];
        for (int64_t r = begin[t]; r < begin[t + 1]; r++) {
          std::string_view sv(buf + pairs[2 * r], (size_t)pairs[2 * r + 1]);
          auto it = map.find(sv);
          int32_t code;
          if (it == map.end()) {
            code = (int32_t)uniq.size();
            map.emplace(sv, code);
            uniq.push_back(sv);
          } else {
            code = it->second;
          }
          codes[r] = code;  // local code for now
        }
      });
    for (auto& x : th) x.join();
  }

  // merge local vocabs into the global map + global uniq list
  std::unordered_map<std::string_view, int32_t> global;
  std::vector<std::string_view> uniq;
  std::vector<std::vector<int32_t>> local_to_global(nt);
  for (int t = 0; t < nt; t++) {
    auto& l2g = local_to_global[t];
    l2g.resize(local_uniq[t].size());
    for (size_t i = 0; i < local_uniq[t].size(); i++) {
      std::string_view sv = local_uniq[t][i];
      auto it = global.find(sv);
      if (it == global.end()) {
        int32_t g = (int32_t)uniq.size();
        global.emplace(sv, g);
        uniq.push_back(sv);
        l2g[i] = g;
      } else {
        l2g[i] = it->second;
      }
    }
  }

  int64_t k = (int64_t)uniq.size();
  std::vector<int32_t> order((size_t)k);
  for (int64_t i = 0; i < k; i++) order[(size_t)i] = (int32_t)i;
  std::sort(order.begin(), order.end(),
            [&](int32_t a, int32_t b) { return uniq[(size_t)a] < uniq[(size_t)b]; });
  std::vector<int32_t> sorted_remap((size_t)k);
  for (int64_t i = 0; i < k; i++) sorted_remap[(size_t)order[(size_t)i]] = (int32_t)i;

  // parallel remap: local code -> global -> sorted
  {
    std::vector<std::thread> th;
    for (int t = 0; t < nt; t++)
      th.emplace_back([&, t] {
        const auto& l2g = local_to_global[t];
        for (int64_t r = begin[t]; r < begin[t + 1]; r++)
          codes[r] = sorted_remap[(size_t)l2g[(size_t)codes[r]]];
      });
    for (auto& x : th) x.join();
  }

  for (int64_t i = 0; i < k; i++) {
    std::string_view sv = uniq[(size_t)order[(size_t)i]];
    vocab_pairs[2 * i] = (int64_t)(sv.data() - buf);
    vocab_pairs[2 * i + 1] = (int64_t)sv.size();
  }
  return k;
}

}  // extern "C"
