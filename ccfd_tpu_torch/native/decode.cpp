// Native hot-path: CSV transaction decode + batch assembly.
//
// The port's copy of ccfd_tpu/native/decode.cpp, unchanged in behavior: the
// router's CSV decode and the REST handler's payload decode run through it.
//
// The reference's per-message hop runs feature extraction inside a JVM Camel
// route (reference deploy/router.yaml, README.md:549); our router instead
// assembles one (B, 30) float32 matrix per micro-batch and the Python
// dict-walk is the slowest host-side stage at high throughput. This decoder
// parses newline-separated CSV transaction rows straight into the caller's
// float32 buffer — one pass, no allocations, no Python per-field overhead.
//
// Exposed via ctypes (see ccfd_tpu_torch/native/__init__.py); the plain numpy
// versions there implement identical semantics, asserted by tests.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse up to max_rows CSV rows of exactly n_features floats each from
// buf[0..len) into out (row-major, max_rows * n_features floats).
// Rows with parse errors or the wrong field count are zero-filled and
// counted in *bad_rows. Returns the number of rows consumed.
int ccfd_decode_csv(const char* buf, size_t len, float* out, int max_rows,
                    int n_features, int* bad_rows) {
  int rows = 0;
  int bad = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end && rows < max_rows) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (line_end == nullptr) line_end = end;
    float* row_out = out + static_cast<size_t>(rows) * n_features;
    int field = 0;
    bool ok = true;
    const char* q = p;
    while (q < line_end && field < n_features) {
      char* next = nullptr;
      float v = strtof(q, &next);
      if (next == q) {  // no parse progress
        ok = false;
        break;
      }
      row_out[field++] = v;
      q = next;
      if (q < line_end) {
        if (*q == ',') {
          ++q;
        } else if (*q != '\n' && *q != '\r') {
          ok = false;
          break;
        }
      }
    }
    // trailing \r (CRLF) is fine; any other leftover content means the row
    // had extra fields — reject it like the numpy fallback does
    while (q < line_end && *q == '\r') ++q;
    if (!ok || field != n_features || q != line_end) {
      memset(row_out, 0, sizeof(float) * n_features);
      ++bad;
    }
    ++rows;
    p = (line_end < end) ? line_end + 1 : end;
  }
  if (bad_rows != nullptr) *bad_rows = bad;
  return rows;
}

// Batch assembly: scatter variable-count rows into a zero-padded bucket.
// src is n_rows * n_features floats; dst is bucket_rows * n_features and is
// fully zeroed first (padding rows score as zeros).
void ccfd_pad_batch(const float* src, int n_rows, int n_features, float* dst,
                    int bucket_rows) {
  const size_t row_bytes = sizeof(float) * static_cast<size_t>(n_features);
  memset(dst, 0, row_bytes * static_cast<size_t>(bucket_rows));
  const int copy = n_rows < bucket_rows ? n_rows : bucket_rows;
  memcpy(dst, src, row_bytes * static_cast<size_t>(copy));
}

// Seldon predict payload decode: parse the numeric matrix out of
//   {"data": {"ndarray": [[f, f, ...], [f, ...]], ...}, ...}
// straight into the caller's float32 buffer — the REST hot path's JSON
// cost without a JSON library (reference request shape README.md:454-459).
//
// Deliberately narrow: ONLY the common canonical-order payload qualifies.
// Returns the row count (>= 0) on success, writing row widths' max to
// *width_out; bails with -1 (caller falls back to the Python JSON path) on
// anything unusual: a "names" key anywhere (caller must remap columns),
// nested objects/strings inside ndarray, no ndarray key, rows wider than
// n_features, or more than max_rows rows. Short rows zero-pad (same
// semantics as the Python path).
int ccfd_decode_ndarray(const char* buf, size_t len, float* out, int max_rows,
                        int n_features, int* width_out) {
  const char* end = buf + len;
  // a "names" key means column remapping — Python path owns that
  for (const char* s = buf; (s = static_cast<const char*>(
                                 memchr(s, '"', end - s))) != nullptr;) {
    if (end - s >= 7 && memcmp(s, "\"names\"", 7) == 0) return -1;
    ++s;
  }
  // require the Seldon "data" wrapper, then "ndarray" after it — a bare
  // {"ndarray": ...} body is NOT the contract and must 400 via the Python
  // path, exactly as the JSON route always did
  const char* data_key = nullptr;
  for (const char* s = buf; (s = static_cast<const char*>(
                                 memchr(s, '"', end - s))) != nullptr;) {
    if (end - s >= 6 && memcmp(s, "\"data\"", 6) == 0) { data_key = s + 6; break; }
    ++s;
  }
  if (data_key == nullptr) return -1;
  const char* nd = nullptr;
  for (const char* s = data_key; (s = static_cast<const char*>(
                                     memchr(s, '"', end - s))) != nullptr;) {
    if (end - s >= 9 && memcmp(s, "\"ndarray\"", 9) == 0) { nd = s + 9; break; }
    ++s;
  }
  if (nd == nullptr) return -1;
  const char* p = nd;
  while (p < end && (*p == ' ' || *p == ':' || *p == '\t' || *p == '\n' ||
                     *p == '\r'))
    ++p;
  if (p >= end || *p != '[') return -1;
  ++p;  // inside the outer array
  int rows = 0;
  int max_width = 0;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == ',' || *p == '\t' || *p == '\n' ||
                       *p == '\r'))
      ++p;
    if (p < end && *p == ']') {  // matrix closed: the tail must close the
      ++p;                       // enclosing objects — a truncated body is
      int depth = 2;             // invalid JSON and must 400, not score
      while (p < end) {
        char c = *p++;
        if (c == '}') {
          --depth;
        } else if (c != ' ' && c != '\t' && c != '\n' && c != '\r' &&
                   c != ',') {
          return -1;  // trailing keys/values: Python path owns them
        }
      }
      if (depth != 0) return -1;  // truncated or over-closed wrappers
      *width_out = max_width;
      return rows;
    }
    if (p >= end || *p != '[') return -1;
    ++p;  // inside a row
    if (rows >= max_rows) return -1;
    float* row_out = out + static_cast<size_t>(rows) * n_features;
    memset(row_out, 0, sizeof(float) * static_cast<size_t>(n_features));
    int col = 0;
    while (p < end) {
      while (p < end && (*p == ' ' || *p == ',' || *p == '\t' || *p == '\n' ||
                         *p == '\r'))
        ++p;
      if (p < end && *p == ']') { ++p; break; }  // row done
      char* next = nullptr;
      float v = strtof(p, &next);
      if (next == p) return -1;  // non-numeric cell: Python path owns it
      if (col >= n_features) return -1;  // wider than the schema
      row_out[col++] = v;
      p = next;
    }
    if (col > max_width) max_width = col;
    ++rows;
  }
  return -1;  // ran off the end without closing the outer array
}

}  // extern "C"
