// Fast host-side data ingest for spmf_tpu_torch (a copy of spmf_tpu's
// data/_native/fast_io.cpp: the port imports nothing of the JAX package).
//
// The reference ingests CSVs row-by-row through tf.data's python/graph CSV
// parser (reference: bin/factorize_csv.py:79-87) and scRNA matrices through
// scanpy (bin/preprocess_scrnaseq_counts.py:26-30). For production-scale
// count matrices (50k cells x 20k genes) the host parse is the pipeline
// bottleneck; this is a single-pass, zero-allocation-per-token C++ parser
// exposed through a plain C ABI (consumed via ctypes — no pybind11 in the
// image).
//
// Built on first use by spmf_tpu_torch/data/native.py:
//   g++ -O3 -shared -fPIC fast_io.cpp -o spmf_tpu_torch/_build/libfastio_<hash>.so
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Buffer {
  std::vector<double> values;
  std::vector<int64_t> coo_rows;
  std::vector<int64_t> coo_cols;
  int64_t n_rows = 0;
  int64_t n_cols = 0;
};

// strtod-based token scan over a whole file slurped into memory.
bool read_file(const char* path, std::vector<char>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(size) + 1);
  size_t got = std::fread(out.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  out[got] = '\0';
  out.resize(got + 1);
  return true;
}

}  // namespace

extern "C" {

// Parse a dense CSV of doubles. Returns an opaque handle; query shape with
// csv_rows/csv_cols, copy data out with csv_copy, free with csv_free.
void* csv_parse(const char* path) {
  std::vector<char> text;
  if (!read_file(path, text)) return nullptr;
  auto* buf = new Buffer();
  char* p = text.data();
  char* end = p + text.size() - 1;
  int64_t cols_this_row = 0;
  while (p < end) {
    char c = *p;
    if (c == '\n') {  // handle row boundary BEFORE strtod (it eats '\n')
      if (cols_this_row > 0) {
        if (buf->n_cols == 0) buf->n_cols = cols_this_row;
        if (cols_this_row != buf->n_cols) { delete buf; return nullptr; }
        buf->n_rows++;
        cols_this_row = 0;
      }
      ++p;
      continue;
    }
    if (c == ',' || c == ' ' || c == '\t' || c == '\r') { ++p; continue; }
    char* next = nullptr;
    double v = std::strtod(p, &next);
    if (next == p) {
      // A token that is not a number (e.g. a header row "gene1,gene2")
      // must fail the whole parse, triggering the numpy fallback (which
      // raises) — skipping bytes here would silently fabricate data.
      delete buf;
      return nullptr;
    }
    buf->values.push_back(v);
    cols_this_row++;
    p = next;
  }
  if (cols_this_row > 0) {  // file without trailing newline
    if (buf->n_cols == 0) buf->n_cols = cols_this_row;
    if (cols_this_row != buf->n_cols) { delete buf; return nullptr; }
    buf->n_rows++;
  }
  return buf;
}

int64_t io_rows(void* h) { return h ? static_cast<Buffer*>(h)->n_rows : -1; }
int64_t io_cols(void* h) { return h ? static_cast<Buffer*>(h)->n_cols : -1; }
int64_t io_nnz(void* h) {
  return h ? static_cast<int64_t>(static_cast<Buffer*>(h)->values.size()) : -1;
}

void io_copy_values(void* h, double* out) {
  auto* buf = static_cast<Buffer*>(h);
  std::memcpy(out, buf->values.data(), buf->values.size() * sizeof(double));
}

void io_copy_coords(void* h, int64_t* rows, int64_t* cols) {
  auto* buf = static_cast<Buffer*>(h);
  std::memcpy(rows, buf->coo_rows.data(), buf->coo_rows.size() * sizeof(int64_t));
  std::memcpy(cols, buf->coo_cols.data(), buf->coo_cols.size() * sizeof(int64_t));
}

void io_free(void* h) { delete static_cast<Buffer*>(h); }

// Parse a MatrixMarket coordinate file (the 10x `matrix.mtx` format,
// 1-based indices) into COO triplets.
void* mtx_parse(const char* path) {
  std::vector<char> text;
  if (!read_file(path, text)) return nullptr;
  auto* buf = new Buffer();
  char* p = text.data();
  char* end = p + text.size() - 1;
  // Validate the MatrixMarket banner: only 'coordinate real|integer
  // general' is supported — 'pattern' files have no value column and would
  // silently corrupt the triplet scan. Anything else falls back to
  // scipy.io.mmread on the Python side.
  if (p < end && *p == '%') {
    char* eol = p;
    while (eol < end && *eol != '\n') ++eol;
    std::string banner(p, eol);
    if (banner.rfind("%%MatrixMarket", 0) == 0) {
      bool coord = banner.find("coordinate") != std::string::npos;
      bool numeric = banner.find("real") != std::string::npos ||
                     banner.find("integer") != std::string::npos;
      bool general = banner.find("general") != std::string::npos;
      if (!(coord && numeric && general)) { delete buf; return nullptr; }
    }
  }
  // skip comment lines
  while (p < end && *p == '%') {
    while (p < end && *p != '\n') ++p;
    ++p;
  }
  // header: rows cols nnz
  char* next = nullptr;
  buf->n_rows = std::strtoll(p, &next, 10); p = next;
  buf->n_cols = std::strtoll(p, &next, 10); p = next;
  int64_t nnz = std::strtoll(p, &next, 10); p = next;
  buf->values.reserve(nnz);
  buf->coo_rows.reserve(nnz);
  buf->coo_cols.reserve(nnz);
  while (p < end) {
    int64_t r = std::strtoll(p, &next, 10);
    if (next == p) { ++p; continue; }
    p = next;
    int64_t c = std::strtoll(p, &next, 10); p = next;
    double v = std::strtod(p, &next); p = next;
    buf->coo_rows.push_back(r - 1);
    buf->coo_cols.push_back(c - 1);
    buf->values.push_back(v);
  }
  // A truncated file or a mis-parsed value column shows up as a triplet
  // count that disagrees with the header nnz.
  if (static_cast<int64_t>(buf->values.size()) != nnz) {
    delete buf;
    return nullptr;
  }
  return buf;
}

}  // extern "C"
