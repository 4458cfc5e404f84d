// Native data-loading tier: CSV / SVMLight / IDX parsers.
//
// Role in the framework: the host-side record pipeline. The reference
// delegated record reading to the external Canova library (SURVEY L3) and
// its tensor backends to ND4J; this library is the native half of the
// HOST pipeline — parsing text/binary datasets at C++ speed so Python
// never tokenizes large training files line by line.  The PyTorch port's
// own copy of the JAX package's dataio.cpp (the two packages share no
// file), built with g++ on first use and exposed through ctypes
// (deeplearning4j_tpu_torch/native/__init__.py), with the Python parsers
// of datasets/fetchers.py where no compiler is available.
//
// C ABI: every reader returns a heap-allocated Table the caller copies out
// of and frees with table_free. On failure ok=0 and err holds a message.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

typedef struct {
  double* data;     // rows*cols feature matrix, row-major
  double* labels;   // rows label column (NAN when absent)
  int64_t rows;
  int64_t cols;
  int32_t ok;
  char err[256];
} Table;

static Table* table_alloc() {
  Table* t = (Table*)std::calloc(1, sizeof(Table));
  t->ok = 1;
  return t;
}

static Table* table_fail(Table* t, const char* msg) {
  std::snprintf(t->err, sizeof(t->err), "%s", msg);
  t->ok = 0;
  std::free(t->data);
  std::free(t->labels);
  t->data = t->labels = nullptr;
  return t;
}

void table_free(Table* t) {
  if (!t) return;
  std::free(t->data);
  std::free(t->labels);
  std::free(t);
}

static bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize((size_t)n);
  size_t got = n ? std::fread(&(*out)[0], 1, (size_t)n, f) : 0;
  std::fclose(f);
  return got == (size_t)n;
}

// ---- CSV -------------------------------------------------------------------

Table* csv_read(const char* path, int32_t skip_header, int32_t label_col) {
  Table* t = table_alloc();
  std::string buf;
  if (!read_file(path, &buf)) return table_fail(t, "cannot read file");

  std::vector<double> values;
  std::vector<double> labels;
  int64_t cols = -1;
  const char* p = buf.c_str();
  const char* end = p + buf.size();
  bool first_line = true;
  std::vector<double> row;
  while (p < end) {
    const char* eol = (const char*)std::memchr(p, '\n', (size_t)(end - p));
    if (!eol) eol = end;
    if (!(first_line && skip_header)) {
      row.clear();
      const char* q = p;
      while (q < eol) {
        char* next = nullptr;
        double v = std::strtod(q, &next);
        if (next == q) {  // skip junk until separator
          ++q;
          continue;
        }
        row.push_back(v);
        q = next;
        while (q < eol && (*q == ',' || *q == ' ' || *q == '\t' ||
                           *q == ';' || *q == '\r'))
          ++q;
      }
      if (!row.empty()) {
        if (cols < 0) cols = (int64_t)row.size();
        if ((int64_t)row.size() != cols)
          return table_fail(t, "ragged CSV row");
        int64_t lc = label_col < 0 ? cols + label_col : label_col;
        if (lc < 0 || lc >= cols)
          return table_fail(t, "label_col out of range");
        for (int64_t i = 0; i < cols; ++i) {
          if (i == lc)
            labels.push_back(row[(size_t)i]);
          else
            values.push_back(row[(size_t)i]);
        }
      }
    }
    first_line = false;
    p = eol + 1;
  }
  if (cols <= 0) return table_fail(t, "no rows parsed");
  t->rows = (int64_t)labels.size();
  t->cols = cols - 1;
  t->data = (double*)std::malloc(sizeof(double) * values.size());
  t->labels = (double*)std::malloc(sizeof(double) * labels.size());
  std::memcpy(t->data, values.data(), sizeof(double) * values.size());
  std::memcpy(t->labels, labels.data(), sizeof(double) * labels.size());
  return t;
}

// ---- SVMLight --------------------------------------------------------------

Table* svmlight_read(const char* path, int64_t num_features) {
  Table* t = table_alloc();
  std::string buf;
  if (!read_file(path, &buf)) return table_fail(t, "cannot read file");

  // pass 1: count rows + max index when num_features unset
  std::vector<double> labels;
  std::vector<std::vector<std::pair<int64_t, double>>> rows;
  const char* p = buf.c_str();
  const char* end = p + buf.size();
  int64_t max_idx = 0;
  while (p < end) {
    const char* eol = (const char*)std::memchr(p, '\n', (size_t)(end - p));
    if (!eol) eol = end;
    const char* hash = (const char*)std::memchr(p, '#', (size_t)(eol - p));
    const char* stop = hash ? hash : eol;
    const char* q = p;
    while (q < stop && (*q == ' ' || *q == '\t')) ++q;
    if (q < stop) {
      char* next = nullptr;
      double label = std::strtod(q, &next);
      if (next != q) {
        q = next;
        std::vector<std::pair<int64_t, double>> feats;
        while (q < stop) {
          while (q < stop && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
          if (q >= stop) break;
          // qid:/cost: meta tokens: index parse fails -> skip token
          char* ixe = nullptr;
          long long ix = std::strtoll(q, &ixe, 10);
          if (ixe == q || ixe >= stop || *ixe != ':') {
            while (q < stop && *q != ' ' && *q != '\t') ++q;
            continue;
          }
          q = ixe + 1;
          char* ve = nullptr;
          double v = std::strtod(q, &ve);
          if (ve == q) {
            while (q < stop && *q != ' ' && *q != '\t') ++q;
            continue;
          }
          q = ve;
          feats.emplace_back((int64_t)ix, v);
          if (ix > max_idx) max_idx = ix;
        }
        labels.push_back(label);
        rows.push_back(std::move(feats));
      }
    }
    p = eol + 1;
  }
  if (rows.empty()) return table_fail(t, "no rows parsed");
  int64_t nf = num_features > 0 ? num_features : max_idx;
  if (nf <= 0) return table_fail(t, "could not infer feature count");
  t->rows = (int64_t)rows.size();
  t->cols = nf;
  t->data = (double*)std::calloc((size_t)(t->rows * nf), sizeof(double));
  t->labels = (double*)std::malloc(sizeof(double) * labels.size());
  std::memcpy(t->labels, labels.data(), sizeof(double) * labels.size());
  for (int64_t r = 0; r < t->rows; ++r) {
    for (auto& kv : rows[(size_t)r]) {
      if (kv.first >= 1 && kv.first <= nf)
        t->data[r * nf + (kv.first - 1)] = kv.second;  // 1-indexed
    }
  }
  return t;
}

// ---- IDX (MNIST) -----------------------------------------------------------

static uint32_t be32(const unsigned char* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

Table* idx_read(const char* path) {
  Table* t = table_alloc();
  std::string buf;
  if (!read_file(path, &buf)) return table_fail(t, "cannot read file");
  if (buf.size() < 4) return table_fail(t, "truncated IDX header");
  const unsigned char* p = (const unsigned char*)buf.data();
  uint32_t magic = be32(p);
  uint32_t ndim = magic & 0xff;
  if ((magic >> 8) != 0x000008 || ndim < 1 || ndim > 3)
    return table_fail(t, "unsupported IDX magic (want unsigned-byte 1-3d)");
  if (buf.size() < 4 + 4 * ndim) return table_fail(t, "truncated IDX dims");
  int64_t dims[3] = {1, 1, 1};
  for (uint32_t i = 0; i < ndim; ++i) dims[i] = (int64_t)be32(p + 4 + 4 * i);
  int64_t rows = dims[0];
  int64_t cols = dims[1] * dims[2];
  size_t need = (size_t)(rows * cols);
  size_t off = 4 + 4 * ndim;
  if (buf.size() - off < need) return table_fail(t, "truncated IDX payload");
  t->rows = rows;
  t->cols = cols;
  t->data = (double*)std::malloc(sizeof(double) * need);
  const unsigned char* d = p + off;
  for (size_t i = 0; i < need; ++i) t->data[i] = (double)d[i];
  t->labels = nullptr;
  return t;
}

}  // extern "C"
