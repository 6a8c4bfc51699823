// Native CNTK-text-format (CTF) parser: file -> dense float32 matrices.
//
// TPU-native equivalent of the reference's native text reader: the external
// `cntk` binary parses the exported CTF file (`|label v ... |features i:v ...`
// lines, written by cntk-train/src/main/scala/DataConversion.scala:86-96)
// in C++ inside its reader block (BrainscriptBuilder.scala:94-101). Here the
// same format parses natively into host buffers ready for device feed.
//
// The port's own copy of mmlspark_tpu/ops/native/ctf.cpp, built by
// mmlspark_tpu_torch/ops/native_build.py into build/torch_native/.
//
// C ABI (consumed via ctypes from mmlspark_tpu_torch/data/ctf.py):
//   int mml_parse_ctf(const char* path,
//                     const char* label_name, const char* feat_name,
//                     int feature_dim,          // >0 to densify sparse feats
//                     double** labels_out, int* label_width,
//                     double** feats_out, int* feat_width, long* rows);
//     returns 0 on success (caller owns both buffers, free with
//     mml_ctf_free); nonzero on any malformed/unsupported input, in which
//     case the caller falls back to the pure-Python parser for a precise
//     error message.
//   void mml_ctf_free(float* p);
//   const char* mml_ctf_version();

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kIoError = 1;
constexpr int kBadField = 2;     // missing/sparse-label/unsupported form
constexpr int kRaggedRow = 3;    // row width differs from first row
constexpr int kBadNumber = 4;

struct Field {
  const char* begin = nullptr;
  const char* end = nullptr;
};

// find "|<name> values..." within [line, line_end); values exclude the name.
// Mirrors the Python fallback's dict semantics exactly: the field name runs
// to the first SPACE (' ' only — a tab stays part of the name, like
// str.partition(" ")), and when a name repeats the LAST occurrence wins.
bool find_field(const char* line, const char* line_end,
                const char* name, size_t name_len, Field* out) {
  bool found = false;
  const char* p = line;
  while (p < line_end) {
    const char* bar = static_cast<const char*>(
        memchr(p, '|', static_cast<size_t>(line_end - p)));
    if (!bar) break;
    const char* fname = bar + 1;
    const char* fend = fname;
    while (fend < line_end && *fend != ' ' && *fend != '|') ++fend;
    const char* vend = static_cast<const char*>(
        memchr(fend, '|', static_cast<size_t>(line_end - fend)));
    if (!vend) vend = line_end;
    if (static_cast<size_t>(fend - fname) == name_len &&
        memcmp(fname, name, name_len) == 0) {
      out->begin = fend;
      out->end = vend;
      found = true;  // keep scanning: last duplicate wins
    }
    p = vend;
  }
  return found;
}

// parse "v v v" (dense) or "i:v i:v" (sparse, dim>0) into row; returns
// parsed width for dense, dim for sparse, or -1 on error. An empty field
// with dim>0 yields dim zeros (an all-zero sparse vector — matches the
// Python parser's _parse_values("") semantics).
int parse_values(const Field& f, int dim, std::vector<double>* row) {
  const char* p = f.begin;
  bool sparse = false;
  bool first = true;
  size_t start = row->size();
  while (p < f.end) {
    while (p < f.end && isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= f.end) break;
    char* next = nullptr;
    if (first) {
      // detect sparse form from the first token
      const char* q = p;
      while (q < f.end && !isspace(static_cast<unsigned char>(*q))) {
        if (*q == ':') { sparse = true; break; }
        ++q;
      }
      if (sparse) {
        if (dim <= 0) return -1;  // sparse without a declared dim
        row->resize(start + static_cast<size_t>(dim), 0.0);
      }
      first = false;
    }
    if (sparse) {
      long idx = strtol(p, &next, 10);
      if (next == p || *next != ':' || idx < 0 || idx >= dim) return -1;
      p = next + 1;
      double v = strtod(p, &next);
      if (next == p) return -1;
      (*row)[start + static_cast<size_t>(idx)] = v;
      p = next;
    } else {
      double v = strtod(p, &next);
      if (next == p) return -1;
      row->push_back(v);
      p = next;
    }
  }
  if (row->size() == start && dim > 0) {
    row->resize(start + static_cast<size_t>(dim), 0.0);
  }
  return static_cast<int>(row->size() - start);
}

double* to_owned(const std::vector<double>& v) {
  size_t bytes = (v.empty() ? 1 : v.size()) * sizeof(double);
  double* out = static_cast<double*>(malloc(bytes));
  if (out && !v.empty()) memcpy(out, v.data(), v.size() * sizeof(double));
  return out;
}

}  // namespace

extern "C" {

int mml_parse_ctf(const char* path, const char* label_name,
                  const char* feat_name, int feature_dim,
                  double** labels_out, int* label_width,
                  double** feats_out, int* feat_width, long* rows_out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return kIoError;
  std::string data;
  char buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), fp)) > 0) data.append(buf, n);
  bool read_err = ferror(fp) != 0;
  fclose(fp);
  if (read_err) return kIoError;

  const size_t lname_len = strlen(label_name);
  const size_t fname_len = strlen(feat_name);
  std::vector<double> labels, feats;
  int lw = -1, fw = -1;
  long rows = 0;

  const char* p = data.data();
  const char* end = p + data.size();
  while (p < end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    // skip blank lines
    const char* q = p;
    while (q < line_end && isspace(static_cast<unsigned char>(*q))) ++q;
    if (q < line_end) {
      Field lf, ff;
      if (!find_field(p, line_end, label_name, lname_len, &lf) ||
          !find_field(p, line_end, feat_name, fname_len, &ff)) {
        return kBadField;
      }
      // labels: dense only in the native fast path (the reference always
      // exports dense labels, DataConversion.scala:86-96)
      int got = parse_values(lf, -1, &labels);
      if (got < 0) return kBadField;
      if (lw == -1) lw = got;
      else if (got != lw) return kRaggedRow;
      got = parse_values(ff, feature_dim, &feats);
      if (got < 0) return kBadNumber;
      if (fw == -1) fw = got;
      else if (got != fw) return kRaggedRow;
      ++rows;
    }
    p = line_end + 1;
  }
  if (rows == 0) {
    // empty file: zero rows with unknown widths
    lw = 1;
    fw = feature_dim > 0 ? feature_dim : 0;
  } else if (lw <= 0 || fw <= 0) {
    // rows exist but some field never produced values (e.g. dense-empty
    // without a declared dim) — let the Python parser report it
    return kBadField;
  }
  *labels_out = to_owned(labels);
  *feats_out = to_owned(feats);
  if (!*labels_out || !*feats_out) {
    free(*labels_out);
    free(*feats_out);
    return kIoError;
  }
  *label_width = lw;
  *feat_width = fw;
  *rows_out = rows;
  return kOk;
}

void mml_ctf_free(double* p) { free(p); }

const char* mml_ctf_version() { return "mml-ctf-2"; }

}  // extern "C"
