// featload: native feature-file loader for flashvtg_tpu_torch.
//
// The reference preloads every sample's .npy/.npz feature file into RAM
// through numpy in a Python loop (start_end_dataset.py:153-218) — for
// TACoS/Charades-scale datasets that is minutes of interpreter overhead.
// This library parses .npy (v1/v2) and .npz (zip, stored or deflated)
// directly, optionally fusing the row-wise l2 normalization
// (basic_utils.l2_normalize_np_array: x / (||x|| + 1e-5)), and exposes a
// small C ABI consumed via ctypes (flashvtg_tpu_torch/runtime/__init__.py).
//
// Supported payloads: little-endian f4/f8 C-order arrays of rank 1 or 2
// (f8 converted to f4 on read) — exactly what the feature extractors emit.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Array {
  std::vector<float> data;
  long rows = 0;
  long cols = 0;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(n);
  bool ok = n == 0 || std::fread(out->data(), 1, n, f) == (size_t)n;
  std::fclose(f);
  return ok;
}

// --- .npy ------------------------------------------------------------------

bool parse_npy(const uint8_t* buf, size_t len, Array* out) {
  if (len < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  int major = buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_off = 10;
  } else {
    if (len < 12) return false;
    header_len = buf[8] | (buf[9] << 8) | (buf[10] << 16) |
                 ((size_t)buf[11] << 24);
    header_off = 12;
  }
  if (header_off + header_len > len) return false;
  std::string header((const char*)buf + header_off, header_len);

  auto find_val = [&](const std::string& key) -> std::string {
    size_t p = header.find("'" + key + "'");
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    if (p == std::string::npos) return "";
    return header.substr(p + 1);
  };

  std::string descr = find_val("descr");
  bool f4 = descr.find("f4") != std::string::npos;
  bool f8 = descr.find("f8") != std::string::npos;
  if (!f4 && !f8) return false;
  if (descr.find('>') != std::string::npos) return false;  // big-endian
  if (find_val("fortran_order").find("True") != std::string::npos)
    return false;

  std::string shape = find_val("shape");
  size_t l = shape.find('(');
  size_t r = shape.find(')');
  if (l == std::string::npos || r == std::string::npos) return false;
  std::string dims = shape.substr(l + 1, r - l - 1);
  long rows = 0, cols = 1;
  int ndim = 0;
  const char* p = dims.c_str();
  while (*p) {
    while (*p == ' ' || *p == ',') p++;
    if (!*p) break;
    char* end;
    long v = std::strtol(p, &end, 10);
    if (end == p) break;
    if (ndim == 0) rows = v;
    else if (ndim == 1) cols = v;
    else return false;  // rank > 2 unsupported
    ndim++;
    p = end;
  }
  if (ndim == 0) return false;
  if (ndim == 1) {  // rank-1 (n,) -> one row of n features
    cols = rows;
    rows = 1;
  }

  size_t elem = f4 ? 4 : 8;
  size_t need = (size_t)rows * cols * elem;
  size_t data_off = header_off + header_len;
  if (data_off + need > len) return false;

  out->rows = rows;
  out->cols = cols;
  out->data.resize((size_t)rows * cols);
  const uint8_t* src = buf + data_off;
  if (f4) {
    std::memcpy(out->data.data(), src, need);
  } else {
    const double* d = (const double*)src;
    for (size_t i = 0; i < (size_t)rows * cols; i++)
      out->data[i] = (float)d[i];
  }
  return true;
}

// --- .npz (zip) ------------------------------------------------------------

bool find_zip_entry(const std::vector<uint8_t>& zip, const std::string& name,
                    std::vector<uint8_t>* out) {
  // locate End Of Central Directory
  if (zip.size() < 22) return false;
  size_t eocd = std::string::npos;
  for (size_t i = zip.size() - 22; ; i--) {
    if (zip[i] == 0x50 && zip[i + 1] == 0x4b && zip[i + 2] == 0x05 &&
        zip[i + 3] == 0x06) {
      eocd = i;
      break;
    }
    if (i == 0 || zip.size() - i > 22 + 65536) break;
  }
  if (eocd == std::string::npos) return false;
  auto rd16 = [&](size_t o) { return zip[o] | (zip[o + 1] << 8); };
  auto rd32 = [&](size_t o) {
    return (uint32_t)zip[o] | ((uint32_t)zip[o + 1] << 8) |
           ((uint32_t)zip[o + 2] << 16) | ((uint32_t)zip[o + 3] << 24);
  };
  uint16_t n_entries = rd16(eocd + 10);
  size_t cd = rd32(eocd + 16);

  for (int e = 0; e < n_entries; e++) {
    if (cd + 46 > zip.size() || rd32(cd) != 0x02014b50) return false;
    uint16_t method = rd16(cd + 10);
    uint32_t csize = rd32(cd + 20);
    uint32_t usize = rd32(cd + 24);
    uint16_t nlen = rd16(cd + 28);
    uint16_t xlen = rd16(cd + 30);
    uint16_t clen = rd16(cd + 32);
    uint32_t lho = rd32(cd + 42);
    std::string ename((const char*)&zip[cd + 46], nlen);
    if (ename == name) {
      // local header: sizes of name/extra may differ from central dir
      if (lho + 30 > zip.size() || rd32(lho) != 0x04034b50) return false;
      uint16_t lnlen = rd16(lho + 26);
      uint16_t lxlen = rd16(lho + 28);
      size_t doff = lho + 30 + lnlen + lxlen;
      if (doff + csize > zip.size()) return false;
      if (method == 0) {
        out->assign(zip.begin() + doff, zip.begin() + doff + csize);
        return true;
      }
      if (method == 8) {
        out->resize(usize);
        z_stream zs;
        std::memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;
        zs.next_in = const_cast<uint8_t*>(&zip[doff]);
        zs.avail_in = csize;
        zs.next_out = out->data();
        zs.avail_out = usize;
        int rc = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        return rc == Z_STREAM_END;
      }
      return false;
    }
    cd += 46 + nlen + xlen + clen;
  }
  return false;
}

void l2_normalize_rows(Array* a) {
  for (long r = 0; r < a->rows; r++) {
    float* row = a->data.data() + (size_t)r * a->cols;
    double s = 0;
    for (long c = 0; c < a->cols; c++) s += (double)row[c] * row[c];
    float inv = 1.0f / ((float)std::sqrt(s) + 1e-5f);
    for (long c = 0; c < a->cols; c++) row[c] *= inv;
  }
}

bool load_any(const char* path, const char* key, Array* arr) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return false;
  if (buf.size() >= 4 && buf[0] == 0x50 && buf[1] == 0x4b) {  // zip -> npz
    std::vector<uint8_t> entry;
    std::string name = std::string(key) + ".npy";
    if (!find_zip_entry(buf, name, &entry)) return false;
    return parse_npy(entry.data(), entry.size(), arr);
  }
  return parse_npy(buf.data(), buf.size(), arr);
}

// --- zero-ish-copy single-call path ---------------------------------------

struct NpyView {
  const uint8_t* data = nullptr;  // payload start
  long rows = 0;
  long cols = 0;
  bool f8 = false;
};

bool parse_npy_header(const uint8_t* buf, size_t len, NpyView* v) {
  if (len < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  int major = buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_off = 10;
  } else {
    if (len < 12) return false;
    header_len = buf[8] | (buf[9] << 8) | (buf[10] << 16) |
                 ((size_t)buf[11] << 24);
    header_off = 12;
  }
  if (header_off + header_len > len) return false;
  std::string header((const char*)buf + header_off, header_len);
  auto find_val = [&](const std::string& key) -> std::string {
    size_t p = header.find("'" + key + "'");
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    if (p == std::string::npos) return "";
    return header.substr(p + 1);
  };
  std::string descr = find_val("descr");
  bool f4 = descr.find("f4") != std::string::npos;
  bool f8 = descr.find("f8") != std::string::npos;
  if (!f4 && !f8) return false;
  if (descr.find('>') != std::string::npos) return false;
  if (find_val("fortran_order").find("True") != std::string::npos)
    return false;
  std::string shape = find_val("shape");
  size_t l = shape.find('(');
  size_t r = shape.find(')');
  if (l == std::string::npos || r == std::string::npos) return false;
  std::string dims = shape.substr(l + 1, r - l - 1);
  long rows = 0, cols = 1;
  int ndim = 0;
  const char* p = dims.c_str();
  while (*p) {
    while (*p == ' ' || *p == ',') p++;
    if (!*p) break;
    char* end;
    long val = std::strtol(p, &end, 10);
    if (end == p) break;
    if (ndim == 0) rows = val;
    else if (ndim == 1) cols = val;
    else return false;
    ndim++;
    p = end;
  }
  if (ndim == 0) return false;
  if (ndim == 1) { cols = rows; rows = 1; }
  size_t elem = f4 ? 4 : 8;
  if (header_off + header_len + (size_t)rows * cols * elem > len) return false;
  v->data = buf + header_off + header_len;
  v->rows = rows;
  v->cols = cols;
  v->f8 = f8;
  return true;
}

}  // namespace

extern "C" {

// Single-call load: reads the file once, resolves the (stored or deflated)
// payload, copies at most `max_rows` rows into a malloc'd float buffer with
// optional fused l2 normalization. Returns a pointer the caller frees with
// fl_free; rows/cols are outputs. nullptr on any failure.
float* fl_load(const char* path, const char* key, long max_rows, int l2norm,
               long* rows_out, long* cols_out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return nullptr;
  std::vector<uint8_t> scratch;
  const uint8_t* npy = nullptr;
  size_t npy_len = 0;
  if (buf.size() >= 4 && buf[0] == 0x50 && buf[1] == 0x4b) {
    if (!find_zip_entry(buf, std::string(key) + ".npy", &scratch))
      return nullptr;
    npy = scratch.data();
    npy_len = scratch.size();
  } else {
    npy = buf.data();
    npy_len = buf.size();
  }
  NpyView v;
  if (!parse_npy_header(npy, npy_len, &v)) return nullptr;
  long rows = v.rows;
  if (max_rows > 0 && rows > max_rows) rows = max_rows;
  float* out = (float*)std::malloc((size_t)rows * v.cols * sizeof(float));
  if (!out) return nullptr;
  if (!v.f8) {
    std::memcpy(out, v.data, (size_t)rows * v.cols * sizeof(float));
  } else {
    const double* d = (const double*)v.data;
    for (size_t i = 0; i < (size_t)rows * v.cols; i++) out[i] = (float)d[i];
  }
  if (l2norm) {
    for (long r = 0; r < rows; r++) {
      float* row = out + (size_t)r * v.cols;
      double s = 0;
      for (long c = 0; c < v.cols; c++) s += (double)row[c] * row[c];
      float inv = 1.0f / ((float)std::sqrt(s) + 1e-5f);
      for (long c = 0; c < v.cols; c++) row[c] *= inv;
    }
  }
  *rows_out = rows;
  *cols_out = v.cols;
  return out;
}

void fl_free(float* p) { std::free(p); }

// Legacy two-phase API (kept for ABI compatibility).
int fl_info(const char* path, const char* key, long* rows, long* cols) {
  Array arr;
  if (!load_any(path, key, &arr)) return -1;
  *rows = arr.rows;
  *cols = arr.cols;
  return 0;
}

long fl_read(const char* path, const char* key, float* out, long max_rows,
             int l2norm) {
  Array arr;
  if (!load_any(path, key, &arr)) return -1;
  long rows = arr.rows;
  if (max_rows > 0 && rows > max_rows) rows = max_rows;
  arr.rows = rows;
  arr.data.resize((size_t)rows * arr.cols);
  if (l2norm) l2_normalize_rows(&arr);
  std::memcpy(out, arr.data.data(), (size_t)rows * arr.cols * sizeof(float));
  return rows;
}

}  // extern "C"
