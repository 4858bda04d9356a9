// Native host I/O for the range-image data path of tulip_tpu_torch.
//
// A small C library (ctypes-bridged, tulip_tpu_torch/data/native.py) that
//   1. parses .npy v1/v2 headers and reads the (H, W, 2) float32
//      range+intensity maps the ETL writes (channel 0 only, as npy_loader
//      does, reference tulip/util/datasets.py:175-179), and
//   2. fuses the dataset builders' transform chain (scale -> range gate ->
//      row/col downsample -> log1p) into the one read pass, writing straight
//      into a caller-owned batch buffer from a pthread pool.
//
// The same arithmetic and C interface as tulip_tpu/data/native/loader.cpp.
// A failed read returns a non-zero status; the Python side raises on it.
//
// Build: g++ -O3 -shared -fPIC -o libtulip_io.so loader.cpp -lpthread

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <pthread.h>

#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal .npy reader (v1.0/v2.0, little-endian '<f4', C-order)
// ---------------------------------------------------------------------------

struct NpyInfo {
  long h = 0, w = 0, c = 1;
  long payload_offset = 0;
};

bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->payload_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
    info->payload_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;
  if (header.find("'<f4'") == std::string::npos &&
      header.find("'|f4'") == std::string::npos)
    return false;  // only little-endian float32
  if (header.find("'fortran_order': True") != std::string::npos) return false;
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t lp = header.find('(', sp);
  size_t rp = header.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) return false;
  std::string shape = header.substr(lp + 1, rp - lp - 1);
  long dims[3] = {0, 0, 1};
  int nd = 0;
  const char* s = shape.c_str();
  while (*s && nd < 3) {
    while (*s == ' ' || *s == ',') ++s;
    if (*s < '0' || *s > '9') break;
    dims[nd++] = strtol(s, const_cast<char**>(&s), 10);
  }
  if (nd < 2) return false;
  info->h = dims[0];
  info->w = dims[1];
  info->c = nd >= 3 ? dims[2] : 1;
  return true;
}

struct Task {
  const char* path;
  // transform parameters (fused chain; see datasets.py builders)
  float scale;        // 1/max_range
  float min_r;        // gate lo (post-scale); <0 disables the gate
  float max_r;        // gate hi
  int log1p;          // apply log1p
  int row_start, row_stride;  // row subsample (stride 0 = keep all rows)
  int col_stride;             // col subsample (0/1 = keep all cols)
  // output
  long out_h, out_w;
  float* out;         // (out_h, out_w), row-major
  int status;         // 0 ok
};

void run_task(Task* t) {
  t->status = 1;
  FILE* f = fopen(t->path, "rb");
  if (!f) return;
  NpyInfo info;
  if (!parse_npy_header(f, &info)) { fclose(f); return; }
  const long rs = t->row_stride > 0 ? t->row_stride : 1;
  const long cs = t->col_stride > 1 ? t->col_stride : 1;
  const long r0 = t->row_stride > 0 ? t->row_start : 0;
  if ((info.h - r0 + rs - 1) / rs < t->out_h ||
      (info.w + cs - 1) / cs < t->out_w) { fclose(f); return; }

  // One bulk read of the needed row span (strided rows are skipped in
  // memory: one sequential read instead of a seek and a read per row)
  const long row_elems = (long)info.w * info.c;
  const long row_bytes = row_elems * 4;
  const long span_rows = (t->out_h - 1) * rs + 1;
  std::vector<float> buf(span_rows * row_elems);
  if (fseek(f, info.payload_offset + r0 * row_bytes, SEEK_SET) != 0) {
    fclose(f);
    return;
  }
  if (fread(buf.data(), 1, span_rows * row_bytes, f) !=
      (size_t)(span_rows * row_bytes)) {
    fclose(f);
    return;
  }
  fclose(f);
  for (long orow = 0; orow < t->out_h; ++orow) {
    const float* src = buf.data() + orow * rs * row_elems;
    float* dst = t->out + orow * t->out_w;
    for (long ocol = 0; ocol < t->out_w; ++ocol) {
      float v = src[ocol * cs * info.c];       // channel 0 (range)
      v *= t->scale;
      if (t->min_r >= 0.0f && (v < t->min_r || v > t->max_r)) v = 0.0f;
      if (t->log1p) v = log1pf(v);
      dst[ocol] = v;
    }
  }
  t->status = 0;
}

struct Shared {
  Task* tasks;
  int n;
  int next;
  pthread_mutex_t mu;
};

void* worker(void* arg) {
  Shared* sh = (Shared*)arg;
  for (;;) {
    pthread_mutex_lock(&sh->mu);
    int i = sh->next++;
    pthread_mutex_unlock(&sh->mu);
    if (i >= sh->n) return nullptr;
    run_task(&sh->tasks[i]);
  }
}

}  // namespace

extern "C" {

// Read one map: channel 0, optional fused transform.  Returns 0 on success.
int tulip_read_npy_range(const char* path, float scale, float min_r,
                         float max_r, int log1p_flag, int row_start,
                         int row_stride, int col_stride, long out_h,
                         long out_w, float* out) {
  Task t{path, scale, min_r, max_r, log1p_flag, row_start, row_stride,
         col_stride, out_h, out_w, out, 1};
  run_task(&t);
  return t.status;
}

// Probe (h, w, c) of a .npy file.  Returns 0 on success.
int tulip_npy_shape(const char* path, long* h, long* w, long* c) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  NpyInfo info;
  bool ok = parse_npy_header(f, &info);
  fclose(f);
  if (!ok) return 1;
  *h = info.h;
  *w = info.w;
  *c = info.c;
  return 0;
}

// Batched read with an internal pthread pool.  paths: n C-strings; out:
// (n, out_h, out_w) float32.  Returns number of failed items.
int tulip_read_npy_batch(const char** paths, int n, float scale, float min_r,
                         float max_r, int log1p_flag, int row_start,
                         int row_stride, int col_stride, long out_h,
                         long out_w, float* out, int num_threads) {
  std::vector<Task> tasks(n);
  for (int i = 0; i < n; ++i) {
    tasks[i] = Task{paths[i], scale, min_r, max_r, log1p_flag, row_start,
                    row_stride, col_stride, out_h, out_w,
                    out + (long)i * out_h * out_w, 1};
  }
  Shared sh{tasks.data(), n, 0, PTHREAD_MUTEX_INITIALIZER};
  int nt = num_threads > 0 ? num_threads : 4;
  if (nt > n) nt = n;
  std::vector<pthread_t> threads(nt);
  for (int i = 0; i < nt; ++i) pthread_create(&threads[i], nullptr, worker, &sh);
  for (int i = 0; i < nt; ++i) pthread_join(threads[i], nullptr);
  int failed = 0;
  for (auto& t : tasks) failed += t.status != 0;
  return failed;
}

}  // extern "C"
