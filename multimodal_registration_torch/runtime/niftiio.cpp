// Native NIfTI-1 reader, gzip writer and threaded prefetch pool: the host-side
// data plane of the batch pipeline. A C++ thread pool inflates and converts
// the next subjects' volumes to float32 while the GPU registers the current
// one, and the gzip writer is the classic single-member save path.
//
// Built at first use by multimodal_registration_torch/utils/native.py
// (g++ -O3 -fPIC -std=c++17 -shared ... -lz -lpthread, into build/runtime/ at
// the root of the checkout) and bound there with ctypes. Exposed C ABI:
//   mmreg_load_nifti(path, out, max_elems, dims_out[8], affine_out[16])
//       -> n_elems or negative error code
//   mmreg_nifti_dims(path, dims_out[8]) -> ndim or negative error code
//   mmreg_write_file_gz(path, data, n, level) -> 0 or negative error code
//   mmreg_prefetch_create(n_threads) -> pool handle
//   mmreg_prefetch_submit(pool, path) -> ticket id
//   mmreg_prefetch_wait(pool, ticket, out, max_elems, dims_out, affine_out)
//   mmreg_prefetch_destroy(pool)
// Error codes: -1 open/inflate, -2 short header, -3 not NIfTI-1
// little-endian, -4 bad dims, -5 output too small, -6 short data,
// -7 unsupported datatype.

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NiftiVolume {
  std::vector<float> data;
  int32_t dims[8] = {0};
  float affine[16] = {0};
  int error = 0;  // 0 ok, else negative code
};

// ---- gzip / raw file reading -------------------------------------------------

bool read_file_maybe_gz(const std::string& path, std::vector<uint8_t>& out) {
  gzFile f = gzopen(path.c_str(), "rb");  // handles both gzip and raw
  if (!f) return false;
  gzbuffer(f, 1 << 20);
  out.clear();
  out.reserve(1 << 22);
  uint8_t buf[1 << 20];
  int n;
  while ((n = gzread(f, buf, sizeof(buf))) > 0) {
    out.insert(out.end(), buf, buf + n);
  }
  bool ok = (n == 0);
  gzclose(f);
  return ok;
}

// ---- header parsing ---------------------------------------------------------

template <typename T>
T rd(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

template <typename T>
void convert_to_float(const uint8_t* src, float* dst, int64_t n, float slope,
                      float inter) {
  const T* s = reinterpret_cast<const T*>(src);
  if (slope == 1.0f && inter == 0.0f) {
    for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<float>(s[i]);
  } else {
    for (int64_t i = 0; i < n; ++i)
      dst[i] = static_cast<float>(s[i]) * slope + inter;
  }
}

int parse_nifti(const std::vector<uint8_t>& raw, NiftiVolume& vol,
                int64_t max_elems) {
  if (raw.size() < 352) return -2;
  const uint8_t* h = raw.data();
  int32_t sizeof_hdr = rd<int32_t>(h + 0);
  if (sizeof_hdr != 348) return -3;  // (big-endian unsupported in fast path)

  int16_t dim[8];
  std::memcpy(dim, h + 40, sizeof(dim));
  int ndim = dim[0];
  if (ndim < 1 || ndim > 7) return -4;
  int64_t n = 1;
  for (int i = 1; i <= ndim; ++i) n *= dim[i];
  if (n <= 0) return -4;

  int16_t datatype = rd<int16_t>(h + 70);
  float pixdim0 = rd<float>(h + 76);
  (void)pixdim0;
  float vox_offset = rd<float>(h + 108);
  float slope = rd<float>(h + 112);
  float inter = rd<float>(h + 116);
  if (slope == 0.0f || slope != slope) slope = 1.0f;
  if (inter != inter) inter = 0.0f;
  int16_t qform_code = rd<int16_t>(h + 252);
  int16_t sform_code = rd<int16_t>(h + 254);

  for (int i = 0; i < 8; ++i) vol.dims[i] = dim[i];
  // affine precedence mirrors utils/nifti.py::_affine_from_header
  // (and nibabel): srow if sform set, else the qform quaternion, else a
  // pixdim diagonal.
  for (int i = 0; i < 16; ++i) vol.affine[i] = 0;
  vol.affine[15] = 1.0f;
  if (sform_code > 0) {
    std::memcpy(vol.affine, h + 280, 12 * sizeof(float));
  } else if (qform_code > 0) {
    float px[8];
    std::memcpy(px, h + 76, sizeof(px));
    double b = rd<float>(h + 256), c = rd<float>(h + 260), d = rd<float>(h + 264);
    double qfac = (px[0] == -1.0f || px[0] == 1.0f) ? px[0] : 1.0;
    double a2 = 1.0 - (b * b + c * c + d * d);
    double a = a2 > 0.0 ? std::sqrt(a2) : 0.0;
    double R[3][3] = {
        {a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)},
        {2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)},
        {2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c}};
    for (int i = 0; i < 3; ++i) R[i][2] *= qfac;
    const double zoom[3] = {std::fabs((double)px[1]), std::fabs((double)px[2]),
                            std::fabs((double)px[3])};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        vol.affine[i * 4 + j] = static_cast<float>(R[i][j] * zoom[j]);
    vol.affine[3] = rd<float>(h + 268);
    vol.affine[7] = rd<float>(h + 272);
    vol.affine[11] = rd<float>(h + 276);
  } else {
    float px[8];
    std::memcpy(px, h + 76, sizeof(px));
    vol.affine[0] = px[1];
    vol.affine[5] = px[2];
    vol.affine[10] = px[3];
  }

  size_t off = static_cast<size_t>(vox_offset);
  if (off < 352) off = 352;
  if (max_elems >= 0 && n > max_elems) return -5;
  if (off > raw.size()) return -6;
  const uint8_t* data = raw.data() + off;
  size_t avail = raw.size() - off;
  vol.data.resize(n);

  auto need = [&](size_t bytes_per) { return avail >= n * bytes_per; };
  switch (datatype) {
    case 2:  // uint8
      if (!need(1)) return -6;
      convert_to_float<uint8_t>(data, vol.data.data(), n, slope, inter);
      break;
    case 4:  // int16
      if (!need(2)) return -6;
      convert_to_float<int16_t>(data, vol.data.data(), n, slope, inter);
      break;
    case 8:  // int32
      if (!need(4)) return -6;
      convert_to_float<int32_t>(data, vol.data.data(), n, slope, inter);
      break;
    case 16:  // float32
      if (!need(4)) return -6;
      convert_to_float<float>(data, vol.data.data(), n, slope, inter);
      break;
    case 64:  // float64
      if (!need(8)) return -6;
      convert_to_float<double>(data, vol.data.data(), n, slope, inter);
      break;
    case 256:  // int8
      if (!need(1)) return -6;
      convert_to_float<int8_t>(data, vol.data.data(), n, slope, inter);
      break;
    case 512:  // uint16
      if (!need(2)) return -6;
      convert_to_float<uint16_t>(data, vol.data.data(), n, slope, inter);
      break;
    default:
      return -7;
  }
  return static_cast<int>(n);
}

int load_volume(const std::string& path, NiftiVolume& vol, int64_t max_elems) {
  std::vector<uint8_t> raw;
  if (!read_file_maybe_gz(path, raw)) return -1;
  return parse_nifti(raw, vol, max_elems);
}

// ---- prefetch pool ----------------------------------------------------------

struct Pool {
  std::vector<std::thread> workers;
  std::deque<std::pair<int64_t, std::string>> queue;
  std::map<int64_t, std::shared_ptr<NiftiVolume>> done;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  bool stop = false;
  int64_t next_ticket = 1;

  explicit Pool(int n_threads) {
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { worker(); });
    }
  }

  void worker() {
    for (;;) {
      std::pair<int64_t, std::string> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        job = queue.front();
        queue.pop_front();
      }
      auto vol = std::make_shared<NiftiVolume>();
      int rc = load_volume(job.second, *vol, -1);
      vol->error = rc < 0 ? rc : 0;
      {
        std::lock_guard<std::mutex> lk(mu);
        done[job.first] = vol;
      }
      cv_done.notify_all();
    }
  }

  int64_t submit(const std::string& path) {
    std::lock_guard<std::mutex> lk(mu);
    int64_t t = next_ticket++;
    queue.emplace_back(t, path);
    cv_work.notify_one();
    return t;
  }

  std::shared_ptr<NiftiVolume> wait(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return done.count(ticket) > 0; });
    auto v = done[ticket];
    done.erase(ticket);
    return v;
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& w : workers) w.join();
  }
};

int copy_out(const NiftiVolume& vol, float* out, int64_t max_elems,
             int32_t* dims_out, float* affine_out) {
  if (vol.error) return vol.error;
  int64_t n = static_cast<int64_t>(vol.data.size());
  if (n > max_elems) return -5;
  std::memcpy(out, vol.data.data(), n * sizeof(float));
  if (dims_out) std::memcpy(dims_out, vol.dims, sizeof(vol.dims));
  if (affine_out) std::memcpy(affine_out, vol.affine, sizeof(vol.affine));
  return static_cast<int>(n);
}

// ---- gzip writer --------------------------------------------------------------

int write_file_gz(const std::string& path, const uint8_t* data, int64_t n,
                  int level) {
  // "wbN" sets the compression level; gzFile writes a gzip wrapper. mtime in
  // the gzip header is whatever zlib stamps — callers needing byte-stable
  // output compare decompressed content (tests do).
  std::string mode = "wb";
  mode += static_cast<char>('0' + (level < 0 ? 6 : (level > 9 ? 9 : level)));
  gzFile f = gzopen(path.c_str(), mode.c_str());
  if (!f) return -1;
  gzbuffer(f, 1 << 20);
  int64_t off = 0;
  while (off < n) {
    unsigned chunk = static_cast<unsigned>(
        std::min<int64_t>(n - off, 1 << 20));
    int w = gzwrite(f, data + off, chunk);
    if (w <= 0) {
      gzclose(f);
      return -2;
    }
    off += w;
  }
  return gzclose(f) == Z_OK ? 0 : -3;
}

}  // namespace

extern "C" {

// Deflate `data` (n bytes) to `path` as a gzip file at `level` (0-9; <0 → 6).
// Returns 0 on success, negative on error. Used for fast .nii.gz saving —
// Python's gzip at level 9 costs seconds per 192^3 volume.
int mmreg_write_file_gz(const char* path, const uint8_t* data, int64_t n,
                        int level) {
  return write_file_gz(path, data, n, level);
}

int mmreg_load_nifti(const char* path, float* out, int64_t max_elems,
                     int32_t* dims_out, float* affine_out) {
  NiftiVolume vol;
  int rc = load_volume(path, vol, max_elems);
  if (rc < 0) return rc;
  return copy_out(vol, out, max_elems, dims_out, affine_out);
}

int mmreg_nifti_dims(const char* path, int32_t* dims_out) {
  // inflate the 352-byte header only, not the volume: the caller sizes its
  // buffer with this before the load (or before collecting a prefetch)
  std::vector<uint8_t> raw(352);
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  int got = gzread(f, raw.data(), static_cast<unsigned>(raw.size()));
  gzclose(f);
  if (got < 0) return -1;
  raw.resize(static_cast<size_t>(got));
  NiftiVolume vol;
  // a 0 budget skips the data: "too big" (-5) means the header parsed
  int rc = parse_nifti(raw, vol, 0);
  if (rc == -5 || rc >= 0) {  // -5 == "too big" i.e. header parsed fine
    std::memcpy(dims_out, vol.dims, sizeof(vol.dims));
    return vol.dims[0];
  }
  return rc;
}

void* mmreg_prefetch_create(int n_threads) { return new Pool(n_threads); }

int64_t mmreg_prefetch_submit(void* pool, const char* path) {
  return static_cast<Pool*>(pool)->submit(path);
}

int mmreg_prefetch_wait(void* pool, int64_t ticket, float* out,
                        int64_t max_elems, int32_t* dims_out,
                        float* affine_out) {
  auto vol = static_cast<Pool*>(pool)->wait(ticket);
  return copy_out(*vol, out, max_elems, dims_out, affine_out);
}

void mmreg_prefetch_destroy(void* pool) { delete static_cast<Pool*>(pool); }

}  // extern "C"
