// medmoe_native — native data-loader hot path (the port's copy of
// native/medmoe_native.cpp, built and bound by medmoe_torch/data/native.py).
//
// The reference framework's input pipeline is pure Python (webdataset +
// PIL inside model.forward, reference swin.py:131) and starves the
// accelerator. This library moves the host-side hot loop to C++:
//
//   * tar shard indexing (raw 512-byte-block header walk, no deps);
//   * fused JPEG decode → bilinear resize → float32 normalize (libjpeg),
//     one pass per image, no intermediate PIL objects;
//   * a batch entry point that fans images across a std::thread pool.
//
// Exposed as a C ABI consumed via ctypes (medmoe_torch/data/native.py,
// which builds it at first use: g++ -O3 -shared -fPIC -std=c++17 ...
// -ljpeg -pthread into csrc/build/).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// tar indexing
// ---------------------------------------------------------------------

struct TarEntry {
  char name[256];
  uint64_t offset;  // payload offset in file
  uint64_t size;
};

static uint64_t parse_octal(const char* p, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] < '0' || p[i] > '7') continue;
    v = (v << 3) | static_cast<uint64_t>(p[i] - '0');
  }
  return v;
}

// Index a tar file: returns number of regular-file entries, fills a
// malloc'd array the caller releases with mn_free. Returns -1 on error.
long mn_tar_index(const char* path, TarEntry** out_entries) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<TarEntry> entries;
  unsigned char header[512];
  uint64_t offset = 0;
  while (std::fread(header, 1, 512, f) == 512) {
    offset += 512;
    // two zero blocks = end of archive
    bool all_zero = true;
    for (int i = 0; i < 512; ++i)
      if (header[i]) { all_zero = false; break; }
    if (all_zero) break;

    uint64_t size = parse_octal(reinterpret_cast<char*>(header) + 124, 12);
    char typeflag = static_cast<char>(header[156]);
    if (typeflag == '0' || typeflag == '\0') {
      TarEntry e;
      std::memset(&e, 0, sizeof(e));
      // prefix (ustar) + name
      char prefix[156] = {0};
      std::memcpy(prefix, header + 345, 155);
      char name[101] = {0};
      std::memcpy(name, header, 100);
      if (prefix[0]) {
        std::snprintf(e.name, sizeof(e.name), "%s/%s", prefix, name);
      } else {
        std::snprintf(e.name, sizeof(e.name), "%s", name);
      }
      e.offset = offset;
      e.size = size;
      entries.push_back(e);
    }
    uint64_t padded = (size + 511) & ~uint64_t(511);
    if (std::fseek(f, static_cast<long>(padded), SEEK_CUR) != 0) break;
    offset += padded;
  }
  std::fclose(f);
  auto* arr = static_cast<TarEntry*>(std::malloc(sizeof(TarEntry)
                                                 * entries.size()));
  if (!arr && !entries.empty()) return -1;
  std::memcpy(arr, entries.data(), sizeof(TarEntry) * entries.size());
  *out_entries = arr;
  return static_cast<long>(entries.size());
}

void mn_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------
// JPEG decode + resize + normalize
// ---------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

static void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  std::longjmp(err->jump, 1);
}

// Decode JPEG bytes to RGB u8; caller frees with mn_free. Returns 0 on ok.
static int decode_rgb(const uint8_t* data, size_t len, uint8_t** out,
                      int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  uint8_t* pixels = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(pixels);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int width = static_cast<int>(cinfo.output_width);
  const int height = static_cast<int>(cinfo.output_height);
  pixels = static_cast<uint8_t*>(std::malloc(size_t(width) * height * 3));
  if (!pixels) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels + size_t(cinfo.output_scanline) * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = pixels;
  *w = width;
  *h = height;
  return 0;
}

// Bilinear resize (align_corners=false, matching PIL/torch conventions
// closely enough for training inputs) + per-channel normalize to f32.
static void resize_normalize(const uint8_t* src, int sw, int sh, int size,
                             const float* mean, const float* stddev,
                             float* out) {
  const float sx = static_cast<float>(sw) / size;
  const float sy = static_cast<float>(sh) / size;
  for (int y = 0; y < size; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - y0;
    for (int x = 0; x < size; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[(size_t(y0) * sw + x0) * 3 + c];
        const float v01 = src[(size_t(y0) * sw + x1) * 3 + c];
        const float v10 = src[(size_t(y1) * sw + x0) * 3 + c];
        const float v11 = src[(size_t(y1) * sw + x1) * 3 + c];
        const float top = v00 + (v01 - v00) * wx;
        const float bot = v10 + (v11 - v10) * wx;
        const float v = (top + (bot - top) * wy) / 255.0f;
        out[(size_t(y) * size + x) * 3 + c] = (v - mean[c]) / stddev[c];
      }
    }
  }
}

// Fused single-image path. out must hold size*size*3 floats. 0 on ok.
int mn_decode_resize_normalize(const uint8_t* jpeg_data, size_t len,
                               int size, const float* mean,
                               const float* stddev, float* out) {
  uint8_t* rgb = nullptr;
  int w = 0, h = 0;
  if (decode_rgb(jpeg_data, len, &rgb, &w, &h) != 0) return -1;
  resize_normalize(rgb, w, h, size, mean, stddev, out);
  std::free(rgb);
  return 0;
}

// Batch path: n images fanned across a thread pool; ok[i]=0 on success.
void mn_decode_batch(const uint8_t** datas, const size_t* lens, int n,
                     int size, const float* mean, const float* stddev,
                     float* out, int* ok, int num_threads) {
  if (num_threads <= 0)
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
  num_threads = std::max(1, std::min(num_threads, n));
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      ok[i] = mn_decode_resize_normalize(
          datas[i], lens[i], size, mean, stddev,
          out + size_t(i) * size * size * 3);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
