// Threaded CT-slice decode + resize pool with its own PNG and JPEG decoders.
//
// The port's counterpart of emr2a_tpu/native/decode_pool.cpp, with the same
// C ABI and the same output. That pool links libpng and libjpeg; this one
// carries its own inflate, PNG and JPEG decoders (inflate.h, png_decode.h,
// jpeg_decode.h), written to give libpng 1.6's and libjpeg-turbo 2.1's bytes
// for the calls that pool makes, so it builds with nothing but a C++17
// compiler:
//
//   g++ -O3 -fPIC -std=c++17 -shared -pthread -o libemr2a_decode.so decode_pool.cpp
//
// C ABI (ctypes-friendly):
//   emr2a_decode_batch(paths, n, out, out_h, out_w, n_threads, ok)
//     paths:   array of n C strings
//     out:     n * out_h * out_w * 3 uint8 buffer (RGB)
//     ok:      n uint8 flags (1 = decoded, 0 = failed -> row zeroed)
//   returns the number of rows decoded.
//
// Resize: box-filter area averaging when both sides shrink, align-corners
// bilinear otherwise, a copy at the same size.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include "image.h"
#include "jpeg_decode.h"
#include "png_decode.h"

namespace {

using emr2a::Image;

bool read_file(const char* path, std::vector<uint8_t>* bytes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bytes->clear();
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof(buf), f)) > 0) bytes->insert(bytes->end(), buf, buf + got);
  std::fclose(f);
  return true;
}

bool decode_file(const char* path, Image* out) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, &bytes)) return false;
  static const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A, 0x0A};
  const uint8_t* m = bytes.data();
  const size_t got = bytes.size();
  try {
    if (got >= 3 && m[0] == 0xFF && m[1] == 0xD8 && m[2] == 0xFF) {
      emr2a::decode_jpeg(m, got, out);
    } else if (got >= 8 && std::memcmp(m, kPngSig, 8) == 0) {
      emr2a::decode_png(m, got, out);
    } else {
      return false;
    }
  } catch (const emr2a::DecodeError&) {
    return false;
  } catch (const std::bad_alloc&) {
    return false;
  }
  return out->h > 0 && out->w > 0;
}

// Area-average (both sides shrink) / bilinear (otherwise) into dst (dh*dw*3).
void resize_rgb(const Image& src, unsigned char* dst, int dh, int dw) {
  if (src.h == dh && src.w == dw) {
    std::memcpy(dst, src.data.data(), size_t(dh) * dw * 3);
    return;
  }
  const bool down = dh <= src.h && dw <= src.w;
  if (down) {
    const double sy = double(src.h) / dh, sx = double(src.w) / dw;
    for (int y = 0; y < dh; y++) {
      int y0 = int(std::floor(y * sy));
      int y1 = std::max(y0 + 1, int(std::ceil((y + 1) * sy)));
      y1 = std::min(y1, src.h);
      for (int x = 0; x < dw; x++) {
        int x0 = int(std::floor(x * sx));
        int x1 = std::max(x0 + 1, int(std::ceil((x + 1) * sx)));
        x1 = std::min(x1, src.w);
        int acc[3] = {0, 0, 0};
        int cnt = (y1 - y0) * (x1 - x0);
        for (int yy = y0; yy < y1; yy++) {
          const unsigned char* row = src.data.data() + (size_t(yy) * src.w + x0) * 3;
          for (int xx = x0; xx < x1; xx++) {
            acc[0] += row[0];
            acc[1] += row[1];
            acc[2] += row[2];
            row += 3;
          }
        }
        unsigned char* o = dst + (size_t(y) * dw + x) * 3;
        o[0] = (unsigned char)(acc[0] / cnt);
        o[1] = (unsigned char)(acc[1] / cnt);
        o[2] = (unsigned char)(acc[2] / cnt);
      }
    }
  } else {  // bilinear, align-corners
    const double sy = double(src.h - 1) / std::max(dh - 1, 1);
    const double sx = double(src.w - 1) / std::max(dw - 1, 1);
    for (int y = 0; y < dh; y++) {
      double fy = y * sy;
      int y0 = int(fy);
      int y1 = std::min(y0 + 1, src.h - 1);
      double wy = fy - y0;
      for (int x = 0; x < dw; x++) {
        double fx = x * sx;
        int x0 = int(fx);
        int x1 = std::min(x0 + 1, src.w - 1);
        double wx = fx - x0;
        unsigned char* o = dst + (size_t(y) * dw + x) * 3;
        for (int c = 0; c < 3; c++) {
          double v00 = src.data[(size_t(y0) * src.w + x0) * 3 + c];
          double v01 = src.data[(size_t(y0) * src.w + x1) * 3 + c];
          double v10 = src.data[(size_t(y1) * src.w + x0) * 3 + c];
          double v11 = src.data[(size_t(y1) * src.w + x1) * 3 + c];
          double v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                     v10 * wy * (1 - wx) + v11 * wy * wx;
          o[c] = (unsigned char)(v + 0.5);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode n files into out (n, out_h, out_w, 3) uint8 with a thread pool.
// ok[i] = 1 on success; failed rows are zeroed (skip-and-continue).
int emr2a_decode_batch(const char** paths, int n, unsigned char* out, int out_h, int out_w,
                       int n_threads, unsigned char* ok) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(n_threads, n));
  const size_t row_bytes = size_t(out_h) * out_w * 3;

  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      Image img;
      unsigned char* dst = out + size_t(i) * row_bytes;
      if (decode_file(paths[i], &img)) {
        resize_rgb(img, dst, out_h, out_w);
        ok[i] = 1;
      } else {
        std::memset(dst, 0, row_bytes);
        ok[i] = 0;
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();

  int n_ok = 0;
  for (int i = 0; i < n; i++) n_ok += ok[i];
  return n_ok;
}

}  // extern "C"
