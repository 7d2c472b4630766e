// PNG to 8-bit RGB, equal to what libpng 1.6 gives for the JAX package's
// decode pool (emr2a_tpu/native/decode_pool.cpp, decode_png): strip 16-bit
// samples to their high byte (png_set_strip_16), scale 1/2/4-bit grey by
// 255/85/17, look palettes up in PLTE (entries past its end are black),
// drop tRNS and alpha without compositing, replicate grey to RGB, undo the
// five filters and Adam7.
//
// Which damaged files fail follows libpng's sequential reader, which the
// pool calls as png_read_info + png_read_image and never png_read_end:
// - every chunk before the first IDAT is read whole; a bad CRC on a critical
//   chunk, an unknown critical chunk, a chunk name that is not letters, an
//   invalid IHDR or a misplaced IHDR/PLTE/IEND fails; ancillary chunks are
//   skipped, their CRCs ignored (they must follow IHDR);
// - the zlib stream is fed from the IDAT chunks in reads of at most 8,192
//   bytes; reading past the end of the file, a bad IDAT CRC (checked when
//   the reader moves past that chunk), or a non-IDAT chunk where more image
//   data is needed fails;
// - any zlib error before the last row is complete fails, as does one found
//   while the last row's read call is still in the same input read;
//   afterwards libpng only warns ("benign" errors) and stops looking, so an
//   Adler-32 or a tail that is never reached does not matter;
// - a filter type above 4 fails; so does a stream that ends early.
// Nothing after the IDAT chunk that ends the stream is read.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include "image.h"
#include "inflate.h"

namespace emr2a {

namespace png_detail {

// CRC-32 by slicing-by-8: t[k][b] is the CRC of byte b followed by k zeros.
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t n = 0; n < 256; n++) {
      uint32_t c = n;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][n] = c;
    }
    for (uint32_t n = 0; n < 256; n++)
      for (int k = 1; k < 8; k++) t[k][n] = (t[k - 1][n] >> 8) ^ t[0][t[k - 1][n] & 0xFF];
  }
};

inline uint32_t crc_update(uint32_t crc, const uint8_t* p, size_t n) {
  static const CrcTables tables;
  const auto& t = tables.t;
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);  // little-endian words
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
          t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

constexpr uint32_t tag(char a, char b, char c, char d) {
  return (uint32_t(uint8_t(a)) << 24) | (uint32_t(uint8_t(b)) << 16) |
         (uint32_t(uint8_t(c)) << 8) | uint32_t(uint8_t(d));
}

constexpr uint32_t kIHDR = tag('I', 'H', 'D', 'R'), kPLTE = tag('P', 'L', 'T', 'E'),
                   kIDAT = tag('I', 'D', 'A', 'T'), kIEND = tag('I', 'E', 'N', 'D');

// Ancillary chunks libpng has a handler for; each fails before IHDR.
inline bool known_ancillary(uint32_t t) {
  static const uint32_t known[] = {
      tag('b', 'K', 'G', 'D'), tag('c', 'H', 'R', 'M'), tag('e', 'X', 'I', 'f'),
      tag('g', 'A', 'M', 'A'), tag('h', 'I', 'S', 'T'), tag('o', 'F', 'F', 's'),
      tag('p', 'C', 'A', 'L'), tag('s', 'C', 'A', 'L'), tag('p', 'H', 'Y', 's'),
      tag('s', 'B', 'I', 'T'), tag('s', 'R', 'G', 'B'), tag('i', 'C', 'C', 'P'),
      tag('s', 'P', 'L', 'T'), tag('t', 'E', 'X', 't'), tag('t', 'I', 'M', 'E'),
      tag('t', 'R', 'N', 'S'), tag('z', 'T', 'X', 't'), tag('i', 'T', 'X', 't')};
  for (uint32_t k : known)
    if (k == t) return true;
  return false;
}

constexpr int kAdamX0[7] = {0, 4, 0, 2, 0, 1, 0};
constexpr int kAdamDX[7] = {8, 8, 4, 4, 2, 2, 1};
constexpr int kAdamY0[7] = {0, 0, 4, 0, 2, 0, 1};
constexpr int kAdamDY[7] = {8, 8, 8, 4, 4, 2, 2};

struct StopInflate {};

class Reader {
 public:
  Reader(const uint8_t* data, size_t size) : d_(data), n_(size) {}

  void decode(Image* out) {
    pos_ = 8;  // the signature was checked by the caller
    read_info();
    read_image();
    convert(out);
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;

  // IHDR
  uint32_t width_ = 0, height_ = 0;
  int depth_ = 0, color_ = 0, interlace_ = 0, channels_ = 0;
  bool have_ihdr_ = false, have_plte_ = false;
  uint8_t palette_[256 * 3] = {0};

  // The chunk being read.
  uint32_t type_ = 0, crc_ = 0, left_ = 0;

  // The image data's read loop.
  size_t needed_ = 0;     // filter bytes + packed rows of every pass
  bool check_ = false;    // past the last row's read call
  size_t extra_ = 0;      // bytes zlib gave beyond the image data
  std::vector<uint8_t> raw_;

  [[noreturn]] static void fail() { throw DecodeError{}; }

  const uint8_t* take(size_t k) {
    if (k > n_ - pos_) fail();  // fread came up short: "Read Error"
    const uint8_t* p = d_ + pos_;
    pos_ += k;
    return p;
  }

  void chunk_header() {
    const uint8_t* h = take(8);
    const uint32_t len = be32(h);
    if (len > 0x7FFFFFFFu) fail();
    for (int i = 4; i < 8; i++) {
      const uint8_t c = h[i];
      if (c < 65 || c > 122 || (c > 90 && c < 97)) fail();
    }
    type_ = be32(h + 4);
    crc_ = crc_update(0, h + 4, 4);
    left_ = len;
  }

  bool critical() const { return (type_ & 0x20000000u) == 0; }

  // png_crc_finish: skip what is left of the chunk, check its CRC; a bad CRC
  // fails a critical chunk and is only a warning on an ancillary one.
  void crc_finish() {
    const uint8_t* p = take(left_);
    crc_ = crc_update(crc_, p, left_);
    left_ = 0;
    if (be32(take(4)) != crc_ && critical()) fail();
  }

  void read_info() {
    for (;;) {
      chunk_header();
      if (type_ == kIDAT) {
        if (!have_ihdr_) fail();
        if (color_ == 3 && !have_plte_) fail();
        return;
      }
      if (type_ == kIHDR) {
        if (have_ihdr_ || left_ != 13) fail();
        const uint8_t* p = take(13);
        crc_ = crc_update(crc_, p, 13);
        left_ = 0;
        crc_finish();
        width_ = be32(p);
        height_ = be32(p + 4);
        depth_ = p[8];
        color_ = p[9];
        interlace_ = p[12];
        check_ihdr(p[10], p[11]);
        have_ihdr_ = true;
      } else if (type_ == kIEND) {
        fail();  // before any IDAT: "out of place"
      } else if (type_ == kPLTE) {
        read_plte();
      } else if (known_ancillary(type_)) {
        if (!have_ihdr_) fail();
        crc_finish();
      } else {
        crc_finish();
        if (critical()) fail();  // "unhandled critical chunk"
      }
    }
  }

  void check_ihdr(int compression, int filter) {
    bool bad = false;
    if (width_ == 0 || width_ > 1000000u || height_ == 0 || height_ > 1000000u) bad = true;
    if (depth_ != 1 && depth_ != 2 && depth_ != 4 && depth_ != 8 && depth_ != 16) bad = true;
    if (color_ == 1 || color_ == 5 || color_ > 6) bad = true;
    if (color_ == 3 && depth_ > 8) bad = true;
    if ((color_ == 2 || color_ == 4 || color_ == 6) && depth_ < 8) bad = true;
    if (interlace_ >= 2 || compression != 0 || filter != 0) bad = true;
    if (bad) fail();
    static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
    channels_ = kChannels[color_];
  }

  void read_plte() {
    if (!have_ihdr_) fail();
    if (have_plte_) fail();  // "duplicate"
    have_plte_ = true;
    if ((color_ & 2) == 0) {  // ignored in a grey PNG
      crc_finish();
      return;
    }
    if (color_ != 3) {  // optional palette of a truecolour image: unused
      crc_finish();
      return;
    }
    if (left_ > 3 * 256 || left_ % 3) fail();
    int num = int(left_ / 3);
    const int max_entries = 1 << depth_;
    if (num > max_entries) num = max_entries;
    const uint8_t* p = take(size_t(num) * 3);
    crc_ = crc_update(crc_, p, size_t(num) * 3);
    left_ -= uint32_t(num) * 3;
    std::memcpy(palette_, p, size_t(num) * 3);
    crc_finish();
  }

  size_t row_bytes(uint32_t w) const {
    return (size_t(w) * channels_ * depth_ + 7) / 8;
  }

  // Pass geometry (the whole image when not interlaced).
  void pass_size(int pass, uint32_t* pw, uint32_t* ph) const {
    if (!interlace_) {
      *pw = width_;
      *ph = height_;
      return;
    }
    const uint32_t x0 = kAdamX0[pass], y0 = kAdamY0[pass];
    *pw = width_ > x0 ? (width_ - x0 + kAdamDX[pass] - 1) / kAdamDX[pass] : 0;
    *ph = height_ > y0 ? (height_ - y0 + kAdamDY[pass] - 1) / kAdamDY[pass] : 0;
  }

  static void next_piece(void* ctx, const uint8_t** begin, const uint8_t** end) {
    static_cast<Reader*>(ctx)->piece(begin, end);
  }
  static void before_output(void* ctx, size_t produced) {
    Reader* r = static_cast<Reader*>(ctx);
    if (produced < r->needed_) return;
    // zlib has no room left in the last row: the read call returns and the
    // rest goes to libpng's end-of-data check, where it counts as extra.
    r->check_ = true;
    r->extra_++;
  }

  void piece(const uint8_t** begin, const uint8_t** end) {
    if (!check_ && raw_size() >= needed_) {
      // The last row's read call ran out of input: the check starts with a
      // new read.
      check_ = true;
    } else if (check_ && extra_ == 0) {
      // A check call that gave no output and wants more input ends the check.
      throw StopInflate{};
    }
    while (left_ == 0) {
      if (be32(take(4)) != crc_) fail();  // IDAT is critical
      chunk_header();
      if (type_ != kIDAT) fail();  // "Not enough image data"
    }
    const uint32_t k = left_ < 8192 ? left_ : 8192;
    const uint8_t* p = take(k);
    crc_ = crc_update(crc_, p, k);
    left_ -= k;
    *begin = p;
    *end = p + k;
  }

  size_t raw_size() const { return inflater_ ? inflater_->size() : 0; }
  Inflater* inflater_ = nullptr;

  void read_image() {
    const int passes = interlace_ ? 7 : 1;
    for (int pass = 0; pass < passes; pass++) {
      uint32_t pw, ph;
      pass_size(pass, &pw, &ph);
      if (pw && ph) needed_ += size_t(ph) * (1 + row_bytes(pw));
    }
    // The first IDAT's header was read by read_info.
    Inflater inf(&Reader::next_piece, &Reader::before_output, this, needed_);
    inflater_ = &inf;
    try {
      inf.run();
      if (inf.size() < needed_) fail();  // "Not enough image data"
    } catch (const InflateError&) {
      if (!check_) fail();
    } catch (const StopInflate&) {
    }
    inflater_ = nullptr;
    raw_ = inf.take_output();
    raw_.resize(needed_);
    // png_read_finish_IDAT: the rest of the current IDAT and its CRC.
    crc_finish();
  }

  static inline uint8_t paeth(int a, int b, int c) {
    int pa = b - c, pb = a - c;
    int pc = pa + pb;
    pa = pa < 0 ? -pa : pa;
    pb = pb < 0 ? -pb : pb;
    pc = pc < 0 ? -pc : pc;
    if (pb < pa) {
      pa = pb;
      a = b;
    }
    if (pc < pa) a = c;
    return uint8_t(a);
  }

  void convert(Image* out) {
    out->h = int(height_);
    out->w = int(width_);
    out->data.assign(size_t(height_) * width_ * 3, 0);
    const int bpp = (channels_ * depth_ + 7) / 8;
    const uint8_t* src = raw_.data();
    std::vector<uint8_t> prev, cur;
    const int passes = interlace_ ? 7 : 1;
    for (int pass = 0; pass < passes; pass++) {
      uint32_t pw, ph;
      pass_size(pass, &pw, &ph);
      if (!pw || !ph) continue;
      const size_t rb = row_bytes(pw);
      prev.assign(rb, 0);
      cur.resize(rb);
      for (uint32_t y = 0; y < ph; y++) {
        const int filter = *src++;
        if (filter > 4) fail();  // "bad adaptive filter value"
        unfilter(filter, src, prev.data(), cur.data(), rb, bpp);
        src += rb;
        const uint32_t oy = interlace_ ? kAdamY0[pass] + y * kAdamDY[pass] : y;
        const uint32_t x0 = interlace_ ? kAdamX0[pass] : 0;
        const uint32_t dx = interlace_ ? kAdamDX[pass] : 1;
        put_row(cur.data(), pw, out->data.data() + size_t(oy) * width_ * 3, x0, dx);
        prev.swap(cur);
      }
    }
  }

  static void unfilter(int filter, const uint8_t* in, const uint8_t* prev, uint8_t* cur,
                       size_t n, int bpp) {
    const size_t k = size_t(bpp) < n ? size_t(bpp) : n;  // the first pixel has no left
    switch (filter) {
      case 0:
        std::memcpy(cur, in, n);
        break;
      case 1:
        std::memcpy(cur, in, k);
        for (size_t i = k; i < n; i++) cur[i] = uint8_t(in[i] + cur[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < n; i++) cur[i] = uint8_t(in[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < k; i++) cur[i] = uint8_t(in[i] + (prev[i] >> 1));
        for (size_t i = k; i < n; i++) cur[i] = uint8_t(in[i] + ((cur[i - bpp] + prev[i]) >> 1));
        break;
      default:
        for (size_t i = 0; i < k; i++) cur[i] = uint8_t(in[i] + prev[i]);  // paeth(0, b, 0)
        for (size_t i = k; i < n; i++)
          cur[i] = uint8_t(in[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
        break;
    }
  }

  // One unfiltered row of a pass to RGB pixels x0, x0 + dx, ... of `dst`.
  void put_row(const uint8_t* row, uint32_t pw, uint8_t* dst, uint32_t x0,
               uint32_t dx) const {
    static const uint8_t kScale[9] = {0, 255, 85, 0, 17, 0, 0, 0, 1};
    const size_t step = size_t(dx) * 3;
    uint8_t* o = dst + size_t(x0) * 3;
    if (depth_ < 8) {  // grey or palette, packed MSB first
      const int per_byte = 8 / depth_, mask = (1 << depth_) - 1;
      for (uint32_t x = 0; x < pw; x++, o += step) {
        const int shift = 8 - depth_ * (int(x % per_byte) + 1);
        const int v = (row[x / per_byte] >> shift) & mask;
        if (color_ == 3) {
          o[0] = palette_[v * 3];
          o[1] = palette_[v * 3 + 1];
          o[2] = palette_[v * 3 + 2];
        } else {
          o[0] = o[1] = o[2] = uint8_t(v * kScale[depth_]);
        }
      }
      return;
    }
    const int bytes = depth_ / 8;  // 16-bit samples keep their high byte
    const int px = channels_ * bytes;
    for (uint32_t x = 0; x < pw; x++, o += step) {
      const uint8_t* p = row + size_t(x) * px;
      switch (color_) {
        case 0:
        case 4:
          o[0] = o[1] = o[2] = p[0];
          break;
        case 3:
          o[0] = palette_[p[0] * 3];
          o[1] = palette_[p[0] * 3 + 1];
          o[2] = palette_[p[0] * 3 + 2];
          break;
        default:  // 2, 6
          o[0] = p[0];
          o[1] = p[bytes];
          o[2] = p[2 * bytes];
          break;
      }
    }
  }
};

}  // namespace png_detail

inline void decode_png(const uint8_t* data, size_t size, Image* out) {
  png_detail::Reader(data, size).decode(out);
}

}  // namespace emr2a
