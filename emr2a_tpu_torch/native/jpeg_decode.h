// JPEG to 8-bit RGB, equal to what libjpeg-turbo 2.1 gives for the JAX
// package's decode pool (emr2a_tpu/native/decode_pool.cpp, decode_jpeg:
// jpeg_read_header, out_color_space = JCS_RGB, default settings otherwise).
//
// Decoded: Huffman-coded baseline, extended (SOF0/SOF1) and progressive
// (SOF2) files, 8-bit, with one (grey) or three (YCbCr, or RGB by Adobe
// marker or component ids) components; interleaved and non-interleaved
// scans, restart intervals, libjpeg's standard tables where a sequential file
// has none.
// Progressive scans: DC and AC first and refinement scans, EOB runs.
// Output: the islow IDCT (jidctint.c's fixed point in the 16-bit arithmetic
// of libjpeg-turbo's x86 SIMD version), fancy upsampling (h2v1 and h2v2 when the
// downsampled width is over 2, h1v2; plain replication otherwise) and
// jdcolor.c's fixed-point YCbCr->RGB tables.
//
// Failing as libjpeg fails: no SOI, no image before EOI, 12-bit, lossless
// and hierarchical frames, CMYK/YCCK and other component
// counts, bad sampling factors, bad tables or scan parameters, more than
// ten blocks in an MCU, a second SOI or SOF, a second SOS in a single-scan
// file. Unlike libjpeg-turbo, arithmetic-coded frames (SOF9 to SOF11) fail
// too: CT slices are PNG or Huffman-coded JPEG. A DAC segment is checked as
// get_dac checks it and otherwise ignored.
//
// Damage is handled as libjpeg handles it: past the end of the file the
// source reads FF D9 (a fake EOI) forever; bits after a marker in entropy-
// coded data read as zeros, and the MCUs after the one that needed them are
// skipped (coefficients stay zero) until a restart; restart markers are
// resynchronised as jpeg_resync_to_restart does; a bad Huffman code reads as
// symbol 0. A progressive file left incomplete is output through libjpeg
// 2.1's block smoothing (jdcoefct.c, decompress_smooth_data).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include "image.h"

namespace emr2a {

namespace jpeg_detail {

// Zigzag to natural order, with the 16 extra entries libjpeg keeps so that
// corrupt run lengths land on coefficient 63.
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

[[noreturn]] inline void fail() { throw DecodeError{}; }

// The file as libjpeg's stdio source reads it: past the end, FF D9 forever.
struct Source {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  inline int byte() {
    if (pos < n) return d[pos++];
    const int v = ((pos - n) & 1) ? 0xD9 : 0xFF;
    pos++;
    return v;
  }
  int be16() {
    const int a = byte();
    return (a << 8) | byte();
  }
  void skip(long k) {
    if (k > 0) pos += size_t(k);
  }
};

struct HuffSpec {
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  bool defined = false;
};

// jdhuff.c's derived table: maxcode/valoffset for the bit-serial decode and
// an 8-bit lookahead table.
struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[256];  // (length << 8) | symbol, length 0 = not in 8 bits

  void derive(const HuffSpec& h, bool dc) {
    char huffsize[257];
    unsigned int huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      const int i = h.bits[l];
      if (p + i > 256) fail();
      for (int k = 0; k < i; k++) huffsize[p++] = char(l);
    }
    huffsize[p] = 0;
    const int numsymbols = p;
    unsigned int code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (int(huffsize[p]) == si) {
        huffcode[p++] = code;
        code++;
      }
      if (code >= (1u << si)) fail();  // no code may be all ones
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (h.bits[l]) {
        valoffset[l] = p - int32_t(huffcode[p]);
        p += h.bits[l];
        maxcode[l] = int32_t(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memcpy(vals, h.vals, 256);
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 8; l++) {
      for (int i = 1; i <= h.bits[l]; i++, p++) {
        const int prefix = int(huffcode[p]) << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; ctr--)
          look[prefix + ctr - 1] = uint16_t((l << 8) | h.vals[p]);
      }
    }
    if (dc)
      for (int i = 0; i < numsymbols; i++)
        if (h.vals[i] > 15) fail();
  }
};

// libjpeg's bit reader over entropy-coded data: stops at a marker, and
// reads zeros past it (flagging the data as insufficient).
struct BitReader {
  Source* src = nullptr;
  int* unread_marker = nullptr;
  uint64_t buf = 0;
  int n = 0;
  bool insufficient = false;

  void reset() {
    buf = 0;
    n = 0;
  }
  inline void fill() {
    while (n <= 56) {
      if (*unread_marker) return;
      int c = src->byte();
      if (c == 0xFF) {
        int c2;
        do c2 = src->byte();
        while (c2 == 0xFF);
        if (c2 != 0) {
          *unread_marker = c2;
          return;
        }
      }
      buf = (buf << 8) | uint64_t(c);
      n += 8;
    }
  }
  inline void ensure(int k) {
    if (n < k) {
      fill();
      if (n < k) {
        insufficient = true;
        buf <<= (56 - n);
        n = 56;
      }
    }
  }
  inline int get(int k) {
    if (k == 0) return 0;
    ensure(k);
    n -= k;
    return int((buf >> n) & ((uint64_t(1) << k) - 1));
  }
  inline int decode(const HuffTable& t) {
    int l = 1;
    if (n < 8) fill();
    if (n >= 8) {
      const uint16_t e = t.look[(buf >> (n - 8)) & 0xFF];
      if (e >> 8) {
        n -= e >> 8;
        return e & 0xFF;
      }
      l = 9;
    }
    int32_t code = get(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;  // bad code: "fake a zero as the safest result"
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + int((~0u) << s) + 1 : r;
}

// jdcolor.c's YCbCr->RGB tables.
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int32_t one_half = 1 << 15;
    auto fix = [](double x) { return int32_t(x * 65536 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

inline const YccTables& ycc() {
  static const YccTables t;
  return t;
}

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// jidctint.c's jpeg_idct_islow on one block, in the arithmetic of
// libjpeg-turbo's x86 SIMD version (jidctint-avx2.asm), which is what runs on
// x86-64: dequantised coefficients and the sums of two inputs wrap at 16
// bits, products accumulate in 32 bits, pass 1's outputs saturate to 16
// bits, the output saturates to 0..255, and pass 1 takes the DC-only path
// only when rows 1 to 7 are zero in all eight columns. On coefficients in
// range this equals the C version.
namespace idct {
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
inline int16_t w16(int32_t v) { return int16_t(uint16_t(uint32_t(v))); }
inline int32_t add32(int32_t a, int32_t b) { return int32_t(uint32_t(a) + uint32_t(b)); }
inline int32_t sub32(int32_t a, int32_t b) { return int32_t(uint32_t(a) - uint32_t(b)); }
inline int32_t mul32(int32_t a, int32_t b) { return int32_t(uint32_t(a) * uint32_t(b)); }
inline int32_t descale(int32_t x, int n) { return add32(x, int32_t(1) << (n - 1)) >> n; }
inline int16_t sat16(int32_t v) { return int16_t(v < -32768 ? -32768 : v > 32767 ? 32767 : v); }
inline uint8_t out8(int32_t v) { return uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128); }

// One 1-D pass over in[0..7] (16-bit) into the eight 32-bit sums before
// descaling, in the order out0..out7.
inline void pass(const int16_t* in, int32_t* o) {
  const int32_t in0 = in[0], in1 = in[1], in2 = in[2], in3 = in[3], in4 = in[4], in5 = in[5],
                in6 = in[6], in7 = in[7];
  // Even part: the rotation as two multiply-adds, (in0 +- in4) in 16 bits.
  const int32_t tmp3e = add32(mul32(in2, F0541 + F0765), mul32(in6, F0541));
  const int32_t tmp2e = add32(mul32(in2, F0541), mul32(in6, F0541 - F1847));
  const int32_t tmp0e = int32_t(w16(in0 + in4)) * 8192;
  const int32_t tmp1e = int32_t(w16(in0 - in4)) * 8192;
  const int32_t tmp10 = add32(tmp0e, tmp3e), tmp13 = sub32(tmp0e, tmp3e);
  const int32_t tmp11 = add32(tmp1e, tmp2e), tmp12 = sub32(tmp1e, tmp2e);
  // Odd part: z3 = in7 + in3 and z4 = in5 + in1 in 16 bits.
  const int32_t z3 = w16(in7 + in3), z4 = w16(in5 + in1);
  const int32_t z3r = add32(mul32(z3, F1175 - F1961), mul32(z4, F1175));
  const int32_t z4r = add32(mul32(z3, F1175), mul32(z4, F1175 - F0390));
  const int32_t tmp0 = add32(add32(mul32(in7, F0298 - F0899), mul32(in1, -F0899)), z3r);
  const int32_t tmp3 = add32(add32(mul32(in7, -F0899), mul32(in1, F1501 - F0899)), z4r);
  const int32_t tmp1 = add32(add32(mul32(in5, F2053 - F2562), mul32(in3, -F2562)), z4r);
  const int32_t tmp2 = add32(add32(mul32(in5, -F2562), mul32(in3, F3072 - F2562)), z3r);
  o[0] = add32(tmp10, tmp3);
  o[7] = sub32(tmp10, tmp3);
  o[1] = add32(tmp11, tmp2);
  o[6] = sub32(tmp11, tmp2);
  o[2] = add32(tmp12, tmp1);
  o[5] = sub32(tmp12, tmp1);
  o[3] = add32(tmp13, tmp0);
  o[4] = sub32(tmp13, tmp0);
}
}  // namespace idct

inline void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  using namespace idct;
  int16_t ws[64];  // pass 1 output, row-major (ws[r * 8 + c])
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; i++) ac_zero = in[i] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; c++) {
      const int16_t dc = w16(int32_t(w16(int32_t(in[c]) * q[c])) * 4);
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      int16_t col[8];
      for (int r = 0; r < 8; r++) col[r] = w16(int32_t(in[r * 8 + c]) * q[r * 8 + c]);
      int32_t o[8];
      pass(col, o);
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = sat16(descale(o[r], 11));
    }
  }
  for (int r = 0; r < 8; r++) {
    int32_t o[8];
    pass(ws + r * 8, o);
    uint8_t* op = out + r * stride;
    for (int c = 0; c < 8; c++) op[c] = out8(sat16(descale(o[c], 18)));
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int width_in_blocks = 0, height_in_blocks = 0;
  int dw = 0, dh = 0;  // downsampled size
  int bw = 0, bh = 0;  // allocated blocks (rounded up to the sampling factors)
  std::vector<int16_t> coef;
  bool latched = false;
  uint16_t q[64] = {0};
  int coef_bits[64], prev_coef_bits[64];
  std::vector<uint8_t> plane;  // IDCT output, (height_in_blocks*8) x (width_in_blocks*8)
  int16_t* block(int by, int bx) { return coef.data() + (size_t(by) * bw + bx) * 64; }
};

enum Marker {
  M_SOF0 = 0xC0, M_SOF1 = 0xC1, M_SOF2 = 0xC2, M_DHT = 0xC4, M_RST0 = 0xD0, M_RST7 = 0xD7,
  M_SOI = 0xD8, M_EOI = 0xD9, M_SOS = 0xDA, M_DQT = 0xDB, M_DNL = 0xDC, M_DRI = 0xDD,
  M_DAC = 0xCC, M_APP0 = 0xE0, M_APP14 = 0xEE, M_APP15 = 0xEF, M_COM = 0xFE, M_TEM = 0x01
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) { src_ = Source{data, size, 0}; }

  void decode(Image* out) {
    bits_.src = &src_;
    bits_.unread_marker = &unread_marker_;
    if (src_.byte() != 0xFF || src_.byte() != M_SOI) fail();
    unread_marker_ = 0;
    for (;;) {
      if (unread_marker_ == 0) unread_marker_ = next_marker();
      const int m = unread_marker_;
      if (m == M_SOS) {
        unread_marker_ = 0;
        read_sos();
        scan();  // may leave the marker that ended it in unread_marker_
        continue;
      }
      if (m == M_EOI) break;
      unread_marker_ = 0;
      switch (m) {
        case M_SOF0:
        case M_SOF1:
          read_sof(false);
          break;
        case M_SOF2:
          read_sof(true);
          break;
        case M_DHT:
          read_dht();
          break;
        case M_DQT:
          read_dqt();
          break;
        case M_DRI:
          if (src_.be16() != 4) fail();
          restart_interval_ = src_.be16();
          break;
        case M_COM:
        case M_DNL:
          skip_variable();
          break;
        case M_DAC:
          read_dac();
          break;
        case M_TEM:
          break;
        default:
          if (m >= M_APP0 && m <= M_APP15) {
            read_app(m);
          } else if (m >= M_RST0 && m <= M_RST7) {
            // parameterless
          } else {
            fail();  // SOI again, unsupported SOFn, reserved markers
          }
      }
    }
    if (input_scan_number_ == 0) fail();  // "JPEG datastream contains no image"
    output(out);
  }

 private:
  Source src_;
  BitReader bits_;
  int unread_marker_ = 0;
  bool saw_sof_ = false, progressive_ = false, set_up_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  int width_ = 0, height_ = 0, precision_ = 0;
  std::vector<Component> comp_;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  HuffSpec dc_spec_[4], ac_spec_[4];
  HuffTable dc_tab_[4], ac_tab_[4];
  int restart_interval_ = 0;
  int max_h_ = 1, max_v_ = 1, total_imcu_rows_ = 0;
  bool multi_scan_ = false;
  int input_scan_number_ = 0;
  int last_good_imcu_row_ = 0;
  // The current scan.
  int comps_in_scan_ = 0;
  int scan_comp_[4] = {0, 0, 0, 0};
  int Ss_ = 0, Se_ = 0, Ah_ = 0, Al_ = 0;
  int last_dc_[4] = {0, 0, 0, 0};
  int eobrun_ = 0;
  int restarts_to_go_ = 0;
  int next_restart_num_ = 0;

  int next_marker() {
    for (;;) {
      int c = src_.byte();
      while (c != 0xFF) c = src_.byte();
      do c = src_.byte();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void skip_variable() {
    const long len = src_.be16();
    src_.skip(len - 2);
  }

  void read_app(int m) {
    long len = long(src_.be16()) - 2;
    const int want = len >= 14 ? 14 : len > 0 ? int(len) : 0;
    uint8_t b[14];
    for (int i = 0; i < want; i++) b[i] = uint8_t(src_.byte());
    len -= want;
    if (m == M_APP0) {
      if (want >= 14 && b[0] == 'J' && b[1] == 'F' && b[2] == 'I' && b[3] == 'F' && b[4] == 0)
        jfif_ = true;
    } else if (m == M_APP14) {
      if (want >= 12 && b[0] == 'A' && b[1] == 'd' && b[2] == 'o' && b[3] == 'b' &&
          b[4] == 'e') {
        adobe_ = true;
        adobe_transform_ = b[11];
      }
    }
    src_.skip(len);
  }

  // get_dac's checks of arithmetic-coding conditioning, which a Huffman-coded
  // file may carry and libjpeg then reads past.
  void read_dac() {
    long len = long(src_.be16()) - 2;
    while (len > 0) {
      const int index = src_.byte();
      const int val = src_.byte();
      len -= 2;
      if (index >= 32) fail();
      if (index < 16 && (val & 15) > (val >> 4)) fail();
    }
    if (len != 0) fail();
  }

  void read_sof(bool progressive) {
    if (saw_sof_) fail();
    const long len = src_.be16();
    precision_ = src_.byte();
    height_ = src_.be16();
    width_ = src_.be16();
    const int n = src_.byte();
    if (height_ <= 0 || width_ <= 0 || n <= 0) fail();
    if (len - 8 != n * 3) fail();
    comp_.assign(size_t(n), Component());
    for (int i = 0; i < n; i++) {
      comp_[i].id = src_.byte();
      const int c = src_.byte();
      comp_[i].h = (c >> 4) & 15;
      comp_[i].v = c & 15;
      comp_[i].tq = src_.byte();
    }
    progressive_ = progressive;
    saw_sof_ = true;
  }

  void read_dht() {
    long len = long(src_.be16()) - 2;
    while (len > 16) {
      const int index = src_.byte();
      HuffSpec spec;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        spec.bits[i] = uint8_t(src_.byte());
        count += spec.bits[i];
      }
      len -= 17;
      if (count > 256 || count > len) fail();
      for (int i = 0; i < count; i++) spec.vals[i] = uint8_t(src_.byte());
      len -= count;
      spec.defined = true;
      if (index & 0x10) {
        if (index - 0x10 >= 4) fail();
        ac_spec_[index - 0x10] = spec;
      } else {
        if (index >= 4) fail();
        dc_spec_[index] = spec;
      }
    }
    if (len != 0) fail();
  }

  void read_dqt() {
    long len = long(src_.be16()) - 2;
    while (len > 0) {
      len--;
      int n = src_.byte();
      const int prec = n >> 4;
      n &= 15;
      if (n >= 4) fail();
      int count = 64;
      if (len < 64L * (prec + 1)) {
        for (int i = 0; i < 64; i++) qt_[n][i] = 1;
        count = int(len >> prec);
      }
      for (int i = 0; i < count; i++)
        qt_[n][kNatural[i]] = uint16_t(prec ? src_.be16() : src_.byte());
      qt_defined_[n] = true;
      len -= 64;
      if (prec) len -= 64;
    }
    if (len != 0) fail();
  }

  void read_sos() {
    if (!saw_sof_) fail();
    const long len = src_.be16();
    const int n = src_.byte();
    if (len != n * 2 + 6 || n < 1 || n > 4) fail();
    comps_in_scan_ = n;
    bool used[4] = {false, false, false, false};
    for (int i = 0; i < n; i++) {
      const int cc = src_.byte();
      const int c = src_.byte();
      int found = -1;
      for (int ci = 0; ci < int(comp_.size()) && ci < 4; ci++)
        if (cc == comp_[ci].id && !used[ci]) {
          found = ci;
          break;
        }
      if (found < 0) fail();
      used[found] = true;
      scan_comp_[i] = found;
      comp_[found].dc_tbl = (c >> 4) & 15;
      comp_[found].ac_tbl = c & 15;
    }
    Ss_ = src_.byte();
    Se_ = src_.byte();
    const int a = src_.byte();
    Ah_ = (a >> 4) & 15;
    Al_ = a & 15;
    next_restart_num_ = 0;
    input_scan_number_++;
  }

  // jdinput.c's initial_setup and the checks jpeg_start_decompress makes.
  void set_up() {
    if (height_ > 65500 || width_ > 65500) fail();
    if (precision_ != 8) fail();
    const int n = int(comp_.size());
    if (n > 10) fail();
    max_h_ = max_v_ = 1;
    for (auto& c : comp_) {
      if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) fail();
      max_h_ = c.h > max_h_ ? c.h : max_h_;
      max_v_ = c.v > max_v_ ? c.v : max_v_;
    }
    for (auto& c : comp_) {
      c.width_in_blocks = int((long(width_) * c.h + 8L * max_h_ - 1) / (8L * max_h_));
      c.height_in_blocks = int((long(height_) * c.v + 8L * max_v_ - 1) / (8L * max_v_));
      c.dw = int((long(width_) * c.h + max_h_ - 1) / max_h_);
      c.dh = int((long(height_) * c.v + max_v_ - 1) / max_v_);
      c.bw = (c.width_in_blocks + c.h - 1) / c.h * c.h;
      c.bh = (c.height_in_blocks + c.v - 1) / c.v * c.v;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = c.prev_coef_bits[k] = -1;
    }
    total_imcu_rows_ = int((long(height_) + 8L * max_v_ - 1) / (8L * max_v_));
    multi_scan_ = comps_in_scan_ < n || progressive_;
    // Colour conversion to RGB: grey (1), YCbCr or RGB (3); nothing else.
    if (n != 1 && n != 3) fail();
    // Upsampling must be by integral factors.
    for (auto& c : comp_)
      if (max_h_ % c.h || max_v_ % c.v) fail();
    // jinit_huff_decoder (sequential only; jinit_phuff_decoder does not)
    // installs the standard tables in empty slots 0 and 1.
    if (!progressive_) std_tables();
    set_up_ = true;
  }

  void std_tables() {
    static const uint8_t dc_bits[2][17] = {
        {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
        {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
    static const uint8_t ac_bits[2][17] = {
        {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
        {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
    static const uint8_t ac_vals[2][162] = {
        {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
         0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
         0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
         0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
         0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
         0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
         0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
         0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
         0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
         0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
         0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
         0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
        {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
         0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
         0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
         0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
         0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
         0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
         0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
         0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
         0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
         0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
         0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
         0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};
    for (int t = 0; t < 2; t++) {
      if (!dc_spec_[t].defined) {
        std::memcpy(dc_spec_[t].bits, dc_bits[t], 17);
        for (int i = 0; i < 12; i++) dc_spec_[t].vals[i] = uint8_t(i);
        dc_spec_[t].defined = true;
      }
      if (!ac_spec_[t].defined) {
        std::memcpy(ac_spec_[t].bits, ac_bits[t], 17);
        std::memcpy(ac_spec_[t].vals, ac_vals[t], 162);
        ac_spec_[t].defined = true;
      }
    }
  }

  void scan() {
    if (!set_up_) {
      set_up();
    } else if (!multi_scan_) {
      fail();  // a second SOS where the first covered every component
    }
    // Scan parameters (jdphuff.c / jdhuff.c start_pass).
    if (progressive_) {
      bool bad = false;
      if (Ss_ == 0) {
        if (Se_ != 0) bad = true;
      } else {
        if (Ss_ > Se_ || Se_ >= 64) bad = true;
        if (comps_in_scan_ != 1) bad = true;
      }
      if (Ah_ != 0 && Al_ != Ah_ - 1) bad = true;
      if (Al_ > 13) bad = true;
      if (bad) fail();
    }
    // MCU geometry and the 10-block limit.
    if (comps_in_scan_ > 1) {
      int blocks = 0;
      for (int i = 0; i < comps_in_scan_; i++) {
        const Component& c = comp_[scan_comp_[i]];
        blocks += c.h * c.v;
      }
      if (blocks > 10) fail();
    }
    // Latch quantisation tables on a component's first scan.
    for (int i = 0; i < comps_in_scan_; i++) {
      Component& c = comp_[scan_comp_[i]];
      if (c.latched) continue;
      if (c.tq >= 4 || !qt_defined_[c.tq]) fail();
      std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
      c.latched = true;
    }
    // Huffman tables.
    for (int i = 0; i < comps_in_scan_; i++) {
      const Component& c = comp_[scan_comp_[i]];
      const bool need_dc = !progressive_ || (Ss_ == 0 && Ah_ == 0);
      const bool need_ac = !progressive_ || Ss_ != 0;
      if (need_dc) {
        if (c.dc_tbl >= 4 || !dc_spec_[c.dc_tbl].defined) fail();
        dc_tab_[c.dc_tbl].derive(dc_spec_[c.dc_tbl], true);
      }
      if (need_ac) {
        if (c.ac_tbl >= 4 || !ac_spec_[c.ac_tbl].defined) fail();
        ac_tab_[c.ac_tbl].derive(ac_spec_[c.ac_tbl], false);
      }
    }
    // Progression status.
    if (progressive_) {
      for (int i = 0; i < comps_in_scan_; i++) {
        Component& c = comp_[scan_comp_[i]];
        const int lo = Ss_ < 1 ? Ss_ : 1, hi = Se_ > 9 ? Se_ : 9;
        for (int k = lo; k <= hi; k++)
          c.prev_coef_bits[k] = input_scan_number_ > 1 ? c.coef_bits[k] : 0;
        for (int k = Ss_; k <= Se_; k++) c.coef_bits[k] = Al_;
      }
    }
    bits_.reset();
    bits_.insufficient = false;
    for (int& d : last_dc_) d = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;

    if (comps_in_scan_ == 1) {
      Component& c = comp_[scan_comp_[0]];
      for (int by = 0; by < c.height_in_blocks; by++) {
        const int imcu_row = by / c.v;
        for (int bx = 0; bx < c.width_in_blocks; bx++) {
          if (!bits_.insufficient) last_good_imcu_row_ = imcu_row;
          int16_t* blk = c.block(by, bx);
          decode_mcu(&blk, 1);
        }
      }
    } else {
      const int mcus_per_row = int((long(width_) + 8L * max_h_ - 1) / (8L * max_h_));
      int16_t* blocks[10];
      int owner[10];
      for (int row = 0; row < total_imcu_rows_; row++) {
        for (int col = 0; col < mcus_per_row; col++) {
          int nb = 0;
          for (int i = 0; i < comps_in_scan_; i++) {
            Component& c = comp_[scan_comp_[i]];
            for (int yy = 0; yy < c.v; yy++)
              for (int xx = 0; xx < c.h; xx++) {
                owner[nb] = i;
                blocks[nb++] = c.block(row * c.v + yy, col * c.h + xx);
              }
          }
          if (!bits_.insufficient) last_good_imcu_row_ = row;
          mcu_owner_ = owner;
          decode_mcu(blocks, nb);
        }
      }
    }
  }

  const int* mcu_owner_ = nullptr;

  // jdhuff.c / jdphuff.c process_restart and read_restart_marker.
  void process_restart() {
    bits_.reset();
    if (unread_marker_ == 0) unread_marker_ = next_marker();
    if (unread_marker_ == M_RST0 + next_restart_num_) {
      unread_marker_ = 0;
    } else {
      resync_to_restart(next_restart_num_);
    }
    next_restart_num_ = (next_restart_num_ + 1) & 7;
    for (int& d : last_dc_) d = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    if (unread_marker_ == 0) bits_.insufficient = false;
  }

  void resync_to_restart(int desired) {
    int marker = unread_marker_;
    for (;;) {
      int action;
      if (marker < M_SOF0) {
        action = 2;
      } else if (marker < M_RST0 || marker > M_RST7) {
        action = 3;
      } else if (marker == M_RST0 + ((desired + 1) & 7) ||
                 marker == M_RST0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == M_RST0 + ((desired - 1) & 7) ||
                 marker == M_RST0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread_marker_ = 0;
        return;
      }
      if (action == 3) return;
      unread_marker_ = next_marker();
      marker = unread_marker_;
    }
  }

  void decode_mcu(int16_t** blocks, int nb) {
    if (restart_interval_ && restarts_to_go_ == 0) process_restart();
    if (!progressive_) {
      decode_sequential(blocks, nb);
    } else if (Ss_ == 0) {
      if (Ah_ == 0)
        dc_first(blocks, nb);
      else
        dc_refine(blocks, nb);
    } else if (Ah_ == 0) {
      ac_first(blocks[0]);
    } else {
      ac_refine(blocks[0]);
    }
    restarts_to_go_--;
  }

  const Component& block_comp(int b) const {
    return comp_[scan_comp_[comps_in_scan_ == 1 ? 0 : mcu_owner_[b]]];
  }
  int block_slot(int b) const { return comps_in_scan_ == 1 ? 0 : mcu_owner_[b]; }

  void decode_sequential(int16_t** blocks, int nb) {
    if (bits_.insufficient) return;
    for (int b = 0; b < nb; b++) {
      const Component& c = block_comp(b);
      int16_t* blk = blocks[b];
      blk[0] = int16_t(huff_dc(b));
      const HuffTable& ac = ac_tab_[c.ac_tbl];
      for (int k = 1; k < 64; k++) {
        int s = bits_.decode(ac);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          r = bits_.get(s);
          blk[kNatural[k]] = int16_t(extend(r, s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  // Block b's DC difference added to its component's prediction (Huffman).
  int huff_dc(int b) {
    int s = bits_.decode(dc_tab_[block_comp(b).dc_tbl]);
    if (s) {
      const int r = bits_.get(s);
      s = extend(r, s);
    }
    int& dc = last_dc_[block_slot(b)];
    dc = int(unsigned(dc) + unsigned(s));
    return dc;
  }

  void dc_first(int16_t** blocks, int nb) {
    if (bits_.insufficient) return;
    for (int b = 0; b < nb; b++) blocks[b][0] = int16_t(unsigned(huff_dc(b)) << Al_);
  }

  void dc_refine(int16_t** blocks, int nb) {
    const int p1 = 1 << Al_;
    for (int b = 0; b < nb; b++)
      if (bits_.get(1)) blocks[b][0] = int16_t(blocks[b][0] | p1);
  }

  void ac_first(int16_t* blk) {
    if (bits_.insufficient) return;
    if (eobrun_ > 0) {
      eobrun_--;
      return;
    }
    const HuffTable& t = ac_tab_[comp_[scan_comp_[0]].ac_tbl];
    for (int k = Ss_; k <= Se_; k++) {
      int s = bits_.decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = bits_.get(s);
        s = extend(r, s);
        blk[kNatural[k]] = int16_t(unsigned(s) << Al_);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += bits_.get(r);
        eobrun_--;
        break;
      }
    }
  }

  void ac_refine(int16_t* blk) {
    if (bits_.insufficient) return;
    const int p1 = 1 << Al_, m1 = int(~0u << Al_);
    const HuffTable& t = ac_tab_[comp_[scan_comp_[0]].ac_tbl];
    int k = Ss_;
    if (eobrun_ == 0) {
      for (; k <= Se_; k++) {
        int s = bits_.decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = bits_.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += bits_.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (bits_.get(1)) {
              if ((*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= Se_);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= Se_; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (bits_.get(1)) {
            if ((*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      eobrun_--;
    }
  }

  // ---------------------------------------------------------------- output

  // jdcoefct.c's smoothing_ok: a progressive file whose coefficients are not
  // all final, with every component's DC at least partly known.
  bool smoothing_ok(int latch[][2][10]) const {
    if (!progressive_) return false;
    bool useful = false;
    for (size_t ci = 0; ci < comp_.size(); ci++) {
      const Component& c = comp_[ci];
      if (!c.latched) return false;
      static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
      for (int p : pos)
        if (c.q[p] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      latch[ci][0][0] = c.coef_bits[0];
      for (int k = 1; k < 10; k++) {
        latch[ci][1][k] = input_scan_number_ > 1 ? c.prev_coef_bits[k] : -1;
        latch[ci][0][k] = c.coef_bits[k];
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  static int predict(int64_t num, int64_t q, int al, bool clamp) {
    int pred;
    if (num >= 0) {
      pred = int(((q << 7) + num) / (q << 8));
      if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = int(((q << 7) - num) / (q << 8));
      if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return pred;
  }

  // Block rows feeding decompress_smooth_data's 5x5 DC window around block
  // row `by`: two above, the row, two below. libjpeg decides by iMCU row, so
  // a neighbour two rows away in the next or previous iMCU row is replaced by
  // the nearer one when the component has v = 2 (and the window never
  // reaches past the image).
  void smooth_rows(const Component& c, int by, int rows[5]) const {
    const int v = c.v;
    const int imcu = by / v, block_row = by % v;
    const int last_imcu = total_imcu_rows_ - 1;
    int block_rows = v;
    if (imcu == last_imcu) {
      block_rows = c.height_in_blocks % v;
      if (block_rows == 0) block_rows = v;
    }
    const int prev = (block_row > 0 || imcu > 0) ? by - 1 : by;
    const int prev2 = (block_row > 1 || imcu > 1) ? by - 2 : prev;
    const int next = (block_row < block_rows - 1 || imcu < last_imcu) ? by + 1 : by;
    const int next2 = (block_row < block_rows - 2 || imcu + 1 < last_imcu) ? by + 2 : next;
    rows[0] = prev2;
    rows[1] = prev;
    rows[2] = by;
    rows[3] = next;
    rows[4] = next2;
  }

  // decompress_smooth_data's estimates for one block: `ws` is a copy of the
  // block, DC[1..25] the 5x5 window of DC values (row-major, block at 13).
  void smooth_block(const Component& c, const int* DC, const int* cb, int16_t* ws) const {
    const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 && cb[4] == -1 &&
                           cb[5] == -1 && cb[6] == -1 && cb[7] == -1 && cb[8] == -1 &&
                           cb[9] == -1;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9],
                  Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10], Q21 = c.q[17], Q30 = c.q[24];
    int al;
    if ((al = cb[1]) != 0 && ws[1] == 0) {
      const int64_t num =
          Q00 * (change_dc ? (-DC[1] - DC[2] + DC[4] + DC[5] - 3 * DC[6] + 13 * DC[7] -
                              13 * DC[9] + 3 * DC[10] - 3 * DC[11] + 38 * DC[12] -
                              38 * DC[14] + 3 * DC[15] - 3 * DC[16] + 13 * DC[17] -
                              13 * DC[19] + 3 * DC[20] - DC[21] - DC[22] + DC[24] + DC[25])
                           : (-7 * DC[11] + 50 * DC[12] - 50 * DC[14] + 7 * DC[15]));
      ws[1] = int16_t(predict(num, Q01, al, true));
    }
    if ((al = cb[2]) != 0 && ws[8] == 0) {
      const int64_t num =
          Q00 * (change_dc ? (-DC[1] - 3 * DC[2] - 3 * DC[3] - 3 * DC[4] - DC[5] - DC[6] +
                              13 * DC[7] + 38 * DC[8] + 13 * DC[9] - DC[10] + DC[16] -
                              13 * DC[17] - 38 * DC[18] - 13 * DC[19] + DC[20] + DC[21] +
                              3 * DC[22] + 3 * DC[23] + 3 * DC[24] + DC[25])
                           : (-7 * DC[3] + 50 * DC[8] - 50 * DC[18] + 7 * DC[23]));
      ws[8] = int16_t(predict(num, Q10, al, true));
    }
    if ((al = cb[3]) != 0 && ws[16] == 0) {
      const int64_t num =
          Q00 * (change_dc ? (DC[3] + 2 * DC[7] + 7 * DC[8] + 2 * DC[9] - 5 * DC[12] -
                              14 * DC[13] - 5 * DC[14] + 2 * DC[17] + 7 * DC[18] +
                              2 * DC[19] + DC[23])
                           : (-DC[3] + 13 * DC[8] - 24 * DC[13] + 13 * DC[18] - DC[23]));
      ws[16] = int16_t(predict(num, Q20, al, true));
    }
    if ((al = cb[4]) != 0 && ws[9] == 0) {
      const int64_t num =
          Q00 * (change_dc ? (-DC[1] + DC[5] + 9 * DC[7] - 9 * DC[9] - 9 * DC[17] +
                              9 * DC[19] + DC[21] - DC[25])
                           : (DC[10] + DC[16] - 10 * DC[17] + 10 * DC[19] - DC[2] - DC[20] +
                              DC[22] - DC[24] + DC[4] - DC[6] + 10 * DC[7] - 10 * DC[9]));
      ws[9] = int16_t(predict(num, Q11, al, true));
    }
    if ((al = cb[5]) != 0 && ws[2] == 0) {
      const int64_t num =
          Q00 * (change_dc ? (2 * DC[7] - 5 * DC[8] + 2 * DC[9] + DC[11] + 7 * DC[12] -
                              14 * DC[13] + 7 * DC[14] + DC[15] + 2 * DC[17] - 5 * DC[18] +
                              2 * DC[19])
                           : (-DC[11] + 13 * DC[12] - 24 * DC[13] + 13 * DC[14] - DC[15]));
      ws[2] = int16_t(predict(num, Q02, al, true));
    }
    if (change_dc) {
      if ((al = cb[6]) != 0 && ws[3] == 0) {
        const int64_t num = Q00 * (DC[7] - DC[9] + 2 * DC[12] - 2 * DC[14] + DC[17] - DC[19]);
        ws[3] = int16_t(predict(num, Q03, al, true));
      }
      if ((al = cb[7]) != 0 && ws[10] == 0) {
        const int64_t num = Q00 * (DC[7] - 3 * DC[8] + DC[9] - DC[17] + 3 * DC[18] - DC[19]);
        ws[10] = int16_t(predict(num, Q12, al, true));
      }
      if ((al = cb[8]) != 0 && ws[17] == 0) {
        const int64_t num = Q00 * (DC[7] - DC[9] - 3 * DC[12] + 3 * DC[14] + DC[17] - DC[19]);
        ws[17] = int16_t(predict(num, Q21, al, true));
      }
      if ((al = cb[9]) != 0 && ws[24] == 0) {
        const int64_t num = Q00 * (DC[7] + 2 * DC[8] + DC[9] - DC[17] - 2 * DC[18] - DC[19]);
        ws[24] = int16_t(predict(num, Q30, al, true));
      }
      const int64_t num =
          Q00 * (-2 * DC[1] - 6 * DC[2] - 8 * DC[3] - 6 * DC[4] - 2 * DC[5] - 6 * DC[6] +
                 6 * DC[7] + 42 * DC[8] + 6 * DC[9] - 6 * DC[10] - 8 * DC[11] + 42 * DC[12] +
                 152 * DC[13] + 42 * DC[14] - 8 * DC[15] - 6 * DC[16] + 6 * DC[17] +
                 42 * DC[18] + 6 * DC[19] - 6 * DC[20] - 2 * DC[21] - 6 * DC[22] -
                 8 * DC[23] - 6 * DC[24] - 2 * DC[25]);
      ws[0] = int16_t(predict(num, Q00, 0, false));
    }
  }

  void inverse_dct() {
    int latch[10][2][10];
    const bool smooth = smoothing_ok(latch);
    for (size_t ci = 0; ci < comp_.size(); ci++) {
      Component& c = comp_[ci];
      const int pw = c.width_in_blocks * 8;
      c.plane.assign(size_t(pw) * c.height_in_blocks * 8, 0);
      int16_t ws[64];
      for (int by = 0; by < c.height_in_blocks; by++) {
        uint8_t* out = c.plane.data() + size_t(by) * 8 * pw;
        if (!smooth) {
          for (int bx = 0; bx < c.width_in_blocks; bx++)
            idct_islow(c.block(by, bx), c.q, out + bx * 8, pw);
          continue;
        }
        const int* cb = latch[ci][by / c.v > last_good_imcu_row_ ? 1 : 0];
        int rows[5];
        smooth_rows(c, by, rows);
        // libjpeg's sliding registers: every column starts as column 0,
        // columns 1 and 2 are fetched while they exist, then shifted in.
        int DC[26];
        for (int r = 0; r < 5; r++)
          for (int k = 1; k <= 5; k++) DC[r * 5 + k] = c.block(rows[r], 0)[0];
        const int last = c.width_in_blocks - 1;
        for (int bx = 0; bx <= last; bx++) {
          if (bx == 0 && bx < last)
            for (int r = 0; r < 5; r++) DC[r * 5 + 4] = c.block(rows[r], 1)[0];
          if (bx + 1 < last)
            for (int r = 0; r < 5; r++) DC[r * 5 + 5] = c.block(rows[r], bx + 2)[0];
          std::memcpy(ws, c.block(by, bx), sizeof(ws));
          smooth_block(c, DC, cb, ws);
          idct_islow(ws, c.q, out + bx * 8, pw);
          for (int r = 0; r < 5; r++)
            for (int k = 1; k <= 4; k++) DC[r * 5 + k] = DC[r * 5 + k + 1];
        }
      }
    }
  }

  // One component upsampled to the output grid: out[y * width_ + x].
  void upsample(const Component& c, std::vector<uint8_t>* full) const {
    const int W = width_, H = height_, pw = c.width_in_blocks * 8;
    const uint8_t* p = c.plane.data();
    full->resize(size_t(W) * H);
    uint8_t* o = full->data();
    const int hx = max_h_ / c.h, vx = max_v_ / c.v;
    auto row = [&](int y) { return p + size_t(y < 0 ? 0 : y >= c.dh ? c.dh - 1 : y) * pw; };
    if (hx == 1 && vx == 1) {
      for (int y = 0; y < H; y++) std::memcpy(o + size_t(y) * W, p + size_t(y) * pw, W);
    } else if (hx == 2 && vx == 1 && c.dw > 2) {  // h2v1 fancy
      std::vector<uint8_t> tmp(size_t(c.dw) * 2);
      for (int y = 0; y < H; y++) {
        const uint8_t* in = p + size_t(y) * pw;
        uint8_t* t = tmp.data();
        int iv = in[0];
        t[0] = uint8_t(iv);
        t[1] = uint8_t((iv * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < c.dw - 1; x++) {
          iv = in[x] * 3;
          t[2 * x] = uint8_t((iv + in[x - 1] + 1) >> 2);
          t[2 * x + 1] = uint8_t((iv + in[x + 1] + 2) >> 2);
        }
        const int x = c.dw - 1;
        iv = in[x];
        t[2 * x] = uint8_t((iv * 3 + in[x - 1] + 1) >> 2);
        t[2 * x + 1] = uint8_t(iv);
        std::memcpy(o + size_t(y) * W, t, W);
      }
    } else if (hx == 1 && vx == 2) {  // h1v2 fancy
      for (int y = 0; y < H; y++) {
        const int in_row = y / 2;
        const bool upper = (y & 1) == 0;
        const uint8_t* near = row(in_row);
        const uint8_t* far = row(upper ? in_row - 1 : in_row + 1);
        const int bias = upper ? 1 : 2;
        uint8_t* out = o + size_t(y) * W;
        for (int x = 0; x < W; x++) out[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
      }
    } else if (hx == 2 && vx == 2 && c.dw > 2) {  // h2v2 fancy
      std::vector<uint8_t> tmp(size_t(c.dw) * 2);
      for (int y = 0; y < H; y++) {
        const int in_row = y / 2;
        const bool upper = (y & 1) == 0;
        const uint8_t* i0 = row(in_row);
        const uint8_t* i1 = row(upper ? in_row - 1 : in_row + 1);
        uint8_t* t = tmp.data();
        int this_sum = i0[0] * 3 + i1[0];
        int next_sum = i0[1] * 3 + i1[1];
        t[0] = uint8_t((this_sum * 4 + 8) >> 4);
        t[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < c.dw - 1; x++) {
          next_sum = i0[x + 1] * 3 + i1[x + 1];
          t[2 * x] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
          t[2 * x + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        const int x = c.dw - 1;
        t[2 * x] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        t[2 * x + 1] = uint8_t((this_sum * 4 + 7) >> 4);
        std::memcpy(o + size_t(y) * W, t, W);
      }
    } else {  // replication (h2v1/h2v2 on narrow images, other integral factors)
      for (int y = 0; y < H; y++) {
        const uint8_t* in = p + size_t(y / vx) * pw;
        uint8_t* out = o + size_t(y) * W;
        for (int x = 0; x < W; x++) out[x] = in[x / hx];
      }
    }
  }

  bool rgb_source() const {
    if (jfif_) return false;
    if (adobe_) return adobe_transform_ == 0;
    return comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
  }

  void output(Image* out) {
    inverse_dct();
    const int W = width_, H = height_;
    out->h = H;
    out->w = W;
    out->data.resize(size_t(W) * H * 3);
    uint8_t* o = out->data.data();
    if (comp_.size() == 1) {
      std::vector<uint8_t> g;
      upsample(comp_[0], &g);
      for (size_t i = 0; i < g.size(); i++) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> a, b, c;
    upsample(comp_[0], &a);
    upsample(comp_[1], &b);
    upsample(comp_[2], &c);
    if (rgb_source()) {
      for (size_t i = 0; i < a.size(); i++) {
        o[3 * i] = a[i];
        o[3 * i + 1] = b[i];
        o[3 * i + 2] = c[i];
      }
      return;
    }
    const YccTables& t = ycc();
    for (size_t i = 0; i < a.size(); i++) {
      const int y = a[i], cb = b[i], cr = c[i];
      o[3 * i] = clamp255(y + t.cr_r[cr]);
      o[3 * i + 1] = clamp255(y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * i + 2] = clamp255(y + t.cb_b[cb]);
    }
  }
};

}  // namespace jpeg_detail

inline void decode_jpeg(const uint8_t* data, size_t size, Image* out) {
  jpeg_detail::Decoder(data, size).decode(out);
}

}  // namespace emr2a
