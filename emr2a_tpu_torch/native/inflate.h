// Inflate (RFC 1950 zlib wrapper around RFC 1951 deflate) for the PNG
// decoder, with zlib's error cases and its input-consumption order.
//
// The PNG reader feeds compressed bytes in pieces (an IDAT chunk split into
// reads of at most 8,192 bytes, as libpng does), and which errors are fatal
// depends on where in that feed zlib notices them. So the input side is a
// callback: `next_piece` is asked for more bytes only when a symbol cannot be
// decoded from what is already held, exactly when zlib would return for more
// input. It may throw to stop decoding. Once `watch` bytes are out,
// `before_output` is called before each further byte is stored (and before a
// match's distance is checked, where zlib first looks for room to write),
// with the count stored so far; the PNG reader uses it to track the phase of
// its own read loop.
//
// Errors throw InflateError with zlib's message.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace emr2a {

struct InflateError {
  const char* msg;
};

inline uint32_t adler32_update(uint32_t adler, const uint8_t* p, size_t n) {
  // In blocks of 1,024 bytes: b grows by k * a plus the bytes weighted by
  // their distance from the block's end, a by their sum (no overflow in 32
  // bits at this block size), which the compiler can vectorise.
  uint32_t a = adler & 0xFFFF, b = adler >> 16;
  while (n > 0) {
    const uint32_t k = n < 1024 ? uint32_t(n) : 1024;
    uint32_t s1 = 0, s2 = 0;
    for (uint32_t i = 0; i < k; i++) {
      s1 += p[i];
      s2 += (k - i) * p[i];
    }
    b = (b + k * a + s2) % 65521;
    a = (a + s1) % 65521;
    p += k;
    n -= k;
  }
  return (b << 16) | a;
}

// A canonical Huffman code: a 12-bit table for short codes, the counts and
// sorted symbols for longer ones.
struct Huffman {
  static constexpr int kFast = 12;
  uint16_t fast[1 << kFast];  // (symbol << 4) | length, 0 = longer or invalid
  uint16_t count[16];
  uint16_t symbol[320];
  int max_len = 0;

  // zlib's inflate_table checks: over-subscribed is an error, incomplete is
  // an error unless `incomplete_ok_if_single` and the code is one symbol of
  // length 1.
  // Returns false on error.
  bool build(const uint8_t* lens, int n, bool incomplete_ok_if_single) {
    std::memset(count, 0, sizeof(count));
    for (int i = 0; i < n; i++) count[lens[i]]++;
    count[0] = 0;
    max_len = 0;
    for (int l = 15; l >= 1; l--)
      if (count[l]) {
        max_len = l;
        break;
      }
    std::memset(fast, 0, sizeof(fast));
    if (max_len == 0) return true;  // decoding reports the error
    int left = 1;
    for (int l = 1; l <= 15; l++) {
      left <<= 1;
      left -= count[l];
      if (left < 0) return false;  // over-subscribed
    }
    if (left > 0 && (!incomplete_ok_if_single || max_len != 1)) return false;
    uint16_t offs[17];
    offs[1] = 0;
    for (int l = 1; l < 16; l++) offs[l + 1] = offs[l] + count[l];
    for (int i = 0; i < n; i++)
      if (lens[i]) symbol[offs[lens[i]]++] = uint16_t(i);
    // Fast table: walk codes in canonical order.
    int code = 0, k = 0;
    for (int l = 1; l <= kFast && l <= 15; l++) {
      for (int j = 0; j < count[l]; j++, k++, code++) {
        int rev = 0;
        for (int b = 0; b < l; b++) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int fill = rev; fill < (1 << kFast); fill += 1 << l)
          fast[fill] = uint16_t((symbol[k] << 4) | l);
      }
      code <<= 1;
    }
    return true;
  }
};

class Inflater {
 public:
  // next_piece(ctx, &begin, &end) supplies more input or throws.
  using PieceFn = void (*)(void* ctx, const uint8_t** begin, const uint8_t** end);
  using EmitFn = void (*)(void* ctx, size_t produced);

  Inflater(PieceFn piece, EmitFn emit, void* ctx, size_t watch)
      : piece_(piece), emit_(emit), ctx_(ctx), watch_(watch) {
    store_.resize(watch + 1024);
    o_ = store_.data();
    cap_ = store_.size();
  }

  size_t size() const { return n_; }
  // The output; the inflater is spent afterwards.
  std::vector<uint8_t> take_output() {
    store_.resize(n_);
    return std::move(store_);
  }

  // Decodes the whole stream; returns normally at the end of a stream whose
  // Adler-32 matched.
  void run() {
    need(16);
    const uint32_t cmf = take(8), flg = take(8);
    if (((cmf << 8) + flg) % 31) throw InflateError{"incorrect header check"};
    if ((cmf & 15) != 8) throw InflateError{"unknown compression method"};
    if ((cmf >> 4) + 8 > 15) throw InflateError{"invalid window size"};
    if (flg & 0x20) throw InflateError{"need dictionary"};
    bool last = false;
    while (!last) {
      need(3);
      last = take(1);
      const uint32_t type = take(2);
      if (type == 0) {
        stored();
      } else if (type == 1) {
        fixed_tables();
        codes();
      } else if (type == 2) {
        dynamic_tables();
        codes();
      } else {
        throw InflateError{"invalid block type"};
      }
    }
    // Byte-align, then the big-endian Adler-32 of all output.
    drop(bits_ & 7);
    need(32);
    uint32_t want = 0;
    for (int i = 0; i < 4; i++) want = (want << 8) | take(8);
    const uint32_t got = adler32_update(1, o_, n_);
    if (got != want) throw InflateError{"incorrect data check"};
  }

 private:
  PieceFn piece_;
  EmitFn emit_;
  void* ctx_;
  size_t watch_;
  std::vector<uint8_t> store_;
  uint8_t* o_ = nullptr;
  size_t n_ = 0, cap_ = 0;
  const uint8_t* in_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t hold_ = 0;
  int bits_ = 0;
  Huffman lens_, dists_;

  // Loads held bits from the current piece only (never asks for a new one).
  inline void prefetch() {
    if (end_ - in_ >= 8) {
      uint64_t v;
      std::memcpy(&v, in_, 8);  // little-endian, as the bit order needs
      hold_ |= v << bits_;
      in_ += (63 - bits_) >> 3;
      bits_ |= 56;
      hold_ &= bits_ == 64 ? ~uint64_t(0) : (uint64_t(1) << bits_) - 1;
      return;
    }
    while (bits_ <= 56 && in_ < end_) {
      hold_ |= uint64_t(*in_++) << bits_;
      bits_ += 8;
    }
  }
  // Makes n bits available, asking for new pieces as needed.
  inline void need(int n) {
    while (bits_ < n) {
      if (in_ == end_) piece_(ctx_, &in_, &end_);
      hold_ |= uint64_t(*in_++) << bits_;
      bits_ += 8;
    }
  }
  inline uint32_t take(int n) {
    const uint32_t v = uint32_t(hold_ & ((uint64_t(1) << n) - 1));
    hold_ >>= n;
    bits_ -= n;
    return v;
  }
  inline void drop(int n) {
    hold_ >>= n;
    bits_ -= n;
  }

  inline void room(size_t k) {
    if (n_ + k > cap_) {
      store_.resize(cap_ * 2 > n_ + k ? cap_ * 2 : n_ + k);
      o_ = store_.data();
      cap_ = store_.size();
    }
  }
  inline void put(uint8_t b) {
    if (n_ >= watch_) emit_(ctx_, n_);
    room(1);
    o_[n_++] = b;
  }

  // One symbol, pulling a byte only when the held bits cannot decide it.
  int decode(const Huffman& h) {
    prefetch();
    const uint16_t e = h.fast[hold_ & ((1u << Huffman::kFast) - 1)];
    if (e && (e & 15) <= bits_) {
      drop(e & 15);
      return e >> 4;
    }
    if (h.max_len == 0) {  // no codes: zlib consumes one bit, then fails
      need(1);
      drop(1);
      return -1;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= h.max_len; l++) {
      need(1);
      code |= take(1);
      const int c = h.count[l];
      if (code - first < c) return h.symbol[index + code - first];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    return -1;  // only the missing half of a one-symbol code reaches here
  }

  void stored() {
    drop(bits_ & 7);
    need(32);
    const uint32_t len = take(16), nlen = take(16);
    if (len != (nlen ^ 0xFFFF)) throw InflateError{"invalid stored block lengths"};
    for (uint32_t i = 0; i < len; i++) {
      if (bits_ >= 8) {
        put(uint8_t(take(8)));
      } else {
        if (in_ == end_) piece_(ctx_, &in_, &end_);
        put(*in_++);
      }
    }
  }

  void fixed_tables() {
    uint8_t l[288];
    int i = 0;
    for (; i < 144; i++) l[i] = 8;
    for (; i < 256; i++) l[i] = 9;
    for (; i < 280; i++) l[i] = 7;
    for (; i < 288; i++) l[i] = 8;
    lens_.build(l, 288, false);
    uint8_t d[32];
    for (i = 0; i < 32; i++) d[i] = 5;
    dists_.build(d, 32, false);
  }

  void dynamic_tables() {
    static const uint8_t order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                      11, 4,  12, 3, 13, 2, 14, 1, 15};
    need(14);
    const int nlen = int(take(5)) + 257, ndist = int(take(5)) + 1,
              ncode = int(take(4)) + 4;
    if (nlen > 286 || ndist > 30)
      throw InflateError{"too many length or distance symbols"};
    uint8_t cl[19] = {0};
    for (int i = 0; i < ncode; i++) {
      need(3);
      cl[order[i]] = uint8_t(take(3));
    }
    Huffman codes;
    if (!codes.build(cl, 19, false)) throw InflateError{"invalid code lengths set"};
    uint8_t l[320] = {0};
    int have = 0;
    while (have < nlen + ndist) {
      int sym = decode(codes);
      if (sym < 0) sym = 0;  // zlib reads an invalid code-length code as 0
      if (sym < 16) {
        l[have++] = uint8_t(sym);
        continue;
      }
      int len = 0, copy;
      if (sym == 16) {
        need(2);
        if (have == 0) throw InflateError{"invalid bit length repeat"};
        len = l[have - 1];
        copy = 3 + int(take(2));
      } else if (sym == 17) {
        need(3);
        copy = 3 + int(take(3));
      } else {
        need(7);
        copy = 11 + int(take(7));
      }
      if (have + copy > nlen + ndist) throw InflateError{"invalid bit length repeat"};
      while (copy--) l[have++] = uint8_t(len);
    }
    if (l[256] == 0) throw InflateError{"invalid code -- missing end-of-block"};
    if (!lens_.build(l, nlen, true)) throw InflateError{"invalid literal/lengths set"};
    if (!dists_.build(l + nlen, ndist, true)) throw InflateError{"invalid distances set"};
  }

  void codes() {
    static const uint16_t len_base[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  13,
                                          15, 17, 19, 23, 27, 31, 35, 43,  51,  59,
                                          67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const uint8_t len_extra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                          2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const uint16_t dist_base[30] = {
        1,   2,   3,   4,   5,   7,    9,    13,   17,   25,   33,   49,   65,    97,    129,
        193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
    static const uint8_t dist_extra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                           6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    for (;;) {
      const int sym = decode(lens_);
      if (unsigned(sym) < 256) {
        if (n_ < watch_) {  // the buffer holds watch_ bytes and more
          o_[n_++] = uint8_t(sym);
        } else {
          put(uint8_t(sym));
        }
        continue;
      }
      if (sym < 0 || sym > 285) throw InflateError{"invalid literal/length code"};
      if (sym == 256) return;
      const int li = sym - 257;
      need(len_extra[li]);
      const int len = len_base[li] + int(take(len_extra[li]));
      const int ds = decode(dists_);
      if (ds < 0 || ds > 29) throw InflateError{"invalid distance code"};
      need(dist_extra[ds]);
      const size_t dist = dist_base[ds] + take(dist_extra[ds]);
      if (n_ >= watch_) emit_(ctx_, n_);
      if (dist > n_) throw InflateError{"invalid distance too far back"};
      if (n_ + len <= watch_) {
        room(len);
        uint8_t* d = o_ + n_;
        const uint8_t* s = d - dist;
        for (int i = 0; i < len; i++) d[i] = s[i];  // may overlap forwards
        n_ += len;
      } else {
        for (int i = 0; i < len; i++) put(o_[n_ - dist]);
      }
    }
  }
};

}  // namespace emr2a
