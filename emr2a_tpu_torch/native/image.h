// The decoders' output: 8-bit RGB, row-major.

#pragma once

#include <cstdint>
#include <vector>

namespace emr2a {

struct Image {
  std::vector<uint8_t> data;  // h * w * 3
  int h = 0, w = 0;
};

// A decode that fails (the pool zeroes the row and reports ok = 0).
struct DecodeError {};

}  // namespace emr2a
