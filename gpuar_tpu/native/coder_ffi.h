// Shape checks shared by the CPU and CUDA bindings of the coder op.
//
//   gip_encode:       words [n, packet_size / 4], sizes [1, n]
//                     -> rows [n, cap], lengths [1, n]
//   gip_decode:       rows [n, cap], sizes [1, n] -> words [n, packet_size / 4]
//   gip_decode_debug: as gip_decode, plus flags [2, n] (row 0: invariant
//                     violation, row 1: final bit cursor)
//
// All buffers are i32.  `sizes` holds raw byte counts; values outside
// [0, packet_size] are clamped.
#pragma once

#include <cstdint>
#include <string>

#include "coder.h"
#include "xla/ffi/api/ffi.h"

namespace gip {

namespace ffi = xla::ffi;

// Packets must stay below MAX_PROBABILITY - MODEL_SIZE bytes so the model's
// counts stay below 1 << 14 (config.CodecConfig): past that the coder's
// ranges lose their order and its u16 Fenwick nodes overflow.
constexpr int32_t kMaxPacketSize = (1 << 14) - 257;

struct Geometry {
  int64_t n;          // packets
  int64_t raw_words;  // packet_size / 4
  int64_t cap;        // framed row capacity in words
};

inline bool is_row(ffi::Span<const int64_t> d, int64_t n) {
  return d.size() == 2 && d[0] == 1 && d[1] == n;
}

inline ffi::Error check(ffi::Span<const int64_t> raw,
                        ffi::Span<const int64_t> framed,
                        ffi::Span<const int64_t> sizes, int32_t packet_size,
                        Geometry* g) {
  if (packet_size <= 0 || packet_size % 16 != 0 ||
      packet_size >= kMaxPacketSize)
    return ffi::Error::InvalidArgument(
        "packet_size must be a positive multiple of 16 below " +
        std::to_string(kMaxPacketSize) + ", got " +
        std::to_string(packet_size));
  if (raw.size() != 2 || framed.size() != 2 || raw[0] != framed[0])
    return ffi::Error::InvalidArgument(
        "raw and framed packets must be [n, words] with equal n");
  if (raw[1] * 4 != packet_size)
    return ffi::Error::InvalidArgument(
        "raw rows hold " + std::to_string(raw[1] * 4) +
        " bytes, packet_size is " + std::to_string(packet_size));
  if (framed[1] < 1)
    return ffi::Error::InvalidArgument("framed rows need at least one word");
  if (framed[1] % 4 != 0)
    return ffi::Error::InvalidArgument(
        "framed rows must be a whole number of 16-byte groups");
  if (!is_row(sizes, raw[0]))
    return ffi::Error::InvalidArgument("sizes must be [1, n]");
  g->n = raw[0];
  g->raw_words = raw[1];
  g->cap = framed[1];
  return ffi::Error::Success();
}

GIP_HD int clamp_raw(int32_t size, int packet_size) {
  return size < 0 ? 0 : (size > packet_size ? packet_size : size);
}

}  // namespace gip
