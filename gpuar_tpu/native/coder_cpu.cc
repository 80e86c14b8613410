// CPU binding of the coder op (g++): the same per-packet coder as the CUDA
// build, run in a loop over the packets of the call.  XLA lowers the op per
// platform, so this is what a process whose devices are CPUs runs.

#include "coder_ffi.h"

namespace gip {
namespace {

ffi::Error Encode(ffi::Buffer<ffi::S32> words, ffi::Buffer<ffi::S32> sizes,
                  ffi::ResultBuffer<ffi::S32> rows,
                  ffi::ResultBuffer<ffi::S32> lens, int32_t packet_size) {
  Geometry g;
  ffi::Error e = check(words.dimensions(), rows->dimensions(),
                       sizes.dimensions(), packet_size, &g);
  if (e.failure()) return e;
  if (!is_row(lens->dimensions(), g.n))
    return ffi::Error::InvalidArgument("lengths must be [1, n]");
  const auto* in = reinterpret_cast<const uint32_t*>(words.typed_data());
  auto* out = reinterpret_cast<uint32_t*>(rows->typed_data());
  uint32_t tree[kTreeWords];
  for (int64_t i = 0; i < g.n; ++i)
    lens->typed_data()[i] = encode_packet(
        Model{tree, 1}, in + i * g.raw_words,
        clamp_raw(sizes.typed_data()[i], packet_size), out + i * g.cap,
        static_cast<int>(g.cap));
  return ffi::Error::Success();
}

template <bool DEBUG>
ffi::Error DecodeRows(ffi::Buffer<ffi::S32>& rows, ffi::Buffer<ffi::S32>& sizes,
                      ffi::ResultBuffer<ffi::S32>& words, int32_t* flags,
                      int32_t packet_size) {
  Geometry g;
  ffi::Error e = check(words->dimensions(), rows.dimensions(),
                       sizes.dimensions(), packet_size, &g);
  if (e.failure()) return e;
  const auto* in = reinterpret_cast<const uint32_t*>(rows.typed_data());
  auto* out = reinterpret_cast<uint32_t*>(words->typed_data());
  uint32_t tree[kTreeWords];
  for (int64_t i = 0; i < g.n; ++i)
    decode_packet<DEBUG>(
        Model{tree, 1}, in + i * g.cap, static_cast<int>(g.cap),
        clamp_raw(sizes.typed_data()[i], packet_size), out + i * g.raw_words,
        static_cast<int>(g.raw_words), DEBUG ? flags + i : nullptr,
        DEBUG ? flags + g.n + i : nullptr);
  return ffi::Error::Success();
}

ffi::Error Decode(ffi::Buffer<ffi::S32> rows, ffi::Buffer<ffi::S32> sizes,
                  ffi::ResultBuffer<ffi::S32> words, int32_t packet_size) {
  return DecodeRows<false>(rows, sizes, words, nullptr, packet_size);
}

ffi::Error DecodeDebug(ffi::Buffer<ffi::S32> rows, ffi::Buffer<ffi::S32> sizes,
                       ffi::ResultBuffer<ffi::S32> words,
                       ffi::ResultBuffer<ffi::S32> flags,
                       int32_t packet_size) {
  const auto d = flags->dimensions();
  if (d.size() != 2 || d[0] != 2 || d[1] != rows.dimensions()[0])
    return ffi::Error::InvalidArgument("flags must be [2, n]");
  return DecodeRows<true>(rows, sizes, words, flags->typed_data(),
                          packet_size);
}

}  // namespace
}  // namespace gip

XLA_FFI_DEFINE_HANDLER_SYMBOL(gip_encode, gip::Encode,
                              xla::ffi::Ffi::Bind()
                                  .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Ret<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Ret<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Attr<int32_t>("packet_size"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(gip_decode, gip::Decode,
                              xla::ffi::Ffi::Bind()
                                  .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Ret<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Attr<int32_t>("packet_size"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(gip_decode_debug, gip::DecodeDebug,
                              xla::ffi::Ffi::Bind()
                                  .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Ret<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Ret<xla::ffi::Buffer<xla::ffi::S32>>()
                                  .Attr<int32_t>("packet_size"));
