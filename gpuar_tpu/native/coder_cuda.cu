// CUDA binding of the coder op for Hopper (nvcc, sm_90a).
//
// One thread codes one packet with its own Fenwick model in shared memory,
// interleaved word by word across the block (coder.h, Model), so a block
// of kBlock packets holds kBlock * 512 bytes of models.  Residency is
// bounded by shared memory: __launch_bounds__ caps registers so that every
// block the SM's shared memory can hold also fits its register file, and
// gip_device_geometry reports the resulting packets per SM, from which the
// caller sizes its super-batches (as the reference sizes launches from the
// SM count).  Handlers only enqueue on the stream XLA passes them.

#include <cuda_runtime.h>

#include <atomic>

#include "coder_ffi.h"

namespace gip {
namespace {

constexpr int kBlock = 32;  // packets (threads) per block, as the reference
constexpr int kTreeBytes = kTreeWords * kBlock * 4;
// Shared memory of one Hopper SM, and the 1 KiB the runtime reserves per
// block: the blocks the SM can hold once every block has its models.
constexpr int kSmemPerSm = 228 * 1024;
constexpr int kBlocksPerSm = kSmemPerSm / (kTreeBytes + 1024);

__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
    encode_kernel(const uint32_t* in, const int32_t* sizes, uint32_t* out,
                  int32_t* lens, int n, int raw_words, int cap) {
  __shared__ uint32_t tree[kTreeWords * kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  lens[i] = encode_packet(Model{tree + threadIdx.x, kBlock},
                          in + static_cast<size_t>(i) * raw_words,
                          clamp_raw(sizes[i], raw_words * 4),
                          out + static_cast<size_t>(i) * cap, cap);
}

template <bool DEBUG>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
    decode_kernel(const uint32_t* in, const int32_t* sizes, uint32_t* out,
                  int32_t* flags, int n, int raw_words, int cap) {
  __shared__ uint32_t tree[kTreeWords * kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  decode_packet<DEBUG>(Model{tree + threadIdx.x, kBlock},
                       in + static_cast<size_t>(i) * cap, cap,
                       clamp_raw(sizes[i], raw_words * 4),
                       out + static_cast<size_t>(i) * raw_words, raw_words,
                       DEBUG ? flags + i : nullptr,
                       DEBUG ? flags + n + i : nullptr);
}

// Ask each device once for the largest shared-memory carveout, so that the
// L1/shared split never caps residency below kBlocksPerSm.  The attribute
// is per device, so a process that drives several cards sets it on each.
constexpr int kMaxDevices = 64;
std::atomic<bool> configured[kMaxDevices];

cudaError_t configure_device() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= kMaxDevices || configured[dev].load())
    return e;
  const void* kernels[] = {
      reinterpret_cast<const void*>(&encode_kernel),
      reinterpret_cast<const void*>(&decode_kernel<false>),
      reinterpret_cast<const void*>(&decode_kernel<true>)};
  for (const void* k : kernels) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  configured[dev].store(true);
  return cudaSuccess;
}

ffi::Error launched(cudaError_t setup) {
  const cudaError_t e = setup != cudaSuccess ? setup : cudaGetLastError();
  if (e != cudaSuccess)
    return ffi::Error::Internal(std::string("gip kernel launch: ") +
                                cudaGetErrorString(e));
  return ffi::Error::Success();
}

unsigned grid(int64_t n) { return static_cast<unsigned>((n + kBlock - 1) / kBlock); }

ffi::Error Encode(cudaStream_t stream, ffi::Buffer<ffi::S32> words,
                  ffi::Buffer<ffi::S32> sizes,
                  ffi::ResultBuffer<ffi::S32> rows,
                  ffi::ResultBuffer<ffi::S32> lens, int32_t packet_size) {
  Geometry g;
  ffi::Error e = check(words.dimensions(), rows->dimensions(),
                       sizes.dimensions(), packet_size, &g);
  if (e.failure()) return e;
  if (!is_row(lens->dimensions(), g.n))
    return ffi::Error::InvalidArgument("lengths must be [1, n]");
  if (g.n == 0) return ffi::Error::Success();
  const cudaError_t setup = configure_device();
  if (setup == cudaSuccess)
    encode_kernel<<<grid(g.n), kBlock, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(words.typed_data()),
        sizes.typed_data(), reinterpret_cast<uint32_t*>(rows->typed_data()),
        lens->typed_data(), static_cast<int>(g.n),
        static_cast<int>(g.raw_words), static_cast<int>(g.cap));
  return launched(setup);
}

template <bool DEBUG>
ffi::Error DecodeRows(cudaStream_t stream, ffi::Buffer<ffi::S32>& rows,
                      ffi::Buffer<ffi::S32>& sizes,
                      ffi::ResultBuffer<ffi::S32>& words, int32_t* flags,
                      int32_t packet_size) {
  Geometry g;
  ffi::Error e = check(words->dimensions(), rows.dimensions(),
                       sizes.dimensions(), packet_size, &g);
  if (e.failure()) return e;
  if (g.n == 0) return ffi::Error::Success();
  const cudaError_t setup = configure_device();
  if (setup == cudaSuccess)
    decode_kernel<DEBUG><<<grid(g.n), kBlock, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(rows.typed_data()),
        sizes.typed_data(), reinterpret_cast<uint32_t*>(words->typed_data()),
        flags, static_cast<int>(g.n), static_cast<int>(g.raw_words),
        static_cast<int>(g.cap));
  return launched(setup);
}

ffi::Error Decode(cudaStream_t stream, ffi::Buffer<ffi::S32> rows,
                  ffi::Buffer<ffi::S32> sizes,
                  ffi::ResultBuffer<ffi::S32> words, int32_t packet_size) {
  return DecodeRows<false>(stream, rows, sizes, words, nullptr, packet_size);
}

ffi::Error DecodeDebug(cudaStream_t stream, ffi::Buffer<ffi::S32> rows,
                       ffi::Buffer<ffi::S32> sizes,
                       ffi::ResultBuffer<ffi::S32> words,
                       ffi::ResultBuffer<ffi::S32> flags,
                       int32_t packet_size) {
  const auto d = flags->dimensions();
  if (d.size() != 2 || d[0] != 2 || d[1] != rows.dimensions()[0])
    return ffi::Error::InvalidArgument("flags must be [2, n]");
  return DecodeRows<true>(stream, rows, sizes, words, flags->typed_data(),
                          packet_size);
}

}  // namespace
}  // namespace gip

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    gip_encode, gip::Encode,
    xla::ffi::Ffi::Bind()
        .Ctx<xla::ffi::PlatformStream<cudaStream_t>>()
        .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
        .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
        .Ret<xla::ffi::Buffer<xla::ffi::S32>>()
        .Ret<xla::ffi::Buffer<xla::ffi::S32>>()
        .Attr<int32_t>("packet_size"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    gip_decode, gip::Decode,
    xla::ffi::Ffi::Bind()
        .Ctx<xla::ffi::PlatformStream<cudaStream_t>>()
        .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
        .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
        .Ret<xla::ffi::Buffer<xla::ffi::S32>>()
        .Attr<int32_t>("packet_size"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    gip_decode_debug, gip::DecodeDebug,
    xla::ffi::Ffi::Bind()
        .Ctx<xla::ffi::PlatformStream<cudaStream_t>>()
        .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
        .Arg<xla::ffi::Buffer<xla::ffi::S32>>()
        .Ret<xla::ffi::Buffer<xla::ffi::S32>>()
        .Ret<xla::ffi::Buffer<xla::ffi::S32>>()
        .Attr<int32_t>("packet_size"));

// SM count of CUDA device `device` and the packets one SM holds at once
// (the smallest residency of the three kernels).  Returns a cudaError_t.
extern "C" int gip_device_geometry(int device, int* sm_count,
                                   int* packets_per_sm) {
  cudaError_t e = cudaDeviceGetAttribute(
      sm_count, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = gip::configure_device();
  int least = 1 << 30;
  const void* kernels[] = {
      reinterpret_cast<const void*>(&gip::encode_kernel),
      reinterpret_cast<const void*>(&gip::decode_kernel<false>),
      reinterpret_cast<const void*>(&gip::decode_kernel<true>)};
  for (const void* k : kernels) {
    if (e != cudaSuccess) break;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                      gip::kBlock, 0);
    if (blocks < least) least = blocks;
  }
  *packets_per_sm = least * gip::kBlock;
  const cudaError_t restore = cudaSetDevice(prev);
  return e != cudaSuccess ? e : restore;
}
