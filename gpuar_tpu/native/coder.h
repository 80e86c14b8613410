// One serial adaptive arithmetic coder per packet: encode, decode and the
// debug decode, written once and compiled twice.
//
// Under nvcc every function is __host__ __device__ and one CUDA thread runs
// one packet (coder_cuda.cu); under g++ the same functions run in a loop
// over packets (coder_cpu.cc).  The bitstream is the one the reference
// writes (jiahansu/GPUAR src/gpuar_kernel.cu, arCompress :487-531 and
// arDecompress :848-892); the specification is ops/golden.py, the
// closed-form renormalisation is derived in ops/xla_codec.py, and every
// packet is tested for bit-equality against native/golden.cpp.
//
// Layout of a framed packet row (i32 words, little-endian bytes):
//   word 0   = total_bytes | raw_bytes << 16   (the [u16 LE][u16 LE] header)
//   word 1.. = the bitstream, MSB-first, so each word is stored byte-swapped.
#pragma once

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define GIP_HD __host__ __device__ __forceinline__
#else
#define GIP_HD inline
#endif

namespace gip {

constexpr uint32_t kU16 = 0xFFFFu;
constexpr uint32_t kInitCum = 256;  // every symbol starts with count 1
constexpr int kTreeWords = 128;     // 256 u16 Fenwick nodes, two per word

GIP_HD int clz16(uint32_t x) {  // leading zeros of a 16-bit value; 16 for 0
#ifdef __CUDA_ARCH__
  return __clz(static_cast<int>(x)) - 16;
#else
  return x ? __builtin_clz(x) - 16 : 16;
#endif
}

GIP_HD uint32_t bswap32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

// 16 bytes of a row as four little-endian words (one ulonglong2-sized load
// on the device, as the reference reads its input).
GIP_HD void load16(const uint32_t* p, uint32_t v[4]) {
#ifdef __CUDA_ARCH__
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
#else
  std::memcpy(v, p, 16);
#endif
}

GIP_HD void store16(uint32_t* p, uint32_t a, uint32_t b, uint32_t c,
                    uint32_t d) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
#else
  const uint32_t v[4] = {a, b, c, d};
  std::memcpy(p, v, 16);
#endif
}

// The adaptive order-0 model as a Fenwick tree over the 256 symbol counts
// (the reference keeps the same counts in a Fenwick tree too).  Node j
// (1..256) covers symbols (j - lowbit(j), j]; C[s] is the count of coded
// symbols below s plus s.  Two u16 nodes share one u32 word; consecutive
// words of one coder sit `stride` words apart, so on the device the
// threads of a warp interleave word by word and always hit distinct
// shared-memory banks.  Counts stay below 256 + 8192, so halves never carry.
struct Model {
  uint32_t* w;
  int stride;

  GIP_HD uint32_t node(int j) const {
    const int r = j - 1;
    return (w[(r >> 1) * stride] >> ((r & 1) << 4)) & kU16;
  }
  GIP_HD void reset() {
    for (int p = 0; p < kTreeWords; ++p) {
      const uint32_t j0 = 2 * p + 1, j1 = 2 * p + 2;
      w[p * stride] = (j0 & (0u - j0)) | ((j1 & (0u - j1)) << 16);
    }
  }
  // C[s] for 0 <= s <= 256.
  GIP_HD uint32_t prefix(int s) const {
    uint32_t c = 0;
    for (; s > 0; s &= s - 1) c += node(s);
    return c;
  }
  // Count one more `sym`: C[i] += 1 for every i > sym.
  GIP_HD void add(int sym) {
    for (int j = sym + 1; j <= 256; j += j & -j)
      w[((j - 1) >> 1) * stride] += 1u << (((j - 1) & 1) << 4);
  }
  // Decode search: the largest s with C[s] <= u, by descent over the tree.
  // Sets *lo = C[s] and *hi = C[s + 1]: the node that the last failed probe
  // read is exactly s + 1 (the lowest zero bit of s), so its prefix is
  // C[s + 1]; when no probe fails, s = 255 and C[256] = cum.
  GIP_HD int find(uint32_t u, uint32_t cum, uint32_t* lo,
                  uint32_t* hi) const {
    int pos = 0;
    uint32_t c = 0, h = cum;
    for (int step = 128; step; step >>= 1) {
      const uint32_t t = node(pos + step);
      if (c + t <= u) {
        pos += step;
        c += t;
      } else {
        h = c + t;
      }
    }
    *lo = c;
    *hi = h;
    return pos;
  }
};

// Closed-form renormalisation of bounds (lo, hi) after a range restriction
// (ops/xla_codec.py derives it): m settled MSBs, then k underflow removals.
struct Renorm {
  int m, k;
  uint32_t lo, hi;
};

GIP_HD Renorm renorm(uint32_t lo, uint32_t hi) {
  Renorm r;
  r.m = clz16(lo ^ hi);
  const uint32_t la = (lo << r.m) & kU16;
  const uint32_t ua = ((hi << r.m) | ((1u << r.m) - 1u)) & kU16;
  const uint32_t a = (la << 1) & kU16;
  const uint32_t b = ((ua << 1) | 1u) & kU16;
  r.k = clz16(~(a & ~b) & kU16);
  r.lo = (la << r.k) & 0x7FFFu;
  r.hi = ((ua << r.k) | ((1u << r.k) - 1u) | 0x8000u) & kU16;
  return r;
}

// MSB-first bit writer into a row of `cap` words.  Words past the row are
// counted but not stored; the caller sees the true length and reports the
// overflow.
struct BitOut {
  uint32_t* row;
  int cap;
  int next;      // next word index (word 0 is the header)
  uint64_t acc;  // pending bits, right-aligned
  int n;         // pending bit count, < 32 between calls

  GIP_HD void put(uint32_t word) {
    if (next < cap) row[next] = bswap32(word);
    ++next;
  }
  // Append the low k bits of v (v < 2^k), k <= 32.
  GIP_HD void append(uint32_t v, int k) {
    acc = (acc << k) | v;
    n += k;
    if (n >= 32) {
      n -= 32;
      put(static_cast<uint32_t>(acc >> n));
    }
  }
  // Append `len` copies of `bit` (underflow runs can exceed 32).
  GIP_HD void run(uint32_t bit, uint32_t len) {
    while (len) {
      const int c = len > 32 ? 32 : static_cast<int>(len);
      append(bit ? 0xFFFFFFFFu >> (32 - c) : 0u, c);
      len -= c;
    }
  }
  // Settled bit b, then `under` complements of it, then `rest` (k bits).
  GIP_HD void settle(uint32_t b, uint32_t under, uint32_t rest, int k) {
    if (under + k < 32) {  // the common case: one append
      const uint32_t run_bits = b ? 0u : (1u << under) - 1u;
      append((((b << under) | run_bits) << k) | rest,
             static_cast<int>(under) + 1 + k);
    } else {
      append(b, 1);
      run(b ^ 1u, under);
      append(rest, k);
    }
  }
  // Left-align the final partial word; returns the stream length in bytes
  // past the header.
  GIP_HD int close() {
    const int bytes = (next - 1) * 4 + (n + 7) / 8;
    if (n) put(static_cast<uint32_t>(acc << (32 - n)));
    return bytes;
  }
};

// MSB-first bit reader over bytes [4, end) of a row; bytes past `end` read
// as 0, as in the golden codec (their values never change a valid decode).
struct BitIn {
  const uint32_t* row;
  int end;
  int next;
  uint64_t win;
  int n;

  GIP_HD uint32_t fetch() {
    const int off = next * 4;
    uint32_t w = 0;
    if (off < end) {
      w = bswap32(row[next]);
      const int keep = end - off;
      if (keep < 4) w &= ~(0xFFFFFFFFu >> (8 * keep));
    }
    ++next;
    return w;
  }
  // Take k <= 16 bits.
  GIP_HD uint32_t take(int k) {
    if (n < 32) {
      win = (win << 32) | fetch();
      n += 32;
    }
    n -= k;
    return static_cast<uint32_t>(win >> n) & ((1u << k) - 1u);
  }
  // Bits consumed, counted from the start of the row (header included).
  GIP_HD int cursor() const { return next * 32 - n; }
};

// Encode `raw` bytes (LE words `in`) into a framed packet row of `cap`
// words.  Returns the packet length in bytes, header included; a length
// above 4 * cap means the stream did not fit and the row is incomplete.
GIP_HD int encode_packet(Model m, const uint32_t* in, int raw, uint32_t* out,
                         int cap) {
  m.reset();
  uint32_t lo = 0, hi = kU16, under = 0, cum = kInitCum;
  BitOut bo{out, cap, 1, 0, 0};
  for (int base = 0; base < raw; base += 16) {
    uint32_t v[4];
    load16(in + base / 4, v);
    const int stop = raw - base < 16 ? raw - base : 16;
    for (int i = 0; i < stop; ++i) {
      // Constant indices keep v in registers (the loop is not unrolled).
      const int q = i >> 2;
      const uint32_t word = q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2]
                                                                   : v[3];
      const int sym = (word >> ((i & 3) * 8)) & 0xFF;
      const uint32_t c_lo = m.prefix(sym), c_hi = m.prefix(sym + 1);
      const uint32_t span = hi - lo + 1;
      const uint32_t hi2 = (lo + c_hi * span / cum - 1) & kU16;
      const uint32_t lo2 = (lo + c_lo * span / cum) & kU16;
      m.add(sym);
      ++cum;
      const Renorm r = renorm(lo2, hi2);
      if (r.m) {
        const uint32_t top = hi2 >> (16 - r.m);  // the m settled bits
        bo.settle(top >> (r.m - 1), under, top & ((1u << (r.m - 1)) - 1u),
                  r.m - 1);
        under = 0;
      }
      under += r.k;
      lo = r.lo;
      hi = r.hi;
    }
  }
  // Tail flush (writeRemaining :379-388): lower's second bit, then
  // under + 1 complements; then the byte-aligned close (writeClose).
  bo.settle((lo >> 14) & 1u, under + 1, 0, 0);
  const int total = 4 + bo.close();
  if (cap > 0) out[0] = (static_cast<uint32_t>(total) & kU16) |
                        (static_cast<uint32_t>(raw) << 16);
  return total;
}

// Decode a framed packet row of `cap` words into `raw` bytes, written as
// `out_words` LE words (zero past `raw`).  With DEBUG, *flag is set on the
// reference's -D_DEBUG conditions (the search target outside [0, cum),
// src/gpuar_kernel.cu:758-762; range inversion, :290-298) and *cursor
// receives the final bit cursor for the overrun check.
template <bool DEBUG>
GIP_HD void decode_packet(Model m, const uint32_t* in, int cap, int raw,
                          uint32_t* out, int out_words, int* flag,
                          int* cursor) {
  m.reset();
  int total = static_cast<int>(in[0] & kU16);
  if (total > 4 * cap) total = 4 * cap;
  BitIn bi{in, total, 1, 0, 0};
  uint32_t code = bi.take(16);
  uint32_t lo = 0, hi = kU16, cum = kInitCum;
  int bad = 0;
  int base = 0;
  for (; base < raw; base += 16) {
    uint32_t o0 = 0, o1 = 0, o2 = 0, o3 = 0;
    const int stop = raw - base < 16 ? raw - base : 16;
    for (int i = 0; i < stop; ++i) {
      const uint32_t span = hi - lo + 1;
      const int num = (static_cast<int>(code) - static_cast<int>(lo) + 1) *
                          static_cast<int>(cum) - 1;
      const uint32_t u = num < 0 ? 0u : static_cast<uint32_t>(num) / span;
      uint32_t c_lo, c_hi;
      const int sym = m.find(u, cum, &c_lo, &c_hi);
      const uint32_t hi2 = (lo + c_hi * span / cum - 1) & kU16;
      const uint32_t lo2 = (lo + c_lo * span / cum) & kU16;
      if (DEBUG) bad |= (num < 0) | (u >= cum) | (lo2 > hi2);
      m.add(sym);
      ++cum;
      const Renorm r = renorm(lo2, hi2);
      const int s = r.m + r.k;
      code = (((code << s) | bi.take(s)) ^ (r.k ? 0x8000u : 0u)) & kU16;
      lo = r.lo;
      hi = r.hi;
      const uint32_t b = static_cast<uint32_t>(sym) << ((i & 3) * 8);
      const int q = i >> 2;
      o0 |= q == 0 ? b : 0u;
      o1 |= q == 1 ? b : 0u;
      o2 |= q == 2 ? b : 0u;
      o3 |= q == 3 ? b : 0u;
    }
    store16(out + base / 4, o0, o1, o2, o3);
  }
  for (; base < out_words * 4; base += 16) store16(out + base / 4, 0, 0, 0, 0);
  if (DEBUG) {
    *flag = bad;
    *cursor = bi.cursor();
  }
}

}  // namespace gip
