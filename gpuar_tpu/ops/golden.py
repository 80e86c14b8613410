"""Golden scalar codec: the executable specification.

A byte-exact, readable re-statement of the adaptive arithmetic coder the
reference runs per CUDA thread (jiahansu/GPUAR src/gpuar_kernel.cu: encode
arCompress :487-531, decode arDecompress :848-892, renormalisation
writeEncodedBits :321-367 / readEncodedBits :787-836, tail flush
writeRemaining :379-388 + writeClose :430-439).  Everything else in this
project — the C++ host backend and the device coder op — is tested
for bit-equality against this module.

Packet layout (written by the codec itself, src/gpuar_kernel.cu:527-528):
    [u16 LE total packet bytes][u16 LE uncompressed bytes][AC bitstream]

Coder invariants (see SURVEY.md §3.4):
  * 16-bit lower/upper state, MSB mask 0x8000, second mask 0x4000;
  * all intermediate products < 2**31, so plain int math suffices;
  * bits are emitted MSB-first into bytes, final partial byte left-aligned;
  * no EOF symbol: the decoder stops after the header's byte count;
  * the decoder may consume bits past the written stream — their values
    never change the decoded output (tail flush guarantees it), so reads
    past the end return 0 here.
"""

from __future__ import annotations

from gpuar_tpu.config import (
    MSB_MASK,
    PACKET_HEADER_LENGTH,
    PRECISION,
    SECOND_MASK,
    U16_MASK,
)
from gpuar_tpu.models.adaptive import AdaptiveModel


class _BitWriter:
    """MSB-first bit accumulator (reference: writeBit src/gpuar_kernel.cu:128)."""

    __slots__ = ("out", "acc", "nbits")

    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, bit: int) -> None:
        self.acc = (self.acc << 1) | (bit & 1)
        self.nbits += 1
        if self.nbits == 8:
            self.out.append(self.acc)
            self.acc = 0
            self.nbits = 0

    def close(self) -> None:
        """Left-align and flush any partial byte (writeClose :430-439)."""
        if self.nbits:
            self.out.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.acc = 0
            self.nbits = 0


class _BitReader:
    """MSB-first bit cursor; reads past the end return 0 (see module doc)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def get(self) -> int:
        byte_idx, bit_idx = divmod(self.pos, 8)
        self.pos += 1
        if byte_idx >= len(self.data):
            return 0
        return (self.data[byte_idx] >> (7 - bit_idx)) & 1


def _apply_symbol_range(model: AdaptiveModel, symbol: int, lower: int, upper: int):
    """Narrow [lower, upper] to the symbol's share, then adapt the model.

    Mirrors applySymbolRange (src/gpuar_kernel.cu:256-299): the new upper is
    computed from the *old* lower, products are exact ints, results wrap to
    16 bits.
    """
    span = upper - lower + 1
    low_cum, high_cum = model.low_high(symbol)
    upper = (lower + (high_cum * span) // model.cumprob - 1) & U16_MASK
    lower = (lower + (low_cum * span) // model.cumprob) & U16_MASK
    model.update(symbol)
    return lower, upper


def encode_packet(data: bytes) -> bytes:
    """Arithmetically encode one packet; returns header + bitstream."""
    model = AdaptiveModel()
    lower, upper, underflow = 0, U16_MASK, 0
    bits = _BitWriter()

    for byte in data:
        lower, upper = _apply_symbol_range(model, byte, lower, upper)

        # Renormalise: emit settled MSBs, absorb 01/10 straddles as
        # underflow (writeEncodedBits :321-367).
        while True:
            if (upper & MSB_MASK) == (lower & MSB_MASK):
                msb = (upper >> (PRECISION - 1)) & 1
                bits.put(msb)
                while underflow > 0:
                    bits.put(msb ^ 1)
                    underflow -= 1
            elif (lower & SECOND_MASK) and not (upper & SECOND_MASK):
                underflow += 1
                lower &= ~(MSB_MASK | SECOND_MASK)
                upper |= SECOND_MASK
            else:
                break
            lower = (lower << 1) & U16_MASK
            upper = ((upper << 1) | 1) & U16_MASK

    # Tail flush: lower's second bit, then underflow+1 complements
    # (writeRemaining :379-388).
    tail = (lower >> (PRECISION - 2)) & 1
    bits.put(tail)
    for _ in range(underflow + 1):
        bits.put(tail ^ 1)
    bits.close()

    total = PACKET_HEADER_LENGTH + len(bits.out)
    header = bytes(
        (total & 0xFF, (total >> 8) & 0xFF, len(data) & 0xFF, (len(data) >> 8) & 0xFF)
    )
    return header + bytes(bits.out)


def decode_packet(packet: bytes) -> bytes:
    """Decode one packet (header + bitstream) back to raw bytes."""
    raw_size = packet[2] | (packet[3] << 8)
    bits = _BitReader(packet[PACKET_HEADER_LENGTH:])
    model = AdaptiveModel()

    code = 0
    for _ in range(PRECISION):
        code = ((code << 1) | bits.get()) & U16_MASK
    lower, upper = 0, U16_MASK

    out = bytearray()
    for _ in range(raw_size):
        # Unscale the code back to a cumulative count (getUnscaledCode
        # :703-716), then locate the symbol owning that count.
        span = upper - lower + 1
        unscaled = ((code - lower + 1) * model.cumprob - 1) // span
        symbol = model.find_symbol(unscaled)
        out.append(symbol)

        lower, upper = _apply_symbol_range(model, symbol, lower, upper)

        # Mirror renormalisation, pulling replacement bits into the code
        # (readEncodedBits :787-836).
        while True:
            if (upper & MSB_MASK) == (lower & MSB_MASK):
                pass
            elif (lower & SECOND_MASK) and not (upper & SECOND_MASK):
                lower &= ~(MSB_MASK | SECOND_MASK)
                upper |= SECOND_MASK
                code ^= SECOND_MASK
            else:
                break
            lower = (lower << 1) & U16_MASK
            upper = ((upper << 1) | 1) & U16_MASK
            code = ((code << 1) | bits.get()) & U16_MASK

    return bytes(out)
