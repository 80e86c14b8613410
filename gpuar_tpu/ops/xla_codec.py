"""Vectorized JAX (pure-XLA) codec: lax.scan over symbol steps, packets
batched along the vector axis.

This is the plain JAX version of the coder op (ops/coder_op.py) — a
SPEC/TEST-TIER implementation and the timing baseline for the CUDA
kernels, not a production path: its output stage (ops.bitpack) packs bits
in a per-lane host loop, which is fine for golden-vector generation and
cross-checks but would crawl at production batch sizes.  Production
traffic goes through the coder op (device) or the native golden codec
(host).  The coder
state and model updates follow the reference
semantics exactly (jiahansu/GPUAR src/gpuar_kernel.cu applySymbolRange
:256-299), but the reference's bit-by-bit renormalisation loops
(writeEncodedBits :321-367, readEncodedBits :787-836) are replaced by a
closed form: per symbol, the number of settled MSBs and the number of
underflow (01/10 straddle) removals are computed with leading-zero counts,
and the new bounds/code fall out of shifts and masks.  Derivation:

  Let L, U be the 16-bit bounds after the symbol's range restriction
  (L <= U).  The serial loop first shifts out m = clz16(L ^ U) common
  MSBs (emitting them), leaving LA = L<<m, UA = (U<<m)|(2^m-1) with
  MSB(LA)=0, MSB(UA)=1.  It then performs k underflow removals, where k is
  the length of the leading run of positions (from bit 1) with LA bit 1 and
  UA bit 0; each removal clears both top bits of LA (its MSB is already 0)
  and forces UA's top two bits to 1 0 -> after shifting, MSBs still differ,
  so no further emission can follow and the loop terminates with
    L' = (LA << k) & 0x7FFF,  U' = ((UA << k) | (2^k - 1)) | 0x8000.
  The encoder emits: [top bit of U] + [its complement] * pending_underflow
  + [remaining m-1 common bits]; pending underflow becomes k (plus the old
  value if m == 0, when nothing was drained).
  The decoder consumes s = m + k bits into the code; each underflow removal
  XORs bit 0x4000 into the code *before* that iteration's shift, so the
  flip from removal j ends up at bit position j - k + 1 (MSB = 0) — only
  the final removal's flip survives in the 16-bit window, landing on the
  MSB:  code' = (((code << s) | next_s_bits) ^ H) & 0xFFFF with
  H = 0x8000 if k >= 1 else 0.

Bit-equality of every packet against the golden scalar codec is enforced
in tests/test_xla_codec.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gpuar_tpu.config import (
    COMPRESSED_PACKET_SIZE,
    MODEL_SIZE,
    PACKET_HEADER_LENGTH,
    UNCOMPRESSED_PACKET_SIZE,
)
from gpuar_tpu.ops import bitpack

U16 = 0xFFFF


def _clz16(x):
    """Leading zeros of a 16-bit value held in i32 (clz16(0) = 16)."""
    return jax.lax.clz(x) - 16


def _apply_symbol_range(C, cumprob, sym, lower, upper):
    """Vectorized applySymbolRange: narrow bounds, adapt model."""
    low = jnp.take_along_axis(C, sym[:, None], axis=1)[:, 0]
    high = jnp.take_along_axis(C, sym[:, None] + 1, axis=1)[:, 0]
    span = upper - lower + 1
    new_upper = (lower + (high * span) // cumprob - 1) & U16
    new_lower = (lower + (low * span) // cumprob) & U16
    iota = jnp.arange(MODEL_SIZE, dtype=jnp.int32)
    C_new = C + (iota[None, :] > sym[:, None]).astype(jnp.int32)
    return C_new, cumprob + 1, new_lower, new_upper


def _renorm(lower, upper):
    """Closed-form renormalisation (see module docstring).

    Returns (new_lower, new_upper, m, k, LA, UA).
    """
    m = _clz16(lower ^ upper)
    pow_m = (1 << m)  # m <= 16 fits i32
    LA = (lower << m) & U16
    UA = ((upper << m) | (pow_m - 1)) & U16
    A = (LA << 1) & U16
    B = ((UA << 1) | 1) & U16
    k = _clz16((~(A & ~B)) & U16)
    pow_k = (1 << k)
    new_lower = (LA << k) & 0x7FFF
    new_upper = (((UA << k) | (pow_k - 1)) | 0x8000) & U16
    return new_lower, new_upper, m, k


def _encode_step(carry, x):
    C, cumprob, lower, upper, under = carry
    sym, t, sizes = x
    active = t < sizes

    C2, cum2, lo2, up2 = _apply_symbol_range(C, cumprob, sym, lower, upper)
    lo3, up3, m, k = _renorm(lo2, up2)

    # Emission descriptor: first settled bit b0, drained underflow run,
    # then the remaining m-1 settled bits (all from the pre-shift upper).
    topm = (up2 >> (16 - m)) & ((1 << m) - 1)
    has = (m > 0).astype(jnp.int32)
    b0 = (topm >> jnp.maximum(m - 1, 0)) & has
    pat = topm & ((1 << jnp.maximum(m - 1, 0)) - 1)
    u_drain = jnp.where(m > 0, under, 0)
    under3 = jnp.where(m > 0, 0, under) + k

    desc = (u_drain << 6) | (m << 1) | b0

    sel = lambda a, b: jnp.where(active, a, b)
    carry = (
        jnp.where(active[:, None], C2, C),
        sel(cum2, cumprob), sel(lo3, lower), sel(up3, upper), sel(under3, under),
    )
    return carry, (sel(desc, 0), sel(pat, 0))


@jax.jit
def encode_scan(symbols: jax.Array, sizes: jax.Array):
    """symbols [steps, B] i32, sizes [B] i32 ->
    (desc [steps, B], pat [steps, B], tail_bit [B], tail_run [B])."""
    steps, batch = symbols.shape
    C0 = jnp.broadcast_to(
        jnp.arange(MODEL_SIZE, dtype=jnp.int32)[None, :], (batch, MODEL_SIZE)
    )
    cum0 = jnp.full((batch,), 256, jnp.int32)
    lo0 = jnp.zeros((batch,), jnp.int32)
    up0 = jnp.full((batch,), U16, jnp.int32)
    un0 = jnp.zeros((batch,), jnp.int32)

    ts = jnp.arange(steps, dtype=jnp.int32)
    sizes_bc = jnp.broadcast_to(sizes[None, :], (steps, batch))
    (C, cum, lower, upper, under), (desc, pat) = jax.lax.scan(
        _encode_step, (C0, cum0, lo0, up0, un0),
        (symbols, jnp.broadcast_to(ts[:, None], (steps, batch)), sizes_bc),
    )
    tail_bit = (lower >> 14) & 1
    tail_run = under + 1
    return desc, pat, tail_bit, tail_run


def encode_batch_xla(data: np.ndarray, sizes: np.ndarray,
                     packet_size: int = UNCOMPRESSED_PACKET_SIZE):
    """Encode padded raw packets [B, packet_size] u8 with true lengths
    ``sizes`` -> (packets [B, COMPRESSED_PACKET_SIZE] u8, lengths [B])."""
    symbols = jnp.asarray(data.T, dtype=jnp.int32)  # [steps, B]
    desc, pat, tb, tr = encode_scan(symbols, jnp.asarray(sizes, jnp.int32))
    return bitpack.pack_batch(
        np.asarray(desc), np.asarray(pat), np.asarray(tb), np.asarray(tr),
        np.asarray(sizes), out_stride=COMPRESSED_PACKET_SIZE,
    )


def _decode_step(carry, t):
    C, cumprob, lower, upper, code, bitpos, words, raw_sizes = carry
    active = t < raw_sizes

    span = upper - lower + 1
    unscaled = ((code - lower + 1) * cumprob - 1) // span
    sym = jnp.clip(
        jnp.sum((C[:, 1:] <= unscaled[:, None]).astype(jnp.int32), axis=1),
        0, 255,
    )

    C2, cum2, lo2, up2 = _apply_symbol_range(C, cumprob, sym, lower, upper)
    lo3, up3, m, k = _renorm(lo2, up2)
    s = m + k

    # Pull s replacement bits from the stream (MSB-first u32 words).
    widx = bitpos >> 5
    boff = (bitpos & 31).astype(jnp.uint32)
    nwords = words.shape[1]
    w0 = jnp.take_along_axis(words, jnp.clip(widx, 0, nwords - 1)[:, None], 1)[:, 0]
    w1 = jnp.take_along_axis(words, jnp.clip(widx + 1, 0, nwords - 1)[:, None], 1)[:, 0]
    win = (w0 << boff) | jnp.where(
        boff > 0, w1 >> (32 - jnp.maximum(boff, 1)), jnp.uint32(0)
    )
    su = jnp.maximum(s, 1).astype(jnp.uint32)
    bits = jnp.where(s > 0, (win >> (32 - su)), jnp.uint32(0)).astype(jnp.int32)

    H = jnp.where(k >= 1, 0x8000, 0)
    code2 = (((code << s) | bits) ^ H) & U16
    bitpos2 = bitpos + s

    sel = lambda a, b: jnp.where(active, a, b)
    carry = (
        jnp.where(active[:, None], C2, C), sel(cum2, cumprob),
        sel(lo3, lower), sel(up3, upper), sel(code2, code),
        sel(bitpos2, bitpos), words, raw_sizes,
    )
    return carry, sel(sym, 0).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(2,))
def decode_scan(words: jax.Array, raw_sizes: jax.Array, steps: int):
    """words [B, W] u32 (bitstream, MSB-first), raw_sizes [B] ->
    symbols [steps, B] u8."""
    batch = words.shape[0]
    C0 = jnp.broadcast_to(
        jnp.arange(MODEL_SIZE, dtype=jnp.int32)[None, :], (batch, MODEL_SIZE)
    )
    cum0 = jnp.full((batch,), 256, jnp.int32)
    lo0 = jnp.zeros((batch,), jnp.int32)
    up0 = jnp.full((batch,), U16, jnp.int32)
    code0 = (words[:, 0] >> 16).astype(jnp.int32)  # initializeDecoder: 16 MSBs
    pos0 = jnp.full((batch,), 16, jnp.int32)

    carry = (C0, cum0, lo0, up0, code0, pos0, words,
             jnp.asarray(raw_sizes, jnp.int32))
    _, syms = jax.lax.scan(
        _decode_step, carry, jnp.arange(steps, dtype=jnp.int32)
    )
    return syms


def packets_to_words(packets: np.ndarray) -> np.ndarray:
    """[B, COMPRESSED_PACKET_SIZE] u8 -> [B, W] u32 big-endian words of the
    bitstream (header stripped)."""
    body = packets[:, PACKET_HEADER_LENGTH:]
    pad = (-body.shape[1]) % 4
    if pad:
        body = np.pad(body, ((0, 0), (0, pad)))
    return body.reshape(body.shape[0], -1, 4).astype(np.uint32) @ np.array(
        [1 << 24, 1 << 16, 1 << 8, 1], dtype=np.uint32
    )


def decode_batch_xla(packets: np.ndarray, raw_sizes: np.ndarray,
                     packet_size: int = UNCOMPRESSED_PACKET_SIZE) -> np.ndarray:
    """Decode fixed-stride packets -> padded raw [B, packet_size] u8."""
    words = jnp.asarray(packets_to_words(packets))
    syms = decode_scan(words, jnp.asarray(raw_sizes, jnp.int32), packet_size)
    return np.asarray(syms).T
