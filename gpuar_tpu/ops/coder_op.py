"""The packet coder as a JAX operation (``jax.ffi``).

One call codes a batch of independent packets.  On a GPU each CUDA
thread runs one complete serial coder over one packet, with its own
adaptive model in shared memory (native/coder_cuda.cu); on a CPU the same
C++ coder loops over the packets (native/coder_cpu.cc).  XLA lowers the op
for the platform it compiles for, so the device path is one program on
both; the CPU build is what the tests run.

Rows are framed packets exactly as they appear in a ``.gip`` body: word 0
is the ``[u16 total][u16 raw]`` header, the bitstream follows, so a row's
first ``length`` bytes splice straight into the container.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np

from gpuar_tpu import native
from gpuar_tpu.config import (
    EXTRA_COMPRESSED_SIZE,
    MAX_PROBABILITY,
    MODEL_SIZE,
    PACKET_HEADER_LENGTH,
    UNCOMPRESSED_PACKET_SIZE,
)
from gpuar_tpu.pipeline import DEFAULT_SUPER_BATCH_PACKETS

# Packets per CUDA block (kBlock in coder_cuda.cu); batches are padded to
# a whole number of blocks per device.
BLOCK = 32

# Packet sizes must stay below this so the adaptive model's counts never
# reach MAX_PROBABILITY (config.CodecConfig; kMaxPacketSize in coder_ffi.h).
PACKET_SIZE_LIMIT = MAX_PROBABILITY - MODEL_SIZE

_TARGETS = ("gip_encode", "gip_decode", "gip_decode_debug")
_FFI_PLATFORM = {"gpu": "CUDA", "cpu": "cpu"}
_registered: set[str] = set()
_lock = threading.Lock()


def out_words(packet_size: int) -> int:
    """Framed row capacity in i32 words: header + packet + the reference's
    EXTRA_COMPRESSED_SIZE slack, rounded up to whole 8-word groups (so the
    row compaction in parallel/mesh.py always finds a dividing row
    width)."""
    cap = -(-(packet_size + EXTRA_COMPRESSED_SIZE + PACKET_HEADER_LENGTH)
            // 4)
    return -(-cap // 8) * 8


def _ensure_registered() -> None:
    platform = jax.default_backend()
    with _lock:
        if platform in _registered:
            return
        if platform not in _FFI_PLATFORM:
            raise RuntimeError(
                f"the coder op has no build for JAX platform {platform!r}")
        lib = native.coder_library(platform)
        for name in _TARGETS:
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, name)),
                platform=_FFI_PLATFORM[platform])
        _registered.add(platform)


def _check_packet_size(packet_size: int) -> None:
    if (packet_size <= 0 or packet_size % 16
            or packet_size >= PACKET_SIZE_LIMIT):
        raise ValueError(f"packet_size {packet_size} must be a positive "
                         f"multiple of 16 below {PACKET_SIZE_LIMIT}")


def encode(words, sizes, *, packet_size: int = UNCOMPRESSED_PACKET_SIZE):
    """words [n, packet_size/4] i32 (the packets' bytes, little-endian),
    sizes [1, n] raw byte counts -> (rows [n, out_words] i32, lengths
    [1, n]).  A length above ``4 * out_words`` marks a stream that did not
    fit its row (see check_lengths)."""
    _check_packet_size(packet_size)
    _ensure_registered()
    n = words.shape[0]
    shapes = (jax.ShapeDtypeStruct((n, out_words(packet_size)), jnp.int32),
              jax.ShapeDtypeStruct((1, n), jnp.int32))
    return jax.ffi.ffi_call("gip_encode", shapes)(
        words, sizes, packet_size=np.int32(packet_size))


def decode(rows, sizes, *, packet_size: int = UNCOMPRESSED_PACKET_SIZE,
           debug: bool = False):
    """rows [n, out_words] i32 framed packets, sizes [1, n] raw byte
    counts -> words [n, packet_size/4] i32 (zero past each raw size).

    With ``debug`` also returns flags [2, n]: row 0 marks the reference's
    -D_DEBUG coder conditions (search target outside the model, range
    inversion), row 1 is the final bit cursor for check_debug_flags."""
    _check_packet_size(packet_size)
    _ensure_registered()
    n = rows.shape[0]
    shapes = [jax.ShapeDtypeStruct((n, packet_size // 4), jnp.int32)]
    if debug:
        shapes.append(jax.ShapeDtypeStruct((2, n), jnp.int32))
    out = jax.ffi.ffi_call(
        "gip_decode_debug" if debug else "gip_decode", tuple(shapes))(
        rows, sizes, packet_size=np.int32(packet_size))
    return tuple(out) if debug else out[0]


def check_lengths(lengths: np.ndarray, capacity_bytes: int) -> None:
    """Raise ValueError naming the packets whose stream overflowed its
    row; the coder never truncates a packet silently."""
    bad = np.nonzero(np.asarray(lengths) > capacity_bytes)[0]
    if bad.size:
        raise ValueError(
            f"compressed stream exceeds the {capacity_bytes}-byte packet "
            f"capacity in packets {bad[:8].tolist()}"
            f"{'...' if bad.size > 8 else ''}")


def check_debug_flags(flags: np.ndarray, comp_len: np.ndarray,
                      n: int) -> None:
    """Raise ContainerError for packets whose debug flags fired.

    Row 0: coder invariant violations (the reference's -D_DEBUG checks).
    Row 1: final bit cursor, compared with the framed packet length
    (``comp_len`` bytes).  The decoder legitimately reads up to 16
    lookahead bits past the written stream (the primed 16-bit code
    window); anything beyond +16 means the stream ran dry: the detectable
    signature of a corrupt well-framed packet.
    """
    overrun = flags[1, :n] > np.asarray(comp_len, np.int64)[:n] * 8 + 16
    bad = np.nonzero((flags[0, :n] != 0) | overrun)[0]
    if bad.size:
        from gpuar_tpu import container

        raise container.ContainerError(
            "Corrupt packet data: coder invariant violation or "
            f"bitstream overrun in packets {bad[:8].tolist()}"
            f"{'...' if bad.size > 8 else ''}"
        )


def packets_per_launch(device) -> int:
    """Packets ``device`` codes at once: SM count times the packets one
    SM holds (the occupancy query of the CUDA build), as the reference
    sizes its launches from the SM count.  A CPU device has no such
    bound and takes the pipeline's default super-batch."""
    if device.platform != "gpu":
        return DEFAULT_SUPER_BATCH_PACKETS
    sm, per_sm = native.cuda_device_geometry(device.local_hardware_id)
    return sm * per_sm


def super_batch_packets(per_device: list[int], quantum: int) -> int:
    """Default super-batch over a mesh: every device full, rounded down to
    the lane quantum (at least one quantum)."""
    total = sum(per_device)
    return max(quantum, total // quantum * quantum)
