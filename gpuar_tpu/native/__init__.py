"""Build + load the native libraries (ctypes): the golden host codec and
the two builds of the device coder op.

Every library is compiled from the committed sources at first use and
cached in ``_build/`` under a tag that hashes the sources, the command
line, the compiler's version and, for ``-march=native`` builds, the ISA
the compiler targets on this host: a library built on one machine is
never loaded on another whose CPU or toolchain differs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from gpuar_tpu.config import (
    COMPRESSED_PACKET_SIZE,
    PACKET_HEADER_LENGTH,
    UNCOMPRESSED_PACKET_SIZE,
)

_DIR = Path(__file__).parent
_SRC = _DIR / "golden.cpp"
_BUILD_DIR = _DIR / "_build"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_CODER: dict[str, ctypes.CDLL] = {}

GOLDEN_CMD = ("g++", "-std=c++17", "-O3", "-march=native", "-fPIC",
              "-shared")


@functools.lru_cache(maxsize=None)
def _toolchain_identity(compiler: str, native_isa: bool) -> bytes:
    """The compiler's version and, with ``native_isa``, the ISA macros
    ``-march=native`` defines on this host."""
    ident = subprocess.run([compiler, "--version"], check=True,
                           capture_output=True).stdout
    if native_isa:
        ident += subprocess.run(
            [compiler, "-march=native", "-E", "-dM", "-x", "c++",
             os.devnull], check=True, capture_output=True).stdout
    return ident


def build_library(name: str, units, cmd, headers=()) -> Path:
    """Compile ``units`` with ``cmd`` (compiler, then flags) into
    ``_build/lib{name}_{tag}.so`` unless that build exists; ``headers``
    join the sources in the tag.  Concurrent builders each write their own
    temporary file and the last rename wins, so a reader never sees a
    partial library."""
    key = hashlib.sha256()
    for path in (*units, *headers):
        key.update(Path(path).read_bytes())
    key.update("\0".join(cmd).encode())
    key.update(_toolchain_identity(cmd[0], "-march=native" in cmd))
    out = _BUILD_DIR / f"lib{name}_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([*cmd, *map(str, units), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"building {out.name} failed:\n"
                           f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def coder_library(platform: str) -> ctypes.CDLL:
    """The device coder op's library for JAX platform ``platform``:
    ``"gpu"`` builds ``coder_cuda.cu`` with nvcc for sm_90a, ``"cpu"``
    builds ``coder_cpu.cc`` with g++.  Both compile the one coder in
    ``coder.h``."""
    import jax.ffi

    with _LOCK:
        if platform not in _CODER:
            inc = f"-I{jax.ffi.include_dir()}"
            headers = (_DIR / "coder.h", _DIR / "coder_ffi.h")
            if platform == "gpu":
                path = build_library(
                    "gip_coder_cuda", [_DIR / "coder_cuda.cu"],
                    [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     inc], headers)
            elif platform == "cpu":
                path = build_library(
                    "gip_coder_cpu", [_DIR / "coder_cpu.cc"],
                    ["g++", "-std=c++17", "-O3", "-fPIC", "-shared", inc],
                    headers)
            else:
                raise ValueError(f"no coder build for platform {platform!r}")
            lib = ctypes.CDLL(str(path))
            if platform == "gpu":
                lib.gip_device_geometry.argtypes = [
                    ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int)]
                lib.gip_device_geometry.restype = ctypes.c_int
            _CODER[platform] = lib
        return _CODER[platform]


def cuda_device_geometry(device: int) -> tuple[int, int]:
    """(SM count, packets one SM holds at once) of CUDA device
    ``device``, from the coder library's occupancy query."""
    sm, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    err = coder_library("gpu").gip_device_geometry(
        device, ctypes.byref(sm), ctypes.byref(per_sm))
    if err:
        raise RuntimeError(f"CUDA device {device}: cudaError {err}")
    return sm.value, per_sm.value


def load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library(
                "tpuar_golden", [_SRC], GOLDEN_CMD)))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.tg_encode_packet.argtypes = [u8p, ctypes.c_int, u8p]
            lib.tg_encode_packet.restype = ctypes.c_int
            lib.tg_decode_packet.argtypes = [u8p, u8p]
            lib.tg_decode_packet.restype = ctypes.c_int
            lib.tg_decode_packet_delta.argtypes = [u8p, u8p]
            lib.tg_decode_packet_delta.restype = ctypes.c_long
            lib.tg_encode_batch.argtypes = [
                u8p, ctypes.c_long, ctypes.c_int, u8p, ctypes.c_long, i32p]
            lib.tg_encode_batch.restype = ctypes.c_long
            lib.tg_decode_batch.argtypes = [
                u8p, ctypes.c_long, ctypes.c_long, u8p, ctypes.c_long, i32p]
            lib.tg_decode_batch.restype = None
            lib.tg_encode_stream.argtypes = [
                u8p, ctypes.c_long, ctypes.c_int, u8p, ctypes.c_long]
            lib.tg_encode_stream.restype = ctypes.c_long
            lib.tg_decode_stream.argtypes = [
                u8p, ctypes.c_long, u8p, ctypes.c_long]
            lib.tg_decode_stream.restype = ctypes.c_long
            lib.tg_splice.argtypes = [
                u8p, ctypes.c_long, i32p, ctypes.c_long, u8p, ctypes.c_long]
            lib.tg_splice.restype = ctypes.c_long
            i64p = ctypes.POINTER(ctypes.c_long)
            lib.tg_splice_at.argtypes = [
                u8p, ctypes.c_long, i64p, i32p, ctypes.c_long, u8p,
                ctypes.c_long]
            lib.tg_splice_at.restype = ctypes.c_long
            lib.tg_expand_at.argtypes = [
                u8p, ctypes.c_long, i64p, i32p, ctypes.c_long, u8p,
                ctypes.c_long]
            lib.tg_expand_at.restype = ctypes.c_long
            _LIB = lib
        return _LIB


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def encode_packet(data: bytes) -> bytes:
    lib = load()
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(len(data) + 512 + PACKET_HEADER_LENGTH + 16, dtype=np.uint8)
    n = lib.tg_encode_packet(_u8p(np.ascontiguousarray(src)), len(data), _u8p(out))
    return out[:n].tobytes()


def decode_packet(packet: bytes) -> bytes:
    lib = load()
    src = np.frombuffer(packet, dtype=np.uint8)
    raw = packet[2] | (packet[3] << 8)
    out = np.empty(max(raw, 1), dtype=np.uint8)
    n = lib.tg_decode_packet(_u8p(np.ascontiguousarray(src)), _u8p(out))
    return out[:n].tobytes()


def decode_packet_delta(packet: bytes) -> tuple[bytes, int]:
    """(decoded bytes, bit-consumption delta vs the framed body length).

    A delta beyond +16 bits of lookahead marks a corrupt well-framed
    packet (golden.cpp tg_decode_packet_delta — the host mirror of the
    device coder's overrun flag, coder_op.check_debug_flags)."""
    lib = load()
    src = np.frombuffer(packet, dtype=np.uint8)
    raw = packet[2] | (packet[3] << 8)
    out = np.empty(max(raw, 1), dtype=np.uint8)
    delta = lib.tg_decode_packet_delta(_u8p(np.ascontiguousarray(src)),
                                       _u8p(out))
    return out[:raw].tobytes(), int(delta)


def encode_batch(data: np.ndarray, packet_size: int = UNCOMPRESSED_PACKET_SIZE,
                 out_stride: int = COMPRESSED_PACKET_SIZE):
    """Encode a raw byte array into fixed-stride packets.

    Returns (packets [n, out_stride] uint8, lengths [n] int32).
    """
    lib = load()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = max(1, -(-data.size // packet_size)) if data.size else 0
    out = np.zeros((max(n, 1), out_stride), dtype=np.uint8)
    lengths = np.zeros(max(n, 1), dtype=np.int32)
    count = lib.tg_encode_batch(_u8p(data), data.size, packet_size, _u8p(out),
                                out_stride, _i32p(lengths))
    return out[:count], lengths[:count]


def decode_batch(packets: np.ndarray, out_stride: int = UNCOMPRESSED_PACKET_SIZE):
    """Decode fixed-stride packets [n, stride] -> (raw [n, out_stride], lengths)."""
    lib = load()
    packets = np.ascontiguousarray(packets, dtype=np.uint8)
    n = packets.shape[0]
    out = np.zeros((max(n, 1), out_stride), dtype=np.uint8)
    lengths = np.zeros(max(n, 1), dtype=np.int32)
    lib.tg_decode_batch(_u8p(packets), packets.shape[1], n, _u8p(out),
                        out_stride, _i32p(lengths))
    return out[:n], lengths[:n]


def encode_stream(data: np.ndarray | bytes,
                  packet_size: int = UNCOMPRESSED_PACKET_SIZE) -> bytes:
    """Encode raw bytes into a back-to-back .gip packet body."""
    lib = load()
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    npackets = -(-max(data.size, 1) // packet_size)
    cap = data.size + npackets * (512 + PACKET_HEADER_LENGTH) + 64
    out = np.empty(cap, dtype=np.uint8)
    w = lib.tg_encode_stream(_u8p(data), data.size, packet_size, _u8p(out), cap)
    if w < 0:
        raise RuntimeError("native encode_stream overflow")
    return out[:w].tobytes()


def decode_stream(body: np.ndarray | bytes, out_cap: int) -> bytes:
    """Decode a back-to-back .gip packet body."""
    lib = load()
    if isinstance(body, (bytes, bytearray, memoryview)):
        body = np.frombuffer(bytes(body), dtype=np.uint8)
    body = np.ascontiguousarray(body, dtype=np.uint8)
    out = np.empty(max(out_cap, 1), dtype=np.uint8)
    w = lib.tg_decode_stream(_u8p(body), body.size, _u8p(out), out.size)
    if w == -1:
        raise ValueError("Incorrect file format: malformed packet framing")
    if w == -2:
        raise ValueError("decode output overflow")
    return out[:w].tobytes()


def splice_at(blob: np.ndarray, offsets: np.ndarray,
              lengths: np.ndarray) -> np.ndarray:
    """Concatenate blob[offsets[i] : offsets[i]+lengths[i]] — strips the
    inter-packet alignment padding of a device-compacted result blob.
    Returns a uint8 array (see splice: avoids a whole-body copy)."""
    lib = load()
    blob = np.ascontiguousarray(blob, dtype=np.uint8).reshape(-1)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    out = np.empty(int(lengths.sum()), dtype=np.uint8)
    w = lib.tg_splice_at(
        _u8p(blob), blob.size,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        _i32p(lengths), lengths.shape[0], _u8p(out), out.size)
    if w < 0:
        raise ValueError("splice_at: offset/length out of range")
    return out[:w]


def expand_at(body: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
              blob_cap: int) -> np.ndarray:
    """Scatter back-to-back packets into aligned blob offsets (decode-side
    upload buffer build): blob[offsets[i]:+lengths[i]] = next body bytes."""
    lib = load()
    body = np.ascontiguousarray(body, dtype=np.uint8).reshape(-1)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    blob = np.zeros(blob_cap, dtype=np.uint8)
    r = lib.tg_expand_at(
        _u8p(body), body.size,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        _i32p(lengths), lengths.shape[0], _u8p(blob), blob.size)
    if r < 0:
        raise ValueError("expand_at: offset/length out of range")
    return blob


def splice(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate rows[i, :lengths[i]] — a native memcpy loop (numpy's
    small-array concatenate costs ~0.5 s per 8192-row batch).  Returns a
    uint8 array (buffer-protocol writable to files without the extra
    whole-body .tobytes() copy a bytes return would cost per batch)."""
    lib = load()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    if rows.ndim != 2 or lengths.shape[0] != rows.shape[0]:
        raise ValueError("rows [n, stride] and lengths [n] required")
    out = np.empty(int(lengths.sum()), dtype=np.uint8)
    w = lib.tg_splice(_u8p(rows), rows.shape[1], _i32p(lengths),
                      rows.shape[0], _u8p(out), out.size)
    if w < 0:
        raise ValueError("splice: length exceeds row stride")
    return out[:w]
