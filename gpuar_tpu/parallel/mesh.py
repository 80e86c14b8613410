"""Device-mesh sharding of the coder op.

The reference is single-GPU (SURVEY.md §2.2.4); this module is the
distributed component it lacks: a 1-D ``data`` mesh over all local
devices, with packet batches sharded along the packet axis via
``shard_map`` — each device runs the coder op on its own packet shard
(compression itself needs zero cross-device communication; only the
ordered splice of variable-length results does, and that is
metadata-sized).

Works identically on GPUs and on the virtual CPU mesh used in tests
(``--xla_force_host_platform_device_count``), where the op runs its CPU
build.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from gpuar_tpu.config import UNCOMPRESSED_PACKET_SIZE
from gpuar_tpu.ops import coder_op

# Fixed, so that every run of this checkout finds the executables an
# earlier one cached (the directory is part of the cache key).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compilation_cache_dir(environ=os.environ) -> Path | None:
    """Where this program keeps JAX's persistent compilation cache: None
    when JAX_COMPILATION_CACHE_DIR is set (JAX then uses that directory
    and the program sets nothing), else DEFAULT_CACHE_DIR."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


def enable_compilation_cache() -> None:
    """Persist compiled executables across processes on GPUs.

    CPU executables are compiled for the exact host microarchitecture,
    so the cache is left off there — a cached CPU binary from another
    machine can SIGILL.
    """
    path = compilation_cache_dir()
    if path is None or jax.default_backend() == "cpu":
        return
    try:
        path.mkdir(exist_ok=True)
    except OSError:
        return  # a read-only checkout: run without the cache
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("data",))


# --- device-side compaction of variable-length results --------------------
#
# The coder writes fixed-stride packets (8,736 B each, like the
# reference's D2H at src/gpu_compressor.cpp:138); fetching that full
# stride moves ~1/ratio more bytes than the compressed data holds.  The
# compact stage gathers each packet's rows (COMPACT_ROW_WORDS-word
# granularity) into a dense blob on the device, so the host transfer
# carries compressed bytes + <=95 B/packet of alignment padding, and the
# decode side mirrors it with an expansion gather on upload.  These are
# plain XLA row gathers.

COMPACT_ROW_WORDS = 24   # 96-byte row granularity (divides out_words 2184)
_BUCKET_ROWS = 4096      # D2H prefix-slice shapes round up to this many
                         # rows so the number of distinct compiled slice
                         # shapes stays tiny


def _compact_rows(pk, lens, n, *, rows_pp, row_words):
    """Gather packets' occupied rows into a dense blob (traced helper).

    pk [n_pad, ow] i32, lens [1, n_pad] bytes, n = real lanes ->
    (blob [n_pad*rows_pp, row_words] i32, roff [n_pad] row offsets,
    total_rows scalar).
    """
    n_pad, ow = pk.shape
    cap = n_pad * rows_pp
    lane = jnp.arange(n_pad, dtype=jnp.int32)
    wlen = (lens[0] + 3) >> 2
    rcnt = jnp.where(lane < n, (wlen + row_words - 1) // row_words, 0)
    ends = jnp.cumsum(rcnt)
    roff = jnp.concatenate([jnp.zeros(1, jnp.int32), ends[:-1]])
    r = jnp.arange(cap, dtype=jnp.int32)
    # Packet of blob row r: count of packet-ends <= r (ends is sorted).
    p = jnp.searchsorted(ends, r, side="right")
    p = jnp.clip(p, 0, n_pad - 1)
    src = jnp.clip(p * rows_pp + (r - roff[p]), 0, cap - 1)
    blob = jnp.take(pk.reshape(cap, row_words), src, axis=0)
    return blob, roff, ends[-1]


def _expand_rows(blob, roff, *, rows_pp):
    """Mirror gather: dense blob rows -> fixed-stride packet rows.

    Rows past a packet's data pick up neighbouring packets' bytes; that
    is sound: the arithmetic coder's final flush (writeRemaining,
    src/gpuar_kernel.cu:379-388) pins every decoded symbol regardless of
    the bits that follow the written stream, and the debug-mode overrun
    check compares bit POSITIONS only.
    """
    n_pad = roff.shape[0]
    idx = roff[:, None] + jnp.arange(rows_pp, dtype=jnp.int32)[None, :]
    idx = jnp.clip(idx.reshape(-1), 0, blob.shape[0] - 1)
    out = jnp.take(blob, idx, axis=0)
    return out.reshape(n_pad, rows_pp * blob.shape[1])


class CompactBody(np.ndarray):
    """A pre-spliced .gip body: subclass marker so `_splice` (and any
    caller expecting fixed-stride rows) can pass it straight through."""

    def __new__(cls, body: bytes):
        return np.frombuffer(body, dtype=np.uint8).view(cls)


def _pad_perm(order: np.ndarray, n_pad: int):
    """Extend a permutation of [0, n) to [0, n_pad) (identity on the pad
    lanes) and return (order, inverse), both int32."""
    n = order.shape[0]
    full = np.arange(n_pad, dtype=np.int32)
    full[:n] = order
    inv = np.empty_like(full)
    inv[full] = np.arange(n_pad, dtype=np.int32)
    return full, inv


def _entropy_order(data: np.ndarray) -> np.ndarray:
    """Stable ordering of packets by a cheap compressibility proxy, so
    packets of one class share blocks: primary key, whether the 256-byte
    sample holds a high-bit byte; secondary, its distinct byte count."""
    n = data.shape[0]
    if n <= 1 or data.shape[1] < 256:
        return np.arange(n)
    sample = data[:, :: max(data.shape[1] // 256, 1)][:, :256]
    s = np.sort(sample, axis=1)
    distinct = 1 + (s[:, 1:] != s[:, :-1]).sum(axis=1)
    has_high = (s[:, -1] >= 128).astype(np.int32)
    return np.argsort(has_high * 1024 + distinct, kind="stable")


def _sharded(mesh, fn, n_out: int):
    """``fn`` over the packet axis of ``mesh``: packets [n, w] and
    sizes/lengths/flags [k, n] are split along n."""
    if mesh.devices.size == 1:  # no partitioning needed; compiles faster
        return jax.jit(fn)
    specs = (P("data", None), P(None, "data"), P(None, "data"))[:n_out]
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P("data", None), P(None, "data")),
        out_specs=specs if n_out > 1 else specs[0],
        check_vma=False,
    ))


def _pad_rows(packets: np.ndarray, n_pad: int, out_words: int) -> np.ndarray:
    """Fixed-stride packets [n, >=out_words*4] u8 -> [n_pad, out_words] i32
    (LE byte view), zero-padded."""
    n = packets.shape[0]
    byts = np.zeros((n_pad, out_words * 4), np.uint8)
    byts[:n, : packets.shape[1]] = packets[:, : out_words * 4]
    return byts.view(np.int32)


class MeshCodec:
    """Sharded encode/decode over a 1-D device mesh.

    Batches are padded to ``lane_quantum`` = devices x coder_op.BLOCK
    packets (whole CUDA blocks on every device); callers slice real
    packets.
    """

    def __init__(self, mesh: Mesh | None = None,
                 packet_size: int = UNCOMPRESSED_PACKET_SIZE,
                 debug: bool = False):
        self.mesh = mesh or make_mesh()
        self.packet_size = packet_size
        # debug=True decodes through the op's debug variant: the
        # reference's -D_DEBUG coder invariants plus bitstream-overrun
        # detection per packet (ContainerError instead of silent garbage).
        self.debug = debug
        enable_compilation_cache()
        self.out_words = coder_op.out_words(packet_size)
        self.n_devices = self.mesh.devices.size
        self.lane_quantum = self.n_devices * coder_op.BLOCK
        enc = _sharded(self.mesh, functools.partial(
            coder_op.encode, packet_size=packet_size), 2)
        dec = _sharded(self.mesh, functools.partial(
            coder_op.decode, packet_size=packet_size, debug=debug),
            2 if debug else 1)

        # Packets are coded in a sorted order (similar packets share a
        # block) and unsorted before the fetch; the permutations are XLA
        # row gathers on the device.
        def enc_sorted(words, sizes, order, inv):
            pk, lens = enc(jnp.take(words, order, axis=0),
                           jnp.take(sizes, order, axis=1))
            return jnp.take(pk, inv, axis=0), jnp.take(lens, inv, axis=1)

        def dec_sorted(packets32, sizes, order, inv):
            out = dec(jnp.take(packets32, order, axis=0),
                      jnp.take(sizes, order, axis=1))
            if debug:
                out, flags = out
                return (jnp.take(out, inv, axis=0),
                        jnp.take(flags, inv, axis=1))
            return jnp.take(out, inv, axis=0)

        self._enc_sorted = jax.jit(enc_sorted)
        self._dec_sorted = jax.jit(dec_sorted)

        # Compacted-transfer variants (see the module comment above
        # _compact_rows): the same op, with a device-side gather that
        # makes the host transfer carry ~compressed bytes only.
        # out_words is always a multiple of 8 (whole word groups), so the
        # fallback row width always divides; 24 is the production pick.
        self.row_words = next(r for r in (COMPACT_ROW_WORDS, 16, 8)
                              if self.out_words % r == 0)
        self.rows_pp = self.out_words // self.row_words

        def enc_body(words, sizes, order, inv, n):
            pk, lens = enc_sorted(words, sizes, order, inv)
            blob, roff, total = _compact_rows(
                pk, lens, n, rows_pp=self.rows_pp,
                row_words=self.row_words)
            return blob, roff, total, lens

        self._enc_body = jax.jit(enc_body)
        # The expansion gather is jitted SEPARATELY from the decode op:
        # its input shape varies with the bucketed blob size, and keeping
        # it out of the decode jit means a new bucket recompiles a ~ms
        # gather, not the whole decode program.
        self._expand = jax.jit(
            functools.partial(_expand_rows, rows_pp=self.rows_pp))

    def _pad_lanes(self, n: int) -> int:
        return -(-max(n, 1) // self.lane_quantum) * self.lane_quantum

    def _encode_args(self, data: np.ndarray, sizes: np.ndarray):
        """Host-side operands of a sorted encode: words, sizes, order,
        inverse order (all padded to the lane quantum)."""
        n = data.shape[0]
        n_pad = self._pad_lanes(n)
        order, inv = _pad_perm(_entropy_order(data), n_pad)
        if n == n_pad and data.flags.c_contiguous:
            # Whole batches need no lane padding: reinterpret in place —
            # with _packetize's reshape fast path a full compress batch
            # reaches the device with ZERO host copies of the bulk.
            words = data.view(np.int32)
        else:
            words = np.zeros((n_pad, self.packet_size // 4), np.int32)
            words[:n] = np.ascontiguousarray(data).view(np.int32)
        sz = np.zeros((1, n_pad), np.int32)
        sz[0, :n] = sizes
        return (jnp.asarray(words), jnp.asarray(sz), jnp.asarray(order),
                jnp.asarray(inv))

    # --- encode ----------------------------------------------------------
    def encode_async(self, data: np.ndarray, sizes: np.ndarray):
        """Launch the device encode; returns a handle for encode_wait.

        JAX dispatch is asynchronous, so the device starts immediately and
        the host is free to overlap I/O until encode_wait materialises the
        results.
        """
        dev = self._enc_sorted(*self._encode_args(data, sizes))
        return dev, data.shape[0]

    def encode_wait(self, handle):
        (packets32, lens), n = handle
        lengths = np.asarray(lens)[0, :n].copy()
        coder_op.check_lengths(lengths, self.out_words * 4)
        packets = np.ascontiguousarray(
            np.asarray(packets32)[:n]).view(np.uint8).copy()
        return packets, lengths

    def encode(self, data: np.ndarray, sizes: np.ndarray):
        """Padded raw packets [n, packet_size] u8 -> (packets [n, stride] u8,
        lengths [n])."""
        return self.encode_wait(self.encode_async(data, sizes))

    # --- compacted-transfer encode (the file-pipeline hot path) ----------
    def encode_body_async(self, data: np.ndarray, sizes: np.ndarray):
        """Like encode_async, but the result is fetched as a dense
        device-compacted blob (D2H carries compressed bytes, not the full
        8,736-B stride per packet) and spliced straight to the .gip body."""
        n = data.shape[0]
        dev = self._enc_body(*self._encode_args(data, sizes), jnp.int32(n))
        return dev, n

    def encode_body_wait(self, handle):
        """Materialise an encode_body_async handle -> (CompactBody,
        lengths [n])."""
        from gpuar_tpu import native

        (blob, roff, total, lens), n = handle
        lengths = np.asarray(lens)[0, :n].copy()
        coder_op.check_lengths(lengths, self.out_words * 4)
        total_rows = int(np.asarray(total))
        kb = min(-(-max(total_rows, 1) // _BUCKET_ROWS) * _BUCKET_ROWS,
                 blob.shape[0])
        flat = np.ascontiguousarray(np.asarray(blob[:kb])).view(np.uint8)
        offsets = (np.asarray(roff)[:n].astype(np.int64)
                   * (self.row_words * 4))
        body = native.splice_at(flat.reshape(-1), offsets, lengths)
        return CompactBody(body), lengths

    def encode_body(self, data: np.ndarray, sizes: np.ndarray):
        return self.encode_body_wait(self.encode_body_async(data, sizes))

    # --- decode ----------------------------------------------------------
    def _dispatch_sorted_decode(self, pk, raw_sizes, comp_len, n, n_pad):
        """Shared decode dispatch tail: density sort/unsort permutations,
        sizes padding and the debug unwrap — one place for the stride,
        body and blob entry points.  Packets are sorted by compressed
        bits per raw byte, known from the packet headers."""
        density = (np.asarray(comp_len, np.int64) * 8192
                   // np.maximum(np.asarray(raw_sizes, np.int64), 1))
        order, inv = _pad_perm(
            np.argsort(density, kind="stable").astype(np.int32), n_pad)
        sz = np.zeros((1, n_pad), np.int32)
        sz[0, :n] = raw_sizes
        out = self._dec_sorted(
            pk, jnp.asarray(sz), jnp.asarray(order), jnp.asarray(inv))
        if self.debug:
            out, flags = out
            return (out, flags, np.asarray(comp_len, np.int32)), n
        return out, n

    def decode_async(self, packets: np.ndarray, raw_sizes: np.ndarray):
        n = packets.shape[0]
        n_pad = self._pad_lanes(n)
        comp_len = (packets[:, 0].astype(np.int32)
                    | (packets[:, 1].astype(np.int32) << 8))
        packets32 = _pad_rows(packets, n_pad, self.out_words)
        return self._dispatch_sorted_decode(
            jnp.asarray(packets32), raw_sizes, comp_len, n, n_pad)

    def decode_wait(self, handle) -> np.ndarray:
        """Materialise a decode_async handle.

        The result may be a READ-ONLY view of the device buffer (the
        zero-copy fast path for full batches); callers that need to
        mutate the decoded bytes must ``.copy()`` it themselves.
        """
        out, n = handle
        if self.debug:
            out, flags, comp_len = out
            coder_op.check_debug_flags(np.asarray(flags), comp_len, n)
        raw = np.ascontiguousarray(
            np.asarray(out)[:n]).view(np.uint8)[:, : self.packet_size]
        # A contiguous row slice is a view keeping the whole padded device
        # result alive; copy small tails so the batch buffer is released.
        return raw.copy() if 2 * n <= self._pad_lanes(n) else raw

    def decode(self, packets: np.ndarray, raw_sizes: np.ndarray) -> np.ndarray:
        """Padded raw packets (possibly a READ-ONLY view — see
        decode_wait)."""
        return self.decode_wait(self.decode_async(packets, raw_sizes))

    # --- compacted-transfer decode (the file-pipeline hot path) ----------
    def decode_body_async(self, packets: np.ndarray,
                          raw_sizes: np.ndarray):
        """Like decode_async, but the H2D transfer carries a dense blob of
        the compressed bytes (96-B-aligned packet starts) instead of the
        full 8,736-B stride per packet; the device expands it back to
        stride rows with a row gather before the op."""
        from gpuar_tpu import native

        n = packets.shape[0]
        n_pad = self._pad_lanes(n)
        R = self.row_words
        comp_len = (packets[:, 0].astype(np.int32)
                    | (packets[:, 1].astype(np.int32) << 8))
        rcnt = (comp_len + R * 4 - 1) // (R * 4)
        roff = np.zeros(n_pad, np.int32)
        np.cumsum(rcnt[:-1], out=roff[1:n])
        total_rows = int(roff[n - 1] + rcnt[-1]) if n else 0
        kb = -(-max(total_rows, 1) // _BUCKET_ROWS) * _BUCKET_ROWS
        body = native.splice(packets, comp_len)
        blob = native.expand_at(
            np.frombuffer(body, np.uint8),
            roff[:n].astype(np.int64) * (R * 4), comp_len, kb * R * 4)
        pk = self._expand(jnp.asarray(blob.view(np.int32).reshape(kb, R)),
                          jnp.asarray(roff))
        return self._dispatch_sorted_decode(pk, raw_sizes, comp_len, n, n_pad)

    def decode_blob_async(self, blob: np.ndarray, roff: np.ndarray,
                          comp_len: np.ndarray, raw_sizes: np.ndarray):
        """Like decode_body_async, but the caller already built the
        row-aligned upload blob (pipeline._PacketReader.read_batch_blob),
        so the submit path does no whole-body host passes.

        blob: uint8, kb*row_words*4 bytes with kb a _BUCKET_ROWS
        multiple; roff: per-packet row offsets; comp_len: framed packet
        lengths (bytes); raw_sizes: decoded lengths.
        """
        n = raw_sizes.shape[0]
        n_pad = self._pad_lanes(n)
        roff_pad = np.zeros(n_pad, np.int32)
        roff_pad[:n] = roff
        pk = self._expand(
            jnp.asarray(blob.view(np.int32).reshape(-1, self.row_words)),
            jnp.asarray(roff_pad))
        return self._dispatch_sorted_decode(pk, raw_sizes, comp_len, n, n_pad)

    def decode_body_wait(self, handle) -> np.ndarray:
        return self.decode_wait(handle)
