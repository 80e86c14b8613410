"""TPUCompressor: the device-backed file pipeline.

Equivalent of the reference's GPUCompressor (src/gpu_compressor.cpp): reads
super-batches of packets, codes them on the device mesh, splices results in
order into the .gip container.  The default super-batch fills every SM of
every device, the way the reference sizes its launches from the SM count
(:77-79); CPU meshes keep the pipeline's default.  JAX's async dispatch overlaps the device work of batch N with the
host read/write of batch N±1, playing the role of the reference's rotating
CUDA streams (:124-196).
"""

from __future__ import annotations

import numpy as np

import jax

from gpuar_tpu.ops import coder_op
from gpuar_tpu.parallel.mesh import _BUCKET_ROWS, MeshCodec, make_mesh
from gpuar_tpu.pipeline import DEFAULT_SUPER_BATCH_PACKETS, Compressor


class NoGPUError(RuntimeError):
    """The device path was asked for, but JAX found no GPU."""


def _cpu_on_purpose() -> bool:
    """True when the process selected the CPU backend itself
    (JAX_PLATFORMS=cpu), as the tests and CPU rehearsals do."""
    return (jax.config.jax_platforms or "").strip().lower() == "cpu"


def check_platform(devices) -> None:
    """Refuse to run the device path anywhere but on a GPU, unless the CPU
    was selected on purpose.  JAX drops to the CPU by itself when its CUDA
    plugin fails to start; this catches that too."""
    platform = devices[0].platform
    if platform == "gpu" or (platform == "cpu" and _cpu_on_purpose()):
        return
    raise NoGPUError(
        f"no GPU found (JAX's backend is {platform!r}): run the codec on "
        "the host CPU with --host (host=True in the library), or set "
        "JAX_PLATFORMS=cpu to run the device path on the CPU on purpose")


class TPUCompressor(Compressor):
    def __init__(self, device_index: int | None = None,
                 super_batch_packets: int | None = None,
                 debug: bool = False, packet_size: int | None = None):
        # Local devices only: in a multi-process run each process codes its
        # own file range on its own devices (DistributedCompressor handles
        # the cross-process splice); a global-device mesh would be
        # unaddressable.
        devices = jax.local_devices()
        if not devices:
            raise RuntimeError("no JAX devices")
        check_platform(devices)
        if device_index is not None:
            if device_index < 0 or device_index >= len(devices):
                raise ValueError(f"no device {device_index}")
            devices = [devices[device_index]]
        # debug: decompress through the op's debug variant (the
        # reference's -D_DEBUG coder checks + bitstream-overrun detection)
        # — corrupt-but-well-framed packets raise instead of decoding to
        # silent garbage.
        # packet_size: production default (8192, config.py); tests pass a
        # tiny geometry to keep the CPU runs short.
        kw = {} if packet_size is None else {"packet_size": packet_size}
        self.codec = MeshCodec(make_mesh(devices), debug=debug, **kw)
        self.packet_size = self.codec.packet_size
        q = self.codec.lane_quantum
        if super_batch_packets is None and devices[0].platform == "gpu":
            super_batch_packets = coder_op.super_batch_packets(
                [coder_op.packets_per_launch(d) for d in devices], q)
        elif super_batch_packets is None:
            # CPU devices share one host's cores: the pipeline's default
            # in all, however many virtual devices the mesh has.
            super_batch_packets = DEFAULT_SUPER_BATCH_PACKETS
        # Round the super-batch to the mesh lane quantum.
        super_batch_packets = max(q, super_batch_packets // q * q)
        super().__init__(super_batch_packets=super_batch_packets)

    def _packetize(self, raw: np.ndarray):
        psize = self.codec.packet_size
        n = max(-(-raw.size // psize), 1) if raw.size else 0
        if n == 0:
            return None, None
        sizes = np.full(n, psize, np.int32)
        if raw.size == n * psize and raw.flags.c_contiguous:
            # Whole batches (every compress batch but the file tail) are
            # already packet-aligned: reshape the read buffer in place
            # instead of a whole-batch memcpy on the submit path.
            return raw.reshape(n, psize), sizes
        data = np.zeros((n, psize), np.uint8)
        data.reshape(-1)[: raw.size] = raw
        sizes[-1] = raw.size - (n - 1) * psize
        return data, sizes

    def encode_batch(self, raw: np.ndarray):
        return self.encode_fetch(self.encode_submit(raw))

    def decode_batch(self, packets: np.ndarray, raw_sizes: np.ndarray):
        return self.decode_fetch(self.decode_submit(packets, raw_sizes))

    # Async pipeline interface (pipeline.Compressor drive loops): the
    # device runs batch N+1 while the host writes batch N.
    def encode_submit(self, raw: np.ndarray):
        data, sizes = self._packetize(raw)
        if data is None:
            return None
        # Compacted-transfer path: D2H fetches a dense blob of compressed
        # bytes instead of the full 8,736-B stride per packet (the
        # reference ships full stride, src/gpu_compressor.cpp:138).
        return self.codec.encode_body_async(data, sizes)

    def encode_fetch(self, handle):
        if handle is None:
            return (np.zeros((0, 1), np.uint8), np.zeros(0, np.int32))
        return self.codec.encode_body_wait(handle)

    def decode_submit(self, packets: np.ndarray, raw_sizes: np.ndarray):
        return self.codec.decode_body_async(packets, raw_sizes)

    # Compacted-upload path: pipeline.decompress builds the row-aligned
    # blob straight from the packet reader's block buffer and submits it
    # here — no fixed-stride batch, no splice/expand host passes on the
    # critical path.
    def decode_blob_geometry(self):
        return (self.codec.row_words * 4, _BUCKET_ROWS)

    def decode_submit_blob(self, blob, roff, comp_len, raw_sizes):
        return self.codec.decode_blob_async(blob, roff, comp_len, raw_sizes)

    def decode_fetch(self, handle):
        return self.codec.decode_body_wait(handle)
