"""gpuar_tpu: a block-parallel adaptive arithmetic coding codec for GPUs.

A from-scratch rebuild of the capabilities of jiahansu/GPUAR: files are
split into independent 8192-byte packets, one GPU thread codes one packet
with its own adaptive model (a CUDA kernel called from JAX through
``jax.ffi``), and batches shard data-parallel over the local GPUs.  The
.gip container is interchangeable with the reference.
"""

__version__ = "0.1.0"

from gpuar_tpu.config import CodecConfig, DEFAULT_CONFIG  # noqa: F401
from gpuar_tpu.container import ContainerError, FileHeader  # noqa: F401
from gpuar_tpu.utils.stats import CompressionInfo, ProgressMonitor  # noqa: F401


def _pick_backend(host: bool, threads: int, debug: bool = False):
    """Same backend policy as the CLI: the GPU by default, the host codec
    on request (``host=True``).  Without a GPU the device backend raises
    NoGPUError; it never falls back to the host codec by itself."""
    if host:
        from gpuar_tpu.pipeline import HostCompressor
        return HostCompressor(threads=threads)
    from gpuar_tpu.parallel.runner import TPUCompressor
    return TPUCompressor(debug=debug)


def compress(src, dst, *, host: bool = False, threads: int = 1,
             resume: bool = False, monitor=None) -> "CompressionInfo":
    """Compress file ``src`` into .gip archive ``dst`` (library mirror of
    the CLI ``c`` verb).  ``host=True`` runs the native host codec;
    otherwise the GPU, and NoGPUError when there is none."""
    return _pick_backend(host, threads).compress(
        src, dst, monitor=monitor, resume=resume)


def decompress(src, dst, *, host: bool = False, threads: int = 1,
               debug: bool = False, monitor=None) -> "CompressionInfo":
    """Decompress .gip archive ``src`` into file ``dst`` (CLI ``d``).
    ``debug=True`` enables the device decode's corrupt-packet detection
    (device path only)."""
    return _pick_backend(host, threads, debug=debug).decompress(
        src, dst, monitor=monitor)


def verify(path, *, deep: bool = False, threads: int = 1) -> dict:
    """Integrity-check a .gip archive (CLI ``v``); see
    pipeline.verify_archive."""
    from gpuar_tpu.pipeline import verify_archive
    return verify_archive(path, deep=deep, threads=threads)


def __getattr__(name):
    # Lazy heavyweight entry points (importing JAX only when asked for).
    if name == "HostCompressor":
        from gpuar_tpu.pipeline import HostCompressor
        return HostCompressor
    if name == "TPUCompressor":
        from gpuar_tpu.parallel.runner import TPUCompressor
        return TPUCompressor
    if name == "DistributedCompressor":
        from gpuar_tpu.parallel.distributed import DistributedCompressor
        return DistributedCompressor
    if name == "MeshCodec":
        from gpuar_tpu.parallel.mesh import MeshCodec
        return MeshCodec
    raise AttributeError(f"module 'gpuar_tpu' has no attribute {name!r}")
