"""The coder op and the file pipeline on the card (marked `gpu`).

These need a GPU and skip elsewhere; on the card run them with
    GPUAR_TEST_ON_GPU=1 python -m pytest -m gpu tests/
They cover what the CPU build cannot: the CUDA launch geometry, the
shared-memory model layout and residency, at a device-sized batch.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from gpuar_tpu import container, native
from gpuar_tpu.ops import coder_op
from gpuar_tpu.pipeline import HostCompressor

P = 8192


@pytest.fixture(scope="module")
def mixer():
    from benchmarks.corpora import Mixer

    return Mixer(seed=0x6B0, text_block=1 << 20)


@pytest.mark.gpu
def test_gpu_op_matches_golden(gpu, mixer):
    n = coder_op.packets_per_launch(gpu)
    data, sizes = mixer.packets(n)
    sz = jnp.asarray(sizes[None])
    rows, lens = coder_op.encode(jnp.asarray(data.view(np.int32)), sz,
                                 packet_size=P)
    rows_h = np.asarray(rows).view(np.uint8)
    lens_h = np.asarray(lens)[0]
    raw = np.concatenate([data[:-1].reshape(-1), data[-1, :sizes[-1]]])
    host_pk, host_len = HostCompressor(
        threads=os.cpu_count() or 1).encode_batch(raw)
    assert np.array_equal(lens_h, host_len)
    assert native.splice(rows_h, lens_h).tobytes() == \
        native.splice(host_pk, host_len).tobytes()
    out, flags = coder_op.decode(rows, sz, packet_size=P, debug=True)
    assert np.array_equal(np.asarray(out).view(np.uint8), data)
    coder_op.check_debug_flags(np.asarray(flags), lens_h, n)


@pytest.mark.gpu
def test_gpu_pipeline_matches_host_archive(gpu, mixer, tmp_path):
    from gpuar_tpu.parallel.runner import TPUCompressor

    src = tmp_path / "in.bin"
    mixer.write_file(src, (96 << 20) + 777, segment=8 << 20)
    dev, host = tmp_path / "d.gip", tmp_path / "h.gip"
    TPUCompressor().compress(src, dev)
    HostCompressor(threads=0).compress(src, host)
    assert dev.read_bytes() == host.read_bytes()
    back = tmp_path / "back.bin"
    TPUCompressor().decompress(host, back)
    assert back.read_bytes() == src.read_bytes()


@pytest.mark.gpu
def test_gpu_debug_decode_rejects_corrupt_packet(gpu, tmp_path, rng):
    from gpuar_tpu.parallel.runner import TPUCompressor

    src = tmp_path / "in.bin"
    src.write_bytes(bytes(64 * P))
    gip = tmp_path / "c.gip"
    HostCompressor().compress(src, gip)
    blob = bytearray(gip.read_bytes())
    pos = container.HEADER_LENGTH
    pos += blob[pos] | (blob[pos + 1] << 8)  # packet 1
    total = blob[pos] | (blob[pos + 1] << 8)
    blob[pos + 4: pos + total] = rng.integers(0, 256, total - 4,
                                              np.uint8).tobytes()
    bad = tmp_path / "bad.gip"
    bad.write_bytes(bytes(blob))
    with pytest.raises(container.ContainerError, match=r"packets \[1\]"):
        TPUCompressor(debug=True).decompress(bad, tmp_path / "out")
