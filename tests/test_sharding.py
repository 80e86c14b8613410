"""Multi-device sharding on the 8-device virtual CPU mesh."""

import jax
import numpy as np

from gpuar_tpu import native
from gpuar_tpu.parallel.mesh import MeshCodec, make_mesh


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_roundtrip_bit_identical(rng):
    P = 64
    codec = MeshCodec(make_mesh(), packet_size=P)
    assert codec.lane_quantum == 256  # 8 devices x 32-packet blocks

    n = 300  # forces lane padding beyond one quantum
    data = rng.integers(0, 256, (n, P), np.uint8)
    sizes = np.full(n, P, np.int32)
    sizes[7] = 13
    data[7, 13:] = 0
    sizes[263] = 0
    data[263] = 0

    packets, lengths = codec.encode(data, sizes)
    for i in range(n):
        exp = native.encode_packet(data[i, : sizes[i]].tobytes())
        assert packets[i, : lengths[i]].tobytes() == exp, f"lane {i}"

    out = codec.decode(packets, sizes)
    for i in range(n):
        assert out[i, : sizes[i]].tobytes() == data[i, : sizes[i]].tobytes()


def test_single_vs_multi_device_identical(rng):
    """Sharded output must be byte-identical to 1-device output."""
    P = 64
    n = 16
    data = rng.integers(0, 256, (n, P), np.uint8)
    sizes = np.full(n, P, np.int32)

    multi = MeshCodec(make_mesh(), packet_size=P)
    single = MeshCodec(make_mesh(jax.devices()[:1]), packet_size=P)
    pm, lm = multi.encode(data, sizes)
    ps, ls = single.encode(data, sizes)
    assert np.array_equal(lm, ls)
    for i in range(n):
        assert pm[i, : lm[i]].tobytes() == ps[i, : ls[i]].tobytes()


def test_compacted_body_path_matches_stride_path(rng):
    """encode_body/decode_body (device-side compaction of the transfers)
    must produce exactly the stride path's spliced bytes and round-trip."""
    P = 64
    codec = MeshCodec(make_mesh(), packet_size=P)

    n = 70  # lane padding + a short tail + an empty lane
    data = rng.integers(0, 256, (n, P), np.uint8)
    sizes = np.full(n, P, np.int32)
    sizes[3] = 9
    data[3, 9:] = 0
    sizes[-1] = 0
    # A compressible stretch so compacted lengths genuinely vary.
    data[10:30] = 7

    packets, lengths = codec.encode(data, sizes)
    expected = b"".join(
        packets[i, : lengths[i]].tobytes() for i in range(n))

    body, lengths2 = codec.encode_body(data, sizes)
    assert np.array_equal(lengths2, lengths)
    assert body.tobytes() == expected

    # Rebuild stride packets from the body (what the reader would see)
    # and decode through the compacted upload path.
    stride = np.zeros((n, packets.shape[1]), np.uint8)
    pos = 0
    for i in range(n):
        stride[i, : lengths[i]] = np.frombuffer(
            expected, np.uint8, lengths[i], pos)
        pos += lengths[i]
    out = codec.decode_body_wait(codec.decode_body_async(stride, sizes))
    for i in range(n):
        assert out[i, : sizes[i]].tobytes() == data[i, : sizes[i]].tobytes()

    # The reader-built blob path (round 5): _PacketReader.read_batch_blob
    # assembles the row-aligned upload blob straight from the framed
    # stream — no fixed-stride batch, no splice/expand host passes — and
    # decode_blob_async must decode it identically.
    import io

    from gpuar_tpu.pipeline import _PacketReader

    reader = _PacketReader(io.BytesIO(expected))
    batch = reader.read_batch_blob(n + 5, codec.row_words * 4, 64)
    assert reader.read_batch_blob(n + 5, codec.row_words * 4, 64) is None
    blob, roff, comp_len, raw2 = batch
    assert np.array_equal(comp_len, lengths)
    assert np.array_equal(raw2, sizes)
    assert blob.size % (64 * codec.row_words * 4) == 0
    out2 = codec.decode_body_wait(
        codec.decode_blob_async(blob, roff, comp_len, raw2))
    for i in range(n):
        assert out2[i, : sizes[i]].tobytes() == \
            data[i, : sizes[i]].tobytes(), f"blob lane {i}"
