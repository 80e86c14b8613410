"""XLA scan codec vs golden: bit-equality per packet, round-trips."""

import numpy as np

from gpuar_tpu import native
from gpuar_tpu.config import COMPRESSED_PACKET_SIZE, UNCOMPRESSED_PACKET_SIZE
from gpuar_tpu.ops import xla_codec
from conftest import fixture_corpora

P = UNCOMPRESSED_PACKET_SIZE


def to_batch(chunks):
    """Pad byte-chunks into [B, P] + sizes."""
    b = len(chunks)
    data = np.zeros((b, P), dtype=np.uint8)
    sizes = np.zeros(b, dtype=np.int32)
    for i, c in enumerate(chunks):
        data[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
        sizes[i] = len(c)
    return data, sizes


def split_packets(data: bytes):
    return [data[o : o + P] for o in range(0, max(len(data), 1), P)]


def test_xla_encode_bit_identical_to_golden(rng):
    chunks = []
    for name, data in fixture_corpora(rng, max_size=20000):
        chunks.extend(split_packets(data))
    data, sizes = to_batch(chunks)
    packets, lengths = xla_codec.encode_batch_xla(data, sizes)
    for i, c in enumerate(chunks):
        expect = native.encode_packet(c)
        got = packets[i, : lengths[i]].tobytes()
        assert got == expect, f"lane {i} (len {len(c)}) diverged"


def test_xla_decode_matches_golden(rng):
    chunks = []
    for name, data in fixture_corpora(rng, max_size=20000):
        chunks.extend(split_packets(data))
    enc = [native.encode_packet(c) for c in chunks]
    packets = np.zeros((len(enc), COMPRESSED_PACKET_SIZE), dtype=np.uint8)
    raw_sizes = np.zeros(len(enc), dtype=np.int32)
    for i, e in enumerate(enc):
        packets[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
        raw_sizes[i] = len(chunks[i])
    out = xla_codec.decode_batch_xla(packets, raw_sizes)
    for i, c in enumerate(chunks):
        assert out[i, : raw_sizes[i]].tobytes() == c, f"lane {i} diverged"


def test_xla_roundtrip_random_batch(rng):
    data = rng.integers(0, 256, (16, P), dtype=np.uint8)
    sizes = np.full(16, P, dtype=np.int32)
    sizes[-1] = 777  # ragged tail lane
    data[-1, 777:] = 0
    packets, lengths = xla_codec.encode_batch_xla(data, sizes)
    out = xla_codec.decode_batch_xla(packets, sizes)
    for i in range(16):
        assert out[i, : sizes[i]].tobytes() == data[i, : sizes[i]].tobytes()


def test_xla_cross_backend_with_native(rng):
    """XLA-encoded packets decode with the native codec and vice versa."""
    raw = rng.integers(0, 256, 2 * P + 100, dtype=np.uint8)
    data, sizes = to_batch(split_packets(raw.tobytes()))
    packets, lengths = xla_codec.encode_batch_xla(data, sizes)
    # native decode of XLA encode
    for i in range(data.shape[0]):
        assert native.decode_packet(packets[i, : lengths[i]].tobytes()) == \
            data[i, : sizes[i]].tobytes()
    # XLA decode of native encode
    npk, nlen = native.encode_batch(raw)
    out = xla_codec.decode_batch_xla(npk, sizes)
    for i in range(npk.shape[0]):
        assert out[i, : sizes[i]].tobytes() == data[i, : sizes[i]].tobytes()
