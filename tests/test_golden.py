"""Golden NumPy codec: round-trip properties + native C++ bit-equality."""

import numpy as np
import pytest

from gpuar_tpu import native
from gpuar_tpu.config import PACKET_HEADER_LENGTH, UNCOMPRESSED_PACKET_SIZE
from gpuar_tpu.ops import golden
from conftest import fixture_corpora


def packets_of(data: bytes):
    for off in range(0, max(len(data), 1), UNCOMPRESSED_PACKET_SIZE):
        yield data[off : off + UNCOMPRESSED_PACKET_SIZE]


def test_golden_roundtrip_small(rng):
    for name, data in fixture_corpora(rng, max_size=20000):
        for pkt in packets_of(data):
            enc = golden.encode_packet(pkt)
            total = enc[0] | (enc[1] << 8)
            raw = enc[2] | (enc[3] << 8)
            assert total == len(enc), name
            assert raw == len(pkt), name
            assert golden.decode_packet(enc) == pkt, name


def test_header_fields_empty_packet():
    enc = golden.encode_packet(b"")
    # Even an empty packet carries the tail flush bits.
    assert len(enc) > PACKET_HEADER_LENGTH
    assert enc[2] == 0 and enc[3] == 0
    assert golden.decode_packet(enc) == b""


def test_native_matches_golden_bit_for_bit(rng):
    for name, data in fixture_corpora(rng, max_size=20000):
        for pkt in packets_of(data):
            g = golden.encode_packet(pkt)
            n = native.encode_packet(pkt)
            assert g == n, f"{name}: native encode diverged from golden"
            assert native.decode_packet(g) == pkt, name


def test_native_batch_matches_packetwise(rng):
    data = rng.integers(0, 256, 3 * UNCOMPRESSED_PACKET_SIZE + 777, np.uint8)
    packets, lengths = native.encode_batch(data)
    assert packets.shape[0] == 4
    off = 0
    for i in range(4):
        pkt = data[off : off + UNCOMPRESSED_PACKET_SIZE].tobytes()
        expect = golden.encode_packet(pkt)
        assert lengths[i] == len(expect)
        assert packets[i, : lengths[i]].tobytes() == expect
        off += UNCOMPRESSED_PACKET_SIZE
    out, raws = native.decode_batch(packets)
    assert b"".join(out[i, : raws[i]].tobytes() for i in range(4)) == data.tobytes()


def test_native_batch_mixed_raw_sizes(rng):
    """Short packets mid-batch break the decoder's equal-raw lockstep runs;
    every grouping/fallback seam must still decode bit-exactly."""
    sizes = [8192, 8192, 300, 8192, 8192, 8192, 17, 1, 8192, 4096]
    raws = [bytes(rng.integers(0, 256, s, np.uint8)) for s in sizes]
    encoded = [native.encode_packet(r) for r in raws]
    stride = max(len(e) for e in encoded)
    packets = np.zeros((len(encoded), stride), dtype=np.uint8)
    for i, e in enumerate(encoded):
        packets[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
    out, got_raws = native.decode_batch(packets)
    for i, r in enumerate(raws):
        assert got_raws[i] == len(r)
        assert out[i, : len(r)].tobytes() == r


def test_native_stream_roundtrip(rng):
    data = rng.integers(0, 256, 5 * UNCOMPRESSED_PACKET_SIZE + 123, np.uint8)
    body = native.encode_stream(data)
    back = native.decode_stream(body, out_cap=data.size)
    assert back == data.tobytes()


def test_compressed_size_bound(rng):
    """Worst case must fit the 512-byte slack (src/gpu.h:8)."""
    # Adversarial-ish: cycle all symbols to keep every count minimal.
    cyc = bytes(np.tile(np.arange(256, dtype=np.uint8), 32))
    for data in (cyc, bytes(rng.integers(0, 256, 8192, np.uint8))):
        enc = native.encode_packet(data)
        assert len(enc) <= 8192 + 512


def test_decoder_ignores_trailing_garbage(rng):
    """Reference decoders read past the written stream (src/gpuar_kernel.cu
    readBit) — bit values there must never change the output."""
    pkt = bytes(rng.integers(0, 256, 4096, np.uint8))
    enc = bytearray(golden.encode_packet(pkt))
    enc.extend(b"\xa5" * 8)  # garbage beyond the declared packet length
    assert golden.decode_packet(bytes(enc)) == pkt


def test_property_random_roundtrips(rng):
    """Property sweep: random sizes and content classes round-trip through
    the native stream codec and match the NumPy golden spec encoder."""
    from gpuar_tpu.ops import golden

    for trial in range(30):
        size = int(rng.integers(0, 3 * 8192 + 17))
        kind = trial % 4
        if kind == 0:
            data = rng.integers(0, 256, size, np.uint8).tobytes()
        elif kind == 1:
            data = bytes(size)
        elif kind == 2:
            data = rng.integers(0, 3, size, np.uint8).tobytes()
        else:
            data = (b"abcdef" * (size // 6 + 1))[:size]
        blob = native.encode_stream(np.frombuffer(data, np.uint8))
        back = native.decode_stream(np.frombuffer(blob, np.uint8),
                                    len(data))
        assert back == data, f"trial {trial} size {size} kind {kind}"


def test_native_decode_hull_window_misses():
    """Adversarial inputs for the host decoder's hull window (golden.cpp
    Model::tail_fix): symbols arriving in a rising staircase force a tail
    miss + materialize at every window growth step; a high byte first
    forces immediate sticky-full; boundary bytes 31/32 and 255 exercise
    the 32-row rounding and the top clamp."""
    cases = [
        bytes(range(0, 256, 8)) * 64,              # rising staircase, repeated
        bytes([255]) + bytes(1000),                 # immediate full, then zeros
        bytes([31, 32, 63, 64, 95, 96]) * 300,      # window-boundary walk
        bytes(reversed(range(256))) * 4,            # descending (full at once)
        bytes([0] * 4000 + [255] + [0] * 4000),     # late single tail hit
    ]
    for i, pkt in enumerate(cases):
        enc = native.encode_packet(pkt)
        assert enc == golden.encode_packet(pkt), f"case {i}: encode diverged"
        assert native.decode_packet(enc) == pkt, f"case {i}: decode diverged"
