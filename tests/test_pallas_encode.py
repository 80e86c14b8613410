"""Encode through the coder op vs the golden codec (CPU build of the op).

The op is parametric in packet size, so small geometries cover the
emission machinery quickly: word flushes, underflow runs, ragged tails.
"""

import numpy as np

from gpuar_tpu import native
from gpuar_tpu.parallel.mesh import MeshCodec, make_mesh


def check(data, sizes, packet_size):
    import jax

    codec = MeshCodec(make_mesh(jax.devices()[:1]), packet_size=packet_size)
    pk, ln = codec.encode(data, sizes)
    for i in range(data.shape[0]):
        exp = native.encode_packet(data[i, : sizes[i]].tobytes())
        got = pk[i, : ln[i]].tobytes()
        assert got == exp, f"packet {i} (size {sizes[i]}) diverged"


def test_random_small_packets(rng):
    P = 64
    data = rng.integers(0, 256, (8, P), np.uint8)
    sizes = np.full(8, P, np.int32)
    sizes[-1] = 37
    data[-1, 37:] = 0
    check(data, sizes, P)


def test_multi_chunk_and_tiles(rng):
    # Several content classes in one batch, including empty and one-byte
    # packets.
    P = 128
    data = np.zeros((16, P), np.uint8)
    data[0] = 0                      # all zeros: heavy compression+underflow
    data[1] = 0xFF
    data[2] = rng.integers(0, 256, P, np.uint8)
    data[3, :] = np.arange(P) % 256  # cycling
    data[4:] = rng.integers(0, 4, (12, P), np.uint8)  # skewed
    sizes = np.full(16, P, np.int32)
    sizes[5] = 0                     # empty packet
    sizes[6] = 1
    data[5] = 0
    data[6, 1:] = 0
    check(data, sizes, P)


def test_underflow_run_path(rng):
    # Content engineered to produce long 01/10 straddles: alternating
    # symbols around the range midpoint after a biased warmup.
    P = 256
    data = np.tile(np.array([128, 127], np.uint8), P // 2)[None, :].repeat(8, 0)
    data[1] = np.tile(np.array([128, 127, 128, 126], np.uint8), P // 4)
    data[2:] = rng.integers(126, 130, (6, P), np.uint8)
    sizes = np.full(8, P, np.int32)
    check(data, sizes, P)
