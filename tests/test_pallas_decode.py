"""Decode through the coder op vs golden-encoded packets (CPU build)."""

import jax
import jax.numpy as jnp
import numpy as np

from gpuar_tpu import native
from gpuar_tpu.ops import coder_op


def roundtrip(data, sizes, packet_size):
    n = data.shape[0]
    enc = [native.encode_packet(data[i, : sizes[i]].tobytes()) for i in range(n)]
    pk = np.zeros((n, coder_op.out_words(packet_size) * 4), np.uint8)
    for i, e in enumerate(enc):
        pk[i, : len(e)] = np.frombuffer(e, np.uint8)
    out = jax.jit(lambda r, s: coder_op.decode(r, s, packet_size=packet_size))(
        jnp.asarray(pk.view(np.int32)), jnp.asarray(sizes[None]))
    out = np.asarray(out).view(np.uint8)
    for i in range(n):
        assert out[i, : sizes[i]].tobytes() == data[i, : sizes[i]].tobytes(), \
            f"packet {i} (size {sizes[i]})"


def test_decode_random(rng):
    P = 64
    data = rng.integers(0, 256, (8, P), np.uint8)
    sizes = np.full(8, P, np.int32)
    sizes[3] = 17
    sizes[5] = 0
    roundtrip(data, sizes, P)


def test_decode_content_classes(rng):
    P = 128
    data = np.zeros((8, P), np.uint8)
    data[0] = 0
    data[1] = 0xFF
    data[2] = rng.integers(0, 256, P, np.uint8)
    data[3] = np.arange(P) % 256
    data[4:] = rng.integers(126, 130, (4, P), np.uint8)  # underflow-heavy
    sizes = np.full(8, P, np.int32)
    roundtrip(data, sizes, P)
