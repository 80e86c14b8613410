"""The debug decode's checks (reference -D_DEBUG parity).

The reference's debug build asserts on coder range inversion and failed
symbol search (src/gpuar_kernel.cu:290-298,758-762).  Those invariants
are provably maintained for ANY input bit string (arithmetic decoding
maps every stream to some symbol sequence — verified here), so the
debug=True decode additionally exports the final bit cursor and flags
packets whose stream ran dry: the detectable signature of
corrupt-but-well-framed data that release mode (like the reference's)
decodes to silent garbage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuar_tpu import container, native
from gpuar_tpu.ops import coder_op

PSIZE = 512
STRIDE = 1088  # any whole number of 16-byte groups holds a packet row


def decode_batch(packets, sizes, debug=False):
    """Decode fixed-stride packets through the op; with debug, raise
    ContainerError naming corrupt packets."""
    out = coder_op.decode(jnp.asarray(packets.view(np.int32)),
                          jnp.asarray(sizes[None]), packet_size=PSIZE,
                          debug=debug)
    if debug:
        out, flags = out
        comp_len = (packets[:, 0].astype(np.int64)
                    | (packets[:, 1].astype(np.int64) << 8))
        coder_op.check_debug_flags(np.asarray(flags), comp_len,
                                   packets.shape[0])
    return np.asarray(out).view(np.uint8)


def _packets(rows):
    pk = [native.encode_packet(d.tobytes()) for d in rows]
    packets = np.zeros((len(pk), STRIDE), np.uint8)
    for i, p in enumerate(pk):
        packets[i, : len(p)] = np.frombuffer(p, np.uint8)
    return packets, [len(p) for p in pk]


def test_debug_decode_clean_batch_passes(rng):
    data = np.zeros((4, PSIZE), np.uint8)
    data[0] = rng.integers(0, 256, PSIZE, np.uint8)
    data[2] = rng.integers(126, 130, PSIZE, np.uint8)  # underflow-heavy
    data[3, :256] = 65
    packets, _ = _packets(data)
    sizes = np.full(4, PSIZE, np.int32)
    out = decode_batch(packets, sizes, debug=True)
    assert np.array_equal(out, data)


def test_debug_decode_flags_corrupt_packet(rng):
    """A compressible packet whose bitstream is replaced by noise (header
    kept intact) consumes far more bits than the frame holds: release
    mode decodes silent garbage, debug mode names the packet."""
    data = np.zeros((2, PSIZE), np.uint8)
    data[0] = rng.integers(0, 256, PSIZE, np.uint8)
    packets, lens = _packets(data)
    sizes = np.full(2, PSIZE, np.int32)
    corrupt = packets.copy()
    corrupt[1, 4: lens[1]] = rng.integers(0, 256, lens[1] - 4, np.uint8)

    # Release mode: same as the reference without -D_DEBUG — garbage out.
    out = decode_batch(corrupt, sizes)
    assert np.array_equal(out[0], data[0])
    assert not np.array_equal(out[1], data[1])

    with pytest.raises(container.ContainerError, match=r"packets \[1\]"):
        decode_batch(corrupt, sizes, debug=True)


def test_mesh_debug_decode_flags_corrupt_packet(rng):
    """The debug variant works through the sharded MeshCodec path (what
    TPUCompressor(debug=True) / the CLI --debug flag use)."""
    from gpuar_tpu.parallel.mesh import MeshCodec, make_mesh

    data = np.zeros((2, PSIZE), np.uint8)
    data[0] = rng.integers(0, 256, PSIZE, np.uint8)
    packets, lens = _packets(data)
    sizes = np.full(2, PSIZE, np.int32)
    codec = MeshCodec(make_mesh(jax.devices()[:2]), packet_size=PSIZE,
                      debug=True)
    # Clean batch decodes fine.
    out = codec.decode(packets, sizes)
    assert np.array_equal(np.asarray(out), data)
    # Noise body under an intact frame raises.
    corrupt = packets.copy()
    corrupt[1, 4: lens[1]] = rng.integers(0, 256, lens[1] - 4, np.uint8)
    with pytest.raises(container.ContainerError, match="Corrupt packet"):
        codec.decode(corrupt, sizes)


def test_cli_debug_flag_validation(tmp_path):
    import subprocess
    import sys as _sys

    src = tmp_path / "x.bin"
    src.write_bytes(b"hello")
    for bad in (["c", f"--in={src}", "--debug"],
                ["d", f"--in={src}", "--debug", "--host"]):
        r = subprocess.run(
            [_sys.executable, "-m", "gpuar_tpu.cli", *bad,
             "--nointeractive"],
            capture_output=True, text=True,
            cwd=str(FIXED_REPO_ROOT))
        assert r.returncode == 2
        assert "--debug" in r.stderr


FIXED_REPO_ROOT = __import__("pathlib").Path(__file__).parent.parent


def test_coder_invariants_hold_for_arbitrary_streams(rng):
    """Sanity for the docstring claim: random bit strings framed as
    packets decode without tripping the invariant flags (the coder
    always keeps code within [lower, upper])."""
    packets = np.zeros((2, STRIDE), np.uint8)
    for i in range(2):
        body = rng.integers(0, 256, 200, np.uint8)
        total = 204
        packets[i, 0] = total & 0xFF
        packets[i, 1] = total >> 8
        packets[i, 2] = PSIZE & 0xFF
        packets[i, 3] = PSIZE >> 8
        packets[i, 4:204] = body
    sizes = np.full(2, PSIZE, np.int32)
    # Must not raise for the INVARIANT flags; the overrun check may or
    # may not fire depending on how fast the noise consumes bits, so
    # inspect the raw flags instead of decode_batch's raise.
    _, flags = coder_op.decode(jnp.asarray(packets.view(np.int32)),
                               jnp.asarray(sizes[None]), packet_size=PSIZE,
                               debug=True)
    assert not np.asarray(flags)[0, :2].any()
