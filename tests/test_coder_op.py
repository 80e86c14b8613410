"""The coder op (jax.ffi) on its CPU build: bit-exactness against the
native golden codec, the debug decode, the capacity flag, lane padding,
super-batch sizing, compile-cache placement and the no-GPU policy.

The CPU build compiles the same coder.h as the CUDA build, so these cases
pin the coder's arithmetic, the FFI binding and the shapes; only the
launch geometry and the shared-memory layout are left to the card
(tests/test_gpu.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks.corpora import adversarial_underflow_packet
from gpuar_tpu import container, native
from gpuar_tpu.config import CodecConfig
from gpuar_tpu.config import UNCOMPRESSED_PACKET_SIZE as P
from gpuar_tpu.ops import coder_op, xla_codec
from conftest import fixture_corpora

REPO = Path(__file__).resolve().parent.parent
CASES = [name for name, _ in fixture_corpora(np.random.default_rng(0))]
CASES.append("adversarial")


def _corpus(name: str) -> bytes:
    if name == "adversarial":
        return adversarial_underflow_packet().tobytes()
    return dict(fixture_corpora(np.random.default_rng(0)))[name]


def _packets(data: bytes, packet_size: int = P):
    """Split into padded packets [n, packet_size] u8 + raw sizes (an empty
    input is one empty packet)."""
    n = max(-(-len(data) // packet_size), 1)
    buf = np.zeros(n * packet_size, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    sizes = np.full(n, packet_size, np.int32)
    sizes[-1] = len(data) - (n - 1) * packet_size
    return buf.reshape(n, packet_size), sizes


def _encode(data: np.ndarray, sizes: np.ndarray, packet_size: int = P):
    rows, lens = coder_op.encode(jnp.asarray(data.view(np.int32)),
                                 jnp.asarray(sizes[None]),
                                 packet_size=packet_size)
    return np.asarray(rows).view(np.uint8), np.asarray(lens)[0]


def _golden_rows(data, sizes, packet_size: int = P):
    rows = np.zeros((data.shape[0], coder_op.out_words(packet_size) * 4),
                    np.uint8)
    for i in range(data.shape[0]):
        enc = native.encode_packet(data[i, : sizes[i]].tobytes())
        rows[i, : len(enc)] = np.frombuffer(enc, np.uint8)
    return rows


@pytest.mark.parametrize("name", CASES)
def test_encode_matches_golden(name):
    data, sizes = _packets(_corpus(name))
    rows, lens = _encode(data, sizes)
    for i in range(data.shape[0]):
        exp = native.encode_packet(data[i, : sizes[i]].tobytes())
        assert lens[i] == len(exp), f"packet {i}"
        assert rows[i, : lens[i]].tobytes() == exp, f"packet {i}"


@pytest.mark.parametrize("name", CASES)
def test_decode_round_trip(name):
    data, sizes = _packets(_corpus(name))
    rows = _golden_rows(data, sizes)
    out = coder_op.decode(jnp.asarray(rows.view(np.int32)),
                          jnp.asarray(sizes[None]), packet_size=P)
    # Bytes past each raw size come back as zeros, like the padding.
    assert np.array_equal(np.asarray(out).view(np.uint8), data)


def _debug_decode(rows, sizes, packet_size):
    out, flags = coder_op.decode(jnp.asarray(rows.view(np.int32)),
                                 jnp.asarray(sizes[None]),
                                 packet_size=packet_size, debug=True)
    return np.asarray(out).view(np.uint8), np.asarray(flags)


@pytest.mark.parametrize("kind", ["random", "zeros", "underflow", "text",
                                  "short"])
def test_debug_decode_clean_passes(kind, rng):
    psize = 512
    data = {
        "random": lambda: rng.integers(0, 256, psize, np.uint8),
        "zeros": lambda: np.zeros(psize, np.uint8),
        "underflow": lambda: rng.integers(126, 130, psize, np.uint8),
        "text": lambda: np.frombuffer((b"abc def " * 64)[:psize], np.uint8),
        "short": lambda: rng.integers(0, 256, psize, np.uint8),
    }[kind]()[None].copy()
    sizes = np.array([37 if kind == "short" else psize], np.int32)
    data[0, sizes[0]:] = 0
    rows = _golden_rows(data, sizes, psize)
    out, flags = _debug_decode(rows, sizes, psize)
    assert np.array_equal(out, data)
    lens = rows[:, 0].astype(np.int64) | (rows[:, 1].astype(np.int64) << 8)
    coder_op.check_debug_flags(flags, lens, 1)
    # The cursor starts past the header and the primed 16-bit window.
    assert 48 <= flags[1, 0] <= lens[0] * 8 + 16


@pytest.mark.parametrize("corruption", ["noise_body", "truncated_frame"])
def test_debug_decode_flags_corrupt_packet(corruption, rng):
    psize = 512
    data = np.zeros((3, psize), np.uint8)
    data[0] = rng.integers(0, 256, psize, np.uint8)
    sizes = np.full(3, psize, np.int32)
    rows = _golden_rows(data, sizes, psize)
    lens = rows[:, 0].astype(np.int64) | (rows[:, 1].astype(np.int64) << 8)
    if corruption == "noise_body":
        rows[1, 4: lens[1]] = rng.integers(0, 256, lens[1] - 4, np.uint8)
    else:  # the frame claims fewer bytes than the stream needs
        lens[1] = lens[1] // 2
        rows[1, 0], rows[1, 1] = lens[1] & 0xFF, lens[1] >> 8
    _, flags = _debug_decode(rows, sizes, psize)
    with pytest.raises(container.ContainerError, match=r"packets \[1\]"):
        coder_op.check_debug_flags(flags, lens, 3)


def test_adversarial_underflow_run_coded_in_op():
    """The adversary keeps ~133 underflow bits pending at once; one
    serial coder per packet emits any run length, so the op must match the
    golden codec with no host re-encode behind it."""
    adv = adversarial_underflow_packet()
    data = np.stack([adv, adv[::-1].copy()])
    sizes = np.full(2, P, np.int32)
    rows, lens = _encode(data, sizes)
    for i in range(2):
        assert rows[i, : lens[i]].tobytes() == \
            native.encode_packet(data[i].tobytes())


def test_op_matches_xla_reference(rng):
    """The op against the plain lax.scan coder (ops/xla_codec.py)."""
    psize = 256
    data = rng.integers(0, 256, (6, psize), np.uint8)
    data[1] = 0
    data[2] = rng.integers(120, 136, psize, np.uint8)
    sizes = np.array([psize, psize, psize, 1, 0, 200], np.int32)
    for i, s in enumerate(sizes):
        data[i, s:] = 0
    rows, lens = _encode(data, sizes, psize)
    ref, ref_len = xla_codec.encode_batch_xla(data, sizes, packet_size=psize)
    assert np.array_equal(lens, ref_len)
    for i in range(6):
        assert rows[i, : lens[i]].tobytes() == ref[i, : ref_len[i]].tobytes()
    back = xla_codec.decode_batch_xla(rows, sizes, packet_size=psize)
    for i in range(6):
        assert np.array_equal(back[i, : sizes[i]], data[i, : sizes[i]])


def test_overflowing_stream_is_flagged_not_truncated(rng):
    """A row too small for the stream: the op reports the true length and
    check_lengths names the packet."""
    coder_op._ensure_registered()
    psize = 64
    data = rng.integers(0, 256, (2, psize), np.uint8)
    data[1] = 0
    sizes = np.full((1, 2), psize, np.int32)
    cap = 16  # words: 64 bytes, too few for 64 random bytes
    rows, lens = jax.ffi.ffi_call("gip_encode", (
        jax.ShapeDtypeStruct((2, cap), jnp.int32),
        jax.ShapeDtypeStruct((1, 2), jnp.int32)))(
        jnp.asarray(data.view(np.int32)), jnp.asarray(sizes),
        packet_size=np.int32(psize))
    lens = np.asarray(lens)[0]
    assert lens[0] == len(native.encode_packet(data[0].tobytes())) > cap * 4
    assert lens[1] <= cap * 4
    with pytest.raises(ValueError, match=r"packets \[0\]"):
        coder_op.check_lengths(lens, cap * 4)


def test_op_rejects_mismatched_packet_size():
    with pytest.raises(Exception, match="packet_size"):
        jax.block_until_ready(coder_op.encode(
            jnp.zeros((2, 16), jnp.int32), jnp.zeros((1, 2), jnp.int32),
            packet_size=128))
    with pytest.raises(ValueError, match="multiple of 16"):
        coder_op.encode(jnp.zeros((2, 6), jnp.int32),
                        jnp.zeros((1, 2), jnp.int32), packet_size=24)


@pytest.mark.parametrize("path", ["wrapper", "ffi"])
def test_op_rejects_packet_size_past_model_bound(path):
    """16128 bytes would push the model's counts past MAX_PROBABILITY
    (config.CodecConfig); both the wrapper and the FFI handler refuse it."""
    psize = coder_op.PACKET_SIZE_LIMIT + 1
    assert psize == 16128 and psize % 16 == 0
    with pytest.raises(ValueError, match="too large"):
        CodecConfig(uncompressed_packet_size=psize)
    words = jnp.zeros((1, psize // 4), jnp.int32)
    sizes = jnp.zeros((1, 1), jnp.int32)
    if path == "wrapper":
        with pytest.raises(ValueError, match="below 16127"):
            coder_op.encode(words, sizes, packet_size=psize)
        return
    coder_op.encode(jnp.zeros((1, 4), jnp.int32), sizes, packet_size=16)
    shapes = (jax.ShapeDtypeStruct((1, coder_op.out_words(psize)), jnp.int32),
              jax.ShapeDtypeStruct((1, 1), jnp.int32))
    with pytest.raises(Exception, match="below 16127"):
        jax.block_until_ready(jax.ffi.ffi_call("gip_encode", shapes)(
            words, sizes, packet_size=np.int32(psize)))


@pytest.mark.parametrize("n", [0, 1, 255, 257])
def test_mesh_lane_padding(n, rng):
    """Batches pad to devices x BLOCK lanes (256 on the 8-device mesh):
    empty, one packet, one short of and one past a quantum."""
    from gpuar_tpu.parallel.mesh import MeshCodec, make_mesh

    psize = 64
    codec = MeshCodec(make_mesh(), packet_size=psize)
    assert codec.lane_quantum == 8 * coder_op.BLOCK == 256
    data = rng.integers(0, 256, (n, psize), np.uint8)
    sizes = np.full(n, psize, np.int32)
    if n:
        sizes[-1] = 9
        data[-1, 9:] = 0
    packets, lengths = codec.encode(data, sizes)
    assert packets.shape[0] == lengths.shape[0] == n
    for i in range(n):
        assert packets[i, : lengths[i]].tobytes() == \
            native.encode_packet(data[i, : sizes[i]].tobytes())
    out = codec.decode(packets, sizes)
    assert out.shape == (n, psize)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("sms, per_sm, devices, quantum, expect", [
    (132, 416, 1, 32, 54912),        # one H100: 132 SMs x 416 packets
    (132, 416, 4, 128, 219648),      # four cards, each full
    (3, 10, 1, 32, 32),              # a tiny device still gets a quantum
    (5, 7, 2, 64, 64),               # rounded down to the quantum
])
def test_super_batch_from_sm_count(sms, per_sm, devices, quantum, expect):
    assert coder_op.super_batch_packets(
        [sms * per_sm] * devices, quantum) == expect


def test_cpu_super_batch_default():
    from gpuar_tpu.parallel.runner import TPUCompressor

    from gpuar_tpu.pipeline import DEFAULT_SUPER_BATCH_PACKETS

    assert coder_op.packets_per_launch(jax.devices()[0]) == \
        DEFAULT_SUPER_BATCH_PACKETS
    # The 8 virtual devices share one host: the default is the total.
    t = TPUCompressor(packet_size=64)
    assert t.codec.n_devices == 8
    assert t.super_batch_packets == DEFAULT_SUPER_BATCH_PACKETS
    assert TPUCompressor(packet_size=64, device_index=0,
                         super_batch_packets=100).super_batch_packets == 96


@pytest.mark.parametrize("env_dir", [None, "/some/where/cache"])
def test_compile_cache_placement(env_dir):
    from gpuar_tpu.parallel import mesh

    environ = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": env_dir}
    got = mesh.compilation_cache_dir(environ)
    if env_dir is None:
        assert got == REPO / ".jax_cache"
        assert ".jax_cache/" in (REPO / ".gitignore").read_text()
    else:
        assert got is None  # JAX reads the variable; the program sets nothing


def test_cli_without_gpu_names_host(tmp_path):
    """A process whose JAX fell back to the CPU without being asked to
    (here: CUDA requested but absent) must not code on the CPU by itself."""
    src = tmp_path / "in.bin"
    src.write_bytes(b"hello world" * 100)
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    for argv in (["c", f"--in={src}", f"--out={tmp_path / 'x.gip'}"],
                 ["d", f"--in={src}", f"--out={tmp_path / 'x'}", "--debug"]):
        r = subprocess.run(
            [sys.executable, "-m", "gpuar_tpu.cli", *argv, "--nointeractive"],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
        assert r.returncode != 0
        assert "--host" in r.stderr and "no GPU" in r.stderr
    assert not (tmp_path / "x.gip").exists()


def test_build_tag_keys_on_flags_and_toolchain(tmp_path, monkeypatch):
    """A library's tag covers its sources, its command line and, for
    -march=native builds, the host ISA: a build from another machine or
    another flag set is never picked up."""
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    src = tmp_path / "k.cc"
    src.write_text('extern "C" int k() { return 7; }\n')
    base = ["g++", "-O1", "-fPIC", "-shared"]
    a = native.build_library("k", [src], base)
    assert native.build_library("k", [src], base) == a  # cache hit
    b = native.build_library("k", [src], [*base, "-march=native"])
    assert a != b
    isa = native._toolchain_identity("g++", True)
    assert b"__x86_64__" in isa or b"__aarch64__" in isa
    assert isa != native._toolchain_identity("g++", False)
    src.write_text('extern "C" int k() { return 8; }\n')
    assert native.build_library("k", [src], base) != a
