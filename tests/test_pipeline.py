"""Streaming pipeline behaviour: multi-super-batch files, CLI error paths."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gpuar_tpu import container
from gpuar_tpu.config import UNCOMPRESSED_PACKET_SIZE as P
from gpuar_tpu.pipeline import HostCompressor


def test_multi_super_batch_streaming(tmp_path, rng):
    """A super-batch smaller than the file forces several fill/drain rounds
    (the reference's do/while loop, src/gpu_compressor.cpp:124); the output
    must equal the single-batch file byte for byte."""
    data = rng.integers(0, 256, 7 * P + 321, np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)

    small = tmp_path / "small.gip"
    HostCompressor(super_batch_packets=2).compress(src, small)
    big = tmp_path / "big.gip"
    HostCompressor(super_batch_packets=1024).compress(src, big)
    assert small.read_bytes() == big.read_bytes()

    back = tmp_path / "back.bin"
    HostCompressor(super_batch_packets=3).decompress(small, back)
    assert back.read_bytes() == data


def _cli(args, cwd, platforms="cpu"):
    # Run the CLI subprocess on the CPU backend selected on purpose (the
    # device path then runs the CPU build of the coder op).  Everything
    # under test here (flag parsing, container errors, backend policy) is
    # backend-independent.
    env = dict(os.environ, JAX_PLATFORMS=platforms)
    return subprocess.run(
        [sys.executable, "-m", "gpuar_tpu.cli", *args],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=600,
    )


def test_packet_reader_block_boundaries(rng):
    """_PacketReader must parse packets that straddle its block fills
    (header split across blocks, body split across blocks) identically
    to a whole-buffer parse."""
    import io

    from gpuar_tpu import pipeline

    data = rng.integers(0, 256, 40 * P + 123, np.uint8).tobytes()
    from gpuar_tpu import native

    body = native.encode_stream(data)
    # Tiny blocks force every straddle case; batch sizes force reuse of
    # the buffered remainder across read_batch calls.
    for block in (5, 64, 1000):
        reader = pipeline._PacketReader(io.BytesIO(body), block_size=block)
        got = []
        while True:
            packets, raw_sizes = reader.read_batch(3)
            if packets is None:
                break
            for row, r in zip(packets, raw_sizes):
                total = int(row[0]) | (int(row[1]) << 8)
                got.append((bytes(row[:total]), int(r)))
        whole = list(__import__("gpuar_tpu.container", fromlist=["x"])
                     .read_packets(io.BytesIO(body)))
        assert [g[0] for g in got] == whole
        assert sum(g[1] for g in got) == len(data)


def test_packet_reader_truncation_mid_block(rng):
    import io

    from gpuar_tpu import container, native, pipeline

    body = native.encode_stream(
        rng.integers(0, 256, 3 * P, np.uint8).tobytes())
    reader = pipeline._PacketReader(io.BytesIO(body[:-5]), block_size=100)
    with pytest.raises(container.ContainerError, match="truncated packet"):
        while reader.read_batch(8)[0] is not None:
            pass


def test_cli_rejects_non_gip(tmp_path, repo_root):
    bad = tmp_path / "bad.gip"
    bad.write_bytes(b"this is not a gip file at all, not even close")
    r = _cli(["d", f"--in={bad}", f"--out={tmp_path/'x.bin'}",
              "--host", "--nointeractive"], repo_root)
    assert r.returncode == 1
    assert "unsupported version" in r.stderr


def test_cli_rejects_conflicting_flags(tmp_path, repo_root):
    src = tmp_path / "in.bin"
    src.write_bytes(b"x" * 100)
    # --host with --multihost: neither silently wins.
    r = _cli(["c", f"--in={src}", f"--out={tmp_path/'x.gip'}",
              "--host", "--multihost", "--nointeractive"], repo_root)
    assert r.returncode == 2
    assert "mutually exclusive" in r.stderr
    # --resume in decompress mode is meaningless, not ignored.
    r = _cli(["d", f"--in={src}", f"--out={tmp_path/'x.bin'}",
              "--host", "--resume", "--nointeractive"], repo_root)
    assert r.returncode == 2
    assert "--resume" in r.stderr


def test_cli_missing_input(tmp_path, repo_root):
    r = _cli(["c", f"--in={tmp_path/'nope.bin'}",
              f"--out={tmp_path/'x.gip'}", "--host", "--nointeractive"],
             repo_root)
    assert r.returncode == 1


def test_cli_truncated_packet(tmp_path, repo_root, rng):
    src = tmp_path / "in.bin"
    src.write_bytes(rng.integers(0, 256, 2 * P, np.uint8).tobytes())
    gip = tmp_path / "c.gip"
    HostCompressor().compress(src, gip)
    cut = tmp_path / "cut.gip"
    cut.write_bytes(gip.read_bytes()[:1000])
    r = _cli(["d", f"--in={cut}", f"--out={tmp_path/'x.bin'}",
              "--host", "--nointeractive"], repo_root)
    assert r.returncode == 1
    assert "truncated" in r.stderr


@pytest.fixture
def repo_root():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _TracingBackend(HostCompressor):
    """Records submit/fetch interleaving to verify the overlap schedule."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.events = []
        self._n = 0

    def encode_submit(self, raw):
        self._n += 1
        self.events.append(("submit", self._n))
        return (self._n, self.encode_batch(raw))

    def encode_fetch(self, handle):
        k, result = handle
        self.events.append(("fetch", k))
        return result


def test_compress_overlaps_batches(tmp_path, rng):
    """The drive loop must submit batch N+1 before fetching batch N."""
    data = rng.integers(0, 256, 6 * P, np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    be = _TracingBackend(super_batch_packets=2)
    gip = tmp_path / "c.gip"
    be.compress(src, gip)

    assert be.events == [
        ("submit", 1), ("submit", 2), ("fetch", 1),
        ("submit", 3), ("fetch", 2), ("fetch", 3),
    ]
    # And the file is identical to the plain synchronous pipeline's.
    ref = tmp_path / "ref.gip"
    HostCompressor(super_batch_packets=2).compress(src, ref)
    assert gip.read_bytes() == ref.read_bytes()


def test_decompress_rejects_packet_boundary_truncation(tmp_path, rng):
    """A .gip cut exactly at a packet boundary reads to clean EOF; the
    header totals must catch it (review finding)."""
    src = tmp_path / "in.bin"
    src.write_bytes(rng.integers(0, 256, 3 * P, np.uint8).tobytes())
    gip = tmp_path / "c.gip"
    comp = HostCompressor()
    comp.compress(src, gip)

    # Find the second packet boundary via the container walk.
    from gpuar_tpu.parallel import distributed as dist

    blob = gip.read_bytes()
    idx = dist.walk_packet_index(
        __import__("io").BytesIO(blob[container.HEADER_LENGTH:]),
        len(blob) - container.HEADER_LENGTH)
    cut = container.HEADER_LENGTH + int(idx[0][2])  # keep 2 of 3 packets
    bad = tmp_path / "cut.gip"
    bad.write_bytes(blob[:cut])

    with pytest.raises(container.ContainerError):
        comp.decompress(bad, tmp_path / "out.bin")


def test_resume_interrupted_compression(tmp_path, rng):
    """An interrupted .gip continues from the last complete packet and
    finishes byte-identical to an uninterrupted run."""
    data = rng.integers(0, 256, 5 * P + 777, np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    comp = HostCompressor(super_batch_packets=2)

    ref = tmp_path / "ref.gip"
    comp.compress(src, ref)
    blob = ref.read_bytes()

    from gpuar_tpu.pipeline import _resume_point

    for cut_kind in ("mid_packet", "packet_boundary", "header_only"):
        part = tmp_path / "part.gip"
        if cut_kind == "mid_packet":
            part.write_bytes(blob[: len(blob) * 2 // 3])
        elif cut_kind == "packet_boundary":
            done_raw, done_comp, _ = _resume_point(ref)
            assert done_raw == 5 * P  # all full packets, not the tail
            part.write_bytes(blob[: container.HEADER_LENGTH + done_comp])
        else:
            part.write_bytes(b"\0" * container.HEADER_LENGTH)

        info = comp.compress(src, part, resume=True)
        assert part.read_bytes() == blob, cut_kind
        assert info.compressed_file_size == len(blob)

    # Resumed file must still round-trip.
    back = tmp_path / "back.bin"
    comp.decompress(ref, back)
    assert back.read_bytes() == data


def test_resume_refuses_changed_input(tmp_path, rng):
    data = rng.integers(0, 256, 3 * P, np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    comp = HostCompressor()
    gip = tmp_path / "c.gip"
    comp.compress(src, gip)
    part = tmp_path / "part.gip"
    part.write_bytes(gip.read_bytes()[:-10])  # interrupted

    # Input mutated since the interrupted run: resume must refuse.
    src.write_bytes(rng.integers(0, 256, 3 * P, np.uint8).tobytes())
    with pytest.raises(container.ContainerError, match="no longer matches"):
        comp.compress(src, part, resume=True)

    # Input shrank below the resume point: refuse too.
    src.write_bytes(data[: P // 2])
    with pytest.raises(container.ContainerError, match="more bytes"):
        comp.compress(src, part, resume=True)


def test_device_flag_validation(tmp_path, rng, repo_root):
    """--device pins a device by index; unlike the reference (which cannot
    select device 0, src/main.cpp:110-117), index 0 is valid.  An
    out-of-range index, or no GPU at all, stops the CLI with an error: it
    never falls back to the host codec by itself."""
    src = tmp_path / "in.bin"
    src.write_bytes(rng.integers(0, 256, 2 * P, np.uint8).tobytes())
    r = _cli(["c", f"--in={src}", f"--out={tmp_path/'x.gip'}",
              "--device=99", "--nointeractive"], repo_root)
    assert r.returncode == 1
    assert "no device 99" in r.stderr
    r = _cli(["c", f"--in={src}", f"--out={tmp_path/'x.gip'}",
              "--nointeractive"], repo_root, platforms="cuda,cpu")
    assert r.returncode == 1
    assert "no GPU" in r.stderr and "--host" in r.stderr
    assert not (tmp_path / "x.gip").exists()

    # Device 0 is selectable, and its archive is the host archive.
    r = _cli(["c", f"--in={src}", f"--out={tmp_path/'x.gip'}",
              "--device=0", "--nointeractive"], repo_root)
    assert r.returncode == 0, r.stderr
    ref = tmp_path / "ref.gip"
    HostCompressor().compress(src, ref)
    assert (tmp_path / "x.gip").read_bytes() == ref.read_bytes()

    from gpuar_tpu.parallel.runner import TPUCompressor

    t = TPUCompressor(device_index=0)
    assert t.codec.n_devices == 1
    with pytest.raises(ValueError):
        TPUCompressor(device_index=99)


def test_threaded_host_codec_identical(tmp_path, rng):
    """HostCompressor(threads=N) splits super-batches into contiguous
    packet ranges coded in a thread pool; packets are independent
    (per-packet model reset, src/cpu_compressor.cpp:159), so the archive
    must be byte-identical to the serial path for any thread count."""
    data = rng.integers(0, 256, 13 * P + 77, np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)

    serial = tmp_path / "serial.gip"
    HostCompressor().compress(src, serial)
    for threads in (3, 8):
        out = tmp_path / f"t{threads}.gip"
        HostCompressor(threads=threads).compress(src, out)
        assert out.read_bytes() == serial.read_bytes(), threads

    back = tmp_path / "back.bin"
    HostCompressor(threads=5, super_batch_packets=4).decompress(serial, back)
    assert back.read_bytes() == data


def test_library_api_round_trip(tmp_path, rng):
    """Top-level gpuar_tpu.compress/decompress/verify one-call API."""
    import gpuar_tpu

    src = tmp_path / "in.bin"
    data = rng.integers(0, 256, 3 * P + 100, dtype=np.uint8).tobytes()
    src.write_bytes(data)
    arc = tmp_path / "a.gip"
    back = tmp_path / "back.bin"
    info = gpuar_tpu.compress(src, arc, host=True)
    assert info.compressed_file_size == arc.stat().st_size
    report = gpuar_tpu.verify(arc, deep=True, threads=2)
    assert report["valid"] and report["packets"] == 4
    gpuar_tpu.decompress(arc, back, host=True)
    assert back.read_bytes() == data


def test_library_host_fallback_warns(monkeypatch):
    """Without a GPU the library API must not silently hand back host
    coding: _pick_backend raises NoGPUError naming host=True, for plain
    and debug decodes alike; host=True still works."""
    import gpuar_tpu
    import gpuar_tpu.parallel.runner as runner

    monkeypatch.setattr(runner, "_cpu_on_purpose", lambda: False)
    for debug in (False, True):
        with pytest.raises(runner.NoGPUError, match="host=True"):
            gpuar_tpu._pick_backend(host=False, threads=1, debug=debug)
    backend = gpuar_tpu._pick_backend(host=True, threads=1)
    assert type(backend).__name__ == "HostCompressor"
