"""CLI verb `v`: archive integrity verification (an extension — the
reference offers only the manual md5 procedure, README.md:24-29).

Structural checks ride the container walk; --deep decodes each packet on
the host codec and applies the device decode's bitstream-overrun rule
(coder_op.check_debug_flags; native tg_decode_packet_delta)."""

import numpy as np
import pytest

from gpuar_tpu import cli, container, native
from gpuar_tpu.config import UNCOMPRESSED_PACKET_SIZE as P
from gpuar_tpu.pipeline import HostCompressor, verify_archive
from gpuar_tpu.utils.stats import ProgressMonitor


@pytest.fixture
def archive(tmp_path, rng):
    src = tmp_path / "in.bin"
    src.write_bytes(rng.integers(0, 256, 3 * P + 123, np.uint8).tobytes())
    out = tmp_path / "c.gip"
    HostCompressor().compress(str(src), str(out),
                              ProgressMonitor(enabled=False))
    return out


def test_verify_clean(archive):
    for deep in (False, True):
        r = verify_archive(archive, deep=deep)
        assert r["valid"] and r["packets"] == 4
        assert r["uncompressed_size"] == 3 * P + 123
        assert r["deep"] is deep


def test_verify_empty_archive(tmp_path):
    out = tmp_path / "e.gip"
    (tmp_path / "empty").write_bytes(b"")
    HostCompressor().compress(str(tmp_path / "empty"), str(out),
                              ProgressMonitor(enabled=False))
    r = verify_archive(out, deep=True)
    assert r["packets"] == 0 and r["uncompressed_size"] == 0


def test_verify_deep_catches_overrun(archive):
    # Deterministic corruption: cut packet 1's bitstream to 100 body
    # bytes but keep its raw size — framing stays self-consistent (the
    # structural walk passes), while decoding a full 8192-symbol packet
    # from a ~100-byte stream must read far past the framed length.
    blob = bytearray(archive.read_bytes())
    off = container.HEADER_LENGTH
    total0, _ = container.packet_sizes(bytes(blob[off:off + 4]))
    off1 = off + total0
    total1, raw1 = container.packet_sizes(bytes(blob[off1:off1 + 4]))
    assert raw1 == P and total1 > 104
    cut = bytearray(blob[off1:off1 + 104])
    cut[0], cut[1] = 104 & 0xFF, 104 >> 8
    blob[off1:off1 + total1] = cut
    hdr = container.FileHeader(
        uncompressed_size=3 * P + 123,
        compressed_size=len(blob))
    blob[:container.HEADER_LENGTH] = hdr.to_bytes()
    archive.write_bytes(bytes(blob))
    # Structural walk still passes (framing intact) ...
    assert verify_archive(archive)["valid"]
    # ... deep decode flags the overrun, naming the packet.
    with pytest.raises(container.ContainerError, match="packet 1"):
        verify_archive(archive, deep=True)


def test_verify_truncated(archive):
    archive.write_bytes(archive.read_bytes()[:-10])
    with pytest.raises(container.ContainerError, match="compressed size"):
        verify_archive(archive)


def test_verify_raw_sum_mismatch(archive):
    blob = bytearray(archive.read_bytes())
    # Shrink the final (short) packet's raw field: sum no longer matches
    # the file header.
    off = container.HEADER_LENGTH
    for _ in range(3):
        total, _ = container.packet_sizes(bytes(blob[off:off + 4]))
        off += total
    blob[off + 2] -= 1
    archive.write_bytes(bytes(blob))
    with pytest.raises(container.ContainerError, match="header says"):
        verify_archive(archive)


def test_verify_mid_stream_short_packet(tmp_path):
    # Hand-build: short packet FIRST, full packet second — invalid.
    short = native.encode_packet(b"x" * 100)
    full = native.encode_packet(bytes(range(256)) * 32)
    body = short + full
    hdr = container.FileHeader(
        uncompressed_size=100 + P,
        compressed_size=container.HEADER_LENGTH + len(body))
    bad = tmp_path / "bad.gip"
    bad.write_bytes(hdr.to_bytes() + body)
    with pytest.raises(container.ContainerError, match="short packet"):
        verify_archive(bad)


def test_cli_verify_exit_codes(archive, capsys):
    assert cli.main(["v", f"--in={archive}"]) == 0
    assert "OK" in capsys.readouterr().out
    assert cli.main(["v", f"--in={archive}", "--deep", "--json"]) == 0
    out = capsys.readouterr().out
    assert '"valid": true' in out and '"deep": true' in out
    archive.write_bytes(archive.read_bytes()[:100])
    assert cli.main(["v", f"--in={archive}"]) == 1


def test_cli_deep_requires_verify_mode(archive):
    with pytest.raises(SystemExit):
        cli.main(["c", f"--in={archive}", "--deep"])


def test_native_delta_clean_slack(rng):
    """Clean packets across corpus classes stay within the 16-bit
    lookahead slack the overrun rule allows."""
    cases = [rng.integers(0, 256, P, np.uint8).tobytes(),
             bytes(P), (b"the quick brown fox " * 410)[:P],
             rng.integers(0, 4, P, np.uint8).astype(np.uint8).tobytes()]
    for data in cases:
        pkt = native.encode_packet(data)
        out, delta = native.decode_packet_delta(pkt)
        assert out == data
        assert delta <= 16, f"clean slack {delta} exceeds the allowance"


def test_verify_deep_threaded_matches_serial(archive):
    r1 = verify_archive(archive, deep=True, threads=1)
    r3 = verify_archive(archive, deep=True, threads=3)
    assert r1 == r3


def test_verify_deep_threaded_catches_overrun(archive):
    blob = bytearray(archive.read_bytes())
    off = container.HEADER_LENGTH
    total0, _ = container.packet_sizes(bytes(blob[off:off + 4]))
    off1 = off + total0
    total1, raw1 = container.packet_sizes(bytes(blob[off1:off1 + 4]))
    cut = bytearray(blob[off1:off1 + 104])
    cut[0], cut[1] = 104 & 0xFF, 104 >> 8
    blob[off1:off1 + total1] = cut
    hdr = container.FileHeader(
        uncompressed_size=3 * P + 123, compressed_size=len(blob))
    blob[:container.HEADER_LENGTH] = hdr.to_bytes()
    archive.write_bytes(bytes(blob))
    with pytest.raises(container.ContainerError, match="packet 1"):
        verify_archive(archive, deep=True, threads=4)


def test_verify_reference_written_fixture():
    """The verify verb must accept archives written by the COMPILED
    reference coder: uninitialised reserved header bytes (0xCD garbage)
    and u32 size fields (the from_bytes fallback path)."""
    import pathlib
    fix = pathlib.Path(__file__).parent / "fixtures" / "reference_written.gip"
    r = verify_archive(fix, deep=True)
    assert r["valid"] and r["packets"] >= 1
