"""Cross-validation against the ACTUAL reference codec.

Everything else in this suite proves the four rebuilt codec tiers agree
with each other; these tests prove they agree with the real GPUAR
bitstream, by compiling the reference's own __host__ path
(/root/reference/src/gpuar_kernel.cu:487-531,848-892) with g++ and a
CUDA-qualifier stub (gpuar_tpu/native/reference_oracle.py) and asserting
byte-for-byte equality both ways.  A frozen reference-written .gip
fixture (committed) keeps the interop check alive even where the
reference tree is absent.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

from gpuar_tpu import native
from gpuar_tpu.config import UNCOMPRESSED_PACKET_SIZE as P
from gpuar_tpu.native import reference_oracle as ro
from gpuar_tpu.pipeline import HostCompressor

from benchmarks.corpora import adversarial_underflow_packet as \
    _adversarial_underflow_packet

FIXTURE = Path(__file__).parent / "fixtures" / "reference_written.gip"

needs_reference = pytest.mark.skipif(
    not ro.available(), reason="reference tree not present"
)


def _fixture_data() -> bytes:
    """Deterministic 2.5-packet mixed corpus for the frozen fixture."""
    rng = np.random.default_rng(0x61F0)
    parts = [
        rng.integers(0, 256, P, np.uint8).tobytes(),
        (b"reference interop fixture / the quick brown fox " * 200)[:P],
        bytes(P // 2),
    ]
    return b"".join(parts)


@needs_reference
def test_encode_bit_parity_with_reference(rng):
    """native/golden.cpp must emit the reference's exact bytes — header
    and bitstream — for every size and content class."""
    cases = [
        rng.integers(0, 256, n, np.uint8).tobytes()
        for n in (1, 2, 15, 16, 17, 100, 4096, P - 1, P)
    ]
    cases += [
        bytes(P),                                    # zeros
        bytes([255]) * P,                            # all 0xFF
        (b"the quick brown fox jumps " * 400)[:P],   # text
        rng.integers(126, 130, P, np.uint8).tobytes(),  # underflow-heavy
        _adversarial_underflow_packet().tobytes(),   # >96-bit underflow run
    ]
    for data in cases:
        assert ro.encode_packet(data) == native.encode_packet(data)


@needs_reference
def test_empty_packet_encode_parity():
    # Encode of an empty packet matches; the REFERENCE decoder divides by
    # zero on raw-size-0 packets (its pipelines never emit one — an empty
    # file is a header-only .gip), so only the encode side is compared.
    assert ro.encode_packet(b"") == native.encode_packet(b"")


@needs_reference
def test_decode_cross_compatibility(rng):
    """The reference decodes our packets; we decode the reference's."""
    for data in (
        rng.integers(0, 256, P, np.uint8).tobytes(),
        rng.integers(0, 256, 137, np.uint8).tobytes(),
        (b"interop " * 1024)[:P],
        bytes(P),
    ):
        ours = native.encode_packet(data)
        theirs = ro.encode_packet(data)
        assert ro.decode_packet(ours) == data
        assert native.decode_packet(theirs) == data


@needs_reference
def test_reference_written_gip_header_fallback(tmp_path):
    """A .gip with the reference writer's uninitialised header bytes
    (0xCD garbage in the reserved slots, src/file_header.hpp:28-72) must
    decompress through the container's u32 fallback (container.py:62-70).
    """
    data = _fixture_data()
    gip = tmp_path / "ref.gip"
    gip.write_bytes(ro.make_reference_gip(data))
    out = tmp_path / "back.bin"
    HostCompressor().decompress(gip, out)
    assert out.read_bytes() == data


@needs_reference
def test_frozen_fixture_is_current():
    """The committed fixture must be exactly what the reference writes
    today (guards against fixture rot)."""
    assert FIXTURE.read_bytes() == ro.make_reference_gip(_fixture_data())


def test_frozen_fixture_roundtrip(tmp_path):
    """Interop with a reference-written archive, no reference required:
    the committed fixture (generated by the compiled reference codec,
    see test_frozen_fixture_is_current) must decompress bit-exactly."""
    raw = FIXTURE.read_bytes()
    assert hashlib.sha256(raw).hexdigest() == FIXTURE.with_suffix(
        ".gip.sha256").read_text().strip()
    out = tmp_path / "back.bin"
    HostCompressor().decompress(FIXTURE, out)
    assert out.read_bytes() == _fixture_data()


@needs_reference
def test_differential_fuzz_skewed_distributions(rng):
    """Differential fuzz vs the compiled reference: skewed Dirichlet
    alphabets, constants, and straddle-heavy alternations exercise the
    host codec's closed-form renorm (settled-run/straddle-run counts,
    64-bit bit I/O, magic division) across packet-size edges.  A larger
    400-case sweep ran clean at adoption time (benchmarks/PROBES_r3.md,
    host-codec sections)."""
    cases = []
    for _ in range(24):
        conc = 10.0 ** -rng.uniform(0, 2)
        p = rng.dirichlet(np.full(256, conc))
        n = int(rng.choice([1, 17, 4096, P - 1, P]))
        cases.append(rng.choice(256, n, p=p).astype(np.uint8).tobytes())
    for v in (0, 127, 255):
        cases.append(bytes([v]) * P)
    for pat in ((127, 128), (0, 255)):
        cases.append(bytes(pat) * (P // 2))
    for data in cases:
        ours = native.encode_packet(data)
        assert ours == ro.encode_packet(data)
        assert native.decode_packet(ours) == data
