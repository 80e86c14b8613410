"""Smoke run of the codec on one GPU: the quickest proof that the system
still starts on the card, and that what it writes is right.

    python chip_smoke.py              # one card: phases 1-4
    python chip_smoke.py --chips 4    # four cards: phases 1, 2 and 5

Everything runs in this one process, which holds the card; the CLI is
called in-process through ``gpuar_tpu.cli.main``.  Phases:

  1. device: platform, kind, count, SM count, JAX version, the card's
     name and power limit; the platform must be ``gpu``;
  2. build the CUDA coder library and compile encode, decode and the
     debug decode for 8192-byte packets at the device-sized batch;
  3. kernel parity: one device-sized batch of mixed content, every packet
     bit-exact against the native golden codec, and decoded back;
  4. the CLI end to end on a >= 1 GiB mixed file: the device archive is
     byte-identical to the ``--host`` archive, both decode md5-exact on
     the GPU, and ``d --debug`` rejects a copy with one corrupt packet;
  5. (``--chips 4``, instead of 3 and 4) the same file over all local
     cards, byte-identical to the one-card archive, md5-exact back.

Any failed phase exits non-zero.  The last line of standard output is
the JSON object ``{"ok": true, "device": {...}}``.  Times printed here
are from a smoke run, not measurements.

``--cpu-rehearsal`` runs the phases on a CPU backend selected with
JAX_PLATFORMS=cpu, at the size ``--mib`` gives, and prints no device
result.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

P = 8192


def say(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def md5(path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while blk := f.read(16 << 20):
            h.update(blk)
    return h.hexdigest()


def cli(*argv) -> tuple[int, str, str]:
    """gpuar_tpu.cli.main in this process -> (exit code, stdout, stderr)."""
    from gpuar_tpu import cli as cli_mod

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli_mod.main([*argv, "--nointeractive"])
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
            if not isinstance(e.code, int):
                print(e.code, file=sys.stderr)
    return rc, out.getvalue(), err.getvalue()


def cli_ok(label: str, *argv) -> float:
    t0 = time.perf_counter()
    rc, out, err = cli(*argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        fail(f"{label}: exit {rc}\n{out[-2000:]}{err[-2000:]}")
    return dt


def phase_device(args):
    import jax

    devices = jax.devices()
    dev = devices[0]
    say(f"[1] jax {jax.__version__}: platform={dev.platform} "
        f"kind={dev.device_kind!r} count={len(devices)}")
    if dev.platform != "gpu":
        if not (args.cpu_rehearsal and dev.platform == "cpu"):
            fail(f"no GPU: JAX's backend is {dev.platform!r}")
    if len(devices) < args.chips:
        fail(f"--chips {args.chips} but JAX sees {len(devices)} devices")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        if not args.cpu_rehearsal:
            fail(f"nvidia-smi: {e}")
        smi = "nvidia-smi not available (CPU rehearsal)\n"
    for line in smi.strip().splitlines():
        say(f"[1] card: {line.strip()}")
    return devices


def phase_compile(dev, rehearsal: bool):
    import jax
    import jax.numpy as jnp

    from gpuar_tpu import native
    from gpuar_tpu.ops import coder_op

    t0 = time.perf_counter()
    native.coder_library(dev.platform)
    say(f"[2] coder library ready in {time.perf_counter() - t0:.1f} s "
        "(build or cache hit; set-up)")
    batch = coder_op.packets_per_launch(dev)
    if dev.platform == "gpu":
        sm, per_sm = native.cuda_device_geometry(dev.local_hardware_id)
        say(f"[2] SMs={sm} (jax core_count="
            f"{getattr(dev, 'core_count', 'n/a')}), packets/SM={per_sm}, "
            f"packets per launch={batch}")
    if rehearsal:
        batch = 512
    i32 = jnp.int32
    raw = jax.ShapeDtypeStruct((batch, P // 4), i32)
    rows = jax.ShapeDtypeStruct((batch, coder_op.out_words(P)), i32)
    sizes = jax.ShapeDtypeStruct((1, batch), i32)
    fns = {
        "encode": (partial(coder_op.encode, packet_size=P), raw),
        "decode": (partial(coder_op.decode, packet_size=P), rows),
        "decode_debug": (partial(coder_op.decode, packet_size=P,
                                 debug=True), rows),
    }
    compiled = {}
    for name, (fn, arg) in fns.items():
        t0 = time.perf_counter()
        compiled[name] = jax.jit(fn).lower(arg, sizes).compile()
        say(f"[2] {name} compiled for {batch} x {P} B in "
            f"{time.perf_counter() - t0:.1f} s: "
            f"{compiled[name].memory_analysis()}")
    return compiled, batch


def phase_parity(compiled, batch: int, mixer):
    import jax.numpy as jnp
    import numpy as np

    from gpuar_tpu import native
    from gpuar_tpu.ops import coder_op
    from gpuar_tpu.pipeline import HostCompressor

    data, sizes = mixer.packets(batch)
    words = jnp.asarray(data.view(np.int32))
    sz = jnp.asarray(sizes[None])
    t0 = time.perf_counter()
    rows, lens = compiled["encode"](words, sz)
    rows.block_until_ready()
    t_enc = time.perf_counter() - t0
    rows_h = np.asarray(rows).view(np.uint8)
    lens_h = np.asarray(lens)[0]
    coder_op.check_lengths(lens_h, rows_h.shape[1])

    raw = np.concatenate([data[:-1].reshape(-1), data[-1, :sizes[-1]]])
    host = HostCompressor(threads=os.cpu_count() or 1)
    t0 = time.perf_counter()
    host_pk, host_len = host.encode_batch(raw)
    t_host = time.perf_counter() - t0
    if not np.array_equal(host_len, lens_h):
        bad = np.nonzero(host_len != lens_h)[0]
        fail(f"[3] lengths differ from the golden codec at packets "
             f"{bad[:8].tolist()}")
    if native.splice(rows_h, lens_h).tobytes() != \
            native.splice(host_pk, host_len).tobytes():
        fail("[3] packet bytes differ from the golden codec")
    say(f"[3] encode parity: {batch} packets bit-exact against the golden "
        f"codec (device call {t_enc:.3f} s, host {host.threads} threads "
        f"{t_host:.1f} s; smoke timings, not measurements); ratio "
        f"{lens_h.sum() / sizes.sum():.4f}, adversarial packet "
        f"{lens_h[0]} B")

    back = np.asarray(compiled["decode"](rows, sz)).view(np.uint8)
    if not np.array_equal(back, data):
        fail("[3] device decode differs from the input")
    back, flags = compiled["decode_debug"](rows, sz)
    if not np.array_equal(np.asarray(back).view(np.uint8), data):
        fail("[3] device debug decode differs from the input")
    coder_op.check_debug_flags(np.asarray(flags), lens_h, batch)
    slack = np.asarray(flags)[1] - lens_h.astype(np.int64) * 8
    say(f"[3] decode and debug decode round-trip {batch} packets "
        f"byte-exact; bit-cursor slack {slack.min()}..{slack.max()} bits")


def _corrupt_copy(gip: Path, bad: Path, rng) -> int:
    """Copy ``gip`` with the body of its most compressible packet replaced
    by noise, framing intact; returns that packet's index."""
    import numpy as np

    from gpuar_tpu import container
    from gpuar_tpu.parallel import distributed

    shutil.copyfile(gip, bad)
    with open(bad, "r+b") as f:
        size = os.path.getsize(bad)
        index = distributed.walk_packet_index(
            distributed._BodyView(f, container.HEADER_LENGTH),
            size - container.HEADER_LENGTH)
        lens = np.diff(index[0])
        k = int(np.argmin(lens))
        f.seek(container.HEADER_LENGTH + int(index[0][k]) + 4)
        f.write(rng.integers(0, 256, int(lens[k]) - 4, np.uint8).tobytes())
    return k


def phase_cli(mixer, size: int, work: Path):
    import numpy as np

    src, gip, hgip = work / "in.bin", work / "dev.gip", work / "host.gip"
    t0 = time.perf_counter()
    mixer.write_file(src, size, segment=min(8 << 20, size // 8))
    say(f"[4] wrote {size} B mixed file in {time.perf_counter() - t0:.1f} s")
    ref = md5(src)
    t_c = cli_ok("device compress", "c", f"--in={src}", f"--out={gip}")
    t_h = cli_ok("host compress", "c", f"--in={src}", f"--out={hgip}",
                 "--host", "--threads=0")
    if md5(gip) != md5(hgip) or gip.stat().st_size != hgip.stat().st_size:
        fail("[4] the device archive differs from the --host archive")
    say(f"[4] c: device archive ({gip.stat().st_size} B) byte-identical to "
        f"the --host archive; wall {t_c:.1f} s device, {t_h:.1f} s host "
        "(smoke run, not a measurement)")
    back = work / "back.bin"
    t_d = cli_ok("device decompress", "d", f"--in={gip}", f"--out={back}")
    if md5(back) != ref:
        fail("[4] device round trip is not md5-exact")
    back.unlink()
    t_d2 = cli_ok("device decompress of the host archive", "d",
                  f"--in={hgip}", f"--out={back}")
    if md5(back) != ref:
        fail("[4] the --host archive does not decode md5-exact on the GPU")
    back.unlink()
    say(f"[4] d: md5-exact ({ref}); host-written archive decoded on the "
        f"device md5-exact; wall {t_d:.1f} s and {t_d2:.1f} s (smoke run)")
    bad = work / "bad.gip"
    k = _corrupt_copy(gip, bad, np.random.default_rng(7))
    hgip.unlink()
    rc, out, err = cli("d", "--debug", f"--in={bad}", f"--out={back}")
    if rc == 0 or "Corrupt packet" not in err:
        fail(f"[4] d --debug did not reject corrupt packet {k}: exit {rc}, "
             f"{err[-500:]!r}")
    say(f"[4] d --debug on a copy with corrupt packet {k}: exit {rc}, "
        f"{err.strip().splitlines()[-1]}")
    return src


def phase_cards(mixer, size: int, work: Path, count: int):
    src, one, many = work / "in.bin", work / "one.gip", work / "all.gip"
    mixer.write_file(src, size, segment=min(8 << 20, size // 8))
    ref = md5(src)
    t1 = cli_ok("one-card compress", "c", f"--in={src}", f"--out={one}",
                "--device=0")
    tn = cli_ok(f"{count}-card compress", "c", f"--in={src}",
                f"--out={many}")
    if md5(one) != md5(many):
        fail(f"[5] the {count}-card archive differs from the one-card one")
    back = work / "back.bin"
    td = cli_ok(f"{count}-card decompress", "d", f"--in={many}",
                f"--out={back}")
    if md5(back) != ref:
        fail(f"[5] {count}-card round trip is not md5-exact")
    say(f"[5] {size} B over {count} cards: archive byte-identical to the "
        f"one-card archive, round trip md5-exact; wall c {tn:.1f} s "
        f"({count} cards) vs {t1:.1f} s (one card), d {td:.1f} s "
        "(smoke run, not a measurement)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run the path across all local cards (phase 5)")
    ap.add_argument("--mib", type=int, default=1024,
                    help="size of the end-to-end file in MiB (>= 1024 on "
                         "the card; a tail of 4321 B is added)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="rehearse on a CPU backend (JAX_PLATFORMS=cpu)")
    args = ap.parse_args()
    if args.mib < 1024 and not args.cpu_rehearsal:
        ap.error("--mib below 1024 is for --cpu-rehearsal only")

    from benchmarks.corpora import Mixer

    devices = phase_device(args)
    compiled, batch = phase_compile(devices[0], args.cpu_rehearsal)
    mixer = Mixer(seed=0x5A0C,
                  text_block=(1 << 20) if args.cpu_rehearsal else 8 << 20)
    size = (args.mib << 20) + 4321
    # Work files live in the checkout (.gitignore lists the prefix).
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        if args.chips == 1:
            phase_parity(compiled, batch, mixer)
            phase_cli(mixer, size, Path(tmp))
        else:
            phase_cards(mixer, size, Path(tmp), args.chips)
    dev = devices[0]
    result = {"ok": True, "device": {"platform": dev.platform,
                                     "kind": dev.device_kind,
                                     "count": len(devices)}}
    if args.cpu_rehearsal:
        say(f"rehearsal OK on {dev.platform} (not a device result): "
            f"{json.dumps(result)}")
        return 0
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
