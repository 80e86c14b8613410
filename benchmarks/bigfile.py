"""The >=4 GiB container proof (round-2 VERDICT item 5).

The reference's u32 header fields cap files at 4 GiB
(/root/reference/src/file_header.hpp:61-72); this container writes the
full 8-byte size slots the layout reserves.  That claim was only
unit-tested until now — this harness drives a RANDOM >4 GiB file (so the
COMPRESSED size also crosses 4 GiB, exercising both u64 fields) through
the real pipeline end-to-end:

    compress (interrupted mid-run) -> --resume -> decompress -> md5

and records a JSON artifact.  Random data also stresses the super-batch
bookkeeping at >2**32 byte offsets and the resume walk over >4 GiB of
packets.

Usage: python benchmarks/bigfile.py [--gib 4.6] [--backend device|host]
                                    [--json benchmarks/bigfile_results.json]
"""

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def md5(path):
    h = hashlib.md5()
    with open(path, "rb") as f:
        while blk := f.read(1 << 24):
            h.update(blk)
    return h.hexdigest()


def write_random(path, size):
    rng = np.random.default_rng(0xB16F11E)
    with open(path, "wb") as f:
        left = size
        while left > 0:
            n = int(min(left, 256 << 20))
            f.write(rng.integers(0, 256, n, np.uint8).tobytes())
            left -= n


def cli(args_list, **kw):
    return subprocess.run(
        [sys.executable, "-m", "gpuar_tpu.cli", *args_list],
        cwd=REPO, **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=4.6)
    ap.add_argument("--backend", choices=["device", "host"], default="device")
    ap.add_argument("--json", default=None)
    ap.add_argument("--tmp", default=None,
                    help="working dir (needs ~3x the file size)")
    args = ap.parse_args()

    size = int(args.gib * (1 << 30)) + 12345  # odd tail: partial packet
    extra = ["--host"] if args.backend == "host" else []
    res = {"bytes": size, "backend": args.backend}

    with tempfile.TemporaryDirectory(dir=args.tmp) as td:
        src = os.path.join(td, "in.bin")
        gip = os.path.join(td, "c.gip")
        back = os.path.join(td, "back.bin")
        t0 = time.time()
        write_random(src, size)
        res["md5"] = md5(src)
        print(f"corpus ready ({time.time() - t0:.0f}s)", flush=True)

        # 1. Start compressing, kill mid-run (SIGKILL: no cleanup).
        t0 = time.time()
        p = subprocess.Popen(
            [sys.executable, "-m", "gpuar_tpu.cli", "c", f"--in={src}",
             f"--out={gip}", "--nointeractive", *extra], cwd=REPO)
        # Wait until a meaningful prefix exists, then kill.
        while time.time() - t0 < 3600:
            time.sleep(5)
            if os.path.exists(gip) and os.path.getsize(gip) > (1 << 30):
                break
            if p.poll() is not None:
                raise RuntimeError("compressor finished before the kill — "
                                   "grow --gib or tighten the threshold")
        p.send_signal(signal.SIGKILL)
        p.wait()
        res["interrupted_at_bytes"] = os.path.getsize(gip)
        print(f"interrupted with {res['interrupted_at_bytes']} bytes "
              f"written ({time.time() - t0:.0f}s)", flush=True)

        # 2. Resume to completion.
        t0 = time.time()
        r = cli(["c", f"--in={src}", f"--out={gip}", "--resume",
                 "--nointeractive", "--json", *extra],
                capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-2000:]
        res["resume_stats"] = json.loads(r.stdout.strip().splitlines()[-1])
        res["compressed_bytes"] = os.path.getsize(gip)
        print(f"resumed to completion ({time.time() - t0:.0f}s): "
              f"{res['compressed_bytes']} compressed bytes", flush=True)
        assert res["compressed_bytes"] > (1 << 32), \
            "compressed size must cross 4 GiB for the u64 field proof"
        os.unlink(src)  # bound disk usage; md5 is recorded

        # 3. Decompress and verify.
        t0 = time.time()
        r = cli(["d", f"--in={gip}", f"--out={back}", "--nointeractive",
                 "--json", *extra], capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-2000:]
        res["decompress_stats"] = json.loads(
            r.stdout.strip().splitlines()[-1])
        os.unlink(gip)
        res["md5_back"] = md5(back)
        res["match"] = res["md5_back"] == res["md5"]
        print(f"decompressed ({time.time() - t0:.0f}s); md5 match: "
              f"{res['match']}", flush=True)
        assert res["match"], "round-trip mismatch"

    print(json.dumps(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
