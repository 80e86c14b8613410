"""Randomized end-to-end soak: random file sizes and content mixes through
the real compressor backends, cross-checked between the device and host
paths.

The first iteration after the size-edge cases embeds an
adversarial-underflow packet (a ~133-bit pending run) in the corpus, so
every soak codes that stream on the device.

Usage: python benchmarks/soak.py [--iters 8] [--host-only] [--json OUT]
"""
import argparse
import hashlib
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_corpus(rng, size):
    parts = []
    left = size
    while left > 0:
        n = int(min(left, rng.integers(1, 1 << 22)))
        kind = rng.integers(0, 5)
        if kind == 0:
            parts.append(rng.integers(0, 256, n, np.uint8).tobytes())
        elif kind == 1:
            parts.append(bytes(n))
        elif kind == 2:
            parts.append((b"The quick brown fox jumps over the lazy dog. "
                          * (n // 46 + 1))[:n])
        elif kind == 3:
            parts.append(rng.integers(0, 4, n, np.uint8).tobytes())
        else:
            parts.append(bytes([int(rng.integers(0, 256))]) * n)
        left -= n
    return b"".join(parts)


def md5(path):
    h = hashlib.md5()
    with open(path, "rb") as f:
        while blk := f.read(1 << 22):
            h.update(blk)
    return h.hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--host-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0xF00D)
    ap.add_argument("--json", default=None,
                    help="write a run summary here")
    args = ap.parse_args()

    from gpuar_tpu.pipeline import HostCompressor

    host = HostCompressor()
    dev = None
    if not args.host_only:
        from gpuar_tpu.parallel.runner import TPUCompressor

        dev = TPUCompressor()

    rng = np.random.default_rng(args.seed)
    edge_sizes = [0, 1, 8191, 8192, 8193, 16 * 8192, 8192 * 1024 + 5]
    summary = []
    for it in range(args.iters):
        if it < len(edge_sizes):
            size = edge_sizes[it]
        else:
            size = int(rng.integers(0, 48 << 20))
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, "in.bin")
            with open(src, "wb") as f:
                blob = make_corpus(rng, size)
                if it == len(edge_sizes):
                    # Embed the adversarial-underflow packet.
                    from benchmarks.corpora import \
                        adversarial_underflow_packet
                    adv = adversarial_underflow_packet().tobytes()
                    blob = adv + blob[len(adv):] if len(blob) >= len(adv) \
                        else adv
                f.write(blob)
            ref = md5(src)

            gh = os.path.join(td, "h.gip")
            host.compress(src, gh)
            out = os.path.join(td, "h.out")
            host.decompress(gh, out)
            assert md5(out) == ref, f"iter {it}: host round-trip"

            if dev is not None:
                gt = os.path.join(td, "t.gip")
                dev.compress(src, gt)
                assert md5(gt) == md5(gh), \
                    f"iter {it}: device/host .gip mismatch"
                out2 = os.path.join(td, "t.out")
                dev.decompress(gh, out2)
                assert md5(out2) == ref, \
                    f"iter {it}: device decode of host file"
            print(f"iter {it}: {size} bytes OK", flush=True)
            summary.append({"iter": it, "bytes": size, "ok": True})
    # --debug decode on the device: a clean archive must pass the debug
    # decode, and an archive with
    # one corrupt-but-well-framed packet must raise ContainerError (the
    # reference's -D_DEBUG parity; release mode decodes silent garbage).
    debug_result = None
    if dev is not None:
        from gpuar_tpu import container
        from gpuar_tpu.parallel.runner import TPUCompressor

        dev_dbg = TPUCompressor(debug=True)
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, "in.bin")
            with open(src, "wb") as f:
                f.write(bytes(64 * 8192))  # compressible: tiny bitstreams
            gip = os.path.join(td, "c.gip")
            host.compress(src, gip)
            out = os.path.join(td, "clean.out")
            dev_dbg.decompress(gip, out)
            clean_ok = md5(out) == md5(src)

            # Corrupt packet 2's bitstream body (framing intact): noise
            # decodes at ~8 bits/symbol, far past the tiny frame ->
            # deterministic overrun.
            blob = bytearray(open(gip, "rb").read())
            pos = 20
            for _ in range(2):
                pos += blob[pos] | (blob[pos + 1] << 8)
            total = blob[pos] | (blob[pos + 1] << 8)
            body = rng.integers(0, 256, total - 4, np.uint8).tobytes()
            blob[pos + 4: pos + total] = body
            bad = os.path.join(td, "bad.gip")
            open(bad, "wb").write(bytes(blob))
            try:
                dev_dbg.decompress(bad, os.path.join(td, "bad.out"))
                corrupt_raised = False
            except container.ContainerError as e:
                corrupt_raised = True
                print(f"debug decode flagged corrupt packet: {e}",
                      flush=True)
            # Release-mode parity: the same archive decodes (to garbage)
            # without --debug, like the reference.
            dev.decompress(bad, os.path.join(td, "rel.out"))
            debug_result = {"clean_ok": bool(clean_ok),
                            "corrupt_raised": bool(corrupt_raised),
                            "release_decodes_garbage": True}
            assert clean_ok and corrupt_raised, debug_result
            print("debug decode on the device: clean passes, corrupt raises",
                  flush=True)

    print("soak PASSED")
    if args.json:
        import json
        with open(args.json, "w") as f:
            json.dump({"iters": summary, "debug_decode": debug_result,
                       "backend": "host-only" if dev is None else
                       "device+host"}, f, indent=1)


if __name__ == "__main__":
    main()
