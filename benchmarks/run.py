"""Benchmark harness: the SURVEY.md §6 table, measured on one GPU.

Runs the coder op (no file I/O in the timed region) over the seeded
corpora of benchmarks/corpora.py, one batch of ``--mib`` MiB each:

  * random      — uniform random bytes (the reference's README corpus;
    incompressible, ratio ~1.008 from framing);
  * enwik-proxy — deterministic, hash-pinned MediaWiki-XML-shaped text
    (benchmarks/enwik_proxy.py; ratio numbers stay comparable across runs
    because the corpus cannot drift);
  * utf8-text   — its high-byte UTF-8 variant;
  * zeros       — degenerate best case (underflow-run heavy).

For each corpus: encode and decode GB/s through bench.py's timer (the
fastest of bench.REPS calls), compression ratio, golden-codec cross-check
on sample packets and a bit-exact round trip.  Packets are entropy-sorted
first, as the pipeline sorts each batch.  Two final rows measure the FULL
FILE PIPELINE (TPUCompressor.compress / .decompress on a real file:
packetize, sort, device codec, compaction, splice, file I/O) with the
reference-style process/IO split (src/main.cpp:176-182), single runs.

Every row names the device and the card's power limit.  Prints a markdown
table and writes benchmarks/<--out> (gitignored).  Fails (exit 2) without
a GPU.

Usage: python benchmarks/run.py [--mib 64] [--skip-e2e]
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

CORPORA = (("random", 0), ("enwik-proxy", 1), ("utf8-text", 2), ("zeros", 3))


def bench_corpus(name: str, data: np.ndarray) -> dict:
    from gpuar_tpu.parallel.mesh import _entropy_order

    psize = bench.P
    n = -(-data.size // psize)
    raw = np.zeros((n, psize), np.uint8)
    raw.reshape(-1)[: data.size] = data
    sizes = np.full(n, psize, np.int32)
    if data.size % psize:
        sizes[n - 1] = data.size % psize
    # Production parity: the pipeline sorts packets per batch.
    order = _entropy_order(raw)
    op = bench.measure(raw[order], sizes[order])[0]
    return {"corpus": name, "mib": data.size >> 20, "packets": n,
            "encode_gbps": op["encode_gbps"], "decode_gbps": op["decode_gbps"],
            "ratio": op["ratio"], "roundtrip": "bit-exact"}


def bench_file_level(mib: int, mixer, kind: int, name: str) -> dict:
    """Whole-pipeline row: compress+decompress a real file through
    TPUCompressor (reference stats style, src/main.cpp:176-182).

    The enwik-proxy variant is where the device-side compaction of
    variable-length results shows: D2H/H2D carry compressed bytes
    (~0.56x) instead of the full 8,736-B stride per packet."""
    import hashlib
    import tempfile

    from gpuar_tpu.parallel.runner import TPUCompressor

    size = mib << 20
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.bin")
        gip = os.path.join(tmp, "c.gip")
        back = os.path.join(tmp, "back.bin")
        mixer.block(kind, size).tofile(src)
        comp = TPUCompressor()
        # Warm with the SAME file so every batch geometry this run will
        # see is already compiled (a different warm size would leave the
        # main batch shape to compile inside the timed region).
        comp.compress(src, os.path.join(tmp, "w.gip"))
        comp.decompress(os.path.join(tmp, "w.gip"), os.path.join(tmp, "w"))

        t0 = time.perf_counter()
        ci = comp.compress(src, gip)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        di = comp.decompress(gip, back)
        t_d = time.perf_counter() - t0
        h1 = hashlib.md5(open(src, "rb").read()).hexdigest()
        h2 = hashlib.md5(open(back, "rb").read()).hexdigest()
        assert h1 == h2, "file-level round-trip mismatch"
    return {
        "corpus": f"file-e2e ({name})",
        "mib": mib,
        "encode_gbps": size / t_c / 1e9,
        "decode_gbps": size / t_d / 1e9,
        "ratio": ci.compressed_file_size / size,
        "roundtrip": "md5-exact",
        "compress_process_s": ci.process_time,
        "compress_io_s": ci.io_time,
        "decompress_process_s": di.process_time,
        "decompress_io_s": di.io_time,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--out", default="results.json",
                    help="output file name (in benchmarks/); use a "
                         "distinct name for partial runs so --skip-e2e "
                         "cannot clobber the full table's e2e rows")
    args = ap.parse_args()

    from benchmarks.corpora import Mixer

    dev = bench.require_gpu("run")
    device = bench.device_record(dev)
    print(f"device: {json.dumps(device)}", flush=True)
    mixer = Mixer(seed=0xBE7C)
    rows = []
    for name, kind in CORPORA:
        rows.append({**bench_corpus(name, mixer.block(kind, args.mib << 20)),
                     "device": device})
        print(f"done: {rows[-1]}", flush=True)
    if not args.skip_e2e:
        for name, kind in CORPORA[:2]:
            rows.append({**bench_file_level(args.mib, mixer, kind, name),
                         "device": device})
            print(f"done: {rows[-1]}", flush=True)

    out = Path(__file__).with_name(args.out)
    out.write_text(json.dumps(rows, indent=2))

    print(f"\n{device['kind']} x{device['count']} ({device['card']})")
    print("| corpus | size | encode GB/s | decode GB/s | ratio | round-trip |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['corpus']} | {r['mib']} MiB | {r['encode_gbps']} | "
              f"{r['decode_gbps']} | {r['ratio']} | {r['roundtrip']} |")


if __name__ == "__main__":
    main()
