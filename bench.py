"""Device throughput of the coder op, with a bit-exact round trip.

    python bench.py

Times encode and decode of one device-sized batch (SM count x packets one
SM holds, 8192-byte packets) on three corpora: uniform random bytes (the
reference's README corpus), the pinned enwik8 stand-in and its high-byte
UTF-8 variant.  Sample packets are checked against the native golden
codec and every packet must round-trip before a number is printed.

This module is also the one op timer of the repo: benchmarks/run.py and
benchmarks/coder_vs_xla.py time through ``best`` and ``measure``.  Each op
is called once to warm up, then REPS times, each call ending in
block_until_ready; the statistic is the fastest call.

Prints one JSON line naming the device and the card's power limit.  Fails
(exit 2) without a GPU: no other device's number is ever printed under
this metric.  The served path (file -> .gip -> file), per-stage spans and
the benchmark cells are ROADMAP S2.
"""

import json
import subprocess
import sys
import time
from functools import partial

import numpy as np

P = 8192
REPS = 5  # timed calls per op after the warm-up; the fastest is kept


def best(fn, reps: int = REPS) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def require_gpu(prog: str):
    """JAX's first device; exit 2 unless it is a GPU (JAX drops to the CPU
    by itself when its CUDA plugin fails to start)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"{prog}: no GPU (JAX's backend is {dev.platform!r})",
              file=sys.stderr)
        sys.exit(2)
    return dev


def device_record(dev) -> dict:
    """The device as JAX reports it, and the card's name and power limit as
    nvidia-smi gives them: every number printed carries this."""
    import jax

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


def measure(data: np.ndarray, sizes: np.ndarray | None = None):
    """Time encode and decode of packets ``data`` [n, P] u8 (raw byte
    counts ``sizes``, full packets by default).  Returns the fastest
    call's seconds and GB/s each way and the ratio, and the op's rows and
    lengths on the device.  Sample packets are asserted against the
    native golden codec and the whole batch must round-trip."""
    import jax

    from gpuar_tpu import native
    from gpuar_tpu.ops import coder_op

    n = data.shape[0]
    if sizes is None:
        sizes = np.full(n, P, np.int32)
    words = jax.device_put(data.view(np.int32))
    sz = jax.device_put(sizes.reshape(1, n))
    enc = jax.jit(partial(coder_op.encode, packet_size=P))
    dec = jax.jit(partial(coder_op.decode, packet_size=P))
    rows, lens = jax.block_until_ready(enc(words, sz))
    t_enc = best(lambda: jax.block_until_ready(enc(words, sz)))
    rows_h = np.asarray(rows).view(np.uint8)
    lens_h = np.asarray(lens)[0]
    coder_op.check_lengths(lens_h, rows_h.shape[1])
    for i in (0, 1, n // 2, n - 1):
        assert rows_h[i, : lens_h[i]].tobytes() == \
            native.encode_packet(data[i, : sizes[i]].tobytes()), \
            f"packet {i} diverged"
    out = jax.block_until_ready(dec(rows, sz))
    t_dec = best(lambda: jax.block_until_ready(dec(rows, sz)))
    assert np.array_equal(np.asarray(out).view(np.uint8), data), \
        "round-trip mismatch"
    raw = int(sizes.sum())
    return ({"encode_s": t_enc, "decode_s": t_dec,
             "encode_gbps": raw / t_enc / 1e9,
             "decode_gbps": raw / t_dec / 1e9,
             "ratio": float(lens_h.sum()) / raw}, rows, lens)


def main() -> int:
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks.corpora import Mixer
    from gpuar_tpu.ops import coder_op

    dev = require_gpu("bench")
    n = coder_op.packets_per_launch(dev)
    mixer = Mixer(seed=0xBE7C)
    detail = {name: measure(mixer.block(kind, n * P).reshape(n, P))[0]
              for name, kind in (("random", 0), ("enwik_proxy", 1),
                                 ("utf8_text", 2))}
    r = detail["random"]
    print(json.dumps({
        "metric": "coder op encode+decode device throughput (random, one "
                  "device-sized batch, bit-exact round trip verified)",
        "value": 1.0 / (1.0 / r["encode_gbps"] + 1.0 / r["decode_gbps"]),
        "unit": "GB/s",
        "device": device_record(dev),
        "batch_packets": n,
        "detail": detail,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
