"""Time the CUDA coder op against what XLA makes of the plain coder.

    python benchmarks/coder_vs_xla.py

At 8192-byte packets and a device-sized batch (SM count x packets one SM
holds), for a random and a text-class (enwik8 stand-in) corpus:

  * encode: coder_op.encode against ops/xla_codec.encode_scan.  The scan
    emits per-symbol descriptors only (ops/bitpack.py packs them on the
    host), so its device time is a lower bound on any plain encode;
  * decode: coder_op.decode against ops/xla_codec.decode_scan, a complete
    device decode.

Both sides are timed by bench.py's timer: one warm-up call, then timed
calls that end in block_until_ready, the fastest kept (REPS for the op,
SCAN_REPS for the scan, whose calls take about a second each).  Outputs
are checked: the scan decode must return the input, and the scan's
descriptors, packed on the host for a sample of packets, must equal the
op's packets.  Prints one JSON line naming the device, its power limit
and every time.  Fails (exit 2) without a GPU.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

P = bench.P
SCAN_REPS = 2


def bench_corpus(name, data):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpuar_tpu.ops import bitpack, xla_codec

    n = data.shape[0]
    sizes = np.full(n, P, np.int32)
    op, rows, lens = bench.measure(data)

    # The plain version: symbols [steps, n] and MSB-first stream words,
    # both made on the device.
    symbols = jax.jit(lambda d: d.T.astype(jnp.int32))(jax.device_put(data))

    @jax.jit
    def stream_words(r):
        w = r[:, 1:].astype(jnp.uint32)
        return ((w >> 24) | ((w >> 8) & 0xFF00) | ((w & 0xFF00) << 8)
                | (w << 24))

    sw = jax.block_until_ready(stream_words(rows))
    szv = jax.device_put(sizes)
    xe = jax.block_until_ready(xla_codec.encode_scan(symbols, szv))
    t_xenc = bench.best(lambda: jax.block_until_ready(
        xla_codec.encode_scan(symbols, szv)), SCAN_REPS)
    xd = jax.block_until_ready(xla_codec.decode_scan(sw, szv, P))
    t_xdec = bench.best(lambda: jax.block_until_ready(
        xla_codec.decode_scan(sw, szv, P)), SCAN_REPS)
    assert bool(jnp.array_equal(xd.T, jax.device_put(data))), \
        "scan decode differs from the input"
    pick = np.arange(0, n, max(n // 64, 1))
    desc, pat, tb, tr = (np.asarray(a) for a in xe)
    pk, pl = bitpack.pack_batch(desc[:, pick], pat[:, pick], tb[pick],
                                tr[pick], sizes[pick], out_stride=P + 516)
    rows_h = np.asarray(rows).view(np.uint8)
    lens_h = np.asarray(lens)[0]
    for j, i in enumerate(pick):
        assert pk[j, : pl[j]].tobytes() == rows_h[i, : lens_h[i]].tobytes()

    gb = data.size / 1e9
    return {
        "corpus": name,
        "packets": n,
        "ratio": op["ratio"],
        "cuda_encode_s": op["encode_s"], "cuda_decode_s": op["decode_s"],
        "xla_encode_scan_s": t_xenc, "xla_decode_scan_s": t_xdec,
        "cuda_encode_gbps": op["encode_gbps"],
        "cuda_decode_gbps": op["decode_gbps"],
        "xla_encode_scan_gbps": gb / t_xenc,
        "xla_decode_scan_gbps": gb / t_xdec,
    }


def main() -> int:
    from benchmarks.corpora import Mixer
    from gpuar_tpu.ops import coder_op

    dev = bench.require_gpu("coder_vs_xla")
    n = coder_op.packets_per_launch(dev)
    mixer = Mixer(seed=0xBE7C)
    rows = []
    for name, kind in (("random", 0), ("enwik-proxy", 1)):
        data = mixer.block(kind, n * P).reshape(n, P)
        rows.append(bench_corpus(name, data))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "device": bench.device_record(dev), "packet_size": P,
        "batch_packets": n, "statistic": "fastest call",
        "reps": {"op": bench.REPS, "scan": SCAN_REPS}, "corpora": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
