"""True multi-process validation: jax.distributed processes over a
localhost coordinator run DistributedCompressor end-to-end, and the
spliced output must be byte-identical to the single-process pipeline.

This exercises the real collectives (process_allgather, barriers,
broadcast_one_to_all) that the single-process tests can only stub.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from gpuar_tpu.config import UNCOMPRESSED_PACKET_SIZE as P
from gpuar_tpu.pipeline import HostCompressor

_WORKER = textwrap.dedent("""
    import os, sys
    rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    os.environ['JAX_PLATFORMS'] = 'cpu'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.distributed.initialize(coordinator_address=f'localhost:{port}',
                               num_processes=world, process_id=rank)
    sys.path.insert(0, sys.argv[5])
    from gpuar_tpu.parallel.distributed import DistributedCompressor
    from gpuar_tpu.pipeline import HostCompressor

    d = DistributedCompressor(backend=HostCompressor(super_batch_packets=2))
    d.compress(f'{tmp}/in.bin', f'{tmp}/out.gip')
    d.decompress(f'{tmp}/out.gip', f'{tmp}/back.bin')
""")


_WORKER_DEVICE = textwrap.dedent("""
    import os, sys
    rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    os.environ['JAX_PLATFORMS'] = 'cpu'
    # Two VIRTUAL devices per process: the per-process mesh must be built
    # from jax.local_devices() only (parallel/runner.py) — a global-device
    # mesh would be unaddressable in a multi-process run.
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.distributed.initialize(coordinator_address=f'localhost:{port}',
                               num_processes=world, process_id=rank)
    assert len(jax.devices()) == 2 * world
    assert len(jax.local_devices()) == 2
    sys.path.insert(0, sys.argv[5])
    from gpuar_tpu.parallel.distributed import DistributedCompressor
    from gpuar_tpu.parallel.runner import TPUCompressor

    backend = TPUCompressor(packet_size=64, super_batch_packets=64)
    assert backend.codec.n_devices == 2
    d = DistributedCompressor(backend=backend)
    d.compress(f'{tmp}/in.bin', f'{tmp}/out.gip')
    d.decompress(f'{tmp}/out.gip', f'{tmp}/back.bin')
""")


def _free_port() -> int:
    # Racy by nature (the port is released before the coordinator binds
    # it); an ephemeral port keeps collisions unlikely under test churn.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 3])
def test_pod_slice_processes(tmp_path, rng, world):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = rng.integers(0, 256, 9 * P + 321, np.uint8).tobytes()
    (tmp_path / "in.bin").write_bytes(data)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(r), str(world), port,
             str(tmp_path), repo],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for r in range(world)
    ]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    assert (tmp_path / "back.bin").read_bytes() == data

    ref = tmp_path / "ref.gip"
    HostCompressor().compress(tmp_path / "in.bin", ref)
    assert (tmp_path / "out.gip").read_bytes() == ref.read_bytes()


def test_pod_slice_device_backend(tmp_path, rng):
    """World-2 run whose backend is the TPUCompressor/MeshCodec device
    path: per-process meshes over two VIRTUAL local CPU devices each, the
    CPU build of the coder op at tiny packet geometry.
    Covers the per-process local-device mesh construction seam inside a
    jax.distributed run (parallel/runner.py); output must be
    byte-identical to the single-process device pipeline."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    world = 2
    data = rng.integers(0, 256, 37 * 64 + 21, np.uint8).tobytes()
    (tmp_path / "in.bin").write_bytes(data)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER_DEVICE)

    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(r), str(world), port,
             str(tmp_path), repo],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for r in range(world)
    ]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    assert (tmp_path / "back.bin").read_bytes() == data

    from gpuar_tpu.parallel.runner import TPUCompressor

    ref = tmp_path / "ref.gip"
    TPUCompressor(packet_size=64,
                  super_batch_packets=64).compress(
        tmp_path / "in.bin", ref)
    assert (tmp_path / "out.gip").read_bytes() == ref.read_bytes()


def _run_cli_world(tmp_path, world, argv):
    port = str(_free_port())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "gpuar_tpu.cli", *argv, "--multihost",
             f"--coordinator=localhost:{port}", f"--num-processes={world}",
             f"--process-id={r}", "--nointeractive"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for r in range(world)
    ]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_cli_multihost_processes(tmp_path, rng):
    """The CLI's --multihost path: every process gets its coordinator,
    count and id from flags, takes its own device, and the archive equals
    the --host archive byte for byte."""
    data = rng.integers(0, 256, 5 * P + 99, np.uint8).tobytes()
    src, gip, back = tmp_path / "in.bin", tmp_path / "m.gip", \
        tmp_path / "back.bin"
    src.write_bytes(data)
    _run_cli_world(tmp_path, 2, ["c", f"--in={src}", f"--out={gip}",
                                 "--batch-packets=64"])
    ref = tmp_path / "ref.gip"
    HostCompressor().compress(src, ref)
    assert gip.read_bytes() == ref.read_bytes()
    _run_cli_world(tmp_path, 2, ["d", f"--in={gip}", f"--out={back}",
                                 "--batch-packets=64"])
    assert back.read_bytes() == data


def test_cli_multihost_needs_coordinator(tmp_path):
    """Without a coordinator, count and id, --multihost stops with an error
    instead of carrying on as a single process."""
    src = tmp_path / "in.bin"
    src.write_bytes(b"x" * 1000)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    r = subprocess.run(
        [sys.executable, "-m", "gpuar_tpu.cli", "c", f"--in={src}",
         f"--out={tmp_path / 'x.gip'}", "--multihost", "--nointeractive"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 1
    assert "--coordinator" in r.stderr
    assert not (tmp_path / "x.gip").exists()
