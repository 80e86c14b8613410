import os
import sys

# The suite runs on the CPU build of the coder op over a virtual 8-device
# CPU mesh, so the sharding code is validated without GPUs (the standard
# JAX recipe).  The tests marked `gpu` need the card:
#   GPUAR_TEST_ON_GPU=1 python -m pytest -m gpu tests/
# leaves JAX on its default (GPU) backend for them; without the variable
# they skip.
if os.environ.get("GPUAR_TEST_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("GPUAR_TEST_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xA12C0DE)


@pytest.fixture
def gpu():
    """The first GPU; skips the test when JAX has none (decided here, at
    run time, never while the module is imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `GPUAR_TEST_ON_GPU=1 python -m pytest "
                    "-m gpu tests/` on the card")
    return dev


def fixture_corpora(rng, max_size=None):
    """The fixture classes from SURVEY.md §4: boundary sizes and contents."""
    sizes = [0, 1, 2, 15, 16, 17, 255, 4096, 8191, 8192, 8193, 16384, 20000]
    if max_size is not None:
        sizes = [s for s in sizes if s <= max_size]
    cases = []
    for s in sizes:
        cases.append((f"random_{s}", rng.integers(0, 256, s, np.uint8).tobytes()))
    cases.append(("all_zero", bytes(8192)))
    cases.append(("all_ff", b"\xff" * 8192))
    cases.append(("text", (b"the quick brown fox jumps over the lazy dog. " * 400)[:8192 + 300]))
    cases.append(("skewed", bytes(rng.choice([0, 1, 2, 255], size=9000, p=[0.7, 0.2, 0.05, 0.05]).astype(np.uint8))))
    return cases
