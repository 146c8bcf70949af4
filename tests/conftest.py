"""Test harness config.

Tests run on a virtual 8-device CPU mesh (SURVEY.md §4: single-host
simulation of multi-chip replaces the reference's asm-vs-C test matrix),
so they give the same results on any machine, with or without a GPU.
Tests that need the card take the ``gpu`` fixture and skip here; the card
itself is checked by chip_smoke.py. Must set env vars before jax is
imported anywhere.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # force, even where a GPU is present
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Pin the config too, in case JAX was imported (and read the environment)
# before this file ran; no backend has initialized yet.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The default backend's devices when it is a GPU; skips otherwise.
    Decided here, at run time, never while a module is imported."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU backend (the harness pins the CPU)")
    return jax.devices()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


from tests.fixtures import make_test_image, make_test_rgb  # noqa: E402


@pytest.fixture(scope="session")
def test_image():
    """Deterministic synthetic 8-bit grayscale test image (no binary fixtures
    in-repo; the reference ships .yuv files, we synthesize an equally rich
    scene: gradient + blobs + corners + noise). Shared with the golden
    generator via tests/fixtures.py."""
    return make_test_image()


@pytest.fixture(scope="session")
def test_rgb(test_image):
    """RGB version with colored gradients."""
    return make_test_rgb(test_image)
