"""Shared helpers for the example scripts: setup + synthetic scenes (no
binary fixtures in-repo, mirroring tests/).

Examples run on JAX's default backend — the GPU where there is one. To run
them on the CPU, set JAX_PLATFORMS=cpu (and, for the multi-device examples,
XLA_FLAGS=--xla_force_host_platform_device_count=8)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from compv_tpu.device import enable_compile_cache  # noqa: E402

enable_compile_cache()


def textured_scene(h=240, w=320, seed=5):
    from scipy import ndimage
    rs = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rs.uniform(0, 255, (h, w)).astype(np.float32), 1.5)
    return ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)


def out_path(name):
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)
