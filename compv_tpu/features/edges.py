"""Gradient edge detectors: Sobel / Scharr / Prewitt.

Reference: core/features/edges/compv_core_feature_edge_dete.cxx (259 LoC) —
common separable-kernel edge detector producing |gx|+|gy| scaled to u8.
Two separable convs + fused elementwise; one XLA program.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.ops.conv import convolve_separable

__all__ = ["sobel_gradients", "edge_detect", "KERNELS", "gradient_magnitude_direction"]

# separable (smooth, derive) pairs — standard operators, as registered by
# CompVCore::init for SOBEL/SCHARR/PREWITT ids (core/compv_core.cxx:149-160)
KERNELS = {
    "sobel": (np.array([1.0, 2.0, 1.0]), np.array([-1.0, 0.0, 1.0])),
    "scharr": (np.array([3.0, 10.0, 3.0]), np.array([-1.0, 0.0, 1.0])),
    "prewitt": (np.array([1.0, 1.0, 1.0]), np.array([-1.0, 0.0, 1.0])),
}


def sobel_gradients(img: jax.Array, operator: str = "sobel"):
    """Returns (gx, gy) float32, same shape. gx = horizontal derivative."""
    smooth, deriv = KERNELS[operator]
    s = jnp.asarray(smooth, jnp.float32)
    d = jnp.asarray(deriv, jnp.float32)
    f = img.astype(jnp.float32)
    gx = convolve_separable(f, d, s)   # derive along x, smooth along y
    gy = convolve_separable(f, s, d)
    return gx, gy


def gradient_magnitude_direction(gx: jax.Array, gy: jax.Array,
                                 l2: bool = False):
    """Magnitude (L1 by default, like the reference's Canny) + direction in
    radians [-pi, pi] (fastAtan2 analogue — XLA's atan2 on the VPU)."""
    if l2:
        mag = jnp.sqrt(gx * gx + gy * gy)
    else:
        mag = jnp.abs(gx) + jnp.abs(gy)
    direction = jnp.arctan2(gy, gx)
    return mag, direction


def edge_detect(img: jax.Array, operator: str = "sobel",
                scale: float | None = None) -> jax.Array:
    """|gx|+|gy| scaled and clamped to u8 (the reference's edge-detector
    output contract)."""
    gx, gy = sobel_gradients(img, operator)
    mag = jnp.abs(gx) + jnp.abs(gy)
    if scale is None:
        # normalize so the maximum possible |gx|+|gy| response maps to 255
        smooth, deriv = KERNELS[operator]
        max_resp = 2.0 * np.abs(smooth).sum() * np.abs(deriv).sum() * 255.0 / 2.0
        scale = 255.0 / max_resp
    return jnp.clip(mag * scale, 0, 255).astype(jnp.uint8)
