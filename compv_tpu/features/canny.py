"""Canny edge detector.

Reference: CompVCornerDeteCanny (core/features/edges/compv_core_feature_canny_dete.cxx:123)
— Sobel3x3 gx/gy (:237-238), L1 magnitude, thresholds (fixed / %-of-mean /
otsu-derived, compv_features.h:80-81), sector-quantized NMS (:279), 8-conn
hysteresis with row-band MT + overlap (:283).

Design:
  * Sobel + magnitude + NMS: dense fused elementwise program.
  * Hysteresis (intrinsically sequential queue-based in the reference):
    reformulated as iterative label propagation — strong |= weak & dilate3x3
    (strong) — inside a lax.while_loop until fixpoint. Converges in
    O(longest weak chain) dilations; each iteration is one fused elementwise pass.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from compv_tpu.features.edges import sobel_gradients

__all__ = ["CannyConfig", "canny"]


@dataclass(frozen=True)
class CannyConfig:
    """Defaults per the reference's canny bench (tLow=59, tHigh=119,
    speed_compare:141-147); threshold_type 'fixed' | 'mean' (percent of
    mean, like COMPV_CANNY_THRESHOLD_TYPE_COMPARE_TO_MEAN)."""
    threshold_low: float = 59.0
    threshold_high: float = 119.0
    threshold_type: str = "fixed"
    max_hysteresis_iters: int = 64


def _nms_gradient(mag: jax.Array, gx: jax.Array, gy: jax.Array) -> jax.Array:
    """Suppress non-maxima along the quantized gradient direction
    (4 sectors: 0, 45, 90, 135 deg)."""
    h, w = mag.shape
    p = jnp.pad(mag, 1)

    def sl(dy, dx):
        return jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w))

    ax = jnp.abs(gx)
    ay = jnp.abs(gy)
    # sector selection by tan 22.5 deg ~ 0.4142: horizontal if |gy| < 0.4142|gx|
    t = 0.41421356
    horiz = ay <= t * ax
    vert = ax <= t * ay
    diag = ~horiz & ~vert
    same_sign = (gx * gy) >= 0   # gradient along +45deg (image coords)

    n1 = jnp.where(horiz, sl(0, -1),
         jnp.where(vert, sl(-1, 0),
         jnp.where(same_sign, sl(-1, -1), sl(-1, 1))))
    n2 = jnp.where(horiz, sl(0, 1),
         jnp.where(vert, sl(1, 0),
         jnp.where(same_sign, sl(1, 1), sl(1, -1))))
    keep = (mag >= n1) & (mag > n2)
    return jnp.where(keep, mag, 0.0)


def _dilate3_bool(x: jax.Array) -> jax.Array:
    h, w = x.shape
    p = jnp.pad(x, 1)
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out | jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w))
    return out


@partial(jax.jit, static_argnames=("config",))
def canny(img: jax.Array, config: CannyConfig = CannyConfig()) -> jax.Array:
    """(H, W) u8 -> (H, W) u8 binary edge map {0, 255}."""
    gx, gy = sobel_gradients(img, "sobel")
    mag = jnp.abs(gx) + jnp.abs(gy)

    if config.threshold_type == "mean":
        mean = jnp.mean(mag)
        tlow = mean * (config.threshold_low / 100.0)
        thigh = mean * (config.threshold_high / 100.0)
    else:
        tlow = jnp.asarray(config.threshold_low, jnp.float32)
        thigh = jnp.asarray(config.threshold_high, jnp.float32)

    nms = _nms_gradient(mag, gx, gy)
    strong = nms >= thigh
    weak = nms >= tlow

    def cond(state):
        s, changed, i = state
        return changed & (i < config.max_hysteresis_iters)

    def body(state):
        s, _, i = state
        # propagate several steps per convergence check (cheaper than
        # checking after every dilation)
        grown = s
        for _ in range(4):
            grown = _dilate3_bool(grown) & weak
        changed = jnp.any(grown != s)
        return grown, changed, i + 1

    strong, _, _ = jax.lax.while_loop(
        cond, body, (strong, jnp.asarray(True), jnp.asarray(0)))

    # zero the 1-px border like the reference's edge maps
    h, w = img.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (yy >= 1) & (yy < h - 1) & (xx >= 1) & (xx < w - 1)
    return jnp.where(strong & interior, jnp.uint8(255), jnp.uint8(0))
