"""FAST-9/12 corner detector.

Reference behavior (core/features/fast/compv_core_feature_fast_dete.cxx):
  * per pixel p with threshold t: brighter = sat(p+t), darker = sat(p-t);
    for each of the 16 Bresenham-circle (r=3) neighbors c_i compute
    d_i = max(darker - c_i, 0), b_i = max(c_i - brighter, 0)
    (fast_dete.cxx:727-767);
  * corner iff some arc of N consecutive circle pixels (mod 16) is all
    nonzero on one side; strength = max over valid arcs of (min diff over the
    arc) (the `_cpp_fast_strenght` macro, fast_dete.cxx:688-711);
  * 3x3 NMS: suppress p if any 8-neighbor strength >= strength(p)
    (CompVFastNmsGather_C, fast_dete.cxx:773-816), applied only in the
    interior [3, dim-3);
  * top-K by strength (selectBest, compv_common.h:641-656).

Design: the scalar early-out pipeline becomes a dense vectorized
computation over the whole image — 16 shifted views (static slices, no
gather), running circular-window minima via a log-depth tree of rolls, NMS
as 8 shifted maxes, top-K via lax.top_k. Everything fuses into a handful of
elementwise passes.

Circle offset order matches the reference (fast_dete.cxx:221-238):
index 0 at (dy=-3,dx=0) going clockwise.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from compv_tpu.core.types import Keypoints
from compv_tpu.ops.topk import select_top_k_2d

__all__ = ["FastConfig", "fast_strengths", "fast_nms", "fast_detect",
           "CIRCLE_OFFSETS"]

# (dy, dx) for the 16 circle pixels, reference order (fast_dete.cxx:221-238)
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


@dataclass(frozen=True)
class FastConfig:
    """Typed config replacing CompVCaps ids COMPV_FAST_SET_INT_* —
    defaults per fast_dete.cxx:76-81."""
    threshold: int = 20
    n: int = 9                 # FAST-9 or FAST-12 (arc length)
    nms: bool = True
    max_features: int = 2000   # static output capacity; -1 in the reference
                               # means "all" — here capacity must be static
    exact_topk: bool = False   # lax.top_k vs approx_max_k (which XLA
                               # computes exactly on CPU and GPU)


def _strengths_f32(img: jax.Array, threshold: int, n: int) -> jax.Array:
    """Dense strengths map (H, W) f32 of exact small integers. Zero outside
    the 3-px border, exactly like the reference's calloc'd map with +3
    borders (fast_dete.cxx:200-215).

    Implementation notes:
    * circle views and circular-window minima are kept as Python lists of
      (H, W) arrays — pure elementwise chains over slices of one padded
      buffer, which XLA fuses into a few passes. (A stacked (16, H, W)
      tensor + jnp.roll formulation materializes every stage in device
      memory.)
    * f32 arithmetic on exact small integers: every value is an integer
      <= 255 in magnitude, so f32 is exact.
    * signed diffs with ONE final relu instead of 32 per-element
      max(x, 0) clamps. Bit-identical: positive diffs (<= 255) are exact,
      negative arc-minima stay negative and the final relu zeroes them —
      same outcome as the reference's saturating per-element clamps
      (fast_dete.cxx:727-767)."""
    h, w = img.shape
    f = img.astype(jnp.float32)
    padded = jnp.pad(f, 3)  # zero-pad; border region is masked off below

    brighter = f + jnp.float32(threshold)
    darker = f - jnp.float32(threshold)

    d_list = []
    b_list = []
    for (dy, dx) in CIRCLE_OFFSETS:
        c = jax.lax.slice(padded, (3 + dy, 3 + dx), (3 + dy + h, 3 + dx + w))
        d_list.append(darker - c)
        b_list.append(c - brighter)

    def arc_strength(vals):
        """max over the 16 arc starts of (min over n consecutive diffs) —
        window-min by doubling over the running-min list."""
        m = list(vals)
        span = 1
        while span < n:
            step = min(span, n - span)
            m = [jnp.minimum(m[k], m[(k + step) % 16]) for k in range(16)]
            span += step
        out = m[0]
        for k in range(1, 16):
            out = jnp.maximum(out, m[k])
        return out

    strength = jnp.maximum(arc_strength(d_list), arc_strength(b_list))
    strength = jnp.maximum(strength, 0.0)

    # zero the 3-px border (reference computes rows/cols in [3, dim-3))
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return jnp.where(interior, strength, 0.0)


def fast_strengths(img: jax.Array, threshold: int = 20, n: int = 9) -> jax.Array:
    """Dense strengths map (H, W) u8 (reference FastDataRow semantics)."""
    return _strengths_f32(img, threshold, n).astype(jnp.uint8)


def _nms_f32(s: jax.Array) -> jax.Array:
    """3x3 NMS on an f32 strengths map (see fast_nms for semantics)."""
    h, w = s.shape
    padded = jnp.pad(s, 1)
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            v = jax.lax.slice(padded, (1 + dy, 1 + dx), (1 + dy + h, 1 + dx + w))
            nmax = v if nmax is None else jnp.maximum(nmax, v)
    keep = (s > 0) & (nmax < s)
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return jnp.where(keep & interior, s, 0.0)


def fast_nms(strengths: jax.Array) -> jax.Array:
    """3x3 non-maxima suppression, reference semantics: suppress the center
    if ANY 8-neighbor has strength >= center (ties suppress both sides,
    CompVFastNmsGather_C fast_dete.cxx:773-816). Applied in [3, dim-3)."""
    return _nms_f32(strengths.astype(jnp.float32)).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("config",))
def fast_detect(img: jax.Array, config: FastConfig = FastConfig()) -> Keypoints:
    """Full detector: strengths -> optional NMS -> top-K Keypoints.

    Matches CompVCornerDeteFAST::process (fast_dete.cxx:162-330). Output is a
    fixed-capacity Keypoints (capacity = max_features) sorted by decreasing
    strength."""
    h, w = img.shape
    s = _strengths_f32(img, config.threshold, config.n)
    if config.nms:
        s = _nms_f32(s)
    k = min(config.max_features, h * w)
    vals, idx = select_top_k_2d(s, k, config.exact_topk)
    valid = vals > 0
    x = (idx % w).astype(jnp.float32)
    y = (idx // w).astype(jnp.float32)
    return Keypoints(
        x=jnp.where(valid, x, 0.0),
        y=jnp.where(valid, y, 0.0),
        strength=jnp.where(valid, vals, 0.0),
        orientation=jnp.zeros_like(vals),
        level=jnp.zeros_like(idx, jnp.int32),
        size=jnp.full_like(vals, 7.0),
        valid=valid,
    )
