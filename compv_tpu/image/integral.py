"""Summed-area tables (integral images).

Reference: base/image/compv_image_integral.cxx (SSSE3 kernels). The
natural formulation is two cumulative sums — XLA lowers cumsum to an
efficient parallel scan.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["integral", "integral_squared", "box_sum", "box_mean_var"]


def integral(img: jax.Array, dtype=jnp.float64) -> jax.Array:
    """Integral image with a leading zero row/col: out shape (H+1, W+1),
    out[i,j] = sum(img[:i,:j]). f64 when x64 is enabled; otherwise pass
    jnp.float32, or jnp.int32 for u8 inputs (exact up to 2^31)."""
    if dtype == jnp.float64 and not jax.config.read("jax_enable_x64"):
        dtype = jnp.int32 if jnp.issubdtype(img.dtype, jnp.integer) else jnp.float32
    s = jnp.cumsum(jnp.cumsum(img.astype(dtype), axis=-2), axis=-1)
    pad = [(0, 0)] * (img.ndim - 2) + [(1, 0), (1, 0)]
    return jnp.pad(s, pad)


def integral_squared(img: jax.Array, dtype=jnp.float64) -> jax.Array:
    if dtype == jnp.float64 and not jax.config.read("jax_enable_x64"):
        dtype = jnp.float32
    f = img.astype(dtype)
    return integral(f * f, dtype)


def box_sum(int_img: jax.Array, size: int) -> jax.Array:
    """Sliding size x size window sums from an integral image (the standard
    SAT query). Output shape (H - size + 1, W - size + 1)."""
    a = int_img[..., size:, size:]
    b = int_img[..., size:, :-size]
    c = int_img[..., :-size, size:]
    d = int_img[..., :-size, :-size]
    return a - b - c + d


def box_mean_var(img: jax.Array, size: int):
    """Local mean and variance over clipped size x size windows, computed
    exactly in centered int32 prefix sums (reference: Wolf/Niblack-style
    binarization uses local moments, base/image/compv_image_threshold.cxx;
    the reference accumulates with SIMD box sums — two 1-D prefix passes
    here). Centering at 128 keeps the squared prefix inside int32 for any
    image with H * size * 16384 < 2^31. Returns (mean f32, var f32).
    Windows are clipped at the borders and normalized by the true count."""
    h, w = img.shape
    r = size // 2
    if h * size * 16384 >= 2 ** 31 or w * size * 16384 >= 2 ** 31:
        f = img.astype(jnp.float32)
        mean = _box_mean_f32(f, size)
        var = jnp.maximum(_box_mean_f32(f * f, size) - mean * mean, 0.0)
        return mean, var
    v = img.astype(jnp.int32) - 128

    def box1d(a, axis):
        cs = jnp.cumsum(a, axis=axis)
        n = cs.shape[axis]
        pads_hi = [(0, r) if ax == axis else (0, 0) for ax in range(2)]
        # right edge: clamp to the row/col total (edge-replicated prefix)
        hi = jax.lax.slice_in_dim(jnp.pad(cs, pads_hi, mode="edge"),
                                  r, r + n, axis=axis)
        pads_lo = [(r + 1, 0) if ax == axis else (0, 0) for ax in range(2)]
        # left edge: prefix before the window start (0 when clipped)
        lo = jax.lax.slice_in_dim(jnp.pad(cs, pads_lo), 0, n, axis=axis)
        return hi - lo

    s1 = box1d(box1d(v, 1), 0)
    s2 = box1d(box1d(v * v, 1), 0)
    xs = jnp.arange(w, dtype=jnp.int32)
    ys = jnp.arange(h, dtype=jnp.int32)
    cw = jnp.minimum(xs + r, w - 1) - jnp.maximum(xs - r, 0) + 1
    ch = jnp.minimum(ys + r, h - 1) - jnp.maximum(ys - r, 0) + 1
    cnt = (ch[:, None] * cw[None, :]).astype(jnp.float32)
    m_c = s1.astype(jnp.float32) / cnt
    var = jnp.maximum(s2.astype(jnp.float32) / cnt - m_c * m_c, 0.0)
    return m_c + 128.0, var


def _box_mean_f32(f: jax.Array, size: int) -> jax.Array:
    h, w = f.shape
    r = size // 2

    def box1d(a, axis):
        cs = jnp.cumsum(a, axis=axis)
        n = cs.shape[axis]
        pads_hi = [(0, r) if ax == axis else (0, 0) for ax in range(2)]
        hi = jax.lax.slice_in_dim(jnp.pad(cs, pads_hi, mode="edge"),
                                  r, r + n, axis=axis)
        pads_lo = [(r + 1, 0) if ax == axis else (0, 0) for ax in range(2)]
        lo = jax.lax.slice_in_dim(jnp.pad(cs, pads_lo), 0, n, axis=axis)
        return hi - lo

    xs = jnp.arange(w, dtype=jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)
    cw = jnp.minimum(xs + r, w - 1) - jnp.maximum(xs - r, 0) + 1
    ch = jnp.minimum(ys + r, h - 1) - jnp.maximum(ys - r, 0) + 1
    cnt = ch[:, None] * cw[None, :]
    return box1d(box1d(f, 1), 0) / cnt
