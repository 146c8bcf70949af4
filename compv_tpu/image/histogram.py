"""Histogram ops: 256-bin build, equalization, LUT apply, axis projections.

Reference: CompVMathHistogram (base/math/compv_math_histogram.cxx) — SIMD
bin-count kernels (speed_compare:49-58).

Formulation — NO scatter, NO gather (whether that beats a plain
scatter-add on the GPU is not measured yet):

  * histogram: split each byte v into nibbles (hi, lo). Then
        hist[hi*16+lo] = sum_n onehot_hi[n,hi] * onehot_lo[n,lo]
    i.e. ONE (16,N)x(N,16) matmul over {0,1} one-hots (bf16 in,
    f32 accumulate — exact: counts < 2^24).
  * LUT apply (equalization): lut[v] = onehot_lo @ lut2d[hi,:] selected by
    hi, i.e. (N,16)x(16,16) matmul + a 16-way masked sum — gather-free.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["histogram256", "equalize", "apply_lut256", "projection_x",
           "projection_y"]


def _nibble_onehots(flat_u8: jax.Array):
    """(N,) u8 -> bf16 one-hots (N,16) for the high and low nibble."""
    v = flat_u8.astype(jnp.int32)
    hi = v >> 4
    lo = v & 15
    iota = jnp.arange(16, dtype=jnp.int32)
    oh_hi = (hi[:, None] == iota[None, :]).astype(jnp.bfloat16)
    oh_lo = (lo[:, None] == iota[None, :]).astype(jnp.bfloat16)
    return oh_hi, oh_lo


def histogram256(img: jax.Array) -> jax.Array:
    """(..., H, W) u8 -> (..., 256) i32 counts (nibble matmul)."""
    batch_shape = img.shape[:-2]
    flat = img.reshape(*batch_shape, -1)

    def one(fl):
        oh_hi, oh_lo = _nibble_onehots(fl)
        h2d = jax.lax.dot_general(
            oh_hi, oh_lo, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)          # (16, 16)
        return h2d.reshape(256).astype(jnp.int32)

    if flat.ndim == 1:
        return one(flat)
    out = jax.vmap(one)(flat.reshape(-1, flat.shape[-1]))
    return out.reshape(*batch_shape, 256)


def apply_lut256(img: jax.Array, lut: jax.Array) -> jax.Array:
    """Per-pixel 256-entry LUT application without a gather:
    out = sum_hi onehot_hi * (onehot_lo @ lut2d[hi].T). (..., H, W) u8 in,
    same shape out with lut's dtype semantics (clipped to u8 by callers)."""
    shape = img.shape
    flat = img.reshape(-1)
    oh_hi, oh_lo = _nibble_onehots(flat)
    lut2d = lut.astype(jnp.float32).reshape(16, 16)       # [hi, lo]
    # (N,16) @ (16,16)^T over lo -> value per candidate hi
    cand = jax.lax.dot_general(
        oh_lo, lut2d, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)               # (N, 16) per hi
    out = jnp.sum(cand * oh_hi.astype(jnp.float32), axis=1)
    return out.reshape(shape)


def equalize(img: jax.Array) -> jax.Array:
    """Histogram equalization, u8 (reference equalization benchmark
    speed_compare:54-58): out = round(cdf(v) * 255 / npixels)."""
    h, w = img.shape[-2:]
    hist = histogram256(img)
    cdf = jnp.cumsum(hist, axis=-1)
    # OpenCV-style: scale by (255 / total)
    lut = jnp.clip(jnp.round(cdf.astype(jnp.float32) * (255.0 / (h * w))),
                   0, 255)
    if img.ndim == 2:
        return apply_lut256(img, lut).astype(jnp.uint8)
    flat = img.reshape(-1, h, w)
    lut_flat = lut.reshape(-1, 256)
    out = jax.vmap(apply_lut256)(flat, lut_flat)
    return out.reshape(img.shape).astype(jnp.uint8)


def projection_x(img: jax.Array) -> jax.Array:
    """Column sums (reference CompVMathHistogram projection kernels)."""
    return jnp.sum(img.astype(jnp.int32), axis=-2)


def projection_y(img: jax.Array) -> jax.Array:
    return jnp.sum(img.astype(jnp.int32), axis=-1)
