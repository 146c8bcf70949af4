"""Binary/grayscale morphology: erode, dilate, open, close.

Reference: CompVMathMorph::process (base/math/compv_math_morph.cxx:95-110)
with cross/rect structuring elements on u8 planes. Formulation:
reduce_window min/max — one fused XLA op each, bandwidth-bound like the
reference's SIMD kernels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["strel", "erode", "dilate", "open_", "close_", "morph_gradient",
           "top_hat", "black_hat"]


def strel(shape: str = "cross", size: int = 3) -> np.ndarray:
    """Structuring element (reference COMPV_MATH_MORPH_STREL_TYPE cross/rect)."""
    if shape == "rect":
        return np.ones((size, size), bool)
    if shape == "cross":
        s = np.zeros((size, size), bool)
        s[size // 2, :] = True
        s[:, size // 2] = True
        return s
    raise ValueError(shape)


def _morph(img: jax.Array, se: np.ndarray, is_erode: bool) -> jax.Array:
    se = np.asarray(se, bool)
    kh, kw = se.shape
    f = img.astype(jnp.int32) if jnp.issubdtype(img.dtype, jnp.integer) \
        else img.astype(jnp.float32)
    pad_v = 255 if is_erode else 0
    if not jnp.issubdtype(img.dtype, jnp.integer):
        pad_v = jnp.inf if is_erode else -jnp.inf
    ph, pw = kh // 2, kw // 2
    padded = jnp.pad(f, [(0, 0)] * (f.ndim - 2) + [(ph, ph), (pw, pw)],
                     constant_values=pad_v)
    # Decompose the SE into shifts — for 3x3 cross/rect this is 5/9 taps,
    # all fused by XLA into one VPU loop.
    taps = []
    for dy in range(kh):
        for dx in range(kw):
            if se[dy, dx]:
                sl = padded[..., dy:dy + f.shape[-2], dx:dx + f.shape[-1]]
                taps.append(sl)
    acc = taps[0]
    for t in taps[1:]:
        acc = jnp.minimum(acc, t) if is_erode else jnp.maximum(acc, t)
    return acc.astype(img.dtype)


def erode(img: jax.Array, se=None) -> jax.Array:
    return _morph(img, strel() if se is None else se, True)


def dilate(img: jax.Array, se=None) -> jax.Array:
    return _morph(img, strel() if se is None else se, False)


def open_(img: jax.Array, se=None) -> jax.Array:
    return dilate(erode(img, se), se)


def close_(img: jax.Array, se=None) -> jax.Array:
    return erode(dilate(img, se), se)


def morph_gradient(img: jax.Array, se=None) -> jax.Array:
    d = dilate(img, se).astype(jnp.int32)
    e = erode(img, se).astype(jnp.int32)
    return jnp.clip(d - e, 0, 255).astype(img.dtype)


def top_hat(img: jax.Array, se=None) -> jax.Array:
    o = open_(img, se).astype(jnp.int32)
    return jnp.clip(img.astype(jnp.int32) - o, 0, 255).astype(img.dtype)


def black_hat(img: jax.Array, se=None) -> jax.Array:
    c = close_(img, se).astype(jnp.int32)
    return jnp.clip(c - img.astype(jnp.int32), 0, 255).astype(img.dtype)
