"""Separable & 2-D convolution + Gaussian kernel builders.

Reference: CompVMathConvlt (base/include/compv/base/math/compv_math_convlt.h:26-98,
header-only template dispatching to per-ISA SIMD) and CompVMathGauss
(base/math/compv_math_gauss.cxx). The reference threads row bands with
overlap; here the whole convolution is one XLA program: shift-and-add
for small kernels, conv_general_dilated for wide ones.

Border mode matches the reference's default for its vision kernels: replicate
is NOT used — CompV uses ZERO or IGNORE (compv_math_convlt.h border modes);
we expose 'zero' (default) and 'replicate'.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["gaussian_kernel1d", "gaussian_kernel2d", "convolve_separable",
           "convolve2d", "gaussian_blur", "fixed_point_kernel",
           "convolve_separable_q16", "gaussian_blur_q16"]


def _gaussian_np(size: int, sigma: float) -> np.ndarray:
    assert size % 2 == 1
    half = size // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_kernel1d(size: int, sigma: float) -> jax.Array:
    """Normalized 1-D Gaussian (reference CompVMathGauss::kernelDim1,
    used by the ORB descriptor with size=5 sigma=2.0, orb_desc.cxx:119-120)."""
    return jnp.asarray(_gaussian_np(size, sigma), jnp.float32)


def gaussian_kernel2d(size: int, sigma: float) -> jax.Array:
    k = np.asarray(gaussian_kernel1d(size, sigma))
    return jnp.asarray(np.outer(k, k), jnp.float32)


def _pad2d(img_f: jax.Array, ph: int, pw: int, border: str) -> jax.Array:
    if border == "zero":
        return jnp.pad(img_f, ((ph, ph), (pw, pw)))
    if border == "replicate":
        return jnp.pad(img_f, ((ph, ph), (pw, pw)), mode="edge")
    raise ValueError(border)


# kernels up to this many taps use the shift-and-add formulation; beyond it
# the XLA convolution
_SHIFT_ADD_MAX_TAPS = 31


def _conv1d_axis(f: jax.Array, k: jax.Array, axis: int, border: str
                 ) -> jax.Array:
    """1-D correlation along ``axis`` (-1 or -2) of (..., H, W) f32 via
    shift-and-add over static slices of one padded buffer.

    Single-channel tiny-kernel convs are a poor fit for XLA's general
    convolution; k static slices + fused multiply-adds are one elementwise
    pass. Same design as features/fast._strengths_f32."""
    taps = k.shape[0]
    half = taps // 2
    pad = [(0, 0)] * (f.ndim - 2) + [(0, 0), (0, 0)]
    pad[axis] = (half, half)
    mode = "edge" if border == "replicate" else "constant"
    padded = jnp.pad(f, pad, mode=mode)
    size = f.shape[axis]
    if isinstance(k, jax.core.Tracer):
        kvals = [k[i].astype(jnp.float32) for i in range(taps)]
    else:
        kvals = [jnp.float32(v) for v in np.asarray(k, np.float32)]
    out = None
    for i in range(taps):
        sl = [slice(None)] * f.ndim
        sl[axis] = slice(i, i + size)
        term = padded[tuple(sl)] * kvals[i]
        out = term if out is None else out + term
    return out


def convolve_separable(img: jax.Array, kh: jax.Array, kv: jax.Array,
                       border: str = "zero") -> jax.Array:
    """Separable convolution: horizontal pass with ``kh`` then vertical with
    ``kv`` (reference convlt1, compv_math_convlt.h:26-44). Returns float32;
    callers quantize to u8 if needed. Works on (H,W) or batched (...,H,W)."""
    f = img.astype(jnp.float32)
    if max(kh.shape[0], kv.shape[0]) <= _SHIFT_ADD_MAX_TAPS:
        y = _conv1d_axis(f, kh, -1, border)
        return _conv1d_axis(y, kv, -2, border)
    khn = kh.shape[0] // 2
    kvn = kv.shape[0] // 2
    batch_shape = f.shape[:-2]
    h, w = f.shape[-2:]
    x = f.reshape((-1, 1, h, w))
    wk_h = kh.astype(jnp.float32).reshape(1, 1, 1, -1)
    wk_v = kv.astype(jnp.float32).reshape(1, 1, -1, 1)
    dn = jax.lax.conv_dimension_numbers(x.shape, wk_h.shape, ("NCHW", "OIHW", "NCHW"))
    if border == "replicate":
        x = jnp.pad(x, ((0, 0), (0, 0), (kvn, kvn), (khn, khn)), mode="edge")
        y = jax.lax.conv_general_dilated(x, wk_h, (1, 1), "VALID", dimension_numbers=dn)
        y = jax.lax.conv_general_dilated(y, wk_v, (1, 1), "VALID", dimension_numbers=dn)
    else:
        y = jax.lax.conv_general_dilated(x, wk_h, (1, 1), [(0, 0), (khn, khn)], dimension_numbers=dn)
        y = jax.lax.conv_general_dilated(y, wk_v, (1, 1), [(kvn, kvn), (0, 0)], dimension_numbers=dn)
    return y.reshape(*batch_shape, h, w)


def convolve2d(img: jax.Array, kernel: jax.Array, border: str = "zero") -> jax.Array:
    """Dense 2-D convolution (reference convlt2). ``kernel`` is (kh, kw),
    correlation convention (no flip) like the reference."""
    f = img.astype(jnp.float32)
    kh, kw = kernel.shape
    if kh * kw <= _SHIFT_ADD_MAX_TAPS * 2:
        # shift-and-add over the 2-D stencil (same rationale as _conv1d_axis)
        half_h, half_w = kh // 2, kw // 2
        pad = [(0, 0)] * (f.ndim - 2) + [(half_h, half_h), (half_w, half_w)]
        mode = "edge" if border == "replicate" else "constant"
        padded = jnp.pad(f, pad, mode=mode)
        hh, ww = f.shape[-2:]
        traced = isinstance(kernel, jax.core.Tracer)
        kf = None if traced else np.asarray(kernel, np.float32)
        out = None
        for i in range(kh):
            for j in range(kw):
                if not traced and kf[i, j] == 0.0:
                    continue  # static zero taps cost nothing
                kij = (kernel[i, j].astype(jnp.float32) if traced
                       else jnp.float32(kf[i, j]))
                term = padded[..., i:i + hh, j:j + ww] * kij
                out = term if out is None else out + term
        return jnp.zeros_like(f) if out is None else out
    batch_shape = f.shape[:-2]
    h, w = f.shape[-2:]
    x = f.reshape((-1, 1, h, w))
    wk = kernel.astype(jnp.float32).reshape(1, 1, kh, kw)
    dn = jax.lax.conv_dimension_numbers(x.shape, wk.shape, ("NCHW", "OIHW", "NCHW"))
    if border == "replicate":
        x = jnp.pad(x, ((0, 0), (0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2)), mode="edge")
        y = jax.lax.conv_general_dilated(x, wk, (1, 1), "VALID", dimension_numbers=dn)
    else:
        y = jax.lax.conv_general_dilated(x, wk, (1, 1),
                                         [(kh // 2, kh // 2), (kw // 2, kw // 2)],
                                         dimension_numbers=dn)
    return y.reshape(*batch_shape, h, w)


def fixed_point_kernel(kernel) -> np.ndarray:
    """Quantize a normalized (>0, sums ~1) float kernel to u16 Q0.16 —
    bit-exact mirror of CompVMathConvlt::fixedPointKernel
    (base/include/compv/base/math/compv_math_convlt.h:75-92):
    coeff * 0xffff, truncated."""
    k = np.asarray(kernel, np.float64)
    if (k < 0).any():
        raise ValueError("fixed-point kernel coefficients must be >= 0")
    return (k * 0xFFFF).astype(np.uint16)


def _q16_pass(img_i32: jax.Array, kern_u16: np.ndarray, axis: int
              ) -> jax.Array:
    """One separable fixed-point pass, interior-exact to the reference's
    convlt1VtHzFixedPoint_C (compv_math_convlt.h:386-404): per-tap
    (u8 * u16) >> 16 with floor, unsigned accumulate, clip [0, 255].
    Borders use zero padding (COMPV_BORDER_TYPE_ZERO)."""
    taps = len(kern_u16)
    r = taps // 2
    h, w = img_i32.shape
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    p = jnp.pad(img_i32, pad)
    acc = jnp.zeros((h, w), jnp.int32)
    for t in range(taps):
        if axis == 0:
            sl = jax.lax.dynamic_slice(p, (t, 0), (h, w))
        else:
            sl = jax.lax.dynamic_slice(p, (0, t), (h, w))
        acc = acc + jnp.right_shift(sl * jnp.int32(int(kern_u16[t])), 16)
    return jnp.clip(acc, 0, 255)


@partial(jax.jit, static_argnames=("vt_kern", "hz_kern"))
def convolve_separable_q16(img: jax.Array, vt_kern: tuple, hz_kern: tuple
                           ) -> jax.Array:
    """Separable fixed-point u8 convolution with Q0.16 u16 kernels —
    the bit-parity twin of the reference's convlt1FixedPoint
    (compv_math_convlt.h:31-34): vertical pass then horizontal pass, each
    per-tap floor-shifted, intermediate stored as u8 like the reference's
    two-pass buffer. Kernels are static tuples of python ints (u16)."""
    vt = np.asarray(vt_kern, np.uint16)
    hz = np.asarray(hz_kern, np.uint16)
    x = img.astype(jnp.int32)
    x = _q16_pass(x, vt, axis=0)
    x = _q16_pass(x, hz, axis=1)
    return x.astype(jnp.uint8)


def gaussian_blur_q16(img: jax.Array, size: int = 5, sigma: float = 2.0
                      ) -> jax.Array:
    """Fixed-point gaussian blur: the bit-parity twin of the reference's
    fixed-point blur path (gaussian kernel -> fixedPointKernel ->
    convlt1FixedPoint)."""
    k = _gaussian_np(size, sigma).astype(np.float32)
    kq = tuple(int(v) for v in fixed_point_kernel(k))
    return convolve_separable_q16(img, kq, kq)


def gaussian_blur(img: jax.Array, size: int = 5, sigma: float = 2.0,
                  border: str = "zero") -> jax.Array:
    """Gaussian blur; u8 in -> u8 out (round-clamp), float in -> float out.
    Reference: gaussian blur benchmark speed_compare:109-114 and the ORB
    descriptor pre-blur (orb_desc.cxx:197-201)."""
    k = gaussian_kernel1d(size, sigma)
    out = convolve_separable(img, k, k, border)
    if jnp.issubdtype(img.dtype, jnp.integer):
        return jnp.clip(jnp.round(out), 0, 255).astype(img.dtype)
    return out.astype(img.dtype)
