"""Element-wise math ops, casts, activations, moments, trig, fast exp.

Reference: base/math/compv_math_op_*.cxx (add/sub/mul, minmax, clip, scale),
compv_math_cast.cxx (s16<->f32 etc.), activation functions (tanh/logistic
for ML), compv_math_exp.cxx (vectorized exp), compv_math_trig.h:22-35
(fastAtan2, hypot), image moments. All of these are single fused XLA
elementwise programs; they exist as named functions for API parity.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["add", "sub", "mul_elementwise", "abs_", "minmax", "clip",
           "scale_values", "cast", "tanh_activation", "logistic_activation",
           "relu", "fast_exp", "fast_atan2_deg", "atan2_deg_exact",
           "hypot_", "image_moments",
           "hu_moments"]


def _saturate(v, dtype):
    info = jnp.iinfo(dtype)
    return jnp.clip(v, info.min, info.max).astype(dtype)


def _int_op(a, b, op, mul=False):
    """Integer path: saturating for <=16-bit dtypes (deliberate EXTENSION —
    the reference's compv_math_op_add/sub family is float32-only SIMD with
    plain wrapping C integer fallbacks, base/math/compv_math_op_add.cxx;
    saturation here matches what the image pipeline wants from u8 math and
    is noted as a divergence in COMPONENTS.md). 32-bit dtypes wrap, exactly
    like the reference's C arithmetic (a 64-bit accumulator would need
    jax_enable_x64).

    Accumulator choice (exactness proof): add/sub of <=16-bit values fit
    int32 (|sum| <= 2^17, and int32 holds the negative range unsigned
    subtract needs before clipping to 0); products fit int32 when signed
    (|p| <= 2^30) but need uint32 when unsigned (uint16^2 <= 2^32-2^17+1,
    and unsigned operands can't go negative)."""
    dt = jnp.result_type(a)
    if jnp.iinfo(dt).bits > 16:
        return op(jnp.asarray(a), jnp.asarray(b, dt)).astype(dt)
    acc = jnp.uint32 if (mul and jnp.iinfo(dt).min == 0) else jnp.int32
    return _saturate(op(a.astype(acc), jnp.asarray(b, acc)), dt)


def add(a, b):
    """Saturating add for <=16-bit integer dtypes, wrapping for wider ints
    (matching the reference's C fallback), plain add for floats."""
    if jnp.issubdtype(jnp.result_type(a), jnp.integer):
        return _int_op(a, b, jnp.add)
    return jnp.add(a, b)


def sub(a, b):
    """Saturating subtract for <=16-bit integer dtypes; see add()."""
    if jnp.issubdtype(jnp.result_type(a), jnp.integer):
        return _int_op(a, b, jnp.subtract)
    return jnp.subtract(a, b)


def mul_elementwise(a, b):
    """Saturating elementwise multiply for <=16-bit integer dtypes; see
    add(). The uint16 case accumulates in uint32 (products to 2^32-2^17+1
    are exact), the int16 case in int32."""
    if jnp.issubdtype(jnp.result_type(a), jnp.integer):
        return _int_op(a, b, jnp.multiply, mul=True)
    return jnp.multiply(a, b)


def abs_(a):
    return jnp.abs(a)


def minmax(a):
    """(min, max) of an array (reference CompVMathOpMinMax)."""
    return jnp.min(a), jnp.max(a)


def clip(a, lo, hi):
    return jnp.clip(a, lo, hi)


def scale_values(a, s):
    return a * s


def cast(a, dtype):
    """Saturating cast for integer targets (reference compv_math_cast)."""
    if jnp.issubdtype(dtype, jnp.integer):
        info = jnp.iinfo(dtype)
        return jnp.clip(jnp.round(a.astype(jnp.float32)), info.min, info.max
                        ).astype(dtype)
    return a.astype(dtype)


def tanh_activation(a):
    """(reference activation-function kernels for ML)."""
    return jnp.tanh(a)


def logistic_activation(a):
    return jax.nn.sigmoid(a)


def relu(a):
    return jnp.maximum(a, 0)


def fast_exp(a):
    """Vectorized exp (reference compv_math_exp fast exp; XLA's exp is
    already the VPU transcendental)."""
    return jnp.exp(a)


# degree-7 odd minimax polynomial coefficients for atan on [0,1], in
# degrees — numeric parity with the reference's fastAtan2
# (base/math/compv_math.cxx:39-43: 57.2836266, -18.6674461, 8.91400051,
# -2.53972459, eps 2.22e-16)
_ATAN2_EPS = 2.2204460492503131e-16
_ATAN2_P = (57.2836266, -18.6674461, 8.91400051, -2.53972459)


def fast_atan2_deg(y, x):
    """Branchless polynomial atan2 in degrees [0, 360) — the reference's
    fastAtan2 kernel (compv_math_trig.cxx:409-440) as one fused VPU
    elementwise chain: octant fold via |x|,|y| compare, degree-7 odd
    polynomial, then quadrant unfolds. Measured max error ~0.01 deg vs the
    transcendental. Use ``atan2_deg_exact`` when exactness matters."""
    y = jnp.asarray(y, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    ax, ay = jnp.abs(x), jnp.abs(y)
    lo = jnp.minimum(ax, ay)
    hi = jnp.maximum(ax, ay)
    c = lo / (hi + _ATAN2_EPS)
    c2 = c * c
    p1, p3, p5, p7 = _ATAN2_P
    a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = jnp.where(ax >= ay, a, 90.0 - a)
    a = jnp.where(x < 0, 180.0 - a, a)
    a = jnp.where(y < 0, 360.0 - a, a)
    return a


def atan2_deg_exact(y, x):
    """Exact atan2 in degrees [0, 360) (XLA transcendental)."""
    d = jnp.rad2deg(jnp.arctan2(y, x))
    return jnp.where(d < 0, d + 360.0, d)


def hypot_(x, y):
    return jnp.hypot(x, y)


def image_moments(img: jax.Array, order: int = 2) -> dict:
    """Raw image moments m_pq up to ``order`` (reference moments kernels,
    base/math/compv_math_moments.cxx)."""
    f = img.astype(jnp.float32)
    h, w = f.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    out = {}
    for p in range(order + 1):
        for q in range(order + 1 - p):
            out[f"m{p}{q}"] = jnp.sum(f * xs ** p * ys ** q)
    return out


def hu_moments(img: jax.Array) -> jax.Array:
    """First 4 Hu invariant moments (rotation/translation/scale invariant)."""
    m = image_moments(img, 3)
    m00 = jnp.maximum(m["m00"], 1e-9)
    cx = m["m10"] / m00
    cy = m["m01"] / m00
    f = img.astype(jnp.float32)
    h, w = f.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) - cy
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) - cx

    def mu(p, q):
        return jnp.sum(f * xs ** p * ys ** q)

    def nu(p, q):
        return mu(p, q) / m00 ** (1 + (p + q) / 2.0)

    n20, n02, n11 = nu(2, 0), nu(0, 2), nu(1, 1)
    n30, n03, n21, n12 = nu(3, 0), nu(0, 3), nu(2, 1), nu(1, 2)
    h1 = n20 + n02
    h2 = (n20 - n02) ** 2 + 4 * n11 ** 2
    h3 = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h4 = (n30 + n12) ** 2 + (n21 + n03) ** 2
    return jnp.stack([h1, h2, h3, h4])
