"""Distance kernels: Hamming, point-to-curve residuals, L2.

Reference: CompVMathDistance (base/math/compv_math_distance.cxx): `hamming`
(Mula/Harley-Seal SIMD popcount, :21-34,:77 — see
matchers/bruteforce.py for the matmul form), `line`/`parabola`
point-to-curve distances (RANSAC residuals), `squaredL2`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from compv_tpu.ops.bitops import unpack_bytes_to_bits
from compv_tpu.precision import geometry

__all__ = ["hamming", "hamming_packed", "dist_line", "dist_parabola",
           "squared_l2", "l2"]


def hamming_packed(data: jax.Array, patch: jax.Array) -> jax.Array:
    """Per-row Hamming distance of N packed descriptors vs one patch
    (reference hamming API shape: (N, B) u8 x (B,) u8 -> (N,) i32)."""
    x = jnp.bitwise_xor(data, patch[None, :])
    return jnp.sum(unpack_bytes_to_bits(x).astype(jnp.int32), axis=-1)


def hamming(data_bits: jax.Array, patch_bits: jax.Array) -> jax.Array:
    """Unpacked-bit variant: (N, B) x (B,) {0,1} -> (N,) i32."""
    return jnp.sum((data_bits != patch_bits[None, :]).astype(jnp.int32), axis=-1)


def dist_line(pts: jax.Array, a, b, c) -> jax.Array:
    """|ax + by + c| / sqrt(a^2 + b^2) for (N, 2) points (reference `line`
    residual used by robust line fitting). A degenerate (a=b=0) model —
    e.g. from a duplicate RANSAC sample — yields +inf so it can never win."""
    num = jnp.abs(a * pts[:, 0] + b * pts[:, 1] + c)
    norm2 = a * a + b * b
    return jnp.where(norm2 < 1e-20, jnp.inf, num / jnp.sqrt(norm2 + 1e-30))


def dist_parabola(pts: jax.Array, a, b, c, axis: str = "x") -> jax.Array:
    """Vertical (resp. horizontal) distance to the parabola
    y = ax^2 + bx + c (reference `parabola` residual)."""
    if axis == "x":
        return jnp.abs(pts[:, 1] - (a * pts[:, 0] ** 2 + b * pts[:, 0] + c))
    return jnp.abs(pts[:, 0] - (a * pts[:, 1] ** 2 + b * pts[:, 1] + c))


@geometry
def squared_l2(a: jax.Array, b: jax.Array) -> jax.Array:
    """Pairwise squared L2: (N, D) x (M, D) -> (N, M) via the matmul
    expansion."""
    aa = jnp.sum(a * a, axis=1)
    bb = jnp.sum(b * b, axis=1)
    ab = a @ b.T
    return jnp.maximum(aa[:, None] + bb[None, :] - 2.0 * ab, 0.0)


@geometry
def l2(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sqrt(squared_l2(a, b))
