"""Geometric transforms on homogeneous point sets.

Reference: CompVMathTransform (base/include/compv/base/math/compv_math_transform.h:19-20):
perspective2D = 3x3 x 3xN then homogeneous divide.
Points are column-major (3, N) like the reference, or (N, 2) cartesian.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from compv_tpu.precision import geometry

__all__ = ["perspective_2d", "homogeneous_to_cartesian_2d", "to_homogeneous",
           "apply_homography"]


def to_homogeneous(pts_xy: jax.Array) -> jax.Array:
    """(N, 2) -> (3, N)."""
    return jnp.concatenate([pts_xy.T, jnp.ones((1, pts_xy.shape[0]),
                                               pts_xy.dtype)], axis=0)


def homogeneous_to_cartesian_2d(pts_h: jax.Array) -> jax.Array:
    """(3, N) -> (2, N), dividing by the w row (guarding w ~ 0)."""
    w = pts_h[2]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return pts_h[:2] / w


@geometry
def perspective_2d(pts_h: jax.Array, m: jax.Array) -> jax.Array:
    """(3, N) points, (3, 3) matrix -> (2, N) cartesian."""
    return homogeneous_to_cartesian_2d(m @ pts_h)


@geometry
def apply_homography(h: jax.Array, pts_xy: jax.Array) -> jax.Array:
    """(N, 2) convenience wrapper: returns (N, 2)."""
    return perspective_2d(to_homogeneous(pts_xy), h).T
