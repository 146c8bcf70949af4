"""Calibration utilities: distortion-aware projection, reprojection error,
undistortion maps.

Reference: core/include/compv/core/calib/compv_core_calib_utils.h:18-26 —
proj2D (K, d, R, t projection with radial/tangential distortion),
proj2DError (RMS), initUndistMap + undist2DImage (map + remap),
dist2DPoints.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from compv_tpu.image.remap import remap_bilinear
from compv_tpu.slam.ba import rodrigues_to_matrix
from compv_tpu.precision import geometry

__all__ = ["project_points_dist", "distort_normalized", "reproj_error_rms",
           "build_undistort_map", "undistort_image", "undistort_points"]


def distort_normalized(xn: jax.Array, yn: jax.Array, dist: jax.Array):
    """Apply radial (k1, k2) + tangential (p1, p2) distortion to normalized
    camera coords. dist = (k1, k2, p1, p2) (reference supports k1,k2 + optional
    p1,p2, calib_camera.cxx levmarq)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return xd, yd


@geometry
def project_points_dist(pts3d: jax.Array, k: jax.Array, dist: jax.Array,
                        rvec: jax.Array, tvec: jax.Array) -> jax.Array:
    """(N,3) world points -> (N,2) pixels through K, distortion, R|t
    (reference proj2D, compv_core_calib_utils.cxx:227)."""
    r = rodrigues_to_matrix(rvec)
    pc = pts3d @ r.T + tvec
    z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
    xn = pc[:, 0] / z
    yn = pc[:, 1] / z
    xd, yd = distort_normalized(xn, yn, dist)
    fx, skew, cx = k[0, 0], k[0, 1], k[0, 2]
    fy, cy = k[1, 1], k[1, 2]
    u = fx * xd + skew * yd + cx
    v = fy * yd + cy
    return jnp.stack([u, v], axis=1)


def reproj_error_rms(observed: jax.Array, projected: jax.Array,
                     mask: jax.Array | None = None) -> jax.Array:
    """RMS reprojection error (reference proj2DError)."""
    d2 = jnp.sum((observed - projected) ** 2, axis=-1)
    if mask is not None:
        n = jnp.maximum(jnp.sum(mask), 1)
        return jnp.sqrt(jnp.sum(jnp.where(mask, d2, 0.0)) / n)
    return jnp.sqrt(jnp.mean(d2))


@geometry
def build_undistort_map(k: jax.Array, dist: jax.Array, height: int, width: int):
    """Maps for remap-based undistortion (reference initUndistMap,
    compv_core_calib_utils.cxx:363): for each *undistorted* output pixel,
    where to sample in the distorted source. Forward distortion only —
    no iterative inversion needed (this direction is closed-form)."""
    yy = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
    fx, skew, cx = k[0, 0], k[0, 1], k[0, 2]
    fy, cy = k[1, 1], k[1, 2]
    yn = (yy - cy) / fy
    xn = (xx - cx - skew * yn) / fx
    xd, yd = distort_normalized(xn, yn, dist)
    map_x = fx * xd + skew * yd + cx
    map_y = fy * yd + cy
    return map_x, map_y


def undistort_image(img: jax.Array, k: jax.Array, dist: jax.Array) -> jax.Array:
    """(reference undist2DImage = initUndistMap + remap)."""
    h, w = img.shape[:2]
    mx, my = build_undistort_map(k, dist, h, w)
    return remap_bilinear(img, mx, my)


@geometry
def undistort_points(pts: jax.Array, k: jax.Array, dist: jax.Array,
                     iterations: int = 8) -> jax.Array:
    """Iteratively invert the distortion for (N,2) pixel points (fixed-point
    iteration, the standard approach)."""
    fx, skew, cx = k[0, 0], k[0, 1], k[0, 2]
    fy, cy = k[1, 1], k[1, 2]
    yd = (pts[:, 1] - cy) / fy
    xd = (pts[:, 0] - cx - skew * yd) / fx

    def body(_, xy):
        xn, yn = xy
        xdd, ydd = distort_normalized(xn, yn, dist)
        return xn + (xd - xdd), yn + (yd - ydd)

    xn, yn = jax.lax.fori_loop(0, iterations, body, (xd, yd))
    u = fx * xn + skew * yn + cx
    v = fy * yn + cy
    return jnp.stack([u, v], axis=1)
