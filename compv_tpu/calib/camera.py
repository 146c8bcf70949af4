"""Zhang camera calibration.

Reference: CompVCalibCamera (core/calib/compv_core_calib_camera.cxx):
per-frame process() finds checkerboard corners (Canny -> Hough -> line
grouping -> intersections, :127-226) and a per-plane homography (:1002);
calibrate() (:479) builds the V constraint matrix (2 rows/plane), solves
Vb = 0 by eigen, recovers closed-form K (Burger Alg. 4.4 / Zhang A.4),
per-view R|t from H and K, radial k1,k2 by linear LSQ, then
Levenberg-Marquardt over everything (:1028).

This module implements the same math with jnp.linalg + calib/lm.py; corner
finding is in calib/checkerboard.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.calib.homography import compute_homography_dlt
from compv_tpu.calib.lm import LMConfig, levenberg_marquardt
from compv_tpu.calib.utils import project_points_dist, reproj_error_rms
from compv_tpu.slam.ba import matrix_to_rodrigues, rodrigues_to_matrix
from compv_tpu.precision import geometry

__all__ = ["CalibrationConfig", "CalibrationResult", "calibrate_camera",
           "intrinsics_from_homographies", "extrinsics_from_homography",
           "checkerboard_object_points"]


@dataclass(frozen=True)
class CalibrationConfig:
    with_tangential: bool = False   # p1, p2 (reference optional, levmarq)
    with_skew: bool = False         # gamma
    lm_iterations: int = 40


class CalibrationResult(NamedTuple):
    k: jax.Array             # (3, 3) intrinsics
    dist: jax.Array          # (4,) k1, k2, p1, p2
    rvecs: jax.Array         # (P, 3) per-plane rotations
    tvecs: jax.Array         # (P, 3)
    rms_initial: jax.Array   # closed-form reprojection RMS
    rms: jax.Array           # post-LM reprojection RMS


def checkerboard_object_points(rows: int, cols: int, square: float
                               ) -> jax.Array:
    """(rows*cols, 3) planar grid, z=0, row-major — the calibration pattern
    model (reference pattern block size, calib_camera.cxx)."""
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float64)
    pts = np.stack([xx * square, yy * square, np.zeros_like(xx)], -1)
    return jnp.asarray(pts.reshape(-1, 3), jnp.float32)


def _v_row(h: jax.Array, i: int, j: int) -> jax.Array:
    """Zhang constraint vector v_ij from homography columns
    (calib_camera.cxx:492-527)."""
    hi = h[:, i]
    hj = h[:, j]
    return jnp.stack([
        hi[0] * hj[0],
        hi[0] * hj[1] + hi[1] * hj[0],
        hi[1] * hj[1],
        hi[2] * hj[0] + hi[0] * hj[2],
        hi[2] * hj[1] + hi[1] * hj[2],
        hi[2] * hj[2],
    ])


@geometry
def intrinsics_from_homographies(hs: jax.Array) -> jax.Array:
    """(P, 3, 3) homographies -> (3, 3) K, closed form (Burger Alg 4.4,
    calib_camera.cxx:531-560). Needs P >= 3 (or >=2 with zero skew)."""
    def rows(h):
        return jnp.stack([_v_row(h, 0, 1), _v_row(h, 0, 0) - _v_row(h, 1, 1)])

    v = jnp.concatenate(jax.vmap(rows)(hs), axis=0)     # (2P, 6)
    vtv = v.T @ v
    _, vecs = jnp.linalg.eigh(vtv)
    b = vecs[:, 0]
    # normalize sign so b0 > 0 (B must be positive definite up to scale)
    b = b * jnp.sign(b[0] + 1e-30)
    b0, b1, b2, b3, b4, b5 = b[0], b[1], b[2], b[3], b[4], b[5]

    den = b0 * b2 - b1 * b1
    v0 = (b1 * b3 - b0 * b4) / den
    lam = b5 - (b3 * b3 + v0 * (b1 * b3 - b0 * b4)) / b0
    alpha = jnp.sqrt(jnp.abs(lam / b0))
    beta = jnp.sqrt(jnp.abs(lam * b0 / den))
    gamma = -b1 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - b3 * alpha * alpha / lam
    return jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                     hs.dtype).at[0, 0].set(alpha).at[0, 1].set(gamma) \
        .at[0, 2].set(u0).at[1, 1].set(beta).at[1, 2].set(v0)


@geometry
def extrinsics_from_homography(h: jax.Array, k: jax.Array):
    """R|t of a plane from its homography (calib_camera.cxx per-view R|t):
    r1 = lam K^-1 h1, r2 = lam K^-1 h2, r3 = r1 x r2, t = lam K^-1 h3;
    R re-orthonormalized by SVD."""
    kinv = jnp.linalg.inv(k)
    h1 = kinv @ h[:, 0]
    h2 = kinv @ h[:, 1]
    h3 = kinv @ h[:, 2]
    lam = 1.0 / jnp.maximum(jnp.linalg.norm(h1), 1e-12)
    # ensure positive depth: t_z > 0
    lam = lam * jnp.sign(h3[2] * lam + 1e-30)
    r1 = lam * h1
    r2 = lam * h2
    r3 = jnp.cross(r1, r2)
    r = jnp.stack([r1, r2, r3], axis=1)
    u, _, vt = jnp.linalg.svd(r)
    r_ortho = u @ vt
    # keep det(R) = +1
    d = jnp.linalg.det(r_ortho)
    u = u.at[:, 2].multiply(jnp.sign(d))
    r_ortho = u @ vt
    t = lam * h3
    return r_ortho, t


def _radial_lsq(obj_pts, img_pts_list, k, rvecs, tvecs):
    """Linear least squares for k1, k2 (calib_camera.cxx radial d LSQ):
    observed - ideal = (ideal_centered) * (k1 r^2 + k2 r^4)."""
    fx, cx = k[0, 0], k[0, 2]
    fy, cy = k[1, 1], k[1, 2]
    rows_a, rows_b = [], []
    for i in range(img_pts_list.shape[0]):
        r = rodrigues_to_matrix(rvecs[i])
        pc = obj_pts @ r.T + tvecs[i]
        xn = pc[:, 0] / pc[:, 2]
        yn = pc[:, 1] / pc[:, 2]
        r2 = xn * xn + yn * yn
        u_ideal = fx * xn + cx
        v_ideal = fy * yn + cy
        du = u_ideal - cx
        dv = v_ideal - cy
        rows_a.append(jnp.concatenate([
            jnp.stack([du * r2, du * r2 * r2], 1),
            jnp.stack([dv * r2, dv * r2 * r2], 1)]))
        rows_b.append(jnp.concatenate([
            img_pts_list[i, :, 0] - u_ideal, img_pts_list[i, :, 1] - v_ideal]))
    a = jnp.concatenate(rows_a, axis=0)
    b = jnp.concatenate(rows_b, axis=0)
    sol, *_ = jnp.linalg.lstsq(a, b)
    return sol


@geometry
def calibrate_camera(obj_pts: jax.Array, img_pts: jax.Array,
                     config: CalibrationConfig = CalibrationConfig()
                     ) -> CalibrationResult:
    """Full Zhang pipeline.

    obj_pts: (N, 3) planar model points (z = 0), shared by all planes.
    img_pts: (P, N, 2) detected corners per plane (P >= 3 planes).
    """
    p, n, _ = img_pts.shape
    obj_pts = obj_pts.astype(jnp.float32)
    img_pts = img_pts.astype(jnp.float32)

    # 1) per-plane homographies (model plane -> image)
    src = obj_pts[:, :2]
    hs = jax.vmap(lambda d: compute_homography_dlt(src, d))(img_pts)  # (P,3,3)

    # 2) closed-form intrinsics
    k = intrinsics_from_homographies(hs)

    # 3) per-plane extrinsics
    def ext(h):
        r, t = extrinsics_from_homography(h, k)
        return matrix_to_rodrigues(r), t

    rvecs, tvecs = jax.vmap(ext)(hs)

    # 4) radial distortion LSQ
    k12 = _radial_lsq(obj_pts, img_pts, k, rvecs, tvecs)
    dist0 = jnp.concatenate([k12, jnp.zeros(2, jnp.float32)])

    def rms_of(kmat, dist, rv, tv):
        def one(i_rv, i_tv, i_obs):
            proj = project_points_dist(obj_pts, kmat, dist, i_rv, i_tv)
            return jnp.sum((proj - i_obs) ** 2)
        tot = jnp.sum(jax.vmap(one)(rv, tv, img_pts))
        return jnp.sqrt(tot / (p * n))

    rms0 = rms_of(k, dist0, rvecs, tvecs)

    # 5) LM refinement over [fx, fy, cx, cy, (skew), k1, k2, (p1, p2),
    #    rvecs, tvecs] (calib_camera.cxx levmarq :1028-1168)
    def pack(kmat, dist, rv, tv):
        base = [kmat[0, 0], kmat[1, 1], kmat[0, 2], kmat[1, 2]]
        if config.with_skew:
            base.append(kmat[0, 1])
        base += [dist[0], dist[1]]
        if config.with_tangential:
            base += [dist[2], dist[3]]
        return jnp.concatenate([jnp.stack(base), rv.ravel(), tv.ravel()])

    def unpack(x):
        i = 4
        fx, fy, cx, cy = x[0], x[1], x[2], x[3]
        skew = jnp.asarray(0.0, x.dtype)
        if config.with_skew:
            skew = x[i]
            i += 1
        k1, k2 = x[i], x[i + 1]
        i += 2
        p1 = p2 = jnp.asarray(0.0, x.dtype)
        if config.with_tangential:
            p1, p2 = x[i], x[i + 1]
            i += 2
        rv = x[i:i + 3 * p].reshape(p, 3)
        tv = x[i + 3 * p:].reshape(p, 3)
        kmat = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], x.dtype)
        kmat = kmat.at[0, 0].set(fx).at[1, 1].set(fy).at[0, 2].set(cx) \
            .at[1, 2].set(cy).at[0, 1].set(skew)
        dist = jnp.stack([k1, k2, p1, p2])
        return kmat, dist, rv, tv

    def residual(x):
        kmat, dist, rv, tv = unpack(x)
        def one(i_rv, i_tv, i_obs):
            proj = project_points_dist(obj_pts, kmat, dist, i_rv, i_tv)
            return (proj - i_obs).ravel()
        return jax.vmap(one)(rv, tv, img_pts).ravel()

    x0 = pack(k, dist0, rvecs, tvecs)
    lm = levenberg_marquardt(residual, x0,
                             LMConfig(iterations=config.lm_iterations))
    k_f, dist_f, rv_f, tv_f = unpack(lm.params)
    rms1 = rms_of(k_f, dist_f, rv_f, tv_f)

    # acceptance: reproj error must not increase after LM
    # (calib_camera.cxx:758-768)
    better = rms1 <= rms0
    k_out = jnp.where(better, k_f, k)
    dist_out = jnp.where(better, dist_f, dist0)
    rv_out = jnp.where(better, rv_f, rvecs)
    tv_out = jnp.where(better, tv_f, tvecs)
    return CalibrationResult(k=k_out, dist=dist_out, rvecs=rv_out,
                             tvecs=tv_out, rms_initial=rms0,
                             rms=jnp.minimum(rms0, rms1))
