"""Perspective-n-Point: camera pose from 2D-3D correspondences.

Not in the reference (its calib recovers pose only for the planar
checkerboard via homography decomposition, core/calib/
compv_core_calib_camera.cxx:169-640); required by the SfM pipeline that
produces BASELINE.json's ATE metric — every frame after the essential-
matrix bootstrap is registered against the triangulated map with PnP.

The design mirrors calib/homography.py: every RANSAC hypothesis is a
6-point DLT solved by one vmapped 12x12 eigh (batched on device, no
data-dependent loop), scored with a single batched reprojection, then a
short fixed-iteration Gauss-Newton polish on (rvec, tvec) using jax.jacfwd
over the 6 pose parameters only.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from compv_tpu.calib.homography import _masked_sample_idx
from compv_tpu.slam.ba import matrix_to_rodrigues, rodrigues_to_matrix
from compv_tpu.precision import geometry

__all__ = ["PnpConfig", "PnpResult", "pnp_dlt", "solve_pnp"]


@dataclass(frozen=True)
class PnpConfig:
    num_hypotheses: int = 256
    sample_size: int = 6
    threshold: float = 2e-5     # squared reprojection error, normalized coords
                                # (~2.2 px at f=500)
    refine_iterations: int = 10
    seed: int = 0


class PnpResult(NamedTuple):
    rvec: jax.Array        # (3,) world -> camera rotation (rodrigues)
    tvec: jax.Array        # (3,)
    inliers: jax.Array     # (N,) bool
    num_inliers: jax.Array


def _project_norm(rvec: jax.Array, tvec: jax.Array, pts3d: jax.Array
                  ) -> jax.Array:
    """World points -> normalized image coords (N, 2)."""
    r = rodrigues_to_matrix(rvec)
    pc = pts3d @ r.T + tvec
    z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
    return pc[:, :2] / z[:, None]


@geometry
def pnp_dlt(pts3d: jax.Array, pts2d_norm: jax.Array,
            mask: jax.Array | None = None):
    """Direct linear transform PnP: (N,3) world points + (N,2) NORMALIZED
    image coords -> (rvec, tvec). Needs N >= 6 non-coplanar points.

    Solves x ~ P [X;1] for P (3,4) as the smallest eigenvector of the
    2Nx12 stacked system's normal matrix, then projects M = P[:, :3] onto
    SO(3) (SVD orthogonalization), recovering scale from the singular
    values and sign from the cheirality of the point cloud."""
    n = pts3d.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    x = pts3d.astype(jnp.float32)
    u = pts2d_norm.astype(jnp.float32)
    ones = jnp.ones((n, 1), jnp.float32)
    xh = jnp.concatenate([x, ones], axis=1)                    # (N, 4)
    zero = jnp.zeros_like(xh)
    row_u = jnp.concatenate([xh, zero, -u[:, :1] * xh], axis=1)   # (N, 12)
    row_v = jnp.concatenate([zero, xh, -u[:, 1:2] * xh], axis=1)  # (N, 12)
    a = jnp.concatenate([row_u, row_v], axis=0)                # (2N, 12)
    m2 = jnp.concatenate([mask, mask]).astype(a.dtype)[:, None]
    a = a * m2
    _, vecs = jnp.linalg.eigh(a.T @ a)
    p = vecs[:, 0].reshape(3, 4)
    # the true solution is P = +lambda [R|t] with lambda > 0 (points in
    # front of the camera); eigh returns +-P, and det(M) = lambda^3 picks
    # the sign — negating ALL of P fixes sign and cheirality at once
    p = p * jnp.sign(jnp.linalg.det(p[:, :3]))
    m = p[:, :3]
    uu, s, vt = jnp.linalg.svd(m)
    r = uu @ vt                    # det = sign(det(M)) = +1
    scale = jnp.maximum(jnp.mean(s), 1e-12)
    t = p[:, 3] / scale
    return matrix_to_rodrigues(r), t


def _refine_gn(rvec, tvec, pts3d, pts2d, weights, iterations: int):
    """Fixed-iteration Gauss-Newton on the 6 pose params (tiny dense 6x6
    normal system; jacfwd over pose only, landmarks constant)."""
    def resid(p6):
        pred = _project_norm(p6[:3], p6[3:], pts3d)
        return ((pred - pts2d) * weights[:, None]).ravel()

    def body(_, p6):
        r0 = resid(p6)
        j = jax.jacfwd(resid)(p6)                       # (2N, 6)
        h = j.T @ j + 1e-8 * jnp.eye(6, dtype=p6.dtype)
        g = j.T @ r0
        dp = jnp.linalg.solve(h, g)
        p1 = p6 - dp
        better = jnp.sum(resid(p1) ** 2) < jnp.sum(r0 ** 2)
        return jnp.where(better, p1, p6)

    p6 = jnp.concatenate([rvec, tvec])
    p6 = jax.lax.fori_loop(0, iterations, body, p6)
    return p6[:3], p6[3:]


@partial(jax.jit, static_argnames=("config",))
@geometry
def solve_pnp(pts3d: jax.Array, pts2d_px: jax.Array, k: jax.Array,
              mask: jax.Array | None = None,
              config: PnpConfig = PnpConfig()) -> PnpResult:
    """RANSAC PnP from pixel observations + intrinsics K over padded point
    sets (N, 3) / (N, 2) + validity mask."""
    n = pts3d.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    kinv = jnp.linalg.inv(k.astype(jnp.float32))
    ph = jnp.concatenate([pts2d_px.astype(jnp.float32),
                          jnp.ones((n, 1), jnp.float32)], axis=1)
    q = ph @ kinv.T
    pn = q[:, :2] / q[:, 2:3]

    key = jax.random.PRNGKey(config.seed)
    idx = _masked_sample_idx(key, mask, config.num_hypotheses,
                             config.sample_size)

    def solve_one(sample):
        return pnp_dlt(pts3d[sample], pn[sample])

    rvs, tvs = jax.vmap(solve_one)(idx)
    samp_ok = jnp.all(mask[idx], axis=1)

    def score_one(rv, tv):
        pred = _project_norm(rv, tv, pts3d)
        z = (pts3d @ rodrigues_to_matrix(rv).T + tv)[:, 2]
        e = jnp.sum((pred - pn) ** 2, axis=1)
        return jnp.where(z > 0, e, jnp.inf)

    errs = jax.vmap(score_one)(rvs, tvs)
    errs = jnp.where(jnp.isfinite(errs), errs, jnp.inf)
    inl = (errs < config.threshold) & mask[None, :] & samp_ok[:, None]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    rvec, tvec, inl_b = rvs[best], tvs[best], inl[best]

    # re-solve DLT on all inliers, keep if not worse
    rv2, tv2 = pnp_dlt(pts3d, pn, inl_b)
    e2 = score_one(rv2, tv2)
    inl2 = (e2 < config.threshold) & mask
    better = jnp.sum(inl2) >= jnp.sum(inl_b)
    rvec = jnp.where(better, rv2, rvec)
    tvec = jnp.where(better, tv2, tvec)
    inl_b = jnp.where(better, inl2, inl_b)

    # GN polish on inliers — accept-only-if-not-worse, so pose and inlier
    # set stay mutually consistent (both revert together if the polish
    # shrinks the inlier set)
    w = inl_b.astype(jnp.float32)
    rv_p, tv_p = _refine_gn(rvec, tvec, pts3d, pn, w,
                            config.refine_iterations)
    e3 = score_one(rv_p, tv_p)
    inl3 = (e3 < config.threshold) & mask
    keep = jnp.sum(inl3) >= jnp.sum(inl_b)
    rvec = jnp.where(keep, rv_p, rvec)
    tvec = jnp.where(keep, tv_p, tvec)
    inl_b = jnp.where(keep, inl3, inl_b)
    return PnpResult(rvec=rvec, tvec=tvec, inliers=inl_b,
                     num_inliers=jnp.sum(inl_b).astype(jnp.int32))
