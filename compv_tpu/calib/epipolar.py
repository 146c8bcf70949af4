"""Epipolar geometry: essential/fundamental matrix estimation, pose
recovery, triangulation.

Not in the single-view reference; required by BASELINE.json ("RANSAC
homography / epipolar estimation" + SfM). Same batched-hypothesis RANSAC
design as calib/homography.py: all 8-point hypotheses solved by one vmapped
eigh, scored with Sampson error as one batched einsum.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from compv_tpu.math.stats import hartley_normalize
from compv_tpu.precision import geometry

__all__ = ["EssentialConfig", "EssentialResult", "compute_fundamental_8pt",
           "find_essential", "decompose_essential", "triangulate_points",
           "sampson_error"]


@dataclass(frozen=True)
class EssentialConfig:
    num_hypotheses: int = 512
    threshold: float = 1e-5      # squared Sampson error in normalized coords
                                 # (~1.6 px at f=500)
    seed: int = 0


class EssentialResult(NamedTuple):
    e: jax.Array            # (3,3) essential matrix
    inliers: jax.Array      # (N,)
    num_inliers: jax.Array
    rvec: jax.Array         # (3,) recovered relative rotation (cam1 -> cam2)
    tvec: jax.Array         # (3,) unit-norm translation
    points3d: jax.Array     # (N,3) triangulated (in cam1 frame)


def _eight_point(src: jax.Array, dst: jax.Array,
                 mask: jax.Array | None = None) -> jax.Array:
    """Normalized 8-point algorithm -> (3,3) F (or E for normalized camera
    coords). src/dst (N, 2)."""
    n = src.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    s_n, t_s = hartley_normalize(src, mask)
    d_n, t_d = hartley_normalize(dst, mask)
    x1, y1 = s_n[:, 0], s_n[:, 1]
    x2, y2 = d_n[:, 0], d_n[:, 1]
    a = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=1)
    a = a * mask.astype(a.dtype)[:, None]
    ata = a.T @ a
    _, vecs = jnp.linalg.eigh(ata)
    f = vecs[:, 0].reshape(3, 3)
    # enforce rank 2
    u, s, vt = jnp.linalg.svd(f)
    s = s.at[2].set(0.0)
    f = (u * s[None, :]) @ vt
    return t_d.T @ f @ t_s


@geometry
def compute_fundamental_8pt(src: jax.Array, dst: jax.Array,
                            mask: jax.Array | None = None) -> jax.Array:
    return _eight_point(src, dst, mask)


def _essential_from_f(f: jax.Array) -> jax.Array:
    """Project onto the essential manifold: singular values (1, 1, 0)."""
    u, s, vt = jnp.linalg.svd(f)
    return u @ jnp.diag(jnp.asarray([1.0, 1.0, 0.0], f.dtype)) @ vt


@geometry
def sampson_error(e: jax.Array, src: jax.Array, dst: jax.Array) -> jax.Array:
    """First-order geometric (Sampson) error per correspondence."""
    ones = jnp.ones((src.shape[0], 1), src.dtype)
    x1 = jnp.concatenate([src, ones], axis=1)          # (N,3)
    x2 = jnp.concatenate([dst, ones], axis=1)
    ex1 = x1 @ e.T                                     # = (E x1)^T rows
    etx2 = x2 @ e                                      # = (E^T x2)^T rows
    num = jnp.sum(x2 * ex1, axis=1) ** 2
    den = ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-18)


@geometry
def triangulate_points(r: jax.Array, t: jax.Array, src: jax.Array,
                       dst: jax.Array) -> jax.Array:
    """Linear (DLT) triangulation in normalized coords: cam1 = [I|0],
    cam2 = [R|t]. (N,2)+(N,2) -> (N,3) in cam1 frame."""
    p1 = jnp.concatenate([jnp.eye(3, dtype=r.dtype),
                          jnp.zeros((3, 1), r.dtype)], axis=1)
    p2 = jnp.concatenate([r, t[:, None]], axis=1)

    def one(s, d):
        a = jnp.stack([
            s[0] * p1[2] - p1[0],
            s[1] * p1[2] - p1[1],
            d[0] * p2[2] - p2[0],
            d[1] * p2[2] - p2[1],
        ])
        _, vecs = jnp.linalg.eigh(a.T @ a)
        x = vecs[:, 0]
        w = jnp.where(jnp.abs(x[3]) < 1e-12, 1e-12, x[3])
        return x[:3] / w

    return jax.vmap(one)(src, dst)


@geometry
def decompose_essential(e: jax.Array, src: jax.Array, dst: jax.Array,
                        mask: jax.Array):
    """E -> (R, t) with the cheirality test over the 4 candidates (most
    points in front of both cameras wins). Coords must be normalized."""
    u, _, vt = jnp.linalg.svd(e)
    # enforce proper rotations
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    wm = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     e.dtype)
    r1 = u @ wm @ vt
    r2 = u @ wm.T @ vt
    tv = u[:, 2]

    def score(r, t):
        pts = triangulate_points(r, t, src, dst)
        z1 = pts[:, 2]
        pc2 = pts @ r.T + t
        z2 = pc2[:, 2]
        ok = (z1 > 0) & (z2 > 0) & mask
        return jnp.sum(ok), pts

    cands = [(r1, tv), (r1, -tv), (r2, tv), (r2, -tv)]
    scores = []
    all_pts = []
    for (r, t) in cands:
        sc, pts = score(r, t)
        scores.append(sc)
        all_pts.append(pts)
    scores = jnp.stack(scores)
    best = jnp.argmax(scores)
    rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    pts = jnp.stack(all_pts)
    return rs[best], ts[best], pts[best]


@partial(jax.jit, static_argnames=("config",))
@geometry
def find_essential(src_px: jax.Array, dst_px: jax.Array, k: jax.Array,
                   mask: jax.Array | None = None,
                   config: EssentialConfig = EssentialConfig()
                   ) -> EssentialResult:
    """RANSAC essential matrix from pixel correspondences + intrinsics K.
    Returns E, inliers, recovered (R|t up to scale) and triangulated points."""
    n = src_px.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    kinv = jnp.linalg.inv(k.astype(jnp.float32))

    def norm_pts(p):
        ph = jnp.concatenate([p, jnp.ones((n, 1), p.dtype)], axis=1)
        q = ph @ kinv.T
        return q[:, :2] / q[:, 2:3]

    src = norm_pts(src_px.astype(jnp.float32))
    dst = norm_pts(dst_px.astype(jnp.float32))

    key = jax.random.PRNGKey(config.seed)
    order = jnp.argsort(~mask)
    n_valid = jnp.sum(mask).astype(jnp.int32)
    ridx = jax.random.randint(key, (config.num_hypotheses, 8), 0,
                              jnp.maximum(n_valid, 1))
    idx = order[ridx]

    def solve_one(sample):
        f = _eight_point(src[sample], dst[sample])
        return _essential_from_f(f)

    es = jax.vmap(solve_one)(idx)
    errs = jax.vmap(lambda e: sampson_error(e, src, dst))(es)
    errs = jnp.where(jnp.isfinite(errs), errs, jnp.inf)
    inl = (errs < config.threshold) & mask[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    e_best = es[best]
    inl_best = inl[best]

    # refine on all inliers
    f_ref = _eight_point(src, dst, inl_best)
    e_ref = _essential_from_f(f_ref)
    err_ref = sampson_error(e_ref, src, dst)
    inl_ref = (err_ref < config.threshold) & mask
    better = jnp.sum(inl_ref) >= jnp.sum(inl_best)
    e_fin = jnp.where(better, e_ref, e_best)
    inl_fin = jnp.where(better, inl_ref, inl_best)

    r, t, pts = decompose_essential(e_fin, src, dst, inl_fin)
    from compv_tpu.slam.ba import matrix_to_rodrigues
    return EssentialResult(e=e_fin, inliers=inl_fin,
                           num_inliers=jnp.sum(inl_fin).astype(jnp.int32),
                           rvec=matrix_to_rodrigues(r), tvec=t, points3d=pts)
