"""Robust curve fitting: line & parabola = RANSAC + total-least-squares
refinement.

Reference: CompVMathStatsFit (base/include/compv/base/math/compv_math_stats_fit.h:19-20,
base/math/compv_math_stats_fit.cxx): RANSAC consensus then TLS refine on
inliers.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from compv_tpu.calib.ransac import RansacConfig, ransac
from compv_tpu.math.distance import dist_line, dist_parabola
from compv_tpu.precision import geometry

__all__ = ["LineFit", "ParabolaFit", "fit_line", "fit_parabola"]


class LineFit(NamedTuple):
    abc: jax.Array        # (3,) ax + by + c = 0, |(a,b)| = 1
    inliers: jax.Array
    num_inliers: jax.Array


class ParabolaFit(NamedTuple):
    abc: jax.Array        # y = a x^2 + b x + c  (or x = f(y) for axis="y")
    inliers: jax.Array
    num_inliers: jax.Array


def _tls_line(pts: jax.Array, mask: jax.Array) -> jax.Array:
    """Total least squares line through masked points: normal = smallest
    eigenvector of the covariance (orthogonal regression)."""
    m = mask.astype(pts.dtype)[:, None]
    n = jnp.maximum(jnp.sum(m), 1.0)
    mu = jnp.sum(pts * m, axis=0) / n
    d = (pts - mu) * m
    cov = d.T @ d
    _, vecs = jnp.linalg.eigh(cov)
    normal = vecs[:, 0]
    c = -jnp.dot(normal, mu)
    return jnp.concatenate([normal, c[None]])


@geometry
def fit_line(pts: jax.Array, mask: jax.Array | None = None,
             threshold: float = 1.0, num_hypotheses: int = 256,
             seed: int = 0) -> LineFit:
    """Robust line fit (reference CompVMathStatsFit::line)."""
    n = pts.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)

    def build(sub):
        p, q = sub[0], sub[1]
        d = q - p
        nv = jnp.stack([-d[1], d[0]])
        nv = nv / jnp.maximum(jnp.linalg.norm(nv), 1e-12)
        return jnp.concatenate([nv, -jnp.dot(nv, p)[None]])

    def resid(model, points):
        return dist_line(points, model[0], model[1], model[2])

    r = ransac(pts, build, resid, mask,
               RansacConfig(num_hypotheses=num_hypotheses, min_model_points=2,
                            threshold=threshold, seed=seed))
    refined = _tls_line(pts, r.inliers)
    e = dist_line(pts, refined[0], refined[1], refined[2])
    inl = (e < threshold) & mask
    better = jnp.sum(inl) >= r.num_inliers
    model = jnp.where(better, refined, r.model)
    inliers = jnp.where(better, inl, r.inliers)
    return LineFit(abc=model, inliers=inliers,
                   num_inliers=jnp.sum(inliers).astype(jnp.int32))


@geometry
def fit_parabola(pts: jax.Array, mask: jax.Array | None = None,
                 threshold: float = 1.0, num_hypotheses: int = 256,
                 axis: str = "x", seed: int = 0) -> ParabolaFit:
    """Robust parabola fit (reference CompVMathStatsFit::parabola)."""
    n = pts.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    if axis == "y":
        pts_f = pts[:, ::-1]
    else:
        pts_f = pts

    def build(sub):
        # exact parabola through 3 points (Vandermonde solve)
        x, y = sub[:, 0], sub[:, 1]
        v = jnp.stack([x * x, x, jnp.ones_like(x)], axis=1)
        return jnp.linalg.solve(v + 1e-12 * jnp.eye(3, dtype=v.dtype), y)

    def resid(model, points):
        return dist_parabola(points, model[0], model[1], model[2])

    r = ransac(pts_f, build, resid, mask,
               RansacConfig(num_hypotheses=num_hypotheses, min_model_points=3,
                            threshold=threshold, seed=seed))

    # LSQ refine on inliers
    m = r.inliers.astype(pts_f.dtype)
    x, y = pts_f[:, 0], pts_f[:, 1]
    v = jnp.stack([x * x, x, jnp.ones_like(x)], axis=1) * m[:, None]
    sol, *_ = jnp.linalg.lstsq(v, y * m)
    e = dist_parabola(pts_f, sol[0], sol[1], sol[2])
    inl = (e < threshold) & mask
    better = jnp.sum(inl) >= r.num_inliers
    model = jnp.where(better, sol, r.model)
    inliers = jnp.where(better, inl, r.inliers)
    return ParabolaFit(abc=model, inliers=inliers,
                       num_inliers=jnp.sum(inliers).astype(jnp.int32))
