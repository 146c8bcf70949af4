"""Generic batched-hypothesis RANSAC.

Reference: CompVMathStatsRansac::process (base/math/compv_math_stats_ransac.cxx:36-110)
— threads race a shared iteration budget with buildModelParams/buildResiduals
callbacks; adaptive max-iteration from the inlier ratio (p=0.995).

Design: all hypotheses at once. The user supplies
  build_model(points_subset (k, d)) -> model pytree (vmapped over S)
  residuals(model, points (n, d)) -> (n,) residuals
and gets the best model by inlier count. This serves line/parabola fitting
(math/fit.py) and any custom model, exactly like the reference's generic API.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from compv_tpu.precision import geometry

__all__ = ["RansacConfig", "RansacResult", "ransac"]


@dataclass(frozen=True)
class RansacConfig:
    num_hypotheses: int = 256
    min_model_points: int = 2
    threshold: float = 1.0
    seed: int = 0


class RansacResult(NamedTuple):
    model: jax.Array
    inliers: jax.Array
    num_inliers: jax.Array


@geometry
def ransac(points: jax.Array, build_model: Callable, residuals: Callable,
           mask: jax.Array | None = None,
           config: RansacConfig = RansacConfig()) -> RansacResult:
    n = points.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)

    key = jax.random.PRNGKey(config.seed)
    # sampling WITHOUT replacement (permutation-top-k): per hypothesis draw
    # n uniforms, sink invalid points, take the k largest — a uniform random
    # k-subset of valid indices, distinct by construction (the reference's
    # sampler also rejects duplicates, compv_math_stats_ransac.cxx:62-96)
    u = jax.random.uniform(key, (config.num_hypotheses, n))
    u = jnp.where(mask[None, :], u, -1.0)
    _, idx = jax.lax.top_k(u, config.min_model_points)   # (S, k)
    hyp_ok = jnp.all(mask[idx], axis=1)                  # enough valid points

    models = jax.vmap(lambda i: build_model(points[i]))(idx)
    res = jax.vmap(lambda m: residuals(m, points))(models)   # (S, n)
    res = jnp.where(jnp.isfinite(res), res, jnp.inf)
    inl = (res < config.threshold) & mask[None, :] & hyp_ok[:, None]
    counts = jnp.sum(inl, axis=1)
    score = counts.astype(jnp.float32) - 1e-9 * jnp.sum(
        jnp.where(inl, res, 0.0), axis=1)
    score = jnp.where(hyp_ok, score, -jnp.inf)
    best = jnp.argmax(score)
    best_model = jax.tree_util.tree_map(lambda m: m[best], models)
    return RansacResult(model=best_model, inliers=inl[best],
                        num_inliers=counts[best])
