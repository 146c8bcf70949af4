"""Trajectory evaluation: ATE / RPE.

BASELINE.json's headline metric is "ATE RMSE on benchmark seqs". Standard
definitions (TUM benchmark): ATE = RMSE of translational error after
Umeyama Sim(3)/SE(3) alignment of estimated to ground-truth trajectory;
RPE = per-step relative pose error.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from compv_tpu.precision import geometry

__all__ = ["umeyama_alignment", "ate_rmse", "rpe_rmse"]


@geometry
def umeyama_alignment(est: jax.Array, gt: jax.Array, with_scale: bool = True):
    """Least-squares similarity aligning est -> gt. (N, 3) each.
    Returns (scale, R (3,3), t (3,))."""
    mu_e = jnp.mean(est, axis=0)
    mu_g = jnp.mean(gt, axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    u, d, vt = jnp.linalg.svd(cov)
    s = jnp.eye(3, dtype=est.dtype)
    det = jnp.linalg.det(u) * jnp.linalg.det(vt)
    s = s.at[2, 2].set(jnp.sign(det))
    r = u @ s @ vt
    var_e = jnp.mean(jnp.sum(ec * ec, axis=1))
    scale = jnp.where(with_scale,
                      jnp.sum(d * jnp.diagonal(s)) / jnp.maximum(var_e, 1e-12),
                      1.0)
    t = mu_g - scale * (r @ mu_e)
    return scale, r, t


def ate_rmse(est: jax.Array, gt: jax.Array, with_scale: bool = True):
    """Absolute trajectory error RMSE after alignment. (N, 3) positions."""
    scale, r, t = umeyama_alignment(est, gt, with_scale)
    aligned = scale * (est @ r.T) + t
    err = aligned - gt
    return jnp.sqrt(jnp.mean(jnp.sum(err * err, axis=1)))


def rpe_rmse(est: jax.Array, gt: jax.Array, delta: int = 1,
             align: bool = True, with_scale: bool = True):
    """Relative pose (translation) error RMSE over steps of ``delta``.

    ``align`` applies the Umeyama sim(3) alignment first — required for
    monocular estimates whose global scale is arbitrary (without it the
    scale mismatch dominates and RPE measures nothing)."""
    if align:
        scale, r, t = umeyama_alignment(est, gt, with_scale)
        est = scale * (est @ r.T) + t
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    err = de - dg
    return jnp.sqrt(jnp.mean(jnp.sum(err * err, axis=1)))
