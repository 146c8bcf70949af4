"""Generic Levenberg-Marquardt for small dense problems.

Replaces the reference's vendored lmfit-6.1 ``lmmin`` (used by camera
calibration, core/calib/compv_core_calib_camera.cxx:1028,1117). JAX-native:
the Jacobian comes from jax.jacfwd (forward-mode — residual counts >> param
count), the normal equations are solved densely (params <= a few hundred),
and the damping schedule runs in a lax.fori_loop so the whole optimization
is one XLA program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from compv_tpu.precision import geometry

__all__ = ["LMConfig", "LMResult", "levenberg_marquardt"]


@dataclass(frozen=True)
class LMConfig:
    iterations: int = 30
    init_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    min_diag: float = 1e-12


class LMResult(NamedTuple):
    params: jax.Array
    cost: jax.Array        # final sum of squared residuals
    initial_cost: jax.Array


@geometry
def levenberg_marquardt(residual_fn: Callable[[jax.Array], jax.Array],
                        x0: jax.Array,
                        config: LMConfig = LMConfig()) -> LMResult:
    """Minimize ||residual_fn(x)||^2 from x0. residual_fn: (P,) -> (R,)."""
    x0 = jnp.asarray(x0)
    p = x0.shape[0]

    def cost_of(x):
        r = residual_fn(x)
        return jnp.sum(r * r)

    jac_fn = jax.jacfwd(residual_fn)
    c0 = cost_of(x0)

    def body(_, state):
        x, lam, cost = state
        r = residual_fn(x)
        j = jac_fn(x)                       # (R, P)
        jtj = j.T @ j                       # (P, P)
        g = j.T @ r                         # (P,)
        # Marquardt scaling: damp by the diagonal
        diag = jnp.maximum(jnp.diagonal(jtj), config.min_diag)
        a = jtj + lam * jnp.diag(diag)
        dx = jnp.linalg.solve(a, -g)
        x_new = x + dx
        cost_new = cost_of(x_new)
        improved = (cost_new < cost) & jnp.all(jnp.isfinite(x_new))
        x = jnp.where(improved, x_new, x)
        lam = jnp.where(improved, lam * config.lambda_down,
                        lam * config.lambda_up)
        cost = jnp.where(improved, cost_new, cost)
        return x, lam, cost

    x, _, cost = jax.lax.fori_loop(
        0, config.iterations, body,
        (x0, jnp.asarray(config.init_lambda, x0.dtype), c0))
    return LMResult(params=x, cost=cost, initial_cost=c0)
