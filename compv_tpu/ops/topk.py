"""Top-k selection.

Detection pipelines use ``select_top_k(..., exact=False)``, which calls
jax.lax.approx_max_k. On the CPU and the GPU XLA computes it as the exact
top-k, so results are bit-deterministic and agree between the two. Callers
that need exact semantics on every backend pass exact=True (lax.top_k).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["select_top_k", "select_top_k_2d"]


def select_top_k(x: jax.Array, k: int, exact: bool = False):
    """(N,) values -> (values (k,), indices (k,)), descending."""
    if exact:
        return jax.lax.top_k(x, k)
    return jax.lax.approx_max_k(x, k)


def select_top_k_2d(img_vals: jax.Array, k: int, exact: bool = False):
    """Top-k over a dense 2-D map -> (values (k,), flat indices (k,)).

    The optimization_barrier keeps XLA from fusing the map's producer
    chain into the top-k's operand, so the map materializes once."""
    img_vals = jax.lax.optimization_barrier(img_vals)
    return select_top_k(img_vals.astype(jnp.float32).ravel(), k, exact)
