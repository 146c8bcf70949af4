"""PCA with JSON model persistence.

Reference: CompVMathPCA (base/math/compv_math_pca.cxx; test
tests/math/pca.cxx with pca.json): compute mean + principal vectors, project
/ back-project, save/load JSON.
"""
from __future__ import annotations

import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from compv_tpu.precision import geometry

__all__ = ["PcaModel", "pca_compute", "pca_project", "pca_backproject",
           "pca_save_json", "pca_load_json"]


class PcaModel(NamedTuple):
    mean: jax.Array        # (D,)
    vectors: jax.Array     # (K, D) principal axes, rows
    values: jax.Array      # (K,) eigenvalues (descending)


@geometry
def pca_compute(data: jax.Array, num_components: int) -> PcaModel:
    """(N, D) observations -> top-K PCA model (covariance eigh)."""
    mean = jnp.mean(data, axis=0)
    centered = data - mean
    cov = centered.T @ centered / jnp.maximum(data.shape[0] - 1, 1)
    vals, vecs = jnp.linalg.eigh(cov)
    vals = vals[::-1][:num_components]
    vecs = vecs[:, ::-1][:, :num_components]
    return PcaModel(mean=mean, vectors=vecs.T, values=vals)


@geometry
def pca_project(model: PcaModel, data: jax.Array) -> jax.Array:
    """(N, D) -> (N, K)."""
    return (data - model.mean) @ model.vectors.T


@geometry
def pca_backproject(model: PcaModel, proj: jax.Array) -> jax.Array:
    """(N, K) -> (N, D)."""
    return proj @ model.vectors + model.mean


def pca_save_json(model: PcaModel, path: str) -> None:
    """Reference persists via Mat<->JSON (compv_json.h:24-25)."""
    obj = {
        "mean": np.asarray(model.mean).tolist(),
        "vectors": np.asarray(model.vectors).tolist(),
        "values": np.asarray(model.values).tolist(),
    }
    with open(path, "w") as f:
        json.dump(obj, f)


def pca_load_json(path: str) -> PcaModel:
    with open(path) as f:
        obj = json.load(f)
    return PcaModel(mean=jnp.asarray(obj["mean"], jnp.float32),
                    vectors=jnp.asarray(obj["vectors"], jnp.float32),
                    values=jnp.asarray(obj["values"], jnp.float32))
