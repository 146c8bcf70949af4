"""KNN search: exact brute-force + random-projection ANN index.

Reference: CompVMachineLearningKNN wrapping vendored annoy-1.11.4
(base/include/compv/base/ml/compv_base_ml_knn.h:19-47): addVector /
build(n_trees) / save / load / search.

Design: exact KNN is a distance matmul + top_k — on an accelerator this
is usually FASTER than a tree index for the corpus sizes the reference
targets (annoy exists because CPU brute force is slow; a matrix unit
changes the tradeoff). For very large corpora an annoy-style random-projection hash
index narrows candidates, still evaluated as one batched matmul.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.math.distance import squared_l2
from compv_tpu.precision import geometry

__all__ = ["KnnIndex", "knn_build", "knn_search", "knn_save_json",
           "knn_load_json", "AnnConfig", "ann_build", "ann_search"]


class KnnIndex(NamedTuple):
    vectors: jax.Array     # (N, D)
    norm: str              # "l2" | "angular" (annoy's two metrics)


def knn_build(vectors: jax.Array, norm: str = "l2") -> KnnIndex:
    v = vectors.astype(jnp.float32)
    if norm == "angular":
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    return KnnIndex(vectors=v, norm=norm)


@geometry
def knn_search(index: KnnIndex, queries: jax.Array, k: int):
    """Exact top-k: returns (indices (M, k), distances (M, k))."""
    q = queries.astype(jnp.float32)
    if index.norm == "angular":
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        sim = q @ index.vectors.T
        vals, idx = jax.lax.top_k(sim, k)
        return idx, jnp.sqrt(jnp.maximum(2.0 - 2.0 * vals, 0.0))  # angular dist
    d2 = squared_l2(q, index.vectors)
    vals, idx = jax.lax.top_k(-d2, k)
    return idx, jnp.sqrt(jnp.maximum(-vals, 0.0))


def knn_save_json(index: KnnIndex, path: str) -> None:
    with open(path, "w") as f:
        json.dump({"vectors": np.asarray(index.vectors).tolist(),
                   "norm": index.norm}, f)


def knn_load_json(path: str) -> KnnIndex:
    with open(path) as f:
        obj = json.load(f)
    return KnnIndex(vectors=jnp.asarray(obj["vectors"], jnp.float32),
                    norm=obj["norm"])


# ------------------------------------------------------------- ANN variant

@dataclass(frozen=True)
class AnnConfig:
    n_projections: int = 16    # random hyperplanes (annoy's n_trees analogue)
    candidates: int = 256      # shortlist size per query
    seed: int = 0


class AnnIndex(NamedTuple):
    vectors: jax.Array       # (N, D)
    planes: jax.Array        # (P, D) random hyperplanes
    codes: jax.Array         # (N,) packed sign codes (int32, P <= 31)


@geometry
def ann_build(vectors: jax.Array, config: AnnConfig = AnnConfig()) -> AnnIndex:
    v = vectors.astype(jnp.float32)
    key = jax.random.PRNGKey(config.seed)
    p = min(config.n_projections, 31)
    planes = jax.random.normal(key, (p, v.shape[1]), jnp.float32)
    signs = (v @ planes.T) > 0                       # (N, P)
    weights = (2 ** jnp.arange(p, dtype=jnp.int32))
    codes = jnp.sum(signs.astype(jnp.int32) * weights[None, :], axis=1)
    return AnnIndex(vectors=v, planes=planes, codes=codes)


@geometry
def ann_search(index: AnnIndex, queries: jax.Array, k: int,
               config: AnnConfig = AnnConfig()):
    """Hash-bucket shortlist (by code Hamming proximity) then exact distances
    on the shortlist. Returns (indices, distances)."""
    q = queries.astype(jnp.float32)
    p = index.planes.shape[0]
    signs = (q @ index.planes.T) > 0
    weights = (2 ** jnp.arange(p, dtype=jnp.int32))
    qcodes = jnp.sum(signs.astype(jnp.int32) * weights[None, :], axis=1)  # (M,)

    xor = jnp.bitwise_xor(qcodes[:, None], index.codes[None, :])
    # popcount of the int32 codes
    pc = jnp.zeros_like(xor)
    for b in range(p):
        pc = pc + ((xor >> b) & 1)
    c = min(config.candidates, index.vectors.shape[0])
    _, cand = jax.lax.top_k(-pc, c)                  # (M, c) closest codes

    def per_query(qv, cidx):
        sub = index.vectors[cidx]                    # (c, D)
        d2 = jnp.sum((sub - qv[None, :]) ** 2, axis=1)
        vals, loc = jax.lax.top_k(-d2, k)
        return cidx[loc], jnp.sqrt(jnp.maximum(-vals, 0.0))

    return jax.vmap(per_query)(q, cand)
