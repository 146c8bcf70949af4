"""Brute-force KNN Hamming matcher, reformulated as a matmul.

Reference: CompVMatcherBruteForce (core/matchers/compv_core_matcher_bruteforce.cxx)
— query blocks split across threads, per-train-row SIMD popcount Hamming
(base/math/compv_math_distance.cxx:77), insertion into K sorted slots,
optional cross-check for KNN=1. Headline: 28.4x vs OpenCV
(speed_compare:135-140).

Reformulation (SURVEY.md §2.6 item 1): descriptors as *unpacked* bit
matrices Q (Nq, 256), T (Nt, 256) in {0,1}. Then

    hamming(q, t) = popcount(q) + popcount(t) - 2 * <q, t>

so the whole Nq x Nt distance matrix is ONE matmul (bf16 inputs,
f32 accumulate — exact: all values are small integers) plus rank-1
broadcasts. KNN-2 = two passes of min+mask (cheaper than a full sort for
K<=2; general K uses lax.top_k on negated distances).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from compv_tpu.core.types import Matches

__all__ = ["MatcherConfig", "hamming_distance_matrix", "knn_match",
           "match_bruteforce", "ratio_test"]


@dataclass(frozen=True)
class MatcherConfig:
    """Replaces COMPV_BRUTEFORCE_SET_INT_KNN / _BOOL_CROSS_CHECK
    (compv_matchers.h:27-42). Defaults: KNN=2, no cross-check."""
    knn: int = 2
    cross_check: bool = False
    norm: str = "hamming"


def hamming_distance_matrix(query_bits: jax.Array, train_bits: jax.Array
                            ) -> jax.Array:
    """(Nq, B) x (Nt, B) {0,1} bits -> (Nq, Nt) i32 Hamming distances via a
    bf16 matmul (exact: 0/1 operands, f32 accumulation). B is the descriptor bit width (256 for ORB)."""
    q = query_bits.astype(jnp.bfloat16)
    t = train_bits.astype(jnp.bfloat16)
    dot = jax.lax.dot_general(
        q, t, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)          # (Nq, Nt)
    pq = jnp.sum(query_bits.astype(jnp.int32), axis=1)   # (Nq,)
    pt = jnp.sum(train_bits.astype(jnp.int32), axis=1)   # (Nt,)
    d = pq[:, None] + pt[None, :] - 2 * dot.astype(jnp.int32)
    return d


@partial(jax.jit, static_argnames=("k",))
def knn_match(query_bits: jax.Array, train_bits: jax.Array,
              query_valid: jax.Array | None = None,
              train_valid: jax.Array | None = None, k: int = 2) -> Matches:
    """K nearest train descriptors per query. Output layout (K, Nq) matches
    the reference's Mat<CompVDMatch>(knn x Nq) (matcher_bruteforce.cxx:104)."""
    d = hamming_distance_matrix(query_bits, train_bits)
    big = jnp.int32(1 << 30)
    if train_valid is not None:
        d = jnp.where(train_valid[None, :], d, big)
    neg = -d
    vals, idx = jax.lax.top_k(neg, k)        # (Nq, k)
    dist = (-vals).astype(jnp.float32)
    valid = vals > -big
    if query_valid is not None:
        valid = valid & query_valid[:, None]
    return Matches(train_idx=idx.T.astype(jnp.int32),
                   distance=jnp.where(valid, dist, jnp.inf).T,
                   valid=valid.T)


def match_bruteforce(query_bits: jax.Array, train_bits: jax.Array,
                     config: MatcherConfig = MatcherConfig(),
                     query_valid: jax.Array | None = None,
                     train_valid: jax.Array | None = None) -> Matches:
    """Facade matching CompVMatcherBruteForce::process
    (matcher_bruteforce.cxx:81). cross_check applies only for knn=1
    (same restriction as the reference, :59-66)."""
    m = knn_match(query_bits, train_bits, query_valid, train_valid, config.knn)
    if config.cross_check and config.knn == 1:
        rev = knn_match(train_bits, query_bits, train_valid, query_valid, 1)
        nq = query_bits.shape[0]
        qidx = jnp.arange(nq, dtype=jnp.int32)
        mutual = rev.train_idx[0][m.train_idx[0]] == qidx
        m = Matches(train_idx=m.train_idx,
                    distance=jnp.where(mutual[None, :], m.distance, jnp.inf),
                    valid=m.valid & mutual[None, :])
    return m


def ratio_test(matches: Matches, ratio: float = 0.67) -> jax.Array:
    """Lowe ratio test mask over queries: d1 < ratio * d2 (the object-
    recognition sample uses 0.67, samples/object_recognition/main.cxx:185).
    Requires knn >= 2. Returns (Nq,) bool."""
    d1 = matches.distance[0]
    d2 = matches.distance[1]
    ok = matches.valid[0] & matches.valid[1] & (d1 < ratio * d2)
    return ok
