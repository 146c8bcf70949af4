"""Homography estimation: normalized DLT + batched-hypothesis RANSAC.

Reference: CompVHomography<T>::find (core/calib/compv_core_calib_homography.cxx:60)
— per-thread RANSAC chains over 4-point samples with colinearity rejection,
inlier count via symmetric transfer error (:498, threshold 30 px^2 units,
:27-28), adaptive iteration budget from the inlier ratio with p=0.995 (:203),
then a final DLT re-solve on all inliers; computeH (:346) = Hartley
normalization -> 2Nx9 DLT matrix (buildHomographyEqMatrix,
base/math/compv_math_matrix.cxx:1051) -> MtM -> Jacobi eigen smallest
eigenvector -> denormalize -> h22-normalize.

Design (SURVEY.md §2.6 item 5): instead of thread-racing sequential
chains, ALL hypotheses are evaluated at once — sample (S, 4) point subsets
with jax.random, solve each 4-point system in CLOSED FORM (projective-basis
construction, _h_from_quad — cheaper than a vmapped 9x9 eigh per
hypothesis), score all S x N transfer errors as one batched
einsum, argmax inliers. The adaptive-budget while_loop is unnecessary at
S≈512 hypotheses (p=0.995 needs ~72 iters at 50% inliers); a fixed S both
fills the device and keeps shapes static. The final all-inlier refine
keeps the normalized DLT (one eigh; jnp.linalg.eigh is XLA-native and
replaces the reference's Jacobi port).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from compv_tpu.math.stats import hartley_normalize
from compv_tpu.math.transform import apply_homography
from compv_tpu.precision import geometry

__all__ = ["HomographyConfig", "HomographyResult", "compute_homography_dlt",
           "find_homography", "symmetric_transfer_error"]


@dataclass(frozen=True)
class HomographyConfig:
    """Defaults per the reference (calib_homography.cxx:27-28, :203)."""
    num_hypotheses: int = 512
    threshold: float = 30.0       # squared-pixel symmetric transfer threshold
    seed: int = 0
    refine: bool = True           # final DLT on all inliers


class HomographyResult(NamedTuple):
    h: jax.Array           # (3, 3) f32, h22-normalized
    inliers: jax.Array     # (N,) bool
    num_inliers: jax.Array  # () i32


def _dlt_rows(src: jax.Array, dst: jax.Array) -> jax.Array:
    """Build the 2N x 9 DLT system rows for H mapping src->dst
    (buildHomographyEqMatrix, compv_math_matrix.cxx:1051-1061)."""
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([-x, -y, -o, z, z, z, u * x, u * y, u], axis=1)
    r2 = jnp.stack([z, z, z, -x, -y, -o, v * x, v * y, v], axis=1)
    return jnp.concatenate([r1, r2], axis=0)  # (2N, 9)


@geometry
def compute_homography_dlt(src: jax.Array, dst: jax.Array,
                           mask: jax.Array | None = None) -> jax.Array:
    """Normalized DLT: returns (3,3) H with H[2,2]=1 mapping src->dst.
    ``mask`` selects the points participating (padded sets supported);
    masked-out rows are zeroed in the normal equations."""
    n = src.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    src_n, t_src = hartley_normalize(src, mask)
    dst_n, t_dst = hartley_normalize(dst, mask)
    a = _dlt_rows(src_n, dst_n)                       # (2N, 9)
    m2 = jnp.concatenate([mask, mask]).astype(a.dtype)[:, None]
    a = a * m2
    ata = a.T @ a                                      # (9, 9)
    _, vecs = jnp.linalg.eigh(ata)                     # ascending eigenvalues
    hvec = vecs[:, 0]                                  # smallest
    hn = hvec.reshape(3, 3)
    h = jnp.linalg.inv(t_dst) @ hn @ t_src             # denormalize
    h22 = h[2, 2]
    h22 = jnp.where(jnp.abs(h22) < 1e-12, 1e-12, h22)
    return h / h22


def _inv3x3(m: jax.Array) -> jax.Array:
    """Closed-form adjugate 3x3 inverse (batched-friendly; no LU loop)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, hh, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * hh
    cb = f * g - d * i
    cc = d * hh - e * g
    det = a * ca + b * cb + c * cc
    det = jnp.where(jnp.abs(det) < 1e-20, jnp.inf, det)
    adj = jnp.stack([
        jnp.stack([ca, c * hh - b * i, b * f - c * e], -1),
        jnp.stack([cb, a * i - c * g, c * d - a * f], -1),
        jnp.stack([cc, b * g - a * hh, a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def _h_from_quad(src4: jax.Array, dst4: jax.Array) -> jax.Array:
    """Exact homography through 4 point pairs via the projective-basis
    construction: A(q) = [q1 q2 q3] * diag(inv([q1 q2 q3]) @ q4) maps the
    canonical basis onto quad q, so H = A(dst) @ A(src)^-1 — two
    closed-form 3x3 adjugate inverses instead of the 9x9 eigh the DLT
    needs (a vmapped 512-hypothesis eigh measured ~8 ms/frame at 720p;
    this form is a few fused VPU ops). Similarity-normalized per quad
    (centroid/RMS, like Hartley) to keep f32 conditioning at 4k coords."""

    def norm(q):
        c = jnp.mean(q, axis=0)
        s = jnp.sqrt(jnp.mean(jnp.sum((q - c) ** 2, axis=1)) + 1e-12)
        return (q - c) / s, c, s

    def basis(q):
        m = jnp.stack([q[:3, 0], q[:3, 1], jnp.ones((3,), q.dtype)], 0)
        p4 = jnp.stack([q[3, 0], q[3, 1], jnp.asarray(1.0, q.dtype)])
        lam = _inv3x3(m) @ p4
        return m * lam[None, :]

    s_n, sc, ss = norm(src4)
    d_n, dc, ds = norm(dst4)
    hn = basis(d_n) @ _inv3x3(basis(s_n))
    # denormalize: H = T_dst^-1 @ Hn @ T_src, both similarities
    t_src = jnp.array([[1.0, 0.0, -sc[0]], [0.0, 1.0, -sc[1]],
                       [0.0, 0.0, ss]], src4.dtype) / ss
    t_dst_inv = jnp.array([[ds, 0.0, dc[0]], [0.0, ds, dc[1]],
                           [0.0, 0.0, 1.0]], dst4.dtype)
    h = t_dst_inv @ hn @ t_src
    h22 = h[2, 2]
    h22 = jnp.where(jnp.abs(h22) < 1e-12, 1e-12, h22)
    return h / h22


@geometry
def symmetric_transfer_error(h: jax.Array, src: jax.Array, dst: jax.Array
                             ) -> jax.Array:
    """Per-point d(H src, dst)^2 + d(H^-1 dst, src)^2 (countInliers,
    calib_homography.cxx:498)."""
    fwd = apply_homography(h, src)
    hinv = _inv3x3(h + 1e-12 * jnp.eye(3, dtype=h.dtype))
    bwd = apply_homography(hinv, dst)
    e_f = jnp.sum((fwd - dst) ** 2, axis=1)
    e_b = jnp.sum((bwd - src) ** 2, axis=1)
    return e_f + e_b


def _masked_sample_idx(key: jax.Array, mask: jax.Array, s: int, k: int
                       ) -> jax.Array:
    """(s, k) random indices drawn WITHOUT replacement from valid positions
    of ``mask`` (the reference's PRNG sampler also rejects duplicate rows,
    calib_homography.cxx:188-246). Permutation-top-k trick: per hypothesis,
    draw N uniforms, sink invalid points to -1, take the k largest — a
    uniformly random k-subset of the valid indices, distinct by
    construction. If fewer than k points are valid the sample contains
    invalid points and the hypothesis loses at scoring."""
    n = mask.shape[0]
    u = jax.random.uniform(key, (s, n))
    u = jnp.where(mask[None, :], u, -1.0)
    _, idx = jax.lax.top_k(u, k)
    return idx


def _quad_nondegenerate(p4: jax.Array) -> jax.Array:
    """True when no 3 of the 4 sample points are (nearly) colinear — the
    reference rejects such samples before solving (calib_homography.cxx:
    188-246). Scale-relative cross-product test over all 4 triples."""
    i = jnp.array([0, 0, 0, 1])
    j = jnp.array([1, 1, 2, 2])
    l = jnp.array([2, 3, 3, 3])
    a = p4[j] - p4[i]
    b = p4[l] - p4[i]
    cross = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    scale = jnp.maximum(jnp.sum(a * a, axis=1) + jnp.sum(b * b, axis=1),
                        1e-12)
    return jnp.all(jnp.abs(cross) > 1e-5 * scale)


@partial(jax.jit, static_argnames=("config",))
@geometry
def find_homography(src: jax.Array, dst: jax.Array,
                    mask: jax.Array | None = None,
                    config: HomographyConfig = HomographyConfig()
                    ) -> HomographyResult:
    """RANSAC homography over padded point sets (N, 2) + validity mask.

    All hypotheses evaluated in parallel; winner = most inliers with total
    residual as tie-break (reference uses variance tie-break,
    calib_homography.cxx:130-158)."""
    n = src.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    src = src.astype(jnp.float32)
    dst = dst.astype(jnp.float32)

    key = jax.random.PRNGKey(config.seed)
    idx = _masked_sample_idx(key, mask, config.num_hypotheses, 4)  # (S, 4)

    def solve_one(sample_idx):
        s4 = src[sample_idx]
        d4 = dst[sample_idx]
        return _h_from_quad(s4, d4)

    hs = jax.vmap(solve_one)(idx)                                  # (S, 3, 3)
    # hypothesis hygiene: reject colinear samples and degenerate solutions
    # (reference: colinearity reject + zero-H guard,
    # calib_homography.cxx:188-246)
    samp_ok = (jax.vmap(_quad_nondegenerate)(src[idx])
               & jax.vmap(_quad_nondegenerate)(dst[idx])
               & jnp.all(mask[idx], axis=1))
    h_ok = jnp.all(jnp.isfinite(hs), axis=(1, 2))
    hyp_ok = samp_ok & h_ok
    errs = jax.vmap(lambda h: symmetric_transfer_error(h, src, dst))(hs)
    errs = jnp.where(jnp.isfinite(errs), errs, jnp.inf)            # (S, N)
    inl = (errs < config.threshold) & mask[None, :] & hyp_ok[:, None]
    counts = jnp.sum(inl, axis=1)
    # tie-break: lower summed inlier error
    score = counts.astype(jnp.float32) - 1e-9 * jnp.sum(
        jnp.where(inl, errs, 0.0), axis=1)
    score = jnp.where(hyp_ok, score, -jnp.inf)
    best = jnp.argmax(score)
    best_h = hs[best]
    best_inl = inl[best]

    if config.refine:
        h_ref = compute_homography_dlt(src, dst, best_inl)
        e_ref = symmetric_transfer_error(h_ref, src, dst)
        inl_ref = (e_ref < config.threshold) & mask
        better = jnp.sum(inl_ref) >= jnp.sum(best_inl)
        best_h = jnp.where(better, h_ref, best_h)
        best_inl = jnp.where(better, inl_ref, best_inl)

    return HomographyResult(h=best_h, inliers=best_inl,
                            num_inliers=jnp.sum(best_inl).astype(jnp.int32))
