"""Bundle adjustment via explicit Schur-complement reduction.

The BASELINE north star names "distributed Schur-complement reduction of the
camera system": landmarks are eliminated analytically (their 3x3 Hessian
blocks invert in closed form) and the reduced camera system
S = Hcc - W Hll^-1 W^T is solved densely.

Formulation (W is never materialized as a dense (F, L, 6, 3) array, which
would be ~368 MB at 256 cams / 20k landmarks):

  * observations are grouped per landmark through a padded (L, K) index
    table built from one sort + searchsorted + gather (K = max obs per
    landmark, a STATIC cap supplied by the host-side wrappers) — so
    Hll, gl, the per-obs cross blocks U = Jc^T Jl, and the back-
    substitution are pure dense einsums with no scatters;
  * the reduced system S = Hcc - sum_l W_l Y_l W_l^T is accumulated over
    landmark CHUNKS inside a lax.scan: each chunk builds its (Lc, K, F)
    camera one-hot and contracts W_chunk/Z_chunk against each other as
    matmuls, so peak memory is O(Lc*F*18 + F^2*36), never O(F*L*18);
  * Hcc and gc are single index-adds over observations, done once per
    step.

Distributed: every accumulated term is a sum over observations, so
sharding observations and psumming partials reproduces the dense system
exactly. The W-chunks must be psum'd BEFORE the W Y W^T outer product
(cross terms couple observations of one landmark on different shards);
that is correct for arbitrary obs sharding but moves L*F*18 floats per
step. When the obs sharding is landmark-partitioned (each landmark's
observations on one shard), set lm_partitioned=True: the outer products
become shard-local and only S itself (F^2*36) is psum'd.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.slam.ba import (BAProblem, ba_residuals,
                               inv3x3_spd, obs_jacobian_blocks)
from compv_tpu.precision import geometry

__all__ = ["SchurConfig", "ba_step_schur", "ba_solve_schur",
           "max_obs_per_landmark"]


@dataclass(frozen=True)
class SchurConfig:
    iterations: int = 10
    damping: float = 1e-3
    lm_chunk: int = 512          # landmarks eliminated per scan step
    lm_partitioned: bool = False  # obs sharding keeps each lm on one shard
    robust_delta: float = 0.0    # IRLS (Cauchy-like) whitening, matching
                                 # BAConfig.robust_delta — without it a
                                 # Schur-driven SfM run lets outliers pull
                                 # weakly-constrained bending modes (12-fr
                                 # probe: ATE 4.8% of span vs 0.5% robust)


def max_obs_per_landmark(lm_idx, valid, num_landmarks: int) -> int:
    """Host-side helper: the static per-landmark observation cap the Schur
    step needs. Rounded up to a multiple of 4 to limit recompiles across
    problems of similar shape."""
    li = np.asarray(lm_idx)[np.asarray(valid)]
    k = int(np.bincount(li, minlength=num_landmarks).max()) if li.size else 1
    return max(4, -4 * (-k // 4))


def _obs_of_lm_table(lm_idx, valid, l: int, k: int, o: int):
    """(L, K) table of observation indices per landmark (pad = o, pointing
    at an appended zero row). Gather-only: sort obs by landmark, find each
    landmark's segment start by searchsorted, take start+j for j<count."""
    key = jnp.where(valid, lm_idx, l)          # invalid -> pad segment
    order = jnp.argsort(key, stable=True)
    key_sorted = key[order]
    starts = jnp.searchsorted(key_sorted, jnp.arange(l), side="left")
    counts = jnp.searchsorted(key_sorted, jnp.arange(l), side="right") - starts
    pos = starts[:, None] + jnp.arange(k)[None, :]          # (L, K)
    in_seg = jnp.arange(k)[None, :] < counts[:, None]
    order_pad = jnp.concatenate([order, jnp.full((1,), o, order.dtype)])
    return jnp.where(in_seg, order_pad[jnp.minimum(pos, o)], o), counts


@geometry
def ba_step_schur(prob: BAProblem, lam: jax.Array, cfg: SchurConfig,
                  psum_axis: str | None = None, *, max_obs_per_lm: int = 16,
                  cam_mask=None):
    """One damped-GN step with explicit Schur elimination of landmarks.
    Camera 0 is gauge-fixed. Returns (new prob, new lam, cost_before).

    ``max_obs_per_lm`` is a STATIC cap; observations beyond it for any
    landmark are silently dropped from the step (use the
    max_obs_per_landmark helper / ba_solve_schur wrapper to size it from
    data so nothing is dropped)."""
    f = prob.cameras.shape[0]
    l = prob.landmarks.shape[0]
    o = prob.cam_idx.shape[0]
    k = max_obs_per_lm
    dtype = prob.cameras.dtype

    def psum(x):
        return jax.lax.psum(x, psum_axis) if psum_axis is not None else x

    r, jc, jl = obs_jacobian_blocks(prob.cameras, prob.landmarks,
                                    prob.intrinsics, prob.cam_idx,
                                    prob.lm_idx, prob.uv, prob.valid)
    w = None
    if cfg.robust_delta > 0:
        d2 = jnp.asarray(cfg.robust_delta, r.dtype) ** 2
        w = jnp.sqrt(d2 / (d2 + jnp.sum(r * r, axis=1)))
        r = r * w[:, None]
        jc = jc * w[:, None, None]
        jl = jl * w[:, None, None]
    cost = psum(jnp.sum(r * r))

    # landmark-side observation table, built first so the camera-side
    # index-adds can exclude observations the static cap `k` drops —
    # otherwise Hcc/gc would include terms the Hll/W side never saw and
    # the normal equations would be silently inconsistent
    table, counts = _obs_of_lm_table(prob.lm_idx, prob.valid, l, k, o)
    kept = jnp.zeros((o + 1,), bool).at[table.ravel()].set(True)[:o]
    jc_k = jnp.where(kept[:, None, None], jc, 0.0)
    r_k = jnp.where(kept[:, None], r, 0.0)

    # camera-side terms: one index-add over observations each
    hcc = jnp.zeros((f, 6, 6), dtype).at[prob.cam_idx].add(
        jnp.einsum("oia,oib->oab", jc_k, jc_k))
    gc = jnp.zeros((f, 6), dtype).at[prob.cam_idx].add(
        jnp.einsum("oia,oi->oa", jc_k, r_k))
    hcc, gc = psum(hcc), psum(gc)
    zpad = lambda x: jnp.concatenate(
        [x, jnp.zeros((1,) + x.shape[1:], x.dtype)])
    jc_l = zpad(jc)[table]                     # (L, K, 2, 6)
    jl_l = zpad(jl)[table]                     # (L, K, 2, 3)
    r_l = zpad(r)[table]                       # (L, K, 2)
    cam_l = jnp.concatenate(
        [prob.cam_idx, jnp.full((1,), f, jnp.int32)])[table]  # (L, K), pad=f

    hll = psum(jnp.einsum("lkia,lkib->lab", jl_l, jl_l))      # (L, 3, 3)
    gl = psum(jnp.einsum("lkia,lki->la", jl_l, r_l))          # (L, 3)
    u = jnp.einsum("lkia,lkib->lkab", jc_l, jl_l)             # (L, K, 6, 3)

    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    hcc_d = hcc + lam * eye6[None]
    y = inv3x3_spd(hll + lam * eye3[None])                   # (L, 3, 3)
    z = jnp.einsum("lkab,lbc->lkac", u, y)                    # (L, K, 6, 3)

    # ---- reduced camera system, accumulated over landmark chunks
    lc = min(cfg.lm_chunk, l)
    nchunk = -(-l // lc)
    lpad = nchunk * lc
    def padl(x):
        return jnp.concatenate(
            [x, jnp.zeros((lpad - l,) + x.shape[1:], x.dtype)]) \
            if lpad != l else x
    u_c = padl(u).reshape(nchunk, lc, k, 6, 3)
    z_c = padl(z).reshape(nchunk, lc, k, 6, 3)
    gl_c = padl(gl).reshape(nchunk, lc, 3)
    cam_c = padl(jnp.where(cam_l < f, cam_l, f)).reshape(nchunk, lc, k)

    def chunk_body(carry, xs):
        s_acc, rhs_acc = carry
        uc, zc, glc, cc = xs
        onehot = (cc[:, :, None] ==
                  jnp.arange(f)[None, None, :]).astype(dtype)  # (lc, K, F)
        # one-hot contractions are gathers-by-matmul: HIGHEST keeps them
        # exact (a default-precision f32 dot may round the blocks)
        w_ch = jnp.einsum("pkf,pkab->pfab", onehot, uc,
                          precision=jax.lax.Precision.HIGHEST)
        z_ch = jnp.einsum("pkf,pkab->pfab", onehot, zc,
                          precision=jax.lax.Precision.HIGHEST)
        if psum_axis is not None and not cfg.lm_partitioned:
            # cross-shard coupling: W_l sums obs across shards, and
            # W Y W^T is bilinear — reduce BEFORE the outer product
            w_ch = jax.lax.psum(w_ch, psum_axis)
            z_ch = jax.lax.psum(z_ch, psum_axis)
        # the W Y W^T products are real arithmetic: they run at the
        # library's f32 policy (compv_tpu/precision.py); at HIGH the
        # H100's reduced-precision passes left the first step's cost 0.65%
        # above the CPU's (256 cams / 20k landmarks)
        s_acc = s_acc - jnp.einsum("pfab,pgcb->fagc", z_ch, w_ch)
        rhs_acc = rhs_acc - jnp.einsum("pfab,pb->fa", z_ch, glc)
        return (s_acc, rhs_acc), None

    s0 = jnp.zeros((f, 6, f, 6), dtype)
    (s_off, rhs_red), _ = jax.lax.scan(
        chunk_body, (s0, jnp.zeros((f, 6), dtype)),
        (u_c, z_c, gl_c, cam_c))
    if psum_axis is not None and cfg.lm_partitioned:
        # non-owning shards saw zero obs for each landmark, so their z_ch
        # (hence their S / rhs contributions) are exactly zero — a plain
        # psum sums each landmark's contribution exactly once
        s_off = jax.lax.psum(s_off, psum_axis)
        rhs_red = jax.lax.psum(rhs_red, psum_axis)

    s = s_off.transpose(0, 2, 1, 3)                            # (F, F, 6, 6)
    s = s.at[jnp.arange(f), jnp.arange(f)].add(hcc_d)
    rhs_c = gc + rhs_red

    # gauge: pin camera 0 (identity block, zero rhs) — plus every camera
    # cam_mask freezes (windowed BA: frozen past cameras anchor the
    # window's gauge)
    pin = jnp.zeros((f,), bool).at[0].set(True)
    if cam_mask is not None:
        pin = pin | ~cam_mask
    keep = (~pin).astype(dtype)
    s = s * keep[:, None, None, None] * keep[None, :, None, None]
    s = s.at[jnp.arange(f), jnp.arange(f)].add(
        eye6[None] * pin.astype(dtype)[:, None, None])
    rhs_c = rhs_c * keep[:, None]

    # S is symmetric positive definite after damping + gauge pinning:
    # Cholesky solve (jnp.linalg.solve would LU-factor: ~2x the flops and
    # a pivoted factorization)
    s_mat = s.transpose(0, 2, 1, 3).reshape(6 * f, 6 * f)
    chol = jax.scipy.linalg.cho_factor(s_mat)
    dx_c = -jax.scipy.linalg.cho_solve(
        chol, rhs_c.reshape(-1)).reshape(f, 6)

    # back-substitute landmarks: dl = -Y (gl + W^T dx_c), with W^T dx_c
    # gathered per padded observation slot (pad camera f -> zero row)
    dc_pad = jnp.concatenate([dx_c, jnp.zeros((1, 6), dtype)])
    wt_dx = psum(jnp.einsum("lkab,lka->lb", u, dc_pad[cam_l]))  # (L, 3)
    dx_l = -jnp.einsum("lab,lb->la", y, gl + wt_dx)

    cams1 = prob.cameras + dx_c
    lms1 = prob.landmarks + dx_l
    r1 = ba_residuals(cams1, lms1, prob)
    if w is not None:
        r1 = r1 * w[:, None]          # frozen IRLS weights, like ba_step
    cost1 = psum(jnp.sum(r1 * r1))
    better = cost1 < cost
    cams = jnp.where(better, cams1, prob.cameras)
    lms = jnp.where(better, lms1, prob.landmarks)
    lam_new = jnp.where(better, lam * 0.5, lam * 4.0)
    return prob._replace(cameras=cams, landmarks=lms), lam_new, cost


@partial(jax.jit, static_argnames=("cfg", "max_obs_per_lm"))
@geometry
def _solve_jit(prob, cfg, max_obs_per_lm, cam_mask=None):
    def body(_, state):
        p, lam, _ = state
        return ba_step_schur(p, lam, cfg, max_obs_per_lm=max_obs_per_lm,
                             cam_mask=cam_mask)

    init = (prob, jnp.asarray(cfg.damping, prob.cameras.dtype),
            jnp.asarray(0.0, prob.cameras.dtype))
    p, lam, cost = jax.lax.fori_loop(0, cfg.iterations, body, init)
    r = ba_residuals(p.cameras, p.landmarks, p)
    return p, jnp.sum(r * r)


def ba_solve_schur(prob: BAProblem, cfg: SchurConfig = SchurConfig(),
                   cam_mask=None):
    """Damped-GN loop with Schur steps. Returns (problem, final cost).
    Host-side wrapper: sizes the static per-landmark cap from the data so
    no observation is dropped, then runs the jitted loop. ``cam_mask``
    (F,) bool freezes the False cameras (windowed BA)."""
    k = max_obs_per_landmark(prob.lm_idx, prob.valid,
                             prob.landmarks.shape[0])
    return _solve_jit(prob, cfg, k, cam_mask)
