"""Bundle adjustment.

The reference has no BA — its closest machinery is Levenberg-Marquardt over
calibration params via vendored lmfit (core/calib/compv_core_calib_camera.cxx:1028)
and per-thread RANSAC reductions. BASELINE.json's north star requires a
distributed BA: keyframes/observations sharded per chip, shard-local
residual/Jacobian products, psum'd reduction of the camera system.

Design (idiomatic JAX, scaling-book style):
  * state  : cameras (F, 6) [rodrigues rvec | tvec], landmarks (L, 3),
             shared intrinsics (fx, fy, cx, cy).
  * obs    : fixed-capacity padded arrays cam_idx (O,), lm_idx (O,),
             uv (O, 2), valid (O,).
  * solver : damped Gauss-Newton; the normal system (J^T J + lam I) dx = -J^T r
             is solved matrix-free with CG (optionally block-Jacobi PCG).
             The Jacobian is linearized ONCE per GN step into explicit
             per-observation 2x6 / 2x3 blocks (obs_jacobian_blocks, one
             vmapped jacfwd pass); each CG matvec is then einsums over
             those blocks with gathers and index-adds on both the camera
             and the landmark side — no reverse-mode AD inside the CG
             loop, no sparse bookkeeping.
  * distributed: observations are sharded over the mesh "frame" axis inside
    shard_map; every J^T (.) / J (.) product psums partial results so each
    device holds the full (replicated) parameter update — the classic
    data-parallel gradient pattern applied to GN. Deterministic: psum order
    fixed by the mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from compv_tpu.precision import geometry

__all__ = ["BAProblem", "BAConfig", "rodrigues_to_matrix", "matrix_to_rodrigues",
           "project_points", "ba_residuals", "ba_solve", "ba_step",
           "ba_step_reduce_scatter", "reproj_rmse", "obs_jacobian_blocks"]


# ----------------------------------------------------------------- rotations

def rodrigues_to_matrix(rvec: jax.Array) -> jax.Array:
    """Axis-angle (3,) -> rotation matrix (3,3). Reference:
    CompVMathTrig::rodriguesVectorToMatrix (compv_math_trig.h:22-35).

    Gradient-safe at theta=0 via the double-where pattern: both branch
    inputs are made finite BEFORE the select, so reverse-mode AD never sees
    an inf/NaN from the untaken branch (the classic jnp.where-grad trap)."""
    theta2 = jnp.sum(rvec * rvec)
    small = theta2 < 1e-12
    theta2_safe = jnp.where(small, 1.0, theta2)   # safe for sqrt/grad
    theta = jnp.sqrt(theta2_safe)
    # sin(t)/t and (1-cos t)/t^2 with series fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / theta2_safe)
    wx, wy, wz = rvec[0], rvec[1], rvec[2]
    km = jnp.array([[0.0, -wz, wy], [wz, 0.0, -wx], [-wy, wx, 0.0]],
                   rvec.dtype)
    return jnp.eye(3, dtype=rvec.dtype) + a * km + b * (km @ km)


def matrix_to_rodrigues(r: jax.Array) -> jax.Array:
    """Rotation matrix -> axis-angle (reference rodriguesMatrixToVector).

    Three branches, all select-safe: small angle (series), general
    (w * theta / 2 sin theta), and near-pi — where w = vee(R - R^T) ~ 0 and
    the general formula degenerates to 0 * inf; there the axis is recovered
    from the diagonal of (R + I)/2 with signs from the dominant row."""
    tr = jnp.trace(r)
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(jnp.clip(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))
    w = jnp.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]],
                  r.dtype)
    small = theta < 1e-4
    near_pi = cos_t < -0.999
    theta_safe = jnp.where(small | near_pi, 1.0, theta)
    scale = jnp.where(small, 0.5 + theta * theta / 12.0,
                      theta_safe / (2.0 * jnp.sin(theta_safe)))
    rvec_general = w * scale

    # near-pi: axis magnitudes from diag((R+I)/2), signs from dominant row
    b = (r + jnp.eye(3, dtype=r.dtype)) * 0.5
    axis = jnp.sqrt(jnp.clip(jnp.diagonal(b), 0.0, 1.0))
    k = jnp.argmax(axis)
    row = b[k, :]
    signs = jnp.where(jnp.arange(3) == k, 1.0,
                      jnp.where(row >= 0, 1.0, -1.0))
    axis_n = axis * signs
    axis_n = axis_n / jnp.maximum(jnp.linalg.norm(axis_n), 1e-12)
    theta_pi = jnp.arccos(jnp.clip(cos_t, -1.0, 1.0))  # exact up to pi
    rvec_pi = axis_n * theta_pi

    return jnp.where(near_pi, rvec_pi, rvec_general)


# ----------------------------------------------------------------- projection

class BAProblem(NamedTuple):
    cameras: jax.Array     # (F, 6) [rvec | tvec]
    landmarks: jax.Array   # (L, 3)
    intrinsics: jax.Array  # (4,) fx, fy, cx, cy
    cam_idx: jax.Array     # (O,) i32
    lm_idx: jax.Array      # (O,) i32
    uv: jax.Array          # (O, 2) observed pixels
    valid: jax.Array       # (O,) bool


@dataclass(frozen=True)
class BAConfig:
    iterations: int = 10        # outer damped-GN iterations
    cg_iterations: int = 20     # inner CG iterations per GN step
    damping: float = 1e-3       # initial LM lambda
    optimize_landmarks: bool = True
    optimize_cameras: bool = True
    robust_delta: float = 0.0   # >0: IRLS Cauchy-like down-weighting of
                                # observations with residual norm >> delta px
                                # (weights frozen per GN step, re-derived
                                # from the step's entry residual)
    precondition: bool = False  # block-Jacobi PCG: per-camera 6x6 and
                                # per-landmark 3x3 diagonal blocks of
                                # J^T J + lam, inverted per step. Helps on
                                # small dense problems (tests/test_ba.py:
                                # CG=30 quality at 15 iters) but HURTS at
                                # sparse production scale (256 cams/100k
                                # obs: rmse 0.38 vs 0.05 after 10 GN
                                # steps — few-observation landmark
                                # blocks are near-singular and the
                                # inverse amplifies their noise), so it
                                # stays opt-in. Supported in ba_step
                                # (incl. psum mode); the reduce-scatter
                                # variant ignores it.


@geometry
def project_points(cameras: jax.Array, landmarks: jax.Array,
                   intrinsics: jax.Array, cam_idx: jax.Array,
                   lm_idx: jax.Array) -> jax.Array:
    """(O, 2) projected pixels for each observation. Batched pinhole:
    u = fx * x/z + cx (no distortion here; calib/utils handles distortion)."""
    rvecs = cameras[cam_idx, :3]           # (O, 3)
    tvecs = cameras[cam_idx, 3:]           # (O, 3)
    pts = landmarks[lm_idx]                # (O, 3)
    rms = jax.vmap(rodrigues_to_matrix)(rvecs)       # (O, 3, 3)
    pc = jnp.einsum("oij,oj->oi", rms, pts) + tvecs  # (O, 3)
    z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    u = fx * pc[:, 0] / z + cx
    v = fy * pc[:, 1] / z + cy
    return jnp.stack([u, v], axis=1)


@geometry
def ba_residuals(cameras: jax.Array, landmarks: jax.Array, prob: BAProblem
                 ) -> jax.Array:
    """(O, 2) masked reprojection residuals. First camera is gauge-fixed by
    the solver (its update is zeroed), not here."""
    pred = project_points(cameras, landmarks, prob.intrinsics,
                          prob.cam_idx, prob.lm_idx)
    r = pred - prob.uv
    return jnp.where(prob.valid[:, None], r, 0.0)


def reproj_rmse(prob: BAProblem) -> jax.Array:
    r = ba_residuals(prob.cameras, prob.landmarks, prob)
    n = jnp.maximum(jnp.sum(prob.valid), 1)
    return jnp.sqrt(jnp.sum(r * r) / (2.0 * n))


# ----------------------------------------------------------------- blocks

@geometry
def obs_jacobian_blocks(cameras, landmarks, intrinsics, cam_idx, lm_idx,
                        uv, valid):
    """Per-observation residual + Jacobian blocks: r (O,2), A = dr/dcam
    (O,2,6), B = dr/dlm (O,2,3), zeroed at invalid observations. One
    vmapped jacfwd over the 9 parameters each observation touches — a
    single fused elementwise pass, computed ONCE per GN step, so the CG
    loop never re-traces AD (a jvp/vjp per matvec would re-linearize the
    whole residual every CG iteration)."""

    def one(cam, lm, uv1):
        def f(c, x):
            r = rodrigues_to_matrix(c[:3])
            pc = r @ x + c[3:]
            z = jnp.where(jnp.abs(pc[2]) < 1e-9, 1e-9, pc[2])
            u = intrinsics[0] * pc[0] / z + intrinsics[2]
            v = intrinsics[1] * pc[1] / z + intrinsics[3]
            return jnp.stack([u, v]) - uv1
        return f(cam, lm), jax.jacfwd(f, 0)(cam, lm), jax.jacfwd(f, 1)(cam, lm)

    r, a, b = jax.vmap(one)(cameras[cam_idx], landmarks[lm_idx], uv)
    m2 = valid[:, None]
    m3 = valid[:, None, None]
    return (jnp.where(m2, r, 0.0), jnp.where(m3, a, 0.0),
            jnp.where(m3, b, 0.0))


# ----------------------------------------------------------------- solver

def _flatten(cams, lms):
    return jnp.concatenate([cams.ravel(), lms.ravel()])


def _unflatten(x, f, l):
    return x[: f * 6].reshape(f, 6), x[f * 6:].reshape(l, 3)


def _gauge_mask(f: int, l: int, cfg: BAConfig, dtype,
                cam_mask=None) -> jax.Array:
    """Parameter-space mask: gauge-fix camera 0 (and optionally freeze
    cameras or landmarks entirely). ``cam_mask`` (F,) bool freezes the
    False cameras — the windowed-BA primitive (frozen past cameras anchor
    the gauge of a sliding window)."""
    cam_m = jnp.ones((f, 6), dtype)
    cam_m = cam_m.at[0].set(0.0)  # fix the first camera (gauge freedom)
    if cam_mask is not None:
        cam_m = cam_m * cam_mask.astype(dtype)[:, None]
    if not cfg.optimize_cameras:
        cam_m = jnp.zeros((f, 6), dtype)
    lm_m = (jnp.ones if cfg.optimize_landmarks else jnp.zeros)((l, 3), dtype)
    return _flatten(cam_m, lm_m)


def _linearize(prob: BAProblem, cfg: BAConfig):
    """Entry residuals + Jacobian blocks for one GN step, IRLS-whitened
    when cfg.robust_delta > 0 (Cauchy-like weights w = delta /
    sqrt(delta^2 + |r|^2) from the step's entry residuals, FROZEN for the
    step — the standard IRLS linearization). Returns (r0 (O,2), A (O,2,6),
    B (O,2,3), w (O,)); all already valid-masked."""
    r, a, b = obs_jacobian_blocks(prob.cameras, prob.landmarks,
                                  prob.intrinsics, prob.cam_idx,
                                  prob.lm_idx, prob.uv, prob.valid)
    if cfg.robust_delta <= 0:
        return r, a, b, None
    d2 = jnp.asarray(cfg.robust_delta, r.dtype) ** 2
    w = jnp.sqrt(d2 / (d2 + jnp.sum(r * r, axis=1)))
    return (r * w[:, None], a * w[:, None, None], b * w[:, None, None], w)


def inv3x3_spd(m):
    """Batched closed-form (adjugate) 3x3 inverse for damped SPD blocks
    (det > 0 by construction). Pure elementwise math — jnp.linalg.inv
    would lower to a batched LU of 3x3 blocks at L ~ 2e4. Shared by the
    Schur solver and the PCG preconditioner."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = f * g - d * i
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    inv_det = 1.0 / det
    adj = jnp.stack([
        jnp.stack([ca, c * h - b * i, b * f - c * e], -1),
        jnp.stack([cb, a * i - c * g, c * d - a * f], -1),
        jnp.stack([cc, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _jv(a, b, cam_idx, lm_idx, dc, dl):
    """J v: per-obs 2x6 / 2x3 block products against the gathered camera /
    landmark updates."""
    return (jnp.einsum("oij,oj->oi", a, dc[cam_idx]) +
            jnp.einsum("oik,ok->oi", b, dl[lm_idx]))


def _jtu(a, b, cam_idx, lm_idx, u, f, l):
    """J^T u: per-obs block products index-added into the (F,6)/(L,3)
    parameter tables."""
    dt = u.dtype
    gc = jnp.zeros((f, 6), dt).at[cam_idx].add(
        jnp.einsum("oij,oi->oj", a, u))
    gl = jnp.zeros((l, 3), dt).at[lm_idx].add(
        jnp.einsum("oik,oi->ok", b, u))
    return gc, gl


def _cg(matvec, b, iters: int, precond=None):
    """Conjugate gradient, fixed iteration count (static for XLA);
    ``precond`` (z = M^-1 r) enables the standard PCG recurrence."""
    apply_m = precond if precond is not None else (lambda r: r)
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = apply_m(r0)
    p0 = z0
    rs0 = jnp.dot(r0, z0)

    def body(_, state):
        x, r, p, rs = state
        ap = matvec(p)
        alpha = rs / jnp.maximum(jnp.dot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = apply_m(r)
        rs_new = jnp.dot(r, z)
        beta = rs_new / jnp.maximum(rs, 1e-30)
        p = z + beta * p
        return x, r, p, rs_new

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x0, r0, p0, rs0))
    return x


@geometry
def ba_step(prob: BAProblem, lam: jax.Array, cfg: BAConfig,
            psum_axis: str | None = None, cam_mask=None):
    """One damped-GN step. Returns (new BAProblem, new lambda, cost_before).

    The normal system is applied matrix-free, but with the Jacobian
    LINEARIZED ONCE per step into explicit per-observation blocks
    (obs_jacobian_blocks) instead of re-running jvp/vjp through the
    projection every CG iteration: each CG matvec is then two gathers, four
    small einsums and two index-adds.

    When ``psum_axis`` is given the function is being traced inside shard_map
    with observations sharded along that axis: every J/Jt product and the
    cost are psum'd so all shards apply the identical (replicated) update —
    the shard-local-residual + psum'd-camera-system pattern."""
    f = prob.cameras.shape[0]
    l = prob.landmarks.shape[0]
    dtype = prob.cameras.dtype
    mask = _gauge_mask(f, l, cfg, dtype, cam_mask)
    mc, ml = _unflatten(mask, f, l)

    def psum(x):
        return jax.lax.psum(x, psum_axis) if psum_axis is not None else x

    r0, a, b, w = _linearize(prob, cfg)
    cost = psum(jnp.sum(r0 * r0))

    def jt(u):
        gc, gl = _jtu(a, b, prob.cam_idx, prob.lm_idx, u, f, l)
        return psum(_flatten(gc * mc, gl * ml))

    def jtj_mv(v):
        vm = v * mask
        dc, dl = _unflatten(vm, f, l)
        return jt(_jv(a, b, prob.cam_idx, prob.lm_idx, dc, dl)) \
            + lam * vm

    precond = None
    if cfg.precondition:
        # block-Jacobi preconditioner: the diagonal 6x6 / 3x3 blocks of
        # J^T J + lam, inverted once per step. The gauge-fixed camera-0
        # block is masked anyway; lam > 0 keeps every block SPD.
        aa = jnp.einsum("oia,oib->oab", a, a).reshape(-1, 36)
        hcc = jnp.zeros((f, 36), dtype).at[prob.cam_idx].add(aa)
        bb2 = jnp.einsum("oia,oib->oab", b, b).reshape(-1, 9)
        hll = jnp.zeros((l, 9), dtype).at[prob.lm_idx].add(bb2)
        hcc = psum(hcc).reshape(f, 6, 6) + lam * jnp.eye(6, dtype=dtype)
        hll = psum(hll).reshape(l, 3, 3) + lam * jnp.eye(3, dtype=dtype)
        minv_c = jnp.linalg.inv(hcc)
        minv_l = inv3x3_spd(hll)

        def precond(r):
            rc, rl = _unflatten(r * mask, f, l)
            zc = jnp.einsum("fab,fb->fa", minv_c, rc)
            zl = jnp.einsum("lab,lb->la", minv_l, rl)
            return _flatten(zc, zl) * mask

    g = jt(r0)
    dx = _cg(jtj_mv, -g, cfg.cg_iterations, precond)
    x1 = _flatten(prob.cameras, prob.landmarks) + dx * mask
    cams1, lms1 = _unflatten(x1, f, l)
    r1 = ba_residuals(cams1, lms1, prob)
    if w is not None:
        r1 = r1 * w[:, None]
    cost1 = psum(jnp.sum(r1 * r1))

    improved = cost1 < cost
    cams = jnp.where(improved, cams1, prob.cameras)
    lms = jnp.where(improved, lms1, prob.landmarks)
    lam_new = jnp.where(improved, lam * 0.5, lam * 4.0)
    new_prob = prob._replace(cameras=cams, landmarks=lms)
    return new_prob, lam_new, cost


@geometry
def ba_step_reduce_scatter(prob: BAProblem, lam: jax.Array, cfg: BAConfig,
                           axis: str):
    """One damped-GN step with the CG state SHARDED over ``axis`` — the
    reduce_scatter variant of ba_step(psum_axis=...) (scaling-book pattern:
    all_gather(v) before J v, psum_scatter(Jt u) after). Each device holds
    1/D of the parameter vector during CG, so the live parameter memory per
    chip shrinks by the mesh size; the psum of ba_step is decomposed into
    its reduce_scatter + all_gather halves around the matvec. Must be traced
    inside shard_map with observations sharded along ``axis``. Bit-parity
    with ba_step is NOT exact (different reduction orders); tests bound the
    divergence."""
    f = prob.cameras.shape[0]
    l = prob.landmarks.shape[0]
    dtype = prob.cameras.dtype
    mask = _gauge_mask(f, l, cfg, dtype)
    mc, ml = _unflatten(mask, f, l)
    n = f * 6 + l * 3
    d = jax.lax.axis_size(axis)
    pad = -n % d
    chunk = (n + pad) // d
    my = jax.lax.axis_index(axis)

    def pad_v(v):
        return jnp.concatenate([v, jnp.zeros(pad, dtype)]) if pad else v

    def shard_of(v_full):
        return jax.lax.dynamic_slice(pad_v(v_full), (my * chunk,), (chunk,))

    r0, a, bb, w = _linearize(prob, cfg)
    cost = jax.lax.psum(jnp.sum(r0 * r0), axis)

    def jt_local(u):
        gc, gl = _jtu(a, bb, prob.cam_idx, prob.lm_idx, u, f, l)
        return _flatten(gc * mc, gl * ml)           # partial (local obs)

    def gather_full(v_shard):
        """Shard -> full replicated vector, INVARIANT over the axis: psum of
        the shard placed at its offset (same collective volume as
        all_gather, but the result is replicated-typed so downstream gather
        indexing and the out_specs stay invariant under shard_map's vma
        checks)."""
        placed = jax.lax.dynamic_update_slice(
            jnp.zeros(n + pad, dtype), v_shard, (my * chunk,))
        return jax.lax.psum(placed, axis)[:n]

    def jtj_mv_shard(v_shard):
        v_full = gather_full(v_shard)
        vm = v_full * mask
        dc, dl = _unflatten(vm, f, l)
        jv = _jv(a, bb, prob.cam_idx, prob.lm_idx, dc, dl)
        jtjv_shard = jax.lax.psum_scatter(pad_v(jt_local(jv)), axis,
                                          tiled=True)
        return jtjv_shard + lam * shard_of(vm)

    g_shard = jax.lax.psum_scatter(pad_v(jt_local(r0)), axis, tiled=True)
    b = -g_shard

    def pdot(a, c):
        return jax.lax.psum(jnp.dot(a, c), axis)

    def body_fixed(_, state):
        x, r, p, rs = state
        ap = jtj_mv_shard(p)
        alpha = rs / jnp.maximum(pdot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = pdot(r, r)
        beta = rs_new / jnp.maximum(rs, 1e-30)
        p = r + beta * p
        return x, r, p, rs_new

    x_sh, _, _, _ = jax.lax.fori_loop(
        0, cfg.cg_iterations, body_fixed,
        (jnp.zeros_like(b), b, b, pdot(b, b)))

    dx = gather_full(x_sh)
    x1 = _flatten(prob.cameras, prob.landmarks) + dx * mask
    cams1, lms1 = _unflatten(x1, f, l)
    r1 = ba_residuals(cams1, lms1, prob)
    if w is not None:
        r1 = r1 * w[:, None]
    cost1 = jax.lax.psum(jnp.sum(r1 * r1), axis)
    improved = cost1 < cost
    cams = jnp.where(improved, cams1, prob.cameras)
    lms = jnp.where(improved, lms1, prob.landmarks)
    lam_new = jnp.where(improved, lam * 0.5, lam * 4.0)
    return prob._replace(cameras=cams, landmarks=lms), lam_new, cost


@partial(jax.jit, static_argnames=("cfg",))
@geometry
def ba_solve(prob: BAProblem, cfg: BAConfig = BAConfig(), cam_mask=None):
    """Full damped-GN loop (single shard). Returns (problem, final_cost).
    ``cam_mask`` (F,) bool freezes the False cameras (windowed BA)."""
    def body(_, state):
        p, lam, _ = state
        return ba_step(p, lam, cfg, cam_mask=cam_mask)

    init = (prob, jnp.asarray(cfg.damping, prob.cameras.dtype),
            jnp.asarray(0.0, prob.cameras.dtype))
    p, lam, cost = jax.lax.fori_loop(0, cfg.iterations, body, init)
    r = ba_residuals(p.cameras, p.landmarks, p)
    return p, jnp.sum(r * r)
