"""Pose-graph optimization over SE(3).

Not present in the reference (single-frame library); required by the
BASELINE north star ("pose-graph consensus", SURVEY.md §5). Design: nodes
are (rvec, tvec) world-from-camera poses; edges are relative-pose
measurements (i -> j) with scalar weights. The residual of edge (i, j) is
log(T_meas^-1 · T_i^-1 · T_j) ∈ R^6 and the graph is solved by the same
matrix-free damped-GN + CG machinery as BA (slam/ba.py) — one XLA program,
psum-able across shards for distributed graphs.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from compv_tpu.slam.ba import matrix_to_rodrigues, rodrigues_to_matrix
from compv_tpu.precision import geometry

__all__ = ["PoseGraph", "PoseGraphConfig", "compose", "invert",
           "relative_pose", "optimize_pose_graph"]


def compose(rvec_a, tvec_a, rvec_b, tvec_b):
    """T_a · T_b as (rvec, tvec): R = Ra Rb, t = Ra tb + ta."""
    ra = rodrigues_to_matrix(rvec_a)
    rb = rodrigues_to_matrix(rvec_b)
    r = ra @ rb
    t = ra @ tvec_b + tvec_a
    return matrix_to_rodrigues(r), t


def invert(rvec, tvec):
    r = rodrigues_to_matrix(rvec)
    rt = r.T
    return matrix_to_rodrigues(rt), -(rt @ tvec)


def relative_pose(rvec_i, tvec_i, rvec_j, tvec_j):
    """T_i^-1 · T_j (the measurement an odometry edge stores)."""
    ri, ti = invert(rvec_i, tvec_i)
    return compose(ri, ti, rvec_j, tvec_j)


class PoseGraph(NamedTuple):
    poses: jax.Array       # (N, 6) [rvec | tvec]
    edge_i: jax.Array      # (E,) i32
    edge_j: jax.Array      # (E,) i32
    edge_meas: jax.Array   # (E, 6) measured relative pose i->j
    edge_weight: jax.Array  # (E,) f32
    edge_valid: jax.Array  # (E,) bool


@dataclass(frozen=True)
class PoseGraphConfig:
    iterations: int = 20
    cg_iterations: int = 30
    damping: float = 1e-3


_CHORDAL_SCALE = 0.70710678  # 1/sqrt(2): ||R-I||_F ~ sqrt(2)*theta small-angle


def _edge_residual(pose_i, pose_j, meas):
    """Residual of one edge, computed entirely in MATRIX form.

    Rotation part uses the chordal distance vec(R_err - I) (9 components,
    scaled to approximate the angle) instead of a log map: matrix->rvec
    conversion is non-differentiable at theta = pi and its clipped arccos
    silently zeroes AD derivatives — measured as |J_ad - J_fd| ~ 20 on ring
    graphs whose poses hit theta = pi. Chordal residuals are smooth
    everywhere and standard for pose-graph relaxations."""
    ri = rodrigues_to_matrix(pose_i[:3])
    rj = rodrigues_to_matrix(pose_j[:3])
    r_rel = ri.T @ rj
    t_rel = ri.T @ (pose_j[3:] - pose_i[3:])
    rm = rodrigues_to_matrix(meas[:3])
    r_err = rm.T @ r_rel
    t_err = rm.T @ (t_rel - meas[3:])
    rot_res = (r_err - jnp.eye(3, dtype=r_err.dtype)).ravel() * _CHORDAL_SCALE
    return jnp.concatenate([rot_res, t_err])


@geometry
def graph_residuals(poses: jax.Array, graph: PoseGraph) -> jax.Array:
    pi = poses[graph.edge_i]
    pj = poses[graph.edge_j]
    res = jax.vmap(_edge_residual)(pi, pj, graph.edge_meas)   # (E, 6)
    w = jnp.sqrt(jnp.maximum(graph.edge_weight, 0.0))[:, None]
    return jnp.where(graph.edge_valid[:, None], res * w, 0.0)


def _edge_residual_mat(r_i, t_i, r_j, t_j, meas):
    """Matrix-form edge residual (see _edge_residual docstring)."""
    r_rel = r_i.T @ r_j
    t_rel = r_i.T @ (t_j - t_i)
    rm = rodrigues_to_matrix(meas[:3])
    r_err = rm.T @ r_rel
    t_err = rm.T @ (t_rel - meas[3:])
    rot_res = (r_err - jnp.eye(3, dtype=r_err.dtype)).ravel() * _CHORDAL_SCALE
    return jnp.concatenate([rot_res, t_err])


@partial(jax.jit, static_argnames=("config",))
@geometry
def optimize_pose_graph(graph: PoseGraph,
                        config: PoseGraphConfig = PoseGraphConfig()):
    """Damped GN with CG on LOCAL pose increments; pose 0 gauge-fixed.
    Returns (graph', final cost)."""
    n = graph.poses.shape[0]
    mask = jnp.ones((n, 6), graph.poses.dtype).at[0].set(0.0).ravel()

    def cg(matvec, b, iters):
        x0 = jnp.zeros_like(b)

        def body(_, state):
            x, r, p, rs = state
            ap = matvec(p)
            alpha = rs / jnp.maximum(jnp.dot(p, ap), 1e-30)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = jnp.dot(r, r)
            beta = rs_new / jnp.maximum(rs, 1e-30)
            return x, r, r + beta * p, rs_new

        x, *_ = jax.lax.fori_loop(0, iters, body, (x0, b, b, jnp.dot(b, b)))
        return x

    w_sqrt = jnp.sqrt(jnp.maximum(graph.edge_weight, 0.0))[:, None]
    valid = graph.edge_valid[:, None]

    def residuals_mat(rmats, tvecs):
        """(N,3,3), (N,3) -> (E, 12) weighted residuals."""
        ri = rmats[graph.edge_i]
        ti = tvecs[graph.edge_i]
        rj = rmats[graph.edge_j]
        tj = tvecs[graph.edge_j]
        res = jax.vmap(_edge_residual_mat)(ri, ti, rj, tj, graph.edge_meas)
        return jnp.where(valid, res * w_sqrt, 0.0)

    def step(carry, _):
        poses, lam = carry
        # current estimate in matrix form — delta differentiation happens
        # ONLY through Exp(delta), never through a matrix->rvec log (which
        # is non-smooth at theta = pi and breaks AD there)
        r_cur = jax.vmap(rodrigues_to_matrix)(poses[:, :3])
        t_cur = poses[:, 3:]

        def apply_delta(dflat):
            d = dflat.reshape(n, 6)
            dr = jax.vmap(rodrigues_to_matrix)(d[:, :3])
            r_new = jnp.einsum("nij,njk->nik", r_cur, dr)
            t_new = t_cur + jnp.einsum("nij,nj->ni", r_cur, d[:, 3:])
            return r_new, t_new

        def res_of_delta(dflat):
            return residuals_mat(*apply_delta(dflat)).ravel()

        zero = jnp.zeros(n * 6, poses.dtype)
        r0 = res_of_delta(zero)
        cost0 = jnp.sum(r0 * r0)
        _, vjp = jax.vjp(res_of_delta, zero)
        g = vjp(r0)[0] * mask

        def mv(v):
            vm = v * mask
            jv = jax.jvp(res_of_delta, (zero,), (vm,))[1]
            return vjp(jv)[0] * mask + lam * vm

        dx = cg(mv, -g, config.cg_iterations) * mask
        r_new, t_new = apply_delta(dx)
        cost1 = jnp.sum(residuals_mat(r_new, t_new) ** 2)
        better = cost1 < cost0
        # rvec conversion is value-only (outside AD) — robust near pi
        rv_new = jax.vmap(matrix_to_rodrigues)(r_new)
        poses1 = jnp.concatenate([rv_new, t_new], axis=1)
        poses = jnp.where(better, poses1, poses)
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        return (poses, lam), cost0

    (poses, _), costs = jax.lax.scan(
        step, (graph.poses, jnp.asarray(config.damping, graph.poses.dtype)),
        None, length=config.iterations)
    final = jnp.sum(graph_residuals(poses, graph) ** 2)
    return graph._replace(poses=poses), final
