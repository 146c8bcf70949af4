"""Multi-chip sharded pipelines: detect / match / distributed BA.

The reference is single-node (SURVEY.md §2.6); this layer is the new part.
Patterns (scaling-book style):
  * frames sharded over the mesh "frame" axis, shard_map'd per-frame ORB
    (data parallelism — replaces the thread pool's frame-level task split);
  * cross-shard all-pairs matching via all_gather of descriptor blocks, or
    the ring variant (ring_all_pairs_match): descriptor blocks travel the
    ring via lax.ppermute so per-step memory is one block instead of the
    full gathered set — ring attention over keyframes (SURVEY.md §5);
  * distributed BA: observations sharded, shard-local residual/J products;
    either psum'd (replicated CG state, slam/ba.py psum_axis) or
    reduce-scattered (CG state sharded over the mesh: all_gather(v) before
    J v, psum_scatter(Jt u) after — halves live parameter memory per chip,
    ba_step_reduce_scatter).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from compv_tpu.matchers.bruteforce import hamming_distance_matrix
from compv_tpu.slam.ba import (BAConfig, BAProblem, ba_step,
                               ba_step_reduce_scatter)

__all__ = ["sharded_detect", "sharded_orb_detect", "sharded_all_pairs_match",
           "ring_all_pairs_match", "distributed_ba_solve",
           "make_distributed_ba_step"]


def sharded_detect(images: jax.Array, mesh: Mesh, threshold: int = 20,
                   max_features: int = 256):
    """(F, H, W) u8 frames sharded over "frame" -> per-frame keypoints +
    descriptors (x, y, strength, valid, desc), outputs sharded the same
    way. Single-level configuration of the real product pipeline —
    sharded_orb_detect with levels=1, so it cannot drift from the
    detector's defaults."""
    from compv_tpu.features.orb import OrbConfig
    cfg = OrbConfig(max_features=max_features, threshold=threshold,
                    levels=1, subpixel=False)
    res = sharded_orb_detect(images, mesh, cfg)
    kp = res.keypoints
    return kp.x, kp.y, kp.strength, kp.valid, res.descriptors


def sharded_orb_detect(images: jax.Array, mesh: Mesh, config=None):
    """(F, H, W) u8 frames sharded over "frame" -> the FULL product ORB
    pipeline per frame (8-level pyramid, per-level budgets, orientation,
    sub-pixel refinement, blurred BRIEF — features/orb.orb_detect_describe),
    outputs sharded the same way.

    This is the multi-device frontend users actually run (sharded_detect
    above is its single-level configuration); tests/test_parallel.py asserts per-frame parity
    with the single-device path."""
    from compv_tpu.features.orb import OrbConfig, orb_detect_describe
    config = config or OrbConfig()
    detect = partial(orb_detect_describe, config=config)

    @partial(shard_map, mesh=mesh, in_specs=P("frame"), out_specs=P("frame"))
    def run(imgs):
        return jax.vmap(detect)(imgs)

    return run(images)


def sharded_all_pairs_match(desc: jax.Array, valid: jax.Array, mesh: Mesh):
    """All-pairs min-Hamming distances between frames.

    desc (F, K, B) sharded over "frame"; returns (F, F) mean-of-min
    descriptor distance (a cheap frame-similarity matrix for keyframe
    selection). Local shard matches against the all_gathered set — the
    descriptor exchange the reference never needed (SURVEY.md §5
    'Distributed communication backend')."""

    @partial(shard_map, mesh=mesh, in_specs=(P("frame"), P("frame")),
             out_specs=P("frame"))
    def run(local_desc, local_valid):
        all_desc = jax.lax.all_gather(local_desc, "frame", tiled=True)
        all_valid = jax.lax.all_gather(local_valid, "frame", tiled=True)

        def one_local(d1, v1):
            return jax.vmap(lambda d2, v2: _pair_sim(d1, v1, d2, v2))(
                all_desc, all_valid)

        return jax.vmap(one_local)(local_desc, local_valid)  # (fl, ft)

    return run(desc, valid)


def _pair_sim(d1, v1, d2, v2):
    """Mean-of-min Hamming distance between two descriptor sets."""
    dist = hamming_distance_matrix(d1, d2)          # (K, K)
    big = jnp.int32(1 << 30)
    dist = jnp.where(v2[None, :], dist, big)
    mins = jnp.min(dist, axis=1)
    mins = jnp.where(v1 & (mins < big), mins, 0)
    cnt = jnp.maximum(jnp.sum(v1 & (jnp.min(dist, axis=1) < big)), 1)
    return jnp.sum(mins).astype(jnp.float32) / cnt.astype(jnp.float32)


def ring_all_pairs_match(desc: jax.Array, valid: jax.Array, mesh: Mesh):
    """ring_all_pairs_match == sharded_all_pairs_match, exchanged over a
    ppermute RING instead of all_gather (SURVEY.md §5 'ring-style ppermute
    exchange of descriptor blocks'): at step s every device matches its
    local frames against the block that originated s hops down the ring,
    then passes the block to its right neighbor. Peak comm memory is ONE
    block instead of the full (F, K, B) gathered set, so keyframe stores
    larger than a device's spare memory still match all-pairs."""
    n_dev = mesh.devices.size

    @partial(shard_map, mesh=mesh, in_specs=(P("frame"), P("frame")),
             out_specs=P("frame"))
    def run(local_desc, local_valid):
        my = jax.lax.axis_index("frame")
        fl = local_desc.shape[0]
        ft = fl * n_dev
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

        def one_block(d1, v1, blk_d, blk_v):
            return jax.vmap(lambda d2, v2: _pair_sim(d1, v1, d2, v2))(
                blk_d, blk_v)

        out = jnp.zeros((fl, ft), jnp.float32)
        blk_d, blk_v = local_desc, local_valid
        for step in range(n_dev):
            # the block now held originated at device (my - step) mod n_dev
            src = (my - step) % n_dev
            cols = jax.vmap(lambda d1, v1: one_block(d1, v1, blk_d, blk_v))(
                local_desc, local_valid)             # (fl, fl)
            out = jax.lax.dynamic_update_slice(out, cols, (0, src * fl))
            if step + 1 < n_dev:
                blk_d = jax.lax.ppermute(blk_d, "frame", perm)
                blk_v = jax.lax.ppermute(blk_v, "frame", perm)
        return out

    return run(desc, valid)


def make_distributed_ba_step(mesh: Mesh, cfg: BAConfig = BAConfig(),
                             mode: str = "psum"):
    """Returns a jitted distributed BA step: parameters replicated,
    observations sharded over "frame"; one damped-GN step.

    mode="psum": every J/Jt product psum'd, CG state replicated
    (slam/ba.py ba_step). mode="reduce_scatter": CG state sharded over the
    mesh, all_gather/psum_scatter around each matvec (ba_step_reduce_scatter
    — same collective volume, 1/D parameter memory per chip)."""
    param_spec = BAProblem(
        cameras=P(), landmarks=P(), intrinsics=P(),
        cam_idx=P("frame"), lm_idx=P("frame"), uv=P("frame"),
        valid=P("frame"))

    @partial(shard_map, mesh=mesh,
             in_specs=(param_spec, P()),
             out_specs=(param_spec, P(), P()))
    def step(prob, lam):
        if mode == "reduce_scatter":
            return ba_step_reduce_scatter(prob, lam, cfg, axis="frame")
        return ba_step(prob, lam, cfg, psum_axis="frame")

    return jax.jit(step)


def make_distributed_schur_step(mesh: Mesh, cfg=None,
                                max_obs_per_lm: int = 16):
    """Distributed Schur-complement BA step: per-shard block assembly
    (Hcc/Hll/gradients and the per-landmark W chunks are sums over local
    observations), psum'd into the exact dense reduced camera system on
    every shard (slam/ba_schur.py). ``max_obs_per_lm`` is the static
    per-shard cap on observations of one landmark — size it with
    slam.ba_schur.max_obs_per_landmark over the worst shard (the global
    count is always a safe upper bound)."""
    from compv_tpu.slam.ba_schur import SchurConfig, ba_step_schur
    cfg = cfg or SchurConfig()
    param_spec = BAProblem(
        cameras=P(), landmarks=P(), intrinsics=P(),
        cam_idx=P("frame"), lm_idx=P("frame"), uv=P("frame"),
        valid=P("frame"))

    @partial(shard_map, mesh=mesh,
             in_specs=(param_spec, P()),
             out_specs=(param_spec, P(), P()))
    def step(prob, lam):
        return ba_step_schur(prob, lam, cfg, psum_axis="frame",
                             max_obs_per_lm=max_obs_per_lm)

    return jax.jit(step)


def distributed_ba_solve(prob: BAProblem, mesh: Mesh,
                         cfg: BAConfig = BAConfig()):
    """Outer Python loop over jitted distributed GN steps (keeps per-step
    compile small; the loop count is tiny)."""
    step = make_distributed_ba_step(mesh, cfg)
    lam = jnp.asarray(cfg.damping, prob.cameras.dtype)
    cost = jnp.asarray(0.0, prob.cameras.dtype)
    for _ in range(cfg.iterations):
        prob, lam, cost = step(prob, lam)
    return prob, cost
