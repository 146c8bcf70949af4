"""Smoke run of compv_tpu's main paths on the GPU, checked against the CPU.

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Each phase drives the package's public entry points at the sizes users run,
prints one JSON line (compile seconds, steady-state ms per call timed with
jax.block_until_ready after a warm-up call, memory_analysis() of its main
jitted step, and every comparison it made), and checks the card's result
against the same function run on the host CPU device in this process — the
plain reference. Integer outputs must match bit for bit; every float
tolerance is stated beside its comparison. A failed check raises, so the
contract line below is printed only when every phase passed.

With no GPU the script stops before any phase runs and exits non-zero.

Phases (one card):
  1. frontend: slam.match_pair with FrontendConfig() defaults on 3 pairs of
     1282x720 frames (bench.py's scene warped by known homographies), plus
     the ORB keypoints and descriptors of each frame;
  2. bundle adjustment: slam.ba.ba_step and slam.ba_schur.ba_step_schur at
     256 cameras / 20,000 landmarks / 102,400 observations, 3 steps each;
  3. CCL labels and boxes and MSER on the 1122x1182 text scan, SHT and KHT
     on the 720p Canny map;
  4. SfM: run_sfm on 8 frames of render_orbit_sequence at 480x640.

--four-cards: sharded_orb_detect on 8 1282x720 frames (2 per card),
sharded_all_pairs_match and ring_all_pairs_match, and
make_distributed_ba_step in psum and reduce_scatter modes at the phase-2
size, each against its one-card result, with the traced collective counts.

The last line of stdout is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import compv_tpu.device as cdev


# ----------------------------------------------------------------- helpers

def _cpu():
    return jax.devices("cpu")[0]


def _memory(compiled) -> dict | None:
    m = compiled.memory_analysis()
    if m is None:
        return None
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def run_timed(fn, args, reps: int):
    """Compile ``fn`` for the device its arguments live on, run it once as
    the warm-up, then time ``reps`` steady-state calls. Returns (output,
    compile seconds, median ms per call or None, memory analysis, the
    compiled executable)."""
    jitted = jax.jit(fn)
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times)) if times else None
    return out, compile_s, ms, _memory(compiled), compiled


class Checks:
    """Collects named comparisons; ``fail()`` raises on the first bad one
    after all of a phase's numbers have been recorded."""

    def __init__(self):
        self.items: dict = {}
        self.bad: list = []

    def exact(self, name, got, want):
        got, want = np.asarray(got), np.asarray(want)
        same = got.shape == want.shape and np.array_equal(got, want)
        n_diff = (int(np.sum(got != want)) if got.shape == want.shape
                  else -1)
        self.items[name] = {"exact": bool(same), "n_diff": n_diff}
        if not same:
            self.bad.append(name)

    def close(self, name, got, want, rtol, atol, why):
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        same = (got == want) | (np.isnan(got) & np.isnan(want))
        with np.errstate(invalid="ignore"):
            err = np.where(same, 0.0, np.abs(got - want))
        ok = bool(np.all(err <= atol + rtol * np.abs(want)))
        self.items[name] = {"max_abs_err": float(err.max(initial=0.0)),
                            "rtol": rtol, "atol": atol, "why": why, "ok": ok}
        if not ok:
            self.bad.append(name)

    def info(self, name, value):
        self.items[name] = {"info": value}

    def bar(self, name, value, limit, why):
        ok = bool(value < limit)
        self.items[name] = {"value": float(value), "limit": float(limit),
                            "why": why, "ok": ok}
        if not ok:
            self.bad.append(name)

    def fail(self, phase):
        if self.bad:
            raise AssertionError(f"{phase}: failed checks {self.bad}: "
                                 + json.dumps({k: self.items[k]
                                               for k in self.bad}))


def _emit(phase, record):
    print(json.dumps({"phase": phase, **record}), flush=True)


# ----------------------------------------------------------------- inputs

def _homographies(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Known mild homographies about the frame centre: rotation up to 4
    degrees, scale 0.95-1.05, shift up to 3% of the width, slight
    perspective."""
    rs = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = np.deg2rad(rs.uniform(-4, 4))
        s = rs.uniform(0.95, 1.05)
        tx, ty = rs.uniform(-0.03, 0.03, 2) * w
        px, py = rs.uniform(-2e-5, 2e-5, 2) * 1282.0 / w
        c = np.array([[1, 0, w / 2], [0, 1, h / 2], [0, 0, 1.0]])
        m = np.array([[s * np.cos(a), -s * np.sin(a), tx],
                      [s * np.sin(a), s * np.cos(a), ty],
                      [px, py, 1.0]])
        out.append(c @ m @ np.linalg.inv(c))
    return np.stack(out)


def _warp(img: np.ndarray, hmat: np.ndarray) -> np.ndarray:
    """img2(p) = img(H^-1 p), bilinear, edge-replicated (numpy/scipy only,
    so both devices see the same bytes)."""
    from scipy import ndimage
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)])
    src = np.linalg.inv(hmat) @ pts
    sx, sy = src[0] / src[2], src[1] / src[2]
    out = ndimage.map_coordinates(img.astype(np.float64), [sy, sx],
                                  order=1, mode="nearest")
    return np.clip(np.round(out), 0, 255).astype(np.uint8).reshape(h, w)


def _corner_error(h_est: np.ndarray, h_true: np.ndarray, h: int,
                  w: int) -> float:
    """Mean pixel distance between the frame corners mapped by both."""
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                  [w - 1, h - 1, 1]], np.float64).T

    def apply(m):
        p = m @ c
        return p[:2] / p[2]

    return float(np.mean(np.linalg.norm(apply(h_est) - apply(h_true),
                                        axis=0)))


def ba_problem(n_cams: int, n_lms: int, n_obs: int, seed: int = 0):
    """Synthetic BA problem with a known solution: landmarks 4-8 units in
    front of cameras near the origin; observation j of landmark l comes
    from camera (c_l + 37 j) mod F — distinct cameras for j < F when 37
    and F are coprime (F = 256: 5-6 cameras per landmark), so every
    landmark block is well posed; 0.5 px noise, then cameras (except the
    gauge camera 0) and landmarks perturbed."""
    from compv_tpu.slam.ba import BAProblem, project_points
    rs = np.random.default_rng(seed)
    cams = np.concatenate([rs.normal(0, 0.05, (n_cams, 3)),
                           rs.normal(0, 0.3, (n_cams, 3))], 1)
    lms = np.concatenate([rs.uniform(-2, 2, (n_lms, 2)),
                          rs.uniform(4, 8, (n_lms, 1))], 1)
    intr = np.array([500.0, 500.0, 320.0, 240.0])
    li = (np.arange(n_obs) % n_lms).astype(np.int32)
    first = rs.integers(0, n_cams, n_lms)
    ci = ((first[li] + 37 * (np.arange(n_obs) // n_lms)) % n_cams
          ).astype(np.int32)
    with jax.default_device(_cpu()):
        uv = np.asarray(project_points(
            jnp.asarray(cams, jnp.float32), jnp.asarray(lms, jnp.float32),
            jnp.asarray(intr, jnp.float32), jnp.asarray(ci),
            jnp.asarray(li)))
    uv = uv + rs.normal(0, 0.5, uv.shape)
    cams0 = cams.copy()
    cams0[1:, :3] += rs.normal(0, 0.005, (n_cams - 1, 3))
    cams0[1:, 3:] += rs.normal(0, 0.02, (n_cams - 1, 3))
    lms0 = lms + rs.normal(0, 0.05, lms.shape)
    return BAProblem(
        cameras=np.asarray(cams0, np.float32),
        landmarks=np.asarray(lms0, np.float32),
        intrinsics=np.asarray(intr, np.float32),
        cam_idx=ci, lm_idx=li, uv=np.asarray(uv, np.float32),
        valid=np.ones((n_obs,), bool))


def _px_step_diff(prob, p_a, p_b) -> float:
    """|P(x_a) - P(x_b)| / |P(x_b) - P(x_0)| over every observation's
    projected pixel, computed on the CPU: how far two BA results differ,
    relative to how far the step moved the projections. Unlike a
    parameter distance it is blind to the gauge (a common scale of
    cameras and landmarks), which no cost or observation pins."""
    from compv_tpu.slam.ba import project_points

    def proj(cams, lms):
        with jax.default_device(_cpu()):
            return np.asarray(project_points(
                jnp.asarray(np.asarray(cams)), jnp.asarray(np.asarray(lms)),
                jnp.asarray(prob.intrinsics), jnp.asarray(prob.cam_idx),
                jnp.asarray(prob.lm_idx)), np.float64)

    pa = proj(p_a.cameras, p_a.landmarks)
    pb = proj(p_b.cameras, p_b.landmarks)
    p0 = proj(prob.cameras, prob.landmarks)
    return float(np.linalg.norm(pa - pb)
                 / max(np.linalg.norm(pb - p0), 1e-12))


# ----------------------------------------------------------------- phases

def phase_frontend(n_pairs: int = 3, h: int = 720, w: int = 1282,
                   config=None, reps: int = 5, corner_bar: float = 1.0,
                   seed: int = 0):
    """match_pair on ``n_pairs`` frame pairs of bench.py's scene warped by
    known homographies, on the default device and on the CPU."""
    from bench import _images
    from compv_tpu.features.orb import orb_detect_describe
    from compv_tpu.matchers.bruteforce import knn_match
    from compv_tpu.slam.frontend import FrontendConfig, match_pair
    config = config or FrontendConfig()
    base = _images(h, w, 48, 48)[0]
    hs = _homographies(n_pairs, h, w, seed)
    pairs = [(base, _warp(base, hm)) for hm in hs]
    ck = Checks()
    rec = {"size": [h, w], "pairs": n_pairs,
           "max_features": config.orb.max_features,
           "levels": config.orb.levels}

    step = jax.jit(lambda a, b: match_pair(a, b, config))
    orb = jax.jit(lambda a: orb_detect_describe(a, config.orb))
    knn = jax.jit(lambda r1, r2: knn_match(
        r1.descriptors, r2.descriptors, r1.keypoints.valid,
        r2.keypoints.valid, k=2))
    for i, (a, b) in enumerate(pairs):
        dev_args = (jnp.asarray(a), jnp.asarray(b))
        cpu_args = jax.device_put(dev_args, _cpu())
        if i == 0:
            out, comp_s, ms, mem, dev_step = run_timed(step, dev_args, reps)
            rec.update(compile_s=comp_s, ms_per_call=ms, memory=mem)
        else:
            out = jax.block_until_ready(dev_step(*dev_args))
        ref = step(*cpu_args)
        for f in ("num_matches", "kp1_count", "kp2_count"):
            ck.exact(f"pair{i}.{f}", getattr(out, f), getattr(ref, f))
        # inliers are f32 residuals compared with a pixel threshold: a match
        # within rounding of the threshold may fall on either side
        ck.close(f"pair{i}.num_inliers", out.num_inliers, ref.num_inliers,
                 0.01, 1.0, "f32 residual vs threshold; 1% of inliers")
        # DLT + RANSAC refine in f32: the two backends sum in other orders
        ck.close(f"pair{i}.H_vs_cpu", np.asarray(out.h) / np.asarray(out.h)[2, 2],
                 np.asarray(ref.h) / np.asarray(ref.h)[2, 2], 1e-3, 1e-6,
                 "f32 DLT/refine summed in another order on each backend")
        ck.bar(f"pair{i}.corner_err_px",
               _corner_error(np.asarray(out.h, np.float64), hs[i], h, w),
               corner_bar, "mean frame-corner reprojection error of the "
               "estimated H against the known warp")
        res = []
        for j, img in enumerate((a, b)):
            r_dev = orb(jnp.asarray(img))
            r_cpu = orb(jax.device_put(jnp.asarray(img), _cpu()))
            res.append((r_dev, r_cpu))
            tag = f"pair{i}.img{j}"
            for f in ("x", "y", "level", "valid"):
                ck.exact(f"{tag}.kp_{f}", getattr(r_dev.keypoints, f),
                         getattr(r_cpu.keypoints, f))
            ck.info(f"{tag}.orientation_max_abs_diff_deg", float(np.max(
                np.abs(np.asarray(r_dev.keypoints.orientation)
                       - np.asarray(r_cpu.keypoints.orientation)))))
            ck.exact(f"{tag}.descriptors", r_dev.descriptors,
                     r_cpu.descriptors)
        m_dev = knn(res[0][0], res[1][0])
        m_cpu = knn(res[0][1], res[1][1])
        ck.exact(f"pair{i}.knn2_hamming", m_dev.distance, m_cpu.distance)
        ck.exact(f"pair{i}.knn2_train_idx", m_dev.train_idx, m_cpu.train_idx)
    rec["checks"] = ck.items
    _emit("frontend", rec)
    ck.fail("frontend")
    return rec


def phase_ba(n_cams: int = 256, n_lms: int = 20000, n_obs: int = 102400,
             cg: int = 20, steps: int = 3, reps: int = 3, seed: int = 0):
    """3 damped-GN steps of ba_step and of ba_step_schur, card vs CPU."""
    from compv_tpu.slam.ba import BAConfig, ba_step
    from compv_tpu.slam.ba_schur import (SchurConfig, ba_step_schur,
                                         max_obs_per_landmark)
    prob = ba_problem(n_cams, n_lms, n_obs, seed)
    k = max_obs_per_landmark(prob.lm_idx, prob.valid, n_lms)
    cfg = BAConfig(cg_iterations=cg)
    solvers = {
        "cg": lambda p, lam: ba_step(p, lam, cfg),
        "schur": lambda p, lam: ba_step_schur(p, lam, SchurConfig(),
                                              max_obs_per_lm=k),
    }
    records = {}
    for name, step in solvers.items():
        step = jax.jit(step)
        ck = Checks()
        rec = {"cams": n_cams, "landmarks": n_lms, "obs": n_obs,
               "cg_iterations": cg if name == "cg" else None,
               "max_obs_per_lm": k if name == "schur" else None}
        runs = {}
        for where, dev in (("gpu", None), ("cpu", _cpu())):
            p = jax.tree.map(jnp.asarray, prob)
            lam = jnp.float32(1e-3)
            if dev is not None:
                p, lam = jax.device_put((p, lam), dev)
            costs = []
            run = step
            for s in range(steps):
                if where == "gpu" and s == 0:
                    (p, lam, c), comp_s, ms, mem, run = run_timed(
                        step, (p, lam), reps)
                    rec.update(compile_s=comp_s, ms_per_call=ms, memory=mem)
                else:
                    p, lam, c = run(p, lam)
                costs.append(float(c))
            costs.append(float(run(p, lam)[2]))   # cost after `steps`
            runs[where] = (costs, p)
        costs, p_dev = runs["gpu"]
        ref_costs, p_cpu = runs["cpu"]
        rec["cost_per_step"] = costs
        rec["cost_per_step_cpu"] = ref_costs
        ck.bar("cost_after_over_before", costs[-1] / costs[0], 1.0,
               "the damped-GN steps must lower the cost")
        # f32 sums over 102,400 observations in another order (the card
        # index-adds with atomics); 20 CG iterations stop short of the
        # exact step, and each GN step starts from the last, so the
        # difference grows step by step (1.5e-3 after 3 steps on an H100)
        ck.close("cost_vs_cpu", costs, ref_costs, 5e-3, 0.0,
                 "f32 reductions in another order, compounded by truncated "
                 "CG over 3 GN steps")
        ck.bar("step_diff_vs_cpu", _px_step_diff(prob, p_dev, p_cpu), 1e-2,
               "|P(x_gpu) - P(x_cpu)| / |P(x_cpu) - P(x_0)| over the "
               "projected pixels: the card's steps agree with the CPU's to "
               "1% of the pixel motion (f32 summation order)")
        rec["checks"] = ck.items
        _emit(f"ba_{name}", rec)
        ck.fail(f"ba_{name}")
        records[name] = rec
    return records


def phase_paths(h: int = 720, w: int = 1282, th: int = 1182, tw: int = 1122,
                reps: int = 5):
    """CCL labels + boxes and MSER on the text scan; SHT and KHT on the
    Canny map of the 720p scene. Integer outputs bit for bit."""
    from bench import _images
    from compv_tpu.features.canny import CannyConfig, canny
    from compv_tpu.features.ccl import (CclConfig, ccl_features_from_labels,
                                        label_components)
    from compv_tpu.features.edges import sobel_gradients
    from compv_tpu.features.hough import (HoughKhtConfig, HoughShtConfig,
                                          hough_kht, hough_sht)
    from compv_tpu.features.mser import MserConfig, mser_detect

    gray_np, text_np = _images(h, w, th, tw)
    text_bin = (text_np < 128).astype(np.uint8) * 255

    def sht(g):
        return hough_sht(canny(g, CannyConfig()), HoughShtConfig())

    def kht(g):
        gx, gy = sobel_gradients(g)
        return hough_kht(canny(g, CannyConfig()), gx, gy, HoughKhtConfig())

    cases = {
        "ccl_label": (label_components, text_bin),
        "ccl_boxes": (lambda lb: ccl_features_from_labels(lb, CclConfig()),
                      None),
        "mser": (lambda im: mser_detect(im, MserConfig()), text_np),
        "hough_sht": (sht, gray_np),
        "hough_kht": (kht, gray_np),
    }
    float_fields = {"cx", "cy"}
    records = {}
    labels = None
    for name, (fn, arr) in cases.items():
        if arr is None:
            arr = labels
        ck = Checks()
        out, comp_s, ms, mem, _ = run_timed(fn, (jnp.asarray(arr),), reps)
        ref = jax.jit(fn)(jax.device_put(jnp.asarray(arr), _cpu()))
        if name == "ccl_label":
            labels = np.asarray(ref)
        if isinstance(out, tuple) and hasattr(out, "_fields"):
            for f in out._fields:
                if f in float_fields:
                    # one f32 division of exact integer sums; a GPU may
                    # divide through a reciprocal: 2 ulp
                    ck.close(f, getattr(out, f), getattr(ref, f), 2.5e-7,
                             0.0, "one f32 division of exact integers")
                else:
                    ck.exact(f, getattr(out, f), getattr(ref, f))
        else:
            ck.exact("labels", out, ref)
        rec = {"input": list(np.shape(arr)), "compile_s": comp_s,
               "ms_per_call": ms, "memory": mem, "checks": ck.items}
        _emit(name, rec)
        ck.fail(name)
        records[name] = rec
    return records


def phase_sfm(n_frames: int = 8, h: int = 480, w: int = 640,
              ate_bar: float = 0.03):
    """run_sfm on an orbit sequence; ATE under 3% of the trajectory span
    on the card, and the CPU run meets the same bar."""
    from compv_tpu.slam.evaluate import ate_rmse
    from compv_tpu.slam.sfm import render_orbit_sequence, run_sfm
    with jax.default_device(_cpu()):
        frames, gt, k = render_orbit_sequence(n_frames, h, w)
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    ck = Checks()
    rec = {"frames": n_frames, "size": [h, w]}
    for where, dev in (("gpu", None), ("cpu", _cpu())):
        ctx = (jax.default_device(dev) if dev is not None
               else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            res = run_sfm(frames, k)
            first_s = time.perf_counter() - t0
            ate = float(ate_rmse(jnp.asarray(res.positions), jnp.asarray(gt),
                                 with_scale=True))
        rec[f"{where}_first_run_s"] = first_s
        rec[f"{where}_ate_over_span"] = ate / span
        rec[f"{where}_reproj_after_px"] = float(res.reproj_after)
        ck.bar(f"{where}_ate_over_span", ate / span, ate_bar,
               "tests/test_sfm.py 8-frame bar: ATE < 3% of the span")
        if where == "gpu":
            t0 = time.perf_counter()
            run_sfm(frames, k)
            rec["gpu_warm_run_s"] = time.perf_counter() - t0
    from compv_tpu.features.orb import orb_detect_describe
    from compv_tpu.slam.sfm import SfmConfig
    orb = lambda a: orb_detect_describe(a, SfmConfig().orb)  # noqa: E731
    _, comp_s, ms, mem, _ = run_timed(orb, (jnp.asarray(frames[0]),), 5)
    rec["orb_step"] = {"compile_s": comp_s, "ms_per_call": ms, "memory": mem}
    rec["checks"] = ck.items
    _emit("sfm", rec)
    ck.fail("sfm")
    return rec


def phase_four_cards(devices=None, n_frames: int = 8, h: int = 720,
                     w: int = 1282, orb_config=None, n_cams: int = 256,
                     n_lms: int = 20000, n_obs: int = 102400, cg: int = 20,
                     reps: int = 3):
    """The sharded paths on a 4-device mesh, each against one device."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from bench import _images
    from compv_tpu.features.orb import OrbConfig
    from compv_tpu.parallel.sharded import (make_distributed_ba_step,
                                            ring_all_pairs_match,
                                            sharded_all_pairs_match,
                                            sharded_orb_detect)
    from compv_tpu.profiling import collective_stats
    from compv_tpu.slam.ba import BAConfig, BAProblem

    devices = list(devices if devices is not None else jax.devices()[:4])
    mesh4 = Mesh(np.array(devices), ("frame",))
    mesh1 = Mesh(np.array(devices[:1]), ("frame",))
    orb_config = orb_config or OrbConfig()
    base = _images(h, w, 48, 48)[0]
    hs = _homographies(n_frames, h, w, 1)
    frames = np.stack([_warp(base, hm) for hm in hs])
    records = {}

    # --- sharded ORB + matching
    ck = Checks()
    outs = {}
    for tag, mesh in (("4", mesh4), ("1", mesh1)):
        imgs = jax.device_put(frames, NamedSharding(mesh, P("frame")))
        det = lambda im, m=mesh: sharded_orb_detect(im, m, orb_config)  # noqa
        res, comp_s, ms, mem, _ = run_timed(det, (imgs,), reps)
        d, v = res.descriptors, res.keypoints.valid
        ag = lambda a, b, m=mesh: sharded_all_pairs_match(a, b, m)  # noqa
        ring = lambda a, b, m=mesh: ring_all_pairs_match(a, b, m)  # noqa
        sim, ag_s, ag_ms, _, _ = run_timed(ag, (d, v), reps)
        sim_r, ring_s, ring_ms, _, _ = run_timed(ring, (d, v), reps)
        outs[tag] = (res, sim, sim_r)
        records[f"orb_{tag}card"] = {
            "compile_s": comp_s, "ms_per_call": ms, "memory": mem,
            "all_gather_match": {"compile_s": ag_s, "ms_per_call": ag_ms},
            "ring_match": {"compile_s": ring_s, "ms_per_call": ring_ms}}
        if tag == "4":
            records["match_collectives"] = {
                "all_gather": collective_stats(jax.make_jaxpr(ag)(d, v))[0],
                "ring": collective_stats(jax.make_jaxpr(ring)(d, v))[0]}
    r4, s4, sr4 = outs["4"]
    r1, s1, sr1 = outs["1"]
    for f in ("x", "y", "level", "valid"):
        ck.exact(f"orb.kp_{f}", getattr(r4.keypoints, f),
                 getattr(r1.keypoints, f))
    ck.exact("orb.descriptors", r4.descriptors, r1.descriptors)
    # mean of exact integer Hamming minima divided by a count: one f32
    # division, the same on every device
    ck.exact("all_pairs_sim", s4, s1)
    ck.exact("ring_sim", sr4, sr1)
    ck.exact("ring_vs_all_gather", sr4, s4)
    records["orb_match_checks"] = ck.items
    _emit("four_cards_orb_match", {k: records[k] for k in records})
    ck.fail("four_cards_orb_match")

    # --- distributed BA, both modes, against the one-card step
    prob = ba_problem(n_cams, n_lms, n_obs - n_obs % len(devices))
    cfg = BAConfig(cg_iterations=cg)
    for mode in ("psum", "reduce_scatter"):
        ck = Checks()
        rec = {"mode": mode, "cams": n_cams, "landmarks": n_lms,
               "obs": int(prob.cam_idx.shape[0]), "cg_iterations": cg}
        res = {}
        for tag, mesh in (("4", mesh4), ("1", mesh1)):
            sh = NamedSharding(mesh, P("frame"))
            rp = NamedSharding(mesh, P())
            pb = BAProblem(*[jax.device_put(a, sh if i >= 3 else rp)
                             for i, a in enumerate(prob)])
            lam = jax.device_put(jnp.float32(1e-3), rp)
            step = make_distributed_ba_step(mesh, cfg, mode=mode)
            (p1, _, c0), comp_s, ms, mem, _ = run_timed(step, (pb, lam),
                                                        reps)
            rec[f"{tag}card"] = {"compile_s": comp_s, "ms_per_call": ms,
                                 "memory": mem}
            res[tag] = (p1, float(c0))
            if tag == "4":
                counts, payload = collective_stats(
                    jax.make_jaxpr(step)(pb, lam), cg)
                rec["collectives_per_step"] = counts
                rec["collective_payload_bytes_per_step"] = payload
        (p4, c4), (p1_, c1) = res["4"], res["1"]
        ck.close("cost_before", c4, c1, 1e-5, 0.0,
                 "psum of 4 partial f32 sums vs one sum")
        ck.bar("step_diff_vs_1card", _px_step_diff(prob, p4, p1_), 1e-2,
               "|P(x_4) - P(x_1)| / |P(x_1) - P(x_0)| over the projected "
               "pixels: f32 psum order through CG")
        rec["checks"] = ck.items
        _emit(f"four_cards_ba_{mode}", rec)
        ck.fail(f"four_cards_ba_{mode}")
        records[f"ba_{mode}"] = rec
    return records


# ----------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    device = cdev.require_gpu()
    print(cdev.gpu_info(), flush=True)
    cdev.enable_compile_cache()
    t0 = time.perf_counter()
    if args.four_cards:
        if device["count"] < 4:
            raise RuntimeError(f"--four-cards needs 4 GPUs, found "
                               f"{device['count']}")
        phase_four_cards()
    else:
        phase_frontend()
        phase_ba()
        phase_paths()
        phase_sfm()
    print(json.dumps({"total_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
