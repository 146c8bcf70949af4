"""Checkerboard corner detection via line intersections.

Reference: CompVCalibCamera::process (core/calib/compv_core_calib_camera.cxx:127-226):
Canny -> Hough -> prune weak lines -> split into horizontal/vertical
families -> group/merge into pattern lines -> intersections -> ordered
corner grid.

Design: Hough SHT peaks are clustered into the two dominant theta
families with a fixed-capacity merge (lines within merge_rho of each other
collapse, strongest wins); intersections are a closed-form batched solve.
Corners come out ordered (row-major by the 'horizontal' family rho, then by
the 'vertical' family rho), ready for calibrate_camera.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.core.types import Lines
from compv_tpu.features.canny import CannyConfig, canny
from compv_tpu.features.hough import HoughShtConfig, hough_sht
from compv_tpu.precision import geometry

__all__ = ["CheckerboardConfig", "CheckerboardResult", "find_chessboard_corners",
           "line_intersections"]


@dataclass(frozen=True)
class CheckerboardConfig:
    rows: int = 6           # inner-corner rows (pattern lines = rows)
    cols: int = 8
    canny: CannyConfig = CannyConfig(threshold_low=40.0, threshold_high=100.0)
    hough_threshold: float = 0.3   # fraction of the Hough peak — scale
                                   # invariant (boards can be small in view)
    merge_rho: float = 10.0  # lines closer than this collapse into one
    grid_tolerance: float = 3.0  # max RMS deviation of corners from a
                                 # projective grid (validity check)


class CheckerboardResult(NamedTuple):
    corners: jax.Array   # (rows*cols, 2) row-major grid
    valid: jax.Array     # () bool — full grid found
    h_lines: Lines
    v_lines: Lines


@geometry
def line_intersections(rho1, theta1, rho2, theta2):
    """Intersection of x cos(t1) + y sin(t1) = r1 with the t2/r2 line.
    Batched over any leading shape."""
    c1, s1 = jnp.cos(theta1), jnp.sin(theta1)
    c2, s2 = jnp.cos(theta2), jnp.sin(theta2)
    det = c1 * s2 - c2 * s1
    det = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
    x = (rho1 * s2 - rho2 * s1) / det
    y = (rho2 * c1 - rho1 * c2) / det
    return x, y


def _select_family(lines: Lines, theta_center, tol: float, count: int,
                   merge_rho: float):
    """Pick the ``count`` strongest lines whose theta is within tol of the
    family center (circular in pi), merge near-duplicates by rho, then order
    by rho. Fixed shapes throughout."""
    # canonicalize (rho, theta) relative to the family center: a line at
    # theta ~ pi with rho r equals theta ~ 0 with rho -r — flip wrapped ones
    # so rho ordering is consistent within the family
    raw_dt = lines.theta - theta_center
    wrapped = jnp.abs(raw_dt) > jnp.pi / 2
    theta_c = jnp.where(wrapped,
                        lines.theta - jnp.sign(raw_dt) * jnp.pi, lines.theta)
    rho_c = jnp.where(wrapped, -lines.rho, lines.rho)

    dt = jnp.abs(theta_c - theta_center)
    in_fam = lines.valid & (dt < tol)
    strength = jnp.where(in_fam, lines.strength, -1.0)

    # greedy merge: iterate `count` times; each time take the strongest
    # remaining line and suppress all lines within merge_rho of it
    def body(carry, _):
        s, rho_acc, th_acc, n = carry
        i = jnp.argmax(s)
        ok = s[i] > 0
        rho_i = rho_c[i]
        th_i = theta_c[i]
        # two Hough peaks are the SAME physical line only if both rho and
        # theta are close (under perspective, distinct converging lines can
        # share similar rho at very different theta)
        close = ((jnp.abs(rho_c - rho_i) < merge_rho)
                 & (jnp.abs(theta_c - th_i) < jnp.deg2rad(6.0)))
        s = jnp.where(close, -1.0, s)
        # unfilled slots get +inf-ish rho so they sort last
        rho_acc = rho_acc.at[n].set(jnp.where(ok, rho_i, 1e9))
        th_acc = th_acc.at[n].set(jnp.where(ok, th_i, 0.0))
        return (s, rho_acc, th_acc, n + ok.astype(jnp.int32)), ok

    init = (strength, jnp.full(count, 1e9), jnp.zeros(count), jnp.int32(0))
    (s, rhos, thetas, n), oks = jax.lax.scan(body, init, None, length=count)
    order = jnp.argsort(rhos)
    return rhos[order], thetas[order], n


@geometry
def find_chessboard_corners(img: jax.Array,
                            config: CheckerboardConfig = CheckerboardConfig()
                            ) -> CheckerboardResult:
    """Detect the (rows x cols) inner-corner grid of a chessboard image."""
    h, w = img.shape
    edges = canny(img, config.canny)
    n_lines_cap = 8 * (config.rows + config.cols)
    lines = hough_sht(edges, HoughShtConfig(
        threshold=config.hough_threshold, max_lines=n_lines_cap,
        theta_step_deg=1.0,
        # board edges are sparse line segments — 16k is ample and keeps the
        # accumulate small; overflow keeps strongest edges anyway
        max_edge_points=16384))

    # two dominant theta families: weighted circular histogram over theta
    nbins = 36
    tbin = jnp.clip((lines.theta / jnp.pi * nbins).astype(jnp.int32), 0,
                    nbins - 1)
    hist = jnp.zeros(nbins).at[tbin].add(
        jnp.where(lines.valid, lines.strength, 0.0))
    fam1_bin = jnp.argmax(hist)
    fam1_theta = (fam1_bin.astype(jnp.float32) + 0.5) * jnp.pi / nbins
    # second family: max of histogram at circular distance > 30 deg
    bins = jnp.arange(nbins)
    dist = jnp.abs(bins - fam1_bin)
    dist = jnp.minimum(dist, nbins - dist)
    hist2 = jnp.where(dist > nbins // 6, hist, -1.0)
    fam2_bin = jnp.argmax(hist2)
    fam2_theta = (fam2_bin.astype(jnp.float32) + 0.5) * jnp.pi / nbins

    tol = jnp.deg2rad(20.0)
    # 'horizontal' family = the one with theta closer to pi/2 (normal ~
    # vertical => line horizontal); corners ordered row-major
    d1 = jnp.abs(fam1_theta - jnp.pi / 2)
    d2 = jnp.abs(fam2_theta - jnp.pi / 2)
    h_theta = jnp.where(d1 < d2, fam1_theta, fam2_theta)
    v_theta = jnp.where(d1 < d2, fam2_theta, fam1_theta)

    # select up to rows+2 / cols+2 candidate lines per family — the board's
    # outer boundary contributes up to one extra line on each side
    # (reference prunes weak/extra lines by strength/GS,
    # calib_camera.cxx:169-189; we prune by X-corner support instead)
    nh = config.rows + 2
    nv = config.cols + 2
    h_rhos, h_thetas, n_h_found = _select_family(lines, h_theta, tol, nh,
                                                 config.merge_rho)
    v_rhos, v_thetas, n_v_found = _select_family(lines, v_theta, tol, nv,
                                                 config.merge_rho)

    # all candidate intersections (nh, nv)
    cx, cy = line_intersections(
        h_rhos[:, None], h_thetas[:, None], v_rhos[None, :], v_thetas[None, :])

    # X-corner (saddle) response at each intersection: for a true inner
    # corner the two diagonal pixel pairs have opposite colors; boundary
    # intersections score lower. Sampled at two radii for scale robustness.
    f = img.astype(jnp.float32)

    def saddle(px, py):
        resp = 0.0
        for d in (3.0, 6.0):
            def sample(dx, dy):
                xs = jnp.clip(px + dx, 0.0, w - 1.0)
                ys = jnp.clip(py + dy, 0.0, h - 1.0)
                x0 = jnp.floor(xs).astype(jnp.int32)
                y0 = jnp.floor(ys).astype(jnp.int32)
                return f[y0, x0]
            a = sample(d, d)
            b = sample(d, -d)
            c = sample(-d, -d)
            e = sample(-d, d)
            resp = resp + jnp.abs((a + c) - (b + e))
        return resp

    resp = saddle(cx, cy)                                # (nh, nv)
    inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    resp = jnp.where(inside, resp, -1e6)

    # pick the contiguous rows x cols window with maximal summed response
    # (the inner-corner grid); 3x3 static candidates
    best_score = -jnp.inf
    best_r0 = 0
    best_c0 = 0
    scores = []
    for r0 in range(nh - config.rows + 1):
        for c0 in range(nv - config.cols + 1):
            sc = jnp.sum(jax.lax.dynamic_slice(
                resp, (r0, c0), (config.rows, config.cols)))
            scores.append((r0, c0, sc))
    score_arr = jnp.stack([s for (_, _, s) in scores])
    best_i = jnp.argmax(score_arr)
    offsets = jnp.asarray([(r0, c0) for (r0, c0, _) in scores], jnp.int32)
    r0 = offsets[best_i, 0]
    c0 = offsets[best_i, 1]

    sel_cx = jax.lax.dynamic_slice(cx, (r0, c0), (config.rows, config.cols))
    sel_cy = jax.lax.dynamic_slice(cy, (r0, c0), (config.rows, config.cols))
    sel_in = jax.lax.dynamic_slice(inside, (r0, c0),
                                   (config.rows, config.cols))

    # canonicalize grid orientation: rho-ascending order depends on the
    # family center's hemisphere (theta ~ 175 deg => rho ~ -x, reversing
    # columns). Force x increasing along columns and y increasing along rows
    # so every view labels corners identically (row-major, +x right, +y down).
    flip_cols = sel_cx[0, -1] < sel_cx[0, 0]
    flip_rows = sel_cy[-1, 0] < sel_cy[0, 0]
    sel_cx = jnp.where(flip_cols, sel_cx[:, ::-1], sel_cx)
    sel_cy = jnp.where(flip_cols, sel_cy[:, ::-1], sel_cy)
    sel_cx = jnp.where(flip_rows, sel_cx[::-1, :], sel_cx)
    sel_cy = jnp.where(flip_rows, sel_cy[::-1, :], sel_cy)
    corners = jnp.stack([sel_cx.ravel(), sel_cy.ravel()], axis=1)

    # validity: enough family lines + all corners inside the image + the
    # grid must be projectively consistent (a homography from the unit
    # grid must fit with small residual — random-noise intersections fail
    # this, real boards pass at ~hough-quantization level)
    from compv_tpu.calib.homography import compute_homography_dlt
    from compv_tpu.math.transform import apply_homography
    uy, ux = np.mgrid[0:config.rows, 0:config.cols].astype(np.float32)
    unit = jnp.asarray(np.stack([ux.ravel(), uy.ravel()], 1))
    hg = compute_homography_dlt(unit, corners)
    fit = apply_homography(hg, unit)
    grid_rms = jnp.sqrt(jnp.mean(jnp.sum((fit - corners) ** 2, axis=1)))
    ok = ((n_h_found >= config.rows) & (n_v_found >= config.cols)
          & jnp.all(sel_in) & (grid_rms < config.grid_tolerance))

    sel_hr = jax.lax.dynamic_slice(h_rhos, (r0,), (config.rows,))
    sel_ht = jax.lax.dynamic_slice(h_thetas, (r0,), (config.rows,))
    sel_vr = jax.lax.dynamic_slice(v_rhos, (c0,), (config.cols,))
    sel_vt = jax.lax.dynamic_slice(v_thetas, (c0,), (config.cols,))
    return CheckerboardResult(
        corners=corners, valid=ok,
        h_lines=Lines(sel_hr, sel_ht, jnp.ones(config.rows),
                      jnp.ones(config.rows, bool)),
        v_lines=Lines(sel_vr, sel_vt, jnp.ones(config.cols),
                      jnp.ones(config.cols, bool)),
    )
