"""End-to-end incremental monocular SfM over an image sequence.

This is BASELINE.json's headline config: ORB frontend -> descriptor
matching -> essential-matrix bootstrap -> PnP registration of subsequent
frames -> two-view triangulation -> global bundle adjustment -> trajectory
evaluated as ATE RMSE against ground truth (slam/evaluate.py). The
reference has no SfM (it stops at calibration, core/calib/
compv_core_calib_camera.cxx); the goldens for this pipeline are
self-established and locked in goldens/sfm.json.

Structure: all per-frame / per-pair compute is jitted (ORB, KNN match,
essential RANSAC, PnP RANSAC, triangulation, BA); the sequence loop and
track bookkeeping are host-side numpy — frames arrive from IO serially
anyway and the table ops are O(features) int bookkeeping.

Also provides render_orbit_sequence(): a synthetic two-plane textured
scene observed by an orbiting camera with exact ground-truth poses — the
benchmark sequence used by tests/test_sfm.py and bench.py (no binary
fixtures in-repo; same policy as tests/fixtures.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.calib.epipolar import (
    EssentialConfig, find_essential, triangulate_points,
)
from compv_tpu.calib.pnp import PnpConfig, solve_pnp
from compv_tpu.features.orb import OrbConfig, orb_detect_describe
from compv_tpu.image.remap import warp_perspective
from compv_tpu.matchers.bruteforce import knn_match
from compv_tpu.slam.ba import (
    BAConfig, BAProblem, ba_residuals, ba_solve, reproj_rmse,
    rodrigues_to_matrix,
)
from compv_tpu.slam.evaluate import ate_rmse
from compv_tpu.precision import geometry

__all__ = ["SfmConfig", "SfmResult", "render_orbit_sequence", "run_sfm"]


# --------------------------------------------------------- synthetic sequence

def _plane_texture(h: int, w: int, seed: int, bg: bool) -> np.ndarray:
    """Corner-rich, locally UNIQUE 8-bit texture: overlapping random
    rectangles of random intensity over a low-frequency ramp. No repeating
    pattern — repetitive textures (checkerboards) defeat the ratio test
    and starve the matcher."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 110 + 40 * np.sin(xx / 61.0) + 30 * np.cos(yy / 53.0)
    n_rects = (h * w) // 300
    for _ in range(n_rects):
        cy = int(rs.integers(0, h - 4))
        cx = int(rs.integers(0, w - 4))
        rh = int(rs.integers(4, 18))
        rw = int(rs.integers(4, 18))
        img[cy:cy + rh, cx:cx + rw] = rs.uniform(10, 245)
    return np.clip(img, 0, 255).astype(np.uint8)


def _look_at(center: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->camera rotation for a camera at ``center`` looking at
    ``target`` (camera z forward, y down — image convention)."""
    f = target - center
    f = f / np.linalg.norm(f)
    up = np.array([0.0, -1.0, 0.0])
    r_ = np.cross(up, f)
    r_ = r_ / np.linalg.norm(r_)
    u = np.cross(f, r_)
    return np.stack([r_, u, f])       # rows: right, down(-up), forward


def render_orbit_sequence(n_frames: int = 8, h: int = 240, w: int = 320,
                          seed: int = 7):
    """Render a camera arcing past two textured fronto-parallel planes
    (z=5 front patch, z=8 background). Returns (frames (N,H,W) u8,
    gt_centers (N,3) f64, K (3,3) f32). Planes at two depths make the
    scene non-planar, so the essential-matrix bootstrap is well-posed."""
    f = 0.9 * w
    k = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]], np.float32)
    # plane extents in world units sized to fill the view at their depth
    planes = [
        # (depth, x-range, y-range, texture, is_background)
        (8.0, (-10.0, 10.0), (-7.5, 7.5), _plane_texture(760, 1000, seed, True)),
        (5.0, (-2.2, 1.4), (-1.8, 1.2), _plane_texture(420, 500, seed + 1, False)),
    ]
    t = np.linspace(0.0, 1.0, n_frames)
    centers = np.stack([1.6 * np.sin(t * 0.9),
                        0.35 * np.sin(t * 1.7),
                        0.8 * t], axis=1)
    target = np.array([0.0, 0.0, 6.5])

    frames = []
    for i in range(n_frames):
        r = _look_at(centers[i], target)
        tv = -r @ centers[i]
        img = jnp.zeros((h, w), jnp.float32)
        for depth, (xa, xb), (ya, yb), tex in planes:
            th, tw = tex.shape
            # plane (x,y) -> image: H = K [r1 r2 d*r3+t]
            hp = k @ np.stack([r[:, 0], r[:, 1], depth * r[:, 2] + tv], axis=1)
            # texture px -> plane coords (affine)
            a = np.array([[(xb - xa) / (tw - 1), 0, xa],
                          [0, (yb - ya) / (th - 1), ya],
                          [0, 0, 1.0]])
            h_tex2img = hp @ a
            h_img2tex = np.linalg.inv(h_tex2img)
            warped = warp_perspective(jnp.asarray(tex), jnp.asarray(
                h_img2tex, jnp.float32), h, w).astype(jnp.float32)
            m = warp_perspective(jnp.full((th, tw), 255, jnp.uint8),
                                 jnp.asarray(h_img2tex, jnp.float32),
                                 h, w).astype(jnp.float32) / 255.0
            img = img * (1 - m) + warped * m
        frames.append(np.asarray(jnp.clip(img, 0, 255).astype(jnp.uint8)))
    return np.stack(frames), centers, k


# ----------------------------------------------------------------- pipeline

@dataclass(frozen=True)
class SfmConfig:
    orb: OrbConfig = OrbConfig(max_features=512, levels=4)
    essential: EssentialConfig = EssentialConfig(num_hypotheses=512,
                                                 threshold=1e-4)
    pnp: PnpConfig = PnpConfig(num_hypotheses=256, threshold=1e-4)
    ba: BAConfig = BAConfig(iterations=12, cg_iterations=30, robust_delta=3.0)
    local_ba: BAConfig = BAConfig(iterations=5, cg_iterations=25,
                                  robust_delta=3.0)
    ratio: float = 0.8
    solver: str = "cg"              # "cg" (matrix-free GN) | "schur"
                                    # (explicit Schur elimination,
                                    # slam/ba_schur.py); both apply the
                                    # robust_delta IRLS whitening
    local_window: int | None = None  # windowed local BA: only cameras in
                                    # [i-window, i] move (older cameras
                                    # freeze and anchor the gauge) and only
                                    # their observations enter the solve —
                                    # bounded per-frame cost on long runs
    checkpoint_every: int | None = None  # ALSO checkpoint every N frames
                                    # (requires checkpoint_dir)
    max_landmarks: int = 4096
    max_obs: int = 16384            # fixed obs capacity: one BA compile
    min_bootstrap_flow: float = 0.05  # median (0,b) match flow, fraction of
                                      # width, before the pair can bootstrap
    min_parallax_deg: float = 0.6   # reject low-parallax triangulations
    prune_px: float = 4.0           # drop observations with post-BA residual
                                    # above this, then re-solve


class SfmResult(NamedTuple):
    positions: np.ndarray       # (N, 3) estimated camera centers
    cameras: np.ndarray         # (N, 6) [rvec|tvec] world->camera
    landmarks: np.ndarray       # (L, 3) world points (padded)
    landmark_valid: np.ndarray  # (L,) bool
    reproj_before: float        # px RMSE entering BA
    reproj_after: float         # px RMSE after BA
    num_tracks: int
    num_obs: int
    frame_stats: list           # per-frame dicts: PnP inliers, map points...


@partial(jax.jit, static_argnames=("ratio",))
def _match_step(desc1, valid1, desc2, valid2, ratio: float):
    m = knn_match(desc1, desc2, valid1, valid2, k=2)
    ok = m.valid[0] & m.valid[1] & (m.distance[0] < ratio * m.distance[1])
    return m.train_idx[0], m.distance[0], ok


@jax.jit
@geometry
def _triangulate_pair(cam1, cam2, px1, px2, kinv):
    """Two-view triangulation with arbitrary known poses: normalize pixels,
    move to cam1 frame (relative pose), DLT-triangulate, map to world."""
    r1 = rodrigues_to_matrix(cam1[:3])
    r2 = rodrigues_to_matrix(cam2[:3])
    t1, t2 = cam1[3:], cam2[3:]
    r_rel = r2 @ r1.T
    t_rel = t2 - r_rel @ t1

    def norm(p):
        ph = jnp.concatenate([p, jnp.ones((p.shape[0], 1), p.dtype)], axis=1)
        q = ph @ kinv.T
        return q[:, :2] / q[:, 2:3]

    n1, n2 = norm(px1.astype(jnp.float32)), norm(px2.astype(jnp.float32))
    pts_c1 = triangulate_points(r_rel, t_rel, n1, n2)
    pts_w = (pts_c1 - t1) @ r1        # R1^T (Xc - t1), row-vector form
    # quality gates: positive depth in both cams + parallax
    z1 = pts_c1[:, 2]
    z2 = (pts_c1 @ r_rel.T + t_rel)[:, 2]
    c1 = -r1.T @ t1
    c2 = -r2.T @ t2
    v1 = pts_w - c1
    v2 = pts_w - c2
    cosang = jnp.sum(v1 * v2, axis=1) / jnp.maximum(
        jnp.linalg.norm(v1, axis=1) * jnp.linalg.norm(v2, axis=1), 1e-12)
    return pts_w, (z1 > 0.05) & (z2 > 0.05), cosang


def _dedup_matches(tidx: np.ndarray, dist: np.ndarray, ok: np.ndarray
                   ) -> np.ndarray:
    """One-to-one matches: among queries hitting the same train index keep
    the smallest distance. Returns refined ok mask."""
    ok = ok.copy()
    order = np.argsort(dist, kind="stable")
    seen = set()
    for q in order:
        if not ok[q]:
            continue
        t = int(tidx[q])
        if t in seen:
            ok[q] = False
        else:
            seen.add(t)
    return ok


@geometry
def run_sfm(frames: np.ndarray, k: np.ndarray,
            config: SfmConfig = SfmConfig(),
            checkpoint_dir: str | None = None) -> SfmResult:
    """Incremental SfM over (N, H, W) u8 frames with intrinsics K.
    Frame 0 is the world origin; global scale is arbitrary (monocular) —
    evaluate with scale-aligned ATE (slam/evaluate.ate_rmse).

    When ``checkpoint_dir`` is set, the full mid-sequence state (poses,
    landmarks, observation buffers) is checkpointed after registration and
    BEFORE the final global BA — the kill-point resume_sfm() recovers from,
    possibly on a different mesh size (SURVEY §5 failure/elastic recovery;
    tests/test_sfm.py::TestCheckpointResume)."""
    n_frames = len(frames)
    kj = jnp.asarray(k, jnp.float32)
    kinv = jnp.linalg.inv(kj)

    # --- frontend: detect + track
    obs = []   # per frame: (x, y, valid, desc) numpy
    for i in range(n_frames):
        r = orb_detect_describe(jnp.asarray(frames[i]), config.orb)
        obs.append((np.asarray(r.keypoints.x), np.asarray(r.keypoints.y),
                    np.asarray(r.keypoints.valid), r.descriptors,
                    r.keypoints.valid))

    cap = config.orb.max_features
    track_of = np.full((n_frames, cap), -1, np.int64)   # kp -> track id
    pair_matches: List[np.ndarray] = []                  # (q, t) arrays
    n_tracks = 0
    parent = []                                          # union-find over tracks

    def find(tr: int) -> int:
        while parent[tr] != tr:
            parent[tr] = parent[parent[tr]]
            tr = parent[tr]
        return tr

    def matched_pairs(a: int, b: int) -> np.ndarray:
        tidx, dist, ok = _match_step(obs[a][3], obs[a][4],
                                     obs[b][3], obs[b][4], config.ratio)
        tidx, dist, ok = np.asarray(tidx), np.asarray(dist), np.asarray(ok)
        ok = _dedup_matches(tidx, dist, ok)
        qs = np.nonzero(ok)[0]
        return np.stack([qs, tidx[qs]], axis=1)

    for i in range(1, n_frames):
        m = matched_pairs(i - 1, i)
        for q, t in m:
            tr = track_of[i - 1, q]
            if tr < 0:
                tr = n_tracks
                parent.append(tr)
                n_tracks += 1
                track_of[i - 1, q] = tr
            track_of[i, t] = tr
        pair_matches.append(m)
        # skip-pair (i-2, i): longer tracks couple the structure across
        # frames (pure consecutive chains leave monocular bending modes
        # weakly constrained)
        if i >= 2:
            for q, t in matched_pairs(i - 2, i):
                ta, tb = track_of[i - 2, q], track_of[i, t]
                if ta >= 0 and tb < 0:
                    track_of[i, t] = ta
                elif ta < 0 and tb >= 0:
                    track_of[i - 2, q] = tb
                elif ta >= 0 and tb >= 0 and find(ta) != find(tb):
                    parent[find(ta)] = find(tb)          # merge tracks

    # canonicalize merged track ids
    for fi in range(n_frames):
        for kp in range(cap):
            if track_of[fi, kp] >= 0:
                track_of[fi, kp] = find(track_of[fi, kp])

    # --- bootstrap pair selection: frame 0 vs the first frame with enough
    # median flow (dense temporal sampling of the same arc makes the (0,1)
    # baseline vanish; essential-matrix bootstrap needs REAL parallax, so
    # widen the pair like production SfM keyframe selection does)
    w_img = frames.shape[2]
    boot_flow = config.min_bootstrap_flow * w_img

    def merge_matches_into_tracks(a: int, bb: int, m: np.ndarray):
        nonlocal n_tracks
        for q, t in m:
            ta, tb_ = track_of[a, q], track_of[bb, t]
            if ta >= 0 and tb_ < 0:
                track_of[bb, t] = ta
            elif ta < 0 and tb_ >= 0:
                track_of[a, q] = tb_
            elif ta < 0 and tb_ < 0:
                tr = n_tracks
                parent.append(tr)
                n_tracks += 1
                track_of[a, q] = tr
                track_of[bb, t] = tr
            elif find(ta) != find(tb_):
                parent[find(ta)] = find(tb_)

    b, m0b = 1, pair_matches[0]
    for j in range(1, n_frames):
        m = pair_matches[0] if j == 1 else matched_pairs(0, j)
        if len(m) < 30:
            break           # matching against frame 0 is degrading: stop
        if j > 1:
            merge_matches_into_tracks(0, j, m)
        b, m0b = j, m
        flow = float(np.median(np.hypot(
            obs[j][0][m[:, 1]] - obs[0][0][m[:, 0]],
            obs[j][1][m[:, 1]] - obs[0][1][m[:, 0]])))
        if flow >= boot_flow:
            break

    # re-canonicalize after the bootstrap merges
    for fi in range(n_frames):
        live = track_of[fi] >= 0
        track_of[fi, live] = [find(t) for t in track_of[fi, live]]

    # --- bootstrap: essential matrix on pair (0, b)
    pad = cap  # fixed capacity for the jitted RANSAC
    src = np.zeros((pad, 2), np.float32)
    dst = np.zeros((pad, 2), np.float32)
    msk = np.zeros((pad,), bool)
    nm = len(m0b)
    src[:nm] = np.stack([obs[0][0][m0b[:, 0]], obs[0][1][m0b[:, 0]]], axis=1)
    dst[:nm] = np.stack([obs[b][0][m0b[:, 1]], obs[b][1][m0b[:, 1]]], axis=1)
    msk[:nm] = True
    eres = find_essential(jnp.asarray(src), jnp.asarray(dst), kj,
                          jnp.asarray(msk), config.essential)
    cams = np.zeros((n_frames, 6), np.float32)
    cams[b, :3] = np.asarray(eres.rvec)
    cams[b, 3:] = np.asarray(eres.tvec)

    # landmarks from the bootstrap triangulation (world = cam0 frame)
    lm_cap = config.max_landmarks
    landmarks = np.zeros((lm_cap, 3), np.float32)
    lm_valid = np.zeros((lm_cap,), bool)
    lm_of_track = np.full((n_tracks + 1,), -1, np.int64)
    n_lms = 0
    pts = np.asarray(eres.points3d)
    inl = np.asarray(eres.inliers)
    min_cos = np.cos(np.deg2rad(config.min_parallax_deg))
    for j in range(nm):
        if not inl[j] or n_lms >= lm_cap:
            continue
        tr = track_of[0, m0b[j, 0]]
        if tr < 0 or lm_of_track[tr] >= 0:
            continue   # track already has a landmark: don't leak a slot
        landmarks[n_lms] = pts[j]
        lm_valid[n_lms] = True
        lm_of_track[tr] = n_lms
        n_lms += 1

    # first REGISTERED observation of each track — the wide-baseline anchor
    # for later triangulation
    tr_first_frame = np.full((n_tracks + 1,), -1, np.int64)
    tr_first_kp = np.zeros((n_tracks + 1,), np.int64)

    def note_first_obs(fi: int):
        kps = np.nonzero(track_of[fi] >= 0)[0]
        trs = track_of[fi, kps]
        new = tr_first_frame[trs] < 0
        tr_first_frame[trs[new]] = fi
        tr_first_kp[trs[new]] = kps[new]

    registered = np.zeros((n_frames,), bool)
    registered[0] = registered[b] = True
    note_first_obs(0)
    note_first_obs(b)

    # --- fixed-capacity BA buffers: ONE jitted solve reused per frame
    oc = config.max_obs
    ob_ci = np.zeros((oc,), np.int32)
    ob_li = np.zeros((oc,), np.int32)
    ob_uv = np.zeros((oc, 2), np.float32)
    ob_ok = np.zeros((oc,), bool)
    intr = jnp.asarray([k[0, 0], k[1, 1], k[0, 2], k[1, 2]], jnp.float32)

    obs_x = np.stack([o[0] for o in obs])    # (F, cap) keypoint tables
    obs_y = np.stack([o[1] for o in obs])

    def rebuild_obs() -> int:
        """Fill the padded obs buffers with every (registered frame,
        landmark) observation implied by the track tables. Returns the live
        count. Vectorized numpy table ops (was an O(frames*cap) Python
        double loop); fi-major/kp-minor order."""
        ob_ok[:] = False
        sub = np.where(registered[:, None], track_of, -1)   # (F, cap)
        fis, kps = np.nonzero(sub >= 0)
        trs = sub[fis, kps]
        lms = lm_of_track[trs]
        sel = (lms >= 0) & lm_valid[np.maximum(lms, 0)]
        fis, kps, lms = fis[sel], kps[sel], lms[sel]
        cnt = len(fis)
        if cnt > oc:
            # no-silent-caps policy: losing BA constraints must be loud
            import warnings
            warnings.warn(
                f"obs buffer saturated: {cnt} observations > max_obs={oc}; "
                f"dropping {cnt - oc} BA constraints — raise SfmConfig."
                f"max_obs", RuntimeWarning, stacklevel=2)
            fis, kps, lms = fis[:oc], kps[:oc], lms[:oc]
            cnt = oc
        ob_ci[:cnt] = fis
        ob_li[:cnt] = lms
        ob_uv[:cnt, 0] = obs_x[fis, kps]
        ob_uv[:cnt, 1] = obs_y[fis, kps]
        ob_ok[:cnt] = True
        return cnt

    def run_ba(cfg: BAConfig, frame_lo: int | None = None):
        """Solve BA over the current buffers; write back cams/landmarks.
        ``frame_lo`` activates the sliding window: cameras < frame_lo
        freeze, and observations from one EXTRA window of frozen frames
        stay in the solve as anchors — frozen-camera constraints are what
        glue the window to the global map (dropping them let landmarks
        drift with the window: a 128-frame probe scored ATE 27% of span
        with obs-masked windows; reproj stayed 0.7 px — the signature of
        a consistently corroding map)."""
        nonlocal cams
        cmask = None
        ok = ob_ok
        if frame_lo is not None:
            win = config.local_window or n_frames
            anchor_lo = max(frame_lo - win, 0)
            ok = ob_ok & (ob_ci >= anchor_lo)
            cmask = jnp.asarray(np.arange(n_frames) >= frame_lo)
        prob = BAProblem(
            cameras=jnp.asarray(cams), landmarks=jnp.asarray(landmarks),
            intrinsics=intr, cam_idx=jnp.asarray(ob_ci),
            lm_idx=jnp.asarray(ob_li), uv=jnp.asarray(ob_uv),
            valid=jnp.asarray(ok))
        if config.solver == "schur":
            from compv_tpu.slam.ba_schur import SchurConfig, ba_solve_schur
            scfg = SchurConfig(iterations=cfg.iterations,
                               damping=cfg.damping,
                               robust_delta=cfg.robust_delta)
            solved, _ = ba_solve_schur(prob, scfg, cam_mask=cmask)
        else:
            solved, _ = ba_solve(prob, cfg, cam_mask=cmask)
        cams = np.array(solved.cameras)          # writable copy
        landmarks[:] = np.asarray(solved.landmarks)
        return solved

    # polish the two-view bootstrap before the first PnP
    rebuild_obs()
    run_ba(config.local_ba)

    # --- register remaining frames with PnP, extend the map
    p3 = np.zeros((pad, 3), np.float32)
    p2 = np.zeros((pad, 2), np.float32)
    stats_of = {b: {"map_pts": nm, "pnp_inliers": int(eres.num_inliers)}}
    for i in [f for f in range(1, n_frames) if f != b]:
        xs, ys, _, _, _ = obs[i]
        p3[:] = 0.0
        p2[:] = 0.0
        pm = np.zeros((pad,), bool)
        # vectorized 2D-3D correspondence assembly (track -> landmark join)
        trs_i = track_of[i]
        kp_sel = np.nonzero(trs_i >= 0)[0]
        lms_i = lm_of_track[trs_i[kp_sel]]
        ok_i = (lms_i >= 0) & lm_valid[np.maximum(lms_i, 0)]
        kp_sel, lms_i = kp_sel[ok_i][:pad], lms_i[ok_i][:pad]
        cnt = len(kp_sel)
        p3[:cnt] = landmarks[lms_i]
        p2[:cnt, 0] = xs[kp_sel]
        p2[:cnt, 1] = ys[kp_sel]
        pm[:cnt] = True
        if cnt < 8:
            # not enough map points: constant-velocity fallback from the
            # nearest registered predecessors (identity-extend at the start)
            prev = [f for f in range(i) if registered[f]]
            if len(prev) >= 2:
                cams[i] = 2 * cams[prev[-1]] - cams[prev[-2]]
            else:
                cams[i] = cams[prev[-1]] if prev else 0.0
            stats_of[i] = {"map_pts": cnt, "pnp_inliers": 0}
        else:
            pres = solve_pnp(jnp.asarray(p3), jnp.asarray(p2), kj,
                             jnp.asarray(pm), config.pnp)
            cams[i, :3] = np.asarray(pres.rvec)
            cams[i, 3:] = np.asarray(pres.tvec)
            stats_of[i] = {"map_pts": cnt,
                           "pnp_inliers": int(pres.num_inliers)}
        registered[i] = True

        # triangulate unlandmarked tracks seen in frame i against their
        # FIRST registered observation — the widest available baseline
        # (consecutive-pair baselines vanish as temporal sampling densifies)
        kps_i = np.nonzero(track_of[i] >= 0)[0]
        trs_i = track_of[i, kps_i]
        f0s = tr_first_frame[trs_i]
        cand = (lm_of_track[trs_i] < 0) & (f0s >= 0) & (f0s != i)
        for f0 in np.unique(f0s[cand]):
            rows = kps_i[cand & (f0s == f0)][:pad]
            trs_r = track_of[i, rows]
            kp0 = tr_first_kp[trs_r]
            nn = len(rows)
            px1 = np.zeros((pad, 2), np.float32)
            px2 = np.zeros((pad, 2), np.float32)
            px1[:nn] = np.stack([obs_x[f0, kp0], obs_y[f0, kp0]], axis=1)
            px2[:nn] = np.stack([obs_x[i, rows], obs_y[i, rows]], axis=1)
            pts_w, depth_ok, cosang = _triangulate_pair(
                jnp.asarray(cams[f0]), jnp.asarray(cams[i]),
                jnp.asarray(px1), jnp.asarray(px2), kinv)
            pts_w = np.asarray(pts_w)
            good = np.asarray(depth_ok) & (np.asarray(cosang) < min_cos)
            for j in range(nn):
                if not good[j] or n_lms >= lm_cap:
                    continue
                tr = trs_r[j]
                if lm_of_track[tr] >= 0:
                    continue   # another row of this batch claimed the track
                landmarks[n_lms] = pts_w[j]
                lm_valid[n_lms] = True
                lm_of_track[tr] = n_lms
                n_lms += 1
        note_first_obs(i)

        # local BA (drift control): everything registered so far, or the
        # sliding window when config.local_window is set
        if i % 16 == 0:
            from compv_tpu.profiling import log as _log
            _log.info(f"sfm: registered frame {i}/{n_frames} "
                      f"(landmarks={n_lms}, obs~{int(ob_ok.sum())})")
        rebuild_obs()
        lo = None if config.local_window is None else \
            max(i - config.local_window, 0)
        run_ba(config.local_ba, frame_lo=lo)
        if (checkpoint_dir is not None and config.checkpoint_every
                and i % config.checkpoint_every == 0):
            from compv_tpu.io.serialize import save_checkpoint
            save_checkpoint(checkpoint_dir, n_frames, {
                "cams": cams, "landmarks": landmarks, "lm_valid": lm_valid,
                "ob_ci": ob_ci, "ob_li": ob_li, "ob_uv": ob_uv,
                "ob_ok": ob_ok, "k": np.asarray(k, np.float32),
                "n_tracks": np.array([n_tracks], np.int32),
                "n_obs": np.array([int(ob_ok.sum())], np.int32)})

    frame_stats = [stats_of[i] for i in sorted(stats_of)]
    # --- final global BA + outlier prune + re-solve
    n_obs = rebuild_obs()
    if checkpoint_dir is not None:
        from compv_tpu.io.serialize import save_checkpoint
        save_checkpoint(checkpoint_dir, n_frames, {
            "cams": cams, "landmarks": landmarks, "lm_valid": lm_valid,
            "ob_ci": ob_ci, "ob_li": ob_li, "ob_uv": ob_uv, "ob_ok": ob_ok,
            "k": np.asarray(k, np.float32),
            "n_tracks": np.array([n_tracks], np.int32),
            "n_obs": np.array([n_obs], np.int32)})
    return _finalize_sfm(cams, landmarks, lm_valid, ob_ci, ob_li, ob_uv,
                         ob_ok, intr, config, n_tracks, n_obs, frame_stats)


def _finalize_sfm(cams, landmarks, lm_valid, ob_ci, ob_li, ob_uv, ob_ok,
                  intr, config: SfmConfig, n_tracks: int, n_obs: int,
                  frame_stats: list, mesh=None) -> SfmResult:
    """Final global BA + outlier prune + re-solve + camera centers. With a
    ``mesh``, each BA runs distributed (observations sharded over the mesh
    "frame" axis, parameters replicated) — the resume path re-shards the
    checkpointed buffers onto whatever mesh is available."""
    n_frames = cams.shape[0]
    cams = np.array(cams)
    landmarks = np.array(landmarks)
    ob_ok = np.array(ob_ok)

    def solve(ci, li, uv, ok, c, lm, cfg):
        prob = BAProblem(
            cameras=jnp.asarray(c), landmarks=jnp.asarray(lm),
            intrinsics=intr, cam_idx=jnp.asarray(ci),
            lm_idx=jnp.asarray(li), uv=jnp.asarray(uv),
            valid=jnp.asarray(ok))
        if mesh is None:
            if config.solver == "schur":
                from compv_tpu.slam.ba_schur import (SchurConfig,
                                                     ba_solve_schur)
                solved, _ = ba_solve_schur(
                    prob, SchurConfig(iterations=cfg.iterations,
                                      damping=cfg.damping,
                                      robust_delta=cfg.robust_delta))
            else:
                solved, _ = ba_solve(prob, cfg)
            return solved
        from compv_tpu.parallel.sharded import distributed_ba_solve
        import jax as _jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        d = mesh.devices.size
        pad_n = (-len(ci)) % d
        if pad_n:
            zpad = lambda a, fill=0: np.concatenate(
                [np.asarray(a),
                 np.full((pad_n,) + np.asarray(a).shape[1:],
                         fill, np.asarray(a).dtype)])
            ci, li = zpad(ci), zpad(li)
            uv, ok = zpad(uv), zpad(ok, False)
            prob = BAProblem(
                cameras=jnp.asarray(c), landmarks=jnp.asarray(lm),
                intrinsics=intr, cam_idx=jnp.asarray(ci),
                lm_idx=jnp.asarray(li), uv=jnp.asarray(uv),
                valid=jnp.asarray(ok))
        sh = NamedSharding(mesh, P("frame"))
        rp = NamedSharding(mesh, P())
        prob = BAProblem(
            cameras=_jax.device_put(prob.cameras, rp),
            landmarks=_jax.device_put(prob.landmarks, rp),
            intrinsics=_jax.device_put(prob.intrinsics, rp),
            cam_idx=_jax.device_put(prob.cam_idx, sh),
            lm_idx=_jax.device_put(prob.lm_idx, sh),
            uv=_jax.device_put(prob.uv, sh),
            valid=_jax.device_put(prob.valid, sh))
        solved, _ = distributed_ba_solve(prob, mesh, cfg)
        return solved

    prob0 = BAProblem(
        cameras=jnp.asarray(cams), landmarks=jnp.asarray(landmarks),
        intrinsics=intr, cam_idx=jnp.asarray(ob_ci),
        lm_idx=jnp.asarray(ob_li), uv=jnp.asarray(ob_uv),
        valid=jnp.asarray(ob_ok))
    before = float(reproj_rmse(prob0))
    solved = solve(ob_ci, ob_li, ob_uv, ob_ok, cams, landmarks, config.ba)
    cams = np.asarray(solved.cameras[:n_frames])
    landmarks = np.asarray(solved.landmarks)
    # prune observations the robust kernel flagged as outliers, re-solve
    r = np.asarray(ba_residuals(solved.cameras, solved.landmarks, solved))
    ob_ok[:] = (np.linalg.norm(r[:len(ob_ok)], axis=1)
                <= config.prune_px) & ob_ok
    solved = solve(ob_ci, ob_li, ob_uv, ob_ok, cams, landmarks, config.ba)
    after = float(reproj_rmse(solved))

    cams_f = np.asarray(solved.cameras)
    centers = np.zeros((n_frames, 3))
    for i in range(n_frames):
        r = np.asarray(rodrigues_to_matrix(jnp.asarray(cams_f[i, :3])))
        centers[i] = -r.T @ cams_f[i, 3:]
    lms_out = np.asarray(solved.landmarks)
    return SfmResult(positions=centers, cameras=cams_f, landmarks=lms_out,
                     landmark_valid=np.array(lm_valid),
                     reproj_before=before,
                     reproj_after=after, num_tracks=n_tracks, num_obs=n_obs,
                     frame_stats=frame_stats)


@geometry
def resume_sfm(checkpoint_path: str, config: SfmConfig = SfmConfig(),
               mesh=None) -> SfmResult:
    """Resume an SfM run from a checkpoint written by run_sfm(...,
    checkpoint_dir=...): reload the mid-sequence state and complete the
    final global BA + prune + re-solve — on ``mesh`` if given, which may
    be a DIFFERENT size than the mesh (or single device) the checkpoint
    was written under. This is the §5 elastic-recovery contract: state is
    mesh-agnostic (replicated parameters + resharding-friendly observation
    buffers), so a job killed at N devices resumes at M."""
    from compv_tpu.io.serialize import load_checkpoint
    like = {"cams": np.zeros((0, 6), np.float32),
            "landmarks": np.zeros((0, 3), np.float32),
            "lm_valid": np.zeros((0,), bool),
            "ob_ci": np.zeros((0,), np.int32),
            "ob_li": np.zeros((0,), np.int32),
            "ob_uv": np.zeros((0, 2), np.float32),
            "ob_ok": np.zeros((0,), bool),
            "k": np.zeros((3, 3), np.float32),
            "n_tracks": np.zeros((1,), np.int32),
            "n_obs": np.zeros((1,), np.int32)}
    st = load_checkpoint(checkpoint_path, like)
    intr_mat = np.asarray(st["k"])
    intr = jnp.asarray([intr_mat[0, 0], intr_mat[1, 1],
                        intr_mat[0, 2], intr_mat[1, 2]], jnp.float32)
    return _finalize_sfm(np.asarray(st["cams"]), np.asarray(st["landmarks"]),
                         np.asarray(st["lm_valid"]), np.asarray(st["ob_ci"]),
                         np.asarray(st["ob_li"]), np.asarray(st["ob_uv"]),
                         np.asarray(st["ob_ok"]), intr, config,
                         int(np.asarray(st["n_tracks"]).ravel()[0]),
                         int(np.asarray(st["n_obs"]).ravel()[0]), [],
                         mesh=mesh)


def sfm_ate(frames: np.ndarray, gt_centers: np.ndarray, k: np.ndarray,
            config: SfmConfig = SfmConfig()):
    """Convenience: run_sfm + scale-aligned ATE RMSE vs ground truth.
    Returns (ate, result)."""
    res = run_sfm(frames, k, config)
    ate = float(ate_rmse(jnp.asarray(res.positions),
                         jnp.asarray(gt_centers), with_scale=True))
    return ate, res
