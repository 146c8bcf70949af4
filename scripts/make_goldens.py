"""Generate goldens/goldens.json — the cross-round regression net.

The reference's whole test philosophy is golden values checked into the
tree: FAST count/Σstrength/Σx/Σy tables (unittests/feature_fast.cxx:18-60)
and MD5s of output buffers (tests/tests_common.cxx:98-116). This script
locks the same style of values for this framework on the CPU backend
(the deterministic test platform); tests/test_goldens.py asserts them.

Regenerate ONLY when an intentional semantic change is made:
    python scripts/make_goldens.py
and review the diff — every changed hash is a behavior change.
"""
import json
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from compv_tpu.core.golden import keypoint_summary, quantized_hash  # noqa: E402
from compv_tpu.native_rt import md5_mat  # noqa: E402
from tests.fixtures import make_test_image, make_test_rgb  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "goldens", "goldens.json")


def build() -> dict:
    from compv_tpu.calib.homography import HomographyConfig, find_homography
    from compv_tpu.features.fast import FastConfig, fast_detect
    from compv_tpu.image.color import rgb_to_gray, rgb_to_hsv
    from compv_tpu.image.integral import integral
    from compv_tpu.image.morph import dilate, erode
    from compv_tpu.image.scale import scale_bilinear
    from compv_tpu.image.threshold import otsu_value, threshold_otsu

    gray = jnp.asarray(make_test_image())
    rgb = jnp.asarray(make_test_rgb())
    g = {}

    # --- FAST golden tuples (reference: unittests/feature_fast.cxx:31-41)
    for n, thr, nms in [(9, 20, True), (9, 20, False), (12, 40, True),
                        (9, 40, True)]:
        kp = fast_detect(gray, FastConfig(threshold=thr, n=n, nms=nms,
                                          max_features=8192))
        g[f"fast{n}_thr{thr}_nms{int(nms)}"] = keypoint_summary(kp)

    # --- image ops: exact MD5 of integer outputs (native md5_mat — the
    # reference's compv_tests_md5 analogue)
    g["md5_to_gray"] = md5_mat(np.asarray(rgb_to_gray(rgb)))
    g["md5_rgb_to_hsv"] = md5_mat(np.asarray(rgb_to_hsv(rgb)))
    g["md5_scale_bilinear_299x401"] = md5_mat(
        np.asarray(scale_bilinear(gray, 299, 401)))
    binary = threshold_otsu(gray)[0]
    g["md5_erode_3x3"] = md5_mat(np.asarray(erode(binary)))
    g["md5_dilate_3x3"] = md5_mat(np.asarray(dilate(binary)))
    g["md5_integral"] = md5_mat(
        np.asarray(integral(gray, jnp.float64)).astype(np.int64))
    g["otsu_value"] = int(otsu_value(gray))

    # --- estimation: quantized hash + values of a RANSAC homography on a
    # deterministic correspondence set with outliers
    rs = np.random.default_rng(11)
    src = rs.uniform(20, 400, (200, 2)).astype(np.float32)
    h_true = np.array([[0.95, 0.08, 12.0], [-0.06, 1.02, -7.0],
                       [1e-4, -8e-5, 1.0]], np.float32)
    p = np.concatenate([src, np.ones((200, 1), np.float32)], 1) @ h_true.T
    dst = (p[:, :2] / p[:, 2:]).astype(np.float32)
    dst[150:] += rs.uniform(40, 90, (50, 2)).astype(np.float32)  # outliers
    res = find_homography(jnp.asarray(src), jnp.asarray(dst),
                          jnp.ones(200, bool),
                          HomographyConfig(num_hypotheses=256))
    hm = np.asarray(res.h) / np.asarray(res.h)[2, 2]
    g["homography_hash_q2"] = quantized_hash(hm, decimals=2)
    g["homography_inliers"] = int(res.num_inliers)

    # --- irregular kernels: CCL / SHT / MSER / BA
    # golden tuples for the determinism matrix's resharding axis
    from compv_tpu.core.golden import ccl_summary, lines_summary, mser_summary
    from compv_tpu.features.canny import CannyConfig, canny
    from compv_tpu.features.ccl import CclConfig, ccl_features
    from compv_tpu.features.hough import HoughShtConfig, hough_sht
    from compv_tpu.features.mser import MserConfig, mser_detect

    ccl_res = ccl_features(binary, CclConfig(max_components=2048))
    assert int(ccl_res.num_components) <= 2048, "raise the golden capacity"
    g["ccl_features_summary"] = ccl_summary(ccl_res)

    edges = canny(gray, CannyConfig())
    g["hough_sht_summary"] = lines_summary(hough_sht(edges, HoughShtConfig()))

    mres = mser_detect(gray[:160, :224], MserConfig(max_regions=64))
    assert int(mres.overflowed) == 0, "MSER golden must not overflow"
    g["mser_summary"] = mser_summary(mres)

    from compv_tpu.slam.ba import BAConfig, BAProblem, ba_step
    prob = _ba_golden_problem()
    p1, lam1, cost = ba_step(prob, jnp.float32(1e-3),
                             BAConfig(cg_iterations=8))
    g["ba_step_cost_before"] = round(float(cost), 1)
    g["ba_step_cam_hash_q3"] = quantized_hash(np.asarray(p1.cameras),
                                              decimals=3)
    return g


def _ba_golden_problem():
    """Deterministic 16-cam / 200-lm / 1600-obs BA problem (o divisible by
    8 so the matrix's distributed row shards it evenly)."""
    from compv_tpu.slam.ba import BAProblem
    rs = np.random.default_rng(23)
    f, l, o = 16, 200, 1600
    cams = np.concatenate([rs.normal(0, 0.05, (f, 3)),
                           rs.normal(0, 0.5, (f, 3)) + [0, 0, 4]], 1)
    lms = rs.normal(0, 1.5, (l, 3)) + [0, 0, 8]
    return BAProblem(jnp.asarray(cams, jnp.float32),
                     jnp.asarray(lms, jnp.float32),
                     jnp.asarray([400.0, 400.0, 240.0, 180.0], jnp.float32),
                     jnp.asarray(rs.integers(0, f, o), jnp.int32),
                     jnp.asarray(rs.integers(0, l, o), jnp.int32),
                     jnp.asarray(rs.normal(0, 40.0, (o, 2)) + 200,
                                 jnp.float32),
                     jnp.ones((o,), bool))


def _sfm_metrics(n_frames: int, h: int, w: int, config=None) -> dict:
    from compv_tpu.slam.evaluate import ate_rmse, rpe_rmse
    from compv_tpu.slam.sfm import SfmConfig, render_orbit_sequence, run_sfm

    frames, gt, k = render_orbit_sequence(n_frames, h, w)
    res = run_sfm(frames, k, config or SfmConfig())
    est = jnp.asarray(res.positions)
    gtj = jnp.asarray(gt)
    ate = float(ate_rmse(est, gtj, with_scale=True))
    rpe = float(rpe_rmse(est, gtj, delta=1))
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    return {
        "sequence": {"n_frames": n_frames, "h": h, "w": w, "seed": 7},
        "ate_rmse": round(ate, 5),
        "rpe_rmse": round(rpe, 5),
        "ate_pct_of_span": round(100.0 * ate / span, 2),
        "reproj_after_px": round(res.reproj_after, 4),
        "num_obs": res.num_obs,
        "num_tracks": res.num_tracks,
        "trajectory_span": round(span, 4),
    }


def build_sfm() -> dict:
    """SfM trajectory golden (BASELINE.json headline: ATE RMSE). Slower
    (~60 s), so gated behind --sfm. Writes goldens/sfm.json."""
    return _sfm_metrics(8, 240, 320)


def build_sfm_long() -> dict:
    """Longer/harder golden: 32 frames at 480p with
    RPE. Gated behind --sfm-long. Writes goldens/sfm_long.json."""
    from compv_tpu.slam.sfm import SfmConfig
    cfg = SfmConfig(max_obs=65536, max_landmarks=8192)
    return _sfm_metrics(32, 480, 640, cfg)


def sfm_128_config():
    """The 128-frame production-shaped run: Schur
    solver, sliding-window local BA (8 frames, frozen-camera anchor
    observations), periodic checkpoints — exercises ba_step_schur,
    camera freezing, landmark capacity and checkpoint cadence at
    sequence scale. Locked at ATE 1.8% of span / RPE 0.0087 (the
    unanchored-window bug this golden caught scored 27%)."""
    from compv_tpu.slam.sfm import SfmConfig
    return SfmConfig(solver="schur", local_window=8, checkpoint_every=16,
                     max_obs=131072, max_landmarks=16384)


def build_sfm_128() -> dict:
    return _sfm_metrics(128, 480, 640, sfm_128_config())


if __name__ == "__main__":
    if "--sfm" in sys.argv or "--sfm-long" in sys.argv \
            or "--sfm-128" in sys.argv:
        name = ("sfm_128.json" if "--sfm-128" in sys.argv else
                "sfm_long.json" if "--sfm-long" in sys.argv else "sfm.json")
        out_sfm = os.path.join(os.path.dirname(OUT), name)
        g = (build_sfm_128() if "--sfm-128" in sys.argv else
             build_sfm_long() if "--sfm-long" in sys.argv else build_sfm())
        with open(out_sfm, "w") as f:
            json.dump(g, f, indent=1, sort_keys=True)
        print(f"wrote {out_sfm}:")
        print(json.dumps(g, indent=1, sort_keys=True))
    else:
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        goldens = build()
        with open(OUT, "w") as f:
            json.dump(goldens, f, indent=1, sort_keys=True)
        print(f"wrote {OUT}:")
        print(json.dumps(goldens, indent=1, sort_keys=True))
