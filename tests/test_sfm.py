"""End-to-end SfM + ATE golden (BASELINE.json's headline metric) and the
PnP solver that powers frame registration.

The reference has no SfM; goldens are self-established (BASELINE.md:51-57
"trajectory baselines must be established by running the new framework's
reference configs and locking them as goldens") and locked in
goldens/sfm.json. Regenerate with scripts/make_goldens.py --sfm.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu.calib.pnp import PnpConfig, pnp_dlt, solve_pnp
from compv_tpu.slam.ba import rodrigues_to_matrix
from compv_tpu.slam.evaluate import ate_rmse
from compv_tpu.slam.sfm import render_orbit_sequence, run_sfm

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "sfm.json")


def _project_px(rvec, tvec, pts, k):
    r = np.asarray(rodrigues_to_matrix(jnp.asarray(rvec, jnp.float32)))
    pc = pts @ r.T + tvec
    uv = pc[:, :2] / pc[:, 2:3]
    return uv * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]


@pytest.fixture(scope="module")
def pose_scene():
    rs = np.random.default_rng(3)
    k = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    rvec = np.array([0.05, -0.1, 0.03])
    tvec = np.array([0.2, -0.1, 0.4])
    pts = rs.uniform(-2, 2, (64, 3)) + [0, 0, 6.0]
    px = _project_px(rvec, tvec, pts, k)
    return k, rvec, tvec, pts.astype(np.float32), px.astype(np.float32)


class TestPnp:
    def test_dlt_exact(self, pose_scene):
        k, rvec, tvec, pts, px = pose_scene
        kinv = np.linalg.inv(k)
        ph = np.concatenate([px, np.ones((len(px), 1), np.float32)], axis=1)
        pn = (ph @ kinv.T)[:, :2]
        rv, tv = pnp_dlt(jnp.asarray(pts), jnp.asarray(pn))
        assert np.allclose(np.asarray(rv), rvec, atol=1e-3)
        assert np.allclose(np.asarray(tv), tvec, atol=1e-3)

    def test_ransac_rejects_outliers(self, pose_scene):
        k, rvec, tvec, pts, px = pose_scene
        rs = np.random.default_rng(4)
        px_bad = px.copy()
        bad = rs.choice(len(px), 20, replace=False)
        px_bad[bad] += rs.uniform(30, 90, (20, 2))
        res = solve_pnp(jnp.asarray(pts), jnp.asarray(px_bad),
                        jnp.asarray(k), config=PnpConfig())
        assert np.allclose(np.asarray(res.rvec), rvec, atol=5e-3)
        assert np.allclose(np.asarray(res.tvec), tvec, atol=2e-2)
        inl = np.asarray(res.inliers)
        assert not inl[bad].any()
        assert int(res.num_inliers) >= 40

    def test_masked_padding(self, pose_scene):
        k, rvec, tvec, pts, px = pose_scene
        pad3 = np.zeros((128, 3), np.float32)
        pad2 = np.zeros((128, 2), np.float32)
        m = np.zeros((128,), bool)
        pad3[:len(pts)] = pts
        pad2[:len(px)] = px
        m[:len(px)] = True
        res = solve_pnp(jnp.asarray(pad3), jnp.asarray(pad2), jnp.asarray(k),
                        jnp.asarray(m), PnpConfig())
        assert np.allclose(np.asarray(res.rvec), rvec, atol=5e-3)
        assert not np.asarray(res.inliers)[len(px):].any()


@pytest.fixture(scope="module")
def sfm_run():
    frames, gt, k = render_orbit_sequence(8, 240, 320)
    res = run_sfm(frames, k)
    ate = float(ate_rmse(jnp.asarray(res.positions), jnp.asarray(gt),
                         with_scale=True))
    return res, ate, gt


@pytest.mark.slow
class TestSfmEndToEnd:
    def test_ate_vs_golden(self, sfm_run):
        """The cross-round lock: ATE must not regress 2x vs the checked-in
        golden."""
        res, ate, gt = sfm_run
        with open(GOLDEN_PATH) as f:
            g = json.load(f)
        assert ate <= 2.0 * g["ate_rmse"], (ate, g["ate_rmse"])
        # absolute quality bar: ATE < 3% of the
        # trajectory span (sub-pixel keypoints brought it to ~0.6%)
        span = float(np.linalg.norm(gt[-1] - gt[0]))
        assert ate < 0.03 * span

    def test_rpe_vs_golden(self, sfm_run):
        from compv_tpu.slam.evaluate import rpe_rmse
        import jax.numpy as jnp
        res, ate, gt = sfm_run
        with open(GOLDEN_PATH) as f:
            g = json.load(f)
        rpe = float(rpe_rmse(jnp.asarray(res.positions), jnp.asarray(gt),
                             delta=1))
        assert rpe <= 2.0 * g["rpe_rmse"], (rpe, g["rpe_rmse"])

    def test_ba_improves_reprojection(self, sfm_run):
        res, ate, gt = sfm_run
        assert res.reproj_after < res.reproj_before
        assert res.reproj_after < 2.5  # px

    def test_structure_scale(self, sfm_run):
        res, ate, gt = sfm_run
        assert res.num_obs > 1500
        assert res.num_tracks > 400
        # every frame registered with a healthy PnP inlier count
        for st in res.frame_stats:
            assert st["pnp_inliers"] >= 20, res.frame_stats

    def test_long_sequence_golden(self):
        """32-frame 480p golden with RPE. ~10 min on
        the 2-core CPU runner — the heaviest test in the slow tier; the
        locked values live in goldens/sfm_long.json (regenerate with
        scripts/make_goldens.py --sfm-long)."""
        from compv_tpu.slam.evaluate import rpe_rmse
        from compv_tpu.slam.sfm import SfmConfig
        long_path = os.path.join(os.path.dirname(GOLDEN_PATH),
                                 "sfm_long.json")
        with open(long_path) as f:
            g = json.load(f)
        seq = g["sequence"]
        frames, gt, k = render_orbit_sequence(seq["n_frames"], seq["h"],
                                              seq["w"])
        res = run_sfm(frames, k,
                      SfmConfig(max_obs=65536, max_landmarks=8192))
        ate = float(ate_rmse(jnp.asarray(res.positions), jnp.asarray(gt),
                             with_scale=True))
        rpe = float(rpe_rmse(jnp.asarray(res.positions), jnp.asarray(gt)))
        assert ate <= 2.0 * g["ate_rmse"], (ate, g["ate_rmse"])
        assert rpe <= 2.0 * g["rpe_rmse"], (rpe, g["rpe_rmse"])

    @pytest.mark.slow
    def test_128_frame_windowed_schur_golden(self, tmp_path):
        """Sequence-scale run — 128 frames @ 480p with
        Schur-solver BA, 8-frame sliding-window local BA (frozen past
        cameras anchor the gauge), periodic checkpoints and landmark
        capacity churn. Locked values live in goldens/sfm_128.json
        (regenerate with scripts/make_goldens.py --sfm-128)."""
        import sys
        from compv_tpu.slam.evaluate import rpe_rmse
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts"))
        from make_goldens import sfm_128_config
        path_128 = os.path.join(os.path.dirname(GOLDEN_PATH),
                                "sfm_128.json")
        if not os.path.exists(path_128):
            pytest.skip("sfm_128 golden not generated (see "
                        "scripts/make_goldens.py --sfm-128)")
        with open(path_128) as f:
            g = json.load(f)
        seq = g["sequence"]
        frames, gt, k = render_orbit_sequence(seq["n_frames"], seq["h"],
                                              seq["w"])
        res = run_sfm(frames, k, sfm_128_config(),
                      checkpoint_dir=str(tmp_path))
        ate = float(ate_rmse(jnp.asarray(res.positions), jnp.asarray(gt),
                             with_scale=True))
        rpe = float(rpe_rmse(jnp.asarray(res.positions), jnp.asarray(gt)))
        span = float(np.linalg.norm(gt[-1] - gt[0]))
        assert ate <= 2.0 * g["ate_rmse"], (ate, g["ate_rmse"])
        assert rpe <= 2.0 * g["rpe_rmse"], (rpe, g["rpe_rmse"])
        # honest standing (r5): the locked golden is 1.8% of span — the
        # 8-frame window accumulates drift the 12-iteration final global
        # BA does not fully undo on this densely-sampled 128-frame arc
        # (the target bar is 1%; the unanchored-window bug this run
        # caught scored 27%). Next rung: periodic full-BA keyframes.
        assert 100.0 * ate / span <= 2.5
        # the periodic checkpoint must exist and be resumable
        assert any(tmp_path.iterdir())

    def test_renderer_deterministic(self, sfm_run):
        """Renderer-only determinism: same seed -> identical frames/gt.
        (run_sfm determinism itself is bounded by the golden assert above,
        not re-asserted bit-exactly here — a second full run costs ~40 s.)"""
        frames1, gt1, k1 = render_orbit_sequence(8, 240, 320)
        frames2, gt2, k2 = render_orbit_sequence(8, 240, 320)
        assert np.array_equal(frames1, frames2)
        assert np.array_equal(gt1, gt2)


class TestCheckpointResume:
    """SURVEY §5 failure/elastic recovery: a mid-SfM
    checkpoint must reload onto a DIFFERENT mesh size and resume to the
    same quality. Fast tier: tiny 6-frame sequence."""

    def test_checkpoint_reshard_resume(self, tmp_path):
        from compv_tpu.parallel.mesh import make_mesh
        from compv_tpu.slam.sfm import SfmConfig, resume_sfm

        frames, gt, k = render_orbit_sequence(6, 120, 160)
        cfg = SfmConfig(max_obs=4096, max_landmarks=1024)
        # direct run, checkpointing the mid-sequence state (all frames
        # registered, before the final global BA)
        res_direct = run_sfm(frames, k, cfg, checkpoint_dir=str(tmp_path))
        ate_direct = float(ate_rmse(jnp.asarray(res_direct.positions),
                                    jnp.asarray(gt), with_scale=True))
        ckpts = sorted(os.listdir(tmp_path))
        assert ckpts, "no checkpoint written"
        path = os.path.join(str(tmp_path), ckpts[-1])

        # simulate the job dying and restarting on a 4-device mesh (the
        # original ran single-device): reload + re-shard + finish
        res4 = resume_sfm(path, cfg, mesh=make_mesh(4))
        ate4 = float(ate_rmse(jnp.asarray(res4.positions),
                              jnp.asarray(gt), with_scale=True))
        span = float(np.linalg.norm(gt[-1] - gt[0]))
        # the contract under test is resume == direct quality (absolute
        # ATE bars live in the 240x320/480p goldens above; this 120x160
        # scene is deliberately tiny for the fast tier)
        assert ate4 <= max(1.5 * ate_direct, 0.03 * span), \
            (ate4, ate_direct)
        assert ate4 < 0.15 * span, (ate4, span)   # sanity: not diverged
        # ...and again on a different mesh size (8): same state, new shards
        res8 = resume_sfm(path, cfg, mesh=make_mesh(8))
        ate8 = float(ate_rmse(jnp.asarray(res8.positions),
                              jnp.asarray(gt), with_scale=True))
        assert ate8 <= max(1.5 * ate_direct, 0.03 * span), \
            (ate8, ate_direct)
