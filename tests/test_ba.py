"""Bundle adjustment tests: synthetic scene, noisy init, BA must reduce
reprojection error; distributed step must match single-shard step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu.slam.ba import (
    BAConfig, BAProblem, ba_residuals, ba_solve, ba_step,
    matrix_to_rodrigues, reproj_rmse, rodrigues_to_matrix,
)


def make_scene(rs, n_cams=4, n_lms=40, noise=0.0, obs_per_lm=None):
    """Cameras looking at a landmark cloud around the origin."""
    lms = rs.uniform(-1, 1, (n_lms, 3)) + np.array([0, 0, 5.0])
    cams = []
    for i in range(n_cams):
        rvec = rs.normal(0, 0.05, 3)
        tvec = np.array([0.4 * i - 0.6, 0.0, 0.0]) + rs.normal(0, 0.05, 3)
        cams.append(np.concatenate([rvec, tvec]))
    cams = np.stack(cams)
    intr = np.array([500.0, 500.0, 320.0, 240.0])

    cam_idx, lm_idx, uvs = [], [], []
    for c in range(n_cams):
        r = cv_rodrigues(cams[c, :3])
        for l in range(n_lms):
            pc = r @ lms[l] + cams[c, 3:]
            u = intr[0] * pc[0] / pc[2] + intr[2]
            v = intr[1] * pc[1] / pc[2] + intr[3]
            cam_idx.append(c)
            lm_idx.append(l)
            uvs.append([u, v])
    uv = np.array(uvs) + rs.normal(0, noise, (len(uvs), 2))
    return (cams, lms, intr, np.array(cam_idx, np.int32),
            np.array(lm_idx, np.int32), uv)


def cv_rodrigues(rvec):
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    km = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * km + (1 - np.cos(theta)) * (km @ km)


class TestRotations:
    def test_roundtrip(self):
        rs = np.random.default_rng(0)
        for _ in range(10):
            rvec = rs.normal(0, 1, 3).astype(np.float32)
            r = rodrigues_to_matrix(jnp.asarray(rvec))
            back = np.asarray(matrix_to_rodrigues(r))
            np.testing.assert_allclose(back, rvec, atol=1e-4)

    def test_matches_numpy(self):
        rs = np.random.default_rng(1)
        rvec = rs.normal(0, 0.8, 3)
        got = np.asarray(rodrigues_to_matrix(jnp.asarray(rvec, jnp.float32)))
        np.testing.assert_allclose(got, cv_rodrigues(rvec), atol=1e-5)

    def test_zero_safe(self):
        r = np.asarray(rodrigues_to_matrix(jnp.zeros(3, jnp.float32)))
        np.testing.assert_allclose(r, np.eye(3), atol=1e-6)
        g = jax.grad(lambda v: rodrigues_to_matrix(v).sum())(jnp.zeros(3, jnp.float32))
        assert np.isfinite(np.asarray(g)).all()


class TestBA:
    def test_zero_residual_at_truth(self):
        rs = np.random.default_rng(2)
        cams, lms, intr, ci, li, uv = make_scene(rs)
        prob = BAProblem(jnp.asarray(cams, jnp.float32), jnp.asarray(lms, jnp.float32),
                         jnp.asarray(intr, jnp.float32), jnp.asarray(ci),
                         jnp.asarray(li), jnp.asarray(uv, jnp.float32),
                         jnp.ones(len(ci), bool))
        assert float(reproj_rmse(prob)) < 1e-2

    def test_ba_reduces_error(self):
        rs = np.random.default_rng(3)
        cams, lms, intr, ci, li, uv = make_scene(rs, noise=0.0)
        cams_n = cams + rs.normal(0, 0.01, cams.shape)
        cams_n[0] = cams[0]  # gauge camera stays at truth
        lms_n = lms + rs.normal(0, 0.02, lms.shape)
        prob = BAProblem(jnp.asarray(cams_n, jnp.float32),
                         jnp.asarray(lms_n, jnp.float32),
                         jnp.asarray(intr, jnp.float32), jnp.asarray(ci),
                         jnp.asarray(li), jnp.asarray(uv, jnp.float32),
                         jnp.ones(len(ci), bool))
        rmse0 = float(reproj_rmse(prob))
        solved, _ = ba_solve(prob, BAConfig(iterations=15, cg_iterations=30))
        rmse1 = float(reproj_rmse(solved))
        assert rmse0 > 1.0
        assert rmse1 < 0.15 * rmse0

    def test_pcg_matches_cg_quality_at_half_iterations(self):
        """Block-Jacobi PCG (BAConfig.precondition) must reach plain
        CG's quality with half the inner iterations — the BA normal
        system's diagonal blocks carry most of its conditioning."""
        rs = np.random.default_rng(12)
        cams, lms, intr, ci, li, uv = make_scene(rs, noise=0.0)
        cams_n = cams + rs.normal(0, 0.01, cams.shape)
        cams_n[0] = cams[0]
        lms_n = lms + rs.normal(0, 0.02, lms.shape)
        prob = BAProblem(jnp.asarray(cams_n, jnp.float32),
                         jnp.asarray(lms_n, jnp.float32),
                         jnp.asarray(intr, jnp.float32), jnp.asarray(ci),
                         jnp.asarray(li), jnp.asarray(uv, jnp.float32),
                         jnp.ones(len(ci), bool))
        plain, _ = ba_solve(prob, BAConfig(iterations=12, cg_iterations=30))
        pcg, _ = ba_solve(prob, BAConfig(iterations=12, cg_iterations=15,
                                         precondition=True))
        r_plain = float(reproj_rmse(plain))
        r_pcg = float(reproj_rmse(pcg))
        assert r_pcg <= max(1.2 * r_plain, 0.05), (r_pcg, r_plain)

    def test_padded_observations_ignored(self):
        rs = np.random.default_rng(4)
        cams, lms, intr, ci, li, uv = make_scene(rs)
        pad = 50
        ci_p = np.concatenate([ci, np.zeros(pad, np.int32)])
        li_p = np.concatenate([li, np.zeros(pad, np.int32)])
        uv_p = np.concatenate([uv, np.full((pad, 2), 1e6)])
        valid = np.concatenate([np.ones(len(ci), bool), np.zeros(pad, bool)])
        prob = BAProblem(jnp.asarray(cams, jnp.float32), jnp.asarray(lms, jnp.float32),
                         jnp.asarray(intr, jnp.float32), jnp.asarray(ci_p),
                         jnp.asarray(li_p), jnp.asarray(uv_p, jnp.float32),
                         jnp.asarray(valid))
        assert float(reproj_rmse(prob)) < 1e-2


@pytest.mark.slow
class TestDistributedBA:
    def test_matches_single_shard(self):
        """One distributed GN step == one local GN step (same psum'd math)."""
        from compv_tpu.parallel.mesh import make_mesh
        from compv_tpu.parallel.sharded import make_distributed_ba_step

        rs = np.random.default_rng(5)
        cams, lms, intr, ci, li, uv = make_scene(rs, n_cams=4, n_lms=16)
        cams_n = (cams + rs.normal(0, 0.01, cams.shape)).astype(np.float32)
        cams_n[0] = cams[0]
        lms_n = (lms + rs.normal(0, 0.02, lms.shape)).astype(np.float32)
        # pad obs count to a multiple of 8 devices
        n_obs = len(ci)
        n_pad = (-n_obs) % 8
        ci_p = np.concatenate([ci, np.zeros(n_pad, np.int32)])
        li_p = np.concatenate([li, np.zeros(n_pad, np.int32)])
        uv_p = np.concatenate([uv, np.zeros((n_pad, 2))]).astype(np.float32)
        valid = np.concatenate([np.ones(n_obs, bool), np.zeros(n_pad, bool)])

        prob = BAProblem(jnp.asarray(cams_n), jnp.asarray(lms_n),
                         jnp.asarray(intr, jnp.float32), jnp.asarray(ci_p),
                         jnp.asarray(li_p), jnp.asarray(uv_p),
                         jnp.asarray(valid))
        cfg = BAConfig(cg_iterations=10)
        lam = jnp.float32(1e-3)

        local_prob, local_lam, local_cost = ba_step(prob, lam, cfg)

        mesh = make_mesh(8)
        step = make_distributed_ba_step(mesh, cfg)
        dist_prob, dist_lam, dist_cost = step(prob, lam)

        np.testing.assert_allclose(float(dist_cost), float(local_cost), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(dist_prob.cameras),
                                   np.asarray(local_prob.cameras),
                                   rtol=2e-3, atol=2e-4)


@pytest.mark.slow
class TestSchurBA:
    def test_schur_reduces_error(self):
        from compv_tpu.slam.ba_schur import SchurConfig, ba_solve_schur
        from compv_tpu.slam.ba import reproj_rmse
        rs = np.random.default_rng(7)
        cams, lms, intr, ci, li, uv = make_scene(rs, n_cams=5, n_lms=30)
        cams_n = cams + rs.normal(0, 0.01, cams.shape)
        cams_n[0] = cams[0]
        lms_n = lms + rs.normal(0, 0.02, lms.shape)
        prob = BAProblem(jnp.asarray(cams_n, jnp.float32),
                         jnp.asarray(lms_n, jnp.float32),
                         jnp.asarray(intr, jnp.float32), jnp.asarray(ci),
                         jnp.asarray(li), jnp.asarray(uv, jnp.float32),
                         jnp.ones(len(ci), bool))
        rmse0 = float(reproj_rmse(prob))
        solved, _ = ba_solve_schur(prob, SchurConfig(iterations=12))
        rmse1 = float(reproj_rmse(solved))
        assert rmse0 > 1.0
        assert rmse1 < 0.05 * rmse0  # Schur converges fast (exact GN step)

    def test_schur_matches_cg_solution_quality(self):
        from compv_tpu.slam.ba_schur import SchurConfig, ba_solve_schur
        from compv_tpu.slam.ba import reproj_rmse
        rs = np.random.default_rng(8)
        cams, lms, intr, ci, li, uv = make_scene(rs, n_cams=4, n_lms=25)
        cams_n = cams + rs.normal(0, 0.008, cams.shape)
        cams_n[0] = cams[0]
        lms_n = lms + rs.normal(0, 0.015, lms.shape)
        prob = BAProblem(jnp.asarray(cams_n, jnp.float32),
                         jnp.asarray(lms_n, jnp.float32),
                         jnp.asarray(intr, jnp.float32), jnp.asarray(ci),
                         jnp.asarray(li), jnp.asarray(uv, jnp.float32),
                         jnp.ones(len(ci), bool))
        s_prob, s_cost = ba_solve_schur(prob, SchurConfig(iterations=10))
        c_prob, c_cost = ba_solve(prob, BAConfig(iterations=15, cg_iterations=30))
        # both must reach near-zero residual on noiseless observations
        assert float(reproj_rmse(s_prob)) < 0.05
        assert float(reproj_rmse(c_prob)) < 0.2

    def test_distributed_schur_matches_local(self):
        from compv_tpu.parallel.mesh import make_mesh
        from compv_tpu.parallel.sharded import make_distributed_schur_step
        from compv_tpu.slam.ba_schur import SchurConfig, ba_step_schur

        rs = np.random.default_rng(9)
        cams, lms, intr, ci, li, uv = make_scene(rs, n_cams=4, n_lms=16)
        cams_n = (cams + rs.normal(0, 0.01, cams.shape)).astype(np.float32)
        cams_n[0] = cams[0]
        lms_n = (lms + rs.normal(0, 0.02, lms.shape)).astype(np.float32)
        n_obs = len(ci)
        n_pad = (-n_obs) % 8
        ci_p = np.concatenate([ci, np.zeros(n_pad, np.int32)])
        li_p = np.concatenate([li, np.zeros(n_pad, np.int32)])
        uv_p = np.concatenate([uv, np.zeros((n_pad, 2))]).astype(np.float32)
        valid = np.concatenate([np.ones(n_obs, bool), np.zeros(n_pad, bool)])
        prob = BAProblem(jnp.asarray(cams_n), jnp.asarray(lms_n),
                         jnp.asarray(intr, jnp.float32), jnp.asarray(ci_p),
                         jnp.asarray(li_p), jnp.asarray(uv_p),
                         jnp.asarray(valid))
        cfg = SchurConfig()
        lam = jnp.float32(1e-3)
        local_prob, _, local_cost = ba_step_schur(prob, lam, cfg)
        mesh = make_mesh(8)
        step = make_distributed_schur_step(mesh, cfg)
        dist_prob, _, dist_cost = step(prob, lam)
        np.testing.assert_allclose(float(dist_cost), float(local_cost), rtol=1e-4)
        # distributed assembly is exact in real arithmetic; the f32
        # reassociation of the per-chunk W/Z psums passes through inv(Hll)
        # and a dense 24x24 solve, so per-element noise can reach ~1%
        np.testing.assert_allclose(np.asarray(dist_prob.cameras),
                                   np.asarray(local_prob.cameras),
                                   rtol=2e-2, atol=1e-3)
        # both updates must land at essentially the same reprojection error
        np.testing.assert_allclose(float(reproj_rmse(dist_prob)),
                                   float(reproj_rmse(local_prob)),
                                   rtol=0.05, atol=1e-3)


@pytest.mark.slow
class TestSchurScale:
    def test_schur_at_production_scale(self):
        """The Schur path must run at
        256 cams / 20k landmarks / 100k obs — the scale where the old
        dense (F, L, 6, 3) W was ~368 MB before any einsum. The chunked
        assembly peaks at O(lm_chunk*F*18 + F^2*36) instead."""
        from compv_tpu.slam.ba_schur import (SchurConfig, ba_step_schur,
                                             max_obs_per_landmark)
        rs = np.random.default_rng(11)
        f, l, o = 256, 20000, 100000
        cams = rs.normal(0, 0.05, (f, 6)).astype(np.float32)
        cams[:, 5] = 0.0
        lms = (rs.uniform(-2, 2, (l, 3)) + [0, 0, 6.0]).astype(np.float32)
        intr = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
        ci = rs.integers(0, f, o).astype(np.int32)
        li = rs.integers(0, l, o).astype(np.int32)
        # observations = true projections; then perturb landmarks so one
        # exact GN step must cut the cost
        import jax
        from compv_tpu.slam.ba import project_points
        uv = np.asarray(project_points(
            jnp.asarray(cams), jnp.asarray(lms), jnp.asarray(intr),
            jnp.asarray(ci), jnp.asarray(li)))
        lms_n = lms + rs.normal(0, 0.01, lms.shape).astype(np.float32)
        prob = BAProblem(jnp.asarray(cams), jnp.asarray(lms_n),
                         jnp.asarray(intr), jnp.asarray(ci),
                         jnp.asarray(li), jnp.asarray(uv, jnp.float32),
                         jnp.ones(o, bool))
        k = max_obs_per_landmark(prob.lm_idx, prob.valid, l)
        step = jax.jit(lambda p, lam: ba_step_schur(
            p, lam, SchurConfig(), max_obs_per_lm=k))
        new_prob, _, cost0 = step(prob, jnp.float32(1e-3))
        r1 = ba_residuals(new_prob.cameras, new_prob.landmarks, new_prob)
        assert float(jnp.sum(r1 * r1)) < 0.5 * float(cost0)


@pytest.mark.slow
class TestReduceScatterBA:
    def test_reduce_scatter_matches_psum(self):
        """The sharded-CG (all_gather/psum_scatter) BA step must reach the
        same update as the replicated-CG psum step up to reduction-order
        noise."""
        from compv_tpu.parallel.mesh import make_mesh
        from compv_tpu.parallel.sharded import make_distributed_ba_step

        rs = np.random.default_rng(6)
        cams, lms, intr, ci, li, uv = make_scene(rs, n_cams=4, n_lms=16)
        cams_n = (cams + rs.normal(0, 0.01, cams.shape)).astype(np.float32)
        cams_n[0] = cams[0]
        lms_n = (lms + rs.normal(0, 0.02, lms.shape)).astype(np.float32)
        n_obs = len(ci)
        n_pad = (-n_obs) % 8
        ci_p = np.concatenate([ci, np.zeros(n_pad, np.int32)])
        li_p = np.concatenate([li, np.zeros(n_pad, np.int32)])
        uv_p = np.concatenate([uv, np.zeros((n_pad, 2))]).astype(np.float32)
        valid = np.concatenate([np.ones(n_obs, bool), np.zeros(n_pad, bool)])
        prob = BAProblem(jnp.asarray(cams_n), jnp.asarray(lms_n),
                         jnp.asarray(intr, jnp.float32), jnp.asarray(ci_p),
                         jnp.asarray(li_p), jnp.asarray(uv_p),
                         jnp.asarray(valid))
        cfg = BAConfig(cg_iterations=10)
        lam = jnp.float32(1e-3)
        mesh = make_mesh(8)

        p_ps, lam_ps, cost_ps = make_distributed_ba_step(mesh, cfg)(prob, lam)
        p_rs, lam_rs, cost_rs = make_distributed_ba_step(
            mesh, cfg, mode="reduce_scatter")(prob, lam)

        np.testing.assert_allclose(float(cost_rs), float(cost_ps), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(p_rs.cameras),
                                   np.asarray(p_ps.cameras),
                                   rtol=5e-3, atol=5e-4)
        # both must actually improve the problem
        assert float(reproj_rmse(p_rs)) < float(reproj_rmse(prob))
