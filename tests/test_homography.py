"""Homography & generic RANSAC tests — synthetic points + known H, the
reference's own strategy (unittests homography, SURVEY.md §4)."""
import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu.calib.homography import (
    HomographyConfig, compute_homography_dlt, find_homography,
    symmetric_transfer_error,
)
from compv_tpu.calib.ransac import RansacConfig, ransac
from compv_tpu.math.transform import apply_homography


def random_h(rs):
    h = np.eye(3)
    h[0, 0] = 1 + rs.uniform(-0.2, 0.2)
    h[1, 1] = 1 + rs.uniform(-0.2, 0.2)
    h[0, 1] = rs.uniform(-0.1, 0.1)
    h[1, 0] = rs.uniform(-0.1, 0.1)
    h[0, 2] = rs.uniform(-30, 30)
    h[1, 2] = rs.uniform(-30, 30)
    h[2, 0] = rs.uniform(-1e-4, 1e-4)
    h[2, 1] = rs.uniform(-1e-4, 1e-4)
    return h


def project(h, pts):
    ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ h.T
    return ph[:, :2] / ph[:, 2:3]


class TestDlt:
    def test_exact_recovery(self):
        rs = np.random.default_rng(0)
        h = random_h(rs)
        src = rs.uniform(0, 640, (40, 2))
        dst = project(h, src)
        got = np.asarray(compute_homography_dlt(jnp.asarray(src, jnp.float32),
                                                jnp.asarray(dst, jnp.float32)))
        np.testing.assert_allclose(got, h / h[2, 2], rtol=2e-3, atol=2e-3)

    def test_four_point_minimal(self):
        rs = np.random.default_rng(1)
        h = random_h(rs)
        src = np.array([[0, 0], [640, 0], [640, 480], [0, 480]], float)
        dst = project(h, src)
        got = np.asarray(compute_homography_dlt(jnp.asarray(src, jnp.float32),
                                                jnp.asarray(dst, jnp.float32)))
        err = project(got, src) - dst
        assert np.abs(err).max() < 0.5

    def test_masked(self):
        rs = np.random.default_rng(2)
        h = random_h(rs)
        src = rs.uniform(0, 640, (50, 2))
        dst = project(h, src)
        dst[40:] += 500  # garbage in masked-out rows
        mask = np.zeros(50, bool)
        mask[:40] = True
        got = np.asarray(compute_homography_dlt(
            jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32),
            jnp.asarray(mask)))
        err = project(got, src[:40]) - dst[:40]
        assert np.abs(err).max() < 1.0


class TestRansacHomography:
    def test_with_outliers(self):
        rs = np.random.default_rng(3)
        h = random_h(rs)
        n, n_out = 120, 48
        src = rs.uniform(50, 600, (n, 2))
        dst = project(h, src) + rs.normal(0, 0.5, (n, 2))
        out_idx = rs.choice(n, n_out, replace=False)
        dst[out_idx] = rs.uniform(0, 640, (n_out, 2))
        res = find_homography(jnp.asarray(src, jnp.float32),
                              jnp.asarray(dst, jnp.float32),
                              config=HomographyConfig(num_hypotheses=512))
        got = np.asarray(res.h)
        inliers = np.asarray(res.inliers)
        true_inl = np.ones(n, bool)
        true_inl[out_idx] = False
        # recovered H must map true inliers correctly
        err = project(got, src[true_inl]) - dst[true_inl]
        assert np.sqrt((err ** 2).sum(1)).mean() < 2.0
        # inlier set mostly agrees
        agree = (inliers == true_inl).mean()
        assert agree > 0.9

    def test_padded_mask(self):
        rs = np.random.default_rng(4)
        h = random_h(rs)
        src = np.zeros((64, 2), np.float32)
        dst = np.zeros((64, 2), np.float32)
        src[:30] = rs.uniform(0, 640, (30, 2))
        dst[:30] = project(h, src[:30])
        mask = np.zeros(64, bool)
        mask[:30] = True
        res = find_homography(jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(mask))
        assert int(res.num_inliers) >= 28
        assert not np.asarray(res.inliers)[30:].any()

    def test_symmetric_error_zero_for_truth(self):
        rs = np.random.default_rng(5)
        h = random_h(rs)
        src = rs.uniform(0, 640, (20, 2)).astype(np.float32)
        dst = project(h, src).astype(np.float32)
        e = np.asarray(symmetric_transfer_error(
            jnp.asarray(h, jnp.float32), jnp.asarray(src), jnp.asarray(dst)))
        assert e.max() < 0.1


class TestGenericRansac:
    def test_line_fit(self):
        """Line model through RANSAC — the reference's stats-fit use case
        (base/include/compv/base/math/compv_math_stats_fit.h:19)."""
        rs = np.random.default_rng(6)
        n = 200
        x = rs.uniform(0, 100, n)
        y = 0.7 * x + 10 + rs.normal(0, 0.3, n)
        y[:60] = rs.uniform(0, 100, 60)  # outliers
        pts = jnp.asarray(np.stack([x, y], 1), jnp.float32)

        def build(sub):  # 2-point line (a, b, c): ax + by + c = 0 normalized
            p, q = sub[0], sub[1]
            d = q - p
            nvec = jnp.stack([-d[1], d[0]])
            nvec = nvec / jnp.maximum(jnp.linalg.norm(nvec), 1e-9)
            c = -jnp.dot(nvec, p)
            return jnp.concatenate([nvec, c[None]])

        def resid(model, points):
            return jnp.abs(points @ model[:2] + model[2])

        res = ransac(pts, build, resid,
                     config=RansacConfig(num_hypotheses=256,
                                         min_model_points=2, threshold=1.0))
        model = np.asarray(res.model)
        # line ax+by+c=0 -> slope = -a/b
        slope = -model[0] / model[1]
        assert abs(slope - 0.7) < 0.05
        assert int(res.num_inliers) > 120


class TestSamplingHygiene:
    """Sampling without replacement + colinearity reject
    (reference rejects both, calib_homography.cxx:188-246)."""

    def test_samples_always_distinct(self):
        from compv_tpu.calib.homography import _masked_sample_idx
        import jax
        mask = np.zeros(100, bool)
        mask[10:90] = True
        idx = np.asarray(_masked_sample_idx(
            jax.random.PRNGKey(0), jnp.asarray(mask), 512, 4))
        for row in idx:
            assert len(set(row.tolist())) == 4, row
        assert ((idx >= 10) & (idx < 90)).all()

    def test_five_valid_points_still_solve(self):
        """Nearly-empty mask: 5 valid points must still recover H (with
        replacement, samples collapse onto duplicates and every hypothesis
        is degenerate)."""
        rs = np.random.default_rng(11)
        h = random_h(rs)
        src = np.zeros((64, 2), np.float32)
        dst = np.zeros((64, 2), np.float32)
        src[:5] = np.array([[10, 10], [600, 30], [580, 440], [40, 420],
                            [320, 240]], np.float32)
        dst[:5] = project(h, src[:5])
        mask = np.zeros(64, bool)
        mask[:5] = True
        res = find_homography(jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(mask),
                              config=HomographyConfig(num_hypotheses=64))
        assert int(res.num_inliers) == 5
        err = project(np.asarray(res.h), src[:5]) - dst[:5]
        assert np.abs(err).max() < 1.0

    def test_colinear_sample_rejected(self):
        from compv_tpu.calib.homography import _quad_nondegenerate
        colinear = jnp.asarray([[0., 0.], [10., 10.], [20., 20.], [5., 80.]])
        good = jnp.asarray([[0., 0.], [100., 0.], [100., 100.], [0., 100.]])
        assert not bool(_quad_nondegenerate(colinear))
        assert bool(_quad_nondegenerate(good))

    def test_generic_ransac_distinct(self):
        """Generic RANSAC with 2 valid points out of 50 must fit the exact
        line through them."""
        pts = np.zeros((50, 2), np.float32)
        pts[0] = [0, 5]
        pts[1] = [10, 5]
        mask = np.zeros(50, bool)
        mask[:2] = True

        def build(sub):
            p, q = sub[0], sub[1]
            d = q - p
            nvec = jnp.stack([-d[1], d[0]])
            nvec = nvec / jnp.maximum(jnp.linalg.norm(nvec), 1e-9)
            return jnp.concatenate([nvec, -jnp.dot(nvec, p)[None]])

        def resid(m, p):
            return jnp.abs(p @ m[:2] + m[2])

        res = ransac(jnp.asarray(pts), build, resid, jnp.asarray(mask),
                     RansacConfig(num_hypotheses=32, min_model_points=2,
                                  threshold=0.5))
        assert int(res.num_inliers) == 2
