"""f32 conditioning stress tests for the estimation core.

The reference solves homography/calibration in f64
(core/calib/compv_core_calib_homography.cxx:60 instantiates the double
path); this framework runs f32 end-to-end. These tests encode WHERE
that is safe and WHY:

  * Hartley normalization is the load-bearing step. The DLT normal matrix
    has entries ~ coord^4; at 4k-resolution coordinates (~4e3) that is
    ~2.6e14, and f32's 24-bit mantissa leaves NO significant bits for the
    small eigenvector — unnormalized f32 DLT is demonstrably garbage
    (test_unnormalized_dlt_fails_at_4k documents the failure, not a bound
    to be met). After normalization (coords ~ sqrt(2)), the normal matrix
    is O(1)-conditioned in scale and f32 recovers H to ~1e-3 relative at
    4k coordinates — asserted against a float64 NumPy oracle.
  * Near-degenerate (colinear-ish) samples: RANSAC's colinearity gate
    rejects truly-degenerate 4-point samples; for the full-inlier-set
    refine solve the smallest eigenvalue separation shrinks and f32 error
    grows ~1/separation. The test pins the measured divergence bound.
  * Focal spread: Zhang's closed-form intrinsics + LM refinement recover
    fx to <1% relative across a 10x focal range (250..2500) in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu.calib.homography import (HomographyConfig,
                                        compute_homography_dlt,
                                        find_homography,
                                        symmetric_transfer_error)


def _f64_dlt_oracle(src, dst):
    """Normalized DLT in float64 (NumPy): the reference-arithmetic oracle
    (computeH, calib_homography.cxx:346)."""
    def norm(p):
        c = p.mean(axis=0)
        d = np.sqrt(((p - c) ** 2).sum(axis=1)).mean()
        s = np.sqrt(2.0) / max(d, 1e-12)
        t = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        ph = np.concatenate([p, np.ones((len(p), 1))], axis=1) @ t.T
        return ph[:, :2], t

    sn, ts = norm(np.asarray(src, np.float64))
    dn, td = norm(np.asarray(dst, np.float64))
    rows = []
    for (x, y), (u, v) in zip(sn, dn):
        rows.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        rows.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    a = np.asarray(rows)
    _, _, vt = np.linalg.svd(a)
    h = np.linalg.inv(td) @ vt[-1].reshape(3, 3) @ ts
    return h / h[2, 2]


def _unnormalized_f32_dlt(src, dst):
    """Plain DLT with NO Hartley normalization, f32 — the failure mode the
    production solver avoids."""
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([-x, -y, -o, z, z, z, u * x, u * y, u], axis=1)
    r2 = jnp.stack([z, z, z, -x, -y, -o, v * x, v * y, v], axis=1)
    a = jnp.concatenate([r1, r2], axis=0)
    _, vecs = jnp.linalg.eigh(a.T @ a)
    h = vecs[:, 0].reshape(3, 3)
    h22 = jnp.where(jnp.abs(h[2, 2]) < 1e-12, 1e-12, h[2, 2])
    return h / h22


def _scene(n, w, h, seed, h_true=None, noise=0.0):
    rs = np.random.default_rng(seed)
    if h_true is None:
        h_true = np.array([[1.05, 0.04, 12.0],
                           [-0.03, 0.98, -7.0],
                           [3e-6, -5e-6, 1.0]])
    src = rs.uniform([0, 0], [w, h], (n, 2))
    ph = np.concatenate([src, np.ones((n, 1))], axis=1) @ h_true.T
    dst = ph[:, :2] / ph[:, 2:3] + rs.normal(0, noise, (n, 2))
    return src.astype(np.float32), dst.astype(np.float32), h_true


class TestHomographyF32Conditioning:
    def test_4k_coordinates_match_f64_oracle(self):
        """f32 normalized DLT at 4096x2160 coordinates must track the f64
        oracle: max symmetric transfer error within 0.05 px^2 and relative
        H difference < 1e-3 (measured headroom ~10x)."""
        src, dst, h_true = _scene(200, 4096, 2160, seed=0, noise=0.0)
        h32 = np.asarray(compute_homography_dlt(jnp.asarray(src),
                                                jnp.asarray(dst)))
        h64 = _f64_dlt_oracle(src, dst)
        rel = np.abs(h32 - h64).max() / np.abs(h64).max()
        assert rel < 1e-3, rel
        err = np.asarray(symmetric_transfer_error(
            jnp.asarray(h32, jnp.float32), jnp.asarray(src),
            jnp.asarray(dst)))
        assert err.max() < 0.05, err.max()

    def test_unnormalized_dlt_fails_at_4k(self):
        """Documents WHY hartley_normalize is load-bearing: the same
        solve WITHOUT normalization diverges by orders of magnitude at 4k
        coordinates in f32 (normal-matrix entries ~ coord^4 ~ 2.6e14
        swamp the 24-bit mantissa)."""
        src, dst, _ = _scene(200, 4096, 2160, seed=1, noise=0.0)
        h_bad = np.asarray(_unnormalized_f32_dlt(jnp.asarray(src),
                                                 jnp.asarray(dst)))
        err_bad = np.asarray(symmetric_transfer_error(
            jnp.asarray(h_bad, jnp.float32), jnp.asarray(src),
            jnp.asarray(dst)))
        h_good = np.asarray(compute_homography_dlt(jnp.asarray(src),
                                                   jnp.asarray(dst)))
        err_good = np.asarray(symmetric_transfer_error(
            jnp.asarray(h_good, jnp.float32), jnp.asarray(src),
            jnp.asarray(dst)))
        # the unnormalized error must be catastrophically larger — this is
        # an existence proof of the failure mode, not a quality bar
        assert np.median(err_bad) > 1e3 * max(np.median(err_good), 1e-6), \
            (np.median(err_bad), np.median(err_good))

    def test_near_colinear_inlier_set(self):
        """75% of points lie within ~1 px of a line across a 4k frame (a
        dominant edge) plus 25% off-line points. The refine solve runs
        over ALL inliers — the conditioning worsens but f32 + Hartley must
        still recover H to sub-0.3 px^2 transfer error (bound has ~5x
        measured headroom)."""
        rs = np.random.default_rng(2)
        h_true = np.array([[1.02, 0.05, 30.0],
                           [-0.04, 0.97, -11.0],
                           [2e-6, -4e-6, 1.0]])
        n_line, n_off = 150, 50
        t = rs.uniform(0, 1, n_line)
        line = (np.stack([t * 4000 + 50, t * 1800 + 100], axis=1)
                + rs.normal(0, 1.0, (n_line, 2)))
        off = rs.uniform([0, 0], [4096, 2160], (n_off, 2))
        src = np.concatenate([line, off]).astype(np.float32)
        ph = np.concatenate([src, np.ones((len(src), 1))], axis=1) @ h_true.T
        dst = (ph[:, :2] / ph[:, 2:3]).astype(np.float32)
        h32 = np.asarray(compute_homography_dlt(jnp.asarray(src),
                                                jnp.asarray(dst)))
        err = np.asarray(symmetric_transfer_error(
            jnp.asarray(h32, jnp.float32), jnp.asarray(src),
            jnp.asarray(dst)))
        assert np.median(err) < 0.3, np.median(err)
        h64 = _f64_dlt_oracle(src, dst)
        rel = np.abs(h32 - h64).max() / np.abs(h64).max()
        assert rel < 5e-3, rel

    def test_ransac_end_to_end_4k(self):
        """Full find_homography at 4k coordinates with 30% outliers: the
        batched-hypothesis RANSAC + f32 refine must recover H (transfer
        error of true inliers < threshold)."""
        src, dst, h_true = _scene(300, 4096, 2160, seed=3, noise=0.3)
        rs = np.random.default_rng(4)
        bad = rs.choice(300, 90, replace=False)
        dst_bad = dst.copy()
        dst_bad[bad] += rs.uniform(80, 400, (90, 2)).astype(np.float32)
        res = find_homography(jnp.asarray(src), jnp.asarray(dst_bad),
                              config=HomographyConfig(num_hypotheses=512,
                                                      threshold=30.0))
        inl = np.asarray(res.inliers)
        assert not inl[bad].any() or inl[bad].mean() < 0.1
        assert int(res.num_inliers) > 150
        h = np.array(res.h)
        hn = h / h[2, 2]
        ht = h_true / h_true[2, 2]
        assert np.abs(hn - ht).max() / np.abs(ht).max() < 2e-2


class TestCalibF32FocalSpread:
    @pytest.mark.parametrize("focal", [250.0, 800.0, 2500.0])
    def test_zhang_recovers_focal(self, focal):
        """Zhang closed-form + LM in f32 across a 10x focal range: fx/fy
        recovered to <1% relative (reference runs this math in f64,
        compv_core_calib_camera.cxx)."""
        from compv_tpu.calib.camera import (CalibrationConfig,
                                            calibrate_camera,
                                            checkerboard_object_points)
        from compv_tpu.calib.utils import project_points_dist
        rs = np.random.default_rng(int(focal))
        k_true = np.array([[focal, 0.0, 320.0],
                           [0.0, focal * 1.01, 240.0],
                           [0.0, 0.0, 1.0]])
        obj = np.asarray(checkerboard_object_points(6, 8, 30.0))
        img_pts = []
        # z scaled so the board subtends a similar image area at any focal
        z0 = 900.0 * focal / 800.0
        for i in range(6):
            rvec = np.array([0.14, -0.12, 0.06]) * (i - 2.5) \
                + rs.normal(0, 0.03, 3)
            tvec = np.array([-120.0, -90.0, z0]) + rs.normal(0, 10.0, 3)
            proj = np.asarray(project_points_dist(
                jnp.asarray(obj), jnp.asarray(k_true, jnp.float32),
                jnp.zeros(4, jnp.float32), jnp.asarray(rvec, jnp.float32),
                jnp.asarray(tvec, jnp.float32)))
            img_pts.append(proj)
        res = calibrate_camera(jnp.asarray(obj),
                               jnp.asarray(np.stack(img_pts), jnp.float32),
                               CalibrationConfig())
        k_est = np.asarray(res.k)
        assert abs(k_est[0, 0] - focal) / focal < 0.01, k_est
        assert abs(k_est[1, 1] - focal * 1.01) / (focal * 1.01) < 0.01
