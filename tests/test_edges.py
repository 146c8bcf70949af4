"""Sobel / Canny / Hough tests."""
import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu.features.canny import CannyConfig, canny
from compv_tpu.features.edges import edge_detect, sobel_gradients
from compv_tpu.features.hough import (
    HoughKhtConfig, HoughShtConfig, hough_kht, hough_sht,
)


@pytest.fixture(scope="module")
def step_img():
    """Vertical step edge at x=32."""
    img = np.zeros((64, 64), np.uint8)
    img[:, 32:] = 200
    return img


@pytest.fixture(scope="module")
def lines_img():
    """Two straight lines: horizontal y=20, vertical x=40."""
    img = np.zeros((80, 100), np.uint8)
    img[20, 5:95] = 255
    img[5:75, 40] = 255
    return img


class TestSobel:
    def test_step_response(self, step_img):
        gx, gy = sobel_gradients(jnp.asarray(step_img))
        gx = np.asarray(gx)
        gy = np.asarray(gy)
        # gx peaks at the step, gy ~ 0 in the interior
        assert abs(gx[32, 31]) + abs(gx[32, 32]) > 100
        assert np.abs(gy[5:-5, 5:-5]).max() < 1e-3

    def test_scalar_parity(self):
        """3x3 Sobel vs explicit scipy correlation."""
        from scipy import ndimage
        rs = np.random.default_rng(0)
        img = rs.integers(0, 255, (32, 32), dtype=np.uint8)
        gx, _ = sobel_gradients(jnp.asarray(img))
        kx = np.outer([1, 2, 1], [-1, 0, 1]).astype(np.float32)
        want = ndimage.correlate(img.astype(np.float32), kx, mode="constant")
        np.testing.assert_allclose(np.asarray(gx)[1:-1, 1:-1],
                                   want[1:-1, 1:-1], atol=1e-3)

    def test_edge_detect_u8(self, step_img):
        out = np.asarray(edge_detect(jnp.asarray(step_img)))
        assert out.dtype == np.uint8
        assert out[:, 30:34].max() > 20


class TestCanny:
    def test_step_edge_single_pixel_wide(self, step_img):
        out = np.asarray(canny(jnp.asarray(step_img),
                               CannyConfig(threshold_low=30, threshold_high=80)))
        mid = out[32]
        cols = np.nonzero(mid)[0]
        assert len(cols) >= 1
        assert np.all(np.abs(cols - 31.5) <= 1.5)  # thin, localized
        # exactly one edge column per row in the interior (thinness)
        interior = out[5:-5]
        per_row = (interior > 0).sum(axis=1)
        assert per_row.max() <= 2

    def test_hysteresis_connects(self):
        """A line whose middle is weak (between tLow and tHigh) must survive
        if its ends are strong."""
        img = np.zeros((40, 120), np.float32)
        # ramp amplitude: strong at ends, weak (but > tLow) in the middle
        amp = np.concatenate([np.full(40, 200.0), np.full(40, 90.0),
                              np.full(40, 200.0)])
        img[20, :] = amp
        out_hyst = np.asarray(canny(jnp.asarray(img.astype(np.uint8)),
                                    CannyConfig(threshold_low=100,
                                                threshold_high=300)))
        # the weak middle (sobel response ~ 4*90=360... choose thresholds so
        # middle is weak-only): low=100 strong=650
        out2 = np.asarray(canny(jnp.asarray(img.astype(np.uint8)),
                                CannyConfig(threshold_low=100,
                                            threshold_high=650)))
        row = out2[19:22, 45:75]
        assert row.max() > 0  # weak middle kept through connectivity

    def test_no_edges_flat(self):
        img = np.full((32, 32), 77, np.uint8)
        out = np.asarray(canny(jnp.asarray(img)))
        assert out.sum() == 0

    def test_mean_threshold_mode(self, step_img):
        out = np.asarray(canny(jnp.asarray(step_img),
                               CannyConfig(threshold_low=66,
                                           threshold_high=133,
                                           threshold_type="mean")))
        assert out.sum() > 0


class TestHough:
    def test_sht_finds_lines(self, lines_img):
        lines = hough_sht(jnp.asarray(lines_img),
                          HoughShtConfig(threshold=40, max_lines=8))
        v = np.asarray(lines.valid)
        assert v.sum() >= 2
        thetas = np.asarray(lines.theta)[v]
        rhos = np.asarray(lines.rho)[v]
        # horizontal line y=20: theta ~ pi/2, rho ~ 20
        has_horiz = np.any((np.abs(thetas - np.pi / 2) < 0.05)
                           & (np.abs(rhos - 20) < 2))
        # vertical line x=40: theta ~ 0, rho ~ 40
        has_vert = np.any((np.abs(thetas) < 0.05) & (np.abs(rhos - 40) < 2))
        assert has_horiz and has_vert

    def test_sht_strength_counts_votes(self, lines_img):
        lines = hough_sht(jnp.asarray(lines_img),
                          HoughShtConfig(threshold=40, max_lines=8))
        v = np.asarray(lines.valid)
        s = np.asarray(lines.strength)[v]
        assert s.max() >= 60  # the 90-px horizontal line

    def test_kht_finds_lines(self, lines_img):
        from compv_tpu.features.edges import sobel_gradients
        gx, gy = sobel_gradients(jnp.asarray(lines_img))
        lines = hough_kht(jnp.asarray(lines_img), gx, gy,
                          HoughKhtConfig(max_lines=8, threshold_ratio=0.05))
        v = np.asarray(lines.valid)
        assert v.sum() >= 2
        thetas = np.asarray(lines.theta)[v]
        rhos = np.asarray(lines.rho)[v]
        has_horiz = np.any((np.abs(thetas - np.pi / 2) < 0.1)
                           & (np.abs(rhos - 20) < 3))
        has_vert = np.any(((np.abs(thetas) < 0.1) | (np.abs(thetas - np.pi) < 0.1))
                          & (np.abs(np.abs(rhos) - 40) < 3))
        assert has_horiz and has_vert

    def test_empty_edges(self):
        lines = hough_sht(jnp.zeros((32, 32), jnp.uint8))
        assert int(lines.count()) == 0


class TestHoughDense:
    """Regression: dense maps must not lose votes silently
    (reference accumulates every edge pixel, houghsht.cxx:350)."""

    @pytest.fixture(scope="class")
    def dense_map(self):
        rs = np.random.default_rng(3)
        img = np.zeros((480, 640), np.uint8)
        mask = rs.uniform(size=img.shape) < 0.12   # ~37k random edges
        img[mask] = 255
        img[40, :] = 255                            # plus two real lines
        img[:, 200] = 255
        return img

    @staticmethod
    def _oracle_acc(xs, ys, wts, h, w, cfg):
        """np.add.at over EVERY vote. Bins come from float64 trig, except
        that a vote whose rho sits within the fixed-point quantization
        error of a half-bin takes the device's documented tie rule (the
        int32 fixed-point formula, replayed in int64)."""
        from compv_tpu.features.hough import (_fixed_point_shift,
                                              _trig_tables)
        theta_step = float(np.deg2rad(cfg.theta_step_deg))
        n_theta = int(np.round(np.pi / theta_step))
        rho_max = float(np.hypot(h, w))
        n_rho = int(np.ceil(2 * rho_max / cfg.rho)) + 1
        shift = _fixed_point_shift(h, w, rho_max, cfg.rho)
        t = np.arange(n_theta) * theta_step
        x = xs.astype(np.int64)[None, :]
        y = ys.astype(np.int64)[None, :]
        u = (np.cos(t)[:, None] * x + np.sin(t)[:, None] * y
             + rho_max) / cfg.rho
        rbin = np.floor(u + 0.5).astype(np.int64)
        cos_q, sin_q = (v.astype(np.int64)[:, None]
                        for v in _trig_tables(n_theta, theta_step, shift))
        step_q = int(round(cfg.rho * 2.0 ** shift))
        num = cos_q * x + sin_q * y + int(round(rho_max * 2.0 ** shift))
        fixed = (num + step_q // 2) // step_q
        near_half = np.abs(u - np.floor(u) - 0.5) < (w + h) * 2.0 ** -shift
        assert (fixed[~near_half] == rbin[~near_half]).all()
        rbin = np.clip(np.where(near_half, fixed, rbin), 0, n_rho - 1)
        acc = np.zeros((n_theta, n_rho), np.int64)
        np.add.at(acc, (np.broadcast_to(np.arange(n_theta)[:, None],
                                        rbin.shape), rbin),
                  np.broadcast_to(wts[None, :], rbin.shape))
        return acc

    def _device_acc(self, xs, ys, wts, valid, h, w, cfg):
        from compv_tpu.features.hough import _accumulate, _fixed_point_shift
        theta_step = float(np.deg2rad(cfg.theta_step_deg))
        n_theta = int(np.round(np.pi / theta_step))
        rho_max = float(np.hypot(h, w))
        acc, _ = _accumulate(jnp.asarray(xs, jnp.float32),
                             jnp.asarray(ys, jnp.float32),
                             jnp.asarray(valid), jnp.asarray(wts), n_theta,
                             rho_max, cfg.rho, theta_step,
                             _fixed_point_shift(h, w, rho_max, cfg.rho))
        return np.asarray(acc)

    def test_dense_accumulator_exact(self, dense_map):
        from compv_tpu.features.hough import _edge_list
        cfg = HoughShtConfig()
        h, w = dense_map.shape
        n_edges = int((dense_map > 0).sum())
        assert n_edges > 30000  # the r1 failure regime
        x, y, valid = _edge_list(jnp.asarray(dense_map), cfg.max_edge_points)
        assert int(np.asarray(valid).sum()) == n_edges  # nothing dropped
        acc = self._device_acc(np.asarray(x), np.asarray(y),
                               np.ones(x.shape, np.int32), np.asarray(valid),
                               h, w, cfg)
        ys, xs = np.nonzero(dense_map)
        oracle = self._oracle_acc(xs, ys, np.ones(xs.shape, np.int64), h, w,
                                  cfg)
        np.testing.assert_array_equal(acc, oracle)

    @pytest.mark.parametrize("rho", [1.0, 0.5])
    def test_weighted_accumulator_exact(self, rho):
        """Integer weights (0 for padded slots) against np.add.at."""
        rs = np.random.default_rng(17)
        h, w, n = 300, 420, 5000
        xs = rs.integers(0, w, n)
        ys = rs.integers(0, h, n)
        wts = rs.integers(0, 6, n)
        valid = rs.uniform(size=n) < 0.9
        cfg = HoughShtConfig(rho=rho)
        acc = self._device_acc(xs, ys, wts.astype(np.int32), valid, h, w,
                               cfg)
        oracle = self._oracle_acc(xs, ys, np.where(valid, wts, 0), h, w, cfg)
        np.testing.assert_array_equal(acc, oracle)

    def test_dense_lines_found(self, dense_map):
        from compv_tpu.features.hough import hough_sht_stats
        lines, stats = hough_sht_stats(
            jnp.asarray(dense_map), HoughShtConfig(threshold=200, max_lines=8))
        assert stats["n_edges"] > 30000 and not stats["truncated"]
        v = np.asarray(lines.valid)
        thetas = np.asarray(lines.theta)[v]
        rhos = np.asarray(lines.rho)[v]
        assert np.any((np.abs(thetas - np.pi / 2) < 0.05)
                      & (np.abs(rhos - 40) < 2))   # y=40 row line
        assert np.any((np.abs(thetas) < 0.05)
                      & (np.abs(rhos - 200) < 2))  # x=200 column line

    def test_truncation_reported_and_ranked(self, dense_map):
        """Overflowing capacity reports truncation and keeps the STRONGEST
        edges when a strength map is given."""
        from compv_tpu.features.hough import hough_sht_stats
        strengths = jnp.asarray(
            np.where(dense_map > 0, 1.0, 0.0).astype(np.float32)
            + np.linspace(0, 1, dense_map.size, dtype=np.float32
                          ).reshape(dense_map.shape))
        cfg = HoughShtConfig(threshold=10, max_lines=4, max_edge_points=1024)
        lines, stats = hough_sht_stats(jnp.asarray(dense_map), cfg, strengths)
        assert stats["truncated"] and stats["n_edges"] > 1024
