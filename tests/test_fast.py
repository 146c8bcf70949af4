"""FAST detector tests: dense-map parity with a scalar oracle implementing
the reference semantics (fast_dete.cxx:658-771), NMS semantics, detect API."""
import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu.features.fast import (
    CIRCLE_OFFSETS, FastConfig, fast_detect, fast_nms, fast_strengths,
)


def oracle_strengths(img: np.ndarray, threshold: int, n: int) -> np.ndarray:
    """Scalar reference implementation of the FAST strength definition:
    strength(p) = max over 16 circular windows of length n of
    (min over window of one-sided saturated diffs)."""
    h, w = img.shape
    out = np.zeros((h, w), np.uint8)
    f = img.astype(np.int32)
    for y in range(3, h - 3):
        for x in range(3, w - 3):
            p = f[y, x]
            brighter = min(p + threshold, 255)
            darker = max(p - threshold, 0)
            d = np.empty(16, np.int32)
            b = np.empty(16, np.int32)
            for i, (dy, dx) in enumerate(CIRCLE_OFFSETS):
                c = f[y + dy, x + dx]
                d[i] = max(darker - c, 0)
                b[i] = max(c - brighter, 0)
            best = 0
            for side in (d, b):
                ext = np.concatenate([side, side])
                for s in range(16):
                    m = ext[s:s + n].min()
                    best = max(best, m)
            out[y, x] = best
    return out


@pytest.fixture(scope="module")
def corner_img():
    """Small image with synthetic corners + noise."""
    rs = np.random.default_rng(11)
    img = rs.integers(90, 110, (48, 64), dtype=np.uint8).astype(np.uint8)
    img[10:20, 10:25] = 220          # bright rectangle -> 4 corners
    img[30:40, 35:50] = 15           # dark rectangle
    img[24, 55] = 250                # isolated bright dot
    return img


class TestStrengths:
    @pytest.mark.parametrize("n", [9, 12])
    @pytest.mark.parametrize("threshold", [10, 20, 40])
    def test_dense_parity_with_oracle(self, corner_img, threshold, n):
        got = np.asarray(fast_strengths(jnp.asarray(corner_img), threshold, n))
        want = oracle_strengths(corner_img, threshold, n)
        np.testing.assert_array_equal(got, want)

    def test_flat_image_no_corners(self):
        img = np.full((32, 32), 128, np.uint8)
        s = np.asarray(fast_strengths(jnp.asarray(img), 20, 9))
        assert s.sum() == 0

    def test_border_is_zero(self, corner_img):
        s = np.asarray(fast_strengths(jnp.asarray(corner_img), 20, 9))
        assert s[:3].sum() == 0 and s[-3:].sum() == 0
        assert s[:, :3].sum() == 0 and s[:, -3:].sum() == 0


class TestNms:
    def test_tie_suppresses_both(self):
        s = np.zeros((16, 16), np.uint8)
        s[8, 8] = 50
        s[8, 9] = 50  # equal neighbor: both must be suppressed
        out = np.asarray(fast_nms(jnp.asarray(s)))
        assert out[8, 8] == 0 and out[8, 9] == 0

    def test_strict_max_survives(self):
        s = np.zeros((16, 16), np.uint8)
        s[8, 8] = 50
        s[8, 9] = 49
        out = np.asarray(fast_nms(jnp.asarray(s)))
        assert out[8, 8] == 50 and out[8, 9] == 0

    def test_oracle_parity(self, corner_img):
        s = np.asarray(fast_strengths(jnp.asarray(corner_img), 20, 9))
        got = np.asarray(fast_nms(jnp.asarray(s)))
        want = np.zeros_like(s)
        h, w = s.shape
        for y in range(3, h - 3):
            for x in range(3, w - 3):
                v = s[y, x]
                if v == 0:
                    continue
                neigh = s[y - 1:y + 2, x - 2 + 1:x + 2].astype(int)
                neighbors = [s[y - 1, x - 1], s[y - 1, x], s[y - 1, x + 1],
                             s[y, x - 1], s[y, x + 1],
                             s[y + 1, x - 1], s[y + 1, x], s[y + 1, x + 1]]
                if max(neighbors) < v:
                    want[y, x] = v
        np.testing.assert_array_equal(got, want)


class TestDetect:
    def test_detect_finds_rect_corners(self, corner_img):
        kp = fast_detect(jnp.asarray(corner_img), FastConfig(threshold=20, nms=True))
        n = int(kp.count())
        assert n > 0
        xs = np.asarray(kp.x)[np.asarray(kp.valid)]
        ys = np.asarray(kp.y)[np.asarray(kp.valid)]
        # at least one detection near a corner of the bright rectangle
        corners = [(10, 10), (10, 24), (19, 10), (19, 24)]
        dmin = min(min(abs(xs - cx) + abs(ys - cy)) for (cy, cx) in corners)
        assert dmin <= 2

    def test_sorted_by_strength(self, corner_img):
        kp = fast_detect(jnp.asarray(corner_img), FastConfig(max_features=100))
        s = np.asarray(kp.strength)
        assert (np.diff(s) <= 1e-6).all()

    def test_max_features_cap(self, corner_img):
        kp = fast_detect(jnp.asarray(corner_img), FastConfig(max_features=5))
        assert kp.capacity == 5
        assert int(kp.count()) <= 5

    def test_no_nms_superset(self, corner_img):
        kp_nms = fast_detect(jnp.asarray(corner_img), FastConfig(nms=True, max_features=2000))
        kp_all = fast_detect(jnp.asarray(corner_img), FastConfig(nms=False, max_features=2000))
        assert int(kp_all.count()) >= int(kp_nms.count())


def _oracle_nms(s: np.ndarray) -> np.ndarray:
    """Scalar 3x3 NMS (suppress unless strictly above all 8 neighbours),
    interior [3, dim-3) only."""
    out = np.zeros_like(s)
    h, w = s.shape
    for y in range(3, h - 3):
        for x in range(3, w - 3):
            v = s[y, x]
            win = s[y - 1:y + 2, x - 1:x + 2].astype(int).ravel()
            if v > 0 and max(np.delete(win, 4)) < v:
                out[y, x] = v
    return out


def _production(img, threshold, n, nms):
    """The detectors' own path: f32 strengths, optional f32 NMS."""
    from compv_tpu.features.fast import _nms_f32, _strengths_f32
    s = _strengths_f32(jnp.asarray(img), threshold, n)
    if nms:
        s = _nms_f32(s)
    return np.asarray(s)


class TestProductionPath:
    """`_strengths_f32` / `_nms_f32` (what fast_detect and ORB run) against
    the scalar oracle."""

    def test_odd_size(self):
        img = np.random.default_rng(3).integers(0, 255, (97, 131),
                                                dtype=np.uint8)
        want = _oracle_nms(oracle_strengths(img, 20, 9))
        np.testing.assert_array_equal(_production(img, 20, 9, True), want)

    @pytest.mark.parametrize("spec", ["fast9_thr20_nms1", "fast9_thr20_nms0",
                                      "fast12_thr40_nms1", "fast9_thr40_nms1"])
    def test_golden_specs(self, spec):
        """The golden FAST specs on the golden image: the production maps
        over the full image, checked against the oracle on a 120x160
        window over the checkerboard's top-left corner, where the FAST-9
        specs find corners (the oracle is scalar Python; the window keeps
        it to about a second)."""
        from tests.fixtures import make_test_image
        n = int(spec[4: spec.index("_")])
        thr = int(spec.split("thr")[1].split("_")[0])
        nms = spec.endswith("nms1")
        img = make_test_image()
        y0, x0 = 70, 100
        win = img[y0:y0 + 120, x0:x0 + 160]
        want = oracle_strengths(win, thr, n)
        if nms:
            want = _oracle_nms(want)
        got = _production(img, thr, n, nms)[y0:y0 + 120, x0:x0 + 160]
        m = 4 if nms else 3          # the oracle's own window border
        np.testing.assert_array_equal(got[m:-m, m:-m], want[m:-m, m:-m])
