"""CCL, MSER, HOG tests with scipy oracles where applicable."""
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from compv_tpu.features.ccl import CclConfig, ccl_features, label_components
from compv_tpu.features.hog import HogConfig, gradient_fast, hog_descriptor
from compv_tpu.features.mser import MserConfig, mser_detect


@pytest.fixture(scope="module")
def blob_img():
    img = np.zeros((64, 96), np.uint8)
    img[5:15, 5:20] = 255          # blob A: 10x15
    img[30:50, 40:60] = 255        # blob B: 20x20
    img[60:63, 90:95] = 255        # blob C: 3x5
    img[20, 70] = 255              # single pixel
    return img


class TestCcl:
    def test_component_count_matches_scipy(self, blob_img):
        res = ccl_features(jnp.asarray(blob_img), CclConfig(max_components=16))
        lbl_scipy, n_scipy = ndimage.label(blob_img > 0,
                                           structure=np.ones((3, 3)))
        assert int(res.num_components) == n_scipy

    def test_labels_partition_match(self, blob_img):
        lbl = np.asarray(label_components(jnp.asarray(blob_img)))
        want, _ = ndimage.label(blob_img > 0, structure=np.ones((3, 3)))
        # same partition: bijection between label sets on foreground
        fg = blob_img > 0
        pairs = set(zip(lbl[fg].tolist(), want[fg].tolist()))
        assert len(pairs) == len(set(p[0] for p in pairs))
        assert len(pairs) == len(set(p[1] for p in pairs))
        assert (lbl[~fg] == -1).all()

    def test_areas_and_boxes(self, blob_img):
        res = ccl_features(jnp.asarray(blob_img), CclConfig(max_components=16))
        areas = sorted(np.asarray(res.area)[np.asarray(res.valid)].tolist(),
                       reverse=True)
        assert areas == [400, 150, 15, 1]
        # biggest blob (B) bbox
        i = int(np.argmax(np.asarray(res.area)))
        assert (int(res.box_x0[i]), int(res.box_y0[i]),
                int(res.box_x1[i]), int(res.box_y1[i])) == (40, 30, 59, 49)
        np.testing.assert_allclose(
            [float(res.cx[i]), float(res.cy[i])], [49.5, 39.5], atol=1e-4)

    def test_4_connectivity(self):
        img = np.zeros((8, 8), np.uint8)
        img[1, 1] = img[2, 2] = 255  # diagonal touch
        res8 = ccl_features(jnp.asarray(img), CclConfig(connectivity=8,
                                                        max_components=8))
        res4 = ccl_features(jnp.asarray(img), CclConfig(connectivity=4,
                                                        max_components=8))
        assert int(res8.num_components) == 1
        assert int(res4.num_components) == 2

    def test_spiral_convergence(self):
        """Long snake component — worst case for plain propagation; pointer
        jumping must still converge within the iteration cap."""
        img = np.zeros((40, 40), np.uint8)
        # boustrophedon snake
        for r in range(0, 40, 4):
            img[r, :] = 255
            if r + 4 < 40:
                img[r:r + 4, 39 if (r // 4) % 2 == 0 else 0] = 255
        res = ccl_features(jnp.asarray(img), CclConfig(max_components=8))
        assert int(res.num_components) == 1


class TestCclRunExtraction:
    """The r5 run-record feature extractor (extract_runs + segmented
    stats) vs the scipy oracle and the capacity-overflow fallback."""

    def test_random_image_full_oracle(self):
        rs = np.random.default_rng(7)
        img = (rs.random((96, 120)) < 0.35).astype(np.uint8)
        lbl_s, n = ndimage.label(img > 0, structure=np.ones((3, 3)))
        from compv_tpu.features.ccl import ccl_features_from_labels
        lbl = label_components(jnp.asarray(img * 255))
        res = ccl_features_from_labels(
            lbl, CclConfig(max_components=max(256, n)))
        assert int(res.num_components) == n
        v = np.asarray(res.valid)
        assert v.sum() == n
        got = sorted(
            (int(res.area[i]), int(res.box_x0[i]), int(res.box_y0[i]),
             int(res.box_x1[i]), int(res.box_y1[i]),
             round(float(res.cx[i]), 3), round(float(res.cy[i]), 3))
            for i in np.nonzero(v)[0])
        objs = ndimage.find_objects(lbl_s)
        areas = np.bincount(lbl_s.ravel())[1:]
        cys, cxs = zip(*ndimage.center_of_mass(
            img > 0, lbl_s, np.arange(1, n + 1)))
        want = sorted(
            (int(areas[i]), objs[i][1].start, objs[i][0].start,
             objs[i][1].stop - 1, objs[i][0].stop - 1,
             round(float(cxs[i]), 3), round(float(cys[i]), 3))
            for i in range(n))
        assert got == want

    def test_overflow_falls_back_to_pixel_path(self):
        img = np.zeros((16, 300), np.uint8)
        img[:, ::2] = 1                       # 150 runs/row > capacity 128
        lbl = label_components(jnp.asarray(img * 255))
        from compv_tpu.features.ccl import ccl_features_from_labels
        res = ccl_features_from_labels(lbl, CclConfig(max_components=160))
        _, n = ndimage.label(img > 0, structure=np.ones((3, 3)))
        assert int(res.num_components) == n
        areas = np.asarray(res.area)[np.asarray(res.valid)]
        assert (areas == 16).all() and len(areas) == 150

    def test_single_row_and_column_runs(self):
        img = np.zeros((5, 9), np.uint8)
        img[2, 2:8] = 1                       # one horizontal run
        img[:, 0] = 1                         # one vertical run (5 rows)
        from compv_tpu.features.ccl import ccl_features_from_labels
        lbl = label_components(jnp.asarray(img * 255))
        res = ccl_features_from_labels(lbl, CclConfig(max_components=4))
        got = sorted(
            (int(res.area[i]), int(res.box_x0[i]), int(res.box_y0[i]),
             int(res.box_x1[i]), int(res.box_y1[i]))
            for i in np.nonzero(np.asarray(res.valid))[0])
        assert got == [(5, 0, 0, 0, 4), (6, 2, 2, 7, 2)]


@pytest.mark.slow
class TestMser:
    def test_dark_blobs_found(self):
        img = np.full((80, 120), 220, np.uint8)
        img[10:30, 10:40] = 40     # dark blob 1
        img[50:70, 70:110] = 60    # dark blob 2
        res = mser_detect(jnp.asarray(img), MserConfig(max_regions=32))
        v = np.asarray(res.valid)
        assert v.sum() >= 2
        boxes = np.stack([np.asarray(res.box_x0)[v], np.asarray(res.box_y0)[v],
                          np.asarray(res.box_x1)[v], np.asarray(res.box_y1)[v]], 1)
        # both blobs present as (near-exact) boxes
        def has_box(x0, y0, x1, y1):
            return any(abs(b[0]-x0) <= 1 and abs(b[1]-y0) <= 1
                       and abs(b[2]-x1) <= 1 and abs(b[3]-y1) <= 1 for b in boxes)
        assert has_box(10, 10, 39, 29)
        assert has_box(70, 50, 109, 69)

    def test_bright_mode(self):
        img = np.full((60, 60), 30, np.uint8)
        img[20:40, 20:40] = 230
        res_d = mser_detect(jnp.asarray(img), MserConfig(dark=True, max_regions=16))
        res_b = mser_detect(jnp.asarray(img), MserConfig(dark=False, max_regions=16))
        vb = np.asarray(res_b.valid)
        assert vb.sum() >= 1
        i = np.nonzero(vb)[0][0]
        assert abs(int(res_b.box_x0[i]) - 20) <= 1

    def test_area_filters(self):
        img = np.full((64, 64), 200, np.uint8)
        img[30, 30] = 10            # tiny region — below min_area
        res = mser_detect(jnp.asarray(img), MserConfig(min_area=0.01))
        v = np.asarray(res.valid)
        areas = np.asarray(res.area)[v]
        assert (areas >= 0.01 * 64 * 64).all() if v.any() else True


class TestHog:
    def test_shape(self):
        rs = np.random.default_rng(0)
        img = rs.integers(0, 255, (128, 64), dtype=np.uint8)
        d = hog_descriptor(jnp.asarray(img))
        # 16x8 cells, 2x2 blocks stride 1 -> 15x7 blocks x 36
        assert d.shape == (15, 7, 36)

    def test_norm_bounded(self):
        rs = np.random.default_rng(1)
        img = rs.integers(0, 255, (64, 64), dtype=np.uint8)
        d = np.asarray(hog_descriptor(jnp.asarray(img)))
        norms = np.linalg.norm(d, axis=-1)
        assert np.all(norms < 1.01)
        assert np.all(d >= 0)

    def test_vertical_edge_bin(self):
        """Vertical edge -> horizontal gradient -> angle 0 -> first bin
        dominates (unsigned, bilinear splits across wrap)."""
        img = np.zeros((32, 32), np.uint8)
        img[:, 16:] = 255
        d = np.asarray(hog_descriptor(jnp.asarray(img), HogConfig(norm="none")))
        hist = d.reshape(-1, 9).sum(0)
        assert hist.argmax() == 0 or hist.argmax() == 8  # wrap-adjacent

    def test_gradient_fast_matches_numpy(self):
        rs = np.random.default_rng(2)
        img = rs.integers(0, 255, (16, 16), dtype=np.uint8)
        gx, gy = gradient_fast(jnp.asarray(img))
        f = img.astype(np.float32)
        want_gx = (np.pad(f, ((0, 0), (1, 1)), mode="edge")[:, 2:]
                   - np.pad(f, ((0, 0), (1, 1)), mode="edge")[:, :-2]) * 0.5
        np.testing.assert_allclose(np.asarray(gx), want_gx, atol=1e-5)

    def test_rotation_shifts_bins(self):
        """45deg gratings put energy in a different bin than 0deg."""
        yy, xx = np.mgrid[0:64, 0:64]
        v = (np.sin(xx * 0.8) * 127 + 128).astype(np.uint8)
        d_v = np.asarray(hog_descriptor(jnp.asarray(v), HogConfig(norm="none"))
                         ).reshape(-1, 9).sum(0)
        diag = (np.sin((xx + yy) * 0.6) * 127 + 128).astype(np.uint8)
        d_d = np.asarray(hog_descriptor(jnp.asarray(diag), HogConfig(norm="none"))
                         ).reshape(-1, 9).sum(0)
        assert d_v.argmax() != d_d.argmax()


@pytest.mark.slow
class TestMserFidelity:
    """Acceptance vs a full-resolution SEQUENTIAL oracle (the reference's
    LMSER semantics: one-sided variation at +delta, local-min stability,
    min-diversity pruning — lmser_result.h:91-199), bounding the divergence
    introduced by the gray-level ladder sampling."""

    @staticmethod
    def _oracle(img, delta=5, min_area=0.0002, max_area=0.5,
                max_variation=0.5, min_diversity=0.5):
        from scipy import ndimage
        h, w = img.shape
        n = h * w
        idx = np.arange(n).reshape(h, w)
        struct = np.ones((3, 3), bool)  # 8-connectivity
        # per-level: root (min flat index) + area of component containing
        # every pixel
        root_of_pix = np.full((256, n), -1, np.int64)
        area_of_pix = np.zeros((256, n), np.int64)
        for t in range(256):
            m = img <= t
            lab, _ = ndimage.label(m, structure=struct)
            flat = lab.ravel()
            if lab.max() == 0:
                continue
            roots = ndimage.minimum(idx.ravel(), flat, np.arange(1, lab.max() + 1))
            areas = np.bincount(flat)[1:]
            root_of_pix[t][m.ravel()] = roots[flat[m.ravel()] - 1]
            area_of_pix[t][m.ravel()] = areas[flat[m.ravel()] - 1]
        # nodes: (t, root) first appearances (distinct root+area runs)
        regions = []
        for t in range(256):
            roots = np.unique(root_of_pix[t][root_of_pix[t] >= 0])
            for r in roots:
                a = area_of_pix[t][r]
                if root_of_pix[t - 1][r] == r and area_of_pix[t - 1][r] == a \
                        if t > 0 else False:
                    continue  # same node as previous level
                tp = min(t + delta, 255)
                ap = area_of_pix[tp][r]
                var = (ap - a) / a
                regions.append({"t": t, "root": r, "area": a, "var": var})
        # stability: local min of var along the chain through the seed
        by_key = {(rg["t"], rg["root"]): rg for rg in regions}
        stable = []
        for rg in regions:
            t, r, a = rg["t"], rg["root"], rg["area"]
            if not (min_area * n <= a <= max_area * n
                    and rg["var"] <= max_variation):
                continue
            # parent: next level where the containing component differs
            var_up = None
            for tu in range(t + 1, 256):
                ru, au = root_of_pix[tu][r], area_of_pix[tu][r]
                if ru != r or au != a:
                    g = by_key.get((tu, ru))
                    if g is not None:
                        var_up = g["var"]
                    break
            var_dn = None
            for td in range(t - 1, -1, -1):
                rd = root_of_pix[td][r]
                if rd < 0:
                    break
                if rd != r or area_of_pix[td][rd] != a:
                    g = by_key.get((td, rd))
                    if g is not None:
                        var_dn = g["var"]
                    break
            if (var_up is None or rg["var"] <= var_up) and \
               (var_dn is None or rg["var"] <= var_dn):
                stable.append(rg)
        # min-diversity greedy collect, most stable first
        stable.sort(key=lambda g: g["var"])
        out = []
        for rg in stable:
            dup = False
            for kept in out:
                t_hi, g_lo = (rg, kept) if rg["t"] >= kept["t"] else (kept, rg)
                nested = root_of_pix[t_hi["t"]][g_lo["root"]] == t_hi["root"]
                rel = abs(rg["area"] - kept["area"]) / max(rg["area"],
                                                           kept["area"])
                if nested and rel < min_diversity:
                    dup = True
                    break
            if not dup:
                ys, xs = np.nonzero(
                    root_of_pix[rg["t"]].reshape(img.shape) == rg["root"])
                rg["box"] = (xs.min(), ys.min(), xs.max(), ys.max())
                out.append(rg)
        return out

    @pytest.fixture(scope="class")
    def blob_img(self):
        img = np.full((96, 96), 230, np.uint8)
        img[10:30, 10:40] = 40                 # blob A
        img[50:80, 50:86] = 100                # blob B (outer)
        img[58:72, 58:78] = 30                 # blob B (nested inner)
        return img

    def test_matches_sequential_oracle(self, blob_img):
        cfg = MserConfig(level_step=4)
        res = mser_detect(jnp.asarray(blob_img), cfg)
        v = np.asarray(res.valid)
        ours = np.stack([np.asarray(res.box_x0)[v], np.asarray(res.box_y0)[v],
                         np.asarray(res.box_x1)[v], np.asarray(res.box_y1)[v]],
                        1)
        oracle = self._oracle(blob_img, delta=cfg.delta,
                              min_area=cfg.min_area, max_area=cfg.max_area,
                              max_variation=cfg.max_variation,
                              min_diversity=cfg.min_diversity)
        assert len(oracle) >= 2

        def iou(a, b):
            ix = max(0, min(a[2], b[2]) - max(a[0], b[0]) + 1)
            iy = max(0, min(a[3], b[3]) - max(a[1], b[1]) + 1)
            inter = ix * iy
            aa = (a[2] - a[0] + 1) * (a[3] - a[1] + 1)
            ab = (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
            return inter / (aa + ab - inter)

        # every oracle region must be recovered (IoU >= 0.6) — the ladder
        # sampling may add/miss borderline duplicates but not real regions
        matched = sum(1 for g in oracle
                      if any(iou(g["box"], b) >= 0.6 for b in ours))
        assert matched == len(oracle), (oracle, ours)
        # and the counts stay within 2x (bounded divergence)
        assert v.sum() <= 2 * len(oracle) + 2

    def test_delta_semantics(self):
        """A region whose area grows steadily with threshold has variation
        proportional to delta — large delta must reject it (the r1 dead
        `delta` knob regression)."""
        h = w = 96
        yy, xx = np.mgrid[0:h, 0:w]
        rad = np.hypot(yy - 48, xx - 48)
        # disk whose radius grows ~1px per 8 gray levels
        img = np.clip(40 + (rad * 8), 0, 230).astype(np.uint8)
        res_small = mser_detect(jnp.asarray(img),
                                MserConfig(delta=2, level_step=2,
                                           max_variation=0.6))
        res_big = mser_detect(jnp.asarray(img),
                              MserConfig(delta=48, level_step=2,
                                         max_variation=0.6))
        assert int(res_small.count()) > int(res_big.count())

    def test_min_diversity(self):
        """Nested regions with similar areas collapse under high
        min_diversity and both survive under low."""
        img = np.full((64, 64), 220, np.uint8)
        img[15:47, 15:47] = 90     # outer 32x32
        img[16:46, 16:46] = 40     # inner 30x30 (rel area diff ~0.12)
        hi = mser_detect(jnp.asarray(img),
                         MserConfig(min_diversity=0.5, level_step=4))
        lo = mser_detect(jnp.asarray(img),
                         MserConfig(min_diversity=0.05, level_step=4))
        assert int(lo.count()) > int(hi.count())

    def test_region_points(self):
        from compv_tpu.features.mser import mser_region_mask, mser_region_points
        img = np.full((48, 48), 200, np.uint8)
        img[10:20, 12:30] = 50
        res = mser_detect(jnp.asarray(img), MserConfig(level_step=4))
        v = np.asarray(res.valid)
        assert v.sum() >= 1
        i = int(np.nonzero(v)[0][0])
        mask = mser_region_mask(jnp.asarray(img), int(res.seed_x[i]),
                                int(res.seed_y[i]), int(res.level[i]))
        m = np.asarray(mask)
        assert m.sum() == int(res.area[i])
        xs, ys, pv = mser_region_points(mask, max_points=512)
        pts = set(zip(np.asarray(xs)[np.asarray(pv)].tolist(),
                      np.asarray(ys)[np.asarray(pv)].tolist()))
        my, mx = np.nonzero(m)
        assert pts == set(zip(mx.tolist(), my.tolist()))


class TestHogLut:
    def test_bilinear_lut_matches_bilinear(self):
        """The quantized-LUT mode (reference hog_std's third interp) must
        converge to exact bilinear as the LUT densifies and already agree
        closely at the default 1024 steps."""
        rs = np.random.default_rng(11)
        img = rs.integers(0, 255, (64, 64), dtype=np.uint8)
        d_bi = np.asarray(hog_descriptor(jnp.asarray(img),
                                         HogConfig(norm="none")))
        d_lut = np.asarray(hog_descriptor(
            jnp.asarray(img), HogConfig(norm="none", interp="bilinear_lut")))
        rel = np.abs(d_lut - d_bi).max() / (np.abs(d_bi).max() + 1e-9)
        assert rel < 0.01, rel
        d_lut_fine = np.asarray(hog_descriptor(
            jnp.asarray(img), HogConfig(norm="none", interp="bilinear_lut",
                                        lut_bins=1 << 16)))
        rel_fine = np.abs(d_lut_fine - d_bi).max() / (np.abs(d_bi).max() + 1e-9)
        assert rel_fine < rel

    def test_lut_is_quantized(self):
        """Two angles inside one LUT step must vote identically."""
        cfg = HogConfig(norm="none", interp="bilinear_lut", lut_bins=16)
        base = np.zeros((16, 16), np.uint8)
        # gradients along two very close directions
        yy, xx = np.mgrid[0:16, 0:16].astype(np.float32)
        img1 = np.clip(xx * 10 + yy * 1.00, 0, 255).astype(np.uint8)
        img2 = np.clip(xx * 10 + yy * 1.02, 0, 255).astype(np.uint8)
        d1 = np.asarray(hog_descriptor(jnp.asarray(img1), cfg))
        d2 = np.asarray(hog_descriptor(jnp.asarray(img2), cfg))
        # same LUT cell -> same bin weights; magnitudes differ slightly
        nz1, nz2 = d1.ravel() != 0, d2.ravel() != 0
        assert (nz1 == nz2).all()


def test_mser_variation_fixed_point():
    """MSER's integer variation round(grow / area * 2^16), clamped, against
    exact rational arithmetic."""
    from fractions import Fraction
    from compv_tpu.features.mser import _VAR_CLAMP, _variation_q
    rs = np.random.default_rng(4)
    area = np.concatenate([rs.integers(1, 2_000_000, 300),
                           [1, 2, 3, 7, 100]]).astype(np.int32)
    grow = np.concatenate([rs.integers(0, 3_000_000, 300),
                           [0, 1, 3, 70000, 800001]]).astype(np.int32)
    got = np.asarray(_variation_q(jnp.asarray(grow), jnp.asarray(area)))
    want = [min(int(Fraction(int(g) * 65536, int(a)) + Fraction(1, 2)),
                _VAR_CLAMP << 16) for g, a in zip(grow, area)]
    np.testing.assert_array_equal(got, np.asarray(want))
