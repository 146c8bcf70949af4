"""Paeth 3-shear rotation (gather-free rotation) tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu.image.scale import _roll_lines, rotate_bilinear, rotate_fast


class TestRollLines:
    def test_per_row_roll(self):
        x = jnp.asarray(np.arange(4 * 8, dtype=np.float32).reshape(4, 8))
        shifts = jnp.asarray([0, 1, 3, 7], jnp.int32)
        out = np.asarray(_roll_lines(x, shifts, axis=1))
        for r, s in enumerate([0, 1, 3, 7]):
            np.testing.assert_array_equal(out[r], np.roll(np.asarray(x)[r], -s))

    def test_per_col_roll(self):
        x = jnp.asarray(np.arange(8 * 4, dtype=np.float32).reshape(8, 4))
        shifts = jnp.asarray([2, 0, 5, 1], jnp.int32)
        out = np.asarray(_roll_lines(x, shifts, axis=0))
        for c, s in enumerate([2, 0, 5, 1]):
            np.testing.assert_array_equal(out[:, c], np.roll(np.asarray(x)[:, c], -s))

    def test_negative_shift_wraps(self):
        x = jnp.asarray(np.arange(2 * 8, dtype=np.float32).reshape(2, 8))
        out = np.asarray(_roll_lines(x, jnp.asarray([-1, -3]), axis=1))
        np.testing.assert_array_equal(out[0], np.roll(np.asarray(x)[0], 1))
        np.testing.assert_array_equal(out[1], np.roll(np.asarray(x)[1], 3))


class TestRotateFast:
    def _image(self, h=96, w=128):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = 128 + 60 * np.sin(xx / 9.0) + 50 * np.cos(yy / 7.0)
        return np.clip(img, 0, 255).astype(np.uint8)

    def test_zero_angle_is_identity_embed(self):
        img = self._image()
        out = np.asarray(rotate_fast(jnp.asarray(img), jnp.float32(0.0)))
        s = out.shape[0]
        py = (s - img.shape[0]) // 2
        px = (s - img.shape[1]) // 2
        np.testing.assert_allclose(
            out[py:py + img.shape[0], px:px + img.shape[1]], img, atol=1e-3)

    def test_matches_bilinear_warp_interior(self):
        """Same rotation as the gather-based bilinear warp (within lerp
        formulation differences) on the interior."""
        img = self._image()
        h, w = img.shape
        a = 30.0
        fast = np.asarray(rotate_fast(jnp.asarray(img), jnp.float32(a)))
        s = fast.shape[0]
        canvas = np.zeros((s, s), np.uint8)
        py, px = (s - h) // 2, (s - w) // 2
        canvas[py:py + h, px:px + w] = img
        ref = np.asarray(rotate_bilinear(jnp.asarray(canvas),
                                         jnp.float32(a))).astype(np.float32)
        inner = np.abs(fast - ref)[py + 8:py + h - 8, px + 8:px + w - 8]
        assert inner.mean() < 1.0
        assert np.percentile(inner, 99) < 12.0

    def test_mass_preserved(self):
        """Shears only translate lines: total intensity is preserved up to
        lerp boundary loss."""
        img = self._image()
        out = np.asarray(rotate_fast(jnp.asarray(img), jnp.float32(20.0)))
        assert abs(out.sum() - float(img.astype(np.int64).sum())) \
            / img.astype(np.int64).sum() < 0.01

    def test_jit_traced_angle(self):
        img = jnp.asarray(self._image())
        f = jax.jit(rotate_fast)
        o1 = f(img, jnp.float32(10.0))
        o2 = f(img, jnp.float32(-10.0))  # same compiled fn, different angle
        assert o1.shape == o2.shape
        assert not np.allclose(np.asarray(o1), np.asarray(o2))
