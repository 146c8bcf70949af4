"""Fixed-point (Q0.16) separable convolution parity.

The scalar oracle below re-implements the reference's exact arithmetic
(convlt1VtHzFixedPoint_C, base/include/compv/base/math/
compv_math_convlt.h:386-404): per-tap (u8 * u16) >> 16 floor, unsigned
accumulate, clip [0,255], vertical pass then horizontal pass with the u8
intermediate. The product kernel must match it bit-exactly.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from compv_tpu.ops.conv import (convolve_separable_q16, fixed_point_kernel,
                                gaussian_blur, gaussian_blur_q16,
                                gaussian_kernel1d)


def _oracle_pass(img: np.ndarray, kern: np.ndarray, axis: int) -> np.ndarray:
    taps = len(kern)
    r = taps // 2
    h, w = img.shape
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    p = np.pad(img.astype(np.uint32), pad)
    out = np.zeros((h, w), np.uint32)
    for y in range(h):
        for x in range(w):
            s = np.uint32(0)
            for t in range(taps):
                yy, xx = (y + t, x) if axis == 0 else (y, x + t)
                s += (p[yy, xx] * np.uint32(kern[t])) >> 16
            out[y, x] = min(s, 255)
    return out.astype(np.uint8)


def _oracle(img: np.ndarray, vt: np.ndarray, hz: np.ndarray) -> np.ndarray:
    return _oracle_pass(_oracle_pass(img, vt, 0), hz, 1)


class TestFixedPointKernel:
    def test_quantization(self):
        k = np.asarray(gaussian_kernel1d(5, 2.0))
        kq = fixed_point_kernel(k)
        assert kq.dtype == np.uint16
        np.testing.assert_array_equal(kq, (k.astype(np.float64)
                                           * 0xFFFF).astype(np.uint16))

    def test_negative_rejected(self):
        with pytest.raises(ValueError):
            fixed_point_kernel([-0.1, 1.1])


class TestQ16Parity:
    @pytest.mark.parametrize("size,sigma", [(3, 1.0), (5, 2.0), (7, 1.5)])
    def test_bit_exact_vs_scalar_oracle(self, size, sigma):
        rs = np.random.default_rng(3)
        img = rs.integers(0, 256, (37, 53), np.uint8)
        k = np.asarray(gaussian_kernel1d(size, sigma))
        kq = fixed_point_kernel(k)
        got = np.asarray(convolve_separable_q16(
            jnp.asarray(img), tuple(map(int, kq)), tuple(map(int, kq))))
        want = _oracle(img, kq, kq)
        np.testing.assert_array_equal(got, want)

    def test_close_to_float_blur(self):
        """The fixed-point path approximates the float blur: interior error
        bounded by the per-tap floor bias (up to `taps` counts per pass)."""
        rs = np.random.default_rng(4)
        img = rs.integers(0, 256, (64, 64), np.uint8)
        fq = np.asarray(gaussian_blur_q16(jnp.asarray(img), 5, 2.0),
                        np.int32)
        ff = np.asarray(gaussian_blur(jnp.asarray(img), 5, 2.0), np.int32)
        interior = (slice(3, -3), slice(3, -3))
        assert np.abs(fq[interior] - ff[interior]).max() <= 12

    def test_dtype_and_shape(self):
        img = jnp.zeros((16, 24), jnp.uint8)
        out = gaussian_blur_q16(img)
        assert out.shape == (16, 24) and out.dtype == jnp.uint8
