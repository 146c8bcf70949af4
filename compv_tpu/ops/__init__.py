"""Compute kernels in plain JAX/XLA.

This layer replaces the reference's entire SIMD backend (~60k LoC asm +
~25k LoC intrinsics, SURVEY.md §1 "SIMD backend layer"). Every op is a
pure-jnp implementation (analogous to the reference's portable *_C
kernels); a hand-written GPU kernel joins one only where a trace on the
card shows the XLA version far from its roofline.
"""
from compv_tpu.ops.conv import (  # noqa: F401
    gaussian_kernel1d, gaussian_kernel2d, convolve_separable, convolve2d,
    gaussian_blur,
)
from compv_tpu.ops.bitops import pack_bits_to_bytes, unpack_bytes_to_bits, popcount_bytes  # noqa: F401
