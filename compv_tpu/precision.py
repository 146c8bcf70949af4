"""The library's matmul precision policy, in one place.

f32 geometry — homographies, essential matrices, poses, BA Jacobians and
normal equations, calibration, PCA/KNN/SVM distances — runs every float32
product at full float32 precision. XLA's default lets a GPU run an f32
product in TF32 (10 mantissa bits), which at 1282-px coordinates is enough
to move RANSAC inlier decisions and Gauss-Newton steps. Products whose
operands are exact by construction keep their own dtypes and are not
touched by the policy: 0/1 bf16 one-hots and bits (Hamming distances,
histograms) with f32 accumulation, and int8 operands with int32
accumulation. Explicit ``precision=`` arguments also override it.

The policy is applied by decorating each public entry point of
``calib/``, ``slam/``, ``math/`` and ``ml/`` with :func:`geometry`; inside
a jitted function the decorator sits under ``jax.jit`` so the products
are traced at that precision.
"""
from __future__ import annotations

import functools

import jax

__all__ = ["GEOMETRY_PRECISION", "geometry"]

GEOMETRY_PRECISION = "highest"


def geometry(fn):
    """Run (or trace) ``fn`` with f32 products at GEOMETRY_PRECISION."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(GEOMETRY_PRECISION):
            return fn(*args, **kwargs)

    return wrapped
