"""Golden-value helpers for the test suite.

The reference proves kernel-variant agreement with golden scalars — corner
count / Σstrength / Σx / Σy tables (unittests/feature_fast.cxx:18-60) and MD5
of output buffers (tests/tests_common.cxx:98-116). Here the analogue is a
quantized checksum that is stable across compilers/backends at a stated
tolerance, plus exact integer checksums for integer outputs.
"""
from __future__ import annotations

import hashlib

import jax.numpy as jnp
import numpy as np


def keypoint_summary(kp) -> dict:
    """count / Σstrength / Σx / Σy of valid keypoints — the reference's FAST
    golden tuple (unittests/feature_fast.cxx:31-41)."""
    v = np.asarray(kp.valid)
    return {
        "count": int(v.sum()),
        "sum_strength": float(np.asarray(kp.strength)[v].sum()),
        "sum_x": float(np.asarray(kp.x)[v].sum()),
        "sum_y": float(np.asarray(kp.y)[v].sum()),
    }


def exact_hash(arr) -> str:
    """MD5 of the raw bytes of an integer array (reference: compv_tests_md5
    row-wise ignoring stride — we have no strides, so plain bytes)."""
    a = np.ascontiguousarray(np.asarray(arr))
    return hashlib.md5(a.tobytes()).hexdigest()


def quantized_hash(arr, decimals: int = 3) -> str:
    """Tolerance-hash for float outputs: round to ``decimals`` then MD5.
    Stable across backends as long as values agree to 10^-decimals."""
    a = np.asarray(arr, dtype=np.float64)
    q = np.round(a, decimals) + 0.0  # +0.0 normalizes -0.0
    return hashlib.md5(q.tobytes()).hexdigest()


def assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=rtol, atol=atol, err_msg=err_msg)


def ccl_summary(res) -> dict:
    """Component-features golden tuple. Capacity must cover every
    component (num_components <= valid.sum()) so the summary is
    tie-break-free."""
    v = np.asarray(res.valid)
    return {
        "num": int(res.num_components),
        "sum_area": int(np.asarray(res.area)[v].sum()),
        "sum_boxes": int((np.asarray(res.box_x0)[v] + np.asarray(res.box_y0)[v]
                          + np.asarray(res.box_x1)[v]
                          + np.asarray(res.box_y1)[v]).sum()),
        "sum_cx": round(float(np.asarray(res.cx)[v].sum()), 2),
        "sum_cy": round(float(np.asarray(res.cy)[v].sum()), 2),
    }


def lines_summary(lines) -> dict:
    """Hough golden tuple over the valid fixed-capacity peaks."""
    v = np.asarray(lines.valid)
    return {
        "count": int(v.sum()),
        "sum_rho": round(float(np.asarray(lines.rho)[v].sum()), 2),
        "sum_theta": round(float(np.asarray(lines.theta)[v].sum()), 4),
        "sum_strength": round(float(np.asarray(lines.strength)[v].sum()), 2),
    }


def mser_summary(res) -> dict:
    """MSER golden tuple over the valid regions (+ the overflow flag,
    which must be zero for a trustworthy golden)."""
    v = np.asarray(res.valid)
    return {
        "count": int(v.sum()),
        "sum_area": int(np.asarray(res.area)[v].sum()),
        "sum_level": int(np.asarray(res.level)[v].sum()),
        "sum_seed_x": int(np.asarray(res.seed_x)[v].sum()),
        "sum_seed_y": int(np.asarray(res.seed_y)[v].sum()),
        "overflowed": int(res.overflowed),
    }
