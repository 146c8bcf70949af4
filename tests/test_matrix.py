"""Systematic determinism matrix.

The reference re-runs every unittest across {asm} x {intrinsics} x
{fixed-point} x {threads} x {cpu-flags} (unittests/main.cxx:82-160). This
repository's translation of that variant sweep, applied to the LOCKED
golden values (goldens/goldens.json) rather than ad-hoc pairs:

  axis 1 — devices: replicated single-device vs row-sharded over the
           8-device virtual mesh. Sharding must not change a single bit
           of any golden (XLA inserts halos/collectives; results must be
           placement-invariant).
  axis 2 — kernel variant: there is one FAST kernel, the production XLA
           path; tests/test_fast.py checks it against the scalar oracle
           on the golden image for the FAST golden specs.
  axis 3 — precision: the bf16 matmul formulations that CLAIM exactness
           (Hamming-as-matmul, nibble-histogram) vs integer oracles.

Every golden key must be claimed by at least one axis (completeness
guard below) so new goldens cannot silently bypass the sweep.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from compv_tpu.core.golden import keypoint_summary, quantized_hash
from compv_tpu.native_rt import md5_mat
from tests.fixtures import make_test_image, make_test_rgb

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _goldens() -> dict:
    with open(os.path.join(_ROOT, "goldens", "goldens.json")) as f:
        return json.load(f)


GOLD = _goldens()


def _mesh8() -> Mesh:
    return Mesh(np.array(jax.devices()[:8]), ("d",))


def _row_sharded(x):
    """Place a host array row-sharded across the 8-device mesh."""
    mesh = _mesh8()
    spec = P("d") if x.ndim == 2 else P("d", None, None)
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


# ---- axis 1: sharded-vs-replicated over every image-op golden ----------

def _op_table():
    from compv_tpu.image.color import rgb_to_gray, rgb_to_hsv
    from compv_tpu.image.integral import integral
    from compv_tpu.image.morph import dilate, erode
    from compv_tpu.image.scale import scale_bilinear
    from compv_tpu.image.threshold import threshold_otsu

    def binary(gray):
        return threshold_otsu(gray)[0]

    return {
        "md5_to_gray": ("rgb", lambda x: rgb_to_gray(x)),
        "md5_rgb_to_hsv": ("rgb", lambda x: rgb_to_hsv(x)),
        "md5_scale_bilinear_299x401": ("gray",
                                       lambda x: scale_bilinear(x, 299, 401)),
        "md5_erode_3x3": ("binary", lambda x: erode(x)),
        "md5_dilate_3x3": ("binary", lambda x: dilate(x)),
        "md5_integral": ("gray", lambda x: integral(x, jnp.float64)),
    }


@pytest.fixture(scope="module")
def inputs():
    gray = make_test_image()
    rgb = make_test_rgb(gray)
    from compv_tpu.image.threshold import threshold_otsu
    binary = np.asarray(threshold_otsu(jnp.asarray(gray))[0])
    return {"gray": gray, "rgb": rgb, "binary": binary}


class TestShardedGoldens:
    """Row-sharded inputs across 8 devices must reproduce every locked
    image-op MD5 bit-exactly."""

    @pytest.mark.parametrize("key", sorted(_op_table()))
    def test_md5_sharded(self, inputs, key):
        src, fn = _op_table()[key]
        x = _row_sharded(inputs[src])
        out = np.asarray(jax.jit(fn)(x))
        if key == "md5_integral":
            out = out.astype(np.int64)
        assert md5_mat(out) == GOLD[key], f"{key} changed under sharding"

    def test_otsu_sharded(self, inputs):
        from compv_tpu.image.threshold import otsu_value
        x = _row_sharded(inputs["gray"])
        assert int(otsu_value(x)) == GOLD["otsu_value"]

    @pytest.mark.parametrize("spec", ["fast9_thr20_nms1", "fast12_thr40_nms1"])
    def test_fast_sharded(self, inputs, spec):
        from compv_tpu.features.fast import FastConfig, fast_detect
        n = int(spec[4: spec.index("_")])
        thr = int(spec.split("thr")[1].split("_")[0])
        nms = spec.endswith("nms1")
        x = _row_sharded(inputs["gray"])
        kp = fast_detect(x, FastConfig(threshold=thr, n=n, nms=nms,
                                       max_features=8192))
        assert keypoint_summary(kp) == GOLD[spec], \
            f"{spec} changed under sharding"


# ---- axis 3: bf16 matmul formulations vs integer oracles ---------------

class TestPrecisionExactness:
    def test_hamming_bf16_exact(self):
        """Hamming-as-matmul (|q|+|t|-2q.t in bf16) claims bit-exact integer
        distances for 256-bit descriptors; verify vs numpy popcount."""
        from compv_tpu.matchers.bruteforce import hamming_distance_matrix
        rs = np.random.default_rng(5)
        qb = rs.integers(0, 2, (64, 256), dtype=np.uint8)
        tb = rs.integers(0, 2, (96, 256), dtype=np.uint8)
        d = np.asarray(hamming_distance_matrix(jnp.asarray(qb),
                                               jnp.asarray(tb)))
        want = (qb[:, None, :] != tb[None, :, :]).sum(-1)
        np.testing.assert_array_equal(d.astype(np.int32), want)

    def test_histogram_bf16_exact(self, inputs):
        """Nibble-matmul histogram (bf16 one-hots) vs np.bincount on the
        golden image — the formulation underlying otsu_value's golden."""
        from compv_tpu.image.histogram import histogram256
        h = np.asarray(histogram256(jnp.asarray(inputs["gray"])))
        want = np.bincount(inputs["gray"].ravel(), minlength=256)
        np.testing.assert_array_equal(h.astype(np.int64), want)


# ---- axis 1 (cont.): the irregular kernels most likely to diverge under
# resharding — CCL labels/features, Hough SHT peaks, MSER region sets and
# one BA step. Integer-exact pipelines must reproduce
# their goldens bit-for-bit from row-sharded inputs; BA (f32 psum) must be
# bitwise reproducible at FIXED placement and within f32-reassociation
# tolerance across placements.

@pytest.mark.slow
class TestIrregularSharded:
    def test_ccl_sharded(self, inputs):
        from compv_tpu.core.golden import ccl_summary
        from compv_tpu.features.ccl import CclConfig, ccl_features
        x = _row_sharded(inputs["binary"])
        res = ccl_features(x, CclConfig(max_components=2048))
        assert ccl_summary(res) == GOLD["ccl_features_summary"], \
            "CCL features changed under sharding"

    def test_sht_sharded(self, inputs):
        from compv_tpu.core.golden import lines_summary
        from compv_tpu.features.canny import CannyConfig, canny
        from compv_tpu.features.hough import HoughShtConfig, hough_sht
        x = _row_sharded(inputs["gray"])
        lines = hough_sht(canny(x, CannyConfig()), HoughShtConfig())
        assert lines_summary(lines) == GOLD["hough_sht_summary"], \
            "SHT peaks changed under sharding"

    def test_mser_sharded(self, inputs):
        from compv_tpu.core.golden import mser_summary
        from compv_tpu.features.mser import MserConfig, mser_detect
        x = _row_sharded(inputs["gray"][:160, :224])
        res = mser_detect(x, MserConfig(max_regions=64))
        assert mser_summary(res) == GOLD["mser_summary"], \
            "MSER regions changed under sharding"

    def test_ba_step_sharded_and_reproducible(self):
        import sys
        sys.path.insert(0, os.path.join(_ROOT, "scripts"))
        from make_goldens import _ba_golden_problem
        from compv_tpu.core.golden import quantized_hash
        from compv_tpu.slam.ba import BAConfig, ba_step
        from compv_tpu.parallel.mesh import make_mesh
        from compv_tpu.parallel.sharded import make_distributed_ba_step

        prob = _ba_golden_problem()
        cfg = BAConfig(cg_iterations=8)
        p1, _, cost = ba_step(prob, jnp.float32(1e-3), cfg)
        assert round(float(cost), 1) == GOLD["ba_step_cost_before"]
        assert quantized_hash(np.asarray(p1.cameras), 3) == \
            GOLD["ba_step_cam_hash_q3"]

        mesh = make_mesh(8)
        sh = NamedSharding(mesh, P("frame"))
        rp = NamedSharding(mesh, P())
        pb = prob._replace(
            cameras=jax.device_put(prob.cameras, rp),
            landmarks=jax.device_put(prob.landmarks, rp),
            intrinsics=jax.device_put(prob.intrinsics, rp),
            cam_idx=jax.device_put(prob.cam_idx, sh),
            lm_idx=jax.device_put(prob.lm_idx, sh),
            uv=jax.device_put(prob.uv, sh),
            valid=jax.device_put(prob.valid, sh))
        step = make_distributed_ba_step(mesh, cfg)
        d1 = step(pb, jnp.float32(1e-3))
        d2 = step(pb, jnp.float32(1e-3))
        # fixed placement => bitwise deterministic
        np.testing.assert_array_equal(np.asarray(d1[0].cameras),
                                      np.asarray(d2[0].cameras))
        # across placements: identical up to f32 psum reassociation
        np.testing.assert_allclose(np.asarray(d1[0].cameras),
                                   np.asarray(p1.cameras),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(float(d1[2]), float(cost),
                                   rtol=1e-5)


# ---- completeness guard ------------------------------------------------

# homography goldens: RANSAC hypotheses are vmapped (placement-free); the
# estimation path is swept separately by test_homography + test_goldens.
_CLAIMED = set(_op_table()) | {
    "otsu_value", "fast9_thr20_nms1", "fast12_thr40_nms1",
    "fast9_thr20_nms0", "fast9_thr40_nms1",
    "homography_hash_q2", "homography_inliers",
    "ccl_features_summary", "hough_sht_summary", "mser_summary",
    "ba_step_cost_before", "ba_step_cam_hash_q3",
}


def test_every_golden_claimed():
    missing = set(GOLD) - _CLAIMED
    assert not missing, (
        f"new goldens not covered by the determinism matrix: {missing} — "
        "add them to an axis above")
