"""Multi-device matrix tests: sharded pipelines must equal local compute
(the {1-vs-N devices} axis of the determinism matrix, SURVEY.md §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu.parallel.mesh import make_mesh
from compv_tpu.parallel.sharded import sharded_all_pairs_match, sharded_detect


@pytest.fixture(scope="module")
def frames():
    rs = np.random.default_rng(0)
    from scipy import ndimage
    out = []
    for i in range(16):
        img = ndimage.gaussian_filter(
            rs.uniform(0, 255, (64, 96)).astype(np.float32), 1.2)
        img = ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)
        out.append(img)
    return np.stack(out)


@pytest.mark.slow
class TestShardedDetect:
    def test_matches_local(self, frames):
        mesh = make_mesh(8)
        x, y, s, valid, desc = sharded_detect(jnp.asarray(frames), mesh,
                                              max_features=64)
        # local reference: the same single-level ORB configuration
        # without the mesh (sharded_detect is a levels=1 configuration of
        # the product pipeline since r5)
        from compv_tpu.features.orb import OrbConfig, orb_detect_describe
        cfg = OrbConfig(max_features=64, threshold=20, levels=1,
                        subpixel=False)
        local = jax.vmap(
            lambda im: orb_detect_describe(im, cfg))(jnp.asarray(frames))
        np.testing.assert_array_equal(np.asarray(valid),
                                      np.asarray(local.keypoints.valid))
        np.testing.assert_allclose(np.asarray(x),
                                   np.asarray(local.keypoints.x))
        np.testing.assert_array_equal(np.asarray(desc),
                                      np.asarray(local.descriptors))

    def test_full_orb_matches_local(self, frames):
        """The multi-device frontend must be the REAL
        product pipeline (8-level pyramid ORB with budgets, sub-pixel and
        blur), asserted per-frame against the single-device path."""
        from compv_tpu.features.orb import OrbConfig, orb_detect_describe
        from compv_tpu.parallel.sharded import sharded_orb_detect
        mesh = make_mesh(8)
        cfg = OrbConfig(max_features=128)
        res = sharded_orb_detect(jnp.asarray(frames), mesh, cfg)
        local = jax.vmap(
            lambda im: orb_detect_describe(im, cfg))(jnp.asarray(frames))
        np.testing.assert_array_equal(np.asarray(res.keypoints.valid),
                                      np.asarray(local.keypoints.valid))
        np.testing.assert_allclose(np.asarray(res.keypoints.x),
                                   np.asarray(local.keypoints.x),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(np.asarray(res.keypoints.y),
                                   np.asarray(local.keypoints.y),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(np.asarray(res.keypoints.orientation),
                                   np.asarray(local.keypoints.orientation),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(np.asarray(res.descriptors),
                                      np.asarray(local.descriptors))

    def test_all_pairs_symmetric_diag_zero(self, frames):
        mesh = make_mesh(8)
        _, _, _, valid, desc = sharded_detect(jnp.asarray(frames), mesh,
                                              max_features=64)
        sim = np.asarray(sharded_all_pairs_match(desc, valid, mesh))
        assert sim.shape == (16, 16)
        # self-distance must be 0 (every descriptor matches itself)
        np.testing.assert_allclose(np.diag(sim), 0.0, atol=1e-5)
        # similar frames (identical) give symmetric-ish structure
        assert np.isfinite(sim).all()


class TestDistributedHelpers:
    def test_process_slice_single(self):
        from compv_tpu.parallel.distributed import process_frame_slice
        lo, hi = process_frame_slice(10)
        assert (lo, hi) == (0, 10)

    def test_global_mesh(self):
        from compv_tpu.parallel.distributed import global_frame_mesh
        m = global_frame_mesh()
        assert m.devices.size == len(jax.devices())


@pytest.mark.slow
class TestRingMatch:
    def test_ring_equals_all_gather(self, frames):
        """The ppermute ring exchange must produce the identical all-pairs
        similarity matrix as the all_gather formulation (SURVEY.md §5 ring
        descriptor exchange)."""
        from compv_tpu.parallel.sharded import ring_all_pairs_match
        mesh = make_mesh(8)
        _, _, _, valid, desc = sharded_detect(jnp.asarray(frames), mesh,
                                              max_features=64)
        ag = np.asarray(sharded_all_pairs_match(desc, valid, mesh))
        ring = np.asarray(ring_all_pairs_match(desc, valid, mesh))
        np.testing.assert_allclose(ring, ag, rtol=1e-6, atol=1e-6)
