"""Pose graph, trajectory eval, planar tracking, IO, viz tests."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu.slam.posegraph import (
    PoseGraph, PoseGraphConfig, compose, invert, optimize_pose_graph,
    relative_pose,
)
from compv_tpu.slam.evaluate import ate_rmse, rpe_rmse, umeyama_alignment


class TestSE3:
    def test_compose_invert(self):
        rs = np.random.default_rng(0)
        rv = jnp.asarray(rs.normal(0, 0.5, 3), jnp.float32)
        tv = jnp.asarray(rs.normal(0, 1, 3), jnp.float32)
        ri, ti = invert(rv, tv)
        rc, tc = compose(rv, tv, ri, ti)
        np.testing.assert_allclose(np.asarray(rc), 0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(tc), 0, atol=1e-5)

    def test_relative(self):
        rs = np.random.default_rng(1)
        a = jnp.asarray(rs.normal(0, 0.3, 6), jnp.float32)
        b = jnp.asarray(rs.normal(0, 0.3, 6), jnp.float32)
        rv, tv = relative_pose(a[:3], a[3:], b[:3], b[3:])
        # composing a with rel must give b
        rb, tb = compose(a[:3], a[3:], rv, tv)
        np.testing.assert_allclose(np.asarray(rb), np.asarray(b[:3]), atol=1e-4)
        np.testing.assert_allclose(np.asarray(tb), np.asarray(b[3:]), atol=1e-4)


class TestPoseGraph:
    def make_ring(self, n=8, noise=0.02, seed=2):
        """Ring of poses with noisy odometry edges + exact loop closure."""
        rs = np.random.default_rng(seed)
        true = np.zeros((n, 6), np.float32)
        for i in range(n):
            ang = 2 * np.pi * i / n
            true[i, :3] = [0, 0, ang]
            true[i, 3:] = [np.cos(ang), np.sin(ang), 0.0]
        ei, ej, meas, w = [], [], [], []
        for i in range(n):
            j = (i + 1) % n
            rv, tv = relative_pose(jnp.asarray(true[i, :3]), jnp.asarray(true[i, 3:]),
                                   jnp.asarray(true[j, :3]), jnp.asarray(true[j, 3:]))
            m = np.concatenate([np.asarray(rv), np.asarray(tv)])
            if j != 0:
                m = m + rs.normal(0, noise, 6)  # odometry noise
            ei.append(i)
            ej.append(j)
            meas.append(m)
            w.append(1.0 if j != 0 else 100.0)  # strong loop closure
        # realistic init: integrate the noisy odometry chain (drifts away
        # from truth; the loop-closure edge pulls it back)
        init = np.zeros_like(true)
        init[0] = true[0]
        for i in range(1, n):
            m = meas[i - 1]
            rv, tv = compose(jnp.asarray(init[i - 1, :3]),
                             jnp.asarray(init[i - 1, 3:]),
                             jnp.asarray(m[:3], jnp.float32),
                             jnp.asarray(m[3:], jnp.float32))
            init[i, :3] = np.asarray(rv)
            init[i, 3:] = np.asarray(tv)
        g = PoseGraph(
            poses=jnp.asarray(init),
            edge_i=jnp.asarray(ei, jnp.int32), edge_j=jnp.asarray(ej, jnp.int32),
            edge_meas=jnp.asarray(np.stack(meas), jnp.float32),
            edge_weight=jnp.asarray(w, jnp.float32),
            edge_valid=jnp.ones(len(ei), bool))
        return g, true

    def test_optimization_reduces_error(self):
        from compv_tpu.slam.posegraph import graph_residuals
        g, true = self.make_ring()
        g2, cost = optimize_pose_graph(g, PoseGraphConfig(iterations=25))
        # translation error vs truth must shrink (rvec wraps at 2pi so we
        # compare the observable part)
        terr0 = np.abs(np.asarray(g.poses)[:, 3:] - true[:, 3:]).mean()
        terr1 = np.abs(np.asarray(g2.poses)[:, 3:] - true[:, 3:]).mean()
        assert terr1 < 0.7 * terr0
        # cost must land near the cost at ground truth (measurement noise
        # floor), far below the drifted-init cost
        cost_true = float(jnp.sum(graph_residuals(jnp.asarray(true), g) ** 2))
        cost_init = float(jnp.sum(graph_residuals(g.poses, g) ** 2))
        # must reach (or beat) the quality of the ground-truth configuration
        assert float(cost) < cost_true * 1.5 + 1e-3
        assert float(cost) < 0.05 * cost_init


class TestEvaluate:
    def test_ate_zero_for_similarity(self):
        rs = np.random.default_rng(3)
        gt = rs.normal(0, 1, (50, 3)).astype(np.float32)
        # arbitrary similarity transform of gt
        from scipy.spatial.transform import Rotation
        r = Rotation.from_euler("xyz", [0.3, -0.2, 0.5]).as_matrix().astype(np.float32)
        est = 2.5 * gt @ r.T + np.array([3, -1, 2], np.float32)
        ate = float(ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert ate < 1e-3

    def test_ate_measures_noise(self):
        rs = np.random.default_rng(4)
        gt = rs.normal(0, 1, (100, 3)).astype(np.float32)
        est = gt + rs.normal(0, 0.1, gt.shape).astype(np.float32)
        ate = float(ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert 0.1 < ate < 0.3

    def test_rpe(self):
        gt = np.cumsum(np.ones((20, 3), np.float32), axis=0)
        est = gt.copy()
        est[10:] += 0.5  # single jump
        r = float(rpe_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert 0.1 < r < 0.5


class TestPlanarTracking:
    def test_translating_sequence(self):
        """Synthetic planar scene translating — recovered chain homography
        must match the cumulative shift (BASELINE config 3)."""
        from scipy import ndimage
        from compv_tpu.slam.pipeline import PlanarTrackerConfig, track_planar_sequence

        rs = np.random.default_rng(5)
        base = ndimage.gaussian_filter(
            rs.uniform(0, 255, (200, 280)).astype(np.float32), 1.5)
        base = ((base - base.min()) / np.ptp(base) * 255).astype(np.uint8)
        shifts = [0, 4, 8, 12, 16]
        frames = [np.roll(base, s, axis=1) for s in shifts]
        res = track_planar_sequence(frames, PlanarTrackerConfig())
        assert all(res.tracked)
        for h, s in zip(res.h_to_first, shifts):
            # frame0 -> frame_t should be x-translation by s
            assert abs(h[0, 2] - s) < 1.5
            assert abs(h[1, 2]) < 1.5


@pytest.mark.slow
class TestIOViz:
    def test_raw_roundtrip(self, tmp_path, test_image):
        from compv_tpu.io import read_raw, write_raw
        p = str(tmp_path / f"img_{test_image.shape[1]}x{test_image.shape[0]}_gray.yuv")
        write_raw(p, test_image)
        back = read_raw(p)
        np.testing.assert_array_equal(back, test_image)

    def test_png_roundtrip(self, tmp_path, test_rgb):
        from compv_tpu.io import read_image, write_image
        p = str(tmp_path / "img.png")
        write_image(p, test_rgb)
        back = read_image(p)
        np.testing.assert_array_equal(back, test_rgb)

    def test_video_raw_reader(self, tmp_path, test_image):
        from compv_tpu.io import RawYuvReader, VideoWriterRaw
        p = str(tmp_path / f"seq_{test_image.shape[1]}x{test_image.shape[0]}_gray.yuv")
        w = VideoWriterRaw(p)
        for i in range(5):
            w.write(np.roll(test_image, i, axis=1))
        w.close()
        r = RawYuvReader(p)
        frames = list(r)
        assert len(r) == 5 and len(frames) == 5
        np.testing.assert_array_equal(frames[0], test_image)

    def test_synthetic_camera(self):
        import time
        from compv_tpu.io import SyntheticCamera
        got = []
        cam = SyntheticCamera(64, 48, fps=100.0, n_frames=5)
        cam.set_callback(lambda f: got.append(f))
        cam.start()
        time.sleep(0.4)
        cam.stop()
        assert len(got) == 5
        assert got[0].shape == (48, 64)

    def test_mat_json(self, tmp_path):
        from compv_tpu.io import save_mat_json, load_mat_json
        rs = np.random.default_rng(6)
        a = rs.normal(0, 1, (4, 5)).astype(np.float32)
        p = str(tmp_path / "mats.json")
        save_mat_json(p, a=a)
        back = load_mat_json(p)["a"]
        np.testing.assert_allclose(back, a, atol=1e-6)

    def test_checkpoint_roundtrip(self, tmp_path):
        from compv_tpu.io import load_checkpoint, save_checkpoint
        tree = {"poses": jnp.arange(12.0).reshape(4, 3),
                "ids": jnp.asarray([1, 2, 3])}
        path = save_checkpoint(str(tmp_path / "ck"), 7, tree)
        like = {"poses": jnp.zeros((4, 3)), "ids": jnp.zeros(3, jnp.int32)}
        back = load_checkpoint(path, like)
        np.testing.assert_allclose(np.asarray(back["poses"]),
                                   np.arange(12.0).reshape(4, 3))

    def test_draw_functions(self, test_image):
        from compv_tpu.features.fast import FastConfig, fast_detect
        from compv_tpu.viz import draw_keypoints, draw_lines, to_rgb
        from compv_tpu.core.types import Lines
        kp = fast_detect(jnp.asarray(test_image), FastConfig(max_features=50))
        canvas = draw_keypoints(test_image, kp)
        assert canvas.shape == (*test_image.shape, 3)
        assert (canvas != to_rgb(test_image)).any()  # something was drawn
        lines = Lines(rho=jnp.asarray([50.0]), theta=jnp.asarray([0.5]),
                      strength=jnp.asarray([1.0]), valid=jnp.asarray([True]))
        canvas2 = draw_lines(test_image, lines)
        assert (canvas2 != to_rgb(test_image)).any()


class TestNativeWiring:
    """native_rt must be wired into product paths — the raw
    video reader streams through the C++ PrefetchLoader (+AlignedPool
    staging) and the image-sequence reader batch-decodes on the Executor."""

    def test_raw_reader_uses_prefetch_loader(self, tmp_path):
        frames = np.arange(4 * 6 * 8, dtype=np.uint8).reshape(4, 6, 8)
        p = tmp_path / "seq_8x6.yuv"
        p.write_bytes(frames.tobytes())
        from compv_tpu.io.video import RawYuvReader
        for reuse in (False, True):
            r = RawYuvReader(str(p), width=8, height=6, reuse_buffers=reuse)
            got = [f.copy() for f in r]
            assert len(got) == len(r) == 4
            np.testing.assert_array_equal(np.stack(got), frames)

    def test_image_sequence_batch_decode(self, tmp_path):
        from PIL import Image
        rs = np.random.default_rng(0)
        imgs = [rs.integers(0, 255, (12, 16), dtype=np.uint8)
                for _ in range(5)]
        for i, im in enumerate(imgs):
            Image.fromarray(im).save(tmp_path / f"f{i:03d}.png")
        from compv_tpu.io.video import ImageSequenceReader
        r = ImageSequenceReader(str(tmp_path))
        batch = r.read_batch()
        assert len(batch) == 5
        for a, b in zip(batch, imgs):
            np.testing.assert_array_equal(a, b)
