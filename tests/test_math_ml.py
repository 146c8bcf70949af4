"""Math breadth + ML layer tests."""
import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu import math as cmath
from compv_tpu import ml


class TestMatrix:
    def test_mul_variants(self):
        rs = np.random.default_rng(0)
        a = jnp.asarray(rs.normal(0, 1, (7, 5)), jnp.float32)
        b = jnp.asarray(rs.normal(0, 1, (5, 3)), jnp.float32)
        np.testing.assert_allclose(np.asarray(cmath.mul_ab(a, b)),
                                   np.asarray(a) @ np.asarray(b), atol=1e-4)
        np.testing.assert_allclose(np.asarray(cmath.mul_abt(a, b.T)),
                                   np.asarray(a) @ np.asarray(b), atol=1e-4)
        np.testing.assert_allclose(np.asarray(cmath.mul_ata(a)),
                                   np.asarray(a).T @ np.asarray(a), atol=1e-4)

    def test_givens(self):
        a = jnp.eye(3, dtype=jnp.float32)
        c, s = np.cos(0.3), np.sin(0.3)
        g = np.asarray(cmath.mul_ag(a, 0, 1, c, s))
        assert abs(g[0, 0] - c) < 1e-6 and abs(g[1, 0] + s) < 1e-6

    def test_rank_and_pinv(self):
        a = jnp.asarray([[1.0, 2.0], [2.0, 4.0], [1.0, 0.0]], jnp.float32)
        assert int(cmath.rank(a)) == 2
        lowrank = jnp.asarray([[1.0, 2.0], [2.0, 4.0]], jnp.float32)
        assert int(cmath.rank(lowrank)) == 1
        p = np.asarray(cmath.pseudo_inverse(a))
        np.testing.assert_allclose(p @ np.asarray(a), np.eye(2), atol=1e-4)

    def test_eigen_symm_descending(self):
        rs = np.random.default_rng(1)
        m = rs.normal(0, 1, (5, 5))
        s = jnp.asarray(m + m.T, jnp.float32)
        vals, vecs = cmath.eigen_symm(s)
        v = np.asarray(vals)
        assert (np.diff(v) <= 1e-5).all()
        # eigenvector property
        r = np.asarray(s) @ np.asarray(vecs)[:, 0] - v[0] * np.asarray(vecs)[:, 0]
        assert np.abs(r).max() < 1e-3

    def test_colinear(self):
        line = jnp.asarray([[0.0, 0], [1, 1], [2, 2], [5, 5]], jnp.float32)
        tri = jnp.asarray([[0.0, 0], [1, 0], [0, 1], [1, 1]], jnp.float32)
        assert bool(cmath.is_colinear_2d(line))
        assert not bool(cmath.is_colinear_2d(tri))

    def test_inverse_3x3(self):
        a = jnp.asarray([[2.0, 0, 1], [0, 3, 0], [1, 0, 1]], jnp.float32)
        inv = np.asarray(cmath.inverse_3x3(a))
        np.testing.assert_allclose(inv @ np.asarray(a), np.eye(3), atol=1e-5)


class TestDistanceFit:
    def test_hamming_packed(self):
        rs = np.random.default_rng(2)
        data = rs.integers(0, 256, (10, 32), dtype=np.uint8)
        patch = rs.integers(0, 256, 32, dtype=np.uint8)
        got = np.asarray(cmath.hamming_packed(jnp.asarray(data), jnp.asarray(patch)))
        want = [bin(int.from_bytes((d ^ patch).tobytes(), "little")).count("1")
                for d in data]
        np.testing.assert_array_equal(got, want)

    def test_fit_line_robust(self):
        rs = np.random.default_rng(3)
        x = rs.uniform(0, 100, 150)
        y = -0.5 * x + 20 + rs.normal(0, 0.2, 150)
        y[:40] = rs.uniform(-50, 100, 40)
        res = cmath.fit_line(jnp.asarray(np.stack([x, y], 1), jnp.float32),
                             threshold=1.0)
        a, b, c = np.asarray(res.abc)
        slope = -a / b
        assert abs(slope - (-0.5)) < 0.03
        assert int(res.num_inliers) > 100

    def test_fit_parabola(self):
        rs = np.random.default_rng(4)
        x = rs.uniform(-10, 10, 200)
        y = 0.3 * x ** 2 - 2 * x + 5 + rs.normal(0, 0.1, 200)
        y[:50] = rs.uniform(0, 60, 50)
        res = cmath.fit_parabola(jnp.asarray(np.stack([x, y], 1), jnp.float32),
                                 threshold=0.8)
        a, b, c = np.asarray(res.abc)
        assert abs(a - 0.3) < 0.03
        assert abs(b + 2) < 0.2

    def test_squared_l2(self):
        rs = np.random.default_rng(5)
        a = rs.normal(0, 1, (6, 4)).astype(np.float32)
        b = rs.normal(0, 1, (5, 4)).astype(np.float32)
        got = np.asarray(cmath.squared_l2(jnp.asarray(a), jnp.asarray(b)))
        want = ((a[:, None] - b[None]) ** 2).sum(-1)
        np.testing.assert_allclose(got, want, atol=1e-4)


class TestPca:
    def test_reconstruct(self, tmp_path):
        rs = np.random.default_rng(6)
        basis = rs.normal(0, 1, (2, 8))
        data = rs.normal(0, 1, (300, 2)) @ basis + rs.normal(0, 0.01, (300, 8))
        model = cmath.pca_compute(jnp.asarray(data, jnp.float32), 2)
        proj = cmath.pca_project(model, jnp.asarray(data, jnp.float32))
        back = np.asarray(cmath.pca_backproject(model, proj))
        assert np.abs(back - data).max() < 0.1
        # JSON roundtrip
        path = str(tmp_path / "pca.json")
        cmath.pca_save_json(model, path)
        m2 = cmath.pca_load_json(path)
        np.testing.assert_allclose(np.asarray(m2.mean), np.asarray(model.mean),
                                   atol=1e-6)


class TestOps:
    def test_cast_saturates(self):
        a = jnp.asarray([300.0, -5.0, 128.7])
        out = np.asarray(cmath.cast(a, jnp.uint8))
        np.testing.assert_array_equal(out, [255, 0, 129])

    def test_moments(self):
        img = np.zeros((10, 10), np.uint8)
        img[2:4, 6:8] = 1
        m = cmath.image_moments(jnp.asarray(img), 1)
        assert float(m["m00"]) == 4
        assert float(m["m10"]) / float(m["m00"]) == 6.5  # centroid x
        assert float(m["m01"]) / float(m["m00"]) == 2.5

    def test_hu_rotation_invariance(self):
        from scipy import ndimage
        rs = np.random.default_rng(7)
        img = np.zeros((64, 64), np.float32)
        img[20:40, 25:45] = 1.0
        img[25:30, 30:42] = 0.0
        rot = ndimage.rotate(img, 35, reshape=False, order=1)
        h1 = np.asarray(cmath.hu_moments(jnp.asarray(img)))
        h2 = np.asarray(cmath.hu_moments(jnp.asarray(rot)))
        np.testing.assert_allclose(h1[0], h2[0], rtol=0.05)
        # h2 is near zero for this near-symmetric shape: absolute tolerance
        np.testing.assert_allclose(h1[1], h2[1], atol=5e-6)

    def test_atan2_deg(self):
        # polynomial approximation (reference fastAtan2 coefficients):
        # bounded error vs the transcendental, not bit-equality
        d = float(cmath.fast_atan2_deg(jnp.asarray(1.0), jnp.asarray(1.0)))
        assert abs(d - 45) < 0.05
        d = float(cmath.fast_atan2_deg(jnp.asarray(-1.0), jnp.asarray(0.0)))
        assert abs(d - 270) < 0.05

    def test_fast_atan2_error_bound(self):
        rs = np.random.default_rng(0)
        y = rs.normal(0, 3, 5000).astype(np.float32)
        x = rs.normal(0, 3, 5000).astype(np.float32)
        fa = np.asarray(cmath.fast_atan2_deg(jnp.asarray(y), jnp.asarray(x)))
        ex = np.asarray(cmath.atan2_deg_exact(jnp.asarray(y), jnp.asarray(x)))
        d = np.abs(fa - ex)
        d = np.minimum(d, 360 - d)      # wrap at 0/360
        assert d.max() < 0.02

    def test_saturating_int_ops(self):
        a = jnp.asarray([250, 10, 128], jnp.uint8)
        b = jnp.asarray([10, 20, 2], jnp.uint8)
        np.testing.assert_array_equal(np.asarray(cmath.add(a, b)),
                                      [255, 30, 130])
        np.testing.assert_array_equal(np.asarray(cmath.sub(a, b)),
                                      [240, 0, 126])
        np.testing.assert_array_equal(
            np.asarray(cmath.mul_elementwise(a, b)), [255, 200, 255])
        # floats stay exact
        assert float(cmath.add(jnp.float32(1.5), jnp.float32(2.25))) == 3.75

    def test_saturating_16bit_ops(self):
        # uint16*uint16 must saturate to 65535, not wrap through
        # an int32 accumulator to 0
        a = jnp.asarray([60000, 40000, 3], jnp.uint16)
        b = jnp.asarray([60000, 40000, 4], jnp.uint16)
        np.testing.assert_array_equal(
            np.asarray(cmath.mul_elementwise(a, b)), [65535, 65535, 12])
        np.testing.assert_array_equal(np.asarray(cmath.add(a, b)),
                                      [65535, 65535, 7])
        np.testing.assert_array_equal(
            np.asarray(cmath.sub(jnp.asarray([5, 40000], jnp.uint16),
                                 jnp.asarray([9, 1], jnp.uint16))),
            [0, 39999])
        s = jnp.asarray([30000, -30000, 180], jnp.int16)
        np.testing.assert_array_equal(
            np.asarray(cmath.mul_elementwise(s, s)), [32767, 32767, 32400])
        np.testing.assert_array_equal(np.asarray(cmath.add(s, s)),
                                      [32767, -32768, 360])

    def test_int32_ops_wrap_like_reference(self):
        # 32-bit ints take the wrapping path (matching the reference's
        # plain C fallback; no 64-bit accumulator without x64)
        a = jnp.asarray([2 ** 31 - 1, 7], jnp.int32)
        out = np.asarray(cmath.add(a, jnp.asarray([1, 1], jnp.int32)))
        assert out[0] == np.int32(-2 ** 31) and out[1] == 8


class TestSvm:
    def test_separable(self):
        rs = np.random.default_rng(8)
        x0 = rs.normal(-2, 0.5, (60, 2))
        x1 = rs.normal(2, 0.5, (60, 2))
        x = np.concatenate([x0, x1]).astype(np.float32)
        y = np.concatenate([-np.ones(60), np.ones(60)]).astype(np.float32)
        model = ml.svm_train(jnp.asarray(x), jnp.asarray(y),
                             ml.SvmConfig(kernel="rbf", gamma=0.5, c=10.0))
        pred = np.asarray(ml.svm_predict(model, jnp.asarray(x)))
        assert (pred == y).mean() > 0.97

    def test_nonlinear_xor(self):
        rs = np.random.default_rng(9)
        x = rs.uniform(-1, 1, (200, 2)).astype(np.float32)
        y = np.where(x[:, 0] * x[:, 1] > 0, 1.0, -1.0).astype(np.float32)
        model = ml.svm_train(jnp.asarray(x), jnp.asarray(y),
                             ml.SvmConfig(kernel="rbf", gamma=4.0, c=10.0,
                                          iterations=500))
        pred = np.asarray(ml.svm_predict(model, jnp.asarray(x)))
        assert (pred == y).mean() > 0.9

    def test_json_roundtrip(self, tmp_path):
        rs = np.random.default_rng(10)
        x = rs.normal(0, 1, (40, 3)).astype(np.float32)
        y = np.sign(x[:, 0]).astype(np.float32)
        model = ml.svm_train(jnp.asarray(x), jnp.asarray(y))
        path = str(tmp_path / "svm.json")
        ml.svm_save_json(model, path)
        m2 = ml.svm_load_json(path)
        d1 = np.asarray(ml.svm_decision(model, jnp.asarray(x)))
        d2 = np.asarray(ml.svm_decision(m2, jnp.asarray(x)))
        np.testing.assert_allclose(d1, d2, atol=1e-5)


class TestKnn:
    def test_exact_search(self):
        rs = np.random.default_rng(11)
        data = rs.normal(0, 1, (500, 16)).astype(np.float32)
        idx = ml.knn_build(jnp.asarray(data))
        q = data[42:45]
        ids, dists = ml.knn_search(idx, jnp.asarray(q), 3)
        assert (np.asarray(ids)[:, 0] == [42, 43, 44]).all()
        np.testing.assert_allclose(np.asarray(dists)[:, 0], 0, atol=1e-4)

    def test_angular(self):
        rs = np.random.default_rng(12)
        data = rs.normal(0, 1, (100, 8)).astype(np.float32)
        idx = ml.knn_build(jnp.asarray(data), norm="angular")
        ids, dists = ml.knn_search(idx, jnp.asarray(data[7:8] * 5.0), 1)
        assert int(ids[0, 0]) == 7  # scale-invariant

    def test_ann_recall(self):
        rs = np.random.default_rng(13)
        data = rs.normal(0, 1, (2000, 32)).astype(np.float32)
        queries = data[rs.choice(2000, 50, replace=False)]
        exact = ml.knn_build(jnp.asarray(data))
        e_ids, _ = ml.knn_search(exact, jnp.asarray(queries), 1)
        ann = ml.ann_build(jnp.asarray(data))
        a_ids, _ = ml.ann_search(ann, jnp.asarray(queries), 1)
        recall = (np.asarray(e_ids)[:, 0] == np.asarray(a_ids)[:, 0]).mean()
        assert recall > 0.9  # self-queries: hash bucket contains the point
