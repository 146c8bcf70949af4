"""Registry factories + SVM CV/multiclass tests."""
import jax.numpy as jnp
import numpy as np

import compv_tpu
from compv_tpu import ml


class TestRegistry:
    def test_create_detector(self, test_image):
        fn, cfg = compv_tpu.create_detector("fast", threshold=30)
        kp = fn(jnp.asarray(test_image), cfg)
        assert int(kp.count()) > 0
        assert cfg.threshold == 30

    def test_create_edge(self, test_image):
        fn, cfg = compv_tpu.create_edge_detector("canny")
        out = np.asarray(fn(jnp.asarray(test_image), cfg))
        assert set(np.unique(out)) <= {0, 255}

    def test_create_matcher(self):
        fn, cfg = compv_tpu.create_matcher("bruteforce")
        rs = np.random.default_rng(0)
        t = rs.integers(0, 2, (10, 256)).astype(np.uint8)
        m = fn(jnp.asarray(t), jnp.asarray(t), cfg)
        np.testing.assert_array_equal(np.asarray(m.train_idx[0]), np.arange(10))

    def test_unknown_raises(self):
        import pytest
        with pytest.raises(KeyError):
            compv_tpu.create_detector("sift")

    def test_list(self):
        algos = compv_tpu.list_algorithms()
        assert "fast" in algos["detectors"]


class TestSvmExtras:
    def test_cross_validation(self):
        rs = np.random.default_rng(1)
        x = np.concatenate([rs.normal(-2, 0.5, (40, 2)),
                            rs.normal(2, 0.5, (40, 2))]).astype(np.float32)
        y = np.concatenate([-np.ones(40), np.ones(40)]).astype(np.float32)
        acc = ml.svm_cross_validate(jnp.asarray(x), jnp.asarray(y),
                                    ml.SvmConfig(gamma=0.5, c=5.0), folds=4)
        assert acc > 0.9

    def test_multiclass(self):
        rs = np.random.default_rng(2)
        centers = np.array([[-3, 0], [3, 0], [0, 3]])
        x = np.concatenate([rs.normal(c, 0.4, (30, 2)) for c in centers]
                           ).astype(np.float32)
        y = np.repeat(np.arange(3), 30).astype(np.float32)
        mc = ml.svm_train_multiclass(jnp.asarray(x), jnp.asarray(y),
                                     ml.SvmConfig(gamma=0.5, c=5.0))
        pred = np.asarray(ml.svm_predict_multiclass(mc, jnp.asarray(x)))
        assert (pred == y).mean() > 0.95


class TestSvr:
    """eps-SVR vs the sklearn oracle."""

    def _data(self, n=120, seed=3):
        rs = np.random.default_rng(seed)
        x = rs.uniform(-2, 2, (n, 2)).astype(np.float32)
        y = (np.sin(x[:, 0]) + 0.5 * x[:, 1]).astype(np.float32)
        return x, y

    def test_matches_sklearn_rbf(self):
        from sklearn.svm import SVR
        from compv_tpu.ml.svm import SvmConfig, svr_predict, svr_train
        x, y = self._data()
        cfg = SvmConfig(kernel="rbf", gamma=0.5, c=2.0, iterations=4000)
        m = svr_train(jnp.asarray(x), jnp.asarray(y), cfg, epsilon=0.05)
        got = np.asarray(svr_predict(m, jnp.asarray(x)))
        ref = SVR(kernel="rbf", gamma=0.5, C=2.0, epsilon=0.05).fit(x, y)
        want = ref.predict(x)
        # both minimize the same dual; agree within the eps tube scale
        assert np.max(np.abs(got - want)) < 0.08, \
            np.max(np.abs(got - want))
        # and the fit is actually good
        assert np.mean(np.abs(got - y)) < 0.1

    def test_linear_kernel(self):
        from compv_tpu.ml.svm import SvmConfig, svr_predict, svr_train
        rs = np.random.default_rng(4)
        x = rs.uniform(-1, 1, (80, 3)).astype(np.float32)
        w = np.array([1.5, -2.0, 0.5], np.float32)
        y = x @ w + 0.25
        cfg = SvmConfig(kernel="linear", c=10.0, iterations=4000)
        m = svr_train(jnp.asarray(x), jnp.asarray(y), cfg, epsilon=0.01)
        got = np.asarray(svr_predict(m, jnp.asarray(x)))
        # fixed-iteration prox-PGD, not exact SMO (module docstring):
        # tube-scale agreement, tight in the mean
        assert np.max(np.abs(got - y)) < 0.15
        assert np.mean(np.abs(got - y)) < 0.05


class TestPlatt:
    def test_probability_calibration(self):
        """Platt probabilities vs sklearn's (libsvm-backed) SVC
        probability=True on a separable-with-overlap problem."""
        from sklearn.svm import SVC
        from compv_tpu.ml.svm import (SvmConfig, svm_predict_proba,
                                      svm_train_probabilistic)
        rs = np.random.default_rng(5)
        n = 150
        x = rs.normal(0, 1, (n, 2)).astype(np.float32)
        y = np.where(x[:, 0] + 0.5 * x[:, 1] + rs.normal(0, 0.4, n) > 0,
                     1.0, -1.0).astype(np.float32)
        cfg = SvmConfig(kernel="rbf", gamma=0.5, c=1.0, iterations=2000)
        pm = svm_train_probabilistic(jnp.asarray(x), jnp.asarray(y), cfg)
        p = np.asarray(svm_predict_proba(pm, jnp.asarray(x)))
        assert ((p >= 0) & (p <= 1)).all()
        ref = SVC(kernel="rbf", gamma=0.5, C=1.0, probability=True,
                  random_state=0).fit(x, y)
        want = ref.predict_proba(x)[:, list(ref.classes_).index(1.0)]
        # calibrations agree in the mean (Platt fits differ per CV split)
        assert np.mean(np.abs(p - want)) < 0.1
        # probabilities rank consistently with the labels
        assert p[y > 0].mean() > 0.6 > 0.4 > p[y < 0].mean()

    def test_platt_monotone(self):
        from compv_tpu.ml.svm import platt_fit, platt_probability
        rs = np.random.default_rng(6)
        f = rs.normal(0, 2, 200).astype(np.float32)
        y = np.where(f + rs.normal(0, 0.5, 200) > 0, 1.0, -1.0)
        a, b = platt_fit(jnp.asarray(f), jnp.asarray(y))
        p = np.asarray(platt_probability(a, b, jnp.asarray(np.sort(f))))
        assert (np.diff(p) >= -1e-6).all()      # monotone in f
        assert p[0] < 0.2 and p[-1] > 0.8


class TestLibsvmFormat:
    def test_roundtrip_c_svc(self, tmp_path):
        from compv_tpu.ml.svm import (SvmConfig, svm_decision,
                                      svm_load_libsvm, svm_save_libsvm,
                                      svm_train)
        rs = np.random.default_rng(7)
        x = rs.normal(0, 1, (60, 3)).astype(np.float32)
        y = np.where(x[:, 0] > 0, 1.0, -1.0).astype(np.float32)
        m = svm_train(jnp.asarray(x), jnp.asarray(y),
                      SvmConfig(gamma=0.3, iterations=1500))
        path = str(tmp_path / "model.libsvm")
        svm_save_libsvm(m, path)
        m2 = svm_load_libsvm(path)
        d1 = np.asarray(svm_decision(m, jnp.asarray(x)))
        d2 = np.asarray(svm_decision(m2, jnp.asarray(x)))
        np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)

    def test_reads_sklearn_dump(self, tmp_path):
        """A model written by libsvm itself (via sklearn's internals is
        not exposed) — emulate with a hand-written minimal file."""
        from compv_tpu.ml.svm import svm_decision, svm_load_libsvm
        path = str(tmp_path / "ref.libsvm")
        with open(path, "w") as f:
            f.write("svm_type c_svc\nkernel_type rbf\ngamma 0.5\n"
                    "nr_class 2\ntotal_sv 2\nrho -0.25\nlabel 1 -1\n"
                    "nr_sv 1 1\nSV\n"
                    "1 1:1.0 2:0.0\n-1 1:-1.0 2:0.5\n")
        m = svm_load_libsvm(path)
        d = np.asarray(svm_decision(m, jnp.asarray(
            np.array([[1.0, 0.0], [-1.0, 0.5]], np.float32))))
        # decision at the positive SV must exceed the negative one's
        assert d[0] > d[1]

    def test_roundtrip_svr(self, tmp_path):
        from compv_tpu.ml.svm import (SvmConfig, svm_load_libsvm,
                                      svm_save_libsvm, svr_predict,
                                      svr_train)
        rs = np.random.default_rng(8)
        x = rs.uniform(-1, 1, (50, 2)).astype(np.float32)
        y = (x[:, 0] * 2 - x[:, 1]).astype(np.float32)
        m = svr_train(jnp.asarray(x), jnp.asarray(y),
                      SvmConfig(kernel="linear", c=5.0, iterations=2000),
                      epsilon=0.02)
        path = str(tmp_path / "model_svr.libsvm")
        svm_save_libsvm(m, path, svm_type="epsilon_svr")
        m2 = svm_load_libsvm(path)
        np.testing.assert_allclose(
            np.asarray(svr_predict(m, jnp.asarray(x))),
            np.asarray(svr_predict(m2, jnp.asarray(x))),
            rtol=1e-5, atol=1e-5)
