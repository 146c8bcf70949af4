"""Dense matrix operations facade.

Reference: CompVMatrix (base/math/compv_math_matrix.cxx, header
base/include/compv/base/math/compv_math_matrix.h:16-72): mulAB/mulABt/mulAtA,
Givens rotations mulAG/mulGA, transpose, rank, isSymmetric/isColinear,
eigen/SVD/pseudo-inverse (:963-990). These map to jnp.linalg /
lax.dot_general — the asm GEMM layer disappears into XLA.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from compv_tpu.precision import geometry

__all__ = ["mul_ab", "mul_abt", "mul_ata", "mul_ag", "mul_ga", "transpose",
           "rank", "is_symmetric", "is_colinear_2d", "eigen_symm", "svd",
           "pseudo_inverse", "inverse_3x3", "inverse_diagonal", "trace",
           "determinant"]


@geometry
def mul_ab(a, b):
    return jnp.matmul(a, b, preferred_element_type=jnp.float32)


@geometry
def mul_abt(a, b):
    """A @ B^T (reference mulABt — avoids materializing the transpose)."""
    return jax.lax.dot_general(a, b, (((a.ndim - 1,), (b.ndim - 1,)), ((), ())),
                               preferred_element_type=jnp.float32)


@geometry
def mul_ata(a):
    """A^T @ A (reference mulAtA, the DLT/normal-equations builder)."""
    return jax.lax.dot_general(a, a, (((0,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


def _givens(n, i, j, c, s, dtype):
    g = jnp.eye(n, dtype=dtype)
    g = g.at[i, i].set(c).at[j, j].set(c).at[i, j].set(s).at[j, i].set(-s)
    return g


def mul_ag(a, i: int, j: int, c, s):
    """Right-multiply by a Givens rotation (reference mulAG)."""
    g = _givens(a.shape[1], i, j, c, s, a.dtype)
    return a @ g


def mul_ga(a, i: int, j: int, c, s):
    """Left-multiply by a Givens rotation (reference mulGA)."""
    g = _givens(a.shape[0], i, j, c, s, a.dtype)
    return g @ a


def transpose(a):
    return a.T


def rank(a, tol: float = 1e-6):
    s = jnp.linalg.svd(a, compute_uv=False)
    return jnp.sum(s > tol * jnp.max(s))


def is_symmetric(a, tol: float = 1e-6):
    return jnp.all(jnp.abs(a - a.T) <= tol)


def is_colinear_2d(pts, tol: float = 1e-6):
    """True if (N, 2) points are colinear (reference isColinear used by the
    homography 4-point sample rejection, calib_homography.cxx)."""
    p0 = pts[0]
    d = pts[1:] - p0
    cross = d[:, 0][None, :] * d[:, 1][:, None] - d[:, 1][None, :] * d[:, 0][:, None]
    scale = jnp.max(jnp.abs(d)) + 1e-12
    return jnp.all(jnp.abs(cross) <= tol * scale * scale)


@geometry
def eigen_symm(s, sort: bool = True):
    """Eigen decomposition of a symmetric matrix (reference
    CompVMathEigen<T>::findSymm — Jacobi iteration, compv_math_eigen.cxx:29;
    here XLA-native eigh). Returns (values desc, vectors as columns)."""
    vals, vecs = jnp.linalg.eigh(s)
    if sort:  # eigh returns ascending; reference sorts descending
        vals = vals[::-1]
        vecs = vecs[:, ::-1]
    return vals, vecs


@geometry
def svd(a):
    """(reference CompVMatrix::svd via eigen of AtA; XLA-native here)."""
    return jnp.linalg.svd(a, full_matrices=False)


@geometry
def pseudo_inverse(a, tol: float = 1e-6):
    """Moore-Penrose (reference pseudoinv, compv_math_matrix.cxx:970)."""
    u, s, vt = jnp.linalg.svd(a, full_matrices=False)
    cutoff = tol * jnp.max(s)
    s_inv = jnp.where(s > cutoff, 1.0 / s, 0.0)
    return (vt.T * s_inv[None, :]) @ u.T


def inverse_3x3(a):
    """invA3x3 with pseudo-inverse fallback on singularity
    (compv_math_matrix.cxx:977)."""
    det = jnp.linalg.det(a)
    return jnp.where(jnp.abs(det) > 1e-12, jnp.linalg.inv(
        a + 1e-30 * jnp.eye(3, dtype=a.dtype)), pseudo_inverse(a))


def inverse_diagonal(d):
    """invD (reference diagonal inverse)."""
    diag = jnp.diagonal(d)
    inv = jnp.where(jnp.abs(diag) > 1e-12, 1.0 / diag, 0.0)
    return jnp.diag(inv)


def trace(a):
    return jnp.trace(a)


def determinant(a):
    return jnp.linalg.det(a)
