"""Hough line transforms: SHT (standard) and KHT-style kernel voting.

Reference:
  * SHT: core/features/hough/compv_core_feature_houghsht.cxx:96 — rho/theta
    accumulator built per-thread then merged (:350), 4-neighbor NMS (:483),
    sort by strength, toCartesian.
  * KHT: core/features/hough/compv_core_feature_houghkht.cxx:208 — edge
    chains -> clusters -> per-cluster elliptical-Gaussian kernel votes.

Design: the accumulator is one integer scatter-add of every (theta, rho)
vote; integer addition is associative, so the result is exact and
deterministic whatever order the device applies the votes in, and the
reference's per-thread clone + merge disappears. Edge pixels live in a
fixed-capacity padded list. The KHT variant keeps the
*voting model* (votes weighted by local line support) but replaces
sequential cluster linking with per-pixel orientation-coherence weights — a
dense reformulation (SURVEY.md §7 'hard parts').
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.core.types import Lines
from compv_tpu.ops.anglebin import angle_bin
from compv_tpu.ops.topk import select_top_k_2d

__all__ = ["HoughShtConfig", "hough_sht", "hough_sht_stats",
           "hough_lines_to_cartesian", "HoughKhtConfig", "hough_kht"]


@dataclass(frozen=True)
class HoughShtConfig:
    rho: float = 1.0            # rho resolution (COMPV_HOUGH_SET_FLT32_RHO)
    theta_step_deg: float = 1.0  # theta resolution
    threshold: float = 100       # min votes (COMPV_HOUGH_SET_INT_THRESHOLD);
                                 # values < 1.0 mean a fraction of the peak
                                 # accumulator value (scale-invariant mode)
    max_lines: int = 64          # fixed output capacity
    max_edge_points: int = 65536   # fixed edge-list capacity — covers ~7%
                                   # edge density at 720p (a dense Canny map
                                   # is 3-8%, the bench scene measures 2.7%).
                                   # Accumulation cost scales with CAPACITY
                                   # (static shapes), so the default tracks
                                   # the dense regime instead of 2x it.
                                   # If exceeded, the STRONGEST edges are
                                   # kept (never an arbitrary subset) and
                                   # hough_sht_stats reports truncation.


def _edge_list(edges: jax.Array, capacity: int,
               strengths: jax.Array | None = None):
    """All edge pixels if they fit in `capacity`, else the `capacity`
    strongest (ranked by `strengths` when given, e.g. gradient magnitude;
    binary maps rank by the map itself). Exact top-k: the reference
    accumulates every edge pixel (houghsht.cxx:350), so the extraction must
    never drop edges below capacity — approx_max_k could. Returns
    (x, y, valid)."""
    h, w = edges.shape
    k = min(capacity, h * w)
    rank = edges if strengths is None else jnp.where(edges > 0, strengths, 0)
    vals, idx = select_top_k_2d(rank, k, exact=True)
    valid = vals > 0
    return (idx % w).astype(jnp.float32), (idx // w).astype(jnp.float32), valid


def _fixed_point_shift(h: int, w: int, rho_max: float, rho_step: float
                       ) -> int:
    """Largest binary scale 2^s at which every step of the rho-bin sum
    x*cos + y*sin + rho_max + step/2 stays inside int32."""
    bound = (w - 1) + (h - 1) + rho_max + rho_step + 2
    return int(np.floor(np.log2((2 ** 31 - 1) / bound)))


def _trig_tables(n_theta: int, theta_step: float, shift: int):
    """(cos, sin) of every theta bin as int32 multiples of 2^-shift, built
    on the host so every backend bins with the same constants."""
    t = np.arange(n_theta, dtype=np.float64) * theta_step
    return (np.round(np.cos(t) * 2.0 ** shift).astype(np.int32),
            np.round(np.sin(t) * 2.0 ** shift).astype(np.int32))


def _rho_bin(xi, yi, cos_q, sin_q, rho_max: float, rho_step: float,
             shift: int, n_rho: int):
    """round((x cos + y sin + rho_max) / rho_step) for integer pixel
    coordinates, in exact int32 fixed point: the bin never depends on a
    backend's trig, fused multiply-add or rounding, so every device votes
    into the same bins (halves round up)."""
    step_q = int(round(rho_step * 2.0 ** shift))
    num = cos_q * xi + sin_q * yi + int(round(rho_max * 2.0 ** shift))
    return jnp.clip((num + step_q // 2) // step_q, 0, n_rho - 1)


def _rho_bins(x, y, n_theta: int, rho_max: float, rho_step: float,
              theta_step: float, shift: int):
    """(A, E) rho-bin index of every edge point at every theta."""
    cos_q, sin_q = _trig_tables(n_theta, theta_step, shift)
    n_rho = int(np.ceil(2 * rho_max / rho_step)) + 1
    rbin = _rho_bin(x.astype(jnp.int32)[None, :], y.astype(jnp.int32)[None, :],
                    jnp.asarray(cos_q)[:, None], jnp.asarray(sin_q)[:, None],
                    rho_max, rho_step, shift, n_rho)
    return rbin, n_rho


def _accumulate(x, y, valid, weights, n_theta: int, rho_max: float,
                rho_step: float, theta_step: float, shift: int):
    """(A, R) accumulator: for every edge point (integer pixel coordinates)
    and every theta bin, vote round((x cos + y sin + rho_max)/step),
    weighted by the integer ``weights``. One int32 scatter-add, exact in
    any vote order; the reference's per-thread clone + merge
    (houghsht.cxx:184-196) disappears."""
    rbin, n_rho = _rho_bins(x, y, n_theta, rho_max, rho_step, theta_step,
                            shift)
    w_row = (weights * valid).astype(jnp.int32)          # (E,)
    tbin = jnp.broadcast_to(
        jnp.arange(n_theta, dtype=jnp.int32)[:, None], rbin.shape)
    acc = jnp.zeros((n_theta, n_rho), jnp.int32).at[tbin, rbin].add(
        jnp.broadcast_to(w_row[None, :], rbin.shape))
    return acc.astype(jnp.float32), n_rho


def _acc_nms_topk(acc: jax.Array, threshold: float, max_lines: int,
                  rho_max: float, rho_step: float, theta_step: float) -> Lines:
    """4-neighbor NMS on the accumulator (houghsht.cxx:483) then top-K.

    Rather than lax.top_k over the full accumulator (a sort of every bin),
    take the top-2 NMS survivors per 64-bin rho segment
    (NMS peaks are >= 2 bins apart, so a segment holds at most ~21 peaks but
    nearly always <= 2 above threshold) and run the exact top-K on the ~16k
    candidates. A peak is only lost if 3+ above-threshold NMS survivors
    share one 64-bin segment AND the lost one belongs in the global top-K."""
    n_theta, n_rho = acc.shape
    p = jnp.pad(acc, 1)

    def sl(dy, dx):
        return jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (n_theta, n_rho))

    is_max = ((acc > sl(0, -1)) & (acc >= sl(0, 1))
              & (acc > sl(-1, 0)) & (acc >= sl(1, 0)))
    kept = jnp.where(is_max & (acc >= threshold), acc, 0.0)

    seg = 64
    nseg = -(-n_rho // seg)
    k3 = jnp.pad(kept, ((0, 0), (0, nseg * seg - n_rho))
                 ).reshape(n_theta, nseg, seg)
    a1 = jnp.argmax(k3, axis=-1)
    m1 = jnp.take_along_axis(k3, a1[..., None], axis=-1)[..., 0]
    iota = jax.lax.broadcasted_iota(jnp.int32, k3.shape, 2)
    k3b = jnp.where(iota == a1[..., None], -1.0, k3)
    a2 = jnp.argmax(k3b, axis=-1)
    m2 = jnp.take_along_axis(k3b, a2[..., None], axis=-1)[..., 0]

    cand_vals = jnp.stack([m1, m2], -1).ravel()        # (n_theta*nseg*2,)
    cand_rbin = (jax.lax.broadcasted_iota(
        jnp.int32, (n_theta, nseg, 2), 1) * seg
        + jnp.stack([a1, a2], -1).astype(jnp.int32)).ravel()
    cand_tbin = jax.lax.broadcasted_iota(
        jnp.int32, (n_theta, nseg, 2), 0).ravel()

    vals, idx = jax.lax.top_k(cand_vals, max_lines)
    valid = vals > 0
    tbin = cand_tbin[idx].astype(jnp.float32)
    rbin = cand_rbin[idx].astype(jnp.float32)
    return Lines(
        rho=jnp.where(valid, rbin * rho_step - rho_max, 0.0),
        theta=jnp.where(valid, tbin * theta_step, 0.0),
        strength=jnp.where(valid, vals, 0.0),
        valid=valid,
    )


@partial(jax.jit, static_argnames=("config", "shape"))
def _hough_sht_impl(edges, strengths, config: HoughShtConfig, shape):
    h, w = shape
    theta_step = float(np.deg2rad(config.theta_step_deg))
    n_theta = int(np.round(np.pi / theta_step))
    rho_max = float(np.hypot(h, w))
    x, y, valid = _edge_list(edges, config.max_edge_points, strengths)
    weights = jnp.ones_like(x)
    acc, _ = _accumulate(x, y, valid, weights, n_theta, rho_max,
                         config.rho, theta_step,
                         _fixed_point_shift(h, w, rho_max, config.rho))
    thr = (jnp.asarray(config.threshold, jnp.float32) if config.threshold >= 1.0
           else config.threshold * jnp.max(acc))
    lines = _acc_nms_topk(acc, thr, config.max_lines,
                          rho_max, config.rho, theta_step)
    n_edges = jnp.sum(edges > 0)
    return lines, n_edges


def hough_sht(edges: jax.Array, config: HoughShtConfig = HoughShtConfig(),
              strengths: jax.Array | None = None) -> Lines:
    """Standard Hough transform on a binary edge map (u8, nonzero=edge).
    Optional `strengths` (e.g. gradient magnitude) ranks edge retention if
    the map overflows config.max_edge_points."""
    return _hough_sht_impl(edges, strengths, config, edges.shape)[0]


def hough_sht_stats(edges: jax.Array,
                    config: HoughShtConfig = HoughShtConfig(),
                    strengths: jax.Array | None = None):
    """Like hough_sht but also returns accumulation stats so vote loss is
    never silent: dict(n_edges, capacity, truncated)."""
    lines, n_edges = _hough_sht_impl(edges, strengths, config, edges.shape)
    n = int(n_edges)
    return lines, {"n_edges": n, "capacity": config.max_edge_points,
                   "truncated": n > config.max_edge_points}


def hough_lines_to_cartesian(lines: Lines, width: int, height: int):
    """Polar (rho, theta) -> segment endpoints clipped to a long span, like
    the reference's toCartesian (houghsht.cxx). Returns (L, 4) [x0,y0,x1,y1]."""
    c = jnp.cos(lines.theta)
    s = jnp.sin(lines.theta)
    x0 = c * lines.rho
    y0 = s * lines.rho
    span = float(np.hypot(width, height))
    return jnp.stack([x0 - span * s, y0 + span * c,
                      x0 + span * s, y0 - span * c], axis=1)


# ---------------------------------------------------------------- KHT-style

@dataclass(frozen=True)
class HoughKhtConfig:
    rho: float = 1.0
    theta_step_deg: float = 0.5
    threshold_ratio: float = 0.25   # of the PEAK accumulator vote — the
                                    # reference KHT accepts lines relative
                                    # to the strongest (relative GS,
                                    # houghkht.cxx); total-mass-relative
                                    # thresholds collapse as scene line
                                    # count grows (votes split over more
                                    # peaks while total mass stays put)
    max_lines: int = 64
    min_votes: float = 30.0         # absolute significance floor — the
                                    # dense analogue of KHT's minimum chain
                                    # length: a real line needs this many
                                    # orientation-coherent supporters, so a
                                    # pure-noise peak can't clear it
    max_edge_points: int = 8192     # strongest-gradient retention: KHT votes
                                    # only from significant kernels, so a
                                    # tight budget of the sharpest edges is
                                    # the method's own pruning semantics


@partial(jax.jit, static_argnames=("config", "shape"))
def _hough_kht_impl(edges, gx, gy, config: HoughKhtConfig, shape):
    """Orientation-weighted voting: each edge pixel votes only near its own
    gradient-normal angle (+-1 bin), weighted by gradient coherence — the
    dense analogue of KHT's cluster-kernel voting (houghkht.cxx:208). This
    concentrates votes like KHT (few, sharp peaks) without sequential chain
    linking."""
    h, w = shape
    theta_step = float(np.deg2rad(config.theta_step_deg))
    n_theta = int(np.round(np.pi / theta_step))
    rho_max = float(np.hypot(h, w))
    n_rho = int(np.ceil(2 * rho_max / config.rho)) + 1

    # rank edge retention by gradient magnitude: if the map overflows
    # capacity, the strongest (most KHT-significant) edges survive — the
    # dense analogue of KHT's "significant kernels only" pruning
    # approx_max_k retention: KHT's "significant kernels only" pruning is
    # itself a heuristic, so an approximate ranking is acceptable here —
    # unlike SHT, where the oracle requires every edge accumulated.
    # +1 floor keeps edge pixels whose own gradient vanishes (the center of
    # a 1-px line is symmetric -> zero sobel response ON the pixel; its
    # orientation still comes from the structure tensor of the 3x3 hood)
    rank = jnp.where(edges > 0, 1.0 + gx * gx + gy * gy, 0.0)
    vk, ik = select_top_k_2d(rank, min(config.max_edge_points, h * w),
                             exact=False)
    x = (ik % w).astype(jnp.float32)
    y = (ik // w).astype(jnp.float32)
    valid = vk > 0
    xi = x.astype(jnp.int32)
    yi = y.astype(jnp.int32)
    # orientation tensor (structure tensor) is sign-invariant — the right
    # way to average gradient directions across an edge
    p_gx = jnp.pad(gx, 1)
    p_gy = jnp.pad(gy, 1)
    jxx = jnp.zeros_like(gx)
    jxy = jnp.zeros_like(gx)
    jyy = jnp.zeros_like(gx)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            gxs = jax.lax.dynamic_slice(p_gx, (1 + dy, 1 + dx), (h, w))
            gys = jax.lax.dynamic_slice(p_gy, (1 + dy, 1 + dx), (h, w))
            jxx = jxx + gxs * gxs
            jxy = jxy + gxs * gys
            jyy = jyy + gys * gys
    # dominant orientation of the structure tensor: angle of the major
    # eigenvector = 0.5 * atan2(2 Jxy, Jxx - Jyy), i.e. theta bin
    # round(atan2(2 Jxy, Jxx - Jyy) / (2 theta_step)) — settled exactly
    # (ops.anglebin) on the doubled-angle vector, scaled by a power of two
    # into int32 (exact for the integer tensors of u8 Sobel gradients)
    va = (jxx - jyy)[yi, xi]
    vb = (2.0 * jxy)[yi, xi]
    _, e = jnp.frexp(jnp.maximum(jnp.abs(va), jnp.abs(vb)))
    tcenter = angle_bin(jnp.round(jnp.ldexp(va, 30 - e)).astype(jnp.int32),
                        jnp.round(jnp.ldexp(vb, 30 - e)).astype(jnp.int32),
                        n_theta, centred=True)

    # KHT votes are sparse in theta (3 of n_theta bins per point): a
    # 3E-element scatter. The weights are multiples of 0.5, so the f32
    # sums are exact and independent of the order the votes land in.
    shift = _fixed_point_shift(h, w, rho_max, config.rho)
    cos_q, sin_q = (jnp.asarray(t) for t in
                    _trig_tables(n_theta, theta_step, shift))
    acc = jnp.zeros((n_theta, n_rho), jnp.float32)
    for dt in (-1, 0, 1):
        tb = (tcenter + dt) % n_theta
        rb = _rho_bin(xi, yi, cos_q[tb], sin_q[tb], rho_max, config.rho,
                      shift, n_rho)
        wgt = jnp.where(valid, jnp.where(dt == 0, 1.0, 0.5), 0.0)
        acc = acc.at[tb, rb].add(wgt)

    peak = jnp.maximum(jnp.max(acc), 1.0)
    thr = jnp.maximum(peak * config.threshold_ratio, config.min_votes)
    return _acc_nms_topk(acc, thr, config.max_lines, rho_max, config.rho,
                         theta_step)


def hough_kht(edges: jax.Array, gx: jax.Array, gy: jax.Array,
              config: HoughKhtConfig = HoughKhtConfig()) -> Lines:
    """KHT-style orientation-weighted Hough. Needs the gradients used to
    build ``edges`` (e.g. from features.edges.sobel_gradients)."""
    return _hough_kht_impl(edges, gx, gy, config, edges.shape)
