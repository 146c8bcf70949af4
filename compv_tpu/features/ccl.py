"""Connected-component labeling + blob features.

Reference: CCL-LSL (core/ccl/compv_core_ccl_lsl.cxx:579 — Light Speed
Labeling: RLE segments + sequential equivalence solving, with lazily
computed features: boxes / moments / point extraction, lsl_result.cxx;
result API base/include/compv/base/compv_ccl.h:141-156).

Two staged solvers, cheapest first, both converging to the same fixed
point (labels = min flat index per component):

  1. Segmented run-min sweeps: per iteration, a 4-diagonal min then
     whole-run min along rows and columns via lax.cummin with a monotone
     per-run offset (earlier/later runs get offsets >= n so the min never
     leaks across background).
  2. Gather-based pointer jumping (label = labels[labels], log-depth) —
     converges on pathological inputs (long snakes) that defeat bounded
     local propagation; only entered when stage 1 reports non-convergence.

Features are fixed-capacity: the top-`max_components` components by area,
computed by per-component masked reductions in compact-id space.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["CclConfig", "CclResult", "label_components",
           "label_components_seeded", "ccl_features"]

_SWEEP_CAP = 12      # run-min sweep iterations before pointer jumping


@dataclass(frozen=True)
class CclConfig:
    connectivity: int = 8        # LSL uses 8-connectivity
    max_components: int = 256    # fixed feature capacity (top-C by area)
    max_iterations: int = 64     # pointer-jumping fallback rounds (log-depth)
    max_runs_per_row: int = 128  # run-record capacity of the fast feature
                                 # extractor; rows with more horizontal
                                 # foreground runs trigger the (slower,
                                 # unbounded) pixel-sort fallback


class CclResult(NamedTuple):
    labels: jax.Array       # (H, W) i32 — the label map (min flat index
                            # per component, -1 background); per-component
                            # rows below are indexed by the compact top-C
                            # order, with the root id recoverable as
                            # box_y0 * W + box_x0's pixel label
    num_components: jax.Array  # () i32
    area: jax.Array         # (C,) i32
    box_x0: jax.Array       # (C,) i32 bounding boxes
    box_y0: jax.Array
    box_x1: jax.Array       # inclusive
    box_y1: jax.Array
    cx: jax.Array           # (C,) f32 centroids (first-order moments / area)
    cy: jax.Array
    valid: jax.Array        # (C,) bool


# --------------------------------------------------------------- stage 1:
# segmented run-min sweeps

def _run_min(lbl, fg, axis, big):
    """Min over each maximal foreground run along `axis` — lax.cummin with
    direction-matched monotone per-run offsets so background blocks
    propagation. Requires n * (axis_len/2 + 2) < 2^31."""
    m = jnp.int32(lbl.shape[0] * lbl.shape[1])
    prev = jnp.pad(fg, [(1, 0) if a == axis else (0, 0) for a in range(2)])
    prev = jax.lax.slice_in_dim(prev, 0, fg.shape[axis], axis=axis)
    start = fg & ~prev.astype(bool)
    b = jnp.cumsum(start.astype(jnp.int32), axis=axis)
    rmax = fg.shape[axis] // 2 + 2
    offs_f = (rmax - b) * m
    offs_b = b * m
    # scan sentinel must exceed the largest offset-inflated key (lbl+offs
    # <= n*(axis/2+2), guarded < 2^30 by the caller) — the stage sentinel
    # `big` (= n) is smaller than inflated keys and would win the min.
    sent = jnp.int32(1 << 30)
    a1 = jax.lax.cummin(jnp.where(fg, lbl + offs_f, sent), axis=axis) - offs_f
    a2 = jax.lax.cummin(jnp.where(fg, lbl + offs_b, sent), axis=axis,
                        reverse=True) - offs_b
    return jnp.where(fg, jnp.minimum(a1, a2), big)


def _diag_min(lbl, fg, big):
    h, w = lbl.shape
    p = jnp.pad(lbl, 1, constant_values=1 << 30)
    mm = lbl
    for dy, dx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        mm = jnp.minimum(mm, jax.lax.dynamic_slice(p, (1 + dy, 1 + dx),
                                                   (h, w)))
    return jnp.where(fg, mm, big)


def _sweep_stage(lbl, fg, connectivity, big, cap):
    """Returns (labels, converged)."""

    def body(state):
        l, _, i = state
        new = _diag_min(l, fg, big) if connectivity == 8 else l
        new = _run_min(new, fg, 0, big)
        new = _run_min(new, fg, 1, big)
        return new, jnp.any(new != l), i + 1

    def cond(state):
        return state[1] & (state[2] < cap)

    lbl, changed, _ = jax.lax.while_loop(
        cond, body, (lbl, jnp.asarray(True), jnp.asarray(0)))
    return lbl, ~changed


# --------------------------------------------------------------- stage 2:
# pointer jumping (gathers; log-depth; guaranteed convergence)

def _neighbor_min(lbl, fg, connectivity, big):
    h, w = lbl.shape
    p = jnp.pad(lbl, 1, constant_values=1 << 30)
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    m = lbl
    for dy, dx in offs:
        m = jnp.minimum(m, jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w)))
    return jnp.where(fg, m, big)


def _pointer_stage(lbl, fg, connectivity, big, max_iterations):
    h, w = lbl.shape

    def body(state):
        l, _, i = state
        new = _neighbor_min(l, fg, connectivity, big)
        flat = new.ravel()
        safe = jnp.minimum(flat, big - 1)
        jumped = jnp.where(flat < big, flat[safe], big)
        jumped = jnp.where(jumped < big, flat[jnp.minimum(jumped, big - 1)],
                           jumped)
        new = jnp.minimum(new, jumped.reshape(h, w))
        new = jnp.where(fg, new, big)
        return new, jnp.any(new != l), i + 1

    def cond(state):
        return state[1] & (state[2] < max_iterations)

    lbl, _, _ = jax.lax.while_loop(
        cond, body, (lbl, jnp.asarray(True), jnp.asarray(0)))
    return lbl


def _propagate(lbl, fg, connectivity, big, max_iterations):
    """Run-min sweeps, then pointer jumping if they did not converge.
    ``lbl`` holds a seed label at foreground pixels and ``big`` elsewhere;
    returns the fixed point with -1 at background."""
    h, w = lbl.shape
    # the run-min offset trick needs n * (axis/2 + 2) in i32
    if h * w * (max(h, w) // 2 + 2) < 2 ** 30:
        lbl, converged = _sweep_stage(lbl, fg, connectivity, big, _SWEEP_CAP)
    else:
        converged = jnp.asarray(False)
    lbl = jax.lax.cond(
        converged, lambda l: l,
        lambda l: _pointer_stage(l, fg, connectivity, big, max_iterations),
        lbl)
    return jnp.where(fg, lbl, -1)


@partial(jax.jit, static_argnames=("connectivity", "max_iterations"))
def label_components(binary: jax.Array, connectivity: int = 8,
                     max_iterations: int = 64) -> jax.Array:
    """(H, W) u8/bool -> (H, W) i32 labels. Foreground pixels get the min
    flat-index of their component; background gets -1."""
    h, w = binary.shape
    fg = binary > 0
    big = jnp.int32(h * w)
    idx = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w
           + jax.lax.broadcasted_iota(jnp.int32, (h, w), 1))
    return _propagate(jnp.where(fg, idx, big), fg, connectivity, big,
                      max_iterations)


@partial(jax.jit, static_argnames=("connectivity", "max_iterations"))
def label_components_seeded(binary: jax.Array, init: jax.Array,
                            connectivity: int = 8,
                            max_iterations: int = 64) -> jax.Array:
    """label_components warm-started from `init` (i32, own flat index or a
    previous level's converged labels at foreground pixels; ignored at
    background). Used by MSER's incremental gray-level ladder — nested level
    sets mean most pixels keep their labels and only newly-merged regions
    re-flood (compv_core_ccl_lmser.cxx grows its component tree the same
    incremental way)."""
    h, w = binary.shape
    fg = binary > 0
    big = jnp.int32(h * w)
    return _propagate(jnp.where(fg, init, big), fg, connectivity, big,
                      max_iterations)


# --------------------------------------------------------------- features

@partial(jax.jit, static_argnames=("config",))
def ccl_features(binary: jax.Array, config: CclConfig = CclConfig()
                 ) -> CclResult:
    """Label + extract per-component features, top max_components by area
    (reference: boxes/moments computed from the labeling result,
    core/ccl/compv_core_ccl_lsl_result.cxx)."""
    lbl = label_components(binary, config.connectivity, config.max_iterations)
    return ccl_features_from_labels(lbl, config)



def _seg_stats_from_runs(label_key, x0, x1, y, w, h, c):
    """Per-component stats from R run records (label_key ascending-sorted
    with invalid = 2^30 at the end; x0/x1/y aligned). Returns the compact
    top-`c`-by-area CclResult fields (without the label map).

    All segmented reductions are cumsum/cummin passes with a monotone
    per-segment offset (segments = equal-label spans, ids from
    cumsum(is_first)); the exact same trick _run_min uses for row sweeps,
    and cheaper than a (value, key) pair associative_scan."""
    big = jnp.int32(1 << 30)
    r = label_key.shape[0]
    prev = jnp.pad(label_key, (1, 0), constant_values=-1)[:-1]
    is_first = (label_key != prev) & (label_key < big)
    vrun = label_key < big
    num = jnp.sum(is_first)
    segid = jnp.cumsum(is_first.astype(jnp.int32))          # 1-based, 0=pre

    length = jnp.where(vrun, x1 - x0 + 1, 0)

    # ---- segmented sums as prefix differences at segment boundaries.
    # Two-part hi/lo split keeps every cumsum int32-exact: per-record
    # values are < w^2 (sum-x) / h*w (sum-y); with shift s, the hi cumsum
    # is bounded by R * (vmax >> s) and the lo cumsum by R * 2^s. The
    # per-component result is returned as f32(hi)*2^s + f32(lo) with both
    # parts exact, so the only rounding is the final f32 render
    # (<= 2^-23 relative, no running-prefix drift).
    def psum(part):
        cs = jnp.cumsum(part)
        exc = jnp.pad(cs, (1, 0))[:-1]
        u = jnp.where(is_first, exc, jnp.int32(2 ** 31 - 1))
        nxt = jax.lax.cummin(u[::-1])[::-1]
        nxt = jnp.concatenate([nxt[1:], cs[-1:]])
        return jnp.minimum(nxt, cs[-1]) - exc                # at is_first

    def seg_sum_f32(v, vmax):
        s = 0
        while r * (vmax >> s) >= 2 ** 31 and s < 31:
            s += 1
        if r * (vmax >> s) >= 2 ** 31 or (s and (r << s) >= 2 ** 31):
            raise ValueError("run table too large for exact int32 sums")
        if s == 0:
            return psum(v).astype(jnp.float32)
        hi, lo = v >> s, v & ((1 << s) - 1)
        return (psum(hi).astype(jnp.float32) * float(1 << s)
                + psum(lo).astype(jnp.float32))

    area = psum(length)                  # i32-exact: R * w < 2^31 (caller)
    sumx = seg_sum_f32(jnp.where(vrun, (x0 + x1) * length // 2, 0), w * w)
    sumy = seg_sum_f32(jnp.where(vrun, y * length, 0), h * w)

    # ---- segmented min/max via suffix cummin + monotone segment offsets
    # (requires R * (max(w,h)+2) < 2^31 — checked by the caller)
    def seg_min(v, neutral, m):
        u = jnp.where(vrun, v, neutral) + segid * m
        suf = jax.lax.cummin(u[::-1])[::-1]
        return suf - segid * m                               # at is_first

    minx = seg_min(x0, jnp.int32(w), w + 1)
    maxx = -seg_min(-x1, jnp.int32(1), w + 2)
    maxy = -seg_min(-y, jnp.int32(1), h + 2)
    miny = label_key // w

    # ---- exact top-C by area: one small descending sort over R slots
    tkey = jnp.where(is_first, -area, big)
    slots = jnp.arange(r, dtype=jnp.int32)
    # (area, slot) keys: equal areas keep slot order on every backend
    tk_s, pos_s = jax.lax.sort([tkey, slots], num_keys=2)
    kk = min(c, r)
    valid = jnp.pad(tk_s[:kk] < 0, (0, c - kk))
    pos = jnp.pad(pos_s[:kk], (0, c - kk))

    def pick(arr, fill=0):
        return jnp.where(valid, arr[pos], fill)

    a = pick(area)
    m00 = jnp.maximum(a, 1).astype(jnp.float32)
    return (num.astype(jnp.int32), a, pick(minx), pick(miny), pick(maxx),
            pick(maxy), pick(sumx).astype(jnp.float32) / m00,
            pick(sumy).astype(jnp.float32) / m00, valid)


def extract_runs(lbl: jax.Array, k: int):
    """(H, W) i32 labels -> per-row run records ((H, K') label / x0 / x1,
    valid where label >= 0, K' = min(k, ceil(W/2))) + per-row run counts
    (H,). Rows with more than K' runs are truncated to their first K' —
    check counts > K' before trusting the records.

    The compaction primitive is a per-row sort over FOLDED column pairs:
    a run start needs bg on its left, so two adjacent columns can never
    both host one and min-combining pairs halves the sort width (ends
    fold symmetrically). Start keys pack (x << label_bits) | label into
    one u32 so the sort carries no extra value arrays; the k-th
    ascending end pairs with the k-th start, so ends sort as a
    bare i32 key. Falls back to (x-key, label-value) 2-array sorting
    when label+x exceed 32 bits (images over ~2 MP at 4k widths)."""
    h, w = lbl.shape
    n = h * w
    lb = max(1, (n - 1).bit_length())
    xb = max(1, w.bit_length())
    fg = lbl >= 0
    xi = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    start = fg & ~jnp.pad(fg, ((0, 0), (1, 0)))[:, :-1]
    end = fg & ~jnp.pad(fg, ((0, 0), (0, 1)))[:, 1:]
    counts = jnp.sum(start.astype(jnp.int32), axis=1)

    wp = -(-w // 2)

    def fold2(a, pad):
        ap = jnp.pad(a, ((0, 0), (0, 2 * wp - w)), constant_values=pad)
        return jnp.minimum(ap[:, 0::2], ap[:, 1::2])

    kk = min(k, wp)
    if lb + xb <= 32:
        sent = jnp.uint32(0xFFFFFFFF)
        key = jnp.where(start,
                        (xi.astype(jnp.uint32) << lb)
                        | lbl.astype(jnp.uint32), sent)
        ks = jax.lax.sort(fold2(key, sent), dimension=1,
                          is_stable=False)[:, :kk]
        run_lbl = jnp.where(ks != sent,
                            (ks & jnp.uint32((1 << lb) - 1)).astype(jnp.int32),
                            -1)
        run_x0 = jnp.where(ks != sent, (ks >> lb).astype(jnp.int32), w)
    else:
        keyx = jnp.where(start, xi, jnp.int32(w))
        # fold pairs while carrying the label: the start (if any) in a
        # column pair is the one with the smaller x key
        kp = jnp.pad(keyx, ((0, 0), (0, 2 * wp - w)), constant_values=w)
        lp = jnp.pad(lbl, ((0, 0), (0, 2 * wp - w)), constant_values=-1)
        left = kp[:, 0::2] <= kp[:, 1::2]
        kf = jnp.where(left, kp[:, 0::2], kp[:, 1::2])
        lf = jnp.where(left, lp[:, 0::2], lp[:, 1::2])
        ks, ls = jax.lax.sort([kf, lf], dimension=1, num_keys=1,
                              is_stable=False)
        run_x0 = ks[:, :kk]
        run_lbl = jnp.where(run_x0 < w, ls[:, :kk], -1)

    keye = jnp.where(end, xi, jnp.int32(w))
    run_x1 = jax.lax.sort(fold2(keye, jnp.int32(w)), dimension=1,
                          is_stable=False)[:, :kk]
    return run_lbl, run_x0, run_x1, counts


@partial(jax.jit, static_argnames=("config",))
def ccl_features_from_labels(lbl: jax.Array, config: CclConfig = CclConfig()
                             ) -> CclResult:
    """Feature extraction given a label map (the reference benchmarks box
    extraction separately from labeling, speed_compare:181-186; its
    extractor walks cached RLE runs, compv_core_ccl_lsl_result.cxx).

    r5 formulation — the reference's own design, vectorized: labels are
    constant along horizontal foreground runs, so per-RUN records
    (label, y, x0, x1) carry all box/area/centroid information. Runs are
    compacted per row by short folded sorts (extract_runs), grouped by
    label with ONE small R = H*K-record sort, and reduced with segmented
    cumsum/cummin passes (~45k records on the reference's text-scan
    benchmark vs the 1.3M pixels a pixel-sort formulation processes).
    Rows with more than config.max_runs_per_row runs divert to the pixel
    path (exact, capacity-free) under a lax.cond."""
    h, w = lbl.shape
    c = config.max_components
    kk = min(config.max_runs_per_row, -(-w // 2))
    r = h * kk
    runs_ok = (r * (max(w, h) + 2) < 2 ** 31)

    if not runs_ok:
        return _ccl_features_pixels(lbl, config)

    run_lbl, run_x0, run_x1, counts = extract_runs(lbl, kk)
    overflow = jnp.any(counts > kk)

    lb_bits = max(1, (h * w - 1).bit_length())
    x_bits = max(1, w.bit_length())

    def run_path(lb_):
        big = jnp.int32(1 << 30)
        if lb_bits + x_bits <= 32:
            # 2-array sort: u32 key (label << xb | x0) groups by label AND
            # orders runs by x0 within a segment; value packs (y, x1), and
            # y*(w+1)+x1 < h*(w+1)+w < 2^31 always (labels need h*w < 2^30)
            yy = jnp.broadcast_to(
                jnp.arange(h, dtype=jnp.int32)[:, None], run_lbl.shape)
            keyu = jnp.where(
                run_lbl >= 0,
                (run_lbl.astype(jnp.uint32) << x_bits)
                | run_x0.astype(jnp.uint32),
                jnp.uint32(0xFFFFFFFF))
            val = yy * (w + 1) + run_x1
            ku, vs = jax.lax.sort([keyu.ravel(), val.ravel()], num_keys=1,
                                  is_stable=False)
            sentinel = ku == jnp.uint32(0xFFFFFFFF)
            ks = jnp.where(sentinel, big, (ku >> x_bits).astype(jnp.int32))
            x0s = jnp.where(sentinel, w,
                            (ku & jnp.uint32((1 << x_bits) - 1))
                            .astype(jnp.int32))
            x1s, ys = vs % (w + 1), vs // (w + 1)
        else:
            yy = jnp.broadcast_to(
                jnp.arange(h, dtype=jnp.int32)[:, None],
                run_lbl.shape).ravel()
            key = jnp.where(run_lbl >= 0, run_lbl, big).ravel()
            x01 = (run_x0 * (w + 1) + run_x1).ravel()
            ks, x01s, ys = jax.lax.sort([key, x01, yy], num_keys=1,
                                        is_stable=False)
            x0s, x1s = x01s // (w + 1), x01s % (w + 1)
        num, area, minx, miny, maxx, maxy, cx, cy, valid = \
            _seg_stats_from_runs(ks, x0s, x1s, ys, w, h, c)
        return CclResult(lb_, num, area, minx, miny, maxx, maxy, cx, cy,
                         valid)

    def pixel_path(lb_):
        return _ccl_features_pixels(lb_, config)

    return jax.lax.cond(overflow, pixel_path, run_path, lbl)


def _ccl_features_pixels(lbl: jax.Array, config: CclConfig) -> CclResult:
    """Capacity-free pixel-sort extraction — the
    fallback when a row exceeds max_runs_per_row.

    ONE stable 1-key sort of [label, flat-index] plus cumsum/cummin
    passes and elementwise math; no scatters, data-dependent gathers, or
    lax.top_k anywhere.

    Per-component stats fall out of segment boundaries in sorted space:
    area/sum-x/sum-y as prefix-sum differences (int32-exact when
    n*max(w,h)/2 < 2^31, f32 otherwise), min/max-x via a segmented-min
    suffix scan keyed by the sorted labels, min-y free (label row), max-y
    from each segment's last slot (stable sort keeps raster order).
    Top-`max_components` by area: exact descending sort over slot space."""
    h, w = lbl.shape
    n = h * w
    c = config.max_components
    big = jnp.int32(1 << 30)
    flat = lbl.ravel()
    fidx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(flat >= 0, flat, big)

    # ---- the one sort: stable => raster (ascending fidx) within segments
    key_s, fidx_s = jax.lax.sort([key, fidx], num_keys=1, is_stable=True)
    prev = jnp.pad(key_s, (1, 0), constant_values=-1)[:-1]
    is_first = (key_s != prev) & (key_s < big)
    nxt_k = jnp.pad(key_s, (0, 1), constant_values=big + 1)[1:]
    is_last = (key_s != nxt_k) & (key_s < big)
    vmask = key_s < big
    num = jnp.sum(is_first)
    x = fidx_s % w
    y = fidx_s // w

    # ---- segmented sums via prefix differences at boundaries
    exact_i32 = n * (max(w, h) // 2 + 1) < 2 ** 31
    sdt = jnp.int32 if exact_i32 else jnp.float32
    sbig = jnp.asarray(2 ** 31 - 1 if exact_i32 else jnp.inf, sdt)
    csum_at = lambda cs: jnp.pad(cs, (1, 0))[:-1]

    def seg_sum(v):
        cs = jnp.cumsum(v.astype(sdt))
        exc = csum_at(cs)
        u = jnp.where(is_first, exc, sbig)
        nxt_f = jax.lax.cummin(u[::-1])[::-1]
        nxt_f = jnp.concatenate([nxt_f[1:], cs[-1:]])
        return jnp.minimum(nxt_f, cs[-1]) - exc          # valid at is_first

    area = seg_sum(vmask.astype(jnp.int32))
    sumx = seg_sum(jnp.where(vmask, x, 0))
    sumy = seg_sum(jnp.where(vmask, y, 0))

    # ---- segmented min/max-x via one suffix associative_scan each: the
    # classic segmented-scan operator ((va,ka)+(vb,kb) -> (ka==kb ?
    # op(va,vb) : va, ka)) is associative for contiguous segments, so at a
    # segment's first slot the suffix combine covers exactly that segment
    def seg_scan(vals, op, fill):
        def combine(a, b):
            # standard segmented-scan operator: the operand nearer the
            # segment start (b under reverse=True) keeps its key; the
            # accumulated suffix (a) only merges when keys match
            va, ka = a
            vb, kb = b
            return jnp.where(ka == kb, op(va, vb), vb), kb

        v0 = jnp.where(vmask, vals, fill)
        out, _ = jax.lax.associative_scan(combine, (v0, key_s), reverse=True)
        return out                                       # valid at is_first

    minx = seg_scan(x, jnp.minimum, jnp.int32(w))
    maxx = seg_scan(x, jnp.maximum, jnp.int32(-1))
    miny = key_s // w                                    # label row = min y
    # max-y: y at the segment's LAST slot (stable sort => max fidx there),
    # pulled back to the first slot with the same no-gather boundary trick
    lasty = jnp.cumsum(jnp.where(is_last, y + 1, 0))
    exly = csum_at(lasty)
    u = jnp.where(is_first, exly, jnp.int32(2 ** 31 - 1))
    nxt_l = jax.lax.cummin(u[::-1])[::-1]
    nxt_l = jnp.concatenate([nxt_l[1:], lasty[-1:]])
    maxy = jnp.minimum(nxt_l, lasty[-1]) - exly - 1      # valid at is_first

    # ---- top-C by area: exact sort over slot space, ties to the lower
    # slot (this is the rare fallback path; exactness beats speed here)
    area_slots = jnp.where(is_first, area, 0).astype(jnp.float32)
    tkey = jnp.where(is_first, -area_slots, jnp.float32(jnp.inf))
    slot_ids = jnp.arange(n, dtype=jnp.int32)
    neg_s, pos_s = jax.lax.sort([tkey, slot_ids], num_keys=2)
    kk = min(c, n)
    vals = jnp.pad(jnp.where(neg_s[:kk] < 0, -neg_s[:kk], 0.0), (0, c - kk))
    pos = jnp.pad(pos_s[:kk], (0, c - kk))
    comp_valid = vals > 0

    def pick(arr, fill=0):
        return jnp.where(comp_valid, arr[pos], fill)

    m00 = jnp.maximum(vals, 1.0)
    return CclResult(
        labels=lbl,
        num_components=num.astype(jnp.int32),
        area=jnp.where(comp_valid, vals.astype(jnp.int32), 0),
        box_x0=pick(minx),
        box_y0=pick(miny),
        box_x1=pick(maxx),
        box_y1=pick(maxy),
        cx=jnp.where(comp_valid, pick(sumx).astype(jnp.float32) / m00, 0.0),
        cy=jnp.where(comp_valid, pick(sumy).astype(jnp.float32) / m00, 0.0),
        valid=comp_valid,
    )
