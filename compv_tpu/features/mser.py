"""MSER — maximally stable extremal regions, data-parallel reformulation.

Reference: LMSER (core/ccl/compv_core_ccl_lmser.cxx:148 — Nistér-Stewénius
linear-time flood-fill component tree with boundary heaps; stability math in
core/include/compv/core/ccl/compv_core_ccl_lmser_result.h:155-199; defaults
delta=5 / min_area=0.0002 / max_area=0.5 / max_variation=0.5 /
min_diversity=0.5, base/include/compv/base/compv_ccl.h:23-27; per-region
point extraction compv_ccl.h:141-156 / lmser_result.h:122-152).

The flood-fill component tree is intrinsically sequential (SURVEY.md §7
'hard parts'). Design — an incremental gray-level ladder:

  phase 1 (lax.scan over levels): the level sets {I <= t} are nested, so
    level t's converged labels SEED level t+step (label_components_seeded);
    only newly-merged regions re-flood. Levels whose foreground did not
    change are skipped entirely (lax.cond) — the cost is content-adaptive,
    like the reference's tree walk. Per level, exact component areas come
    from RUN records (labels are constant along horizontal foreground
    runs): compaction by two short folded per-row sorts
    (features/ccl.py extract_runs), then one u32-packed
    (label << len_bits | len) R-record sort + a segmented prefix-sum.

  phase 2 (batched small-table math): the reference's stability rules on
    the sampled tree:
      variation(r at t) = (area(comp containing seed at t+delta)
                           - area(r)) / area(r)     [lmser_result.h:155-161]
      stable iff local min of variation vs the parent (next level up through
      the seed) and the child (next level down), variation <= max_variation,
      min_area <= area <= max_area        [lmser_result.h:166-183]
      min-diversity: among NESTED stable regions with relative area
      difference < min_diversity only the most stable survives
      [lmser_result.h:91-113]
    Cross-level lookups go through per-level SORTED (root -> area/variation)
    tables (<= max_candidates entries per level) resolved by batched
    sort-merge joins (_lookup_sorted) — no scatters anywhere.

Bounded deviations from the exact tree (both flagged in `overflowed` where
they can silently bite): the ladder samples `level_step` gray levels, and
components smaller than min_area have no variation table entry, so a
below-min-area CHILD cannot veto its parent's local-min test (the reference
compares against every ER node). tests/test_ccl_mser_hog.py bounds the
end-to-end divergence against a full-resolution sequential oracle.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.features.ccl import label_components_seeded

__all__ = ["MserConfig", "MserResult", "mser_detect", "mser_region_mask",
           "mser_region_points"]

_BIG = 1 << 30


@dataclass(frozen=True)
class MserConfig:
    """Parameter names and defaults follow the reference's LMSER caps ids
    (COMPV_CCL_SET_INT_MSER_DELTA etc.) and default constants
    (base/include/compv/base/compv_ccl.h:23-27)."""
    delta: int = 5               # stability step in GRAY LEVELS
    min_area: float = 0.0002     # fraction of image area
    max_area: float = 0.5
    max_variation: float = 0.5
    min_diversity: float = 0.5
    dark: bool = True            # detect dark-on-bright (I <= t)
    level_step: int = 5          # gray-level quantization of the ladder;
                                 # 5 == delta makes t+delta land exactly on
                                 # the next level (no extra labelings)
    max_regions: int = 128       # fixed output capacity
    max_candidates: int = 1024   # per-level capacity for components with
                                 # area >= min_area (text scans measure a
                                 # few hundred); overflow sets `overflowed`
    run_tiers: tuple = (112, 320)  # per-row run-record capacities of the
                                 # per-level area extraction; each level
                                 # dispatches (lax.cond) to the smallest
                                 # tier covering its max runs/row, and a
                                 # final ceil(W/2) tier makes areas EXACT
                                 # at any level (typical text levels need
                                 # <= 105 runs/row, noisy flood levels
                                 # ~280 — paying the wide sort only there
                                 # halves the ladder's area cost)


class MserResult(NamedTuple):
    # per region, fixed capacity R:
    seed_x: jax.Array      # (R,) i32 seed pixel (component min-index)
    seed_y: jax.Array
    level: jax.Array       # (R,) i32 gray threshold at which it is stable
    area: jax.Array        # (R,) i32
    variation: jax.Array   # (R,) f32 stability score (lower = more stable)
    box_x0: jax.Array      # (R,) i32
    box_y0: jax.Array
    box_x1: jax.Array
    box_y1: jax.Array
    valid: jax.Array       # (R,) bool
    overflowed: jax.Array  # () i32: #levels where a fixed capacity clipped
                           # (runs/row or candidate table) — results may
                           # silently miss regions when nonzero

    def count(self):
        return jnp.sum(self.valid)


_VAR_BITS = 16        # variation in i32 fixed point (units of 2^-16) so
_VAR_CLAMP = 8000     # table lookups stay exact (clamp * 2^16 * 2 < 2^31)


def _variation_q(grow, area):
    """round(grow / area * 2^16), clamped to 8000 * 2^16, for int32
    grow >= 0 and 1 <= area < 2^27, in exact integer long division (four
    4-bit digits after the integer part, so no product exceeds 2^31): the
    same integers on every backend, whatever its f32 division does."""
    q, r = grow // area, grow % area
    frac = jnp.zeros_like(q)
    for _ in range(_VAR_BITS // 4):
        frac, r = frac * 16 + (r * 16) // area, (r * 16) % area
    frac = frac + (2 * r >= area).astype(jnp.int32)
    return jnp.where(q >= _VAR_CLAMP, _VAR_CLAMP << _VAR_BITS,
                     jnp.minimum((jnp.minimum(q, _VAR_CLAMP) << _VAR_BITS)
                                 + frac, _VAR_CLAMP << _VAR_BITS))


def _lookup_sorted(table_keys, table_vals, queries, invalid_key):
    """Batched exact-match lookup: (B, C) tables sorted ascending by key
    (invalid entries = invalid_key, sorted to the end), (B, Q) queries ->
    (found (B, Q) bool, vals (B, Q) i32, vals >= 0 required).

    Sort-merge: table rows and queries sort together by (key, kind); the
    running table value is reconstructed by a cumsum of per-entry value
    DIFFS (exact in int32 — no gather-based forward fill), and a second
    small sort by slot restores query order. Dense (root -> val) scatter
    tables would need 271 MB operands at 1122x1182."""
    b, c = table_keys.shape
    q = queries.shape[1]
    prev_v = jnp.pad(table_vals, ((0, 0), (1, 0)))[:, :-1]
    diffs = table_vals - prev_v
    skey = jnp.concatenate([table_keys * 2, queries * 2 + 1], axis=1)
    dif = jnp.concatenate([diffs, jnp.zeros((b, q), jnp.int32)], axis=1)
    slot = jnp.concatenate(
        [jnp.full((b, c), q, jnp.int32),
         jnp.broadcast_to(jnp.arange(q, dtype=jnp.int32), (b, q))], axis=1)
    kk = jnp.concatenate([table_keys, queries], axis=1)
    _, dif_s, slot_s, key_s, flag_s = jax.lax.sort(
        [skey, dif, slot, kk,
         jnp.concatenate([jnp.zeros((b, c), jnp.int32),
                          jnp.ones((b, q), jnp.int32)], axis=1)],
        dimension=1, num_keys=1)
    ffv = jnp.cumsum(jnp.where(flag_s == 0, dif_s, 0), axis=1)
    ffk = jax.lax.cummax(jnp.where(flag_s == 0, key_s, -1), axis=1)
    found = (ffk == key_s) & (key_s != invalid_key)
    packed = ffv * 2 + found.astype(jnp.int32)
    # restore query order: queries hold unique slots 0..q-1 (tables all
    # hold q), so sorting by slot puts them first, in order
    _, out = jax.lax.sort([slot_s, packed], dimension=1, num_keys=1,
                          is_stable=False)
    out = out[:, :q]
    return (out % 2) == 1, out // 2


@partial(jax.jit, static_argnames=("config", "shape"))
def _mser_impl(img: jax.Array, config: MserConfig, shape) -> MserResult:
    h, w = shape
    n = h * w
    f = img if config.dark else (255 - img.astype(jnp.int32)).astype(jnp.uint8)

    cand_levels = list(range(config.level_step, 256, config.level_step))
    plus_levels = [min(t + config.delta, 255) for t in cand_levels]
    all_levels = sorted(set(cand_levels) | set(plus_levels))
    pos = {t: i for i, t in enumerate(all_levels)}
    n_lv = len(all_levels)
    n_cand = len(cand_levels)
    # run-capacity tiers, ending in an exact ceil(W/2) tier (clamped only
    # when the int32 area-sum bound forbids it — flagged via counts)
    w_exact = -(-w // 2)
    sum_cap = max((2 ** 31 - 1) // (h * max(w, 1)), 1)
    tiers = sorted({min(t, w_exact, sum_cap) for t in config.run_tiers}
                   | {min(w_exact, sum_cap)})
    kk_max = tiers[-1]
    cap = min(config.max_candidates, h * tiers[0])
    amin = max(int(config.min_area * n), 1)
    amax = int(config.max_area * n)
    lb_bits = max(1, (n - 1).bit_length())
    len_bits = max(1, w.bit_length())

    idx = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w
           + jax.lax.broadcasted_iota(jnp.int32, (h, w), 1))

    def level_candidates(lbl, kk):
        """Exact per-component areas of one level's labeling via run
        records (see module docstring), compacted to the (cap,) candidate
        table of components with area >= min_area (amax applies only at
        final filtering so PARENT components stay in the tables)."""
        from compv_tpu.features.ccl import extract_runs
        run_lbl, run_x0, run_x1, counts = extract_runs(lbl, kk)
        over_runs = jnp.any(counts > kk)
        length = jnp.where(run_lbl >= 0, run_x1 - run_x0 + 1, 0)
        if lb_bits + len_bits <= 32:
            keyu = jnp.where(
                run_lbl >= 0,
                (run_lbl.astype(jnp.uint32) << len_bits)
                | length.astype(jnp.uint32),
                jnp.uint32(0xFFFFFFFF)).ravel()
            ku = jax.lax.sort(keyu, is_stable=False)
            sen = ku == jnp.uint32(0xFFFFFFFF)
            ks = jnp.where(sen, _BIG, (ku >> len_bits).astype(jnp.int32))
            ln = jnp.where(sen, 0,
                           (ku & jnp.uint32((1 << len_bits) - 1))
                           .astype(jnp.int32))
        else:
            key = jnp.where(run_lbl >= 0, run_lbl, _BIG).ravel()
            ks, ln = jax.lax.sort([key, length.ravel()], num_keys=1,
                                  is_stable=False)
            ln = jnp.where(ks < _BIG, ln, 0)
        prev_k = jnp.pad(ks, (1, 0), constant_values=-1)[:-1]
        is_first = (ks != prev_k) & (ks < _BIG)
        cs = jnp.cumsum(ln)
        exc = jnp.pad(cs, (1, 0))[:-1]
        u = jnp.where(is_first, exc, jnp.int32(2 ** 31 - 1))
        nxt = jax.lax.cummin(u[::-1])[::-1]
        nxt = jnp.concatenate([nxt[1:], cs[-1:]])
        area = jnp.minimum(nxt, cs[-1]) - exc          # valid at is_first

        # candidates keep rec-space (ascending-root) order: sorting by
        # masked root alone compacts them — no third value array
        cand_mask = is_first & (area >= amin)
        root_s, area_s = jax.lax.sort(
            [jnp.where(cand_mask, ks, _BIG),
             jnp.where(cand_mask, area, 0)], num_keys=1, is_stable=False)
        root = jnp.where(root_s[:cap] < _BIG, root_s[:cap], -1)
        car = jnp.where(root >= 0, area_s[:cap], 0)
        over = (over_runs | (jnp.sum(cand_mask) > cap)).astype(jnp.int32)
        return root, car, over

    # ---------------- phase 1: incremental labeling + per-level records
    def level_step_fn(carry, t):
        prev_lbl, prev_root, prev_area = carry
        fgm = (f.astype(jnp.int32) <= t).astype(jnp.uint8)
        changed = jnp.any((fgm > 0) != (prev_lbl >= 0))

        def compute(_):
            init = jnp.where(prev_lbl >= 0, prev_lbl, idx)
            lbl = label_components_seeded(fgm, init, 8)
            # tier dispatch: pay the wide-capacity sorts only at levels
            # that need them (noisy flood levels; ~280 runs/row vs <= 105
            # at typical text levels)
            fgl = lbl >= 0
            starts = fgl & ~jnp.pad(fgl, ((0, 0), (1, 0)))[:, :-1]
            mx = jnp.max(jnp.sum(starts.astype(jnp.int32), axis=1))
            branches = [partial(level_candidates, kk=t_) for t_ in tiers]
            sel = sum(jnp.int32(mx > t_) for t_ in tiers[:-1]) \
                if len(tiers) > 1 else jnp.int32(0)
            root, car, over = jax.lax.switch(sel, branches, lbl)
            return lbl, root, car, over

        def reuse(_):
            return prev_lbl, prev_root, prev_area, jnp.int32(0)

        lbl, root, car, over = jax.lax.cond(changed, compute, reuse, 0)
        return (lbl, root, car), (lbl.ravel(), root, car, over)

    carry0 = (jnp.full((h, w), -1, jnp.int32),
              jnp.full((cap,), -1, jnp.int32),
              jnp.zeros((cap,), jnp.int32))
    _, (labels_flat, cand_root, cand_area, over_all) = jax.lax.scan(
        level_step_fn, carry0, jnp.asarray(all_levels, jnp.int32))
    # labels_flat: (L, n) — flattened in-step so no (L, h, w) -> (L, n)
    # relayout copy is needed for the cross-level gathers below
    invalid = jnp.int32(n + 1)
    tbl_root = jnp.where(cand_root >= 0, cand_root, invalid)  # (L, cap)

    cand_rows = jnp.asarray([pos[t] for t in cand_levels], jnp.int32)
    plus_rows = jnp.asarray([pos[p] for p in plus_levels], jnp.int32)
    seeds = cand_root[cand_rows]                       # (n_cand, cap)
    areas = cand_area[cand_rows]
    valid_c = seeds >= 0

    # variation: area of the comp containing the seed at the +delta level
    # (>= own area >= min_area, so it has a table entry unless capacity
    # overflowed — flagged)
    plus_roots = labels_flat[plus_rows[:, None],
                             jnp.where(seeds >= 0, seeds, 0)]
    found_p, area_plus = _lookup_sorted(
        tbl_root[plus_rows], cand_area[plus_rows],
        jnp.where(plus_roots >= 0, plus_roots, invalid), invalid)
    has_var = valid_c & found_p & (area_plus >= areas)
    var_q = _variation_q(jnp.where(has_var, area_plus - areas, 0),
                         jnp.maximum(areas, 1))
    var = jnp.where(has_var,
                    var_q.astype(jnp.float32) / float(1 << _VAR_BITS),
                    np.inf)
    var_q = jnp.where(has_var, var_q, _VAR_CLAMP << _VAR_BITS)

    # local-minimum stability vs parent (next cand level up, through the
    # seed) and child (next level down); a missing table entry (area <
    # min_area, capacity overflow, or ladder edge) passes the test.
    up_rows = jnp.minimum(jnp.arange(n_cand) + 1, n_cand - 1)
    dn_rows = jnp.maximum(jnp.arange(n_cand) - 1, 0)
    r_up = labels_flat[cand_rows[up_rows][:, None],
                       jnp.where(seeds >= 0, seeds, 0)]
    r_dn = labels_flat[cand_rows[dn_rows][:, None],
                       jnp.where(seeds >= 0, seeds, 0)]
    var_tbl_keys = jnp.where(valid_c, seeds, invalid)  # (n_cand, cap) sorted
    found_ud, vq_ud = _lookup_sorted(
        jnp.concatenate([var_tbl_keys[up_rows], var_tbl_keys[dn_rows]], 0),
        jnp.concatenate([var_q[up_rows], var_q[dn_rows]], 0),
        jnp.concatenate([jnp.where(r_up >= 0, r_up, invalid),
                         jnp.where(r_dn >= 0, r_dn, invalid)], 0), invalid)
    found_up, found_dn = found_ud[:n_cand], found_ud[n_cand:]
    vq_up, vq_dn = vq_ud[:n_cand], vq_ud[n_cand:]
    is_min_up = jnp.where(
        found_up & (jnp.arange(n_cand)[:, None] < n_cand - 1),
        var_q <= vq_up, True)
    has_dn = (r_dn >= 0) & found_dn & (jnp.arange(n_cand)[:, None] > 0)
    is_min_dn = jnp.where(has_dn, var_q <= vq_dn, True)

    ok = (valid_c & is_min_up & is_min_dn & (areas <= amax)
          & (var <= config.max_variation))
    # ---------------- top-R regions: per-level top-R then global top-R,
    # most stable first, ties to the lower index — sorts on (integer
    # variation, index) pairs, so every backend picks the same regions
    r_cap = config.max_regions
    kr = min(r_cap, cap)
    none = jnp.int32(2 ** 31 - 1)
    score_q = jnp.where(ok, var_q, none)
    sq, posi = jax.lax.sort(
        [score_q, jax.lax.broadcasted_iota(jnp.int32, score_q.shape, 1)],
        dimension=1, num_keys=2)
    sq, posi = sq[:, :kr], posi[:, :kr]                  # (n_cand, kr)
    vals, sel = jax.lax.sort(
        [sq.ravel(), jnp.arange(sq.size, dtype=jnp.int32)], num_keys=2)
    vals, sel = vals[:r_cap], sel[:r_cap]
    valid = vals < none
    lvl_i = (sel // kr).astype(jnp.int32)                # cand-level index
    slot = posi.reshape(-1)[sel]
    pick = lambda a2d: a2d[lvl_i, slot]
    sel_seed = jnp.where(valid, pick(seeds), 0)
    sel_area = jnp.where(valid, pick(areas), 0)
    sel_var = jnp.where(valid, pick(var), np.inf)

    # ---------------- min-diversity (lmser_result.h:91-113)
    rows_i = cand_rows[lvl_i]                             # (R,)
    root_j_at_i = labels_flat[rows_i[:, None], sel_seed[None, :]]  # (R, R)
    nested = (root_j_at_i == sel_seed[:, None]) & \
        (lvl_i[:, None] >= lvl_i[None, :])
    nested = nested | nested.T
    a_i = sel_area[:, None].astype(jnp.float32)
    a_j = sel_area[None, :].astype(jnp.float32)
    # |a_i - a_j| / max(a_i, a_j) < min_diversity, without the division
    similar = jnp.abs(a_i - a_j) < config.min_diversity * jnp.maximum(
        jnp.maximum(a_i, a_j), 1.0)
    rank = jnp.arange(r_cap)
    beats = (rank[None, :] < rank[:, None]) & valid[None, :]
    killed = jnp.any(nested & similar & beats, axis=1)
    keep = valid & ~killed

    # ---------------- boxes for the surviving regions: ONE batched pass
    # (gather the level rows once and reduce (R, n) in a single program
    # instead of R sequential full-image sweeps; min-y is free — the
    # root's row)
    xi1 = jnp.arange(w, dtype=jnp.int32)
    yi1 = jnp.arange(h, dtype=jnp.int32)
    rows_lab = labels_flat[rows_i]                        # (R, n)
    m = (rows_lab == sel_seed[:, None]).reshape(-1, h, w)
    big = jnp.int32(_BIG)
    anyx = jnp.any(m, axis=1)                             # (R, w)
    anyy = jnp.any(m, axis=2)                             # (R, h)
    bx0 = jnp.min(jnp.where(anyx, xi1[None, :], big), axis=1)
    bx1 = jnp.max(jnp.where(anyx, xi1[None, :], -1), axis=1)
    by1 = jnp.max(jnp.where(anyy, yi1[None, :], -1), axis=1)
    by0 = sel_seed // w

    level_arr = jnp.asarray(cand_levels, jnp.int32)
    overflowed = jnp.sum(over_all).astype(jnp.int32)
    return MserResult(
        seed_x=jnp.where(keep, sel_seed % w, 0),
        seed_y=jnp.where(keep, sel_seed // w, 0),
        level=jnp.where(keep, level_arr[lvl_i], 0),
        area=jnp.where(keep, sel_area, 0),
        variation=jnp.where(keep, sel_var, np.inf),
        box_x0=jnp.where(keep, bx0, 0),
        box_y0=jnp.where(keep, by0, 0),
        box_x1=jnp.where(keep, bx1, 0),
        box_y1=jnp.where(keep, by1, 0),
        valid=keep,
        overflowed=overflowed,
    )


def _warn_overflow(n_levels):
    from compv_tpu.profiling import log
    log.warn(
        f"MSER capacity overflow at {int(n_levels)} level(s): regions may "
        "be silently missing. Raise MserConfig.max_candidates (components "
        "with area >= min_area per level) — run capacities auto-tier up "
        "to the exact ceil(W/2) bound and cannot overflow on their own.")


def mser_detect(img: jax.Array, config: MserConfig = MserConfig()
                ) -> MserResult:
    """Detect MSERs on a (H, W) u8 grayscale image.

    Capacity sizing: `max_candidates` bounds components with area >=
    min_area per gray level; text scans measure a few hundred, so the
    default 1024 is comfortable. If any level exceeds it the result sets
    `overflowed` AND — on eager (non-traced) calls — a WARN log fires,
    so no product path can silently drop regions. Under an outer jit the
    eager check cannot run; callers there must consume `overflowed`
    themselves, as run_sfm and the tests do."""
    res = _mser_impl(img, config, img.shape)
    if not isinstance(res.overflowed, jax.core.Tracer):
        n_over = int(res.overflowed)
        if n_over > 0:
            _warn_overflow(n_over)
    return res


@partial(jax.jit, static_argnames=("dark", "shape"))
def _region_mask_impl(img, seed_x, seed_y, level, dark: bool, shape):
    from compv_tpu.features.ccl import label_components
    f = img if dark else (255 - img.astype(jnp.int32)).astype(jnp.uint8)
    binary = (f.astype(jnp.int32) <= level).astype(jnp.uint8)
    lbl = label_components(binary, 8, 64)
    return (lbl >= 0) & (lbl == lbl[seed_y, seed_x])


def mser_region_mask(img: jax.Array, seed_x, seed_y, level,
                     dark: bool = True) -> jax.Array:
    """(H, W) bool membership mask of one detected region — the analogue of
    the reference's per-region point lists (compv_ccl.h:141-156,
    lmser_result.h computeFinalPoints). Recomputes the level-set labeling
    at the region's gray level (cheap; one CCL pass)."""
    return _region_mask_impl(img, seed_x, seed_y, level, dark, img.shape)


@partial(jax.jit, static_argnames=("max_points",))
def mser_region_points(mask: jax.Array, max_points: int = 4096):
    """(H, W) bool mask -> fixed-capacity point list ((P,) x, (P,) y,
    (P,) valid) in raster order — CompVConnectedComponentPoints analogue."""
    h, w = mask.shape
    n = h * w
    flat = mask.ravel()
    rank = jnp.where(flat, n - jnp.arange(n, dtype=jnp.int32), 0)
    vals, idx2 = jax.lax.top_k(rank, min(max_points, n))
    valid = vals > 0
    return ((idx2 % w).astype(jnp.int32) * valid,
            (idx2 // w).astype(jnp.int32) * valid, valid)
