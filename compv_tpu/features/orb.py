"""ORB: oriented FAST detector + rotated-BRIEF-256 descriptor.

Reference behavior:
  * detector (core/features/orb/compv_core_feature_orb_dete.cxx): 8-level
    bilinear pyramid (sf=0.83), per-level FAST9 (threshold 20, NMS), per-level
    feature budget = max_features * sf^level / scaleFactorsSum
    (orb_dete.cxx:301-311), border erase at patch radius, orientation from
    circular-patch image moments: orient = atan2(m01, m10) in degrees [0,360)
    (orb_dete.cxx:330-346, CompVPatch::moments0110 base/compv_patch.cxx:58),
    coords scaled back to level 0.
  * descriptor (core/features/orb/compv_core_feature_orb_desc.cxx): per-level
    Gaussian blur (k=5, sigma=2.0, orb_desc.cxx:119-120), here in Q16 fixed
    point (ops.conv.gaussian_blur_q16); per keypoint the
    256 (A,B) point pairs are rotated by the keypoint orientation, ROUNDED to
    nearest int and sampled nearest-neighbor from the blurred level image
    centered at the rounded keypoint (CompVOrbBrief256_31_32f_C,
    orb_desc.cxx:477-518); bit i = (I[A_i] < I[B_i]).

Design: per-level dense FAST (features/fast.py) + top-k; orientation
comes from dense incremental-shift moment maps (2 gathers/keypoint), and
the descriptor is 2 x 256 per-sample gathers per keypoint. The BRIEF pattern is
generated deterministically (Gaussian sigma = patch/5 clipped to the radius-14
disc, the original BRIEF "GII" scheme) — NOT copied from the reference's
hardcoded table; rotation preserves the norm so all rotated samples stay
inside the patch radius and border-erased keypoints can never sample
out-of-bounds.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.core.types import Keypoints
from compv_tpu.features.fast import _nms_f32, _strengths_f32
from compv_tpu.image.pyramid import pyramid_sizes, scale_factors, scale_factors_sum
from compv_tpu.image.scale import scale as scale_image
from compv_tpu.ops.conv import gaussian_blur_q16
from compv_tpu.ops.anglebin import angle_bin
from compv_tpu.ops.bitops import pack_bits_to_bytes
from compv_tpu.ops.topk import select_top_k_2d

__all__ = ["OrbConfig", "brief_pattern", "patch_orientation", "brief_describe",
           "orb_detect_describe", "OrbResult"]

PATCH_DIAMETER = 31   # COMPV_FEATURE_DETE_ORB_PATCH_DIAMETER (orb_dete.cxx:41)
PATCH_RADIUS = PATCH_DIAMETER // 2
DESC_BITS = 256       # COMPV_FEATURE_DETE_ORB_PATCH_BITS (orb_dete.cxx:42)


@dataclass(frozen=True)
class OrbConfig:
    max_features: int = 2000      # COMPV_FEATURE_DETE_ORB_FAST_MAX_FEATURES
    threshold: int = 20
    fast_n: int = 9
    nms: bool = True
    levels: int = 8               # COMPV_FEATURE_DETE_ORB_PYRAMID_LEVELS
    scale_factor: float = 0.83    # COMPV_FEATURE_DETE_ORB_PYRAMID_SF
    blur_size: int = 5            # COMPV_FEATURE_DESC_ORB_GAUSS_KERN_SIZE
    blur_sigma: float = 2.0       # COMPV_FEATURE_DESC_ORB_GAUSS_KERN_SIGMA
    subpixel: bool = True         # quadratic-vertex keypoint refinement
                                  # (beyond the reference's integer coords)


def brief_pattern(bits: int = DESC_BITS, patch: int = PATCH_DIAMETER,
                  seed: int = 0xC0F
                  ) -> np.ndarray:
    """Deterministic BRIEF test-pair pattern, (bits, 4) int32 [ax, ay, bx, by].

    Original-BRIEF GII sampling: A,B ~ iid N(0, (patch/5)^2), rejection-
    sampled into the disc of radius patch/2 - 1.5 so rotated samples stay in
    the patch. Fixed seed -> identical pattern everywhere forever."""
    rs = np.random.default_rng(seed)
    sigma = patch / 5.0
    rmax = patch / 2.0 - 1.5
    out = np.zeros((bits, 4), np.int32)
    for i in range(bits):
        pts = []
        while len(pts) < 2:
            p = rs.normal(0.0, sigma, 2)
            if p[0] ** 2 + p[1] ** 2 <= rmax ** 2:
                pts.append(np.round(p).astype(np.int32))
        out[i] = [pts[0][0], pts[0][1], pts[1][0], pts[1][1]]
    return out


# numpy at module scope (device transfer happens at trace time) — a
# module-level jnp constant would initialize the backend on import,
# breaking jax.distributed.initialize ordering on multi-host
_PATTERN = brief_pattern()  # (256, 4) i32 numpy


def _disc_mask_and_grids(radius: int):
    d = 2 * radius + 1
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = (xs * xs + ys * ys) <= radius * radius
    return (np.asarray(mask, np.float32), np.asarray(xs, np.float32),
            np.asarray(ys, np.float32))


# numpy at module scope; converted at trace time (see _PATTERN note)
_DISC_MASK, _DISC_X, _DISC_Y = _disc_mask_and_grids(PATCH_RADIUS)

ORIENT_BINS = 360     # orientation resolution: 1-degree bins


def _steering_offsets(bins: int = ORIENT_BINS) -> np.ndarray:
    """(bins, 256, 4) i8 host table: the BRIEF pattern [ax, ay, bx, by]
    rotated by each orientation bin's centre angle and rounded (float64,
    once), so steering is the same integers on every backend."""
    ctr = (2 * np.arange(bins) + 1) * np.pi / bins
    c, sn = np.cos(ctr)[:, None], np.sin(ctr)[:, None]
    ax, ay = _PATTERN[None, :, 0], _PATTERN[None, :, 1]
    bx, by = _PATTERN[None, :, 2], _PATTERN[None, :, 3]
    offsets = np.stack([np.round(ax * c - ay * sn), np.round(ax * sn + ay * c),
                        np.round(bx * c - by * sn), np.round(bx * sn + by * c)],
                       -1).astype(np.int8)
    return offsets


_BRIEF_OFFSETS = _steering_offsets()


def _m10_map(img: jax.Array) -> jax.Array:
    """Dense map of the disc first moment m10(y, x) = sum over the
    radius-15 disc of dx * I(y+dy, x+dx), via static shifts only.

    Row moments build INCREMENTALLY over the half-width e:
    M_e = M_{e-1} + e * (I(., x+e) - I(., x-e)), then the disc is 31
    row-shifted copies picking M_{e(|dy|)}, e(dy) = floor(sqrt(r^2-dy^2)).
    Everything is f32-exact for u8 input: |M_e| <= 255 * 2 * sum(d) and
    |m10| <= 255 * 15 * 961 are both < 2^24 (a cumsum-based window would
    carry ~2^31 prefixes and lose integer exactness). Zero padding only
    affects map entries within r of the border, which callers never
    gather (keypoint centers are clamped to the interior)."""
    f = img.astype(jnp.float32)
    h, w = f.shape
    r = PATCH_RADIUS

    def shx(a, d):
        if d > 0:
            return jnp.pad(a, ((0, 0), (0, d)))[:, d:]
        return jnp.pad(a, ((0, 0), (-d, 0)))[:, :w]

    def shy(a, d):
        if d == 0:
            return a
        if d > 0:
            return jnp.pad(a, ((0, d), (0, 0)))[d:, :]
        return jnp.pad(a, ((-d, 0), (0, 0)))[:h, :]

    es = [int(np.floor(np.sqrt(r * r - dy * dy))) for dy in range(r + 1)]
    m_by_e = {0: jnp.zeros_like(f)}
    m = jnp.zeros_like(f)
    for e in range(1, r + 1):
        m = m + float(e) * (shx(f, e) - shx(f, -e))
        m_by_e[e] = m
    out = m_by_e[es[0]]
    for dy in range(1, r + 1):
        me = m_by_e[es[dy]]
        out = out + shy(me, dy) + shy(me, -dy)
    return out


def patch_orientation(img: jax.Array, x: jax.Array, y: jax.Array,
                      valid: jax.Array) -> jax.Array:
    """IC-moment orientation in degrees [0,360) for keypoints at integer-
    rounded (x, y) on ``img``. Batched over the keypoint axis.

    m10 = sum(x_rel * I), m01 = sum(y_rel * I) over the radius-15 disc;
    orient = atan2(m01, m10) (orb_dete.cxx:336-344), returned as the centre
    of its 1-degree bin. The moments are exact integers and the bin is
    settled by exact integer arithmetic (ops.anglebin.angle_bin), so every
    backend returns the same bin.

    The moments are LINEAR in the image, so both are dense maps computed
    once per level and gathered at the K keypoints — 2 gathers/keypoint
    instead of a 961-element patch slice per keypoint. The disc is a stack
    of 31 row windows with 16 distinct half-widths e(dy) =
    floor(sqrt(r^2 - dy^2)); each row's centered moment builds
    incrementally over e and the vertical stack is 31 static row shifts
    (~90 fused elementwise passes instead of a 31x31 single-channel conv).
    Integer-exact for u8 input — see _m10_map."""
    h, w = img.shape
    m10_map = _m10_map(img)
    m01_map = _m10_map(img.T).T
    xi = jnp.clip(jnp.round(x).astype(jnp.int32), PATCH_RADIUS,
                  w - 1 - PATCH_RADIUS)
    yi = jnp.clip(jnp.round(y).astype(jnp.int32), PATCH_RADIUS,
                  h - 1 - PATCH_RADIUS)
    m10 = m10_map[yi, xi]
    m01 = m01_map[yi, xi]
    b = angle_bin(m10.astype(jnp.int32), m01.astype(jnp.int32), ORIENT_BINS)
    deg = (b.astype(jnp.float32) + 0.5) * (360.0 / ORIENT_BINS)
    return jnp.where(valid, deg, 0.0)


def brief_describe(blurred: jax.Array, x: jax.Array, y: jax.Array,
                   orientation_deg: jax.Array, valid: jax.Array) -> jax.Array:
    """Rotated BRIEF-256 on a pre-blurred image. Returns (K, 256) u8 bits.

    Per reference kernel (orb_desc.cxx:477-518): rotate each pattern point by
    the keypoint angle, round to nearest int, nearest-neighbor sample, bit =
    (I[A] < I[B]). The angle steers in 1-degree bins (the bin's centre, as
    patch_orientation returns it): the rotated, rounded offsets come from a
    host table, so they are the same integers on every backend."""
    h, w = blurred.shape
    f = blurred.astype(jnp.float32)
    xi = jnp.round(x).astype(jnp.int32)
    yi = jnp.round(y).astype(jnp.int32)
    b = jnp.floor(orientation_deg * (ORIENT_BINS / 360.0)).astype(jnp.int32)
    off = jnp.asarray(_BRIEF_OFFSETS)[b % ORIENT_BINS].astype(jnp.int32)
    rax, ray, rbx, rby = off[..., 0], off[..., 1], off[..., 2], off[..., 3]

    gx_a = jnp.clip(xi[:, None] + rax, 0, w - 1)
    gy_a = jnp.clip(yi[:, None] + ray, 0, h - 1)
    gx_b = jnp.clip(xi[:, None] + rbx, 0, w - 1)
    gy_b = jnp.clip(yi[:, None] + rby, 0, h - 1)
    bits = (f[gy_a, gx_a] < f[gy_b, gx_b]).astype(jnp.uint8)
    return jnp.where(valid[:, None], bits, jnp.uint8(0))


class OrbResult(NamedTuple):
    keypoints: Keypoints       # level-0 coords, capacity = max_features
    descriptors: jax.Array     # (max_features, 256) u8 bits (unpacked)

    def packed(self) -> jax.Array:
        """(max_features, 32) u8 — the reference's 32-byte descriptor rows."""
        return pack_bits_to_bytes(self.descriptors)


def _level_budgets(cfg: OrbConfig):
    """Per-level feature budget: max_features * sf^lv / sfs, >= 10
    (orb_dete.cxx:301-311, COMPV_FEATURE_DETE_ORB_MIN_FEATUES_PER_LEVEL)."""
    sfs = scale_factors_sum(cfg.levels, cfg.scale_factor)
    budgets = []
    for sf in scale_factors(cfg.levels, cfg.scale_factor):
        budgets.append(max(int(round(cfg.max_features * sf / sfs)), 10))
    return budgets


def _subpixel_offsets(s: jax.Array, x: jax.Array, y: jax.Array):
    """Per-axis quadratic vertex offsets in [-0.5, 0.5] from the 4-neighbor
    response samples around integer keypoints (x, y). Keypoints are interior
    by construction (border erase uses PATCH_RADIUS >= 1)."""
    xi = x.astype(jnp.int32)
    yi = y.astype(jnp.int32)
    sc = s[yi, xi]
    sl = s[yi, xi - 1]
    sr = s[yi, xi + 1]
    su = s[yi - 1, xi]
    sd = s[yi + 1, xi]

    def vertex(a, b, c):
        # parabola through (-1,a),(0,b),(1,c): vertex at (a-c)/(2(a-2b+c)),
        # rounded to 2^-10 px in exact integer arithmetic (the responses
        # are small integers), so every backend lands on the same offset
        ai, bi, ci = (v.astype(jnp.int32) for v in (a, b, c))
        den = ai - 2 * bi + ci
        sgn = jnp.where(den < 0, -1, 1)
        num = (ai - ci) * (1024 * sgn)               # off * 1024 = num / d
        d = 2 * den * sgn                            # > 0 unless den == 0
        q = (2 * num + d) // jnp.maximum(2 * d, 1)   # round half up
        q = jnp.where(den != 0, jnp.clip(q, -512, 512), 0)
        return q.astype(jnp.float32) / 1024.0

    return vertex(sl, sc, sr), vertex(su, sc, sd)


@partial(jax.jit, static_argnames=("config",))
def orb_detect_describe(img: jax.Array, config: OrbConfig = OrbConfig()
                        ) -> OrbResult:
    """Full ORB pipeline on a grayscale (H, W) u8 image.

    Per level: scale -> FAST strengths (+NMS) -> border zero -> top-k(budget)
    -> orientation -> blur -> BRIEF. Level results are concatenated and the
    global top ``max_features`` by strength are kept. All shapes static."""
    h, w = img.shape
    budgets = _level_budgets(config)
    sizes = pyramid_sizes(h, w, config.levels, config.scale_factor)
    sfs = scale_factors(config.levels, config.scale_factor)

    parts = []
    for lv in range(config.levels):
        lh, lw = sizes[lv]
        sf = sfs[lv]
        if lh < PATCH_DIAMETER + 2 or lw < PATCH_DIAMETER + 2:
            # level smaller than the orientation/BRIEF patch: no keypoint
            # can have a fully-interior patch — skip the level statically
            # (the reference's pyramid bottoms out the same way for tiny
            # inputs, orb_dete.cxx pyramid levels)
            continue
        k = min(budgets[lv], lh * lw)
        level_img = img if lv == 0 else scale_image(img, lh, lw, "bilinear")

        s = _strengths_f32(level_img, config.threshold, config.fast_n)
        s_raw = s          # pre-NMS response surface for sub-pixel fit
        if config.nms:
            s = _nms_f32(s)
        # zero out the border so top-k never selects points whose patch
        # crosses the image edge (reference eraseTooCloseToBorder with
        # patch radius, orb_dete.cxx:318-323)
        yy = jax.lax.broadcasted_iota(jnp.int32, (lh, lw), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (lh, lw), 1)
        interior = ((yy >= PATCH_RADIUS) & (yy < lh - PATCH_RADIUS)
                    & (xx >= PATCH_RADIUS) & (xx < lw - PATCH_RADIUS))
        s = jnp.where(interior, s, 0.0)

        vals, idx = select_top_k_2d(s, k)
        valid = vals > 0
        lx = (idx % lw).astype(jnp.float32)
        ly = (idx // lw).astype(jnp.float32)

        orient = patch_orientation(level_img, lx, ly, valid)
        blurred = gaussian_blur_q16(level_img, config.blur_size,
                                    config.blur_sigma)
        desc = brief_describe(blurred, lx, ly, orient, valid)

        # sub-pixel localization: 1-D quadratic vertex fit on the pre-NMS
        # response surface, per axis (reference detects at integer pixels,
        # orb_dete.cxx; the ±0.5 px quantization there is the accuracy
        # floor of everything downstream — homography, PnP, BA)
        if config.subpixel:
            rx, ry = _subpixel_offsets(s_raw, lx, ly)
            lxo = lx + jnp.where(valid, rx, 0.0)
            lyo = ly + jnp.where(valid, ry, 0.0)
        else:
            lxo, lyo = lx, ly

        inv_sf = 1.0 / sf
        parts.append((
            Keypoints(
                x=jnp.where(valid, lxo * inv_sf, 0.0),
                y=jnp.where(valid, lyo * inv_sf, 0.0),
                strength=jnp.where(valid, vals, 0.0),
                orientation=orient,
                level=jnp.full((k,), lv, jnp.int32),
                size=jnp.full((k,), PATCH_DIAMETER * inv_sf, jnp.float32),
                valid=valid,
            ),
            desc,
        ))

    if not parts:
        # image smaller than the ORB patch at every level: empty result
        k = config.max_features
        zf = jnp.zeros((k,), jnp.float32)
        return OrbResult(
            keypoints=Keypoints(zf, zf, zf, zf, jnp.zeros((k,), jnp.int32),
                                zf, jnp.zeros((k,), bool)),
            descriptors=jnp.zeros((k, DESC_BITS), jnp.uint8))

    kp_all = Keypoints(*[jnp.concatenate([getattr(p[0], fld) for p in parts])
                         for fld in Keypoints._fields])
    desc_all = jnp.concatenate([p[1] for p in parts], axis=0)

    # global top max_features by strength (reference retains per-level
    # budgets which already sum to ~max_features; we clamp exactly)
    kcap = min(config.max_features, int(kp_all.x.shape[0]))
    svals = jnp.where(kp_all.valid, kp_all.strength, -jnp.inf)
    _, sel = jax.lax.top_k(svals, kcap)
    take = lambda a: jnp.take(a, sel, axis=0)
    kp = Keypoints(take(kp_all.x), take(kp_all.y), take(kp_all.strength),
                   take(kp_all.orientation), take(kp_all.level),
                   take(kp_all.size), take(kp_all.valid))
    return OrbResult(keypoints=kp, descriptors=take(desc_all))
