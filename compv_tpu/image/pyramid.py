"""Image scale pyramid.

Reference: CompVImageScalePyramid (base/image/compv_image_scale_pyramid.cxx:62,163)
— scaleFactor^level images with per-level thread-safe process() and
scaleFactorsSum() used for per-level feature budgets
(core/features/orb/compv_core_feature_orb_dete.cxx:301-302).

Design: all levels are computed in one jitted call. Because XLA requires
static shapes, each level has its own (h_l, w_l) derived at trace time;
levels are returned as a list (a Python-level structure of fixed arrays),
which is also what scan-free per-level processing wants.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import jax
import jax.numpy as jnp

from compv_tpu.image.scale import scale

__all__ = ["Pyramid", "pyramid_sizes", "build_pyramid", "scale_factors", "scale_factors_sum"]


def scale_factors(levels: int, scale_factor: float) -> List[float]:
    return [scale_factor ** i for i in range(levels)]


def scale_factors_sum(levels: int, scale_factor: float) -> float:
    return float(sum(scale_factors(levels, scale_factor)))


def pyramid_sizes(h: int, w: int, levels: int, scale_factor: float):
    """Per-level (h, w) — static, computed at trace time. The reference
    computes per-level size as round(dim * sf^level)
    (compv_image_scale_pyramid.cxx:163)."""
    out = []
    for lv in range(levels):
        sf = scale_factor ** lv
        out.append((max(int(round(h * sf)), 1), max(int(round(w * sf)), 1)))
    return out


@dataclass
class Pyramid:
    """Holds the per-level images plus metadata."""
    levels: int
    scale_factor: float
    images: List[jax.Array] = field(default_factory=list)

    @property
    def factors(self) -> List[float]:
        return scale_factors(self.levels, self.scale_factor)

    @property
    def factors_sum(self) -> float:
        return scale_factors_sum(self.levels, self.scale_factor)

    def image_at(self, level: int) -> jax.Array:
        return self.images[level]


def build_pyramid(img: jax.Array, levels: int = 8, scale_factor: float = 0.83,
                  interpolation: str = "bilinear") -> Pyramid:
    """Build all levels from the level-0 image. Defaults match ORB's
    (COMPV_FEATURE_DETE_ORB_PYRAMID_LEVELS=8, _SF=0.83f, bilinear —
    orb_dete.cxx:39-44). Each level is scaled directly from level 0 as the
    reference does (pyramid process() scales the input image per level, not
    cascaded)."""
    h, w = img.shape[:2]
    sizes = pyramid_sizes(h, w, levels, scale_factor)
    images = [img]
    for (lh, lw) in sizes[1:]:
        images.append(scale(img, lh, lw, interpolation))
    return Pyramid(levels=levels, scale_factor=scale_factor, images=images)
