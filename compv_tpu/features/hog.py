"""HOG (R-HOG) dense descriptor.

Reference: CompVHogStd (core/features/hog/compv_core_feature_hog_std.cxx:196):
gradX/gradY (GradientFast central difference) -> magnitude + direction
(fastAtan2) -> cell histograms (nearest / bilinear interpolation) -> block
normalization none/L1/L1Sqrt/L2/L2Hys -> dense row-major descriptor.
Params compv_features.h:105-120; defaults 8x8 cells, 2x2 blocks, stride 8,
9 bins, L2Hys, gradient unsigned.

Design: everything is dense reshapes + one-hot bin scatter expressed as
a (pixels x bins) weighted sum via segment reshape — no loops, batched
over images with vmap.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["HogConfig", "hog_descriptor", "gradient_fast"]


@dataclass(frozen=True)
class HogConfig:
    cell_size: int = 8          # COMPV_HOG_SET_INT_CELL_SIZE (8x8)
    block_size: int = 2         # in cells (2x2)
    block_stride: int = 1       # in cells
    nbins: int = 9              # COMPV_HOG_SET_INT_NBINS
    norm: str = "l2hys"         # none | l1 | l1sqrt | l2 | l2hys
    signed_gradient: bool = False  # unsigned [0,180) like the reference default
    interp: str = "bilinear"    # nearest | bilinear | bilinear_lut
    lut_bins: int = 1024        # direction quantization of bilinear_lut
    l2hys_clip: float = 0.2


def gradient_fast(img: jax.Array):
    """Central-difference gradients (reference GradientFast,
    base/include/compv/base/compv_gradient_fast.h:19-71): replicated borders."""
    f = img.astype(jnp.float32)
    fx = jnp.pad(f, ((0, 0), (1, 1)), mode="edge")
    fy = jnp.pad(f, ((1, 1), (0, 0)), mode="edge")
    gx = (fx[:, 2:] - fx[:, :-2]) * 0.5
    gy = (fy[2:, :] - fy[:-2, :]) * 0.5
    return gx, gy


@partial(jax.jit, static_argnames=("config",))
def hog_descriptor(img: jax.Array, config: HogConfig = HogConfig()
                   ) -> jax.Array:
    """(H, W) u8 -> (n_blocks_y, n_blocks_x, block^2 * nbins) f32 descriptor
    (flattenable to the reference's dense row vector)."""
    h, w = img.shape
    cs = config.cell_size
    nb = config.nbins
    ch = h // cs
    cw = w // cs
    hh = ch * cs
    ww = cw * cs

    gx, gy = gradient_fast(img)
    gx = gx[:hh, :ww]
    gy = gy[:hh, :ww]
    mag = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.arctan2(gy, gx)                      # [-pi, pi]
    if config.signed_gradient:
        ang = jnp.where(ang < 0, ang + 2 * jnp.pi, ang)
        span = 2 * jnp.pi
    else:
        ang = jnp.where(ang < 0, ang + jnp.pi, ang)  # [0, pi)
        span = jnp.pi

    pos = ang / span * nb                          # [0, nb)
    if config.interp == "bilinear_lut":
        # the reference's third mode: hog_std builds a quantized bilinear
        # LUT over the direction (compv_core_feature_hog_std.cxx) so the
        # CPU pays one table read instead of a divide per pixel. Here the
        # same semantics are reproduced arithmetically, with no gather: quantize the direction to
        # lut_bins steps and vote bilinearly from the step's
        # representative angle — bit-identical to indexing a table built
        # from the same formula.
        q = jnp.clip(jnp.floor(pos / nb * config.lut_bins), 0,
                     config.lut_bins - 1)
        pos = (q + 0.5) * (nb / config.lut_bins)
    if config.interp == "nearest":
        b0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, nb - 1)
        w0 = jnp.ones_like(pos)
        b1 = b0
        w1 = jnp.zeros_like(pos)
    else:                       # bilinear / bilinear_lut
        # bilinear vote into the two nearest bin centers (centers at k+0.5)
        pc = pos - 0.5
        b0f = jnp.floor(pc)
        frac = pc - b0f
        b0 = jnp.mod(b0f.astype(jnp.int32), nb)
        b1 = jnp.mod(b0 + 1, nb)
        w0 = 1.0 - frac
        w1 = frac

    # cell histograms: reshape to (ch, cs, cw, cs) and one-hot bin sum
    def cell_hist(bins, wgt):
        oh = jax.nn.one_hot(bins, nb, dtype=jnp.float32)      # (hh, ww, nb)
        v = oh * (mag * wgt)[..., None]
        v = v.reshape(ch, cs, cw, cs, nb)
        return v.sum(axis=(1, 3))                             # (ch, cw, nb)

    hist = cell_hist(b0, w0) + cell_hist(b1, w1)

    # block assembly: (by, bx, bs, bs, nb)
    bs = config.block_size
    stride = config.block_stride
    n_by = (ch - bs) // stride + 1
    n_bx = (cw - bs) // stride + 1
    idx_y = (jnp.arange(n_by) * stride)[:, None] + jnp.arange(bs)[None, :]
    idx_x = (jnp.arange(n_bx) * stride)[:, None] + jnp.arange(bs)[None, :]
    blocks = hist[idx_y][:, :, idx_x]             # (by, bs, bx, bs, nb)
    blocks = jnp.transpose(blocks, (0, 2, 1, 3, 4))
    vec = blocks.reshape(n_by, n_bx, bs * bs * nb)

    eps = 1e-6
    if config.norm == "none":
        out = vec
    elif config.norm == "l1":
        out = vec / (jnp.sum(jnp.abs(vec), axis=-1, keepdims=True) + eps)
    elif config.norm == "l1sqrt":
        out = jnp.sqrt(vec / (jnp.sum(jnp.abs(vec), axis=-1, keepdims=True) + eps))
    elif config.norm == "l2":
        out = vec / jnp.sqrt(jnp.sum(vec * vec, axis=-1, keepdims=True) + eps * eps)
    elif config.norm == "l2hys":
        v = vec / jnp.sqrt(jnp.sum(vec * vec, axis=-1, keepdims=True) + eps * eps)
        v = jnp.clip(v, 0.0, config.l2hys_clip)
        out = v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True) + eps * eps)
    else:
        raise ValueError(config.norm)
    return out
