"""Map-based resampling: remap, perspective/affine warp.

Reference: CompVImageRemap::process (base/image/compv_image_remap.cxx:417)
and CompVImage::warp/warpInverse (base/image/compv_image.cxx / compv_image.h:74-75).
Used by undistortion (core/calib/compv_core_calib_utils.cxx:227-485).

A remap is a 2D gather + lerp over the destination grid; XLA lowers it
to a single fused gather kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["remap_bilinear", "remap_nearest", "warp_perspective", "warp_affine"]


def _sample_bilinear(img: jax.Array, xs: jax.Array, ys: jax.Array,
                     fill: float = 0.0) -> jax.Array:
    """Sample img (H,W[,C]) at float coords (xs, ys) of any common shape,
    bilinear, out-of-range -> fill."""
    h, w = img.shape[:2]
    f = img.astype(jnp.float32)
    inside = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    xc = jnp.clip(xs, 0.0, w - 1.0)
    yc = jnp.clip(ys, 0.0, h - 1.0)
    x0 = jnp.floor(xc).astype(jnp.int32)
    y0 = jnp.floor(yc).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    tx = xc - x0
    ty = yc - y0
    if img.ndim == 3:
        tx = tx[..., None]
        ty = ty[..., None]
        inside_e = inside[..., None]
    else:
        inside_e = inside
    v00 = f[y0, x0]
    v01 = f[y0, x1]
    v10 = f[y1, x0]
    v11 = f[y1, x1]
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    out = top * (1 - ty) + bot * ty
    return jnp.where(inside_e, out, fill)


def remap_bilinear(img: jax.Array, map_x: jax.Array, map_y: jax.Array,
                   fill: float = 0.0) -> jax.Array:
    """dst[i,j] = img(map_y[i,j], map_x[i,j]) bilinear. Matches
    CompVImageRemap::process with COMPV_INTERPOLATION_TYPE_BILINEAR."""
    dtype = img.dtype
    out = _sample_bilinear(img, map_x.astype(jnp.float32),
                           map_y.astype(jnp.float32), fill)
    if jnp.issubdtype(dtype, jnp.integer):
        out = jnp.clip(jnp.round(out), 0, 255)
    return out.astype(dtype)


def remap_nearest(img: jax.Array, map_x: jax.Array, map_y: jax.Array,
                  fill: float = 0.0) -> jax.Array:
    h, w = img.shape[:2]
    xs = jnp.round(map_x).astype(jnp.int32)
    ys = jnp.round(map_y).astype(jnp.int32)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs = jnp.clip(xs, 0, w - 1)
    ys = jnp.clip(ys, 0, h - 1)
    out = img[ys, xs]
    if img.ndim == 3:
        inside = inside[..., None]
    return jnp.where(inside, out, jnp.asarray(fill, img.dtype))


def _dst_grid(out_h: int, out_w: int):
    yy = jax.lax.broadcasted_iota(jnp.float32, (out_h, out_w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (out_h, out_w), 1)
    return xx, yy


def warp_perspective(img: jax.Array, h_dst_to_src: jax.Array,
                     out_h: int, out_w: int, fill: float = 0.0) -> jax.Array:
    """Perspective warp; ``h_dst_to_src`` is the 3x3 homography mapping
    destination pixel (x,y,1) to source coords (reference
    CompVImage::warpInverse, compv_image.h:74-75)."""
    xx, yy = _dst_grid(out_h, out_w)
    hm = h_dst_to_src.astype(jnp.float32)
    den = hm[2, 0] * xx + hm[2, 1] * yy + hm[2, 2]
    den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    sx = (hm[0, 0] * xx + hm[0, 1] * yy + hm[0, 2]) / den
    sy = (hm[1, 0] * xx + hm[1, 1] * yy + hm[1, 2]) / den
    return remap_bilinear(img, sx, sy, fill)


def warp_affine(img: jax.Array, m_dst_to_src: jax.Array,
                out_h: int, out_w: int, fill: float = 0.0) -> jax.Array:
    """Affine warp with a 2x3 dst->src matrix."""
    xx, yy = _dst_grid(out_h, out_w)
    m = m_dst_to_src.astype(jnp.float32)
    sx = m[0, 0] * xx + m[0, 1] * yy + m[0, 2]
    sy = m[1, 0] * xx + m[1, 1] * yy + m[1, 2]
    return remap_bilinear(img, sx, sy, fill)
