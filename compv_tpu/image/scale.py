"""Image resampling: bilinear / bicubic / nearest scaling.

Reference: base/image/compv_image_scale_bilinear.cxx,
compv_image_scale_bicubic.cxx, driven by CompVImage::scale
(base/image/compv_image.cxx:852). The reference splits rows across the
thread pool and uses fixed-point sample weights; here a scale is a pair of
gathers + lerps over the whole image, fused by XLA — one kernel, no tiling
logic needed (memory-bandwidth bound, same as the reference's roofline).

Sample-position convention: half-pixel centers (dst x maps to
(x+0.5)*sx - 0.5), matching OpenCV/the reference's visual behavior.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["scale", "scale_bilinear", "scale_bicubic", "scale_nearest",
           "rotate_bilinear", "rotate_fast"]


def _src_coords(dst_n: int, src_n: int):
    s = src_n / dst_n
    x = (jnp.arange(dst_n, dtype=jnp.float32) + 0.5) * s - 0.5
    return x


def scale_nearest(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    h, w = img.shape[:2]
    ys = jnp.clip(jnp.round(_src_coords(out_h, h)).astype(jnp.int32), 0, h - 1)
    xs = jnp.clip(jnp.round(_src_coords(out_w, w)).astype(jnp.int32), 0, w - 1)
    return img[ys][:, xs]


_BILINEAR_BITS = 11   # fixed-point weight precision of the u8 path


def _bilinear_taps(dst_n: int, src_n: int):
    """Host-side (numpy) source taps and Q11 weights of one axis:
    (i0, i1, w1) with w1 in [0, 2048] the weight of i1."""
    one = 1 << _BILINEAR_BITS
    x = np.clip((np.arange(dst_n) + 0.5) * (src_n / dst_n) - 0.5,
                0.0, src_n - 1.0)
    i0 = np.floor(x).astype(np.int32)
    i1 = np.minimum(i0 + 1, src_n - 1)
    w1 = np.round((x - i0) * one).astype(np.int32)
    return i0, i1, w1


def scale_bilinear(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """(H,W[,C]) u8/f32 -> (out_h,out_w[,C]) same dtype.

    Integer images interpolate in fixed point, like the reference's
    fixed-point sample weights: Q11 weights from host-side tables and int32
    sums (255 * 2^11 * 2^11 < 2^31) rounded half up — the same bytes on
    every backend. Float images interpolate in f32."""
    h, w = img.shape[:2]
    dtype = img.dtype
    if jnp.issubdtype(dtype, jnp.integer):
        y0, y1, wy = _bilinear_taps(out_h, h)
        x0, x1, wx = _bilinear_taps(out_w, w)
        one = 1 << _BILINEAR_BITS
        wy, wx = wy[:, None], wx[None, :]
        if img.ndim == 3:
            wy, wx = wy[..., None], wx[..., None]
        f = img.astype(jnp.int32)
        top = f[y0][:, x0] * (one - wx) + f[y0][:, x1] * wx
        bot = f[y1][:, x0] * (one - wx) + f[y1][:, x1] * wx
        out = top * (one - wy) + bot * wy
        out = (out + (1 << (2 * _BILINEAR_BITS - 1))) >> (2 * _BILINEAR_BITS)
        return jnp.clip(out, 0, 255).astype(dtype)

    f = img.astype(jnp.float32)
    yf = jnp.clip(_src_coords(out_h, h), 0.0, h - 1.0)
    xf = jnp.clip(_src_coords(out_w, w), 0.0, w - 1.0)
    y0 = jnp.floor(yf).astype(jnp.int32)
    x0 = jnp.floor(xf).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    wy = (yf - y0)[:, None]
    wx = (xf - x0)[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]

    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(dtype)


def _cubic_weights(t: jax.Array, a: float = -0.5):
    """Keys cubic kernel weights for fractional offset t in [0,1), for taps
    at offsets {-1, 0, 1, 2} (reference uses the same Catmull-Rom-style
    kernel, compv_image_scale_bicubic.cxx)."""
    t2 = t * t
    t3 = t2 * t
    w0 = a * (t3 - 2 * t2 + t)
    w1 = (a + 2) * t3 - (a + 3) * t2 + 1
    w2 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w3 = a * (-t3 + t2)
    return w0, w1, w2, w3


def scale_bicubic(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    h, w = img.shape[:2]
    dtype = img.dtype
    f = img.astype(jnp.float32)

    yf = jnp.clip(_src_coords(out_h, h), 0.0, h - 1.0)
    xf = jnp.clip(_src_coords(out_w, w), 0.0, w - 1.0)
    y0 = jnp.floor(yf).astype(jnp.int32)
    x0 = jnp.floor(xf).astype(jnp.int32)
    ty = yf - y0
    tx = xf - x0

    wys = _cubic_weights(ty)
    wxs = _cubic_weights(tx)

    def row_tap(dy, i):
        yi = jnp.clip(y0 + dy, 0, h - 1)
        rows = f[yi]  # (out_h, w[,C])
        acc = None
        for dx, wx in zip((-1, 0, 1, 2), wxs):
            xi = jnp.clip(x0 + dx, 0, w - 1)
            v = rows[:, xi]
            wxe = wx[None, :, None] if img.ndim == 3 else wx[None, :]
            acc = v * wxe if acc is None else acc + v * wxe
        return acc

    out = None
    for dy, wy in zip((-1, 0, 1, 2), wys):
        v = row_tap(dy, None)
        wye = wy[:, None, None] if img.ndim == 3 else wy[:, None]
        out = v * wye if out is None else out + v * wye

    if jnp.issubdtype(dtype, jnp.integer):
        out = jnp.clip(jnp.round(out), 0, 255)
    return out.astype(dtype)


def scale(img: jax.Array, out_h: int, out_w: int,
          interpolation: str = "bilinear") -> jax.Array:
    """Facade matching CompVImage::scale (base/image/compv_image.cxx:852)."""
    if interpolation == "bilinear":
        return scale_bilinear(img, out_h, out_w)
    if interpolation == "bicubic":
        return scale_bicubic(img, out_h, out_w)
    if interpolation == "nearest":
        return scale_nearest(img, out_h, out_w)
    raise ValueError(f"unknown interpolation {interpolation!r}")


@partial(jax.jit, static_argnames=())
def rotate_bilinear(img: jax.Array, angle_deg: jax.Array) -> jax.Array:
    """Rotate about image center with bilinear sampling (reference rotate
    benchmark speed_compare:96-101 implemented via warp)."""
    from compv_tpu.image.remap import warp_affine
    h, w = img.shape[:2]
    th = jnp.deg2rad(angle_deg)
    c, s = jnp.cos(th), jnp.sin(th)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    # dst->src affine
    m = jnp.array([[1, 0, 0], [0, 1, 0]], jnp.float32)
    rot = jnp.stack([jnp.stack([c, s, cx - c * cx - s * cy]),
                     jnp.stack([-s, c, cy + s * cx - c * cy])])
    return warp_affine(img, rot, h, w)


def _roll_lines(x: jax.Array, shifts: jax.Array, axis: int) -> jax.Array:
    """Roll each line of a 2-D array along ``axis`` by its own amount
    (shifts left/up by shifts[i], one entry per line of the OTHER axis).

    A per-line variable roll without a per-pixel gather is a barrel
    shifter: log2(n) uniform rolls, each applied only to the
    lines whose shift has that bit set (select). Wraparound is the caller's
    responsibility (pad with enough zeros)."""
    n = x.shape[axis]
    shifts = jnp.mod(shifts.astype(jnp.int32), n)
    nbits = max(int(np.ceil(np.log2(n))), 1)
    mask_shape = (-1, 1) if axis == 1 else (1, -1)
    for b in range(nbits):
        bit = 1 << b
        rolled = jnp.roll(x, -bit, axis=axis)
        take = ((shifts >> b) & 1) == 1
        x = jnp.where(take.reshape(mask_shape), rolled, x)
    return x


def _shear(x: jax.Array, factor: jax.Array, axis: int) -> jax.Array:
    """Sub-pixel shear about the canvas center: content of line i (along the
    other axis) MOVES by +factor * (i - center) along ``axis``, i.e.
    out[i, c] = in[i, c - factor*(i-center)]. Linear interpolation = lerp
    between the integer roll and the integer roll + 1."""
    other = 1 - axis
    n_lines = x.shape[other]
    center = (n_lines - 1) / 2.0
    # roll left by -move so the content shifts right by +move
    t = -factor * (jnp.arange(n_lines, dtype=jnp.float32) - center)
    k = jnp.floor(t)
    f = (t - k).astype(jnp.float32)
    a = _roll_lines(x, k.astype(jnp.int32), axis)
    b = jnp.roll(a, -1, axis=axis)
    fm = f.reshape((-1, 1) if axis == 1 else (1, -1))
    return a * (1.0 - fm) + b * fm


def rotate_fast(img: jax.Array, angle_deg: jax.Array) -> jax.Array:
    """Rotation by three shears (Paeth 1986) on an expanded canvas — a
    gather-free rotation: only uniform rolls + selects + lerps.

    rotate(a) = shear_x(-tan(a/2)) . shear_y(sin(a)) . shear_x(-tan(a/2)),
    each shear a per-line sub-pixel translation (see _shear). Quality is
    equivalent to bilinear warping (three 1-D lerps instead of one 2-D).
    ``angle_deg`` must be in [-45, 45] as a traced value; combine with exact
    jnp.rot90 for larger angles (rotate_bilinear stays the arbitrary-angle
    gather-based reference). Returns the (S, S) canvas holding the full
    rotated image, f32."""
    h, w = img.shape
    s_can = int(np.ceil(1.5 * float(np.hypot(h, w)))) // 2 * 2
    f = img.astype(jnp.float32)
    py = (s_can - h) // 2
    px = (s_can - w) // 2
    canvas = jnp.pad(f, ((py, s_can - h - py), (px, s_can - w - px)))

    th = jnp.deg2rad(angle_deg.astype(jnp.float32))
    alpha = -jnp.tan(th / 2.0)
    beta = jnp.sin(th)
    canvas = _shear(canvas, alpha, axis=1)
    canvas = _shear(canvas, beta, axis=0)
    canvas = _shear(canvas, alpha, axis=1)
    return canvas
