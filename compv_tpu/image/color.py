"""Color-space conversion.

Covers the reference's conversion family (base/image/compv_image_conv_*.cxx):
any->grayscale, RGB<->YUV (NV12/NV21/I420/I422/I444/YUYV/UYVY), RGB->HSV,
channel split/merge. The reference implements these as per-ISA SIMD kernels
with fixed-point coefficients (base/image/compv_image_conv_common.cxx:29-41,
:196-215); here each conversion is a single fused element-wise XLA program
using the *same* fixed-point arithmetic so u8 outputs are bit-exact with the
reference:

    Y = ((33R + 65G + 13B) >> 7) + 16
    U = ((-38R - 74G + 112B) >> 8) + 128
    V = ((112R - 94G - 18B) >> 8) + 128
    R = (37Y' +  0U' +  51V') >> 5      (Y'=Y-16, U'=U-128, V'=V-128)
    G = (37Y' - 13U' -  26V') >> 5
    B = (37Y' + 65U' +   0V') >> 5

Images are channel-last arrays: gray (H,W) u8, RGB (H,W,3) u8. Planar YUV is
passed as separate plane arrays (XLA has no notion of strided multi-plane
buffers; planes as arrays is the natural representation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "rgb_to_gray", "bgr_to_gray", "rgba_to_gray",
    "rgb_to_yuv444", "yuv_to_rgb", "i420_to_rgb", "nv12_to_rgb",
    "nv21_to_rgb", "yuyv_to_rgb", "uyvy_to_rgb", "i422_to_rgb",
    "rgb_to_i420", "rgb_to_hsv", "yuv444_to_hsv",
    "split_channels", "merge_channels", "to_gray", "rgb_to_hsl",
    "rgb565_to_rgb", "rgb_to_rgb565",
]


def _i32(x):
    return x.astype(jnp.int32)


def _sra(x, n):
    """Arithmetic shift right, matching C's ``>>`` on negative ints."""
    return jax.lax.shift_right_arithmetic(x, jnp.int32(n))


def _clamp_u8(x):
    return jnp.clip(x, 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------- to gray

def rgb_to_gray(rgb: jax.Array) -> jax.Array:
    """(H,W,3) u8 RGB -> (H,W) u8 luma. Fixed-point per
    compv_image_conv_common.cxx:29-31 (Y = ((33R+65G+13B)>>7)+16)."""
    r, g, b = _i32(rgb[..., 0]), _i32(rgb[..., 1]), _i32(rgb[..., 2])
    y = _sra(33 * r + 65 * g + 13 * b, 7) + 16
    return _clamp_u8(y)


def bgr_to_gray(bgr: jax.Array) -> jax.Array:
    return rgb_to_gray(bgr[..., ::-1])


def rgba_to_gray(rgba: jax.Array) -> jax.Array:
    return rgb_to_gray(rgba[..., :3])


def to_gray(img: jax.Array) -> jax.Array:
    """Any->gray facade (reference CompVImage::convertGrayscale,
    base/image/compv_image.cxx:687): channel-last u8 in, (H,W) u8 out."""
    if img.ndim == 2:
        return img.astype(jnp.uint8)
    c = img.shape[-1]
    if c == 3:
        return rgb_to_gray(img)
    if c == 4:
        return rgba_to_gray(img)
    raise ValueError(f"unsupported channel count {c}")


# ---------------------------------------------------------------- RGB -> YUV

def rgb_to_yuv444(rgb: jax.Array):
    """(H,W,3) u8 -> (Y,U,V) planes, each (H,W) u8
    (coefficients compv_image_conv_common.cxx:29-41)."""
    r, g, b = _i32(rgb[..., 0]), _i32(rgb[..., 1]), _i32(rgb[..., 2])
    y = _sra(33 * r + 65 * g + 13 * b, 7) + 16
    u = _sra(-38 * r - 74 * g + 112 * b, 8) + 128
    v = _sra(112 * r - 94 * g - 18 * b, 8) + 128
    return _clamp_u8(y), _clamp_u8(u), _clamp_u8(v)


def rgb_to_i420(rgb: jax.Array):
    """(H,W,3) u8 -> I420 planes: Y (H,W), U/V (H/2,W/2). Chroma is the
    top-left sample of each 2x2 block (the reference subsamples, it does not
    average — compv_image_conv_to_yuv444p.cxx family)."""
    y, u, v = rgb_to_yuv444(rgb)
    return y, u[::2, ::2], v[::2, ::2]


# ---------------------------------------------------------------- YUV -> RGB

def yuv_to_rgb(y: jax.Array, u: jax.Array, v: jax.Array) -> jax.Array:
    """Full-res Y/U/V planes (H,W) u8 -> (H,W,3) u8 RGB. Fixed-point per
    compv_image_conv_common.cxx:196-215."""
    yp = _i32(y) - 16
    up = _i32(u) - 128
    vp = _i32(v) - 128
    t = 37 * yp
    r = _sra(t + 51 * vp, 5)
    g = _sra(t - 13 * up - 26 * vp, 5)
    b = _sra(t + 65 * up, 5)
    return jnp.stack([_clamp_u8(r), _clamp_u8(g), _clamp_u8(b)], axis=-1)


def _upsample2(p: jax.Array, h: int, w: int) -> jax.Array:
    """Nearest 2x chroma upsample to (h, w)."""
    q = jnp.repeat(p, 2, axis=0)[:h]
    return jnp.repeat(q, 2, axis=1)[:, :w]


def i420_to_rgb(y: jax.Array, u: jax.Array, v: jax.Array) -> jax.Array:
    h, w = y.shape
    return yuv_to_rgb(y, _upsample2(u, h, w), _upsample2(v, h, w))


def nv12_to_rgb(y: jax.Array, uv: jax.Array) -> jax.Array:
    """NV12: interleaved UV plane (H/2, W/2, 2) or (H/2, W) with U first."""
    if uv.ndim == 2:
        uv = uv.reshape(uv.shape[0], uv.shape[1] // 2, 2)
    h, w = y.shape
    return yuv_to_rgb(y, _upsample2(uv[..., 0], h, w), _upsample2(uv[..., 1], h, w))


def nv21_to_rgb(y: jax.Array, vu: jax.Array) -> jax.Array:
    if vu.ndim == 2:
        vu = vu.reshape(vu.shape[0], vu.shape[1] // 2, 2)
    h, w = y.shape
    return yuv_to_rgb(y, _upsample2(vu[..., 1], h, w), _upsample2(vu[..., 0], h, w))


def i422_to_rgb(y: jax.Array, u: jax.Array, v: jax.Array) -> jax.Array:
    """I422: U/V are (H, W/2)."""
    h, w = y.shape
    return yuv_to_rgb(y, jnp.repeat(u, 2, axis=1)[:, :w],
                      jnp.repeat(v, 2, axis=1)[:, :w])


def yuyv_to_rgb(yuyv: jax.Array) -> jax.Array:
    """Packed YUYV422 (H, W*2) u8 or (H, W/2, 4)."""
    if yuyv.ndim == 2:
        yuyv = yuyv.reshape(yuyv.shape[0], -1, 4)
    y = jnp.stack([yuyv[..., 0], yuyv[..., 2]], axis=-1).reshape(yuyv.shape[0], -1)
    u = yuyv[..., 1]
    v = yuyv[..., 3]
    return i422_to_rgb(y, u, v)


def uyvy_to_rgb(uyvy: jax.Array) -> jax.Array:
    if uyvy.ndim == 2:
        uyvy = uyvy.reshape(uyvy.shape[0], -1, 4)
    y = jnp.stack([uyvy[..., 1], uyvy[..., 3]], axis=-1).reshape(uyvy.shape[0], -1)
    u = uyvy[..., 0]
    v = uyvy[..., 2]
    return i422_to_rgb(y, u, v)


# ---------------------------------------------------------------- HSV

def rgb_to_hsv(rgb: jax.Array) -> jax.Array:
    """(H,W,3) u8 RGB -> (H,W,3) u8 HSV with OpenCV/compv u8 ranges:
    H in [0,180), S,V in [0,255] (reference compv_image_conv_hsv.cxx)."""
    rgbf = rgb.astype(jnp.float32)
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    v = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    c = v - mn
    s = jnp.where(v > 0, 255.0 * c / jnp.maximum(v, 1e-9), 0.0)
    safe_c = jnp.maximum(c, 1e-9)
    h = jnp.where(
        v == r, 30.0 * (g - b) / safe_c,
        jnp.where(v == g, 60.0 + 30.0 * (b - r) / safe_c,
                  120.0 + 30.0 * (r - g) / safe_c))
    h = jnp.where(c == 0, 0.0, jnp.where(h < 0, h + 180.0, h))
    return jnp.stack([
        jnp.clip(jnp.round(h), 0, 255).astype(jnp.uint8),
        jnp.clip(jnp.round(s), 0, 255).astype(jnp.uint8),
        jnp.clip(v, 0, 255).astype(jnp.uint8),
    ], axis=-1)


def yuv444_to_hsv(y: jax.Array, u: jax.Array, v: jax.Array) -> jax.Array:
    """Fused YUV->RGB->HSV (the reference ships a dedicated fused kernel;
    XLA fuses this chain automatically)."""
    return rgb_to_hsv(yuv_to_rgb(y, u, v))


def rgb_to_hsl(rgb: jax.Array) -> jax.Array:
    """(H,W,3) u8 RGB -> (H,W,3) u8 HSL, H in [0,180), S,L in [0,255]
    (reference supports HSL formats, compv_common.h:347-381)."""
    f = rgb.astype(jnp.float32) / 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    mx = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    c = mx - mn
    l = (mx + mn) * 0.5
    s = jnp.where(c == 0, 0.0,
                  c / jnp.maximum(1.0 - jnp.abs(2.0 * l - 1.0), 1e-9))
    safe_c = jnp.maximum(c, 1e-9)
    h = jnp.where(
        mx == r, 30.0 * (g - b) / safe_c,
        jnp.where(mx == g, 60.0 + 30.0 * (b - r) / safe_c,
                  120.0 + 30.0 * (r - g) / safe_c))
    h = jnp.where(c == 0, 0.0, jnp.where(h < 0, h + 180.0, h))
    return jnp.stack([
        jnp.clip(jnp.round(h), 0, 255).astype(jnp.uint8),
        jnp.clip(jnp.round(s * 255.0), 0, 255).astype(jnp.uint8),
        jnp.clip(jnp.round(l * 255.0), 0, 255).astype(jnp.uint8),
    ], axis=-1)


def rgb565_to_rgb(packed: jax.Array, little_endian: bool = True) -> jax.Array:
    """(H,W) u16 (or (H, W*2) u8 byte pairs) RGB565 -> (H,W,3) u8
    (reference rgb565le/be family kernels)."""
    if packed.dtype == jnp.uint8:
        lo = packed[..., 0::2].astype(jnp.uint16)
        hi = packed[..., 1::2].astype(jnp.uint16)
        v = (hi << 8) | lo if little_endian else (lo << 8) | hi
    else:
        v = packed.astype(jnp.uint16)
    r5 = (v >> 11) & 0x1F
    g6 = (v >> 5) & 0x3F
    b5 = v & 0x1F
    # expand with bit replication (standard 565 -> 888)
    r = ((r5 << 3) | (r5 >> 2)).astype(jnp.uint8)
    g = ((g6 << 2) | (g6 >> 4)).astype(jnp.uint8)
    b = ((b5 << 3) | (b5 >> 2)).astype(jnp.uint8)
    return jnp.stack([r, g, b], axis=-1)


def rgb_to_rgb565(rgb: jax.Array) -> jax.Array:
    """(H,W,3) u8 -> (H,W) u16 RGB565."""
    r = (rgb[..., 0].astype(jnp.uint16) >> 3) << 11
    g = (rgb[..., 1].astype(jnp.uint16) >> 2) << 5
    b = rgb[..., 2].astype(jnp.uint16) >> 3
    return r | g | b


# ---------------------------------------------------------------- split/merge

def split_channels(img: jax.Array):
    """(H,W,C) -> tuple of C (H,W) planes (reference image split benchmark,
    speed_compare:44-47)."""
    return tuple(img[..., i] for i in range(img.shape[-1]))


def merge_channels(*planes: jax.Array) -> jax.Array:
    return jnp.stack(planes, axis=-1)
