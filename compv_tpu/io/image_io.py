"""Image file IO (host-side).

Reference: CompVImage::read/decode (base/image/compv_image.cxx,
compv_image_decoder.cxx): raw .yuv/.rgb files with dimensions encoded in the
filename (e.g. equirectangular_1282x720_gray.yuv — tests_common.cxx:52-59),
plus jpeg via the drawing module's libjpeg hook.

Here: raw planar formats by filename convention, PNG/JPEG/BMP via PIL,
PGM/PPM natively. Decoding is host-side numpy (IO is not a device problem);
arrays feed straight into the jnp pipeline.
"""
from __future__ import annotations

import os
import re

import numpy as np

__all__ = ["read_image", "write_image", "read_raw", "write_raw",
           "parse_raw_filename"]

_RAW_RE = re.compile(r"(\d+)x(\d+)")


def parse_raw_filename(path: str):
    """Extract (width, height) from names like foo_1282x720_gray.yuv
    (the reference's fixture convention)."""
    m = _RAW_RE.search(os.path.basename(path))
    if not m:
        raise ValueError(f"no WxH in filename: {path}")
    return int(m.group(1)), int(m.group(2))


def read_raw(path: str, width: int | None = None, height: int | None = None,
             fmt: str | None = None) -> np.ndarray:
    """Read a raw image file. fmt inferred from extension/name when omitted:
    *gray*.yuv -> (H,W) u8; *.yuv (I420) -> (H,W) gray Y plane returned with
    chroma available via read_raw(..., fmt='i420') -> (y, u, v); *.rgb ->
    (H,W,3)."""
    if width is None or height is None:
        width, height = parse_raw_filename(path)
    data = np.fromfile(path, np.uint8)
    name = os.path.basename(path).lower()
    if fmt is None:
        if "gray" in name or len(data) == width * height:
            fmt = "gray"
        elif name.endswith(".rgb") or len(data) == width * height * 3:
            fmt = "rgb" if name.endswith(".rgb") else "i420x"
        else:
            fmt = "i420"
    if fmt == "gray":
        return data[: width * height].reshape(height, width)
    if fmt == "rgb":
        return data[: width * height * 3].reshape(height, width, 3)
    if fmt == "i420":
        y = data[: width * height].reshape(height, width)
        cw, ch = width // 2, height // 2
        off = width * height
        u = data[off: off + cw * ch].reshape(ch, cw)
        v = data[off + cw * ch: off + 2 * cw * ch].reshape(ch, cw)
        return y, u, v
    raise ValueError(f"unknown raw format {fmt}")


def write_raw(path: str, arr: np.ndarray) -> None:
    np.ascontiguousarray(arr).tofile(path)


def read_image(path: str) -> np.ndarray:
    """Decode PNG/JPEG/BMP/PGM/PPM (PIL) or raw by extension. Returns (H,W)
    gray u8 or (H,W,3) RGB u8."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".yuv", ".rgb", ".raw"):
        out = read_raw(path)
        return out if isinstance(out, np.ndarray) else out[0]
    from PIL import Image
    img = Image.open(path)
    if img.mode in ("L", "I;16"):
        return np.asarray(img.convert("L"), np.uint8)
    return np.asarray(img.convert("RGB"), np.uint8)


def write_image(path: str, arr: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".yuv", ".rgb", ".raw"):
        write_raw(path, arr)
        return
    from PIL import Image
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    Image.fromarray(a).save(path)
