"""EXIF reader tests (reference vendors easyexif for its IO layer).

Fixtures are synthesized byte-exact TIFF/APP1 blobs, so the test is
self-contained (no binary files in-repo, same policy as conftest images).
"""
import struct

import numpy as np
import pytest

from compv_tpu.io.exif import (
    ExifData, orientation_to_transform, parse_tiff, read_exif,
)


def _rational(n, d):
    return struct.pack("<II", n, d)


def _build_tiff():
    """Little-endian TIFF with IFD0 (make/model/orientation + EXIF/GPS
    pointers), an EXIF sub-IFD and a GPS IFD."""
    # layout: header(8) | ifd0 | exif_ifd | gps_ifd | data area
    def entry(tag, typ, count, value_bytes, data_area, data_base):
        if len(value_bytes) <= 4:
            return struct.pack("<HHI", tag, typ, count) + value_bytes.ljust(4, b"\0")
        off = data_base + len(data_area)
        data_area += value_bytes
        return struct.pack("<HHI", tag, typ, count) + struct.pack("<I", off), data_area

    # precompute section offsets
    n_ifd0, n_exif, n_gps = 5, 5, 5
    ifd0_off = 8
    exif_off = ifd0_off + 2 + 12 * n_ifd0 + 4
    gps_off = exif_off + 2 + 12 * n_exif + 4
    data_base = gps_off + 2 + 12 * n_gps + 4

    data = b""
    entries0 = []
    make = b"AcmeCam\0"
    e = entry(0x010F, 2, len(make), make, data, data_base)
    e, data = e if isinstance(e, tuple) else (e, data)
    entries0.append(e)
    model = b"Model-1\0"
    e = entry(0x0110, 2, len(model), model, data, data_base)
    e, data = e if isinstance(e, tuple) else (e, data)
    entries0.append(e)
    entries0.append(struct.pack("<HHI", 0x0112, 3, 1) + struct.pack("<HH", 6, 0))
    entries0.append(struct.pack("<HHI", 0x8769, 4, 1) + struct.pack("<I", exif_off))
    entries0.append(struct.pack("<HHI", 0x8825, 4, 1) + struct.pack("<I", gps_off))

    entries_exif = []
    e = entry(0x829A, 5, 1, _rational(1, 250), data, data_base)  # exposure 1/250
    e, data = e if isinstance(e, tuple) else (e, data)
    entries_exif.append(e)
    e = entry(0x920A, 5, 1, _rational(35, 1), data, data_base)   # focal 35mm
    e, data = e if isinstance(e, tuple) else (e, data)
    entries_exif.append(e)
    entries_exif.append(struct.pack("<HHI", 0x8827, 3, 1) + struct.pack("<HH", 200, 0))
    entries_exif.append(struct.pack("<HHI", 0xA002, 4, 1) + struct.pack("<I", 1282))
    entries_exif.append(struct.pack("<HHI", 0xA003, 4, 1) + struct.pack("<I", 720))

    entries_gps = []
    entries_gps.append(struct.pack("<HHI", 0x0001, 2, 2) + b"N\0\0\0")
    e = entry(0x0002, 5, 3,
              _rational(48, 1) + _rational(51, 1) + _rational(2979, 100),
              data, data_base)
    e, data = e if isinstance(e, tuple) else (e, data)
    entries_gps.append(e)
    entries_gps.append(struct.pack("<HHI", 0x0003, 2, 2) + b"E\0\0\0")
    e = entry(0x0004, 5, 3,
              _rational(2, 1) + _rational(17, 1) + _rational(4020, 100),
              data, data_base)
    e, data = e if isinstance(e, tuple) else (e, data)
    entries_gps.append(e)
    e = entry(0x0006, 5, 1, _rational(3500, 100), data, data_base)
    e, data = e if isinstance(e, tuple) else (e, data)
    entries_gps.append(e)

    def ifd(entries):
        return struct.pack("<H", len(entries)) + b"".join(entries) + b"\0\0\0\0"

    tiff = (b"II" + struct.pack("<HI", 42, ifd0_off)
            + ifd(entries0) + ifd(entries_exif) + ifd(entries_gps) + data)
    return tiff


def test_parse_tiff_fields():
    ex = parse_tiff(_build_tiff())
    assert ex.make == "AcmeCam"
    assert ex.model == "Model-1"
    assert ex.orientation == 6
    assert ex.iso == 200
    assert ex.pixel_width == 1282 and ex.pixel_height == 720
    assert ex.exposure_time == pytest.approx(1 / 250)
    assert ex.focal_length_mm == pytest.approx(35.0)
    assert ex.gps_latitude == pytest.approx(48 + 51 / 60 + 29.79 / 3600, abs=1e-6)
    assert ex.gps_longitude == pytest.approx(2 + 17 / 60 + 40.20 / 3600, abs=1e-6)
    assert ex.gps_altitude == pytest.approx(35.0)


def test_read_exif_from_jpeg(tmp_path):
    tiff = _build_tiff()
    app1 = b"Exif\x00\x00" + tiff
    jpeg = (b"\xff\xd8"                                   # SOI
            + b"\xff\xe0" + struct.pack(">H", 18) + b"JFIF\0" + b"\0" * 11
            + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1
            + b"\xff\xda" + struct.pack(">H", 4) + b"\0\0"  # SOS stops scan
            + b"\xff\xd9")
    p = tmp_path / "x.jpg"
    p.write_bytes(jpeg)
    ex = read_exif(str(p))
    assert ex.model == "Model-1" and ex.orientation == 6


def test_no_exif_returns_defaults(tmp_path):
    p = tmp_path / "plain.jpg"
    p.write_bytes(b"\xff\xd8\xff\xda" + struct.pack(">H", 4) + b"\0\0\xff\xd9")
    ex = read_exif(str(p))
    assert isinstance(ex, ExifData) and ex.orientation == 1
    p2 = tmp_path / "not_a.jpg"
    p2.write_bytes(b"hello world")
    assert read_exif(str(p2)).make == ""


def test_orientation_transform_roundtrip():
    """Applying the transform to a rotated image recovers the upright one."""
    img = np.arange(12).reshape(3, 4)
    # orientation 6 = camera rotated: stored image is upright rotated CW 90;
    # transform says rot90 k=3 (i.e. rotate CCW 270 == CW 90... verify inverse)
    k, flip = orientation_to_transform(6)
    stored = np.rot90(img, 1)   # what a "rotate 90 CW to view" file stores
    up = np.rot90(stored, k)
    if flip:
        up = up[:, ::-1]
    assert up.shape == img.shape
    np.testing.assert_array_equal(up, img)
    k, flip = orientation_to_transform(1)
    assert k == 0 and not flip
    k, flip = orientation_to_transform(3)
    np.testing.assert_array_equal(np.rot90(np.rot90(img, 2), k), img)
