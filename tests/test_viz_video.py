"""Video writer + bitmap text rendering.

Reference parity: core/video/compv_core_video_writer_ffmpeg.cxx (writer),
gl/compv_gl_freetype.cxx (text). Here: pipe-ffmpeg writer gated on the
binary, animated-GIF fallback, and a 5x7 bitmap font rasterizer.
"""
import os
import shutil

import numpy as np
import pytest

from compv_tpu.io.video import GifReader, GifWriter, open_writer, FfmpegWriter
from compv_tpu.viz import draw_boxes, draw_text, text_size


class TestGifWriter:
    def test_roundtrip(self, tmp_path):
        path = str(tmp_path / "clip.gif")
        frames = [np.full((16, 24, 3), 40 * i, np.uint8) for i in range(4)]
        with GifWriter(path, fps=10) as w:
            for f in frames:
                w.write(f)
        assert os.path.exists(path)
        rd = GifReader(path)
        got = list(rd)
        assert len(got) == 4
        assert got[0].shape == (16, 24, 3)

    def test_gray_promoted(self, tmp_path):
        path = str(tmp_path / "g.gif")
        with GifWriter(path) as w:
            w.write(np.zeros((8, 8), np.uint8))
        assert os.path.exists(path)


class TestOpenWriter:
    def test_fallback_without_ffmpeg(self, tmp_path):
        w = open_writer(str(tmp_path / "out.mp4"), 24, 16, fps=5)
        if shutil.which("ffmpeg") is None:
            assert isinstance(w, GifWriter)
            assert w.path.endswith(".gif")
        else:
            assert isinstance(w, FfmpegWriter)
        w.write(np.zeros((16, 24, 3), np.uint8))
        w.close()

    def test_explicit_gif(self, tmp_path):
        w = open_writer(str(tmp_path / "out.gif"), 24, 16)
        assert isinstance(w, GifWriter)
        w.close()

    def test_ffmpeg_gated(self):
        if shutil.which("ffmpeg") is None:
            with pytest.raises(RuntimeError):
                FfmpegWriter("/tmp/x.mp4", 8, 8)


class TestDrawText:
    def test_pixels_set(self):
        canvas = np.zeros((32, 128, 3), np.uint8)
        draw_text(canvas, 2, 2, "FAST9 1.7X", color=(255, 0, 0))
        assert (canvas[..., 0] == 255).sum() > 40
        assert (canvas[..., 1] == 0).all()

    def test_background_box(self):
        canvas = np.zeros((32, 128, 3), np.uint8)
        draw_text(canvas, 4, 4, "OK", color=(255, 255, 255),
                  background=(64, 64, 64))
        th, tw = text_size("OK")
        assert (canvas[4: 4 + th, 4: 4 + tw] != 0).any()
        assert (canvas[5, 5] == 64).all() or (canvas[5, 5] == 255).all()

    def test_clipping_no_crash(self):
        canvas = np.zeros((10, 10, 3), np.uint8)
        draw_text(canvas, -3, -3, "CLIP ME PLEASE", color=(1, 2, 3))
        draw_text(canvas, 8, 8, "EDGE", color=(1, 2, 3))

    def test_distinct_glyphs(self):
        a = np.zeros((10, 8, 3), np.uint8)
        b = np.zeros((10, 8, 3), np.uint8)
        draw_text(a, 0, 0, "0")
        draw_text(b, 0, 0, "8")
        assert (a != b).any()

    def test_scale(self):
        th1, tw1 = text_size("AB", scale=1)
        th2, tw2 = text_size("AB", scale=2)
        assert th2 == 2 * th1

    def test_labeled_boxes(self):
        img = np.zeros((64, 64), np.uint8)
        out = draw_boxes(img, [10], [20], [40], [50], labels=["BLOB 0"])
        assert (out != 0).any()
