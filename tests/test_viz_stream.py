"""Live streaming viewer tests: the headless analogue of the reference's
windowed demo loop (drawing/compv_drawing.cxx event pump ->
viz/stream.run_live; SDL window -> MJPEG endpoint)."""
import io
import urllib.request

import numpy as np

from compv_tpu.io.camera import SyntheticCamera
from compv_tpu.viz.stream import MjpegServer, run_live


def _read_mjpeg_parts(resp, n):
    """Parse n JPEG parts from a multipart/x-mixed-replace stream."""
    parts = []
    buf = b""
    while len(parts) < n:
        chunk = resp.fp.read1(65536)   # return whatever is available
        if not chunk:
            break
        buf += chunk
        while True:
            start = buf.find(b"\xff\xd8")      # JPEG SOI
            end = buf.find(b"\xff\xd9")        # JPEG EOI
            if start == -1 or end == -1 or end < start:
                break
            parts.append(buf[start:end + 2])
            buf = buf[end + 2:]
            if len(parts) >= n:
                break
    return parts


class TestMjpegServer:
    def test_snapshot_and_stream(self):
        with MjpegServer(port=0) as srv:
            frame = np.zeros((48, 64), np.uint8)
            frame[10:30, 20:40] = 255
            srv.push(frame)
            url = f"http://127.0.0.1:{srv.port}"
            jpg = urllib.request.urlopen(f"{url}/snapshot", timeout=5).read()
            assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"
            from PIL import Image
            img = np.asarray(Image.open(io.BytesIO(jpg)))
            assert img.shape[:2] == (48, 64)
            assert img[20, 30] > 200 and img[5, 5] < 50

            # live stream: the handler sends the current frame on connect;
            # read it, then push a new one and read that (two pushes
            # back-to-back can coalesce into one latest-frame update —
            # deliberate drop-to-latest window semantics)
            resp = urllib.request.urlopen(url + "/", timeout=30)
            parts = _read_mjpeg_parts(resp, 1)
            srv.push(255 - frame)
            parts += _read_mjpeg_parts(resp, 1)
            assert len(parts) == 2
            for p in parts:
                assert p[:2] == b"\xff\xd8"
        assert srv.frames_pushed == 2

    def test_run_live_event_loop(self):
        """The demo loop: synthetic camera -> process -> stream, bounded
        by max_frames; the camera is stopped on exit (reference
        CompVDrawing::runLoop lifecycle)."""
        cam = SyntheticCamera(width=96, height=64, fps=60.0)
        seen = []

        def process(frame):
            seen.append(frame.shape)
            return 255 - frame          # trivial annotation

        with MjpegServer(port=0) as srv:
            stats = run_live(cam, process, srv, seconds=5.0, max_frames=5)
            assert stats["frames"] >= 5
            assert srv.frames_pushed >= 5
            jpg = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/snapshot", timeout=5).read()
            assert jpg[:2] == b"\xff\xd8"
        assert all(s == (64, 96) for s in seen)
        assert not cam._running.is_set()

    def test_run_live_stops_on_camera_exhaustion(self):
        """A finite camera (n_frames) must end run_live even with no
        seconds/max_frames bound."""
        import time as _time
        cam = SyntheticCamera(width=32, height=24, fps=200.0, n_frames=4)
        with MjpegServer(port=0) as srv:
            t0 = _time.perf_counter()
            stats = run_live(cam, lambda f: f, srv)
            assert _time.perf_counter() - t0 < 5.0
        assert stats["frames"] == 4
        assert cam.finished.is_set()

    def test_v4l2_graceful_without_hardware(self):
        """The V4L2 backend must degrade cleanly on camera-less hosts:
        list_devices() omits unopenable nodes; start() raises CameraError
        (not a bare OSError) with actionable text."""
        from compv_tpu.io.camera import CameraError, V4l2Camera, list_devices
        devs = list_devices()
        assert "synthetic:checkerboard" in devs
        assert all(not d.startswith("v4l2:") or d[5:].startswith("/dev/")
                   for d in devs)
        import os
        if not any(d.startswith("v4l2:") for d in devs):
            cam = V4l2Camera("/dev/video0")
            import pytest as _pytest
            with _pytest.raises(CameraError):
                cam.start()
            assert cam._fd is None and not cam._maps
