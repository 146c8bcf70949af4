"""Live streaming viewer — the headless-host analogue of the reference's
windowed demo loop.

Reference: the drawing layer runs camera -> process -> GL window at frame
rate behind an event loop (drawing/compv_drawing.cxx:74-90 event pump;
drawing/compv_drawing_window_sdl.cxx / gl/compv_gl_window.cxx surfaces).
A headless compute host has no display server, so the equivalent surface here is a
browser: an MJPEG (multipart/x-mixed-replace) HTTP endpoint that any
browser or `ffplay http://host:port/` renders as live video, fed by the
same start/stop camera lifecycle (io/camera.py) the reference's capture
plugins expose.

    cam = SyntheticCamera(fps=30)
    with MjpegServer(port=8080) as srv:
        run_live(cam, process=my_annotate_fn, server=srv, seconds=30)

`run_live` IS the event loop: the camera thread delivers frames via the
OnNewFrame callback, `process` runs the (jitted) pipeline + host-side
annotation, and the latest annotated frame is handed to the server; slow
consumers never block the pipeline (frames are dropped, matching how a
real-time window drops to vsync).
"""
from __future__ import annotations

import io
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

__all__ = ["MjpegServer", "run_live"]

_BOUNDARY = b"compvframe"


class MjpegServer:
    """Minimal MJPEG-over-HTTP server. `push(frame)` replaces the latest
    frame (u8 gray (H, W) or RGB (H, W, 3)); every connected client
    receives it on its next poll. Stats: .frames_pushed, .clients."""

    def __init__(self, port: int = 8080, host: str = "127.0.0.1",
                 quality: int = 85):
        self._latest: Optional[bytes] = None
        self._seq = 0
        self._cond = threading.Condition()
        self.frames_pushed = 0
        self.clients = 0
        self.quality = quality
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/snapshot":
                    jpg = outer._wait_jpeg(None)
                    if jpg is None:
                        self.send_error(503, "no frame yet")
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpg)))
                    self.end_headers()
                    self.wfile.write(jpg)
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    f"multipart/x-mixed-replace; boundary={_BOUNDARY.decode()}")
                self.end_headers()
                with outer._cond:
                    outer.clients += 1
                last_seq = -1
                try:
                    while True:
                        jpg, last_seq = outer._next_jpeg(last_seq)
                        if jpg is None:
                            return
                        self.wfile.write(
                            b"--" + _BOUNDARY + b"\r\n"
                            b"Content-Type: image/jpeg\r\n"
                            b"Content-Length: " +
                            str(len(jpg)).encode() + b"\r\n\r\n")
                        self.wfile.write(jpg + b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return
                finally:
                    with outer._cond:
                        outer.clients -= 1

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._stopped = False

    # ---- producer side
    def push(self, frame: np.ndarray) -> None:
        from PIL import Image
        frame = np.ascontiguousarray(frame, np.uint8)
        img = Image.fromarray(frame if frame.ndim == 3 else frame,
                              mode="RGB" if frame.ndim == 3 else "L")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=self.quality)
        with self._cond:
            self._latest = buf.getvalue()
            self._seq += 1
            self.frames_pushed += 1
            self._cond.notify_all()

    # ---- consumer side
    def _wait_jpeg(self, timeout):
        with self._cond:
            if self._latest is None:
                self._cond.wait(timeout=timeout or 2.0)
            return self._latest

    def _next_jpeg(self, last_seq):
        with self._cond:
            while self._seq == last_seq and not self._stopped:
                self._cond.wait(timeout=0.5)
            if self._stopped:
                return None, last_seq
            return self._latest, self._seq

    # ---- lifecycle
    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stopped = True
        with self._cond:
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def run_live(camera, process: Callable[[np.ndarray], np.ndarray],
             server: MjpegServer, seconds: float | None = None,
             max_frames: int | None = None) -> dict:
    """The demo event loop: camera frames -> `process` (pipeline +
    annotation, returns a displayable u8 array) -> streaming window.
    Returns run stats {frames, fps}. Stops after `seconds`/`max_frames`
    or camera exhaustion, then stops the camera (reference lifecycle:
    CompVDrawing::runLoop drives capture start/stop the same way)."""
    done = threading.Event()
    stats = {"frames": 0}
    t0 = time.perf_counter()

    def on_frame(frame):
        out = process(frame)
        server.push(out)
        stats["frames"] += 1
        if max_frames is not None and stats["frames"] >= max_frames:
            done.set()
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            done.set()

    camera.set_callback(on_frame)
    camera.start()
    try:
        deadline = None if seconds is None else t0 + seconds
        # wake on EITHER the frame-count/deadline signal or the camera's
        # capture loop exiting (file/synthetic cameras exhaust)
        while not done.is_set() and not camera.finished.is_set():
            step = 0.1 if deadline is None else \
                max(0.0, min(0.1, deadline - time.perf_counter()))
            if deadline is not None and step <= 0.0:
                break
            done.wait(timeout=step)
    finally:
        camera.stop()
    dt = max(time.perf_counter() - t0, 1e-9)
    stats["fps"] = stats["frames"] / dt
    return stats
