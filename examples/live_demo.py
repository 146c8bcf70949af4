"""Live demo loop: camera -> ORB detect -> annotated live stream.

The reference's flagship demos open an SDL/GL window and render the
processed camera feed at frame rate (drawing/compv_drawing_window_sdl.cxx,
samples in the reference tree); on a headless host the window is a
browser pointed at the MJPEG endpoint this script serves.

    python examples/live_demo.py [--seconds 30] [--port 8080]

then open http://127.0.0.1:8080/ (or /snapshot for a single frame).
"""
import argparse
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from compv_tpu.features.orb import OrbConfig, orb_detect_describe
from compv_tpu.io.camera import SyntheticCamera
from compv_tpu.viz import MjpegServer, draw_keypoints, draw_text, run_live


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--fps", type=float, default=15.0)
    args = ap.parse_args()

    cfg = OrbConfig(max_features=256, levels=3)
    state = {"n": 0}

    def process(frame: np.ndarray) -> np.ndarray:
        res = orb_detect_describe(jnp.asarray(frame), cfg)
        out = draw_keypoints(frame, res.keypoints)
        state["n"] += 1
        return draw_text(out, 4, 4,
                         f"frame {state['n']}  "
                         f"kp {int(res.keypoints.valid.sum())}")

    cam = SyntheticCamera(width=640, height=480, fps=args.fps)
    with MjpegServer(port=args.port) as srv:
        print(f"live stream on http://127.0.0.1:{srv.port}/ "
              f"for {args.seconds:.0f}s ...", flush=True)
        stats = run_live(cam, process, srv, seconds=args.seconds)
    print(f"done: {stats['frames']} frames at {stats['fps']:.1f} fps")


if __name__ == "__main__":
    main()
