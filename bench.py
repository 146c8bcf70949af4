"""Benchmark harness — the FULL suite vs the reference's speed_compare table.

Prints one JSON line per metric:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": ratio}
and a final summary line:
  {"metric": "suite_geomean_vs_reference", "value": G, ...}
vs_baseline is our fps / the reference's fps derived from BASELINE.md
(total_ms / reps on an i7-4790K @4GHz, 8 threads, AVX2+asm — the
reference's own published numbers, speed_compare:20-202).

Methodology: each metric loops ON DEVICE — a fori_loop with a data
dependency between iterations (input perturbed by the previous result)
runs the op R times inside one XLA program; per-frame time is the slope
(T(R2)-T(R1))/(R2-R1), which cancels host dispatch, the host round trip
that reads the result, and compile overhead. R2 is sized from a probe run
to target ~0.5 s of differential device time (capped at 1100 reps).
Median of 3 slopes (slope noise is two-sided; min would bias low). These
are kernel-layer rows: no host path is timed.

The first line names the device (platform, device_kind, count, and the
card's name and power limit). Without a GPU the harness stops before it
times anything.

Env:
  BENCH_METRICS=a,b    run only the named metrics
  BENCH_TARGET_DIFF=s  differential-time target per trial (default 0.5)
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

HEADLINE = "fast9_nms_detect_fps_1282x720"


def _images(h: int = 720, w: int = 1282, th: int = 1182, tw: int = 1122):
    """Synthetic fixtures. 1282x720 scene with a checkerboard (corners for
    FAST/ORB), plus a 1122x1182 'text' image matching the reference's CCL /
    MSER benchmark input (speed_compare:173-195 uses a text scan). Other
    sizes scale the checkerboard window with the frame."""
    rs = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 + 48 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0)
    ch = ((xx // 24).astype(int) + (yy // 24).astype(int)) % 2
    base = np.where((xx > w * 300 // 1282) & (xx < w * 1000 // 1282)
                    & (yy > h * 150 // 720) & (yy < h * 570 // 720),
                    ch * 200.0 + 20, base)
    gray = np.clip(base + rs.normal(0, 2.0, base.shape), 0, 255).astype(np.uint8)

    text = np.full((th, tw), 235, np.uint8)
    # glyph-like dark blobs: ~90 lines of ~40 "characters" of random strokes
    for row in range(20, th - 14, 13):
        for col in range(16, tw - 10, 28):
            if rs.random() < 0.15:
                continue
            gw = min(int(rs.integers(12, 22)), tw - 10 - col)
            gh = min(int(rs.integers(7, 10)), th - 14 - row)
            glyph = rs.random((gh, gw)) < 0.45
            # thicken horizontally so strokes connect like type
            glyph[:, 1:] |= glyph[:, :-1]
            text[row:row + gh, col:col + gw][glyph] = 20
    # realistic scan: antialias + sensor noise (a bimodal {20,235} image
    # lets MSER's content-adaptive ladder skip ~49 of 51 gray levels —
    # unfairly easy; the reference benchmarked a real text scan)
    from scipy import ndimage as _ndi
    text = np.clip(_ndi.gaussian_filter(text.astype(np.float32), 0.8)
                   + rs.normal(0, 3.0, text.shape), 0, 255).astype(np.uint8)
    return gray, text


def main():
    only = os.environ.get("BENCH_METRICS")
    only = set(only.split(",")) if only else None
    target_diff = float(os.environ.get("BENCH_TARGET_DIFF", "0.5"))

    import jax
    from compv_tpu.device import enable_compile_cache, gpu_info, require_gpu

    device = require_gpu()
    device["card"] = gpu_info()
    enable_compile_cache()
    print(json.dumps({"device": device}), flush=True)

    import jax.numpy as jnp
    from compv_tpu.features.canny import CannyConfig, canny
    from compv_tpu.features.ccl import (
        CclConfig, ccl_features_from_labels, label_components,
    )
    from compv_tpu.features.edges import edge_detect, sobel_gradients
    from compv_tpu.features.fast import _nms_f32, _strengths_f32
    from compv_tpu.features.hog import HogConfig, hog_descriptor
    from compv_tpu.features.hough import (
        HoughKhtConfig, HoughShtConfig, hough_kht, hough_sht,
    )
    from compv_tpu.features.mser import MserConfig, mser_detect
    from compv_tpu.image.color import (
        _upsample2, i420_to_rgb, rgb_to_gray, rgb_to_hsv, split_channels,
        yuv444_to_hsv,
    )
    from compv_tpu.image.histogram import equalize, histogram256
    from compv_tpu.image.integral import integral, integral_squared
    from compv_tpu.image.morph import close_, erode, strel
    from compv_tpu.image.scale import rotate_fast, scale
    from compv_tpu.image.threshold import (
        threshold_adaptive, threshold_otsu, threshold_wolf,
    )
    from compv_tpu.matchers.bruteforce import knn_match
    from compv_tpu.ops.conv import gaussian_blur
    from compv_tpu.ops.topk import select_top_k_2d

    gray_np, text_np = _images()
    h, w = gray_np.shape
    rs = np.random.default_rng(1)
    gray = jnp.asarray(gray_np)
    text = jnp.asarray(text_np)
    text_bin = jnp.asarray((text_np < 128).astype(np.uint8) * 255)
    rgb = jnp.asarray(np.stack([gray_np,
                                np.roll(gray_np, 3, 0),
                                np.roll(gray_np, 7, 1)], -1))
    u_p = jnp.asarray(rs.integers(0, 255, (h // 2, w // 2), dtype=np.uint8))
    v_p = jnp.asarray(rs.integers(0, 255, (h // 2, w // 2), dtype=np.uint8))
    descq = jnp.asarray(rs.integers(0, 2, (200, 256), dtype=np.uint8))
    desct = jnp.asarray(rs.integers(0, 2, (258, 256), dtype=np.uint8))
    descq_big = jnp.asarray(rs.integers(0, 2, (2048, 256), dtype=np.uint8))
    desct_big = jnp.asarray(rs.integers(0, 2, (2048, 256), dtype=np.uint8))
    se3 = strel("cross", 3)
    big_bin = jnp.asarray(rs.integers(0, 2, (1285, 1285), dtype=np.uint8) * 255)

    def u8sum(a):
        v = jnp.sum(a.astype(jnp.int32))
        return v.astype(jnp.float32), v

    def fsum(a):
        return jnp.sum(a.astype(jnp.float32)), jnp.int32(1)

    def match_sum(m):
        return (jnp.sum(jnp.where(m.valid, m.distance, 0.0)),
                jnp.sum(m.train_idx))

    def lines_sum(L):
        return jnp.sum(L.strength), jnp.sum(L.rho).astype(jnp.int32)

    # The reference's BF-matcher headline is 200x258 descriptors — far too
    # small to fill the device. The scaled 2048x2048 row uses the same
    # baseline expressed in descriptor-pairs/s: 200*258*1000 pairs / 0.260 s
    # = 198.5M pairs/s -> at 2048*2048 pairs/frame that is 47.32 frames/s.
    bf_big_ref_fps = (200 * 258 * 1000 / 0.260) / (2048 * 2048)

    # End-to-end frontend pair: the reference's
    # identity is a live pipeline (samples/object_recognition/main.cxx:
    # 92-220 — detect -> describe -> match -> homography per frame).
    # No end-to-end number is published, so the baseline is derived from
    # the reference's own component rows, CONSERVATIVELY (unpublished
    # stages — ORB describe, RANSAC — are excluded, which makes the
    # reference look faster than it is): 2 x FAST9 detect (0.3358 ms,
    # speed_compare:73-80) + KNN2 Hamming at 2000x2000 pairs scaled
    # linearly from the 200x258 row (198.5M pairs/s, speed_compare:
    # 135-140) = 20.15 ms -> 48.0 fps.
    frontend_ref_fps = 1.0 / (2 * 0.3358e-3 + (2000.0 * 2000.0)
                              / (200 * 258 * 1000 / 0.260))

    from compv_tpu.calib.homography import find_homography
    from compv_tpu.features.orb import OrbConfig, orb_detect_describe

    def frontend_pair(im):
        im2 = jnp.roll(im, (4, 7), (0, 1))
        cfg_orb = OrbConfig(max_features=2000)
        kp1, d1 = orb_detect_describe(im, cfg_orb)
        kp2, d2 = orb_detect_describe(im2, cfg_orb)
        m = knn_match(d1, d2, k=2)
        q = jnp.stack([kp1.x, kp1.y], 1)
        t = jnp.stack([kp2.x, kp2.y], 1)[m.train_idx[0]]
        res = find_homography(q, t, mask=m.valid[0] & kp1.valid)
        return (jnp.sum(jnp.where(jnp.isfinite(res.h), res.h, 0.0)),
                jnp.sum(res.inliers))

    # (name, input-to-perturb, fn(im) -> (f32 acc, int checksum), ref fps)
    # Each timed call ends by reading the scalar result on the host
    # (float(bench(...))), which waits for the device to finish.
    cases = [
        ("rgb24_to_gray", rgb,
         lambda im: u8sum(rgb_to_gray(im)), 10000 / 0.449),
        ("i420_to_rgb24", gray,
         lambda im: u8sum(i420_to_rgb(im, u_p, v_p)), 10000 / 0.968),
        ("rgb24_to_hsv", rgb,
         lambda im: u8sum(rgb_to_hsv(im)), 10000 / 2.137),
        # YUV420P->HSV: chroma upsample + fused YUV->RGB->HSV
        # (speed_compare:38-41: 3045 ms / 10k)
        ("yuv420p_to_hsv", gray,
         lambda im: u8sum(yuv444_to_hsv(im, _upsample2(u_p, h, w),
                                        _upsample2(v_p, h, w))),
         10000 / 3.045),
        ("split_rgb", rgb,
         lambda im: u8sum(split_channels(im)[0]), 10000 / 0.694),
        ("histogram_256", gray,
         lambda im: u8sum(histogram256(im)), 10000 / 1.073),
        ("hist_equalize", gray,
         lambda im: u8sum(equalize(im)), 10000 / 2.675),
        ("integral_sq", gray,
         lambda im: u8sum(integral(im, jnp.float32)[-1, -1:]
                          + integral_squared(im, jnp.float32)[-1, -1:]),
         1000 / 1.832),
        ("otsu_threshold", gray,
         lambda im: u8sum(threshold_otsu(im)[0]), 10000 / 1.253),
        ("adaptive_thresh_5x5", gray,
         lambda im: u8sum(threshold_adaptive(im, 5, 21)), 10000 / 3.551),
        # Wolf binarization 41x41 (speed_compare:66-70: 8721 ms / 1k)
        ("wolf_binarization_41x41", gray,
         lambda im: u8sum(threshold_wolf(im, 41)), 1000 / 8.721),
        ("gaussian_blur_7x7", gray,
         lambda im: u8sum(gaussian_blur(im, 7, 2.0)), 10000 / 1.367),
        ("sobel3x3", gray,
         lambda im: u8sum(edge_detect(im, "sobel")), 10000 / 7.476),
        ("scale_bilinear", gray,
         lambda im: u8sum(scale(im, 597, 1064, "bilinear")), 10000 / 1.474),
        # Bicubic: the reference is SLOWER than OpenCV here ("Shame!!",
        # speed_compare:88-94) — baseline is OpenCV's 6671 ms / 10k, the
        # best published number in the table.
        ("scale_bicubic", gray,
         lambda im: u8sum(scale(im, 597, 1064, "bicubic")), 10000 / 6.671),
        ("rotate_45_paeth", gray,
         lambda im: u8sum(rotate_fast(im, jnp.float32(44.9))), 1000 / 1.540),
        (HEADLINE, gray,
         lambda im: (lambda vi: (jnp.sum(vi[0]), jnp.sum(vi[1])))(
             select_top_k_2d(_nms_f32(_strengths_f32(im, 20, 9)), 2000)),
         10000 / 3.358),
        ("canny3x3", gray,
         lambda im: u8sum(canny(im, CannyConfig())), 10000 / 14.903),
        ("morph_erode_3x3", big_bin,
         lambda im: u8sum(erode(im, se3)), 10000 / 0.449),
        ("morph_close_3x3", big_bin,
         lambda im: u8sum(close_(im, se3)), 10000 / 0.794),
        ("hough_sht", gray,
         lambda im: lines_sum(hough_sht(canny(im, CannyConfig()),
                                        HoughShtConfig())), 1000 / 10.367),
        ("hough_kht", gray,
         lambda im: (lambda egxy: lines_sum(
             hough_kht(egxy[0], egxy[1], egxy[2], HoughKhtConfig())))(
             (canny(im, CannyConfig()),) + sobel_gradients(im)),
         1000 / 1.413),
        # HOG 8x8 cells, 9 bins, L2Hys (speed_compare:197-202: 5198 ms / 1k)
        ("hog_8x8_l2hys", gray,
         lambda im: fsum(hog_descriptor(im, HogConfig(norm="l2hys"))),
         1000 / 5.198),
        ("bf_hamming_knn2_200x258", descq,
         lambda q: match_sum(knn_match(q, desct, k=2)), 1000 / 0.260),
        ("bf_hamming_knn2_2048x2048", descq_big,
         lambda q: match_sum(knn_match(q, desct_big, k=2)), bf_big_ref_fps),
        # CCL labeling on the 1122x1182 text image
        # (speed_compare:173-179: 2973 ms / 10k — the 22.3x headline)
        ("ccl_label_text", text_bin,
         lambda im: u8sum(label_components(im)), 10000 / 2.973),
        # CCL blob features / boxes from an existing labeling — the
        # reference benchmarks extraction separately from labeling
        # (speed_compare:181-186); labels are precomputed outside the loop
        # and perturbed per rep for the data dependency
        ("ccl_boxes_text", label_components(text_bin),
         lambda lb: (lambda r: (jnp.sum(r.area).astype(jnp.float32),
                                jnp.sum(r.box_x1)))(
             ccl_features_from_labels(lb, CclConfig())), 10000 / 0.956),
        # End-to-end ORB frontend pair at 720p (see frontend_ref_fps above)
        ("frontend_pair_720p", gray, frontend_pair, frontend_ref_fps),
        # MSER on the text image (speed_compare:188-195: 27072 ms / 1k)
        ("mser_text", text,
         lambda im: (lambda r: (jnp.sum(r.area).astype(jnp.float32),
                                jnp.sum(r.level)))(
             mser_detect(im, MserConfig())), 1000 / 27.072),
    ]

    results = {}
    for name, arr, fn, ref_fps in cases:
        if only is not None and name not in only:
            continue

        @jax.jit
        def bench(im, reps, fn=fn):
            def body(i, carry):
                acc, cur = carry
                sv, si = fn(cur)
                delta = (si % 2).astype(cur.dtype)
                cur = cur.at[(0,) * cur.ndim].set(cur[(0,) * cur.ndim] + delta)
                return acc + sv, cur
            acc, _ = jax.lax.fori_loop(0, reps, body, (jnp.float32(0.0), im))
            return acc

        try:
            t0 = time.perf_counter()
            _ = float(bench(arr, jnp.int32(1)))
            compile_s = time.perf_counter() - t0

            # probe: size R2 so the differential device time ~target_diff
            t0 = time.perf_counter()
            float(bench(arr, jnp.int32(1)))
            t_one = time.perf_counter() - t0
            probe = 17
            t0 = time.perf_counter()
            float(bench(arr, jnp.int32(probe)))
            t_probe = time.perf_counter() - t0
            est = max((t_probe - t_one) / (probe - 1), 1e-7)
            r2 = int(np.clip(round(target_diff / est), 3, 1100))
            r1 = max(1, r2 // 11)
            trials = 3

            slopes = []
            for _t in range(trials):
                t0 = time.perf_counter(); float(bench(arr, jnp.int32(r1)))
                ta = time.perf_counter() - t0
                t0 = time.perf_counter(); float(bench(arr, jnp.int32(r2)))
                tb = time.perf_counter() - t0
                s = (tb - ta) / (r2 - r1)
                if s > 0:
                    slopes.append(s)
            if not slopes:
                # fast op drowned in noise: fall back to whole-call time at
                # r2 (an upper bound, never silent)
                t0 = time.perf_counter(); float(bench(arr, jnp.int32(r2)))
                slopes = [(time.perf_counter() - t0) / r2]
            per = sorted(slopes)[len(slopes) // 2]
            fps = 1.0 / per
            results[name] = (fps, ref_fps)
            print(json.dumps({"metric": name, "value": round(fps, 2),
                              "unit": "frames/s",
                              "vs_baseline": round(fps / ref_fps, 3)}),
                  flush=True)
        except Exception as e:  # noqa: BLE001 — report and continue the suite
            print(json.dumps({"metric": name, "error": str(e)[:200]}),
                  flush=True)

    if results:
        geo = float(np.exp(np.mean([np.log(f / r) for f, r in results.values()])))
        line = {"metric": "suite_geomean_vs_reference",
                "value": round(geo, 3), "unit": "x",
                "vs_baseline": round(geo, 3),
                "n_metrics": len(results)}
        if HEADLINE in results:
            f, r = results[HEADLINE]
            line["headline_fast9_fps"] = round(f, 1)
            line["headline_vs_baseline"] = round(f / r, 3)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
