"""SLAM/SfM frontend: the flagship end-to-end pipeline.

Mirrors the reference's object-recognition sample chain (SURVEY.md §3.2,
samples/object_recognition/main.cxx:92-220):
  gray -> ORB detect/describe -> brute-force KNN2 Hamming match ->
  Lowe ratio test (0.67) -> RANSAC homography.

One jitted program: XLA fuses the whole frame pipeline; this is also the
compile-check entry used by __graft_entry__.entry().
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from compv_tpu.calib.homography import HomographyConfig, find_homography
from compv_tpu.features.orb import OrbConfig, orb_detect_describe
from compv_tpu.matchers.bruteforce import knn_match, ratio_test
from compv_tpu.precision import geometry

__all__ = ["FrontendConfig", "PairResult", "match_pair", "detect_describe"]


@dataclass(frozen=True)
class FrontendConfig:
    orb: OrbConfig = OrbConfig()
    homography: HomographyConfig = HomographyConfig()
    ratio: float = 0.67       # samples/object_recognition/main.cxx:185


class PairResult(NamedTuple):
    h: jax.Array              # (3,3) homography img1 -> img2
    num_matches: jax.Array    # ratio-test survivors
    num_inliers: jax.Array
    kp1_count: jax.Array
    kp2_count: jax.Array


def detect_describe(img: jax.Array, config: FrontendConfig = FrontendConfig()):
    return orb_detect_describe(img, config.orb)


@partial(jax.jit, static_argnames=("config",))
@geometry
def match_pair(img1: jax.Array, img2: jax.Array,
               config: FrontendConfig = FrontendConfig()) -> PairResult:
    r1 = orb_detect_describe(img1, config.orb)
    r2 = orb_detect_describe(img2, config.orb)
    m = knn_match(r1.descriptors, r2.descriptors,
                  r1.keypoints.valid, r2.keypoints.valid, k=2)
    ok = ratio_test(m, config.ratio)

    src = jnp.stack([r1.keypoints.x, r1.keypoints.y], axis=1)
    tidx = m.train_idx[0]
    dst = jnp.stack([r2.keypoints.x[tidx], r2.keypoints.y[tidx]], axis=1)

    hres = find_homography(src, dst, ok, config.homography)
    return PairResult(h=hres.h,
                      num_matches=jnp.sum(ok).astype(jnp.int32),
                      num_inliers=hres.num_inliers,
                      kp1_count=r1.keypoints.count().astype(jnp.int32),
                      kp2_count=r2.keypoints.count().astype(jnp.int32))
