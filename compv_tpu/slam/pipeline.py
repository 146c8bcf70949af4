"""Sequence pipelines: planar tracking, keyframe store, mini-SfM.

BASELINE configs 3 & 5: "RANSAC homography + LM refinement, planar tracking
over a short sequence" and "multi-keyframe matching + distributed BA + pose
graph". The per-pair step is the jitted flagship frontend (slam/frontend.py);
the sequence loop is host-side Python (frames arrive from IO anyway), with
all per-frame compute on device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from compv_tpu.calib.homography import HomographyConfig, find_homography
from compv_tpu.features.orb import OrbConfig, OrbResult, orb_detect_describe
from compv_tpu.matchers.bruteforce import knn_match, ratio_test
from compv_tpu.slam.ba import matrix_to_rodrigues
from compv_tpu.precision import geometry

__all__ = ["PlanarTrackerConfig", "PlanarTrackResult", "track_planar_sequence",
           "KeyframeStore", "decompose_homography"]


@dataclass(frozen=True)
class PlanarTrackerConfig:
    orb: OrbConfig = OrbConfig(max_features=1000, levels=4)
    homography: HomographyConfig = HomographyConfig(num_hypotheses=256)
    ratio: float = 0.75
    min_inliers: int = 12


class PlanarTrackResult(NamedTuple):
    h_to_first: List[np.ndarray]   # per-frame homography frame0 -> frame_t
    num_inliers: List[int]
    tracked: List[bool]


@jax.jit
def _pair_homography_step(desc1, valid1, x1, y1, desc2, valid2, x2, y2,
                          ratio, num_hypotheses_dummy):
    m = knn_match(desc1, desc2, valid1, valid2, k=2)
    ok = m.valid[0] & m.valid[1] & (m.distance[0] < ratio * m.distance[1])
    src = jnp.stack([x1, y1], axis=1)
    t = m.train_idx[0]
    dst = jnp.stack([x2[t], y2[t]], axis=1)
    res = find_homography(src, dst, ok)
    return res.h, res.num_inliers, jnp.sum(ok)


@geometry
def track_planar_sequence(frames, config: PlanarTrackerConfig = PlanarTrackerConfig()
                          ) -> PlanarTrackResult:
    """Track a planar scene: frame0 is the template; every frame is matched
    to the PREVIOUS frame and homographies are chained to frame0 (drift-
    prone but matches the reference sample's strategy; loop closure comes
    from re-matching the template when inliers drop)."""
    hs = [np.eye(3)]
    inl = [0]
    tracked = [True]
    prev: Optional[OrbResult] = None
    first: Optional[OrbResult] = None
    h_acc = np.eye(3)

    for i, frame in enumerate(frames):
        img = jnp.asarray(frame)
        res = orb_detect_describe(img, config.orb)
        if i == 0:
            first = prev = res
            continue
        kp_p, kp_c = prev.keypoints, res.keypoints
        h, n, _ = _pair_homography_step(
            prev.descriptors, kp_p.valid, kp_p.x, kp_p.y,
            res.descriptors, kp_c.valid, kp_c.x, kp_c.y,
            config.ratio, 0)
        n = int(n)
        good = n >= config.min_inliers
        if good:
            h_acc = np.asarray(h) @ h_acc
        else:
            # re-localize against the template
            kp_f = first.keypoints
            h0, n0, _ = _pair_homography_step(
                first.descriptors, kp_f.valid, kp_f.x, kp_f.y,
                res.descriptors, kp_c.valid, kp_c.x, kp_c.y,
                config.ratio, 0)
            n0 = int(n0)
            if n0 >= config.min_inliers:
                h_acc = np.asarray(h0)
                n, good = n0, True
        hs.append(h_acc / h_acc[2, 2])
        inl.append(n)
        tracked.append(good)
        prev = res
    return PlanarTrackResult(h_to_first=hs, num_inliers=inl, tracked=tracked)


@geometry
def decompose_homography(h: jax.Array, k: jax.Array):
    """Planar H = K (R + t n^T / d) K^-1 decomposition (Malis-Vargas style,
    returning the physically-plausible normalized solution): gives (rvec,
    tvec/d, n). Assumes the plane is mostly fronto-parallel in frame 0."""
    kinv = jnp.linalg.inv(k)
    a = kinv @ h @ k
    # normalize so the middle singular value is 1
    s = jnp.linalg.svd(a, compute_uv=False)
    a = a / s[1]
    # fronto-parallel prior: n ~ (0,0,1); R ~ a - t n^T with t = a e3 - r3
    n = jnp.array([0.0, 0.0, 1.0], h.dtype)
    # orthogonalize the rotation part
    u, _, vt = jnp.linalg.svd(a)
    r = u @ vt
    det = jnp.linalg.det(r)
    u = u.at[:, 2].multiply(jnp.sign(det))
    r = u @ vt
    t = (a - r) @ n
    return matrix_to_rodrigues(r), t, n


@dataclass
class KeyframeStore:
    """Fixed-capacity keyframe database: descriptors + keypoints + poses.
    The multi-chip layer shards this over the "frame" mesh axis
    (parallel/sharded.py)."""
    capacity: int
    descriptors: List[jax.Array] = field(default_factory=list)
    keypoints: List = field(default_factory=list)
    poses: List[np.ndarray] = field(default_factory=list)
    frame_ids: List[int] = field(default_factory=list)

    def add(self, frame_id: int, orb: OrbResult, pose_rt: np.ndarray) -> bool:
        if len(self.frame_ids) >= self.capacity:
            return False
        self.descriptors.append(orb.descriptors)
        self.keypoints.append(orb.keypoints)
        self.poses.append(np.asarray(pose_rt))
        self.frame_ids.append(frame_id)
        return True

    def __len__(self):
        return len(self.frame_ids)

    def stacked_descriptors(self):
        """(K, N, 256) for the sharded all-pairs matcher."""
        return (jnp.stack(self.descriptors),
                jnp.stack([kp.valid for kp in self.keypoints]))
