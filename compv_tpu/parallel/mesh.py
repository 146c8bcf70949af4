"""Device-mesh helpers.

The reference's entire parallelism story is one pinned thread pool
(base/parallel/compv_threaddisp11.cxx); this framework's is a
jax.sharding.Mesh + shard_map (SURVEY.md §2.6). Axis conventions:

  "frame"  — data parallelism over frames/keyframes (dp)
  "tile"   — spatial parallelism over image tiles within a frame (sp)

Most pipelines use a 1-D "frame" mesh; BA shards cameras over "frame" and
reduces the Schur system with psum over it.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "frame_sharding", "replicated", "P"]


def make_mesh(n_devices: int | None = None, axis: str = "frame") -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.array(devs[:n]), (axis,))


def make_mesh_2d(n_frame: int, n_tile: int) -> Mesh:
    devs = np.array(jax.devices()[: n_frame * n_tile]).reshape(n_frame, n_tile)
    return Mesh(devs, ("frame", "tile"))


def frame_sharding(mesh: Mesh, axis: str = "frame") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
