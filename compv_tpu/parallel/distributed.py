"""Multi-host bring-up helpers.

The reference is single-process; pod-scale runs need jax.distributed. This
wraps the standard recipe: initialize once per host, build a global mesh
over all processes' devices, and give each host its shard of the frame
stream. Single-host (including the CPU test mesh) degrades gracefully.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["init_distributed", "global_frame_mesh", "process_frame_slice"]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """jax.distributed.initialize with env-based autodetection. No-op when
    already initialized or single-process.

    NOTE: must run before ANY backend-initializing jax call (jax.devices,
    process_count, any computation) — so this function must not probe the
    backend itself; it only try/excepts initialize."""
    if coordinator_address is None:
        # rely on the cluster environment's auto-detection; if absent this
        # is a single-process run and nothing needs doing
        try:
            jax.distributed.initialize()
        except Exception:
            return
    else:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id)
        except RuntimeError:
            # already initialized (idempotent re-entry)
            if jax.process_count() != (num_processes or 1):
                raise


def global_frame_mesh(axis: str = "frame") -> Mesh:
    """1-D mesh over every device of every process. The mesh follows the
    algorithm alone: the cards of one host are joined all to all (NVLink),
    so no axis needs to match a physical topology. Across hosts the
    network is slower, so keep per-step data local and let only
    reductions cross."""
    return Mesh(np.array(jax.devices()), (axis,))


def process_frame_slice(n_frames: int):
    """Which slice of a global frame list this host should load (IO is
    per-host; arrays become globally-sharded via jax.make_array_from_process_local_data)."""
    p = jax.process_index()
    n = jax.process_count()
    per = (n_frames + n - 1) // n
    lo = p * per
    return lo, min(lo + per, n_frames)
