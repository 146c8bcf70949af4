"""compv_tpu — a JAX computer-vision / SLAM-SfM framework.

Brand-new JAX/XLA implementation of the capability set of the CompV
reference library (surveyed in SURVEY.md): image pipeline,
feature detection & description, matching, robust estimation, camera
calibration, dense linear algebra, ML, and a distributed (multi-chip /
multi-host) SfM layer that the single-node reference never had.

Design stance (SURVEY.md §7):
  * images/matrices are plain ``jnp.ndarray``s — XLA owns layout, no strides,
    no ref-counting (replaces CompVMat, base/include/compv/base/compv_mat.h).
  * every algorithm is a pure function with a typed config dataclass
    (replaces CompVCaps set/get-by-id, base/include/compv/base/compv_caps.h).
  * variable-size outputs (keypoints, matches, lines) are fixed-capacity
    padded pytrees with validity masks — static shapes for XLA.
  * every kernel is jitted jnp/lax; a hand-written GPU kernel joins only
    where a trace on the card calls for one.
  * parallelism is jax.sharding Mesh + shard_map (replaces the thread pool,
    base/parallel/compv_threaddisp11.cxx).
"""

__version__ = "0.1.0"

from compv_tpu.core.types import Keypoints, Matches  # noqa: F401
from compv_tpu import image  # noqa: F401
from compv_tpu import features  # noqa: F401
from compv_tpu import matchers  # noqa: F401
from compv_tpu import calib  # noqa: F401
from compv_tpu import math  # noqa: F401
from compv_tpu import ml  # noqa: F401
from compv_tpu import io  # noqa: F401
from compv_tpu import viz  # noqa: F401
from compv_tpu import slam  # noqa: F401
from compv_tpu import parallel  # noqa: F401
from compv_tpu.registry import (  # noqa: F401
    create_detector, create_matcher, create_edge_detector, list_algorithms,
)


def init(num_threads: int | None = None) -> None:
    """Framework bring-up, analogous to CompVInit()
    (api/include/compv/compv_api.h:126-146).

    There is nothing to initialize eagerly — XLA owns threads, memory
    and device state — so this only exists for API familiarity. ``num_threads``
    is accepted and ignored (XLA manages host threading).
    """
    return None


def deinit() -> None:
    """Analogous to CompVDeInit() (api/include/compv/compv_api.h:136-146)."""
    return None
