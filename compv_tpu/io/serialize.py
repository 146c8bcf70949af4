"""Array / pytree serialization + checkpointing.

Reference persistence surfaces: Mat<->JSON (base/include/compv/base/compv_json.h:22-27),
SVM/Annoy model files, PCA json (SURVEY.md §5 'Checkpoint / resume').
Additions: orbax-style checkpoint of SLAM state (keyframes, landmarks,
poses, BA state) for multi-host failure recovery — the elasticity story the
single-process reference never needed.
"""
from __future__ import annotations

import json
import os
from typing import Any

import jax
import numpy as np

__all__ = ["array_to_json", "array_from_json", "save_mat_json",
           "load_mat_json", "save_checkpoint", "load_checkpoint",
           "save_npz", "load_npz"]


def array_to_json(arr) -> dict:
    """Mat -> JSON object with dtype/shape/data (reference CompVJSON::write)."""
    a = np.asarray(arr)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.ravel().tolist()}


def array_from_json(obj: dict) -> np.ndarray:
    return np.asarray(obj["data"], dtype=obj["dtype"]).reshape(obj["shape"])


def save_mat_json(path: str, **arrays) -> None:
    with open(path, "w") as f:
        json.dump({k: array_to_json(v) for k, v in arrays.items()}, f)


def load_mat_json(path: str) -> dict:
    with open(path) as f:
        return {k: array_from_json(v) for k, v in json.load(f).items()}


def save_npz(path: str, tree: Any) -> None:
    """Flatten any pytree of arrays to an .npz (fast binary path)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    np.savez(path, treedef=np.frombuffer(str(treedef).encode(), np.uint8),
             **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})


def load_npz(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (same treedef)."""
    data = np.load(path)
    leaves, treedef = jax.tree_util.tree_flatten(like)
    new_leaves = [data[f"leaf_{i}"] for i in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Orbax checkpoint when available, .npz fallback. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    try:
        import orbax.checkpoint as ocp
        path = os.path.join(os.path.abspath(directory), f"step_{step}")
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, tree, force=True)
        ckptr.wait_until_finished()
        return path
    except Exception:
        path = os.path.join(directory, f"step_{step}.npz")
        save_npz(path, tree)
        return path


def load_checkpoint(path: str, like: Any) -> Any:
    if path.endswith(".npz"):
        return load_npz(path, like)
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(path, like)
