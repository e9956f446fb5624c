"""Checkpoint / resume for simulation state.

The reference has no sim-state checkpointing (SURVEY.md §5) — only
cache-like artifacts (hashed clipmap ``.npz``, crater/rock DB
``save_to_disk`` knobs, SDG run dirs). This framework makes
checkpointing first-class: any framework pytree (``LoopState``,
``ControllerState``, ``RoverState``, terrain block caches) round-trips
through one ``.npz`` file.

Serialization is template-based: arrays are stored flat under their
tree-path key, and :func:`restore` maps them back onto a caller-provided
template pytree (same structure, any values) — no pickling of framework
classes, so checkpoints stay loadable across refactors that keep field
names.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any

import jax
import numpy as np


def _path_key(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "name"):
            parts.append(str(p.name))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "key"):
            parts.append(str(p.key))
        else:
            parts.append(str(p))
    return "/".join(parts) if parts else "_root"


def _norm_path(path: str | pathlib.Path) -> pathlib.Path:
    """``np.savez_compressed`` silently appends ``.npz``; normalise here so
    a config that says ``checkpoint: {path: traverse.ckpt}`` saves and
    resumes through the SAME file."""
    path = pathlib.Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(
        path.suffix + ".npz")


def save(path: str | pathlib.Path, state: Any, metadata: dict | None = None) -> None:
    """Write a pytree checkpoint: one array per leaf, keyed by tree path."""
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    arrays = {}
    for p, leaf in leaves:
        arrays[_path_key(p)] = np.asarray(leaf)
    arrays["__metadata__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8
    )
    path = _norm_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_metadata(path: str | pathlib.Path) -> dict:
    """Read only the metadata dict of a checkpoint — callers with
    dynamic-structure payloads (per-block terrain caches, variable-length
    paths) store the structure here and build the :func:`restore` template
    from it."""
    with np.load(_norm_path(path)) as data:
        return json.loads(bytes(data["__metadata__"].tobytes()).decode() or "{}")


def restore(path: str | pathlib.Path, template: Any) -> tuple[Any, dict]:
    """Load a checkpoint back onto ``template``'s structure.

    Returns ``(state, metadata)``. Every leaf of ``template`` must be
    present in the file; dtypes follow the stored arrays.
    """
    with np.load(_norm_path(path)) as data:
        meta = json.loads(bytes(data["__metadata__"].tobytes()).decode() or "{}")
        paths_and_leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
        leaves = []
        for p, tmpl_leaf in paths_and_leaves:
            key = _path_key(p)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if hasattr(tmpl_leaf, "shape") and tuple(arr.shape) != tuple(
                np.shape(tmpl_leaf)
            ):
                raise ValueError(
                    f"checkpoint leaf {key!r} shape {arr.shape} != template "
                    f"{np.shape(tmpl_leaf)}"
                )
            if isinstance(tmpl_leaf, (bool, int, float)):
                leaves.append(type(tmpl_leaf)(arr.item()))
            else:
                leaves.append(jax.numpy.asarray(arr))
    return jax.tree_util.tree_unflatten(treedef, leaves), meta
