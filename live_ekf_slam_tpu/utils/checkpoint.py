"""Checkpoint / resume of full batched run state.

The reference has no checkpointing (SURVEY.md §5); this framework saves and
restores the entire sim+filter PyTree at any tick so long Monte-Carlo runs can
resume (npz by default; orbax if available for sharded arrays).
"""

from __future__ import annotations

import os

import jax
import numpy as np


def _flatten_with_paths(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return leaves, treedef


def save(path: str, tree) -> None:
    """Save any PyTree of arrays to an .npz (host-side)."""
    leaves, treedef = _flatten_with_paths(tree)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def restore(path: str, like):
    """Restore into the structure of `like` (a template PyTree)."""
    data = np.load(path)
    leaves, treedef = _flatten_with_paths(like)
    new_leaves = []
    for i, template in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        t = np.asarray(template)
        if arr.shape != t.shape:
            raise ValueError(
                f"checkpoint leaf {i} shape {arr.shape} != template {t.shape}"
            )
        new_leaves.append(arr.astype(t.dtype))
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


def save_orbax(path: str, tree) -> None:  # pragma: no cover - optional dep
    """Orbax variant (handles sharded device arrays natively)."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), tree)
    ckptr.wait_until_finished()


def restore_orbax(path: str, like):  # pragma: no cover - optional dep
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(path), like)
