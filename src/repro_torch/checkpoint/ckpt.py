"""Sharded npz checkpointing with atomic manifest commit + async save.

Port of ``repro.checkpoint.ckpt``, the same layout and commit protocol:
``<dir>/step_<N>/shard_<p>.npz`` + ``manifest.json``, written in
``<dir>/_staging_step_<N>`` and committed by renaming the directory, so a
partially written checkpoint is never restorable; restore picks the newest
step with a manifest, and a save keeps the newest ``keep`` steps.

A tree is nested dicts (keys in sorted order, as ``jax.tree.flatten``
orders them), tuples, NamedTuples and lists, whose leaves are tensors,
numpy arrays or Python numbers; leaf i is ``leaf_i`` in the npz.

The port's optimizer updates parameters and moments in place, so
``save_async`` copies every leaf to host memory before it returns (the
reference may read its immutable arrays later); only the write runs in the
worker thread. ``restore_latest`` fills the tensors of ``like_tree`` in
place, so a model's own parameters take the checkpoint's values.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["save", "save_async", "restore_latest", "latest_step", "wait_pending"]

_pending: list[threading.Thread] = []


def _flatten(tree) -> tuple[list, str]:
    """(leaves, a description of the structure) in the reference's order."""
    if isinstance(tree, dict):
        parts = [(k, _flatten(tree[k])) for k in sorted(tree)]
        return [x for _, (ls, _) in parts for x in ls], "{" + ", ".join(f"{k!r}: {d}" for k, (_, d) in parts) + "}"
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t) for t in tree]
        name = type(tree).__name__
        return [x for ls, _ in parts for x in ls], f"{name}(" + ", ".join(d for _, d in parts) + ")"
    return [tree], "*"


def _unflatten(like, leaves):
    """``like`` with its leaves taken in order from the iterator ``leaves``."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}  # the like tree's own key order
    if isinstance(like, tuple) and hasattr(like, "_fields"):  # a NamedTuple
        return type(like)(*(_unflatten(t, leaves) for t in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return next(leaves)


def _host(x) -> np.ndarray:
    """A leaf as a numpy array in host memory of its own (a copy)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:  # no numpy bf16: saved as f32, exactly
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def save(ckpt_dir, step: int, tree, process_index: int = 0, keep: int = 3):
    ckpt_dir = Path(ckpt_dir)
    stage = ckpt_dir / f"_staging_step_{step}"
    final = ckpt_dir / f"step_{step}"
    stage.mkdir(parents=True, exist_ok=True)
    leaves, treedef = _flatten(tree)
    arrays = {f"leaf_{i}": x if isinstance(x, np.ndarray) else _host(x) for i, x in enumerate(leaves)}
    np.savez(stage / f"shard_{process_index}.npz", **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": treedef,
        "time": time.time(),
        "shards": [f"shard_{process_index}.npz"],
    }
    (stage / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(stage, final)  # atomic commit
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(
        (int(p.name.split("_")[1]), p)
        for p in ckpt_dir.glob("step_*")
        if (p / "manifest.json").exists()
    )
    for _, p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def save_async(ckpt_dir, step: int, tree, keep: int = 3):
    """Snapshot to host memory now (every leaf copied); write in a worker thread."""
    leaves, _ = _flatten(tree)
    host_tree = _unflatten(tree, iter([_host(x) for x in leaves]))
    wait_pending()  # one-deep pipeline
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree), kwargs={"keep": keep})
    t.start()
    _pending.append(t)
    return t


def wait_pending():
    while _pending:
        _pending.pop().join()


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in ckpt_dir.glob("step_*")
        if (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def _restored(like, arr: np.ndarray):
    """Leaf ``like`` given the saved ``arr``: a tensor is filled in place
    (cast to its dtype) and returned; a Python number comes back as its
    type; an array is cast to ``like``'s dtype."""
    if isinstance(like, torch.Tensor):
        with torch.no_grad():
            like.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        return like
    if isinstance(like, (bool, int, float)):
        return type(like)(arr)
    return np.asarray(arr).astype(np.asarray(like).dtype)


def restore_latest(ckpt_dir, like_tree):
    """Restore newest valid checkpoint into the structure of ``like_tree``.

    Returns (tree, step) or (None, None) when no checkpoint exists.
    """
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    data = {}
    for shard in manifest["shards"]:
        with np.load(d / shard) as z:
            data.update({k: z[k] for k in z.files})
    leaves, _ = _flatten(like_tree)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint/model structure mismatch: {manifest['n_leaves']} leaves in {d}, "
                         f"{len(leaves)} in the like tree")
    new_leaves = [_restored(like, data[f"leaf_{i}"]) for i, like in enumerate(leaves)]
    return _unflatten(like_tree, iter(new_leaves)), step
