"""Checkpointing (port of ``repro.ft.checkpoint``): per-shard npz and a
manifest, atomic rename, resume from the latest step.

Layout, the reference's:
    <dir>/step_00000123.tmp/      (written, each file fsynced)
    <dir>/step_00000123/          (atomic rename on completion)
        manifest.json             {step, leaves: [{name, shape, dtype}],
                                   n_shards: 1}
        shard_00000.npz           leaf_i arrays

A tree is nested dicts, lists and tuples, NamedTuples (``OptState``) and
:class:`~repro_torch.core.csr.BlockCSR` s over tensor and numpy leaves; a
leaf's name is its path joined by ``"/"`` (dict keys, list indices, field
names).  Every tensor is saved, integer ones too (``OptState.step``), and a
BlockCSR's pattern (``block_col``, ``block_row``, ``row_ptr``) beside its
``blocks``; :func:`load` refuses a saved pattern that differs from its
``like``'s, so values never land in another pattern.  numpy has no
bfloat16: a bf16 leaf is saved as its uint16 bits under dtype
``"bfloat16"`` and restored bit for bit.

The reference re-slices every leaf onto the current mesh's sharding on
load (elastic restarts); the port saves and loads whole tensors in one
process, and reshard-on-load waits for the sharding rules.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.csr import BlockCSR

_PATTERN = ("block_col", "block_row", "row_ptr")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``node``'s named children, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if isinstance(node, BlockCSR):
        return [(f, getattr(node, f)) for f in ("blocks",) + _PATTERN]
    if isinstance(node, (torch.Tensor, np.ndarray)):
        return None
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += _flatten(child, f"{prefix}/{name}" if prefix else name)
    return out


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and its manifest dtype (bf16: its bits)."""
    if isinstance(leaf, np.ndarray):
        return leaf, str(leaf.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous checkpoint: write to .tmp, fsync, atomic rename."""
    leaves = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays, entries = {}, []
    for i, (name, leaf) in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        entries.append({"name": name, "shape": list(arr.shape),
                        "dtype": dtype})
    shard = os.path.join(tmp, "shard_00000.npz")
    np.savez(shard, **arrays)
    _fsync(shard)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": entries, "n_shards": 1}, f,
                  indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomicity: readers never see partials
    _fsync(ckpt_dir)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Largest committed (non-.tmp) step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _restore(arr: np.ndarray, dtype: str, like):
    """A saved array in ``like``'s type, dtype and device."""
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    # (ascontiguousarray makes a () array (1,): the reshape keeps the shape)
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _rebuild(like, prefix: str, loaded: Dict[str, Any]):
    kids = _children(like)
    if kids is None:
        return loaded[prefix]
    sub = {name: _rebuild(child, f"{prefix}/{name}" if prefix else name,
                          loaded) for name, child in kids}
    if isinstance(like, dict):
        return {k: sub[str(k)] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(**sub)
    if isinstance(like, (list, tuple)):
        return type(like)(sub[str(i)] for i in range(len(like)))
    for f in _PATTERN:                  # BlockCSR: the pattern must match
        if not np.array_equal(sub[f], getattr(like, f)):
            raise ValueError(f"{prefix}: the saved sparse pattern's {f} "
                             f"differs from the one loaded into")
    return dataclasses.replace(like, blocks=sub["blocks"])


def load(ckpt_dir: str, like: Any, step: Optional[int] = None,
         mesh=None, shardings=None) -> Tuple[int, Any]:
    """Restore into the structure of ``like``: each leaf on ``like``'s
    device in ``like``'s dtype.  Raises ``KeyError`` for a leaf the
    checkpoint lacks and ``ValueError`` for a shape (or a sparse pattern)
    that differs.  ``mesh`` is accepted as the reference's is (unused);
    ``shardings`` raises: reshard-on-load needs the sharding rules."""
    if shardings is not None:
        raise NotImplementedError(
            "load(shardings=...): reshard-on-load needs the logical-axis "
            "sharding rules of distributed/sharding.py, not ported yet "
            "(ROADMAP queue A item 6)")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: (i, e["dtype"])
               for i, e in enumerate(manifest["leaves"])}
    loaded = {}
    with np.load(os.path.join(d, "shard_00000.npz")) as data:
        for name, leaf in _flatten(like):
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name}")
            i, dtype = by_name[name]
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{name}: saved {arr.shape} vs expected "
                    f"{tuple(leaf.shape)}")
            loaded[name] = _restore(arr, dtype, leaf)
    return step, _rebuild(like, "", loaded)


def garbage_collect(ckpt_dir: str, keep: int = 3) -> None:
    """Drop all but the newest `keep` committed checkpoints (+ stray .tmp)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(m.group(1)) for name in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", name)))
    for name in os.listdir(ckpt_dir):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
