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

Reshard-on-load (elastic restarts): given ``shardings``, a tree of
:class:`~repro_torch.distributed.sharding.NamedSharding` in ``like``'s
structure (``param_shardings`` of the new mesh), each leaf goes onto its
sharding's mesh.  The port saves and loads whole tensors in one process,
so a mesh places a leaf on its one device; a mesh whose coordinates name
several devices raises (the per-device slices of such a mesh are not
ported, ROADMAP queue A item 10).
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

from repro_torch.distributed.sharding import (leaves_with_path, map_with_path,
                                              one_device, path_str)

_PATTERN = ("block_col", "block_row", "row_ptr")


def _name(path) -> str:
    return path_str(path, "name")


def _flatten(tree) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` for every leaf of ``tree``, in order."""
    out = []
    for path, leaf in leaves_with_path(tree):
        if not isinstance(leaf, (torch.Tensor, np.ndarray)):
            raise TypeError(f"cannot checkpoint a {type(leaf).__name__}")
        out.append((_name(path), leaf))
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


def _same_pattern(like, fields, path):
    """``like`` with its loaded ``blocks``, the saved pattern being
    ``like``'s own."""
    for f in _PATTERN:
        if not np.array_equal(fields[f], getattr(like, f)):
            raise ValueError(f"{_name(path)}: the saved sparse pattern's {f} "
                             f"differs from the one loaded into")
    return dataclasses.replace(like, blocks=fields["blocks"])


def _rebuild(like, loaded: Dict[str, Any]):
    return map_with_path(lambda path, leaf: loaded[_name(path)], like,
                         bsr=_same_pattern)


def _placed(like, shardings):
    """``like`` with every tensor leaf on its sharding's mesh device (an
    empty tensor of the leaf's shape and dtype there), numpy leaves as
    they are; ``shardings`` is walked beside ``like``, leaf for leaf."""
    targets = leaves_with_path(shardings)

    def place(path, leaf):
        target_path, target = next(targets, (None, None))
        if target_path is None or _name(target_path) != _name(path):
            raise KeyError(f"shardings have no entry for leaf {_name(path)}")
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return torch.empty(leaf.shape, dtype=leaf.dtype, device=one_device(
            target.mesh, "load(shardings=...)"))
    return map_with_path(place, like, bsr=lambda node, fields, path:
                         dataclasses.replace(node, **fields))


def load(ckpt_dir: str, like: Any, step: Optional[int] = None,
         mesh=None, shardings=None) -> Tuple[int, Any]:
    """Restore into the structure of ``like``: each leaf on ``like``'s
    device in ``like``'s dtype, or, with ``shardings`` (a tree of
    ``NamedSharding`` in ``like``'s structure, a BlockCSR's as a dict by
    field), on its sharding's mesh device; the values are the saved bits.
    Raises ``KeyError`` for a leaf the checkpoint lacks and ``ValueError``
    for a shape (or a sparse pattern) that differs; a sharding over a
    mesh of several devices raises ``NotImplementedError``.  ``mesh`` is
    accepted as the reference's is (unused)."""
    if shardings is not None:
        like = _placed(like, shardings)
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
    return step, _rebuild(like, loaded)


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
