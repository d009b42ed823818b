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

An MoE expert leaf placed over a mesh's ``model`` peers
(:class:`~repro_torch.distributed.sharding.PeerSlices`, from
``sharding.device_put_params``) is saved as its whole leaf under its
path: a placed tree's checkpoint is its whole tree's, manifest and
arrays, and the reference's ``load`` reads it.  Loaded into a placed
``like``, each slice is restored from its range of the saved leaf,
straight onto its device.

Reshard-on-load (elastic restarts): given ``shardings``, a tree of
:class:`~repro_torch.distributed.sharding.NamedSharding` in ``like``'s
structure (``param_shardings`` of the new mesh), each leaf goes onto its
sharding's mesh.  A mesh whose entries are all one device takes every
leaf whole on that device; a mesh whose entries name several devices
places what ``device_put_params`` places there: each expert leaf cut
into its peers' slices, each on ``mesh.device_at(model=pe)``, every
other leaf whole on the mesh's first device.
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

from repro_torch.distributed.sharding import (PeerSlices, leaves_with_path,
                                              map_with_path, mesh_devices,
                                              path_str, peer_axis)

_PATTERN = ("block_col", "block_row", "row_ptr")


def _name(path) -> str:
    return path_str(path, "name")


def _flatten(tree) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` for every leaf of ``tree``, in order."""
    out = []
    for path, leaf in leaves_with_path(tree):
        if not isinstance(leaf, (torch.Tensor, np.ndarray, PeerSlices)):
            raise TypeError(f"cannot checkpoint a {type(leaf).__name__}")
        out.append((_name(path), leaf))
    return out


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and its manifest dtype (bf16: its bits)."""
    if isinstance(leaf, np.ndarray):
        return leaf, str(leaf.dtype)
    if isinstance(leaf, PeerSlices):
        leaf = leaf.whole("cpu")
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
    """A saved array in ``like``'s type, dtype and device (a placed leaf:
    each slice its range of ``arr``, on its device)."""
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    if isinstance(like, PeerSlices):
        out, lo = [], 0
        for part in like.parts:
            n = part.shape[like.axis]
            out.append(_restore(arr[(slice(None),) * like.axis
                                    + (slice(lo, lo + n),)], dtype, part))
            lo += n
        return PeerSlices(tuple(out), like.axis, like.shape)
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
    """``like`` with every tensor leaf placed on its sharding's mesh (as
    empty tensors of the leaf's shape and dtype): whole on a mesh of one
    device; on a mesh of several devices cut as ``device_put_params``
    cuts it (:func:`~repro_torch.distributed.sharding.peer_axis` of the
    sharding's spec), each slice on its peer's device, else whole on the
    mesh's first device.  numpy leaves stay as they are; ``shardings`` is
    walked beside ``like``, leaf for leaf."""
    targets = leaves_with_path(shardings)

    def place(path, leaf):
        target_path, target = next(targets, (None, None))
        if target_path is None or _name(target_path) != _name(path):
            raise KeyError(f"shardings have no entry for leaf {_name(path)}")
        if not isinstance(leaf, (torch.Tensor, PeerSlices)):
            return leaf
        mesh = target.mesh
        if getattr(mesh, "devices", None) is None:
            raise ValueError("load(shardings=...): an abstract mesh holds no "
                             "devices")
        shape = tuple(leaf.shape)
        dtype = (leaf.parts[0] if isinstance(leaf, PeerSlices) else leaf).dtype
        axis = (peer_axis(path_str(path, "str"), target.spec, mesh)
                if len(mesh_devices(mesh)) > 1 else None)
        if axis is None:
            return torch.empty(shape, dtype=dtype,
                               device=mesh.devices.reshape(-1)[0])
        msize = mesh.shape["model"]
        e_loc = shape[axis] // msize
        cut = shape[:axis] + (e_loc,) + shape[axis + 1:]
        return PeerSlices(tuple(
            torch.empty(cut, dtype=dtype, device=mesh.device_at(model=pe))
            for pe in range(msize)), axis, shape)
    return map_with_path(place, like, bsr=lambda node, fields, path:
                         dataclasses.replace(node, **fields))


def load(ckpt_dir: str, like: Any, step: Optional[int] = None,
         mesh=None, shardings=None) -> Tuple[int, Any]:
    """Restore into the structure of ``like``: each leaf on ``like``'s
    device in ``like``'s dtype, or, with ``shardings`` (a tree of
    ``NamedSharding`` in ``like``'s structure, a BlockCSR's as a dict by
    field), placed on its sharding's mesh (:func:`_placed`); the values
    are the saved bits.  A placed leaf of ``like`` comes back placed
    alike.  Raises ``KeyError`` for a leaf the checkpoint lacks and
    ``ValueError`` for a shape (or a sparse pattern) that differs, or a
    sharding over an abstract mesh.  ``mesh`` is accepted as the
    reference's is (unused)."""
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
