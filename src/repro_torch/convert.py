"""Carry the reference's parameters and sparse operands across to the
port.

The reference keeps parameters as a pytree of JAX arrays with
``BlockCSR`` leaves.  This module never sees JAX: the caller hands over
the tree as nested dicts of numpy arrays, with each ``BlockCSR`` flattened
to a dict of its fields (``blocks``, ``block_col``, ``block_row``,
``row_ptr``, ``shape``, ``block_shape``).  The layout is kept as it is,
including the stacked ``groups/b<i>``, ``tail/b0`` and
``encoder/groups/b0`` layer axes, a layer norm's ``bias`` and the vision
projection ``vis_proj``; the trainer's per-layer leaves are
``models.lm.unstack_layers`` of the result.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.csr import CSR, BlockCSR

_BSR_FIELDS = {"blocks", "block_col", "block_row", "row_ptr", "shape",
               "block_shape"}


def block_csr_from_numpy(d: Mapping[str, Any], device="cuda") -> BlockCSR:
    """A flattened BlockCSR as a port container.  A stacked one (payload
    ``(L, nb, bm, bk)``, metadata ``(L, ...)``) must share one pattern
    across the stack; the port keeps that pattern once."""
    dev = resolve_device(device)
    blocks = np.asarray(d["blocks"])
    meta = {k: np.asarray(d[k]).astype(np.int32)
            for k in ("block_col", "block_row", "row_ptr")}
    if blocks.ndim == 4:
        for k, v in meta.items():
            if not (v == v[:1]).all():
                raise ValueError(f"stacked BlockCSR layers disagree on {k}; "
                                 f"the port keeps one shared pattern")
        meta = {k: v[0] for k, v in meta.items()}
    elif blocks.ndim != 3:
        raise ValueError(f"blocks must be (nb, bm, bk) or (L, nb, bm, bk), "
                         f"got {blocks.shape}")
    return BlockCSR(blocks=torch.from_numpy(np.array(blocks)).to(dev),
                    block_col=np.ascontiguousarray(meta["block_col"]),
                    block_row=np.ascontiguousarray(meta["block_row"]),
                    row_ptr=np.ascontiguousarray(meta["row_ptr"]),
                    shape=tuple(int(x) for x in d["shape"]),
                    block_shape=tuple(int(x) for x in d["block_shape"]))


def csr_from_numpy(value, col_id, row_ptr, shape, device="cuda") -> CSR:
    """A padded CSR from the reference's three host vectors (``np.asarray``
    of its ``value`` / ``col_id`` / ``row_ptr``); the value lands on
    ``device``, the pattern stays host numpy."""
    return CSR(value=torch.from_numpy(np.array(value)).to(
                   resolve_device(device)),
               col_id=np.array(col_id, dtype=np.int32),
               row_ptr=np.array(row_ptr, dtype=np.int32),
               shape=tuple(int(x) for x in shape))


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device="cuda") -> dict:
    """The port's parameter tree from the reference's (nested dicts of
    numpy arrays, BlockCSR leaves flattened to dicts).  Every leaf under
    ``/groups`` must carry ``n_groups`` layers on its leading axis, every
    leaf under ``/tail`` ``len(tail)``, every one under
    ``/encoder/groups`` ``n_enc_layers``; a config with a tail, an encoder
    or a vision prefix needs that subtree."""
    dev = resolve_device(device)
    _, n_groups, tail = cfg.layer_plan()
    layers = {"/groups": n_groups, "/tail": len(tail),
              "/encoder/groups": cfg.n_enc_layers}

    def stack_of(path):
        parts = path.split("/")
        return layers.get("/".join(parts[:3]),
                          layers.get("/".join(parts[:2])))

    def convert(node, path):
        if isinstance(node, Mapping):
            if _BSR_FIELDS <= set(node):
                return block_csr_from_numpy(node, dev)
            return {k: convert(v, f"{path}/{k}") for k, v in node.items()}
        arr = np.asarray(node)
        n = stack_of(path)
        if n is not None and arr.shape[:1] != (n,):
            raise ValueError(f"{path}: leading layer axis {arr.shape[:1]} "
                             f"!= ({n},)")
        return torch.from_numpy(np.array(arr)).to(dev)

    out = convert(tree, "")
    required = ("embed_tokens", "groups", "final_norm", "lm_head") + \
        (("tail",) if tail else ()) + \
        (("encoder",) if cfg.n_enc_layers > 0 else ()) + \
        (("vis_proj",) if cfg.n_patches > 0 else ())
    for key in required:
        if key not in out:
            raise ValueError(f"parameter tree has no {key!r}")
    return out
