"""The LM (port of ``repro.models.lm``): ``init_params``,
``sparse_mlp_plan``, ``forward`` and ``loss_fn`` for training;
``init_decode_state``, ``prefill``, ``decode_step`` and
``prefill_cross_kv`` for serving, and ``init_paged_state`` /
``decode_step_paged`` (with ``needs_kv_pages`` and ``history_horizon``)
for the continuous batcher's paged KV pool.

A model is a stack of blocks.  Each block is a temporal mixer (global GQA
attention, local-window attention, RG-LRU or Mamba-2 SSD), a
cross-attention to the encoder's output in an encoder-decoder model, and
an FFN (the MLP, or the MoE layer for the MoE family; SSM blocks have
none).  The kinds come from ``cfg.pattern_unit`` repeated ``n_groups``
times, then a homogeneous ``tail`` (``cfg.layer_plan()``).  The audio
family (whisper) adds an encoder of ``n_enc_layers`` non-causal attention
blocks over precomputed frame embeddings (``params["encoder"]``, its
stack under ``groups/b0``); the vlm family puts ``n_patches`` projected
patch embeddings (``params["vis_proj"]``) in front of the tokens.

Serving keeps the reference's scanned layout: one stacked group per
position of the unit, ``params["groups"]["b<i>"]``, each leaf with a
leading layer axis, and the tail as ``params["tail"]["b0"]`` stacked over
``len(tail)``; a stacked block-sparse MLP weight is one
:class:`BlockCSR` with a ``(L, nnzb, bm, bk)`` payload over a shared
pattern.  ``init_params``, ``prefill`` and ``decode_step`` take that
layout, and the layer loop runs group by group through the unit's kinds,
then the tail.  Decode caches keep the same layout per kind (K/V,
``min(max_seq, window)`` long in rolling layout for local attention;
``conv`` / ``h`` for RG-LRU; ``conv`` / ``state`` for SSM) and are updated
in place.

The trainer holds the same tree with ``groups["b<i>"]`` as a list of
per-layer subtrees instead (:func:`unstack_layers`), each leaf a tensor
of its own: autograd then gives each layer its own gradient, where
indexing a stacked leaf would allocate a zero tensor as large as the
stack per layer in the backward (the encoder's stack as well);
:func:`stack_layers` goes back (a training checkpoint served).
``forward`` and ``loss_fn`` take that layout and train every family:
the encoder and its cross-attentions, the vision prefix (whose positions
carry no loss), the MoE layer on B8's forward and backward, the SSD and
RG-LRU scans through autograd, and every attention (local windows too) on
``layers.chunked_attention``'s hand-written backward.  Remat is per
block, or two-level where ``cfg.scan_remat_chunk`` divides a stack's
group count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.csr import BlockCSR
from repro_torch.distributed.sharding import recompute_context
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

ATTENTION = ("attn", "local_attn")
# the block kinds and the FFN each ported family stacks
FAMILIES = {"dense": ({"attn"}, "dense"), "moe": ({"attn"}, "moe"),
            "hybrid": ({"rglru", "local_attn"}, "dense"),
            "ssm": ({"ssm"}, "none"), "audio": ({"attn"}, "dense"),
            "vlm": ({"attn"}, "dense")}


def _attn_cfg(cfg: ModelConfig, kind: str = "attn") -> L.AttnConfig:
    return L.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta, causal=kind != "enc_attn",
        window=cfg.window if kind == "local_attn" else None, norm=cfg.norm)


def _moe_cfg(cfg: ModelConfig) -> M.MoEConfig:
    return M.MoEConfig(
        d_model=cfg.d_model, n_experts=cfg.n_experts,
        n_experts_padded=cfg.n_experts_padded, top_k=cfg.top_k,
        d_expert=cfg.d_expert, capacity_factor=cfg.moe_capacity_factor,
        impl=cfg.moe_impl)


def _ssm_cfg(cfg: ModelConfig) -> S.SSMConfig:
    return S.SSMConfig(d_model=cfg.d_model, d_state=cfg.ssm_d_state,
                       headdim=cfg.ssm_headdim, chunk=cfg.ssm_chunk)


def _rglru_cfg(cfg: ModelConfig) -> R.RGLRUConfig:
    return R.RGLRUConfig(d_model=cfg.d_model, lru_width=cfg.lru_width)


def _check_ported(cfg: ModelConfig) -> None:
    """An encoder only in the audio family, a vision prefix only in the
    vlm family, each over global attention and the dense MLP."""
    unit, _, tail = cfg.layer_plan()
    kinds, ffn = FAMILIES.get(cfg.family, (set(), None))
    if (not set(unit + tail) <= kinds or cfg.ffn_kind != ffn
            or (cfg.n_enc_layers and cfg.family != "audio")
            or (cfg.n_patches and cfg.family != "vlm")):
        raise NotImplementedError(
            f"{cfg.name} (family={cfg.family!r}, pattern={unit}, "
            f"n_enc_layers={cfg.n_enc_layers}, n_patches={cfg.n_patches}) "
            f"is not ported yet: the port serves dense and MoE models with "
            f"global attention, the hybrid RG-LRU + local-attention family, "
            f"the SSM family, and an encoder (audio) or a vision prefix "
            f"(vlm) only over global attention and the dense MLP")


def _stacks(cfg: ModelConfig):
    """(tree key, kinds, layers) of each stacked group, in execution
    order: the unit's groups, then the tail."""
    unit, n_groups, tail = cfg.layer_plan()
    out = [("groups", unit, n_groups)]
    if tail:
        out.append(("tail", tail[:1], len(tail)))
    return out


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter / cache subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, BlockCSR):
        return tree.layer(i)
    return tree[i]


def _stacked_layers(group) -> List[Dict[str, Any]]:
    """The per-layer views of a stacked layer group (serving layout)."""
    if isinstance(group, list):
        raise TypeError("serving takes the stacked layout; this tree holds "
                        "per-layer lists (the trainer's)")
    leaf = group
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    n = leaf.blocks.shape[0] if isinstance(leaf, BlockCSR) else leaf.shape[0]
    return [_layer(group, i) for i in range(n)]


def _blocks(params, caches, cfg: ModelConfig):
    """Every block in execution order as (kind, its parameters, its
    cache's per-layer views), from the stacked ``params`` and ``caches``
    (state trees with the same ``groups`` / ``tail`` keys)."""
    for key, kinds, count in _stacks(cfg):
        per = [_stacked_layers(params[key][f"b{i}"])
               for i in range(len(kinds))]
        for li in range(count):
            for i, kind in enumerate(kinds):
                yield kind, per[i][li], _layer(caches[key][f"b{i}"], li)


def unstack_layers(params, *, copy: bool = True):
    """The trainer's layout: each stacked group becomes a list of
    per-layer subtrees whose leaves are tensors of their own (copies; a
    sparse weight keeps its one host pattern), or views of the stack
    without ``copy``.  Other leaves are shared with ``params``."""
    def own(t):
        if isinstance(t, dict):
            return {k: own(v) for k, v in t.items()}
        if not copy:
            return t
        if isinstance(t, BlockCSR):
            return dataclasses.replace(t, blocks=t.blocks.clone())
        return t.clone()

    def per_layer(groups):
        return {name: [own(p) for p in _stacked_layers(group)]
                for name, group in groups.items()}

    out = dict(params)
    for key in ("groups", "tail"):
        if key in params:
            out[key] = per_layer(params[key])
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"],
                              groups=per_layer(params["encoder"]["groups"]))
    return out


def stack_layers(params):
    """The serving layout from the trainer's (:func:`unstack_layers`'s
    inverse): each group's per-layer list stacked along a new leading
    axis; a sparse weight's layers must share one pattern."""
    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([l[k] for l in layers]) for k in first}
        if isinstance(first, BlockCSR):
            for l in layers[1:]:
                if not all(np.array_equal(getattr(l, f), getattr(first, f))
                           for f in ("block_col", "block_row", "row_ptr")):
                    raise ValueError("stacked sparse layers must share one "
                                     "pattern")
            return dataclasses.replace(
                first, blocks=torch.stack([l.blocks for l in layers]),
                device_meta={})
        return torch.stack(layers)

    def per_group(groups):
        return {name: stack(layers) for name, layers in groups.items()}

    out = dict(params)
    for key in ("groups", "tail"):
        if key in params:
            out[key] = per_group(params[key])
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"],
                              groups=per_group(params["encoder"]["groups"]))
    return out


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """The encoder's (seq, dim) f32 table: sin on even channels, cos on
    odd ones."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _init_block(generator, cfg: ModelConfig, kind: str, *, stack,
                dtype, cross: bool = False) -> Dict[str, Any]:
    """One stacked block of ``kind`` (``"enc_attn"``: an encoder block),
    with ``cross`` a cross-attention and its norm.  The sparse-MLP block
    mask is drawn from a fresh CPU generator seeded with
    ``cfg.sparse_mask_seed``, so every layer of every group shares one
    pattern, as in the reference."""
    dev = generator.device
    p = {"norm1": L.init_norm(cfg.d_model, cfg.norm, stack=stack,
                              device=dev)}
    if kind in ATTENTION or kind == "enc_attn":
        p["attn"] = L.init_attention(generator, _attn_cfg(cfg, kind), dtype,
                                     stack=stack)
    elif kind == "rglru":
        p["rglru"] = R.init_rglru(generator, _rglru_cfg(cfg), dtype,
                                  stack=stack)
    elif kind == "ssm":
        p["ssm"] = S.init_ssm(generator, _ssm_cfg(cfg), dtype, stack=stack)
    else:
        raise ValueError(kind)
    if cross:
        p["cross_norm"] = L.init_norm(cfg.d_model, cfg.norm, stack=stack,
                                      device=dev)
        p["cross"] = L.init_attention(generator, _attn_cfg(cfg, "enc_attn"),
                                      dtype, stack=stack)
    if cfg.ffn_kind == "none" or kind == "ssm":
        return p
    p["norm2"] = L.init_norm(cfg.d_model, cfg.norm, stack=stack, device=dev)
    if cfg.ffn_kind == "moe":
        p["moe"] = M.init_moe(generator, _moe_cfg(cfg), dtype, stack=stack)
    else:
        p["mlp"] = L.init_mlp(
            generator, cfg.d_model, cfg.d_ff, cfg.activation, dtype,
            stack=stack, sparse_down=cfg.sparse_mlp,
            sparse_block=cfg.sparse_block, sparse_density=cfg.sparse_density,
            mask_generator=torch.Generator().manual_seed(
                cfg.sparse_mask_seed))
    return p


def _cross(p, cfg: ModelConfig, x, k, v):
    """The cross-attention half of a decoder block over the encoder's
    K/V."""
    h = L.apply_norm(x, p["cross_norm"], cfg.norm)
    return x + L.cross_attention(p["cross"], _attn_cfg(cfg, "enc_attn"), h,
                                 k, v)


def _ffn(p, cfg: ModelConfig, x, mlp_plan=None):
    """The feed-forward half of a block: the MLP (a sparse one on
    ``mlp_plan`` where given), or the MoE layer for the MoE family; SSM
    blocks have none."""
    if "moe" in p:
        return x + M.moe_layer(p["moe"], _moe_cfg(cfg),
                               L.apply_norm(x, p["norm2"], cfg.norm))
    if "mlp" in p:
        return x + L.mlp(p["mlp"], L.apply_norm(x, p["norm2"], cfg.norm),
                         cfg.activation, sparse_plan=mlp_plan)
    return x


class _ShapeOnly(torch.Generator):
    """A generator whose draws are ``meta`` tensors: shapes and dtypes,
    no values (``torch.randn(..., device="meta")`` draws nothing)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                dtype=torch.float32, *, device="cuda"):
    """Random parameters, drawn from ``generator`` on ``device`` (the
    generator must live there).  ``device="meta"`` is the shape-only
    init (the reference's ``jax.eval_shape(init_params)``): every leaf a
    ``meta`` tensor of its shape and dtype, no draws, ``generator`` None
    (a sparse MLP's block pattern is still drawn on the host, from
    ``cfg.sparse_mask_seed``: it is structure, not values)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        generator = _ShapeOnly()
    elif generator is None or generator.device.type != dev.type:
        raise ValueError(f"generator is on "
                         f"{None if generator is None else generator.device}"
                         f", params go to {dev}: make the generator on the "
                         f"device")
    cross = cfg.n_enc_layers > 0
    params = {"embed_tokens": L.dense_init(generator,
                                           (cfg.vocab_padded, cfg.d_model),
                                           cfg.d_model, dtype)}
    for key, kinds, count in _stacks(cfg):
        params[key] = {f"b{i}": _init_block(generator, cfg, kind,
                                            stack=(count,), dtype=dtype,
                                            cross=cross)
                       for i, kind in enumerate(kinds)}
    params["final_norm"] = L.init_norm(cfg.d_model, cfg.norm, device=dev)
    params["lm_head"] = L.dense_init(generator,
                                     (cfg.vocab_padded, cfg.d_model),
                                     cfg.d_model, dtype)
    if cross:
        params["encoder"] = {
            "groups": {"b0": _init_block(generator, cfg, "enc_attn",
                                         stack=(cfg.n_enc_layers,),
                                         dtype=dtype)},
            "final_norm": L.init_norm(cfg.d_model, cfg.norm, device=dev)}
    if cfg.n_patches > 0:
        params["vis_proj"] = L.dense_init(generator,
                                          (cfg.d_model, cfg.d_model),
                                          cfg.d_model, dtype)
    return params


def sparse_mlp_plan(params, *, n_lanes: int = 8, chunk=None,
                    n_shards=None, n_col_shards=None,
                    autotune: bool = False):
    """The shared ``SpmmTrainPlan`` of a sparse-MLP model, built on the
    host from the first :class:`BlockCSR` in the tree (every layer shares
    its pattern), or ``None`` when the tree holds no sparse weight.
    ``autotune=True`` replaces ``n_lanes`` / ``chunk`` with a budgeted
    ``kernels.autotune`` search over the pattern (memoized per pattern);
    ``n_shards`` then bounds the searched device axis.  Otherwise
    ``n_shards`` / ``n_col_shards`` above 1 make both sides
    mesh-partitioned (the backward re-partitioned on the transposed
    pattern), as in the reference."""
    from repro_torch.kernels.autotune import auto_plan
    from repro_torch.kernels.schedule import plan_spmm_vjp

    def first_sparse(tree):
        if isinstance(tree, BlockCSR):
            return tree
        items = tree.values() if isinstance(tree, dict) else \
            tree if isinstance(tree, list) else ()
        for v in items:
            found = first_sparse(v)
            if found is not None:
                return found
        return None

    w = first_sparse(params)
    if w is None:
        return None
    if autotune:
        return auto_plan(w.layer(0) if w.stacked else w, trainable=True,
                         n_shards=n_shards, n_col_shards=n_col_shards)
    return plan_spmm_vjp(w, n_lanes=n_lanes, chunk=chunk, n_shards=n_shards,
                         n_col_shards=n_col_shards)


def _apply_block(p, cfg: ModelConfig, kind: str, x, positions, rope,
                 enc_out, mlp_plan):
    """One block over the full sequence (the reference's ``_apply_block``):
    its mixer (global, local-window or encoder attention, the RG-LRU or
    the SSD block), the cross-attention over the encoder output
    ``enc_out``'s K/V (projected here, so that remat recomputes them),
    then the FFN."""
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    if kind == "ssm":
        x = x + S.ssm_block(p["ssm"], _ssm_cfg(cfg), h)
    elif kind == "rglru":
        x = x + R.rglru_block(p["rglru"], _rglru_cfg(cfg), h)
    else:
        x = x + L.attention(p["attn"], _attn_cfg(cfg, kind), h, positions,
                            rope=rope)
    if enc_out is not None and "cross" in p:
        k, v = L.encode_kv(p["cross"], _attn_cfg(cfg, "enc_attn"), enc_out)
        x = _cross(p, cfg, x, k, v)
    return _ffn(p, cfg, x, mlp_plan)


def _run_block(p, cfg: ModelConfig, kind: str, x, positions, rope,
               enc_out, mlp_plan, remat: bool):
    """:func:`_apply_block`, under ``torch.utils.checkpoint`` with
    ``remat`` (non-reentrant: only the block's inputs are saved, the
    reference's ``nothing_saveable`` policy; the recompute under the mesh
    bound at the forward)."""
    if remat:
        return checkpoint(_apply_block, p, cfg, kind, x, positions, rope,
                          enc_out, mlp_plan, use_reentrant=False,
                          context_fn=recompute_context)
    return _apply_block(p, cfg, kind, x, positions, rope, enc_out, mlp_plan)


def _run_groups(groups, kinds, cfg: ModelConfig, x, positions, rope,
                enc_out, mlp_plan, remat: bool):
    """Consecutive groups (each the per-layer parameters of every kind of
    the unit) through :func:`_run_block`."""
    for group in groups:
        for p, kind in zip(group, kinds):
            x = _run_block(p, cfg, kind, x, positions, rope, enc_out,
                           mlp_plan, remat)
    return x


def apply_layers(layers, cfg: ModelConfig, x, *, mlp_plan=None):
    """``x`` (B, S, D) through consecutive attention blocks (per-layer
    parameter subtrees of the trainer's layout, e.g. a pipeline stage's
    share of ``unstack_layers(params)["groups"]["b0"]``) with
    :func:`forward`'s block function: positions ``0 .. S-1``, the RoPE
    tables made once, each block under remat."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    rope = _rope(cfg, positions)
    for p in layers:
        x = _run_block(p, cfg, "attn", x, positions, rope, None, mlp_plan,
                       True)
    return x


def forward(params, cfg: ModelConfig, batch, *, remat: bool = True,
            mlp_plan=None):
    """Full-sequence forward → logits ``(B, S, vocab_padded)`` (S counts
    a vision prefix), on the trainer's per-layer parameters
    (:func:`unstack_layers`), as the reference's: the prefix and tokens
    (:func:`_embed_inputs`); with an encoder, :func:`_encode` over
    ``batch["enc_frames"]`` first; then every stack of :func:`_stacks`
    (groups, then the tail), each block by its kind.

    ``mlp_plan`` is the shared ``SpmmTrainPlan`` of the sparse MLP
    (:func:`sparse_mlp_plan`); without it the sparse layers run the naive
    schedule.  ``remat`` recomputes each block (an encoder block too) in
    the backward instead of keeping its activations; where
    ``cfg.scan_remat_chunk > 1`` divides a stack's group count (the
    groups, then the tail, as in the reference; the encoder stays per
    block), the remat is two-level: an outer checkpoint over each run of
    that many consecutive groups keeps only the run's input, and the
    per-block checkpoints inside it are recomputed in its backward.  The
    reference's inner policy also saves the tensor-parallel projection
    outputs (``save_only_these_names("tp_proj_out")``) so that the
    forward's all-reduces are not run a third time; on one card there is
    no all-reduce, so it has no counterpart here."""
    _check_ported(cfg)
    stacks = _stacks(cfg)
    trees = [params[key] for key, _, _ in stacks]
    if cfg.n_enc_layers > 0:
        trees.append(params["encoder"]["groups"])
    if not all(isinstance(g, list) for t in trees for g in t.values()):
        raise TypeError("forward takes the trainer's per-layer layout: "
                        "pass lm.unstack_layers(params)")
    x, positions = _embed_inputs(params, cfg, batch)       # (B, S, D)
    rope = _rope(cfg, positions)
    enc_out = (_encode(params, cfg, batch["enc_frames"], remat=remat,
                       mlp_plan=mlp_plan)
               if cfg.n_enc_layers > 0 else None)
    chunk = cfg.scan_remat_chunk
    for key, kinds, count in stacks:
        groups = [[params[key][f"b{i}"][li] for i in range(len(kinds))]
                  for li in range(count)]
        if remat and chunk > 1 and count % chunk == 0:
            for c0 in range(0, count, chunk):
                x = checkpoint(_run_groups, groups[c0:c0 + chunk], kinds,
                               cfg, x, positions, rope, enc_out, mlp_plan,
                               True, use_reentrant=False,
                               context_fn=recompute_context)
        else:
            x = _run_groups(groups, kinds, cfg, x, positions, rope, enc_out,
                            mlp_plan, remat)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    return _logits(params, x)


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = True,
            mlp_plan=None):
    """Next-token cross-entropy plus z-loss, masked on ``labels < 0``; a
    vision prefix's positions carry no loss (its labels padded with -1,
    as in the reference).  Returns ``(loss, {"loss": nll, "z_loss": ...,
    "tokens": ...})``."""
    logits = forward(params, cfg, batch, remat=remat,
                     mlp_plan=mlp_plan).float()
    labels = batch["labels"]
    if cfg.n_patches > 0:
        labels = torch.cat([labels.new_full(
            (labels.shape[0], cfg.n_patches), -1), labels], dim=1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    z_loss = 1e-4 * torch.square(lse) * mask
    denom = torch.clamp(mask.sum(), min=1)
    loss = (nll + z_loss).sum() / denom
    return loss, {"loss": nll.sum().detach() / denom,
                  "z_loss": z_loss.sum().detach() / denom,
                  "tokens": mask.sum()}


# --------------------------------------------------------------------------
# serving: decode state, prefill, decode step
# --------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, kind: str, count: int, rows: int,
                 kv_shape, dtype, device) -> Dict[str, torch.Tensor]:
    """Zero decode cache of a stack of ``count`` blocks of ``kind``:
    K/V of per-layer shape ``kv_shape`` for attention, else the recurrent
    state of ``rows`` batch rows (``conv`` in ``dtype``, ``h`` / ``state``
    f32)."""
    if kind in ATTENTION:
        return {name: torch.zeros((count, *kv_shape), dtype=dtype,
                                  device=device) for name in ("k", "v")}
    if kind == "rglru":
        conv, h = R.init_rglru_state(_rglru_cfg(cfg), rows, dtype,
                                     stack=(count,), device=device)
        return {"conv": conv, "h": h}
    if kind == "ssm":
        conv, st = S.init_ssm_state(_ssm_cfg(cfg), rows, dtype,
                                    stack=(count,), device=device)
        return {"conv": conv, "state": st}
    raise ValueError(kind)


def _kv_len(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    """A static cache's K/V length: a local window keeps a rolling cache
    of ``min(max_seq, window)``; global attention keeps all of it."""
    return min(max_seq, cfg.window) if kind == "local_attn" else max_seq


def _static_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device) -> Dict[str, Any]:
    """``groups`` / ``tail`` decode caches of ``batch`` rows; with an
    encoder, every block also holds the cross K/V ``cross_k`` / ``cross_v``
    ``(L, B, enc_seq, KVH, hd)``."""
    caches = {}
    for key, kinds, count in _stacks(cfg):
        caches[key] = {}
        for i, kind in enumerate(kinds):
            c = _block_cache(cfg, kind, count, batch,
                             (batch, _kv_len(cfg, kind, max_seq),
                              cfg.n_kv_heads, cfg.head_dim), dtype, device)
            if cfg.n_enc_layers > 0:
                for name in ("cross_k", "cross_v"):
                    c[name] = torch.zeros(
                        (count, batch, cfg.enc_seq, cfg.n_kv_heads,
                         cfg.head_dim), dtype=dtype, device=device)
            caches[key][f"b{i}"] = c
    return caches


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.float32, *, device="cuda"):
    """Empty decode state: stacked per-kind caches (K/V ``(L, B, S_kv,
    KVH, hd)``, recurrent ``conv`` / ``h`` / ``state``, the cross K/V of
    an encoder-decoder model) and ``pos = 0``."""
    _check_ported(cfg)
    return {**_static_caches(cfg, batch, max_seq, dtype,
                             resolve_device(device)), "pos": 0}


def _logits(params, x):
    return torch.matmul(x, params["lm_head"].t())


def _rope(cfg: ModelConfig, positions):
    """The RoPE tables of ``positions`` when the model attends, else
    None (an SSM stack has no head dim)."""
    if not any(k in ATTENTION for k in cfg.block_kinds()):
        return None
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _mix_prefill(p, cfg: ModelConfig, kind: str, h, positions, rope,
                 max_seq: int, cache):
    """A block's temporal mixer over the prompt; writes the block's
    decode cache (per-layer views of the stacked cache) in place."""
    if kind in ATTENTION:
        h, kc, vc = L.attention_prefill(
            p["attn"], _attn_cfg(cfg, kind), h, positions,
            cache_len=_kv_len(cfg, kind, max_seq), rope=rope)
        cache["k"].copy_(kc)
        cache["v"].copy_(vc)
    elif kind == "rglru":
        h, (conv, hid) = R.rglru_block(p["rglru"], _rglru_cfg(cfg), h,
                                       return_state=True)
        cache["conv"].copy_(conv)
        cache["h"].copy_(hid)
    else:
        h, (conv, st) = S.ssm_block(p["ssm"], _ssm_cfg(cfg), h,
                                    return_state=True)
        cache["conv"].copy_(conv)
        cache["state"].copy_(st)
    return h


def _encode(params, cfg: ModelConfig, enc_frames, *, remat: bool = False,
            mlp_plan=None):
    """The whisper-style encoder over precomputed (stub) frame embeddings
    (B, enc_seq, D): the sinusoidal table added, then the non-causal
    blocks, whose attention also rotates by RoPE at the frame positions
    (as the reference's), and the final norm.  Takes the stacked layout
    (serving) or the trainer's per-layer one, whose blocks ``remat``
    recomputes in the backward."""
    x = enc_frames + sinusoidal_positions(
        enc_frames.shape[1], cfg.d_model,
        device=enc_frames.device).to(enc_frames.dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    group = params["encoder"]["groups"]["b0"]
    for p in group if isinstance(group, list) else _stacked_layers(group):
        x = _run_block(p, cfg, "enc_attn", x, positions, rope, None,
                       mlp_plan, remat)
    return L.apply_norm(x, params["encoder"]["final_norm"], cfg.norm)


def _embed_inputs(params, cfg: ModelConfig, batch):
    """Tokens, behind the vision prefix where the model has one
    (``vision_embeds`` (B, P, D) cast to the embeddings' dtype, then
    ``@ vis_proj``), → (B, S, D) and positions over the whole sequence."""
    x = params["embed_tokens"][batch["tokens"]]            # (B, S_text, D)
    if cfg.n_patches > 0:
        vis = batch["vision_embeds"].to(x.dtype)           # (B, P, D)
        x = torch.cat([torch.matmul(vis, params["vis_proj"]), x], dim=1)
    b, s, _ = x.shape
    return x, torch.arange(s, device=x.device).expand(b, s)


def prefill(params, cfg: ModelConfig, batch, *, max_seq: Optional[int] = None,
            cache_dtype=None, remat: bool = True,
            return_hidden: bool = False):
    """Process the prompt ``batch["tokens"]`` (B, S) — behind
    ``batch["vision_embeds"]`` (B, n_patches, D) in a vlm, beside
    ``batch["enc_frames"]`` (B, enc_seq, D) in an encoder-decoder model;
    return (last-position logits (B, 1, V) — or the final-norm hidden
    state with ``return_hidden`` — and the decode state with ``pos`` the
    sequence's length, the prefix included).  An encoder runs once and
    every decoder block's cross K/V go into its cache.

    K/V and conv caches take ``cache_dtype`` (default: the activations'
    dtype); recurrent hidden states stay f32.  ``remat`` is the
    reference's checkpointing switch; prefill here runs no backward, so it
    changes nothing and is accepted as given."""
    _check_ported(cfg)
    x, positions = _embed_inputs(params, cfg, batch)       # (B, S, D)
    b, s, _ = x.shape
    if max_seq is None:
        max_seq = s
    rope = _rope(cfg, positions)
    caches = _static_caches(cfg, b, max_seq,
                            x.dtype if cache_dtype is None else cache_dtype,
                            x.device)
    enc_out = (_encode(params, cfg, batch["enc_frames"])
               if cfg.n_enc_layers > 0 else None)
    for kind, p, cache in _blocks(params, caches, cfg):
        h = L.apply_norm(x, p["norm1"], cfg.norm)
        x = x + _mix_prefill(p, cfg, kind, h, positions, rope, max_seq,
                             cache)
        if enc_out is not None and "cross" in p:
            k, v = L.encode_kv(p["cross"], _attn_cfg(cfg, "enc_attn"),
                               enc_out)
            cache["cross_k"].copy_(k)
            cache["cross_v"].copy_(v)
            x = _cross(p, cfg, x, k, v)
        x = _ffn(p, cfg, x)
    state = {**caches, "pos": s}
    x = L.apply_norm(x[:, -1:], params["final_norm"], cfg.norm)
    if return_hidden:
        return x, state
    return _logits(params, x), state


def prefill_cross_kv(params, cfg: ModelConfig, state, enc_frames,
                     remat: bool = False):
    """Run the encoder once over ``enc_frames`` (B, enc_seq, D) and write
    every decoder block's cross K/V into ``state``'s caches in place (the
    reference returns an updated copy); returns the state.  ``remat`` as
    in :func:`prefill`."""
    _check_ported(cfg)
    if cfg.n_enc_layers <= 0:
        raise ValueError(f"{cfg.name} has no encoder")
    enc_out = _encode(params, cfg, enc_frames)
    acfg = _attn_cfg(cfg, "enc_attn")
    for _, p, cache in _blocks(params, state, cfg):
        k, v = L.encode_kv(p["cross"], acfg, enc_out)
        cache["cross_k"].copy_(k)
        cache["cross_v"].copy_(v)
    return dict(state)


def _mix_decode(p, cfg: ModelConfig, kind: str, h, cache, pos, rope,
                table=None):
    """A block's temporal mixer for one new token a row, against the
    static cache (``table`` None, ``pos`` a 0-dim device tensor) or the
    paged pool
    (``table`` and per-row ``pos`` on the device); caches are updated in
    place."""
    if kind in ATTENTION:
        acfg = _attn_cfg(cfg, kind)
        if table is None:
            h, _, _ = L.attention_decode(p["attn"], acfg, h, cache["k"],
                                         cache["v"], pos, rope=rope)
        else:
            h, _, _ = L.attention_decode_paged(p["attn"], acfg, h,
                                               cache["k"], cache["v"],
                                               table, pos, rope=rope)
    elif kind == "rglru":
        h, conv, hid = R.rglru_decode_step(p["rglru"], _rglru_cfg(cfg), h,
                                           cache["conv"], cache["h"])
        cache["conv"].copy_(conv)
        cache["h"].copy_(hid)
    else:
        h, conv, st = S.ssm_decode_step(p["ssm"], _ssm_cfg(cfg), h,
                                        cache["conv"], cache["state"])
        cache["conv"].copy_(conv)
        cache["state"].copy_(st)
    return h


def decode_step(params, cfg: ModelConfig, state, tokens, *,
                return_hidden: bool = False):
    """One decode step.  tokens: (B, 1) → (logits (B, 1, V) or the hidden
    state, new state).  The caches in ``state`` are updated in place and
    carried into the returned state with ``pos + 1``; a decoder block's
    cross-attention reads the cross K/V its cache holds.  ``state["pos"]``
    is an int, or a 0-dim integer tensor on the device (a captured step's
    position buffer); the returned ``pos`` is of the same kind.  The step
    never reads the position on the host: an int is filled into a device
    scalar once and the layers build their write indices and masks from
    it there."""
    _check_ported(cfg)
    pos = state["pos"]
    x = params["embed_tokens"][tokens]
    at = pos if torch.is_tensor(pos) else torch.full(
        (), int(pos), dtype=torch.long, device=x.device)
    rope = _rope(cfg, at.reshape(1, 1).expand(x.shape[0], 1))
    for kind, p, cache in _blocks(params, state, cfg):
        h = L.apply_norm(x, p["norm1"], cfg.norm)
        x = x + _mix_decode(p, cfg, kind, h, cache, at, rope)
        if "cross" in p:
            x = _cross(p, cfg, x, cache["cross_k"], cache["cross_v"])
        x = _ffn(p, cfg, x)
    new_state = dict(state, pos=pos + 1)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    if return_hidden:
        return x, new_state
    return _logits(params, x), new_state


# --------------------------------------------------------------------------
# serving: paged decode (continuous batching)
# --------------------------------------------------------------------------

def needs_kv_pages(cfg: ModelConfig) -> bool:
    """Does any layer keep a token-indexed KV history?  Pure-recurrent
    stacks (SSM / RG-LRU only) carry fixed-size state and need no pages."""
    return any(k in ATTENTION for k in cfg.block_kinds())


def history_horizon(cfg: ModelConfig) -> Optional[int]:
    """How many past tokens any layer can still read: ``None`` when some
    layer attends globally (unbounded), else the largest local window (0
    for pure-recurrent stacks).  The serving engine frees KV pages that
    fall entirely behind it."""
    horizon = 0
    for k in cfg.block_kinds():
        if k == "attn":
            return None
        if k == "local_attn":
            horizon = max(horizon, cfg.window or 0)
    return horizon


def init_paged_state(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int, max_pages: int, dtype=torch.float32, *,
                     device="cuda"):
    """Decode state for the continuous-batching engine, on ``device``.

    The attention K/V live in a physical page pool ``(L, n_pages,
    page_size, KVH, hd)`` shared by all ``n_slots`` slots through a block
    table ``(n_slots, max_pages)`` int32; a slot's memory is the pages
    allocated to it.  Page 0 is the dead page: free slots (table all 0,
    pos 0) write their garbage token there, and reads of unallocated
    logical pages land there too (masked by position).  Recurrent layers
    (RG-LRU / SSM conv and hidden state) keep a fixed-size row per slot,
    no pages; the engine's prefill-on-admit overwrites the admitted
    slot's rows.  ``pos`` ``(n_slots,)`` int32 is per slot."""
    if cfg.n_enc_layers > 0 or cfg.n_patches > 0:
        raise NotImplementedError(
            "paged decode supports decoder-only token models (enc-dec "
            "cross caches / vision prefixes still use the static path)")
    _check_ported(cfg)
    dev = resolve_device(device)
    kv_shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    state = {key: {f"b{i}": _block_cache(cfg, kind, count, n_slots,
                                          kv_shape, dtype, dev)
                   for i, kind in enumerate(kinds)}
             for key, kinds, count in _stacks(cfg)}
    state["table"] = torch.zeros((n_slots, max_pages), dtype=torch.int32,
                                 device=dev)
    state["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    return state


def decode_step_paged(params, cfg: ModelConfig, state, tokens, *,
                      return_hidden: bool = False):
    """One fused decode step over every engine slot, paged KV.

    tokens: (n_slots, 1), the pending token of each slot (free slots carry
    0 and write into the dead page).  Positions are per slot
    (``state["pos"]``, a device tensor, never read on the host); the
    attention layers read and write the shared page pool through
    ``state["table"]``, the recurrent layers their rows of per-slot
    state, all in place.  Returns ``(logits | hidden, new_state)`` with
    ``pos + 1``; ``return_hidden=True`` skips the dense ``lm_head`` so a
    ``SparseLogitHead`` can score the hidden states."""
    _check_ported(cfg)
    table, pos = state["table"], state["pos"]
    x = params["embed_tokens"][tokens]
    rope = _rope(cfg, pos[:, None])
    for kind, p, cache in _blocks(params, state, cfg):
        h = L.apply_norm(x, p["norm1"], cfg.norm)
        x = _ffn(p, cfg, x + _mix_decode(p, cfg, kind, h, cache, pos, rope,
                                         table))
    new_state = dict(state, pos=pos + 1)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    if return_hidden:
        return x, new_state
    return _logits(params, x), new_state
