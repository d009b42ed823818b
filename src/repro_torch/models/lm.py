"""Decoder-only LM for serving (port of the dense family of
``repro.models.lm``): ``init_params``, ``init_decode_state``, ``prefill``
and ``decode_step``.

The parameter tree keeps the reference's scanned layout: every leaf under
``params["groups"]["b<i>"]`` carries a leading layer axis, and a stacked
block-sparse MLP weight is one :class:`BlockCSR` with a
``(L, nnzb, bm, bk)`` payload over a shared pattern.  The layer loop is a
Python loop over that axis.  Decode caches are updated in place.

Not ported yet: MoE, SSM, RG-LRU, local-window and cross attention, QKV
biases, the vision prefix, paged decode, and training (``forward`` /
``loss_fn``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.csr import BlockCSR
from repro_torch.models import layers as L


def _attn_cfg(cfg: ModelConfig) -> L.AttnConfig:
    return L.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta)


def _check_ported(cfg: ModelConfig) -> None:
    unit, _, tail = cfg.layer_plan()
    if (cfg.family != "dense" or cfg.ffn_kind != "dense"
            or set(unit) != {"attn"} or tail or cfg.n_enc_layers
            or cfg.n_patches or cfg.qkv_bias):
        raise NotImplementedError(
            f"{cfg.name} (family={cfg.family!r}, pattern={unit}) is not "
            f"ported yet: only decoder-only dense models with global "
            f"attention are")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter / cache subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, BlockCSR):
        return tree.layer(i)
    return tree[i]


def _init_block(generator, cfg: ModelConfig, *, stack, dtype,
                mask_generator) -> Dict[str, Any]:
    dev = generator.device
    return {
        "norm1": L.init_norm(cfg.d_model, cfg.norm, stack=stack, device=dev),
        "attn": L.init_attention(generator, _attn_cfg(cfg), dtype,
                                 stack=stack),
        "norm2": L.init_norm(cfg.d_model, cfg.norm, stack=stack, device=dev),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                          dtype, stack=stack, sparse_down=cfg.sparse_mlp,
                          sparse_block=cfg.sparse_block,
                          sparse_density=cfg.sparse_density,
                          mask_generator=mask_generator),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, *, device="cuda"):
    """Random parameters, drawn from ``generator`` on ``device`` (the
    generator must live there).  The sparse-MLP block mask is drawn from
    a CPU generator seeded with ``cfg.sparse_mask_seed``, so every layer
    shares one pattern, as in the reference."""
    _check_ported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params go to "
                         f"{dev}: make the generator on the device")
    _, n_groups, _ = cfg.layer_plan()
    mask_gen = torch.Generator().manual_seed(cfg.sparse_mask_seed)
    return {
        "embed_tokens": L.dense_init(generator,
                                     (cfg.vocab_padded, cfg.d_model),
                                     cfg.d_model, dtype),
        "groups": {"b0": _init_block(generator, cfg, stack=(n_groups,),
                                     dtype=dtype, mask_generator=mask_gen)},
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, device=dev),
        "lm_head": L.dense_init(generator, (cfg.vocab_padded, cfg.d_model),
                                cfg.d_model, dtype),
    }


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.float32, *, device="cuda"):
    """Empty decode state: stacked ``(L, B, max_seq, KVH, hd)`` caches and
    ``pos = 0``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    _, n_groups, _ = cfg.layer_plan()
    shape = (n_groups, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"groups": {"b0": {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev)}}, "pos": 0}


def _logits(params, x):
    return torch.matmul(x, params["lm_head"].t())


def prefill(params, cfg: ModelConfig, batch, *, max_seq: Optional[int] = None,
            return_hidden: bool = False):
    """Process the prompt ``batch["tokens"]`` (B, S); return (last-position
    logits (B, 1, V) — or the final-norm hidden state with
    ``return_hidden`` — and the decode state with ``pos = S``)."""
    _check_ported(cfg)
    tok = batch["tokens"]
    x = params["embed_tokens"][tok]                        # (B, S, D)
    b, s, _ = x.shape
    if max_seq is None:
        max_seq = s
    rope = L.rope_tables(torch.arange(s, device=x.device).expand(b, s),
                         cfg.head_dim, cfg.rope_theta)
    acfg = _attn_cfg(cfg)
    groups = params["groups"]["b0"]
    n_layers = groups["attn"]["wq"].shape[0]
    cache_shape = (n_layers, b, max_seq, cfg.n_kv_heads, cfg.head_dim)
    k_all = torch.empty(cache_shape, dtype=x.dtype, device=x.device)
    v_all = torch.empty(cache_shape, dtype=x.dtype, device=x.device)
    for li in range(n_layers):
        p = _layer(groups, li)
        h = L.apply_norm(x, p["norm1"], cfg.norm)
        h, kc, vc = L.attention_prefill(p["attn"], acfg, h, rope,
                                        cache_len=max_seq)
        k_all[li] = kc
        v_all[li] = vc
        x = x + h
        h = L.apply_norm(x, p["norm2"], cfg.norm)
        x = x + L.mlp(p["mlp"], h, cfg.activation)
    state = {"groups": {"b0": {"k": k_all, "v": v_all}}, "pos": s}
    x = L.apply_norm(x[:, -1:], params["final_norm"], cfg.norm)
    if return_hidden:
        return x, state
    return _logits(params, x), state


def decode_step(params, cfg: ModelConfig, state, tokens, *,
                return_hidden: bool = False):
    """One decode step.  tokens: (B, 1) → (logits (B, 1, V) or the hidden
    state, new state).  The caches in ``state`` are updated in place and
    carried into the returned state with ``pos + 1``."""
    _check_ported(cfg)
    pos = int(state["pos"])
    x = params["embed_tokens"][tokens]
    b = x.shape[0]
    rope = L.rope_tables(torch.full((b, 1), pos, device=x.device),
                         cfg.head_dim, cfg.rope_theta)
    acfg = _attn_cfg(cfg)
    groups = params["groups"]["b0"]
    caches = state["groups"]["b0"]
    for li in range(groups["attn"]["wq"].shape[0]):
        p = _layer(groups, li)
        h = L.apply_norm(x, p["norm1"], cfg.norm)
        h, _, _ = L.attention_decode(p["attn"], acfg, h, caches["k"][li],
                                     caches["v"][li], pos, rope)
        x = x + h
        h = L.apply_norm(x, p["norm2"], cfg.norm)
        x = x + L.mlp(p["mlp"], h, cfg.activation)
    new_state = {"groups": state["groups"], "pos": pos + 1}
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    if return_hidden:
        return x, new_state
    return _logits(params, x), new_state
