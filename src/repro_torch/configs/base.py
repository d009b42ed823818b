"""Model configuration schema and the assigned input-shape grid (port of
``repro.configs.base``).

The fields are those the ported serving and training paths (and
:func:`input_specs`) read or refuse.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # local-attention window
    # block pattern
    pattern_unit: Tuple[str, ...] = ("attn",)
    # ffn
    activation: str = "silu"              # silu | gelu_glu | gelu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    # moe
    n_experts: int = 0
    n_experts_padded: int = 0
    top_k: int = 0
    d_expert: int = 0
    # ssm (mamba2)
    ssm_d_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    # rg-lru
    lru_width: int = 0
    # enc-dec / vlm inputs (whisper: n_layers = decoder layers)
    n_enc_layers: int = 0
    enc_seq: int = 0
    n_patches: int = 0
    # padding granularity for vocab sharding (16-way model × 128 lanes)
    vocab_pad_multiple: int = 2048
    moe_capacity_factor: float = 1.25
    moe_impl: str = "gspmd"       # "gspmd" | "ep_a2a" (all-to-all EP)
    # block-sparse MLP: the down-projection becomes a BlockCSR weight
    # driven by maple_spmm.  The block mask is sampled once from
    # `sparse_mask_seed` and shared by all layers, so the stacked weights
    # agree on one pattern.
    sparse_mlp: bool = False
    sparse_block: Tuple[int, int] = (64, 64)
    sparse_density: float = 0.25
    sparse_mask_seed: int = 0
    # training defaults
    train_microbatches: int = 1
    bf16_first_moment: bool = False   # Adam m in bf16 (giant configs)
    grad_accum_dtype: str = "float32"  # microbatch grad accumulator
    scan_remat_chunk: int = 0   # two-level (sqrt) remat over layer groups
    remat: bool = True

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def ffn_kind(self) -> str:
        if self.n_experts > 0:
            return "moe"
        if self.d_ff > 0:
            return "dense"
        return "none"

    def layer_plan(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(pattern unit, n_groups, homogeneous tail)."""
        k = len(self.pattern_unit)
        n_groups = self.n_layers // k
        rem = self.n_layers - n_groups * k
        tail = tuple(self.pattern_unit[:rem])
        if len(set(tail)) > 1:
            raise ValueError(f"heterogeneous tail {tail} unsupported")
        return self.pattern_unit, n_groups, tail

    def block_kinds(self) -> Tuple[str, ...]:
        unit, g, tail = self.layer_plan()
        return unit * g + tail

    def param_count(self, active_only: bool = False) -> int:
        """Parameters of the model, as the reference counts them
        (embedding and head, attention, cross-attention and encoder, the
        FFN or the experts — ``active_only`` counts ``top_k`` of them — the
        router, and the RG-LRU and SSM mixers)."""
        kinds = self.block_kinds()
        d, hd = self.d_model, self.head_dim
        n_attn = sum(1 for k in kinds if k in ("attn", "local_attn"))
        n_rec = sum(1 for k in kinds if k == "rglru")
        n_ssm = sum(1 for k in kinds if k == "ssm")
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        p = self.vocab_padded * d * 2                   # embed + head
        p += n_attn * attn
        if self.n_enc_layers > 0:   # cross-attention in every decoder layer
            p += self.n_layers * attn
            p += self.n_enc_layers * (attn + 2 * d * self.d_ff
                                      + d * self.d_ff)
        if self.ffn_kind == "dense":
            gated = 3 if self.activation in ("silu", "gelu_glu") else 2
            p += (n_attn + n_rec) * gated * d * self.d_ff
        elif self.ffn_kind == "moe":
            experts = self.top_k if active_only else self.n_experts
            p += (n_attn + n_rec) * experts * 3 * d * self.d_expert
            p += (n_attn + n_rec) * d * self.n_experts
        if n_rec:
            w = self.lru_width
            p += n_rec * (2 * d * w + 2 * w * w + w * d)
        if n_ssm:
            di = 2 * d
            n = self.ssm_d_state
            p += n_ssm * (d * (2 * di + 2 * n + di // self.ssm_headdim)
                          + di * d)
        return p


# --------------------------------------------------------------------------
# the assigned shape grid
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(applicable?, reason-if-not).  long_500k needs sub-quadratic
    attention — run only for SSM / hybrid archs."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("pure full-attention arch: 524k dense-KV decode is "
                       "the quadratic-memory regime this shape excludes")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Stand-ins for a step's batch argument: ``device="meta"`` tensors
    (shape and dtype, no storage) where the reference returns
    ``jax.ShapeDtypeStruct``s of the same shapes.

    For train/prefill, ``seq_len`` is the *total* sequence (the VLM's
    vision prefix counts toward it); decode specs are the single new
    token against a ``seq_len``-deep cache."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    i32 = torch.int32
    specs: Dict[str, torch.Tensor] = {}
    text_len = s - (cfg.n_patches if cfg.n_patches > 0 else 0)

    if shape.kind in ("train", "prefill"):
        specs["tokens"] = meta((b, text_len), i32)
        if shape.kind == "train":
            specs["labels"] = meta((b, text_len), i32)
        if cfg.n_patches > 0:
            specs["vision_embeds"] = meta((b, cfg.n_patches, cfg.d_model),
                                          dtype)
        if cfg.n_enc_layers > 0:
            specs["enc_frames"] = meta((b, cfg.enc_seq, cfg.d_model), dtype)
    else:  # decode: one new token against a seq_len-deep cache/state
        specs["tokens"] = meta((b, 1), i32)
    return specs
