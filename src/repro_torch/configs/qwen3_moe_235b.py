"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, qk-norm
[hf:Qwen/Qwen3-235B-A22B]."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab_size=151_936, qk_norm=True, rope_theta=1e6,
        n_experts=128, n_experts_padded=128, top_k=8, d_expert=1536,
        moe_impl="ep_a2a",
        train_microbatches=16,
        bf16_first_moment=True,
        scan_remat_chunk=2, grad_accum_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=512, n_experts=8,
        n_experts_padded=8, top_k=2, d_expert=32, vocab_pad_multiple=64,
        moe_impl="gspmd",
        moe_capacity_factor=4.0, train_microbatches=1,
    )
