"""granite-moe-3b-a800m [moe]: 40 experts top-8, padded to 48 for EP-16
divisibility (pads are never routed)
[hf:ibm-granite/granite-3.0-3b-a800m-base]."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49_155,
        n_experts=40, n_experts_padded=48, top_k=8, d_expert=512,
        moe_impl="ep_a2a",
        train_microbatches=8,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=512, n_experts=8,
        n_experts_padded=8, top_k=2, d_expert=32, vocab_pad_multiple=64,
        moe_impl="gspmd",
        moe_capacity_factor=4.0, train_microbatches=1,
    )
