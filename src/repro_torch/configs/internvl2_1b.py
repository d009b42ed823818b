"""internvl2-1b [vlm]: the InternViT frontend is a stub —
``input_specs()`` provides precomputed patch embeddings (B, 256, D); the
backbone is the Qwen2-0.5B-class LM [arXiv:2404.16821]."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151_655, qkv_bias=True, rope_theta=1e6,
        n_patches=256,
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, n_patches=8,
        vocab_pad_multiple=64, train_microbatches=1,
    )
