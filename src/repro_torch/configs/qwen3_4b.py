"""qwen3-4b [dense]: GQA + qk-norm, no QKV bias [hf:Qwen/Qwen3-8B]."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=9728, vocab_size=151_936, qk_norm=True, rope_theta=1e6,
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, vocab_pad_multiple=64,
        train_microbatches=1,
    )
