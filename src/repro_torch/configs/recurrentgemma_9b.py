"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 attn:recurrent
pattern (rec, rec, local-attn) [arXiv:2402.19427]."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256_000,
        pattern_unit=("rglru", "rglru", "local_attn"),
        window=2048, lru_width=4096, activation="gelu_glu",
        train_microbatches=8,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=512, window=16, lru_width=64,
        vocab_pad_multiple=64, train_microbatches=1,
    )
