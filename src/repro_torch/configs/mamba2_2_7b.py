"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=50_280,
        pattern_unit=("ssm",), ssm_d_state=128, ssm_headdim=64,
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, vocab_size=512,
        ssm_d_state=16, ssm_headdim=16, ssm_chunk=32,
        vocab_pad_multiple=64, train_microbatches=1,
    )
