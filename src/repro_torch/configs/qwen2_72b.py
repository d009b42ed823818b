"""qwen2-72b [dense]: GQA with QKV bias, 80 layers [arXiv:2407.10671]."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab_size=152_064, qkv_bias=True, rope_theta=1e6,
        train_microbatches=8,
        bf16_first_moment=True,
        scan_remat_chunk=8, grad_accum_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, vocab_pad_multiple=64,
        train_microbatches=1,
    )
