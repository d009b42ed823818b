"""whisper-base [audio]: encoder-decoder backbone; the conv frontend is a
stub — ``input_specs()`` provides precomputed frame embeddings
(B, enc_seq, D) [arXiv:2212.04356].  enc_seq = 1536 (1500 mel frames
padded for chunking)."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab_size=51_865, activation="gelu", norm="layernorm",
        n_enc_layers=6, enc_seq=1536,
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, n_enc_layers=2, enc_seq=24,
        vocab_pad_multiple=64, train_microbatches=1,
    )
