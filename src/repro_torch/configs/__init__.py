"""Architecture registry: --arch <id> resolves here.  Only the ported
architectures are listed."""

from repro_torch.configs import granite_moe_3b, qwen3_4b
from repro_torch.configs.base import ModelConfig, pad_to

ARCHS = {
    "qwen3-4b": qwen3_4b,
    "granite-moe-3b-a800m": granite_moe_3b,
}


def get_config(name: str) -> ModelConfig:
    return ARCHS[name].config()


def get_smoke_config(name: str) -> ModelConfig:
    return ARCHS[name].smoke_config()


__all__ = ["ARCHS", "ModelConfig", "get_config", "get_smoke_config",
           "pad_to"]
