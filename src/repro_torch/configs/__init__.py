"""Architecture registry: --arch <id> resolves here.  Every reference
architecture, under the reference's names."""

from repro_torch.configs import (granite_moe_3b, internvl2_1b, mamba2_2_7b,
                                 minitron_8b, qwen2_7b, qwen2_72b, qwen3_4b,
                                 qwen3_moe_235b, recurrentgemma_9b,
                                 whisper_base)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                      input_specs, pad_to, shape_applicable)

ARCHS = {
    "recurrentgemma-9b": recurrentgemma_9b,
    "qwen3-4b": qwen3_4b,
    "qwen2-7b": qwen2_7b,
    "qwen2-72b": qwen2_72b,
    "minitron-8b": minitron_8b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "mamba2-2.7b": mamba2_2_7b,
    "whisper-base": whisper_base,
    "internvl2-1b": internvl2_1b,
}


def get_config(name: str) -> ModelConfig:
    return ARCHS[name].config()


def get_smoke_config(name: str) -> ModelConfig:
    return ARCHS[name].smoke_config()


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "get_smoke_config", "input_specs", "pad_to", "shape_applicable"]
