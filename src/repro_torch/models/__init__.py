"""Model layers, the LM over every family and its mixers: the MoE
layer, the RG-LRU and the SSD block."""
from repro_torch.models import layers, lm, moe, rglru, ssm

__all__ = ["layers", "lm", "moe", "rglru", "ssm"]
