"""Model layers and the decoder-only LM (serving path)."""
from repro_torch.models import layers, lm

__all__ = ["layers", "lm"]
