"""PyTorch + CUDA port of the Maple reproduction (``repro``), for Hopper.

The package mirrors ``repro``'s layout module for module; ``repro`` (JAX
with Pallas TPU kernels) stays the reference the port is held against.
This package imports ``torch``, numpy and the standard library only.

Numerics: f32 parity with the reference needs full-precision float32
matrix products, so importing the package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` explicitly (TF32 keeps about
three decimal digits).

Entry points take an explicit ``device=`` that defaults to ``"cuda"``;
asking for CUDA on a machine without it raises (:func:`resolve_device`)
instead of carrying on silently on the CPU.  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available (never a silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch versions")
    return dev


__all__ = ["resolve_device"]
