"""The reference's four examples on the port (counterparts of
``examples/*.py``), each a module run as::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.accelerator_sim --spgemm
    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    PYTHONPATH=src python -m repro_torch.examples.train_lm --sparse-mlp

Each takes the reference example's flags plus ``--device`` (default
``cuda``: no card raises, never a silent CPU run), prints the reference
example's text in its format, and is built from functions that return
what they print, with the numbers behind it.  Weights are drawn on the
CPU from a seed and then moved to the device, so that a CPU run and a
card run of one example start from the same weights; every function that
builds a model also takes ``params=`` (a stacked tree, as
``convert.params_from_numpy`` gives).
"""

from __future__ import annotations

from typing import List


def say(lines: List[str], text: str) -> None:
    """Print ``text`` and keep it in ``lines``."""
    print(text, flush=True)
    lines.append(text)


__all__ = ["say"]
