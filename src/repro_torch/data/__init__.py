"""Synthetic data (port of ``repro.data``)."""

from repro_torch.data.pipeline import DataConfig, data_iterator, synth_batch

__all__ = ["DataConfig", "synth_batch", "data_iterator"]
