"""Greedy and sampled generation."""
from repro_torch.serving.engine import ServeEngine

__all__ = ["ServeEngine"]
