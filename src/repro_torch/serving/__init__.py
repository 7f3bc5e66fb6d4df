"""Serving: ``ServeEngine.generate`` and continuous ``serve`` with the
prefix cache."""
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.prefix_cache import PrefixCache

__all__ = ["PrefixCache", "Request", "ServeEngine"]
