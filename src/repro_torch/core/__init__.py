"""STLT math: nodes, adaptive masks, scan algebra and the STLT layer."""
from repro_torch.core.nodes import exponential_window, half_lives, init_nodes, node_poles

__all__ = ["exponential_window", "half_lives", "init_nodes", "node_poles"]
