"""STLT math: nodes, adaptive masks, scan algebra and the STLT layer."""
