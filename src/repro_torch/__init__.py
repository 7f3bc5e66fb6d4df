"""PyTorch port of the STLT reproduction, for NVIDIA Hopper (H100).

Mirrors the JAX package ``repro`` module by module (``configs``, ``core``,
``kernels``, ``models``, ``serving``, ``optim``, ``data``, ``launch``) and
imports nothing from it. Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""
