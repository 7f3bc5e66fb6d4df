"""Checkpoints of the port, in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpointer import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]
