"""Checkpoints: atomic, async, retained, elastic, patterns kept."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
