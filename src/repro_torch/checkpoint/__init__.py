"""Checkpointing of solver state (counterpart of `repro.checkpoint`)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
