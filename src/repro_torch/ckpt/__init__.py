"""The trainer's checkpoints (the reference's ``repro.ckpt``)."""

from repro_torch.ckpt.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
