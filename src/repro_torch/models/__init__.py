"""The LM substrate's model zoo: the decoders (dense, MoE, vision), the
Mamba-2 stack, the Hymba hybrid and the encoder-decoder (``api.build``)."""

from repro_torch.models.api import build
from repro_torch.models.config import ModelConfig

__all__ = ["build", "ModelConfig"]
