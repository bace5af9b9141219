"""Model zoo entry point: ``build(cfg, device)`` returns the family's
``nn.Module``, which exposes ``init_weights``, ``forward``, ``prefill``,
``decode``, ``init_cache``, ``axes``, ``cache_axes`` (the logical axes of
the parameters, keyed by state-dict name, and of the cache), ``loss`` and
``param_count`` with the same signatures in every family (the
encoder-decoder's ``init_cache`` also takes the encoder's length;
``loss`` and ``param_count`` come from ``models/lm.py``).
Every kind of the reference is ported: the decoder (dense, moe and vlm
share it, as in the reference), Mamba-2, the Hymba hybrid and the
encoder-decoder."""

from __future__ import annotations

from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import Decoder
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.lm import AUX_LOSS_WEIGHT
from repro_torch.models.ssm import Mamba

__all__ = ["build", "AUX_LOSS_WEIGHT"]

_FAMILIES = {"decoder": Decoder, "moe": Decoder, "vlm": Decoder,
             "ssm": Mamba, "hybrid": Hybrid, "encdec": EncDec}


def build(cfg: ModelConfig, device="cuda") -> nn.Module:
    """The model of ``cfg`` on ``device`` (default the GPU), weights not yet
    initialised."""
    dev = resolve_device(device)
    if cfg.kind not in _FAMILIES:
        raise ValueError(f"unknown model kind {cfg.kind!r}")
    return _FAMILIES[cfg.kind](cfg, dev)
