"""The trainer's deterministic synthetic data pipeline (the reference's
``repro.data``)."""

from repro_torch.data.pipeline import SyntheticTokens, make_batches

__all__ = ["SyntheticTokens", "make_batches"]
