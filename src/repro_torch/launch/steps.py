"""Greedy serve steps (the reference's ``launch/steps.py``
``make_prefill_step`` and ``make_decode_step``, without shardings)."""

from __future__ import annotations

import torch

__all__ = ["make_prefill_step", "make_decode_step"]


def _greedy(logits):
    return logits[:, -1, :].argmax(dim=-1, keepdim=True).to(torch.int32)


def make_prefill_step(model, max_len: int | None = None):
    """(batch) -> (next_token (B, 1) int32, cache)."""
    def prefill_step(batch):
        logits, cache = model.prefill(batch, max_len=max_len)
        return _greedy(logits), cache

    return prefill_step


def make_decode_step(model):
    """One-token greedy serve step: (cache, token, pos) -> (next_token,
    cache)."""
    def decode_step(cache, token, pos: int):
        logits, cache = model.decode(cache, token, pos)
        return _greedy(logits), cache

    return decode_step
