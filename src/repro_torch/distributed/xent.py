"""Mean token-level cross entropy (the reference's ``distributed/xent.py``,
without its sharding constraint: the port's trainer runs on one card).

The log-sum-exp is taken in float32 with the row max detached, and the
label's logit is picked by a one-hot product, as the reference does. The
one-hot is float32 (a scatter into zeros, not ``F.one_hot``'s int64)."""

from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(logits, labels, mask=None):
    """logits (B, S, V), labels (B, S) int; ``mask`` (B, S) weights the
    tokens. Returns the 0-d float32 mean."""
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]
    onehot = torch.zeros_like(x).scatter_(-1, labels[..., None].long(), 1.0)
    picked = torch.einsum("bsv,bsv->bs", x, onehot)
    nll = lse - picked
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
