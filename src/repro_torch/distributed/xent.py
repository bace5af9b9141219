"""Mean token-level cross entropy (the reference's ``distributed/xent.py``).

The log-sum-exp is taken in float32 with the row max detached, and the
label's logit is picked by a one-hot product, as the reference does. The
one-hot is float32 (a scatter into zeros, not ``F.one_hot``'s int64).

With a vocab ``split`` (the meshed train step's, ``tensor_parallel.Split``)
the logits are the rank's vocab columns ``split.lo:split.hi`` and stay so,
as the reference's sharding constraint keeps them: the max is an
all-reduce (max, no gradient), and the sum of ``exp`` with the one-hot sum
restricted to the rank's range go through one all-reduce (sum) together.
Whole logits are never gathered."""

from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as tp

__all__ = ["cross_entropy"]


def cross_entropy(logits, labels, mask=None, split=None):
    """logits (B, S, V), labels (B, S) int; ``mask`` (B, S) weights the
    tokens; ``split``: logits of the rank's vocab slice. Returns the 0-d
    float32 mean."""
    x = logits.float()
    if split is None:
        m = x.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]
        onehot = torch.zeros_like(x).scatter_(-1, labels[..., None].long(),
                                              1.0)
        picked = torch.einsum("bsv,bsv->bs", x, onehot)
    else:
        m = tp.max_over_model(x.amax(dim=-1, keepdim=True), split.mesh)
        local = labels[..., None].long() - split.lo
        mine = (local >= 0) & (local < x.shape[-1])
        onehot = torch.zeros_like(x).scatter_(
            -1, local.clamp(0, x.shape[-1] - 1), mine.float())
        sums = tp.reduce_from_model(torch.stack([
            torch.exp(x - m).sum(dim=-1),
            torch.einsum("bsv,bsv->bs", x, onehot)]), split.mesh)
        lse = torch.log(sums[0]) + m[..., 0]
        picked = sums[1]
    nll = lse - picked
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
