"""What every family of the model zoo shares for training: ``loss`` (the
reference's ``Model.loss``), the embedding lookup and the LM head
(``_lookup``, ``_head``), ``param_count``, ``remat``, which recomputes a
block in the backward (the reference's ``jax.checkpoint`` per block under
``cfg.remat``), and ``layer_axes``, which spells a family's per-layer
logical axes out over the port's state-dict names.

Under a vocab split (the meshed train step; the model's own ``Split``,
``distributed/tensor_parallel.py``) the embedding and the head hold the
rank's vocab rows: the lookup is masked to them and all-reduced, the
logits stay split into the vocab-parallel cross entropy and are never
gathered whole."""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.xent import cross_entropy

__all__ = ["LM", "AUX_LOSS_WEIGHT", "remat", "layer_axes"]

AUX_LOSS_WEIGHT = 0.01  # MoE load-balance loss weight


def remat(cfg, fn, *args):
    """``fn(*args)``; under ``cfg.remat`` with grad enabled, through
    ``torch.utils.checkpoint`` (non-reentrant): the block keeps only its
    inputs and runs again in the backward. Serving (grad disabled) calls
    ``fn`` as it is."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def layer_axes(prefix: str, n: int, tree: dict) -> dict:
    """The reference's axes of a scan-stacked subtree (``tree``: nested
    dicts of logical-axis tuples, without the leading ``"layers"`` entry)
    as the port's flat names: ``<prefix>.<l>.<path>`` for l < n."""
    flat = {}

    def walk(node, path):
        for key, sub in node.items():
            if isinstance(sub, dict):
                walk(sub, path + (key,))
            else:
                flat[".".join(path + (key,))] = sub

    walk(tree, ())
    return {f"{prefix}.{i}.{k}": v for i in range(n) for k, v in flat.items()}


class LM(nn.Module):
    """Base of the families: ``forward(batch) -> (logits, aux)``."""

    def loss(self, batch: dict):
        """Mean next-token cross entropy over ``batch["labels"]`` plus
        ``AUX_LOSS_WEIGHT`` times the MoE aux; a vlm's logits keep only
        their last ``labels.shape[1]`` positions (its patch positions
        dropped). 0-d float32."""
        logits, aux = self(batch)
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:, :]
        return cross_entropy(logits, labels, split=tp.split_of(self)) \
            + AUX_LOSS_WEIGHT * aux

    def _lookup(self, tokens):
        """The float32 embedding rows of ``tokens``; under a vocab split
        each rank looks up the tokens in its rows, zero elsewhere, and the
        ranks' rows are summed."""
        split = tp.split_of(self)
        if split is None:
            return self.embed[tokens]
        local = tokens.long() - split.lo
        mine = (local >= 0) & (local < split.hi - split.lo)
        x = self.embed[local.clamp(0, split.hi - split.lo - 1)] \
            * mine[..., None]
        return tp.reduce_from_model(x, split.mesh)

    def _head(self, x, head):
        """Logits of the normed ``x`` against ``head`` (D, V); the rank's
        vocab columns under a split."""
        split = tp.split_of(self)
        if split is not None:
            x = tp.copy_to_model(x, split.mesh)
        return torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
