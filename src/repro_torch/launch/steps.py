"""Step factories (the reference's ``launch/steps.py``, without shardings):
the train step with gradient accumulation, and the greedy serve steps."""

from __future__ import annotations

import torch

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def make_train_step(model, optimizer, n_microbatches: int = 1):
    """``train_step(opt_state, batch) -> (opt_state, metrics)`` on the
    model's parameters, which ``optimizer.update`` changes in place.

    ``batch`` is a dict of tensors on the model's device. With
    ``n_microbatches`` n > 1 the batch is cut into the reference's
    contiguous slices (``x.reshape((n, B // n) + ...)[i]``), each one's
    backward accumulates into the float32 ``.grad`` of the masters, and
    grads and loss are divided by n. Metrics: ``loss``, ``grad_norm`` and
    ``step``, 0-d tensors on the device (nothing is read back)."""
    params = dict(model.named_parameters())
    n = n_microbatches

    def train_step(opt_state, batch):
        for p in params.values():
            p.grad = None
        if n == 1:
            loss = model.loss(batch)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), device=next(iter(params.values())).device)
            for i in range(n):
                mb = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                      for k, x in batch.items()}
                mb_loss = model.loss(mb)
                mb_loss.backward()
                loss = loss + mb_loss.detach()
            div = torch.tensor(float(n), device=loss.device)
            loss = loss / div
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(div)
        grads = {k: p.grad for k, p in params.items()}
        _, opt_state, gnorm = optimizer.update(grads, opt_state, params)
        for p in params.values():     # the grads' memory, free until the next
            p.grad = None
        return opt_state, {"loss": loss, "grad_norm": gnorm,
                           "step": opt_state.step.clone()}

    return train_step


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
