"""AdamW with decoupled weight decay and global-norm clipping (the
reference's ``optim/adamw.py``).

The state's moments are float32 and keyed by parameter name, like the
model's ``named_parameters``. ``update`` writes the new parameters and
moments in place under ``no_grad`` (the reference returns new trees): one
copy of the masters and the moments is on the card. Its arithmetic keeps
the reference's order: the clip scale, then m, v, the bias-corrected mh and
vh, then ``p - lr * (mh / (sqrt(vh) + eps) + wd * p)``. Nothing in it
reads a value back to the host: the step, the learning rate and the grad
norm stay 0-d tensors on the parameters' device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["AdamW", "OptState"]


@dataclasses.dataclass
class OptState:
    """The step count (0-d int32) and the float32 moments m and v, keyed by
    parameter name."""

    step: torch.Tensor
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        """Zero moments for ``params`` (name -> tensor), step 0, on the
        parameters' device."""
        zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                        device=p.device)
                         for n, p in params.items()}
        dev = next(iter(params.values())).device
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        m=zeros(), v=zeros())

    @staticmethod
    def global_norm(grads: dict) -> torch.Tensor:
        """The global norm of ``grads`` (name -> tensor), summed in their
        order: 0-d float32."""
        return torch.sqrt(sum(g.float().square().sum()
                              for g in grads.values()))

    @torch.no_grad()
    def update(self, grads: dict, state: OptState,
               params: dict[str, torch.Tensor], gnorm=None):
        """One step on ``params`` (name -> tensor) from ``grads`` (name ->
        tensor, or None for a parameter the loss did not reach: a zero
        gradient). Parameters, moments and step update in place. ``gnorm``
        is the global norm when ``params`` and ``grads`` are a rank's shards
        of the whole (the meshed step takes it over the whole gradients);
        None takes it over ``grads``. Returns (params, state, grad_norm):
        the global norm before clipping, 0-d."""
        gs = {n: (torch.zeros_like(p) if grads.get(n) is None else grads[n])
              for n, p in params.items()}
        if gnorm is None:
            gnorm = self.global_norm(gs)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        state.step.add_(1)
        step = state.step
        lr = self.lr(step) if callable(self.lr) else self.lr
        c1 = 1.0 - self.b1 ** step.float()
        c2 = 1.0 - self.b2 ** step.float()
        for n, p in params.items():
            g = gs[n].float() * scale
            m = self.b1 * state.m[n] + (1 - self.b1) * g
            v = self.b2 * state.v[n] + (1 - self.b2) * g.square()
            mh = m / c1
            vh = v / c2
            new_p = p - lr * (mh / (vh.sqrt() + self.eps)
                              + self.weight_decay * p)
            p.copy_(new_p)
            state.m[n].copy_(m)
            state.v[n].copy_(v)
        return params, state, gnorm
