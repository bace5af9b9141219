"""Pipeline parallelism: GPipe-style microbatched pipelining over a
``stage`` mesh dim (the reference's ``distributed/pipeline.py``).

Each rank of the dim holds one stage's parameters. Time is unrolled into
``n_micro + n_stages - 1`` ticks; at every tick each stage processes the
activation it holds and sends the result to its successor (a collective
permute), while stage 0 injects the next microbatch — the standard
fill/steady/drain schedule. Bubble fraction = (S-1)/(M+S-1), so callers
pick M >> S.
"""

from __future__ import annotations

import torch

from repro_torch.engine.mesh import all_reduce, dim_rank, permute

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn, stage_params, x, n_stages: int, mesh,
                   axis: str = "stage"):
    """Run ``x`` through ``n_stages`` pipeline stages over the dim ``axis``
    of ``mesh`` (a ``DeviceMesh`` or ``GridMesh``, passed explicitly);
    every rank of the dim calls it with the same arguments.

    stage_fn:      (params_one_stage, activation (B_micro, ...)) -> same shape
    stage_params:  dict of tensors with a leading ``n_stages`` dim (or one
                   such tensor); each rank takes its own slice
    x:             (n_micro, B_micro, ...) microbatched activations

    Returns (n_micro, B_micro, ...) outputs of the final stage on every
    rank. Collectives: one collective permute per tick (the activation
    ring, stage i -> i + 1) and one all-reduce (the last stage's outputs,
    the others' zeros: a permute cannot broadcast one-to-many)."""
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    idx = dim_rank(mesh, axis)
    p_one = {k: v[idx] for k, v in stage_params.items()} \
        if isinstance(stage_params, dict) else stage_params[idx]
    state = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(ticks):
        cur = x[min(t, n_micro - 1)] if idx == 0 and t < n_micro else state
        y = stage_fn(p_one, cur)
        # Last stage emits microbatch t - (n_stages - 1).
        out_t = t - (n_stages - 1)
        if idx == n_stages - 1 and out_t >= 0:
            outs[out_t] = y
        state = permute(mesh, y, dim=axis)
    if idx != n_stages - 1:
        outs.zero_()
    return all_reduce(mesh, outs, dim=axis, op="sum")
