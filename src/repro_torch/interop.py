"""Plain-numpy constructors for the port's inputs.

The scheduler has no weights: its inputs are jobs, policies and markets.
These constructors build the port's objects from plain arrays and tuples, so
a caller holding another implementation's inputs (exported as numpy) feeds
the port the same data. The LM substrate's weights come across with
``params_from_reference``, the optimizer's state with
``opt_state_from_reference``.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.market import SLOTS_PER_UNIT, SpotMarket
from repro_torch.core.scheduler import Policy
from repro_torch.core.types import ChainJob, chain_from_arrays
from repro_torch.optim import OptState

__all__ = ["chain_jobs_from_arrays", "markets_from_prices",
           "policies_from_tuples", "chain_jobs_to_arrays",
           "params_from_reference", "opt_state_from_reference"]


def chain_jobs_from_arrays(arrival: Sequence[float],
                           deadline: Sequence[float],
                           z: Sequence[Sequence[float]],
                           delta: Sequence[Sequence[float]]) -> list[ChainJob]:
    """Chain jobs from per-job arrival/deadline and per-task work (z) and
    parallelism (delta) rows (ragged: one row per job)."""
    if not len(arrival) == len(deadline) == len(z) == len(delta):
        raise ValueError("arrival, deadline, z and delta need one entry per job")
    return [chain_from_arrays(a, d, zj, dj)
            for a, d, zj, dj in zip(arrival, deadline, z, delta)]


def chain_jobs_to_arrays(jobs) -> tuple[np.ndarray, np.ndarray, list, list]:
    """(arrival, deadline, z rows, delta rows) of any chain-job objects with
    ``arrival``/``deadline``/``tasks[i].z``/``tasks[i].delta`` fields."""
    return (np.array([j.arrival for j in jobs]),
            np.array([j.deadline for j in jobs]),
            [np.array([t.z for t in j.tasks]) for j in jobs],
            [np.array([t.delta for t in j.tasks]) for j in jobs])


def markets_from_prices(prices, slot: float = 1.0 / SLOTS_PER_UNIT,
                        p_ondemand: float = 1.0) -> list[SpotMarket]:
    """One market per per-slot price row of ``prices`` ((S, n_slots) or a
    single (n_slots,) row), on a slot grid of length ``slot``."""
    spu = int(round(1.0 / slot))
    if abs(spu * slot - 1.0) > 1e-12:
        raise ValueError(f"slot {slot} must divide one time unit")
    rows = np.atleast_2d(np.asarray(prices, dtype=np.float64))
    return [SpotMarket.from_prices(row, slots_per_unit=spu,
                                   p_ondemand=p_ondemand) for row in rows]


def policies_from_tuples(
        tuples: Iterable[tuple[float, float] | tuple[float, float, float | None]]
) -> list[Policy]:
    """Policies from (beta, bid) or (beta, bid, beta0) tuples."""
    return [Policy(float(t[0]), float(t[1]),
                   None if len(t) < 3 or t[2] is None else float(t[2]))
            for t in tuples]


def params_from_reference(cfg, tree) -> dict[str, torch.Tensor]:
    """The state dict of the port's model for ``cfg`` (``models.build``)
    from the reference's parameter tree: nested dicts of numpy arrays, the
    per-layer leaves stacked on a leading axis under ``"layers"`` (and the
    encoder-decoder's ``"enc_layers"`` and ``"dec_layers"``). Leaf
    ``layers/attn/wq`` row ``l`` becomes ``layers.<l>.attn.wq`` (and
    ``layers/ffn/experts/w_gate`` ``layers.<l>.ffn.experts.w_gate``);
    other leaves (``embed``, the hybrid's ``meta``, the vlm's
    ``vision_proj``) keep their path."""
    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
              "dec_layers": cfg.n_layers}
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, sub in node.items():
                walk(sub, path + (key,))
            return
        arr = torch.from_numpy(np.array(node, dtype=np.float32))
        if path[0] not in stacks:
            out[".".join(path)] = arr
            return
        n = stacks[path[0]]
        if arr.shape[0] != n:
            raise ValueError(f"{'/'.join(path)} has {arr.shape[0]} layers, "
                             f"the config {n}")
        for i in range(n):
            out[".".join((path[0], str(i)) + path[1:])] = arr[i]

    walk(tree, ())
    return out


def opt_state_from_reference(cfg, state):
    """The port's ``optim.OptState`` from the reference's (anything with
    ``step``, ``m`` and ``v``: the step a scalar, the moments parameter
    trees as ``params_from_reference`` takes them), keyed by the port's
    parameter names; CPU tensors, the step int32."""
    return OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        m=params_from_reference(cfg, state.m),
        v=params_from_reference(cfg, state.v))
