"""``evaluate_grid`` — the single entry point of the port's evaluation engine.

Scores every job under every policy in every market scenario: the plan
layer (``plan.py``) dedups the grid into evaluation groups and builds their
plan tensors (on the card in float32 by default, see
``resolve_plan_backend``; on the host in float64 otherwise), the per-bid
market views go to the device as float32, and the cost kernels
(``backend.py``) fill the (S, J, P) result tensors. Runs on the card by
default; ``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.market import SpotMarket
from repro_torch.core.scheduler import Policy
from repro_torch.core.types import ChainJob
from repro_torch.device import resolve_device
from repro_torch.engine import backend
from repro_torch.engine.plan import _PLAN_BACKENDS, build_grid_plan
from repro_torch.engine.result import EngineResult
from repro_torch.engine.scenarios import MarketListBatch
from repro_torch.kernels.policy_cost import OUT_KEYS

__all__ = ["evaluate_grid", "resolve_plan_backend"]


def resolve_plan_backend(plan_backend: str, device="cuda",
                         pool: str = "dedicated") -> str:
    """Resolve where the plan tensors are built.

    ``"auto"`` builds them on the device (``"device"``) when the evaluation
    runs on a CUDA card with the dedicated pool — the reference's ``"auto"``
    on an accelerator — and on the host in float64 (``"host"``) on the CPU
    or with the shared pool, whose chronological replay is host code — the
    reference on the CPU. An explicit ``"device"`` is allowed on the CPU
    (the same float32 plan, on the CPU) and raises with ``pool="shared"``.
    """
    if plan_backend == "auto":
        if torch.device(device).type == "cuda" and pool != "shared":
            return "device"
        return "host"
    if plan_backend not in _PLAN_BACKENDS:
        raise ValueError(f"unknown plan backend {plan_backend!r}; pick from "
                         f"{_PLAN_BACKENDS + ('auto',)}")
    if plan_backend == "device" and pool == "shared":
        raise ValueError(
            "plan_backend='device' supports pool='dedicated' only (the "
            "chronological shared-pool replay is host code)")
    return plan_backend


def evaluate_grid(
    jobs: list[ChainJob],
    policies: Sequence[Policy],
    scenarios: SpotMarket | Sequence[SpotMarket],
    r_total: int = 0,
    *,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    early_start: bool = True,
    pool: str = "dedicated",
    availability: Callable | Sequence[Callable] | None = None,
    plan_backend: str = "auto",
    device="cuda",
) -> EngineResult:
    """Evaluate every job under every policy in every market scenario.

    Returns an ``EngineResult`` whose ``unit_cost[s]`` is the (J, P) TOLA
    cost matrix for scenario s. ``scenarios`` is one ``SpotMarket`` or a
    list of markets sharing a slot grid. ``pool`` selects the self-owned
    semantics: "dedicated" is the counterfactual evaluator (TOLA / Alg. 4
    scoring, optionally against a realized ``availability`` query — one
    callable, or a list of S per-scenario callables, in which case the
    self-owned stats gain a leading scenario axis), "shared" replays the
    chronological shared-pool allocation per policy. ``plan_backend``
    selects where the plan tensors are built (:func:`resolve_plan_backend`);
    ``timings["plan_device"]`` is the device plan build's seconds (0.0 for
    host plans).
    """
    dev = resolve_device(device)
    if not jobs:
        raise ValueError("need at least one job")
    policies = list(policies)
    if not policies:
        raise ValueError("need at least one policy")
    single = isinstance(scenarios, SpotMarket)
    batch = MarketListBatch([scenarios] if single else scenarios, dev)
    S = batch.n_scenarios
    gplan = build_grid_plan(
        jobs, policies, r_total, windows=windows, selfowned=selfowned,
        pool=pool, availability=availability,
        slots_per_unit=batch.slots_per_unit, n_scenarios=S,
        plan_backend=resolve_plan_backend(plan_backend, dev, pool),
        device=dev)
    J, P = gplan.n_jobs, gplan.n_policies

    t0 = time.perf_counter()
    for bid in gplan.bids:
        batch.stacked(bid)
    t1 = time.perf_counter()
    out = {k: np.zeros((S, J, P)) for k in OUT_KEYS}
    backend.run(gplan, batch, early_start, out)
    t2 = time.perf_counter()

    so_shape = (S, J, P) if gplan.per_scenario else (J, P)
    selfowned_work = np.zeros(so_shape)
    selfowned_reserved = np.zeros(so_shape)
    for g in gplan.groups:
        sw, sr = g.selfowned_work, g.selfowned_reserved
        if gplan.per_scenario and not g.per_scenario:
            sw, sr = np.broadcast_to(sw, (S, J)), np.broadcast_to(sr, (S, J))
        selfowned_work[..., g.policy_idx] = sw[..., None]
        selfowned_reserved[..., g.policy_idx] = sr[..., None]

    total = out["spot_cost"] + out["ondemand_cost"]
    unit = total / np.maximum(gplan.workload, 1e-12)[None, :, None]
    return EngineResult(
        unit_cost=unit, spot_cost=out["spot_cost"],
        ondemand_cost=out["ondemand_cost"], spot_work=out["spot_work"],
        ondemand_work=out["ondemand_work"], workload=gplan.workload.copy(),
        selfowned_work=selfowned_work, selfowned_reserved=selfowned_reserved,
        device=str(dev), single_market=single,
        timings={"plan": gplan.plan_seconds, "pool": gplan.pool_seconds,
                 "views": t1 - t0, "eval": t2 - t1,
                 # The device plan build alone: on the staged path the pool
                 # phase is mostly the host's availability queries.
                 "plan_device": gplan.plan_seconds if gplan.device else 0.0})
