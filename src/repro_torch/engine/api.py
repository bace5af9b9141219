"""``evaluate_grid`` — the single entry point of the port's evaluation engine.

Scores every job under every policy in every market scenario: the plan
layer (``plan.py``) dedups the grid into evaluation groups and builds their
plan tensors (on the card in float32 by default, see
``resolve_plan_backend``; on the host in float64 otherwise), the per-bid
market views go to the device as float32, and the cost kernels
(``backend.py``) fill the (S, J, P) result tensors. Runs on the card by
default; ``device="cpu"`` runs the kernels' plain PyTorch versions.

The SCENARIO axis is a chunked stream (``scenarios.py``): ``scenarios``
may be a materialized market (list) or a declarative ``ScenarioSpec`` /
``ScenarioStream``, and ``scenario_chunk=K`` evaluates K scenarios per pass
against ONE grid plan, a spec's chunks synthesized on the device.
``evaluate_grid_chunks`` yields the same stream one chunk at a time (the
online-learning replay folds it without the full (S, J, P) tensor, and the
adaptive adversary's feedback happens between chunks).

``mesh=`` shards the scenario axis (and the group axis of a 2-D mesh)
over the ranks of a ``torch.distributed`` process group (``mesh.py``,
DESIGN.md §9); every rank returns the full result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.market import SpotMarket
from repro_torch.core.scheduler import Policy
from repro_torch.core.types import ChainJob
from repro_torch.device import resolve_device
from repro_torch.engine import backend
from repro_torch.engine.cache import scenario_fingerprint
from repro_torch.engine.mesh import as_scenario_mesh
from repro_torch.engine.plan import _PLAN_BACKENDS, build_grid_plan
from repro_torch.engine.result import EngineResult
from repro_torch.engine.scenarios import as_source
from repro_torch.kernels.policy_cost import OUT_KEYS
from repro_torch.obs import METRICS, maybe_snapshot, span

__all__ = ["evaluate_grid", "evaluate_grid_chunks", "GridChunk",
           "resolve_plan_backend"]

_REDUCES = ("stack", "mean")


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


def _check_scenario_chunk(scenario_chunk) -> None:
    """API-boundary validation of ``scenario_chunk``: fail here, naming the
    argument, not deep in the backend with a shape error."""
    if scenario_chunk is None:
        return
    if isinstance(scenario_chunk, bool) \
            or not isinstance(scenario_chunk, (int, np.integer)):
        raise ValueError(
            f"scenario_chunk must be an int >= 1 or None "
            f"(got {scenario_chunk!r})")
    if scenario_chunk < 1:
        raise ValueError(
            f"scenario_chunk must be >= 1 (got {scenario_chunk}); pass "
            f"None to evaluate all scenarios in one pass")


def _prepare_stream(jobs, policies, scenarios, r_total, windows, selfowned,
                    pool, availability, plan_backend, scenario_chunk,
                    overlap, dev, mesh=None):
    """Shared validation + plan build of the chunked evaluation paths.

    Returns ``(source, gplan, chunk, single, overlap, mesh)`` — the grid
    plan is built ONCE and reused across every scenario chunk (it is
    scenario-independent apart from the per-scenario availability case,
    which requires a single full-batch chunk)."""
    if not jobs:
        raise ValueError("need at least one job")
    policies = list(policies)
    if not policies:
        raise ValueError("need at least one policy")
    single = isinstance(scenarios, SpotMarket)
    source = as_source(scenarios)
    S = source.n_scenarios
    _check_scenario_chunk(scenario_chunk)
    chunk = S if scenario_chunk is None else min(int(scenario_chunk), S)
    if chunk < S and isinstance(availability, (list, tuple)):
        raise ValueError(
            "scenario_chunk cannot split a batch with per-scenario "
            "availability queries (the plan's self-owned tensors are "
            "indexed by the full scenario axis); evaluate in one chunk")
    # Per-scenario availability (refined plans) is shardable: the (S, R, L)
    # self-owned stacks are sliced on both axes with the views.
    mesh = as_scenario_mesh(mesh)
    if mesh is not None:
        mesh.check_device(dev)
    if overlap is None:
        overlap = dev.type == "cuda" and not source.reactive
    elif overlap and source.reactive:
        raise ValueError(
            "overlap=True cannot double-buffer a reactive (adaptive) "
            "scenario stream: chunk k+1's spikes are planned from feedback "
            "about chunk k, so its synthesis cannot be dispatched early")
    gplan = build_grid_plan(
        jobs, policies, r_total, windows=windows, selfowned=selfowned,
        pool=pool, availability=availability,
        slots_per_unit=source.slots_per_unit, n_scenarios=S,
        plan_backend=resolve_plan_backend(plan_backend, dev, pool),
        device=dev)
    return source, gplan, chunk, single, bool(overlap), mesh


def _prefetched(stream):
    """Double-buffer a chunk stream: DISPATCH chunk k+1's synthesis (on the
    card's side stream) before yielding chunk k, so it runs while the
    consumer evaluates k. Lookahead depth 1 — at most two chunks of
    synthesis output are live at once."""
    prev = None
    for item in stream:
        item[2].dispatch()
        if prev is not None:
            yield prev
        prev = item
    if prev is not None:
        yield prev


def _run_chunk(ci, s0, s1, gplan, batch, early_start, out, overlap, dev,
               mesh=None):
    """Prepare a chunk, build its views and fill ``out`` under the span
    tree chunk -> {synth, views x bids, eval [-> splice under a mesh]};
    returns the synth seconds, the views spans' seconds (bid order), the
    eval seconds and the splice seconds (part of eval; 0.0 unsharded)."""
    with span("chunk", index=ci, s0=s0, s1=s1, backend=dev):
        with span("synth", s0=s0, s1=s1, overlap=overlap) as sp_s:
            batch.prepare()
        views = batch.build_views(gplan.bids)
        with span("eval", s0=s0, s1=s1, backend=dev) as sp_e:
            splice_t = backend.run(gplan, batch, early_start, out,
                                   mesh=mesh)
    return sp_s.seconds, views, sp_e.seconds, splice_t


def _fold(seconds) -> float:
    """Left-to-right float sum in completion order: the order the tracer's
    totals fold the same spans in (``sum()`` of floats is compensated on
    Python 3.12 and would leave them)."""
    total = 0.0
    for t in seconds:
        total += t
    return total


def _chunk_metrics(dev, synth_t, views_t, eval_t) -> None:
    if METRICS.enabled:
        h = METRICS.histogram("engine.chunk_seconds")
        h.observe(synth_t, phase="synth", backend=dev)
        h.observe(views_t, phase="views", backend=dev)
        h.observe(eval_t, phase="eval", backend=dev)


@dataclasses.dataclass
class GridChunk:
    """One scenario chunk of a streamed grid evaluation.

    ``unit_cost[k]`` is the (J, P) cost matrix of GLOBAL scenario
    ``s0 + k``; ``out`` carries the per-cell cost decomposition of the
    chunk. The arrays are chunk-sized — a consumer that only folds them
    (regret accumulation, scenario-mean reduction) never holds the full
    (S, J, P) tensor.
    """

    s0: int
    s1: int
    unit_cost: np.ndarray          # (s1 - s0, J, P)
    out: dict                      # per-cell cost decomposition, chunk-sized
    workload: np.ndarray           # (J,)
    timings: dict                  # {"synth", "views", "eval": s, "overlap"}


def evaluate_grid_chunks(
    jobs: list[ChainJob],
    policies: Sequence[Policy],
    scenarios,
    r_total: int = 0,
    *,
    scenario_chunk: int | None = None,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    early_start: bool = True,
    pool: str = "dedicated",
    availability: Callable | Sequence[Callable] | None = None,
    plan_backend: str = "auto",
    overlap: bool | None = None,
    device="cuda",
    mesh=None,
) -> Iterator[GridChunk]:
    """Stream the grid evaluation one scenario chunk at a time.

    Same contract as :func:`evaluate_grid` (one grid plan, the same
    per-scenario results), but yields ``GridChunk`` objects instead of
    assembling the (S, J, P) tensor — peak memory is chunk-sized. Between
    ``next()`` calls the caller may invoke ``source.observe(...)`` on an
    adaptive ``ScenarioStream``: the generator builds each chunk lazily
    AFTER the previous one was consumed, which is exactly the chunk
    boundary the adaptive adversary's feedback round-trip is defined at.
    ``overlap`` double-buffers chunk synthesis (default: on a CUDA card,
    except for reactive adaptive streams, whose chunks cannot be
    prefetched). ``mesh`` shards each chunk over a mesh of ranks (see
    :func:`evaluate_grid`).

    Validation (and the plan build) runs at the call, not at the first
    ``next()`` — a bad ``scenario_chunk`` fails here, at the call site.
    """
    dev = resolve_device(device)
    with span("prepare_stream"):
        source, gplan, chunk, _, overlap, mesh = _prepare_stream(
            jobs, policies, scenarios, r_total, windows, selfowned, pool,
            availability, plan_backend, scenario_chunk, overlap, dev, mesh)

    def _iter():
        J, P = gplan.n_jobs, gplan.n_policies
        wl = np.maximum(gplan.workload, 1e-12)
        stream = source.chunks(chunk, dev, mesh)
        if overlap:
            stream = _prefetched(stream)
        for ci, (s0, s1, batch) in enumerate(stream):
            out = {k: np.zeros((s1 - s0, J, P)) for k in OUT_KEYS}
            synth_t, views, eval_t, splice_t = _run_chunk(
                ci, s0, s1, gplan, batch, early_start, out, overlap, str(dev),
                mesh)
            views_t = _fold(views)
            _chunk_metrics(str(dev), synth_t, views_t, eval_t)
            unit = (out["spot_cost"] + out["ondemand_cost"]) \
                / wl[None, :, None]
            timings = {"synth": synth_t, "views": views_t, "eval": eval_t,
                       "overlap": overlap}
            if mesh is not None:
                timings["splice"] = splice_t
            yield GridChunk(s0=s0, s1=s1, unit_cost=unit, out=out,
                            workload=gplan.workload.copy(), timings=timings)

    return _iter()


def evaluate_grid(
    jobs: list[ChainJob],
    policies: Sequence[Policy],
    scenarios,
    r_total: int = 0,
    *,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    early_start: bool = True,
    pool: str = "dedicated",
    availability: Callable | Sequence[Callable] | None = None,
    plan_backend: str = "auto",
    scenario_chunk: int | None = None,
    reduce: str = "stack",
    overlap: bool | None = None,
    device="cuda",
    mesh=None,
) -> EngineResult:
    """Evaluate every job under every policy in every market scenario.

    Returns an ``EngineResult`` whose ``unit_cost[s]`` is the (J, P) TOLA
    cost matrix for scenario s. ``scenarios`` is one ``SpotMarket``, a list
    of markets sharing a slot grid, or a ``ScenarioSpec`` /
    ``ScenarioSource`` whose price paths are synthesized on the device.
    ``pool`` selects the self-owned semantics: "dedicated" is the
    counterfactual evaluator (TOLA / Alg. 4 scoring, optionally against a
    realized ``availability`` query — one callable, or a list of S
    per-scenario callables, in which case the self-owned stats gain a
    leading scenario axis and the batch cannot be chunked), "shared"
    replays the chronological shared-pool allocation per policy.
    ``plan_backend`` selects where the plan tensors are built
    (:func:`resolve_plan_backend`); ``timings["plan_device"]`` is the device
    plan build's seconds (0.0 for host plans).

    ``scenario_chunk=K`` evaluates the scenario axis K scenarios per pass
    against one grid plan (chunk results are bit for bit the monolithic
    pass's: chunking changes memory, not arithmetic); ``reduce="mean"``
    folds the chunks into the scenario-mean tensors (shape (1, J, P),
    ``n_scenarios_total`` keeps S). ``overlap`` double-buffers chunk
    synthesis on the card (see :func:`evaluate_grid_chunks`);
    ``timings["overlap"]`` records the resolved flag, ``timings["synth"]``
    the synthesis seconds (under overlap the RESIDUAL wait) and
    ``timings["chunks"]`` the per-chunk split.

    ``mesh`` shards the SCENARIO axis, and on a 2-D mesh the group axis,
    over the ranks of a ``torch.distributed`` process group (DESIGN.md §9):
    a ``GridMesh``, an int shard count (clamped to the process group's
    ranks with a warning; 1 without a process group) or a ``DeviceMesh``
    with a ``"data"`` dim. Each rank synthesizes and scores only its
    scenario slab x group block, with no collective in the cost launches;
    a chunk whose scenario or group count does not divide is padded (the
    last one repeated) and the padding dropped at the splice, so every
    rank returns the full result, bit for bit the unsharded one.

    Plan groups and spec views are kept across calls (``engine/cache.py``;
    ``timings["plan_cached"]`` counts the groups served from the cache),
    and a ``reduce="stack"`` result over a fingerprintable scenario input
    without availability queries carries the ``delta_state`` that
    ``evaluate_grid_delta`` re-scores a changed grid against.
    """
    if reduce not in _REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}; pick from {_REDUCES}")
    if reduce == "mean" and isinstance(availability, (list, tuple)):
        raise ValueError("reduce='mean' cannot fold per-scenario "
                         "availability results; use reduce='stack'")
    dev = resolve_device(device)
    with span("evaluate_grid", reduce=reduce) as root:
        with span("prepare_stream"):
            source, gplan, chunk, single, overlap, mesh = _prepare_stream(
                jobs, policies, scenarios, r_total, windows, selfowned, pool,
                availability, plan_backend, scenario_chunk, overlap, dev,
                mesh)
        S, J, P = source.n_scenarios, gplan.n_jobs, gplan.n_policies
        root.set(backend=str(dev), scenarios=S, overlap=overlap)

        if reduce == "stack":
            out = {k: np.zeros((S, J, P)) for k in OUT_KEYS}
        else:
            acc = {k: np.zeros((J, P)) for k in OUT_KEYS}
            buf = {k: np.zeros((chunk, J, P)) for k in OUT_KEYS}
        chunk_timings: list[dict] = []
        synth_total = views_total = eval_total = splice_total = 0.0
        # The stack path writes the backend's output straight into the
        # (S, J, P) slices, so it does not go through GridChunk.
        stream = source.chunks(chunk, dev, mesh)
        if overlap:
            stream = _prefetched(stream)
        for ci, (s0, s1, batch) in enumerate(stream):
            if reduce == "stack":
                out_chunk = {k: v[s0:s1] for k, v in out.items()}
            else:
                out_chunk = {k: v[:s1 - s0] for k, v in buf.items()}
            synth_t, views, eval_t, splice_t = _run_chunk(
                ci, s0, s1, gplan, batch, early_start, out_chunk, overlap,
                str(dev), mesh)
            if reduce == "mean":
                for k in OUT_KEYS:
                    acc[k] += out_chunk[k].sum(axis=0)
            # Totals fold every span in completion order, as the tracer
            # does: the views total over each bid's span, not the chunks'.
            synth_total += synth_t
            for t in views:
                views_total += t
            eval_total += eval_t
            splice_total += splice_t
            views_t = _fold(views)
            _chunk_metrics(str(dev), synth_t, views_t, eval_t)
            chunk_timings.append({"scenarios": [s0, s1], "synth": synth_t,
                                  "views": views_t, "eval": eval_t})
            if mesh is not None:
                chunk_timings[-1]["splice"] = splice_t
        if reduce == "mean":
            out = {k: v[None] / S for k, v in acc.items()}
    if METRICS.enabled:
        METRICS.gauge("engine.scenarios_per_sec").set(
            S / max(root.seconds, 1e-12), backend=str(dev))

    so_shape = (S, J, P) if gplan.per_scenario else (J, P)
    selfowned_work = np.zeros(so_shape)
    selfowned_reserved = np.zeros(so_shape)
    for g in gplan.groups:
        sw, sr = g.selfowned_work, g.selfowned_reserved
        if gplan.per_scenario and not g.per_scenario:
            sw, sr = np.broadcast_to(sw, (S, J)), np.broadcast_to(sr, (S, J))
        selfowned_work[..., g.policy_idx] = sw[..., None]
        selfowned_reserved[..., g.policy_idx] = sr[..., None]

    # Delta-evaluation handle: recorded whenever the inputs have a
    # cross-call identity (fingerprintable scenarios, no availability
    # queries) and the full (S, J, P) stack is there to splice from.
    delta_state = None
    if reduce == "stack" and availability is None:
        sfp = scenario_fingerprint(scenarios)
        if sfp is not None:
            delta_state = {
                "jobs_fp": gplan.jobs_fp,
                "scenario_fp": sfp,
                "n_scenarios": S,
                "config": {"r_total": float(r_total), "windows": windows,
                           "selfowned": selfowned, "pool": pool,
                           "early_start": bool(early_start),
                           "device": str(dev),
                           "plan_backend": gplan.plan_backend},
                "group_rep": {key: int(g.policy_idx[0])
                              for key, g in zip(gplan.group_keys,
                                                gplan.groups)},
            }

    total = out["spot_cost"] + out["ondemand_cost"]
    unit = total / np.maximum(gplan.workload, 1e-12)[None, :, None]
    return EngineResult(
        unit_cost=unit, spot_cost=out["spot_cost"],
        ondemand_cost=out["ondemand_cost"], spot_work=out["spot_work"],
        ondemand_work=out["ondemand_work"], workload=gplan.workload.copy(),
        selfowned_work=selfowned_work, selfowned_reserved=selfowned_reserved,
        device=str(dev), single_market=single and reduce == "stack",
        n_scenarios_total=S,
        timings={"plan": gplan.plan_seconds, "pool": gplan.pool_seconds,
                 "synth": synth_total, "views": views_total,
                 "eval": eval_total,
                 "chunks": chunk_timings, "overlap": overlap,
                 "plan_cached": gplan.plan_cached,
                 # The device plan build alone: on the staged path the pool
                 # phase is mostly the host's availability queries.
                 "plan_device": gplan.plan_seconds if gplan.device else 0.0,
                 # Under a mesh: the gathers and splices, part of eval.
                 **({"splice": splice_total} if mesh is not None else {})},
        obs=maybe_snapshot(),
        delta_state=delta_state)
