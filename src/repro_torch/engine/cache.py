"""Cross-call reuse layer of the port's evaluation engine.

Users re-score the paper's parametric policy family over and over as the
market moves, so successive ``evaluate_grid`` calls share most of their
(Dealloc param, beta_0, bid) evaluation groups and their scenario views.
This module makes the repeated call the fast path:

* ``PLAN_CACHE`` — cross-call LRU of built ``EvalGroup`` records, keyed on
  the SAME dedup signature the plan layer uses within one grid (window
  key, rounded beta_0, ``round(bid, 12)``) plus the jobs fingerprint and
  the pool configuration; device plans add the normalized torch device,
  so a call never receives another device's tensors. ``plan.build_grid_plan``
  consults it per *group*: a second call with an overlapping grid builds
  only the new groups, and a fully-overlapping one builds nothing.
* ``VIEW_CACHE`` — cross-call LRU of stacked scenario views keyed on
  (spec, chunk range, device, host flag, ``round(bid, 12)``); the
  per-batch memo in ``scenarios.ScenarioBatch.stacked`` dies with the
  batch, this one survives across ``evaluate_grid`` / ``replay_stream``
  calls. Feedback-driven (adaptive) chunks and materialized market lists
  bypass it: their views have no key.
* ``evaluate_grid_delta`` — incremental evaluation: diff the new policy
  grid against the group signatures recorded on a previous
  ``EngineResult`` and re-score ONLY the new or changed groups, splicing
  the earlier cost columns for the rest. Every group is an independent
  evaluation cell, so the splice is bit for bit a full re-evaluation.

Cached groups and views are shared by every later hit: nothing that
consumes them (the backend, the kernel wrappers, TOLA) writes into them.

``REPRO_ENGINE_CACHE=0`` (the reference's switch, which this module
reads too) or ``configure(enabled=False)`` / ``disabled()`` turns the
cross-call caches off; cache-on and cache-off results are bit for bit the
same (tests/test_torch_cache.py).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import os

import numpy as np
import torch

from repro_torch.obs import METRICS, maybe_snapshot

__all__ = [
    "PLAN_CACHE", "VIEW_CACHE", "enabled", "configure", "disabled",
    "clear_caches", "plan_cache_events", "fingerprint_job_arrays",
    "jobs_fingerprint", "scenario_fingerprint", "device_key",
    "evaluate_grid_delta",
]

_CacheInfo = collections.namedtuple(
    "CacheInfo", ["hits", "misses", "maxsize", "currsize"])


class _LRU:
    """Bounded recency-ordered cache with hit, miss and eviction counts.

    ``cache_info()`` has the ``functools.lru_cache`` field layout, and
    ``evictions`` counts the entries pushed out by the bound (so
    ``obs.compiled.factory_caches`` reports it like the ``lru_cache``
    factories). When ``metric`` is set, evictions by ``put`` emit
    ``<metric>{event=evict}`` through ``obs.METRICS``.
    """

    def __init__(self, maxsize: int, metric: str | None = None):
        self.maxsize = int(maxsize)
        self.metric = metric
        self._data: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        try:
            value = self._data[key]
        except KeyError:
            self.misses += 1
            return default
        self._data.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key, value) -> None:
        if self.maxsize <= 0:
            return
        self._data[key] = value
        self._data.move_to_end(key)
        n = self._evict()
        if n and self.metric and METRICS.enabled:
            METRICS.counter(self.metric).inc(float(n), event="evict")

    def _evict(self) -> int:
        n = 0
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)
            n += 1
        self.evictions += n
        return n

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def cache_info(self) -> _CacheInfo:
        return _CacheInfo(self.hits, self.misses, self.maxsize,
                          len(self._data))

    def clear(self) -> None:
        """Drop entries AND counters: a cleared cache reports like a fresh
        one."""
        self._data.clear()
        self.hits = self.misses = self.evictions = 0

    def resize(self, maxsize: int) -> None:
        self.maxsize = int(maxsize)
        self._evict()


# An EvalGroup at Table 6's 10000 jobs holds a few MB of plan tensors
# (host float64 or device float32); 1024 entries cover many concurrent
# policy grids. Stacked views are (chunk, n_slots+1)-sized per bid; 128
# entries cover a serving loop replaying the same spec windows.
PLAN_CACHE = _LRU(1024, metric="engine.plan_cache")
VIEW_CACHE = _LRU(128, metric="engine.view_cache")

_ENABLED_OVERRIDE: bool | None = None


def enabled() -> bool:
    """Cross-call caching on? ``configure(enabled=...)`` wins over the
    ``REPRO_ENGINE_CACHE`` environment switch (``0`` disables)."""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    return os.environ.get("REPRO_ENGINE_CACHE", "1") != "0"


def configure(enabled: bool | None = None, plan_maxsize: int | None = None,
              view_maxsize: int | None = None) -> None:
    """Adjust the cross-call cache layer in-process.

    ``enabled=None`` leaves the current switch; a smaller maxsize evicts
    least-recent entries at once (counted as evictions).
    """
    global _ENABLED_OVERRIDE
    if enabled is not None:
        _ENABLED_OVERRIDE = bool(enabled)
    if plan_maxsize is not None:
        PLAN_CACHE.resize(plan_maxsize)
    if view_maxsize is not None:
        VIEW_CACHE.resize(view_maxsize)


@contextlib.contextmanager
def disabled():
    """Scoped cache-off (the on/off parity checks run their oracle leg
    under this)."""
    global _ENABLED_OVERRIDE
    prev = _ENABLED_OVERRIDE
    _ENABLED_OVERRIDE = False
    try:
        yield
    finally:
        _ENABLED_OVERRIDE = prev


def clear_caches() -> None:
    """Drop every cross-call entry (plan groups and scenario views)."""
    PLAN_CACHE.clear()
    VIEW_CACHE.clear()


def plan_cache_events(hits: int = 0, misses: int = 0) -> None:
    """Emit the plan cache's hit and miss counters (one labeled series;
    evictions are emitted by the cache itself)."""
    if not METRICS.enabled or not (hits or misses):
        return
    c = METRICS.counter("engine.plan_cache")
    if hits:
        c.inc(float(hits), event="hit")
    if misses:
        c.inc(float(misses), event="miss")


def device_key(device) -> str:
    """A torch device as a cache key: ``cuda`` and ``cuda:0`` are one key
    when card 0 is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


# --------------------------------------------------------------------------
# Fingerprints: the invalidation half of the cache key contract.
# --------------------------------------------------------------------------

def _hash_arrays(h, arrays) -> None:
    for f in dataclasses.fields(arrays):
        v = getattr(arrays, f.name)
        h.update(f.name.encode())
        if f.name == "jobs" and v is not None:
            # The source stream enters through its deadlines: a ChainJob's
            # other fields (arrival, each task's z and delta) are in the
            # arrays already, bit for bit (the reference hashes the list's
            # repr, 12 MB of text at 10000 jobs).
            v = np.array([j.deadline for j in v], np.float64)
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(repr(v).encode())


def fingerprint_job_arrays(arrays) -> str:
    """Content hash of a ``JobArrays`` batch — every field the plan layer
    reads, so any change to the job set invalidates its cache entries."""
    h = hashlib.sha1()
    _hash_arrays(h, arrays)
    return h.hexdigest()


def jobs_fingerprint(jobs) -> str:
    """Content hash of a job list (via its padded array form)."""
    from repro_torch.core.scheduler import job_arrays

    return fingerprint_job_arrays(job_arrays(jobs))


def scenario_fingerprint(scenarios):
    """Hashable identity of a scenario input, or None when it has none.

    A ``ScenarioSpec`` is its own fingerprint (a frozen dataclass: equal
    specs synthesize equal markets). Materialized markets hash their price
    paths and slot grid. Sources (a ``ScenarioStream``, adaptive or not)
    return None: their chunks may depend on feedback, so no cross-call
    identity exists and delta evaluation refuses them.
    """
    from repro_torch.core.market import SpotMarket
    from repro_torch.engine.scenarios import ScenarioSpec

    if isinstance(scenarios, ScenarioSpec):
        return scenarios
    if isinstance(scenarios, SpotMarket):
        scenarios = [scenarios]
    if isinstance(scenarios, (list, tuple)) and scenarios \
            and all(isinstance(m, SpotMarket) for m in scenarios):
        h = hashlib.sha1()
        for m in scenarios:
            h.update(np.ascontiguousarray(m.price, np.float64).tobytes())
            h.update(np.float64(m.slot).tobytes())
            h.update(np.int64(m.slots_per_unit).tobytes())
            h.update(np.float64(m.p_ondemand).tobytes())
        return h.hexdigest()
    return None


# --------------------------------------------------------------------------
# Incremental (delta) grid evaluation.
# --------------------------------------------------------------------------

def evaluate_grid_delta(prev, jobs, policies, scenarios, r_total: int = 0, *,
                        windows: str = "dealloc", selfowned: str = "prop12",
                        early_start: bool = True, pool: str = "dedicated",
                        device=None, plan_backend: str | None = None,
                        scenario_chunk: int | None = None,
                        overlap: bool | None = None, mesh=None):
    """Re-evaluate a policy grid incrementally against a previous result.

    Diffs the new grid's evaluation groups (the plan layer's
    (window key, beta_0, ``round(bid, 12)``) dedup signature) against the
    groups recorded on ``prev.delta_state``, re-scores ONLY the new or
    changed groups through :func:`repro_torch.engine.evaluate_grid`, and
    splices the unchanged cost columns straight out of ``prev``'s arrays.
    Each group is an independent evaluation cell, so the result is bit for
    bit a full re-evaluation on the same device and plan backend.

    ``prev`` must come from a ``reduce="stack"`` ``evaluate_grid`` call
    over the SAME jobs, scenarios and pool configuration (checked against
    the fingerprints on ``prev.delta_state``; a mismatch raises naming the
    offending input). ``device`` and ``plan_backend`` default to
    ``prev``'s. ``mesh`` shards the re-scoring pass (see
    ``evaluate_grid``; the splice from ``prev`` is host work on every
    rank). The number of re-scored groups is returned in
    ``timings["delta_groups_rescored"]``.
    """
    from repro_torch.engine.api import evaluate_grid
    from repro_torch.engine.plan import _grid_structure
    from repro_torch.engine.result import EngineResult

    st = getattr(prev, "delta_state", None)
    if st is None:
        raise ValueError(
            "prev carries no delta_state: delta evaluation needs a "
            "reduce='stack' evaluate_grid result over a fingerprintable "
            "scenario input (ScenarioSpec or materialized markets) with "
            "availability=None")
    cfg = st["config"]
    mismatches = [
        f"{name}: prev {cfg[name]!r} vs call {got!r}"
        for name, got in (("r_total", float(r_total)), ("windows", windows),
                          ("selfowned", selfowned), ("pool", pool),
                          ("early_start", bool(early_start)))
        if cfg[name] != got]
    if mismatches:
        raise ValueError(
            "delta evaluation config differs from prev's; re-scoring only "
            "changed groups would be wrong for: " + "; ".join(mismatches))
    if jobs_fingerprint(jobs) != st["jobs_fp"]:
        raise ValueError(
            "jobs changed since prev was computed (fingerprint mismatch); "
            "every group depends on the job set — run a full evaluate_grid")
    sfp = scenario_fingerprint(scenarios)
    if sfp is None or sfp != st["scenario_fp"]:
        raise ValueError(
            "scenarios changed since prev was computed (or are not "
            "fingerprintable); every group depends on the market "
            "realizations — run a full evaluate_grid")
    device = cfg["device"] if device is None else device
    plan_backend = cfg["plan_backend"] if plan_backend is None else \
        plan_backend

    policies = list(policies)
    s = _grid_structure(policies, r_total, windows)
    n_groups = len(s.g_bid)
    rep = st["group_rep"]
    changed = [gi for gi in range(n_groups) if s.g_key[gi] not in rep]

    S = prev.n_scenarios_total
    P = len(policies)
    keys = ("spot_cost", "ondemand_cost", "spot_work", "ondemand_work")
    # Each new column's source column in prev: one gather per array (a
    # per-group scatter along the policy axis costs seconds at Table 6's
    # (16, 10000, 175)). Changed groups' columns are overwritten below.
    src = np.zeros(P, np.intp)
    for gi in range(n_groups):
        if s.g_key[gi] in rep:
            src[s.g_pols[gi]] = rep[s.g_key[gi]]
    out = {k: np.take(getattr(prev, k), src, axis=2) for k in keys}
    so_work = np.take(prev.selfowned_work, src, axis=1)
    so_res = np.take(prev.selfowned_reserved, src, axis=1)

    timings = {"delta_groups_rescored": len(changed),
               "delta_groups_total": n_groups, "plan": 0.0, "pool": 0.0,
               "synth": 0.0, "views": 0.0, "eval": 0.0, "plan_cached": 0}
    if changed:
        # One representative policy per changed group: the group tensors
        # depend on the policy only through its dedup signature, so the
        # representative's columns are every member's columns.
        rep_pols = [policies[s.g_pols[gi][0]] for gi in changed]
        inner = evaluate_grid(
            jobs, rep_pols, scenarios, r_total, windows=windows,
            selfowned=selfowned, early_start=early_start, pool=pool,
            plan_backend=plan_backend, scenario_chunk=scenario_chunk,
            reduce="stack", overlap=overlap, device=device, mesh=mesh)
        cols = [p for gi in changed for p in s.g_pols[gi]]
        reps = [i for i, gi in enumerate(changed) for _ in s.g_pols[gi]]
        for k in keys:
            out[k][:, :, cols] = getattr(inner, k)[:, :, reps]
        so_work[:, cols] = inner.selfowned_work[:, reps]
        so_res[:, cols] = inner.selfowned_reserved[:, reps]
        device = inner.device
        for k in ("plan", "pool", "synth", "views", "eval", "plan_cached"):
            timings[k] = inner.timings[k]
    if METRICS.enabled:
        METRICS.counter("engine.delta_groups_rescored").inc(
            float(len(changed)))

    workload = prev.workload.copy()
    total = out["spot_cost"] + out["ondemand_cost"]
    unit = total / np.maximum(workload, 1e-12)[None, :, None]
    return EngineResult(
        unit_cost=unit,
        spot_cost=out["spot_cost"],
        ondemand_cost=out["ondemand_cost"],
        spot_work=out["spot_work"],
        ondemand_work=out["ondemand_work"],
        workload=workload,
        selfowned_work=so_work,
        selfowned_reserved=so_res,
        device=str(device),
        single_market=prev.single_market,
        n_scenarios_total=S,
        timings=timings,
        obs=maybe_snapshot(),
        delta_state={
            "jobs_fp": st["jobs_fp"],
            "scenario_fp": st["scenario_fp"],
            "n_scenarios": S,
            "config": dict(cfg, device=str(device),
                           plan_backend=plan_backend),
            "group_rep": {s.g_key[gi]: int(s.g_pols[gi][0])
                          for gi in range(n_groups)},
        },
    )
