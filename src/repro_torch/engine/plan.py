"""Plan layer of the port's evaluation engine.

Turns (jobs x policies) into a deduplicated batch of *evaluation groups*.
The padded ``PlanBatch`` depends on a policy only through its Dealloc
parameter, the self-owned allocation only through (plan, beta_0), and the
market realization additionally through the bid. Policies sharing the
triple (window key, beta_0, bid) are exact duplicates and collapse into one
group.

The plan layer has two backends (``plan_backend``):

* ``"host"`` — float64 numpy: window plans for all distinct Dealloc
  parameters come out of one vectorized ``build_plans_batch`` pass, and the
  market-independent arithmetic (policy-(12) counts, cloud residuals, pins)
  follows in float64 — the same numbers as the reference's host plan, which
  the backend uploads to the cost kernels as float32.
* ``"device"`` — the same pipeline in float32 torch ops on the evaluation
  device (the reference's fused jit program, ``_build_grid_plan_device``):
  the Alg.-1 waterfill (``core.dealloc.window_sizes_batch_device``), the
  policy-(12) counts (``core.scheduler._selfowned_counts_device``), the
  cloud residuals and the group gather. The plan tensors stay on the
  device, where the cost kernels read them. Every operation is one IEEE
  float32 operation in a fixed order (running sums, no reductions), so the
  plan is the same bits on the card and on the CPU. Parity with the host
  path is float-level, and integral-count ceils use a widened epsilon
  (``scheduler._DEVICE_CEIL_EPS``).

When ``availability`` is a *list* of per-scenario queries (TOLA's batched
pool refinement), the self-owned arrays gain a leading scenario axis:
groups carry (S, J, L) tensors and backends pair scenario s with slice s.
Availability queries are host callables, so the device path stages the
planned windows to the host once to evaluate them; without queries it
never leaves the device.

Without queries, both paths consult the cross-call group cache
(``engine/cache.py``) and build only the groups it misses: the window
plans, allocations and cells of a subset are the same bits as those of
the whole grid, since every one of them is computed per Dealloc parameter
and per (window plan, beta_0) cell.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dealloc import window_sizes_batch_device
from repro_torch.core.scheduler import (
    PlanBatch,
    Policy,
    _allocate_pool,
    _selfowned_counts_device,
    _selfowned_counts_vec,
    build_plans_batch,
    job_arrays,
)
from repro_torch.core.types import ChainJob
from repro_torch.engine import cache as _cache
from repro_torch.obs import span

__all__ = ["EvalGroup", "GridPlan", "build_grid_plan", "scenario_cat",
           "concat_rows", "distinct_window_params"]

_PLAN_BACKENDS = ("host", "device")

# Dust threshold of the DEVICE residual-workload kill. The host oracle
# zeroes residuals below 1e-9 * (z + 1) — the f64 cancellation floor of
# z - r * sizes. Device arithmetic is f32 whose cancellation noise is
# ~1e-7 relative, so the same subtraction leaves phantom residuals the
# 1e-9 threshold would keep alive; 1e-6 kills them. Genuine residuals are
# either 0 or substantial, so the widened window changes nothing real.
_DEVICE_DUST = 1e-6


def concat_rows(arrays):
    """Concatenate group row batches along axis 0: numpy arrays on the
    host, tensors on their device."""
    if isinstance(arrays[0], torch.Tensor):
        return torch.cat(arrays)
    return np.concatenate(arrays)


def scenario_cat(groups, attr: str, S: int):
    """Concatenate a group attribute into an (S, R, L) scenario-major stack,
    broadcasting groups whose arrays are scenario-independent. Device
    tensors stay on their device."""
    shape = lambda g: (S,) + tuple(g.plan.ends.shape)  # noqa: E731
    if isinstance(getattr(groups[0], attr), torch.Tensor):
        return torch.cat([getattr(g, attr).expand(shape(g)) for g in groups],
                         dim=1)
    return np.concatenate(
        [np.broadcast_to(getattr(g, attr), shape(g)) for g in groups], axis=1)


def _bid_key(bid: float) -> float:
    """The one bid-comparison rule of the plan layer: groups are deduped,
    listed and looked up on the same rounded value."""
    return round(bid, 12)


@dataclasses.dataclass
class EvalGroup:
    """One distinct (window plan, beta_0, bid) evaluation cell.

    ``policy_idx`` lists every policy of the original grid that this group
    realizes. The self-owned arrays are (J, L) when market-independent and
    (S, J, L) when the caller supplied per-scenario availability queries.
    On the device plan path they are float32 tensors on the evaluation
    device (views of one stack per (window plan, beta_0) cell), and the
    plan's ``starts``/``ends`` are too; the self-owned stats stay host
    numpy.
    """

    plan: PlanBatch
    policy_idx: np.ndarray   # (k,) columns of the cost matrix this fills
    bid: float
    r_alloc: np.ndarray      # (J, L) | (S, J, L) self-owned instances
    z_t: np.ndarray          # (J, L) | (S, J, L) cloud workload after s-o
    d_eff: np.ndarray        # (J, L) | (S, J, L) cloud parallelism after s-o
    pins: np.ndarray         # bool — tasks holding reservations
    selfowned_work: np.ndarray      # (J,) | (S, J)
    selfowned_reserved: np.ndarray  # (J,) | (S, J)

    @property
    def per_scenario(self) -> bool:
        return self.z_t.ndim == 3


@dataclasses.dataclass
class GridPlan:
    """The full batched evaluation plan for (jobs x policies)."""

    jobs: list[ChainJob]
    policies: list[Policy]
    groups: list[EvalGroup]
    workload: np.ndarray     # (J,) Z_j
    arrival: np.ndarray      # (J,)
    n_jobs: int
    n_policies: int
    L: int
    plan_seconds: float = 0.0   # window-plan tensor construction
    pool_seconds: float = 0.0   # self-owned allocation + residuals
    plan_backend: str = "host"  # "host" (numpy f64) | "device" (torch f32)
    plan_cached: int = 0        # groups served from the cross-call cache
    jobs_fp: str = ""           # content fingerprint of the job batch
    group_keys: list | None = None  # per-group dedup signatures (cache keys)

    @property
    def device(self) -> bool:
        return self.plan_backend == "device"

    @property
    def bids(self) -> list[float]:
        seen: dict[float, float] = {}
        for g in self.groups:
            seen.setdefault(_bid_key(g.bid), g.bid)
        return sorted(seen.values())

    @property
    def per_scenario(self) -> bool:
        return any(g.per_scenario for g in self.groups)

    def groups_for_bid(self, bid: float) -> list[EvalGroup]:
        key = _bid_key(bid)
        return [g for g in self.groups if _bid_key(g.bid) == key]


def _window_key(policy: Policy, r_total: int, windows: str):
    if windows == "even":
        return ("even",)
    return ("dealloc", round(policy.dealloc_param(r_total), 12))


def distinct_window_params(policies, r_total: int,
                           windows: str = "dealloc") -> dict[tuple, float]:
    """Window-key dedup of a policy grid: {window key -> exact Dealloc param
    of the FIRST policy carrying it} in first-appearance order."""
    key_param: dict[tuple, float] = {}
    for pol in policies:
        wkey = _window_key(pol, r_total, windows)
        if wkey not in key_param:
            key_param[wkey] = (pol.dealloc_param(r_total)
                               if windows != "even" else 0.0)
    return key_param


@dataclasses.dataclass
class _GridStructure:
    """First-appearance-ordered dedup of the (window, beta_0, bid) grid."""

    key_param: dict[tuple, float]   # window key -> exact Dealloc param
    a_plan: list[int]               # akey -> window-plan index
    a_beta0: list[float | None]     # akey -> beta_0 of its first policy
    g_akey: list[int]               # group -> akey index
    g_bid: list[float]              # group -> exact bid of its first policy
    g_pols: list[list[int]]         # group -> policy columns it fills
    g_key: list[tuple]              # group -> full (window, b0, bid) key


def _grid_structure(policies, r_total: int, windows: str) -> _GridStructure:
    key_param = distinct_window_params(policies, r_total, windows)
    w_index = {k: i for i, k in enumerate(key_param)}
    akey_index: dict[tuple, int] = {}
    g_index: dict[tuple, int] = {}
    s = _GridStructure(key_param, [], [], [], [], [], [])
    for pi, pol in enumerate(policies):
        wkey = _window_key(pol, r_total, windows)
        b0 = None if pol.beta0 is None else round(pol.beta0, 12)
        akey = wkey + (b0,)
        ai = akey_index.get(akey)
        if ai is None:
            ai = akey_index[akey] = len(s.a_plan)
            s.a_plan.append(w_index[wkey])
            s.a_beta0.append(pol.beta0)
        gkey = akey + (_bid_key(pol.bid),)
        gi = g_index.get(gkey)
        if gi is None:
            gi = g_index[gkey] = len(s.g_bid)
            s.g_akey.append(ai)
            s.g_bid.append(pol.bid)
            s.g_pols.append([pi])
            s.g_key.append(gkey)
        else:
            s.g_pols[gi].append(pi)
    return s


def _cloud_residuals(plan: PlanBatch, r_alloc: np.ndarray):
    """Residual cloud workload (dust-killed), effective parallelism, pins,
    self-owned stats. ``r_alloc`` may carry a leading scenario axis."""
    sizes = plan.sizes
    z_t = np.maximum(plan.z - r_alloc * sizes, 0.0)
    z_t[z_t <= 1e-9 * (plan.z + 1.0)] = 0.0
    d_eff = np.maximum(plan.delta - r_alloc, 0.0)
    selfowned = np.minimum(r_alloc * sizes, plan.z)
    return z_t, d_eff, r_alloc > 0, selfowned.sum(axis=-1), \
        (r_alloc * sizes).sum(axis=-1)


def _group_alloc(plan: PlanBatch, pol_beta0: float | None, r_total: int,
                 selfowned: str, pool: str, availability,
                 slots_per_unit: int) -> np.ndarray:
    if r_total <= 0:
        return np.zeros_like(plan.z)
    beta0 = np.full(plan.z.shape[0],
                    np.nan if pol_beta0 is None else pol_beta0)
    if pool == "shared":
        # Chronological shared-pool replay on the planned windows; each
        # policy of a sweep owns a fresh pool. The allocation is
        # bid-independent, so bid is NaN.
        pplan = dataclasses.replace(plan, beta0=beta0,
                                    bid=np.full(plan.z.shape[0], np.nan))
        r_alloc, _ = _allocate_pool(pplan, r_total, selfowned, slots_per_unit)
        return r_alloc
    if availability is None:
        avail = float(r_total)
    elif isinstance(availability, (list, tuple)):
        # Per-scenario residual-occupancy queries -> (S, J, L) availability.
        avail = np.stack([q(plan.starts, plan.ends) for q in availability])
    else:
        avail = availability(plan.starts, plan.ends)
    r_alloc = _selfowned_counts_vec(
        plan.z, plan.delta, plan.sizes, beta0[:, None], avail, selfowned)
    return np.where(plan.mask, r_alloc, 0.0)


def build_grid_plan(
    jobs: list[ChainJob],
    policies: list[Policy],
    r_total: int = 0,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    pool: str = "dedicated",
    availability=None,
    slots_per_unit: int = 12,
    n_scenarios: int | None = None,
    plan_backend: str = "host",
    device="cuda",
) -> GridPlan:
    """Deduplicate (jobs x policies) into evaluation groups.

    ``pool="dedicated"`` scores each policy against an uncontended pool (the
    counterfactual evaluator TOLA uses; ``availability`` optionally replaces
    the constant ``r_total`` with a realized residual-occupancy query, or a
    LIST of per-scenario queries for scenario-batched pool refinement —
    pass ``n_scenarios`` so the list length is validated here).
    ``pool="shared"`` replays the chronological shared-pool allocation per
    policy.
    ``plan_backend="device"`` builds the plan tensors in float32 on
    ``device`` (see the module docstring; ``pool="dedicated"`` only).
    Without ``availability``, groups found in the cross-call plan cache
    are reused and only the missing ones are built. A mesh plays no part
    here: every rank builds the full, unsharded group tensors and slices
    its block at launch, so meshed and unmeshed calls share the cache.
    """
    if pool not in ("dedicated", "shared"):
        raise ValueError(f"unknown pool mode {pool!r}")
    if plan_backend not in _PLAN_BACKENDS:
        raise ValueError(f"unknown plan backend {plan_backend!r}; pick from "
                         f"{_PLAN_BACKENDS}")
    if isinstance(availability, (list, tuple)) and n_scenarios is not None \
            and len(availability) != n_scenarios:
        raise ValueError(
            f"per-scenario availability needs one query per scenario "
            f"({len(availability)} queries, {n_scenarios} scenarios)")
    if plan_backend == "device" and pool == "shared":
        raise ValueError(
            "plan_backend='device' supports pool='dedicated' only (the "
            "chronological shared-pool replay is host code)")

    s = _grid_structure(policies, r_total, windows)
    arrays = job_arrays(jobs)
    # Availability queries are opaque host callables: their results have no
    # fingerprint, so refined plans never enter the cross-call cache, and a
    # refinement round hashes no jobs.
    jobs_fp = "" if availability is not None \
        else _cache.fingerprint_job_arrays(arrays)
    use_cache = availability is None and _cache.enabled()
    if plan_backend == "device":
        return _build_grid_plan_device(jobs, policies, s, arrays, r_total,
                                       windows, selfowned, availability,
                                       torch.device(device), jobs_fp,
                                       use_cache)
    base = (jobs_fp, float(r_total), windows, selfowned, pool,
            int(slots_per_unit), "host")
    cached, miss = _cache_lookup(s, base, use_cache)
    need_ai = sorted({s.g_akey[gi] for gi in miss})
    need_w = sorted({s.a_plan[ai] for ai in need_ai})
    w_pos = {w: i for i, w in enumerate(need_w)}
    params = list(s.key_param.values())

    # Spans are opened even on an all-hit call: timings["plan"/"pool"]
    # stay the same floats as the span tracer's totals.
    with span("plan", plan_backend="host", windows=windows,
              n_plans=len(need_w), n_cached=len(cached)) as sp:
        if not need_w:
            built: list[PlanBatch] = []
        elif windows == "even":
            built = build_plans_batch(jobs, windows="even", arrays=arrays)
        else:
            built = build_plans_batch(jobs, [params[w] for w in need_w],
                                      windows="dealloc", arrays=arrays)
    plan_seconds = sp.seconds
    with span("pool", plan_backend="host", pool=pool,
              n_groups=len(miss)) as sp:
        alloc = {ai: _group_alloc(built[w_pos[s.a_plan[ai]]], s.a_beta0[ai],
                                  r_total, selfowned, pool, availability,
                                  slots_per_unit)
                 for ai in need_ai}
        groups: list[EvalGroup] = []
        for gi in range(len(s.g_bid)):
            if gi in cached:
                groups.append(cached[gi])
                continue
            ai = s.g_akey[gi]
            plan = built[w_pos[s.a_plan[ai]]]
            z_t, d_eff, pins, so_work, so_res = _cloud_residuals(plan,
                                                                 alloc[ai])
            g = EvalGroup(
                plan=plan, policy_idx=np.asarray(s.g_pols[gi]),
                bid=s.g_bid[gi], r_alloc=alloc[ai], z_t=z_t, d_eff=d_eff,
                pins=pins, selfowned_work=so_work, selfowned_reserved=so_res)
            groups.append(g)
            if use_cache:
                _cache.PLAN_CACHE.put((base, s.g_key[gi]), g)
    return GridPlan(jobs=jobs, policies=policies, groups=groups,
                    workload=arrays.z.sum(axis=1), arrival=arrays.arrival,
                    n_jobs=len(jobs), n_policies=len(policies),
                    L=arrays.z.shape[1], plan_seconds=plan_seconds,
                    pool_seconds=sp.seconds, plan_cached=len(cached),
                    jobs_fp=jobs_fp, group_keys=list(s.g_key))


def _cache_lookup(s: _GridStructure, base: tuple, use_cache: bool):
    """Consult the cross-call group cache: {group index -> cached group
    carrying this grid's policy columns} and the list of missing groups,
    which the callers build (and only those); the hit and miss counters
    are emitted here."""
    cached: dict[int, EvalGroup] = {}
    if use_cache:
        for gi in range(len(s.g_bid)):
            rec = _cache.PLAN_CACHE.get((base, s.g_key[gi]))
            if rec is not None:
                # The cached group keeps ITS exact bid: two bids rounding
                # to the same 12-decimal key are one group, in-grid and
                # across calls alike, so the hit is bit for bit.
                cached[gi] = dataclasses.replace(
                    rec, policy_idx=np.asarray(s.g_pols[gi]))
        _cache.plan_cache_events(hits=len(cached),
                                 misses=len(s.g_bid) - len(cached))
    miss = [gi for gi in range(len(s.g_bid)) if gi not in cached]
    return cached, miss


# --------------------------------------------------------------------------
# Device plan path: jobs -> plan tensors in float32 torch ops.
# --------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    """Wait for the device's queued work, so a phase's seconds are its own."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_plans(windows: str, e, delta, mask, omega, arrival, xs):
    """(W, J, L) raw window sizes, starts and ends on the device.

    ``ends`` is the arrival plus a running sum of the sizes in task order,
    one addition per task (``torch.cumsum`` scans in another order on CUDA
    than on the CPU). The raw sizes ride along: recomputing them as
    ends - starts would round-trip through the sum and inflate the f32
    noise ~L-fold, blowing the policy-(12) knife-edge guards (every
    fully-capped task sits exactly at f(beta_0) = 0).
    """
    if windows == "even":
        # xs carries the per-job Even slack share (slack_even / l).
        sizes = torch.where(mask, e + xs[:, None], torch.zeros_like(e))[None]
    else:
        sizes = window_sizes_batch_device(e, delta, mask, omega, xs)
    W, J, L = sizes.shape
    starts = torch.empty_like(sizes)
    ends = torch.empty_like(sizes)
    cum = torch.zeros((W, J), dtype=sizes.dtype, device=sizes.device)
    for k in range(L):
        starts[:, :, k] = arrival if k == 0 else ends[:, :, k - 1]
        cum = cum + sizes[:, :, k]
        ends[:, :, k] = arrival + cum
    return sizes, starts, ends


def _device_cells(counts_fn, z, delta, mask, sizes, plan_of_akey, b0_of_akey,
                  avail):
    """Counts, residuals, pins and self-owned sums per (window plan,
    beta_0) cell: (Ga, J, L) tensors, (Ga, S, J, L) under per-scenario
    availability (``avail`` 4-D), and the sums (Ga[, S], J)."""
    sizes_a = sizes[plan_of_akey]                       # (Ga, J, L)
    b0 = b0_of_akey[:, None, None]
    if avail.dim() == 4:                                # (Ga, S, J, L)
        sizes_a = sizes_a[:, None]
        b0 = b0[:, None]
    # Broadcast up front: a counts rule need not touch every operand (naive
    # = min(avail, delta) ignores the sizes), but axis 0 is the cell axis
    # the groups index.
    shape = torch.broadcast_shapes(sizes_a.shape, avail.shape, z.shape)
    counts = counts_fn(z, delta, sizes_a, b0, avail)
    r = torch.where(mask, counts, torch.zeros_like(counts)).expand(shape)
    work = r * sizes_a
    z_t = torch.clamp_min(z - work, 0.0)
    z_t = torch.where(z_t <= _DEVICE_DUST * (z + 1.0), torch.zeros_like(z_t),
                      z_t)
    d_eff = torch.clamp_min(delta - r, 0.0)
    useful = torch.minimum(work, z)
    # Serial sums in task order: the same bits on every device (the host
    # reads them; a reduction's order differs between the card and the CPU).
    so_work = torch.zeros(shape[:-1], dtype=z.dtype, device=z.device)
    so_res = torch.zeros_like(so_work)
    for k in range(shape[-1]):
        so_work = so_work + useful[..., k]
        so_res = so_res + work[..., k]
    return r, z_t, d_eff, r > 0, so_work, so_res


def _build_grid_plan_device(jobs, policies, s: _GridStructure, arrays,
                            r_total, windows, selfowned, availability,
                            dev: torch.device, jobs_fp: str,
                            use_cache: bool) -> GridPlan:
    """The reference's ``_build_grid_plan_device``: the query-free path in
    one pass over the groups the cache misses (windows -> starts/ends ->
    counts -> residuals -> group views), or, with availability callables,
    plans on the device, starts and ends staged to the host once for the
    queries, their results shipped back once, then the groups on the
    device."""
    # Same validation the host waterfill performs (device code would
    # silently clamp instead of raising).
    if np.any(arrays.omega < -1e-9):
        raise ValueError("infeasible job: window < critical path")
    if windows == "even":
        xs = np.maximum(arrays.slack_even(), 0.0) / arrays.l
    else:
        xs = np.fromiter(s.key_param.values(), dtype=np.float64)
        if np.any((xs <= 0.0) | (xs > 1.0)):
            bad = xs[(xs <= 0.0) | (xs > 1.0)][0]
            raise ValueError(f"Dealloc parameter must be in (0, 1], got {bad}")
    counts_fn = _selfowned_counts_device(selfowned)
    staged = availability is not None and r_total > 0

    # The device joins the key: a call never receives another device's
    # tensors. Staged calls never read or write the cache (use_cache).
    base = (jobs_fp, float(r_total), windows, selfowned, "device",
            _cache.device_key(dev))
    cached, miss = _cache_lookup(s, base, use_cache)
    need_ai = sorted({s.g_akey[gi] for gi in miss})
    ai_pos = {ai: i for i, ai in enumerate(need_ai)}
    need_w = sorted({s.a_plan[ai] for ai in need_ai})
    w_pos = {w: i for i, w in enumerate(need_w)}

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    # The query-free path is one "plan" span (windows through residuals,
    # the reference's fused program; pool 0.0); the staged path splits at
    # the host's availability queries into "plan" and "pool".
    with span("plan", plan_backend="device", windows=windows,
              n_cached=len(cached)) as sp:
        if miss:
            z, delta = f32(arrays.z), f32(arrays.delta)
            mask = torch.from_numpy(arrays.mask).to(dev)
            plan_of_akey = torch.as_tensor(
                [w_pos[s.a_plan[ai]] for ai in need_ai], dtype=torch.int64,
                device=dev)
            b0 = f32([np.nan if s.a_beta0[ai] is None else s.a_beta0[ai]
                      for ai in need_ai])
            # Even windows: xs is the per-job slack share of the one plan.
            sizes, starts, ends = _device_plans(
                windows, f32(arrays.e), delta, mask, f32(arrays.omega),
                f32(arrays.arrival),
                f32(xs if windows == "even" else xs[need_w]))
        if not staged and miss:
            avail = torch.tensor(float(max(r_total, 0)), dtype=torch.float32,
                                 device=dev)
            cells = _device_cells(counts_fn, z, delta, mask, sizes,
                                  plan_of_akey, b0, avail)
        _sync(dev)
    plan_seconds, pool_seconds = sp.seconds, 0.0
    if staged:
        with span("pool", plan_backend="device") as sp:
            h_starts, h_ends = starts.cpu().numpy(), ends.cpu().numpy()
            plan_rows = [w_pos[s.a_plan[ai]] for ai in need_ai]
            if isinstance(availability, (list, tuple)):
                avail = np.stack([[q(h_starts[p], h_ends[p])
                                   for q in availability]
                                  for p in plan_rows])
            else:
                avail = np.stack([availability(h_starts[p], h_ends[p])
                                  for p in plan_rows])
            cells = _device_cells(counts_fn, z, delta, mask, sizes,
                                  plan_of_akey, b0, f32(avail))
            _sync(dev)
        pool_seconds = sp.seconds

    groups = []
    if miss:
        nan = np.full(len(jobs), np.nan)
        plans = [PlanBatch(arrival=arrays.arrival, starts=starts[i],
                           ends=ends[i], z=arrays.z, delta=arrays.delta,
                           mask=arrays.mask, bid=nan, beta0=nan)
                 for i in range(len(need_w))]
        r_a, z_t_a, d_eff_a, pins_a, so_w_a, so_r_a = cells
        # The self-owned stats are read on the host only (the EngineResult
        # scatter): ship the two small stacks across once here. Everything
        # the cost kernels read (starts/ends, z_t, d_eff, pins) stays on the
        # device.
        so_w_a, so_r_a = so_w_a.cpu().numpy(), so_r_a.cpu().numpy()
    for gi in range(len(s.g_bid)):
        if gi in cached:
            groups.append(cached[gi])
            continue
        ai = ai_pos[s.g_akey[gi]]
        g = EvalGroup(
            plan=plans[w_pos[s.a_plan[s.g_akey[gi]]]],
            policy_idx=np.asarray(s.g_pols[gi]), bid=s.g_bid[gi],
            r_alloc=r_a[ai], z_t=z_t_a[ai], d_eff=d_eff_a[ai],
            pins=pins_a[ai], selfowned_work=so_w_a[ai],
            selfowned_reserved=so_r_a[ai])
        groups.append(g)
        if use_cache:
            _cache.PLAN_CACHE.put((base, s.g_key[gi]), g)
    return GridPlan(jobs=jobs, policies=policies, groups=groups,
                    workload=arrays.z.sum(axis=1), arrival=arrays.arrival,
                    n_jobs=len(jobs), n_policies=len(policies),
                    L=arrays.z.shape[1], plan_seconds=plan_seconds,
                    pool_seconds=pool_seconds, plan_backend="device",
                    plan_cached=len(cached), jobs_fp=jobs_fp,
                    group_keys=list(s.g_key))
