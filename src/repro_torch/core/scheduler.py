"""Algorithm 2 — deadline + instance allocation over an arriving job stream.

Events (paper Alg. 2):

  * ``t = a_j``  — allocate deadlines to the job's chain (lines 1-5):
                   Dealloc(beta) when r = 0 or beta < beta_0,
                   Dealloc(beta_0) when r > 0 and beta_0 <= beta.
  * task start   — allocate self-owned instances r_i by policy (12)
                   (lines 6-10). Reservations live on the PLANNED windows
                   [s_{i-1}, s_i] (policy (12) is defined on them), so all
                   pool events are known at arrival and are processed in
                   global chronological order across overlapping jobs.
  * in-window    — spot while flexibility holds (Def. 3.1), on-demand after
                   the turning point (lines 11-15), realized exactly by
                   ``simulate_tasks``. Execution is *early-start* by default
                   (paper Table 1: a task begins at its predecessor's
                   realized finish); ``early_start=False`` gives the
                   planned-start variant used by the Even benchmark, whose
                   windows are prescriptive ("tasks are executed and
                   finished in the specified windows", Section 6.1).

``run_jobs`` is the realized system (shared-pool contention included, host
float64): ``_allocate_pool`` + ``_simulate_plan``, which TOLA's rounds
replay; the plan builders feed the engine's cost kernels.
``evaluate_policy_fullpool`` is the counterfactual evaluator — each
candidate policy sees the pool as if dedicated — routed through the port's
``repro_torch.engine.evaluate_grid`` (on the card by default).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dealloc import window_sizes, window_sizes_batch
from repro_torch.core.market import SpotMarket
from repro_torch.core.policy import f_selfowned
from repro_torch.core.pool import LazySegmentTree, RangeMax, SelfOwnedPool
from repro_torch.core.simulate import simulate_chains_early, simulate_tasks
from repro_torch.core.types import ChainJob

__all__ = [
    "Policy",
    "StreamCosts",
    "PlanBatch",
    "JobArrays",
    "job_arrays",
    "build_plans",
    "build_plans_batch",
    "selfowned_counts_vec_device",
    "run_jobs",
    "evaluate_policy_fullpool",
]


@dataclasses.dataclass(frozen=True)
class Policy:
    """One parametric policy {beta, b, beta_0} (paper Section 5)."""

    beta: float
    bid: float
    beta0: float | None = None  # None <=> no self-owned instances considered

    def dealloc_param(self, r_total: int) -> float:
        """Lines 1-5 of Algorithm 2: which parameter drives Dealloc."""
        if r_total > 0 and self.beta0 is not None and self.beta0 <= self.beta:
            return self.beta0
        return self.beta


@dataclasses.dataclass
class StreamCosts:
    """Per-job realized costs for a processed stream (all arrays (n_jobs,))."""

    spot_cost: np.ndarray
    ondemand_cost: np.ndarray
    spot_work: np.ndarray
    ondemand_work: np.ndarray
    selfowned_work: np.ndarray
    workload: np.ndarray       # Z_j
    selfowned_reserved: np.ndarray

    @classmethod
    def zeros(cls, n: int) -> "StreamCosts":
        return cls(*(np.zeros(n) for _ in range(7)))

    @property
    def total_cost(self) -> np.ndarray:
        return self.spot_cost + self.ondemand_cost

    def average_unit_cost(self) -> float:
        """alpha = sum_j c_j / sum_j Z_j (paper Section 6.1)."""
        return float(self.total_cost.sum() / self.workload.sum())


@dataclasses.dataclass
class PlanBatch:
    """Padded (n_jobs, L_max) plan of windows/workloads for a job stream."""

    arrival: np.ndarray    # (J,)
    starts: np.ndarray     # (J, L) planned window starts
    ends: np.ndarray       # (J, L) planned window ends (task deadlines)
    z: np.ndarray          # (J, L) task workloads (0 on padding)
    delta: np.ndarray      # (J, L) parallelism bounds (1 on padding)
    mask: np.ndarray       # (J, L) real-task mask
    bid: np.ndarray        # (J,) per-job bid price
    beta0: np.ndarray      # (J,) per-job beta_0 (nan = none)

    @property
    def sizes(self) -> np.ndarray:
        return self.ends - self.starts

    @property
    def workload(self) -> np.ndarray:
        return self.z.sum(axis=1)


def _job_windows(job: ChainJob, policy: Policy, r_total: int, mode: str) -> np.ndarray:
    if mode == "dealloc":
        return window_sizes(job, policy.dealloc_param(r_total))
    if mode == "even":
        e = job.e_array()
        return e + max(job.slack, 0.0) / job.l
    raise ValueError(f"unknown window mode {mode!r}")


def build_plans(
    jobs: list[ChainJob],
    policies: Policy | list[Policy],
    r_total: int = 0,
    windows: str = "dealloc",
) -> PlanBatch:
    """Lines 1-5 for every job: padded window/workload matrices."""
    J = len(jobs)
    pol_list = policies if isinstance(policies, list) else [policies] * J
    L = max(j.l for j in jobs)
    starts = np.zeros((J, L)); ends = np.zeros((J, L))
    z = np.zeros((J, L)); delta = np.ones((J, L))
    mask = np.zeros((J, L), dtype=bool)
    arrival = np.zeros(J); bid = np.zeros(J); beta0 = np.full(J, np.nan)
    for ji, (job, pol) in enumerate(zip(jobs, pol_list)):
        sizes = _job_windows(job, pol, r_total, windows)
        bounds = job.arrival + np.concatenate([[0.0], np.cumsum(sizes)])
        l = job.l
        starts[ji, :l] = bounds[:-1]; ends[ji, :l] = bounds[1:]
        # Padding keeps ends monotone so the early-start scan stays trivial.
        if l < L:
            starts[ji, l:] = bounds[-1]; ends[ji, l:] = bounds[-1]
        z[ji, :l] = job.z_array(); delta[ji, :l] = job.delta_array()
        mask[ji, :l] = True
        arrival[ji] = job.arrival
        bid[ji] = pol.bid
        beta0[ji] = pol.beta0 if pol.beta0 is not None else np.nan
    return PlanBatch(arrival=arrival, starts=starts, ends=ends, z=z,
                     delta=delta, mask=mask, bid=bid, beta0=beta0)


@dataclasses.dataclass
class JobArrays:
    """Padded per-job task arrays — the policy-independent half of a plan.

    Extracted ONCE per job stream (one cheap padding pass) and shared by
    every window plan of a grid; ``omega`` is the Dealloc slack
    ``window - e.sum()`` and ``slack_even`` the Even-benchmark slack
    (``job.slack``, a Python-sum of e_i) — kept separate because the two
    sequential paths reduce e differently and bit-compatibility requires
    reproducing each exactly.
    """

    arrival: np.ndarray   # (J,)
    z: np.ndarray         # (J, L) task workloads (0 on padding)
    delta: np.ndarray     # (J, L) parallelism bounds (1 on padding)
    e: np.ndarray         # (J, L) min execution times (0 on padding)
    mask: np.ndarray      # (J, L) real-task mask
    omega: np.ndarray     # (J,) Dealloc slack
    l: np.ndarray         # (J,) chain lengths
    jobs: list[ChainJob] | None = None  # source stream (Even-slack fallback)

    def slack_even(self) -> np.ndarray:
        """Even-benchmark slack per job (``job.slack``, the Python-sum
        variant — reduced lazily because only the Even window mode needs it
        and its per-task property walk is the costliest part of padding)."""
        return np.array([j.slack for j in self.jobs])


def job_arrays(jobs: list[ChainJob]) -> JobArrays:
    """One flat extraction pass over the stream.

    Task attributes come out as two flat list comprehensions (one array
    construction each, not one per job) and scatter into the padded (J, L)
    layout through the mask; ``e`` is the same IEEE divide as ``Task.e``
    element for element, and ``omega`` reduces each job's own contiguous
    e-row (identical length, identical pairwise sum) so everything stays
    bit-compatible with the per-job ``build_plans`` path.
    """
    J = len(jobs)
    ls = np.array([j.l for j in jobs], dtype=np.int64)
    L = int(ls.max())
    flat_z = np.array([t.z for j in jobs for t in j.tasks])
    flat_d = np.array([t.delta for j in jobs for t in j.tasks])
    mask = np.arange(L)[None, :] < ls[:, None]
    z = np.zeros((J, L)); delta = np.ones((J, L))
    z[mask] = flat_z
    delta[mask] = flat_d
    e = np.where(mask, z / delta, 0.0)
    flat_e = flat_z / flat_d
    off = np.concatenate([[0], np.cumsum(ls)])
    arrival = np.array([j.arrival for j in jobs])
    window = np.array([j.window for j in jobs])
    omega = np.array([window[ji] - float(flat_e[off[ji]:off[ji + 1]].sum())
                      for ji in range(J)])
    return JobArrays(arrival=arrival, z=z, delta=delta, e=e, mask=mask,
                     omega=omega, l=ls, jobs=jobs)


def _plans_from_sizes(arrays: JobArrays, sizes: np.ndarray) -> list[PlanBatch]:
    """(G, J, L) window sizes -> G padded PlanBatches (shared job arrays).

    Padded sizes are exactly 0, so the cumulative bounds stay flat past the
    chain end — starts == ends == the job deadline on padding, the same
    invariant ``build_plans`` writes explicitly.
    """
    G, J, L = sizes.shape
    cum = np.cumsum(sizes, axis=2)
    ends = arrays.arrival[None, :, None] + cum
    starts = np.empty_like(ends)
    starts[:, :, 0] = arrays.arrival[None, :]
    starts[:, :, 1:] = arrays.arrival[None, :, None] + cum[:, :, :-1]
    nan = np.full(J, np.nan)
    return [PlanBatch(arrival=arrays.arrival, starts=starts[g], ends=ends[g],
                      z=arrays.z, delta=arrays.delta, mask=arrays.mask,
                      bid=nan, beta0=nan)
            for g in range(G)]


def build_plans_batch(
    jobs: list[ChainJob],
    xs=(),
    windows: str = "dealloc",
    arrays: JobArrays | None = None,
) -> list[PlanBatch]:
    """Vectorized ``build_plans`` over a whole deduplicated parameter grid.

    ``windows="dealloc"``: one PlanBatch per Dealloc parameter in ``xs``,
    computed as a single (G, J, L) array pass (``window_sizes_batch``) —
    bit-identical to looping ``build_plans`` per parameter.
    ``windows="even"``: the parameter-free Even benchmark plan (``xs``
    ignored, one PlanBatch). The returned plans carry NaN ``bid``/``beta0``
    placeholders — they are window plans, not policy plans; callers supply
    the policy-dependent fields (the engine's plan layer does).
    """
    a = arrays if arrays is not None else job_arrays(jobs)
    if windows == "dealloc":
        xs = np.atleast_1d(np.asarray(xs, dtype=np.float64))
        if xs.size == 0:
            raise ValueError("need at least one Dealloc parameter")
        sizes = window_sizes_batch(a.e, a.delta, a.mask, a.omega, xs)
    elif windows == "even":
        per_task = np.maximum(a.slack_even(), 0.0) / a.l
        sizes = np.where(a.mask, a.e + per_task[:, None], 0.0)[None]
    else:
        raise ValueError(f"unknown window mode {windows!r}")
    return _plans_from_sizes(a, sizes)


def _selfowned_counts_vec(
    z: np.ndarray, delta: np.ndarray, sizes: np.ndarray,
    beta0: np.ndarray | float | None, available, mode: str,
) -> np.ndarray:
    """Integral r_i (policy (12) or the naive benchmark), vectorized.

    ``available`` may carry extra leading axes (e.g. a scenario axis for
    per-scenario residual-availability queries); everything broadcasts and
    the result takes the combined shape.
    """
    avail = np.asarray(available, dtype=np.float64)
    if mode == "prop12":
        if beta0 is None:
            return np.zeros_like(z)
        b0 = np.broadcast_to(np.asarray(beta0, dtype=np.float64), z.shape)
        safe_b0 = np.where(np.isnan(b0), 1.0, b0)
        f = np.ceil(f_selfowned(z, delta, np.maximum(sizes, 1e-12), safe_b0) - 1e-9)
        f = np.where(np.isnan(b0), 0.0, f)
        useful = np.ceil(np.where(sizes > 0, z / np.maximum(sizes, 1e-12), 0.0) - 1e-9)
        return np.maximum(0.0, np.minimum(np.minimum(f, avail),
                                          np.minimum(delta, useful)))
    if mode == "naive":
        return np.maximum(0.0, np.minimum(avail, delta))
    raise ValueError(f"unknown self-owned mode {mode!r}")


# Integral-count rounding guard of the DEVICE twin: the host path ceils
# with a 1e-9 absolute epsilon (f64 noise floor); device arithmetic is f32,
# whose ~1e-7 relative noise would push exact-integer f values (e.g. the
# zero-slack case f(beta_0) = delta) across the ceil boundary. 1e-5 absorbs
# that (as the reference's device twin does); the min(..., delta) clamp pins
# the common exact-integer cases. The remaining knife edge, an f64 value
# within (1e-9, 1e-5] above an integer, is not rare: a capped task's
# f(beta_0), 0 in exact arithmetic, can come out a few 1e-9 in f64, one
# instance on the host and none here (ROADMAP queue C).
_DEVICE_CEIL_EPS = 1e-5
# _BETA_ONE_EPS: the beta_0 == 1 knife edge of Eq. (11) — beta_0 arrives as
# an exact 1.0 from the grid builder, so 1e-12 only absorbs parsing /
# arithmetic blur, never a real beta_0 < 1.
_BETA_ONE_EPS = 1e-12


def _counts_prop12_device(z, delta, sizes, beta0, avail):
    s = torch.clamp_min(sizes, 1e-12)
    nan_b0 = torch.isnan(beta0)
    safe_b0 = torch.where(nan_b0, torch.ones_like(beta0), beta0)
    one = safe_b0 >= 1.0 - _BETA_ONE_EPS
    den = s * torch.where(one, torch.ones_like(safe_b0), 1.0 - safe_b0)
    # Eq.-(11) numerator z - delta*size*beta_0 is EXACTLY zero for every
    # task the Dealloc waterfill fills to its cap (there size = e/beta_0,
    # so delta*size*beta_0 = z by construction) — a systematic knife edge,
    # not a measure-zero one. Snap the f32 blur around it to the f = 0 the
    # f64 oracle computes.
    num = z - delta * s * safe_b0
    snap = one | (num <= _DEVICE_CEIL_EPS * (z + 1.0))
    f = num / torch.clamp_min(den, 1e-30)
    f = torch.where(snap, torch.zeros_like(f), f)
    f = torch.ceil(f - _DEVICE_CEIL_EPS)
    f = torch.where(nan_b0, torch.zeros_like(f), f)
    useful = torch.where(sizes > 0, z / s, torch.zeros_like(s))
    useful = torch.ceil(useful - _DEVICE_CEIL_EPS)
    return torch.clamp_min(torch.minimum(torch.minimum(f, avail),
                                         torch.minimum(delta, useful)), 0.0)


def _counts_naive_device(z, delta, sizes, beta0, avail):
    return torch.clamp_min(torch.minimum(avail, delta), 0.0)


def _selfowned_counts_device(mode: str):
    """The device twin of :func:`_selfowned_counts_vec` for one mode (the
    reference's ``_selfowned_counts_impl``): broadcast-generic, any argument
    may carry extra leading axes; NaN ``beta0`` means no self-owned
    instances (count 0). Float32 tensors on one device, one IEEE operation
    at a time (no division by a Python scalar, which CUDA turns into a
    reciprocal multiply), so the card and the CPU give the same bits."""
    if mode == "prop12":
        return _counts_prop12_device
    if mode == "naive":
        return _counts_naive_device
    raise ValueError(f"unknown self-owned mode {mode!r}")


def selfowned_counts_vec_device(z, delta, sizes, beta0, available,
                                mode: str = "prop12") -> torch.Tensor:
    """Integral r_i (policy (12) or the naive benchmark) on the device: the
    twin of the reference's ``selfowned_counts_vec_jax``.

    Float32 tensors on one device (``beta0`` and ``available`` may also be
    Python floats) with a widened ceil epsilon (``_DEVICE_CEIL_EPS``); the
    float64 host path stays the exact oracle.
    """
    as_t = lambda a: torch.as_tensor(a, dtype=z.dtype,  # noqa: E731
                                     device=z.device)
    return _selfowned_counts_device(mode)(z, delta, sizes, as_t(beta0),
                                          as_t(available))


# _SPAN_EPS: zero-length allocation windows (ends == starts to f64
# round-off) carry no work and must not claim pool slots.
_SPAN_EPS = 1e-12
# _HOST_DUST: kill z - r*size residue
# (~1e-13 on fully-self-owned tasks) before it reaches the cost kernels.
_HOST_DUST = 1e-9


_POOL_CHUNK = 256  # tasks per optimistic batch of the chronological alloc


def _allocate_pool(
    plan: PlanBatch, r_total: int, selfowned: str,
    slots_per_unit: int,
) -> tuple[np.ndarray, SelfOwnedPool | None]:
    """Chronological shared-pool allocation on the planned windows.

    Tasks are processed in chronological start order, but in *optimistic
    batches*: every task of a chunk is tentatively granted
    ``min(cap, total - rangemax(used))`` against the occupancy at chunk
    entry (one vectorized sparse-table query for the whole chunk), the
    chunk's combined occupancy delta is built as one diff-array cumsum, and
    if the pool stays within capacity everywhere the chunk commits with a
    single batched slot-grid write. That outcome is exactly what the
    sequential scan would produce: each task's own grant is part of the
    checked final occupancy, so feasibility pins every prefix grant to the
    tentative value from both sides (the entry-occupancy grant is an upper
    bound on the sequential grant, and a feasible total leaves each prefix
    at least that much room). Only chunks whose members genuinely interact
    (their combined writes would overfill some slot) fall back to the exact
    per-task order — allocation there is inherently order-dependent — which
    runs on a lazy-add segment tree (``pool.LazySegmentTree``): each task is
    one O(log n) range-max query + one O(log n) range-add instead of an
    O(span) occupancy rescan, so a fully saturated stream costs O(n log n)
    total. Grants are exact integers either way; the tree's pending deltas
    are flushed back into the slot grid before any batched attempt reads it.
    """
    J, L = plan.z.shape
    r_alloc = np.zeros((J, L))
    if r_total <= 0:
        return r_alloc, None
    flat = np.nonzero(plan.mask.ravel())[0]
    starts = plan.starts.ravel()[flat]
    ends = plan.ends.ravel()[flat]
    zf = plan.z.ravel()[flat]
    df = plan.delta.ravel()[flat]
    b0f = np.repeat(plan.beta0, L)[flat]
    sizes = np.maximum(ends - starts, 1e-12)
    # Pool-independent cap of policy (12) (or the naive benchmark),
    # vectorized up front; the chronological pass only intersects it with
    # the pool's live availability.
    cap = _selfowned_counts_vec(zf, df, sizes, b0f, np.inf, selfowned)
    horizon = max(float(ends.max()), 1.0)
    pool = SelfOwnedPool(r_total, horizon, slots_per_unit)
    out = np.zeros(len(flat))
    # Conservative slot coverage (matches SelfOwnedPool._span).
    slot = pool.slot
    k1s = np.maximum(np.floor(starts / slot + 1e-9).astype(np.int64), 0)
    k2s = np.minimum(np.ceil(ends / slot - 1e-9).astype(np.int64), pool.n_slots)
    k2s = np.maximum(k2s, k1s + 1)
    used = pool.used
    total = pool.total
    spans = ends - starts
    live = (cap > 0.0) & (spans > _SPAN_EPS)
    order = np.argsort(starts, kind="stable")
    # Python-native scalars for the contended scan (numpy scalar boxing is
    # the dominant per-task cost there).
    k1l, k2l = k1s.tolist(), k2s.tolist()
    capl, spanl, zfl = cap.tolist(), spans.tolist(), zf.tolist()
    reserved_t = worked_t = 0.0
    cooldown = 0  # chunks to run sequentially after a failed batch attempt
    tree: LazySegmentTree | None = None
    tdiff: np.ndarray | None = None  # grants pending flush into `used`
    def _flush() -> None:
        """Fold the tree stretch's grants back into the slot grid."""
        nonlocal tree, tdiff
        if tree is not None:
            used[:] += np.cumsum(tdiff[:-1])
            tree = None
            tdiff = None

    for pos in range(0, len(order), _POOL_CHUNK):
        sel = order[pos:pos + _POOL_CHUNK]
        sel = sel[live[sel]]
        if len(sel) == 0:
            continue
        run = sel
        if cooldown > 0:
            cooldown -= 1
        else:
            _flush()
            lo = int(k1s[sel].min())
            hi = int(k2s[sel].max())
            m0 = RangeMax(used[lo:hi]).query(k1s[sel] - lo, k2s[sel] - lo)
            r0 = np.floor(np.minimum(cap[sel], total - m0)).astype(np.int64)
            r0 = np.maximum(r0, 0)
            diff = np.zeros(hi - lo + 1, dtype=np.int64)
            np.add.at(diff, k1s[sel] - lo, r0)
            np.add.at(diff, k2s[sel] - lo, -r0)
            add = np.cumsum(diff[:-1])
            if (used[lo:hi] + add).max(initial=0) <= total:
                used[lo:hi] += add
                out[sel] = r0
                reserved = r0 * spans[sel]
                reserved_t += reserved.sum()
                worked_t += np.minimum(reserved, zf[sel]).sum()
                continue
            # Contended chunk: tasks the entry occupancy leaves no room for
            # provably get r == 0 (occupancy only grows within the chunk),
            # so the exact order below only visits the rest; back off from
            # batch attempts while the stream stays saturated.
            run = sel[m0 <= total - 1]
            cooldown = 4
        if len(run) and tree is None:
            tree = LazySegmentTree(used)
            tdiff = np.zeros(len(used) + 1, dtype=np.int64)
        for i in run.tolist():
            k1, k2 = k1l[i], k2l[i]
            avail = total - tree.max(k1, k2)
            c = capl[i]
            r = int(c) if c <= avail else avail
            if r > 0:
                tree.add(k1, k2, r)
                tdiff[k1] += r
                tdiff[k2] -= r
                span = spanl[i]
                reserved_t += r * span
                worked = r * span
                zfi = zfl[i]
                worked_t += zfi if zfi < worked else worked
                out[i] = r
    _flush()
    pool.reserved_instance_time += reserved_t
    pool.worked_instance_time += worked_t
    r_alloc.ravel()[flat] = out
    return r_alloc, pool


def _simulate_plan(
    plan: PlanBatch, r_alloc: np.ndarray, market: SpotMarket,
    early_start: bool,
) -> StreamCosts:
    """Spot/on-demand realization of a planned batch (per-bid grouping)."""
    J, L = plan.z.shape
    sizes = plan.sizes
    z_t = np.maximum(plan.z - r_alloc * sizes, 0.0)
    # Kill float dust (z - r*size ~ 1e-13 on fully-self-owned tasks).
    z_t[z_t <= _HOST_DUST * (plan.z + 1.0)] = 0.0
    d_eff = np.maximum(plan.delta - r_alloc, 0.0)
    selfowned_work = np.minimum(r_alloc * sizes, plan.z)

    out = StreamCosts.zeros(J)
    out.workload[:] = plan.workload
    out.selfowned_work[:] = selfowned_work.sum(axis=1)
    out.selfowned_reserved[:] = (r_alloc * sizes).sum(axis=1)

    for bid in np.unique(plan.bid):
        jm = plan.bid == bid
        view = market.view(float(bid))
        if early_start:
            sim = simulate_chains_early(
                view, plan.arrival[jm], plan.ends[jm], z_t[jm], d_eff[jm],
                selfowned_pins=(r_alloc[jm] > 0), p_ondemand=market.p_ondemand)
            out.spot_cost[jm] = sim.spot_cost
            out.ondemand_cost[jm] = sim.ondemand_cost
            out.spot_work[jm] = sim.spot_work
            out.ondemand_work[jm] = sim.ondemand_work
        else:
            rows = np.nonzero(jm)[0]
            fl = plan.mask[jm].ravel()
            sim = simulate_tasks(
                view, plan.starts[jm].ravel()[fl], plan.ends[jm].ravel()[fl],
                z_t[jm].ravel()[fl], d_eff[jm].ravel()[fl], market.p_ondemand)
            owner = np.repeat(rows, plan.mask[jm].sum(axis=1))
            np.add.at(out.spot_cost, owner, sim.spot_cost)
            np.add.at(out.ondemand_cost, owner, sim.ondemand_cost)
            np.add.at(out.spot_work, owner, sim.spot_work)
            np.add.at(out.ondemand_work, owner, sim.ondemand_work)
    return out


def run_jobs(
    jobs: list[ChainJob],
    policy: Policy | list[Policy],
    market: SpotMarket,
    r_total: int = 0,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    early_start: bool = True,
    return_pool: bool = False,
) -> StreamCosts | tuple[StreamCosts, np.ndarray, SelfOwnedPool | None]:
    """Realized processing of a job stream (shared pool, chronological)."""
    plan = build_plans(jobs, policy, r_total, windows)
    r_alloc, pool = _allocate_pool(plan, r_total, selfowned, market.slots_per_unit)
    costs = _simulate_plan(plan, r_alloc, market, early_start)
    if return_pool:
        return costs, r_alloc, pool
    return costs


def evaluate_policy_fullpool(
    jobs: list[ChainJob],
    policy: Policy,
    market: SpotMarket,
    r_total: int = 0,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    early_start: bool = True,
    availability=None,
    device="cuda",
) -> StreamCosts:
    """Counterfactual per-job costs with a dedicated (uncontended) pool.

    ``availability``: optional callable ``(starts, ends) -> (J, L) array`` of
    per-task self-owned availability. Defaults to the dedicated pool
    (``r_total`` everywhere); TOLA's pool-aware refinement passes the
    realized residual-occupancy query instead.

    Routed through the engine as a 1-policy grid (on the card unless
    ``device="cpu"``); grids should call ``repro_torch.engine.evaluate_grid``
    directly.
    """
    from repro_torch.engine import evaluate_grid  # engine depends on this module

    res = evaluate_grid(
        jobs, [policy], market, r_total, windows=windows,
        selfowned=selfowned, early_start=early_start,
        availability=availability, pool="dedicated", device=device)
    return res.stream_costs(0, 0)
