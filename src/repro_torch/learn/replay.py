"""Batched replay of the online-learning recurrence over a cost tensor.

The paper's Alg. 4 is a sequential recurrence over a merged event stream:
when job j ARRIVES a policy is sampled from the learner's current
distribution; once its window has fully ELAPSED (``t = a_j + d``) its
counterfactual costs become observable and the learner state is updated.
This module replays learners over the engine's (scenarios x jobs x
policies) cost tensor:

* ``backend="numpy"`` — the sequential float64 event loop, the exact
  oracle, and what TOLA's rounds run. For ``hedge`` with the ``alg4``
  schedule it consumes the uniform stream exactly as ``rng.choice`` would.
* ``backend="torch"`` — Hedge instances go through the fused
  ``kernels/weight_update.py`` kernel, all (scenario x schedule) instances
  in one launch; every other instance (exp3, ucb1, egreedy, ftl) through
  ``kernels/learner_replay.py``, one warp per (scenario, instance) walking
  the event stream, all of them in one launch.

Sampling is inverse-CDF against a per-scenario uniform stream drawn up
front in numpy, so every backend consumes the SAME randomness and produces
the same sampled-policy trace up to float ties, and all learners of a sweep
share the stream (common random numbers).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import learner_replay as lk
from repro_torch.kernels import weight_update as wu
from repro_torch.learn.learners import (
    as_spec,
    init_state,
    sample_probs,
    update_state,
)
from repro_torch.learn.regret import LearnResult

__all__ = ["replay", "build_events"]


def build_events(arrivals: np.ndarray, d: float):
    """Merged (sample, update) event stream, exactly as Alg. 4 orders it.

    Returns ``(ev_kind, ev_j, n_done)``: per-event kind (0 = sample at
    ``a_j``, 1 = update at ``a_j + d``) and job index, in lexicographic
    (t, kind, j) order — at equal times samples precede updates — plus
    ``n_done[j]``, the number of updates already applied when job j samples
    (the delayed-feedback offsets the trajectory kernel consumes).
    """
    n = len(arrivals)
    events = sorted(
        [(float(arrivals[j]), 0, j) for j in range(n)]
        + [(float(arrivals[j] + d), 1, j) for j in range(n)]
    )
    ev_kind = np.array([k for _, k, _ in events], dtype=np.int32)
    ev_j = np.array([j for _, _, j in events], dtype=np.int32)
    upd_before = np.concatenate([[0], np.cumsum(ev_kind)])[:-1]
    n_done = np.zeros(n, dtype=np.int32)
    sample_pos = ev_kind == 0
    n_done[ev_j[sample_pos]] = upd_before[sample_pos]
    return ev_kind, ev_j, n_done


def _sample_cdf(p: np.ndarray, u: float) -> int:
    """What ``np.random.Generator.choice(m, p)`` does with one uniform."""
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    return min(int(np.searchsorted(cdf, u, side="right")), len(p) - 1)


def _replay_numpy_one(C, spec, u, ev_kind, ev_j, etas, gammas):
    """Sequential float64 event loop for one (scenario, learner) instance."""
    n, m = C.shape
    st = init_state(m)
    chosen = np.zeros(n, dtype=np.int64)
    p_sel = np.zeros(n)
    e_cost = np.zeros(n)
    for kind, j in zip(ev_kind, ev_j):
        if kind == 0:
            p = sample_probs(spec.kind, st, gammas[j])
            c = _sample_cdf(p, u[j])
            chosen[j] = c
            p_sel[j] = p[c]
            e_cost[j] = float(p @ C[j])
        else:
            oh = np.where(np.arange(m) == chosen[j], 1.0, 0.0)
            st = update_state(spec.kind, st, C[j], oh, p_sel[j], etas[j])
    weights = sample_probs(spec.kind, st, gammas[-1])
    return chosen, p_sel, e_cost, weights


def replay(
    C,
    arrivals,
    d: float,
    workload=None,
    learners=("hedge",),
    seed: int = 0,
    rng: np.random.Generator | None = None,
    backend: str = "torch",
    device="cuda",
) -> LearnResult:
    """Replay a batch of learners over a (S, J, P) counterfactual tensor.

    ``C`` is the engine's cost tensor (an ``EngineResult``, its
    ``unit_cost``, or a (J, P) / (S, J, P) array); ``arrivals`` the
    arrival-ordered job times, ``d`` the max relative deadline (feedback
    delay), ``workload`` the per-job Z_j used by the regret accounting
    (defaults to 1). ``learners`` is a flat list of kinds / ``LearnerSpec``s;
    the result keeps their order. ``rng`` (single-scenario only) draws the
    uniform stream from a live generator — the hook TOLA's rounds use;
    otherwise scenario s uses ``seed + s``. ``device`` is where
    ``backend="torch"`` runs its kernels.
    """
    if hasattr(C, "unit_cost"):
        if workload is None:
            workload = C.workload
        C = C.unit_cost
    C = np.asarray(C, dtype=np.float64)
    if C.ndim == 2:
        C = C[None]
    if C.ndim != 3:
        raise ValueError(f"cost tensor must be (S, J, P); got {C.shape}")
    S, n, m = C.shape
    arrivals = np.asarray(arrivals, dtype=np.float64)
    if len(arrivals) != n:
        raise ValueError("arrivals length != n_jobs axis of C")
    Z = np.ones(n) if workload is None else np.asarray(workload, np.float64)
    specs = [as_spec(l) for l in learners]
    if not specs:
        raise ValueError("need at least one learner")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown replay backend {backend!r}")
    if backend == "torch":
        dev = resolve_device(device)

    ev_kind, ev_j, n_done = build_events(arrivals, d)
    etas = np.stack([sp.eta.values(arrivals, d, m) for sp in specs])
    gammas = np.stack([sp.explore.values(arrivals, d, m) for sp in specs])
    if rng is not None:
        if S != 1:
            raise ValueError("rng streams are single-scenario only")
        u = rng.random(n)[None]
    else:
        u = np.stack([np.random.default_rng(seed + s).random(n)
                      for s in range(S)])

    K = len(specs)
    if backend == "numpy":
        chosen = np.zeros((S, K, n), dtype=np.int64)
        p_sel = np.zeros((S, K, n))
        e_cost = np.zeros((S, K, n))
        weights = np.zeros((S, K, m))
        for s in range(S):
            for k, sp in enumerate(specs):
                chosen[s, k], p_sel[s, k], e_cost[s, k], weights[s, k] = \
                    _replay_numpy_one(C[s], sp, u[s], ev_kind, ev_j,
                                      etas[k], gammas[k])
    else:
        chosen, p_sel, e_cost, weights = _replay_torch(
            C, specs, etas, gammas, u, ev_kind, ev_j, n_done, dev)

    return LearnResult(
        specs=specs, chosen=chosen, p_chosen=p_sel, expected_unit=e_cost,
        weights=weights, unit_cost=C, arrivals=arrivals, workload=Z,
        feedback_delay=float(d), backend=backend)


def _replay_torch(C, specs, etas, gammas, u, ev_kind, ev_j, n_done, dev):
    """``backend="torch"``: the Hedge instances in one ``hedge_replay``
    launch, the others in one ``learner_replay`` launch; results in spec
    order (host float64, traces int64)."""
    S, n, m = C.shape
    K = len(specs)
    f32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    chosen = np.zeros((S, K, n), dtype=np.int64)
    p_sel = np.zeros((S, K, n))
    e_cost = np.zeros((S, K, n))
    weights = np.zeros((S, K, m))
    C_d, u_d = f32(C), f32(u)
    hedge = [k for k, sp in enumerate(specs) if sp.kind == "hedge"]
    other = [k for k, sp in enumerate(specs) if sp.kind != "hedge"]
    outs = []
    if hedge:
        out = wu.hedge_replay(C_d, f32(etas[hedge]), u_d, i32(n_done))
        # Hedge's final sampling weights: normalized on the host in float64.
        logw = out["logw"].cpu().numpy().astype(np.float64)
        w = np.exp(logw - logw.max(axis=-1, keepdims=True))
        outs.append((hedge, out, w / w.sum(axis=-1, keepdims=True)))
    if other:
        out = lk.learner_replay(
            [specs[k].kind for k in other], C_d, f32(etas[other]),
            f32(gammas[other]), u_d, i32(ev_kind), i32(ev_j))
        outs.append((other, out, out["weights"].cpu().numpy()))
    for ks, out, w in outs:
        chosen[:, ks] = out["chosen"].cpu().numpy()
        p_sel[:, ks] = out["p_chosen"].cpu().numpy()
        e_cost[:, ks] = out["expected_cost"].cpu().numpy()
        weights[:, ks] = w
    return chosen, p_sel, e_cost, weights
