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
  ``kernels/learner_replay.py``, one block per (scenario, instance) (an
  update warp carrying the state, sample warps drawing from its
  snapshots), all of them in one launch.

Sampling is inverse-CDF against a per-scenario uniform stream drawn up
front in numpy, so every backend consumes the SAME randomness and produces
the same sampled-policy trace up to float ties, and all learners of a sweep
share the stream (common random numbers). ``replay_stream`` replays a
scenario stream chunk by chunk (``evaluate_grid_chunks``) and folds the
regret, with the adaptive adversary's feedback between chunks; under a
mesh the fold is sharded (``_sharded_fold``): each ``"data"`` rank replays
its own scenario slab, and one all-reduce per chunk sums the packed
statistics.
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
from repro_torch.learn.regret import LearnResult, StreamLearnResult
from repro_torch.obs import METRICS, maybe_snapshot, span
from repro_torch.obs.compiled import program

__all__ = ["replay", "replay_stream", "build_events"]


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


def _weight_metrics(specs, weights_mean) -> None:
    """Per-chunk learner telemetry: Shannon entropy (nats) of the mean
    weight posterior and the heaviest expert's share, one labeled series
    per learner instance. No-op unless the metrics registry is collecting."""
    if not METRICS.enabled:
        return
    w = np.maximum(np.asarray(weights_mean, np.float64), 0.0)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
    ent = -(w * np.log(np.maximum(w, 1e-300))).sum(axis=1)
    top = w.max(axis=1)
    hist = METRICS.histogram("learn.weight_entropy")
    gauge = METRICS.gauge("learn.top_weight")
    for k, sp in enumerate(specs):
        label = f"{k}:{sp.kind}"
        hist.observe(float(ent[k]), learner=label)
        gauge.set(float(top[k]), learner=label)


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
    return _replay_timed(C, arrivals, d, workload, learners, seed, rng,
                         backend, device)[0]


def _replay_timed(
    C,
    arrivals,
    d: float,
    workload=None,
    learners=("hedge",),
    seed: int = 0,
    rng: np.random.Generator | None = None,
    backend: str = "torch",
    device="cuda",
) -> tuple[LearnResult, float]:
    """:func:`replay` and the seconds of its ``replay`` span."""
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
    with span("replay", backend=backend, scenarios=S, learners=K) as sp_r:
        if backend == "numpy":
            chosen = np.zeros((S, K, n), dtype=np.int64)
            p_sel = np.zeros((S, K, n))
            e_cost = np.zeros((S, K, n))
            weights = np.zeros((S, K, m))
            for s in range(S):
                for k, sp in enumerate(specs):
                    chosen[s, k], p_sel[s, k], e_cost[s, k], weights[s, k] \
                        = _replay_numpy_one(C[s], sp, u[s], ev_kind, ev_j,
                                            etas[k], gammas[k])
        else:
            chosen, p_sel, e_cost, weights = _replay_torch(
                C, specs, etas, gammas, u, ev_kind, ev_j, n_done, dev)

    return LearnResult(
        specs=specs, chosen=chosen, p_chosen=p_sel, expected_unit=e_cost,
        weights=weights, unit_cost=C, arrivals=arrivals, workload=Z,
        feedback_delay=float(d), backend=backend), sp_r.seconds


def replay_stream(
    jobs,
    policies,
    scenarios,
    r_total: int = 0,
    *,
    learners=("hedge",),
    seed: int = 0,
    scenario_chunk: int | None = None,
    backend: str = "torch",
    windows: str = "dealloc",
    selfowned: str = "prop12",
    early_start: bool = True,
    overlap: bool | None = None,
    device="cuda",
    mesh=None,
) -> StreamLearnResult:
    """Regret straight from a scenario stream — no (S, J, P) tensor.

    The engine evaluates ``scenario_chunk`` scenarios per pass
    (``evaluate_grid_chunks`` on ``device``: one grid plan, a spec's price
    paths synthesized on the device), each chunk's counterfactual cost
    tensor is replayed by every learner in ``learners`` (scenario s keeps
    replay seed ``seed + s``, so the sampled traces are those of a
    monolithic ``replay`` over the materialized tensor), and the chunk's
    ``LearnResult`` is folded into a ``StreamLearnResult``: peak memory is
    chunk-sized. ``backend`` is the replay's (``"torch"``: the learner
    kernels on ``device``, one launch of each per chunk; ``"numpy"``: the
    float64 host loop). ``overlap`` double-buffers chunk synthesis (see
    ``evaluate_grid``); it is refused for adaptive sources.

    ``mesh`` (a ``GridMesh`` / shard count / ``None``) shards the stream:
    each chunk is evaluated sharded (over both dims of a 2-D mesh) and the
    fold runs sharded (:func:`_sharded_fold`): each ``"data"`` rank replays
    its scenario slab with the learner kernels and computes the regret
    statistics in float32 on its device, and the chunk's one collective is
    an all-reduce of the packed sums over ``"data"``. The statistics agree
    with the host fold to about 1e-4, not bit for bit. It needs
    ``backend="torch"``.

    When ``scenarios`` is an adaptive ``ScenarioSpec`` / ``ScenarioStream``
    the chunk's realized regret of ``learners[0]`` is fed back through
    ``ScenarioStream.observe`` BEFORE the next chunk is synthesized: the
    adversary watches the learner at chunk boundaries and concentrates its
    spikes on the most harmful period.
    """
    from repro_torch.engine.api import evaluate_grid_chunks
    from repro_torch.engine.mesh import as_scenario_mesh
    from repro_torch.engine.scenarios import as_source

    if not jobs:
        raise ValueError("need jobs")
    arrivals = np.array([j.arrival for j in jobs])
    if np.any(np.diff(arrivals) < -1e-9):
        raise ValueError("jobs must be arrival-ordered")
    d = max(j.deadline - j.arrival for j in jobs)
    Z = np.array([j.total_work for j in jobs])
    specs = [as_spec(l) for l in learners]
    if not specs:
        raise ValueError("need at least one learner")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown replay backend {backend!r}")
    mesh = as_scenario_mesh(mesh)
    if mesh is not None and backend != "torch":
        raise ValueError(
            f"mesh= shards the torch replay fold; replay backend "
            f"{backend!r} cannot (pass backend='torch')")

    source = as_source(scenarios)
    acc = StreamLearnResult(specs=specs, feedback_delay=float(d),
                            backend=backend)
    stream = evaluate_grid_chunks(
        jobs, policies, source, r_total, scenario_chunk=scenario_chunk,
        windows=windows, selfowned=selfowned, early_start=early_start,
        pool="dedicated", overlap=overlap, device=device, mesh=mesh)
    if mesh is not None:
        _sharded_fold(stream, source, acc, mesh, specs, arrivals, d, Z,
                      len(policies), seed, resolve_device(device))
        acc.obs = maybe_snapshot()
        return acc
    with span("replay_stream", backend=backend):
        for ci, ch in enumerate(stream):
            with span("fold", chunk=ci, s0=ch.s0, s1=ch.s1):
                lr = replay(ch.unit_cost, arrivals, d, workload=Z,
                            learners=specs, seed=seed + ch.s0,
                            backend=backend, device=device)
                feedback = acc.fold(lr)
            _weight_metrics(specs, lr.weights.mean(axis=0))
            # The chunk-boundary round trip: a no-op for every non-adaptive
            # source; the generator builds the NEXT chunk only after this
            # returns, so the adversary's state is current when spikes
            # land.
            source.observe(feedback)
    acc.obs = maybe_snapshot()
    return acc

def stage_learners(specs, etas, gammas, ev_kind, ev_j, n_done, dev) -> dict:
    """The learners' launch inputs on ``dev``, uploaded once before any
    launch: the Hedge and the other instances' spec indices (a list and a
    device index tensor each), their rates, the event stream and
    ``n_done``."""
    f32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    hedge = [k for k, sp in enumerate(specs) if sp.kind == "hedge"]
    other = [k for k, sp in enumerate(specs) if sp.kind != "hedge"]
    st = {"K": len(specs), "legs": []}
    if hedge:
        st["legs"].append((hedge, torch.as_tensor(hedge, device=dev), True,
                           {"etas": f32(etas[hedge]), "n_done": i32(n_done)}))
    if other:
        st["legs"].append((other, torch.as_tensor(other, device=dev), False,
                           {"kinds": [specs[k].kind for k in other],
                            "etas": f32(etas[other]),
                            "gammas": f32(gammas[other]),
                            "ev_kind": i32(ev_kind), "ev_j": i32(ev_j)}))
    return st


def kernel_launches(C_d, u_d, st):
    """The Hedge instances in one ``hedge_replay`` launch, the others in
    one ``learner_replay`` launch, over the device tensors ``C_d`` (S, J,
    P) and ``u_d`` (S, J) and :func:`stage_learners`' inputs ``st``;
    returns ``[(spec indices, their index tensor, is_hedge, outputs)]``
    with the outputs on the device."""
    outs = []
    for ks, idx, is_hedge, a in st["legs"]:
        out = wu.hedge_replay(C_d, a["etas"], u_d, a["n_done"]) if is_hedge \
            else lk.learner_replay(a["kinds"], C_d, a["etas"], a["gammas"],
                                   u_d, a["ev_kind"], a["ev_j"])
        outs.append((ks, idx, is_hedge, out))
    return outs


def _replay_torch(C, specs, etas, gammas, u, ev_kind, ev_j, n_done, dev):
    """``backend="torch"``: the Hedge instances in one ``hedge_replay``
    launch, the others in one ``learner_replay`` launch; results in spec
    order (host float64, traces int64)."""
    S, n, m = C.shape
    K = len(specs)
    f32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    chosen = np.zeros((S, K, n), dtype=np.int64)
    p_sel = np.zeros((S, K, n))
    e_cost = np.zeros((S, K, n))
    weights = np.zeros((S, K, m))
    for ks, _, is_hedge, out in kernel_launches(
            f32(C), f32(u), stage_learners(specs, etas, gammas, ev_kind,
                                           ev_j, n_done, dev)):
        if is_hedge:
            # Hedge's final sampling weights: normalized on the host in
            # float64.
            logw = out["logw"].cpu().numpy().astype(np.float64)
            w = np.exp(logw - logw.max(axis=-1, keepdims=True))
            w = w / w.sum(axis=-1, keepdims=True)
        else:
            w = out["weights"].cpu().numpy()
        chosen[:, ks] = out["chosen"].cpu().numpy()
        p_sel[:, ks] = out["p_chosen"].cpu().numpy()
        e_cost[:, ks] = out["expected_cost"].cpu().numpy()
        weights[:, ks] = w
    return chosen, p_sel, e_cost, weights


# --------------------------------------------------------------------------
# The sharded fold
# --------------------------------------------------------------------------

def fold_acc_size(K: int, J: int, P: int) -> int:
    """Length of the packed fold vector (the ``_unpack_fold`` layout)."""
    return 5 * K + 2 * K * J + K * P + 2


def _unpack_fold(flat: np.ndarray, K: int, J: int, P: int) -> dict:
    """Split the reduced flat vector back into the named per-learner sums
    (specs order)."""
    o = 0

    def take(n):
        nonlocal o
        v = flat[o:o + n]
        o += n
        return v

    out = {
        "realized": take(K), "expected": take(K), "regret": take(K),
        "regret_sq": take(K), "best_fixed": float(take(1)[0]),
        "curve": take(K * J).reshape(K, J),
        "curve_sq": take(K * J).reshape(K, J),
        "weights": take(K * P).reshape(K, P),
        "top_weight": take(K), "n": int(round(float(take(1)[0]))),
    }
    assert o == len(flat)
    return out


def _fold_sums(C, chosen, ec, w, Z, valid):
    """One slab's regret statistics, float32 torch on its device: the
    packed sums over its real rows (``valid``) in the ``_unpack_fold``
    layout, and the per-scenario realized regret (S_l, K).

    C (S_l, J, P) unit costs, chosen/ec (S_l, K, J) sampled traces and
    expected costs, w (S_l, K, P) final weights, Z (J,) workloads: the
    arithmetic of ``LearnResult``'s statistics, in float32.
    """
    Sl, K, J = chosen.shape
    zsum = Z.sum()
    per_job = torch.gather(C[:, None].expand(Sl, K, J, C.shape[2]), 3,
                           chosen[..., None])[..., 0]            # (S_l, K, J)
    realized = (per_job * Z).sum(dim=2) / zsum                   # (S_l, K)
    expected = (ec * Z).sum(dim=2) / zsum
    fixed_cum = (C * Z[:, None]).cumsum(dim=1)                   # (S_l, J, P)
    best_fixed = fixed_cum[:, -1].min(dim=1).values / zsum       # (S_l,)
    regret = realized - best_fixed[:, None]                      # (S_l, K)
    cum_real = (per_job * Z).cumsum(dim=2)                       # (S_l, K, J)
    p_star = fixed_cum[:, -1].argmin(dim=1)                      # (S_l,)
    cum_best = torch.gather(fixed_cum, 2,
                            p_star[:, None, None].expand(Sl, J, 1))[..., 0]
    curve = (cum_real - cum_best[:, None]) / Z.cumsum(dim=0)
    top_w = w.max(dim=2).values                                  # (S_l, K)
    v = valid.to(C.dtype)
    v1, v2 = v[:, None], v[:, None, None]
    sums = torch.cat([
        (realized * v1).sum(0),
        (expected * v1).sum(0),
        (regret * v1).sum(0),
        (regret ** 2 * v1).sum(0),
        (best_fixed * v).sum()[None],
        (curve * v2).sum(0).reshape(-1),
        (curve ** 2 * v2).sum(0).reshape(-1),
        (w * v2).sum(0).reshape(-1),
        (top_w * v1).sum(0),
        v.sum()[None],
    ])
    return sums, regret


def fold_chunk(mesh, red, C_d, u_d, Z_d, valid, lo: int, st):
    """One chunk of the sharded fold (program ``learn.fold:sharded``): the
    slab's learners (:func:`kernel_launches`), its statistics
    (:func:`_fold_sums`) packed into ``red[:size]`` and its regret of
    learner 0 at its chunk positions ``red[size + lo:]``, then ONE
    all-reduce over ``"data"`` sums ``red`` in place. ``red`` is the
    chunk's accumulator: zeros of ``fold_acc_size + mesh.pad(S)`` on the
    device, the one argument the program writes. Reads nothing back to
    the host."""
    from repro_torch.engine.mesh import all_reduce  # engine imports learn

    with program("learn.fold:sharded"):
        Sl, J, P = C_d.shape
        K, dev = st["K"], C_d.device
        chosen = torch.empty((Sl, K, J), dtype=torch.int64, device=dev)
        ec = torch.empty((Sl, K, J), dtype=torch.float32, device=dev)
        w = torch.empty((Sl, K, P), dtype=torch.float32, device=dev)
        for _, idx, is_hedge, out in kernel_launches(C_d, u_d, st):
            chosen[:, idx] = out["chosen"]
            ec[:, idx] = out["expected_cost"]
            w[:, idx] = torch.softmax(out["logw"], dim=-1) \
                if is_hedge else out["weights"]
        sums, regret = _fold_sums(C_d, chosen, ec, w, Z_d, valid)
        size = sums.shape[0]
        red[:size] = sums
        red[size + lo:size + lo + Sl] = regret[:, 0]
        return all_reduce(mesh, red)


def _sharded_fold(stream, source, acc, mesh, specs, arrivals, d, Z, P,
                  seed, dev) -> None:
    """Fold a meshed chunk stream into ``acc`` (the reference's
    ``_sharded_fold`` and the meshed branch of its ``replay_stream``).

    Every rank holds the chunk's spliced cost tensor; each ``"data"`` rank
    replays its slab (scenario s keeps uniforms ``seed + s``; padding rows
    repeat the last scenario and are masked by ``valid``), computes the
    statistics on its device and packs them, with its rows' regret of
    learner 0 at their chunk positions (zeros elsewhere), into ONE vector:
    ONE all-reduce over ``"data"`` per chunk (:func:`fold_chunk`) sums the
    statistics and hands every rank the whole chunk's feedback for the
    adaptive adversary. The ``"model"`` ranks compute identical sums. The
    host reads the reduced vector once per chunk and folds it in float64.
    """
    J = len(arrivals)
    K = len(specs)
    ev_kind, ev_j, n_done = build_events(arrivals, d)
    etas = np.stack([sp.eta.values(arrivals, d, P) for sp in specs])
    gammas = np.stack([sp.explore.values(arrivals, d, P) for sp in specs])
    f32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    Z_d = f32(Z)
    st = stage_learners(specs, etas, gammas, ev_kind, ev_j, n_done, dev)
    size = fold_acc_size(K, J, P)
    with span("replay_stream", backend="torch", sharded=True):
        for ci, ch in enumerate(stream):
            Sc = ch.unit_cost.shape[0]
            pos = mesh.slab(Sc)
            lo = mesh.data_rank * len(pos)
            u = np.stack([np.random.default_rng(seed + ch.s0 + s).random(J)
                          for s in pos])
            with span("fold", chunk=ci, s0=ch.s0, s1=ch.s1):
                red = torch.zeros(size + mesh.pad(Sc), dtype=torch.float32,
                                  device=dev)
                fold_chunk(mesh, red, f32(ch.unit_cost[pos]), f32(u), Z_d,
                           torch.from_numpy(mesh.slab_valid(Sc)).to(dev),
                           lo, st)
                red = red.cpu().numpy().astype(np.float64)
                g = _unpack_fold(red[:size], K, J, P)
                acc.fold_sums(g["n"], g["realized"], g["expected"],
                              g["regret"], g["regret_sq"], g["best_fixed"],
                              g["curve"], g["curve_sq"], g["weights"],
                              g["top_weight"])
            _weight_metrics(specs, g["weights"] / max(g["n"], 1))
            # The chunk-boundary round trip, as on the unsharded path.
            source.observe(red[size:size + Sc])
