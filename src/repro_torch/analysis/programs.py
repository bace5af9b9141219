"""Layer 2: the program verifier, the port's ``repro.analysis.programs``.

The reference traces its jit programs abstractly and never executes them.
Torch has no jaxpr: the port's programs are eager torch ops and
hand-written kernels. So the verifier RUNS each registered program twice
on the requested device at the reference's canonical small shapes, once
to build it (lazy library loads, caches, a communicator's first use) and
once under watch, and asserts per program:

- **build**: the program constructs and runs (an unknown key fails here);
- **syncs** (the reference's ``callbacks``): under a ``TorchDispatchMode``
  no ``aten._local_scalar_dense`` (``.item()``, ``float(t)``, ``bool(t)``)
  and no op whose output shape depends on the data (``nonzero``,
  ``masked_select``, ``unique``, boolean-mask indexing...), and on the card
  no copy between the card and the host; on the card the program also runs
  under ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
  synchronizing call PyTorch makes (``.tolist()`` reaches no dispatcher
  on the CPU: there only RPR005 sees it);
- **dtype** (§6): no float64 or complex128 op output (views aside),
  except at the named (program, op) allowances of :data:`F64_ALLOWED`,
  each the deliberate float64 site ROADMAP queue C explains;
- **mutation** (the reference's ``donation``): no tensor reachable from an
  argument changes its ``_version``, save the arguments the program is
  declared to write: the sharded fold's accumulator, the reference's one
  whitelisted donation, which must move;
- **collectives** (§9): the exact per-kind counts
  ``obs.compiled.collective_counts(key)`` records over the watched run,
  after ``reset_collectives()``; the verifier runs every program inside
  ``program(key)``, so a collective the program issues outside its own
  block counts too;
- **launches** (on the card): each kernel the program must reach raised
  its ``kernels.LAUNCHES`` counter — the kernel ran, not its plain version.

The reference's ``weak-type`` check has no counterpart: torch has no weak
types (a Python scalar operand never becomes a tensor of its own dtype),
so no output can fragment a cache the way a weak JAX aval does.

Program inventory (each reference key with its port function; the eval,
gather and fold programs run on the given 1x1 or larger ``GridMesh``):

==============================  =========================================
engine.eval.chain:sharded       ``engine.backend.eval_sharded`` (chain)
engine.eval.task:sharded        ``engine.backend.eval_sharded`` (task)
engine.eval.chain_ps:sharded    the same, per-scenario plans
engine.eval.task_ps:sharded     the same, per-scenario plans
engine.gather:sharded           ``engine.backend.gather_sharded`` (port)
scenarios.synth:fresh:sharded   ``engine.scenarios._device_synth``
scenarios.views:sharded         ``engine.scenarios._device_views``
plan.device.full                ``engine.plan._device_plans`` + ``_cells``
learn.scan:hedge                ``learn.replay.kernel_launches`` (Hedge)
learn.fold:sharded              ``learn.replay.fold_chunk`` (writes acc)
kernels.policy_cost.chain       ``kernels.policy_cost.policy_cost_chain``
kernels.policy_cost             ``kernels.policy_cost.policy_cost`` (port)
kernels.hedge_replay            ``kernels.weight_update.hedge_replay``
kernels.learner_replay          ``kernels.learner_replay`` (port)
kernels.flash_attention         ``kernels.ops.flash_attention``
kernels.ssd_scan                ``kernels.ops.ssd``
==============================  =========================================

On the CPU the kernel wrappers take their plain versions: the same
checks hold them, and the launch check is the card's alone.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = [
    "CheckResult", "ProgramSpec", "PROGRAM_KEYS", "F64_ALLOWED",
    "program_inventory", "verify_program", "verify_all",
]

# §9 placement contract: exact per-kind collective counts.
_ZERO = {"total": 0}
_ONE_GATHER = {"all-gather": 1, "total": 1}
_ONE_REDUCE = {"all-reduce": 1, "total": 1}

PROGRAM_KEYS = (
    "engine.eval.chain:sharded",
    "engine.eval.task:sharded",
    "engine.eval.chain_ps:sharded",
    "engine.eval.task_ps:sharded",
    "engine.gather:sharded",
    "scenarios.synth:fresh:sharded",
    "scenarios.views:sharded",
    "plan.device.full",
    "learn.scan:hedge",
    "learn.fold:sharded",
    "kernels.policy_cost.chain",
    "kernels.policy_cost",
    "kernels.hedge_replay",
    "kernels.learner_replay",
    "kernels.flash_attention",
    "kernels.ssd_scan",
)

_QUEUE_C = "ROADMAP queue C"
# (program, op) -> why the op may output float64 there.
F64_ALLOWED = {
    "scenarios.views:sharded": dict.fromkeys(
        ("aten.zeros", "aten.cumsum", "aten.cat"),
        "core/market.py::stacked_view_tensors sums A and C in float64 and "
        "rounds once: a float32 cumsum drifts by 1.7e-3 over 33021 slots "
        f"on the card ({_QUEUE_C})"),
    "kernels.ssd_scan": dict.fromkeys(
        ("aten.empty", "aten._to_copy", "aten.cumsum", "aten.sub"),
        "the SSD decay cumsum of A * dt is taken in float64, the kernel's "
        "scratch and the plain version's sum alike: float32 differences "
        f"of a long cumsum lose the decay ({_QUEUE_C})"),
    "kernels.learner_replay": dict.fromkeys(
        ("aten._to_copy", "aten.exp", "aten.log"),
        "learner_replay's plain version rounds exp and log through "
        "float64 as the kernel does (_f64), so both agree bit for bit "
        f"({_QUEUE_C})"),
}

# Ops whose use on the card waits for it, or whose output shape depends on
# the data (they read a count back to the host).
_SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
    "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.equal", "aten.is_nonzero",
})
_INDEX_OPS = frozenset({"aten.index", "aten.index_put", "aten.index_put_",
                        "aten._index_put_impl_"})


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """One contract assertion on one program."""

    program: str
    check: str   # build | syncs | dtype | mutation | collectives | launches
    ok: bool
    detail: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ProgramSpec:
    key: str
    fn: object                  # callable over ``args``
    args: tuple                 # tensors on the device and host objects
    collectives: dict           # expected exact counts (subset of kinds)
    mutated: tuple = ()         # argnums the program must write
    launches: tuple = ()        # kernels.LAUNCHES keys a card run raises


# --------------------------------------------------------------------------
# Watching a run
# --------------------------------------------------------------------------

def _tensors(obj, seen=None, depth=0) -> list:
    """Every tensor reachable from ``obj`` through containers and the
    fields of the port's own objects (a plan's groups, a batch's views)."""
    import torch

    seen = set() if seen is None else seen
    if id(obj) in seen or depth > 8:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    elif type(obj).__module__.startswith("repro_torch") \
            and hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return []
    return [t for it in items for t in _tensors(it, seen, depth + 1)]


def _watch_mode(device):
    """A ``TorchDispatchMode`` recording the syncs and wide outputs of
    every op it sees."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    # The dtypes the check looks for, not a tensor of the program's.
    wide_types = (torch.float64, torch.complex128)  # repro: noqa RPR003
    on_card = device.type == "cuda"

    def leaves(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            for y in x:
                yield from leaves(y)

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.syncs: list[str] = []
            self.wide: list[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func.overloadpacket)
            if name in _SYNC_OPS:
                self.syncs.append(name)
            elif name in _INDEX_OPS and len(args) > 1 and any(
                    isinstance(i, torch.Tensor)
                    and i.dtype in (torch.bool, torch.uint8)
                    for i in (args[1] or ())):
                self.syncs.append(f"{name} (boolean mask)")
            elif on_card and name in ("aten._to_copy", "aten.copy_") \
                    and not kwargs.get("non_blocking", False):
                devs = {t.device.type for t in leaves(list(args))}
                dst = kwargs.get("device")
                if dst is not None:
                    devs.add(torch.device(dst).type)
                if len(devs) > 1:
                    self.syncs.append(f"{name} (host <-> card)")
            out = func(*args, **kwargs)
            if not getattr(func, "is_view", False):
                for t in leaves(out):
                    if t.dtype in wide_types:
                        self.wide.append(f"{name} -> {t.dtype}")
            return out

    return Watch()


class _SyncDebug:
    """``torch.cuda.set_sync_debug_mode("error")`` for the block on the
    card; nothing elsewhere."""

    def __init__(self, device):
        self.on = device.type == "cuda"

    def __enter__(self):
        if self.on:
            import torch

            self._old = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        if self.on:
            import torch

            torch.cuda.set_sync_debug_mode(self._old)
        return False


def _clone_args(args: Sequence, mutated: Sequence[int]) -> tuple:
    """``args`` with each written argument cloned (the build run's copy)."""
    import torch

    return tuple(a.clone() if i in mutated and isinstance(a, torch.Tensor)
                 else a for i, a in enumerate(args))


# --------------------------------------------------------------------------
# Per-program verification
# --------------------------------------------------------------------------

def verify_program(fn, args: Sequence, *, key: str = "?",
                   collectives: dict | None = None,
                   mutated: Sequence[int] = (), device="cpu",
                   launches: Sequence[str] = ()) -> list[CheckResult]:
    """Run one program twice on ``device`` (a build run, then a watched
    run) and return its checks."""
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.obs import compiled

    device = torch.device(device)
    mutated = tuple(mutated)
    try:
        with compiled.program(key):
            fn(*_clone_args(args, mutated))
    except Exception as exc:
        return [CheckResult(key, "build", False,
                            f"{key}: build run failed: "
                            f"{type(exc).__name__}: {exc}")]

    watched = [(i, t) for i, a in enumerate(args) for t in _tensors(a)]
    before = [t._version for _, t in watched]
    launched = dict(LAUNCHES)
    compiled.reset_collectives()
    watch = _watch_mode(device)
    error = None
    try:
        with _SyncDebug(device), watch, compiled.program(key):
            fn(*args)
        if device.type == "cuda":
            # An asynchronous fault of the watched launches surfaces here,
            # inside the check (the program itself is already done).
            torch.cuda.synchronize(device)  # repro: noqa RPR005
    except Exception as exc:
        error = exc
    if error is not None and "synchroniz" not in str(error):
        return [CheckResult(key, "build", False,
                            f"{key}: watched run failed: "
                            f"{type(error).__name__}: {error}")]
    results = [CheckResult(key, "build", True, f"ran on {device}")]

    syncs = sorted(set(watch.syncs))
    if error is not None:
        syncs.append(f"sync debug mode: {error}")
    results.append(CheckResult(
        key, "syncs", not syncs,
        f"{key}: host syncs in the program: {syncs}" if syncs
        else "no host sync, no data-dependent shape"))

    allowed = F64_ALLOWED.get(key, {})
    wide = sorted({w for w in watch.wide
                   if w.split(" -> ")[0] not in allowed})
    kept = sorted({w.split(" -> ")[0] for w in watch.wide} & set(allowed))
    results.append(CheckResult(
        key, "dtype", not wide,
        f"{key}: float64/complex128 outputs: {wide}" if wide
        else f"float64 only at the named allowances {kept}" if kept
        else "no float64 op output"))

    moved = sorted({i for (i, t), v in zip(watched, before)
                    if t._version != v})
    bad = [i for i in moved if i not in mutated]
    missing = [i for i in mutated if i not in moved]
    results.append(CheckResult(
        key, "mutation", not bad and not missing,
        (f"{key}: wrote argument(s) {bad}" if bad else
         f"{key}: declared accumulator argument(s) {missing} not written")
        if bad or missing else
        (f"writes only its accumulator argument(s) {list(mutated)}"
         if mutated else "leaves every argument alone")))

    if collectives is not None:
        counts = compiled.collective_counts(key)
        off = {k: (counts.get(k, 0), v) for k, v in collectives.items()
               if counts.get(k, 0) != v}
        results.append(CheckResult(
            key, "collectives", not off,
            (f"{key}: collective counts off contract: "
             + ", ".join(f"{k}={got} (want {want})"
                         for k, (got, want) in sorted(off.items()))
             + f"; full counts {counts}") if off
            else f"placement contract holds: {counts}"))

    if device.type == "cuda" and launches:
        short = [k for k in launches
                 if LAUNCHES.get(k, 0) <= launched.get(k, 0)]
        got = {k: LAUNCHES.get(k, 0) - launched.get(k, 0) for k in launches}
        results.append(CheckResult(
            key, "launches", not short,
            f"{key}: kernel(s) {short} did not launch (plain version?)"
            if short else f"kernel launches {got}"))
    return results


# --------------------------------------------------------------------------
# Canonical program inventory
# --------------------------------------------------------------------------

def _setup():
    """The canonical small inputs: four chain jobs and their horizon."""
    from repro_torch.core import generate_chain_jobs

    jobs = generate_chain_jobs(4, 1, seed=3)
    return jobs, max(j.deadline for j in jobs) + 1.0


def _build_eval_programs(mesh, device) -> list[ProgramSpec]:
    import numpy as np

    from repro_torch.core import benchmark_bid_policies, selfowned_policies
    from repro_torch.engine import backend, cache
    from repro_torch.engine.plan import build_grid_plan
    from repro_torch.engine.scenarios import ScenarioSpec, SynthBatch

    jobs, horizon = _setup()
    # Scenario rows ride "data": size the axis by its shard count so the
    # canonical shapes divide exactly.
    S = 2 * mesh.data_shards
    spec = ScenarioSpec("fresh", horizon, S, seed=1)

    def avail(s):
        return lambda starts, ends: np.full_like(
            np.asarray(starts, np.float64), float(s % 3))

    legs = (
        ("engine.eval.chain:sharded", selfowned_policies()[::13], {}, True,
         None, "policy_cost_chain"),
        ("engine.eval.task:sharded", benchmark_bid_policies(),
         {"windows": "even", "selfowned": "naive"}, False, None,
         "policy_cost"),
        ("engine.eval.chain_ps:sharded", selfowned_policies()[::13], {},
         True, [avail(s) for s in range(S)], "policy_cost_chain"),
        ("engine.eval.task_ps:sharded", benchmark_bid_policies(),
         {"windows": "even", "selfowned": "naive"}, False,
         [avail(s) for s in range(S)], "policy_cost"),
    )
    out = []
    with cache.disabled():
        for key, pols, kw, early, av, kernel in legs:
            gplan = build_grid_plan(jobs, pols, 3, availability=av,
                                    n_scenarios=S, plan_backend="device",
                                    device=device, **kw)
            batch = SynthBatch(spec, 0, S, device, mesh=mesh)
            batch.prepare()
            batch.build_views(gplan.bids)
            local = [backend._block(mesh, gplan.groups_for_bid(b),
                                    mesh.model_rank) for b in gplan.bids]
            arrival = backend._arrival(gplan, device) if early else None
            out.append(ProgramSpec(
                key, backend.eval_sharded,
                (gplan, batch, early, local, mesh, arrival), dict(_ZERO),
                launches=(kernel,)))
    return out


def _build_gather_program(mesh, device) -> list[ProgramSpec]:
    import torch

    from repro_torch.engine import backend

    packed = torch.arange(16, dtype=torch.float32, device=device)
    return [ProgramSpec("engine.gather:sharded", backend.gather_sharded,
                        (mesh, packed), dict(_ONE_GATHER))]


def _build_scenario_programs(mesh, device) -> list[ProgramSpec]:
    import numpy as np
    import torch

    from repro_torch.engine.scenarios import (ScenarioSpec, _device_synth,
                                              _device_views)

    # Synthesis and views shard over "data" only.
    n = mesh.data_shards
    spec = ScenarioSpec("fresh", 8.0, 2 * n, seed=1)
    idx = mesh.slab(spec.n_scenarios)
    i64 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.int64), device=device)
    synth_args = (spec, i64(idx), i64(np.full(len(idx), 2)),
                  i64(np.ones(len(idx))), i64(np.full(len(idx), -1)))
    h, price, spike = _device_synth(*synth_args)
    thresh = torch.as_tensor(spec.thresholds(0.24, idx), device=device)
    return [
        ProgramSpec("scenarios.synth:fresh:sharded", _device_synth,
                    synth_args, dict(_ZERO)),
        ProgramSpec("scenarios.views:sharded", _device_views,
                    (h, price, spike, thresh, False, spec.slot),
                    dict(_ZERO)),
    ]


def _plan_device_full(windows, counts_fn, e, delta, mask, omega, arrival,
                      xs, z, plan_of_akey, b0, avail):
    """Windows through residuals on the device: the reference's fused
    ``plan.device.full`` program."""
    from repro_torch.engine.plan import _device_cells, _device_plans

    sizes, starts, ends = _device_plans(windows, e, delta, mask, omega,
                                        arrival, xs)
    return (starts, ends) + _device_cells(counts_fn, z, delta, mask, sizes,
                                          plan_of_akey, b0, avail)


def _build_plan_program(device) -> list[ProgramSpec]:
    import numpy as np
    import torch

    from repro_torch.core.scheduler import _selfowned_counts_device, job_arrays

    jobs, _ = _setup()
    a = job_arrays(jobs)
    f32 = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.float32), device=device)
    args = ("dealloc", _selfowned_counts_device("prop12"), f32(a.e),
            f32(a.delta), torch.as_tensor(a.mask, device=device),
            f32(a.omega), f32(a.arrival), f32([0.5, 1.0]), f32(a.z),
            torch.as_tensor([0, 1, 1], dtype=torch.int64, device=device),
            f32([np.nan, np.nan, 0.6]),
            torch.tensor(3.0, dtype=torch.float32, device=device))
    return [ProgramSpec("plan.device.full", _plan_device_full, args,
                        dict(_ZERO))]


def _learn_inputs(device, S: int, kinds):
    """A tiny event stream (J = 3 jobs, P = 4 policies) and its staged
    learner inputs."""
    import numpy as np
    import torch

    from repro_torch.learn.learners import as_spec
    from repro_torch.learn.replay import build_events, stage_learners

    J, P = 3, 4
    arrivals = np.array([0.0, 0.5, 1.0])
    ev_kind, ev_j, n_done = build_events(arrivals, 0.8)
    specs = [as_spec(k) for k in kinds]
    etas = np.stack([sp.eta.values(arrivals, 0.8, P) for sp in specs])
    gammas = np.stack([sp.explore.values(arrivals, 0.8, P) for sp in specs])
    rng = np.random.default_rng(5)
    f32 = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.float32), device=device)
    return {"C": f32(rng.random((S, J, P))), "u": f32(rng.random((S, J))),
            "st": stage_learners(specs, etas, gammas, ev_kind, ev_j, n_done,
                                 device),
            "etas": f32(etas), "gammas": f32(gammas),
            "ev_kind": ev_kind, "ev_j": ev_j, "n_done": n_done,
            "J": J, "P": P, "f32": f32}


def _build_learn_programs(mesh, device) -> list[ProgramSpec]:
    import torch

    from repro_torch.learn.replay import (fold_acc_size, fold_chunk,
                                          kernel_launches)

    scan = _learn_inputs(device, 2, ["hedge"])
    # The fold shards chunk rows over "data" and all-reduces over "data".
    S = 2 * mesh.data_shards
    fold = _learn_inputs(device, S, ["hedge"])
    pos = mesh.slab(S)
    f32 = fold["f32"]
    acc = torch.zeros(fold_acc_size(1, fold["J"], fold["P"]) + mesh.pad(S),
                      dtype=torch.float32, device=device)
    valid = torch.as_tensor(mesh.slab_valid(S), device=device)
    fold_args = (mesh, acc, fold["C"][pos], fold["u"][pos],
                 f32([1.0, 2.0, 1.5]), valid, mesh.data_rank * len(pos),
                 fold["st"])
    return [
        ProgramSpec("learn.scan:hedge", kernel_launches,
                    (scan["C"], scan["u"], scan["st"]), dict(_ZERO),
                    launches=("hedge_replay",)),
        ProgramSpec("learn.fold:sharded", fold_chunk, fold_args,
                    dict(_ONE_REDUCE), mutated=(1,),
                    launches=("hedge_replay",)),
    ]


def _cost_inputs(device):
    """A 12-slot market pair (S = 2) and four 2-task rows: the canonical
    cost-kernel shapes (B = 1, S = 2, R = 4, L = 2, 13 slot edges)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    slot = 1.0 / 12.0
    price = rng.uniform(0.1, 1.0, (2, 12))
    avail = price <= 0.5
    A = np.concatenate([np.zeros((2, 1)), np.cumsum(avail * slot, 1)], 1)
    C = np.concatenate([np.zeros((2, 1)),
                        np.cumsum(avail * price * slot, 1)], 1)
    arrival = np.array([0.0, 0.1, 0.2, 0.3])
    ends = arrival[:, None] + np.cumsum(np.full((4, 2), 0.2), 1)
    starts = np.concatenate([arrival[:, None], ends[:, :1]], 1)
    f32 = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.float32), device=device)
    return {"A": f32(A), "C": f32(C), "arrival": f32(arrival),
            "starts": f32(starts), "ends": f32(ends),
            "z": f32(np.full((4, 2), 0.1)), "d": f32(np.ones((4, 2))),
            "pins": f32(np.zeros((4, 2))), "slot": slot}


def _build_kernel_programs(device) -> list[ProgramSpec]:
    import functools

    import numpy as np
    import torch

    from repro_torch.kernels import learner_replay as lk
    from repro_torch.kernels import ops
    from repro_torch.kernels import policy_cost as pc
    from repro_torch.kernels import weight_update as wu

    c = _cost_inputs(device)
    chain = functools.partial(pc.policy_cost_chain, slot=c["slot"],
                              p_od=1.0)
    task = functools.partial(pc.policy_cost, slot=c["slot"], p_od=1.0)
    hedge = _learn_inputs(device, 2, ["hedge"])
    kinds = ["exp3", "ucb1", "egreedy", "ftl"]
    other = _learn_inputs(device, 2, kinds)
    i32 = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.int32), device=device)
    rng = np.random.default_rng(11)
    f32 = lambda *s: torch.as_tensor(  # noqa: E731
        rng.standard_normal(s).astype(np.float32), device=device)
    # flash attention fwd: (B, S, H, dh) = (1, 8, 2, 8), one block.
    q = f32(1, 8, 2, 8)
    # ssd scan: Bb=1, S=8, H=2, P=4, G=1, N=4, one chunk.
    ssd_args = (f32(1, 8, 2, 4), torch.nn.functional.softplus(f32(1, 8, 2)),
                -torch.exp(f32(2)), f32(1, 8, 1, 4), f32(1, 8, 1, 4))
    return [
        ProgramSpec("kernels.policy_cost.chain", chain,
                    (c["A"][None], c["C"][None], c["arrival"][None],
                     c["ends"][None], c["z"][None], c["d"][None],
                     c["pins"][None]), dict(_ZERO),
                    launches=("policy_cost_chain",)),
        ProgramSpec("kernels.policy_cost", task,
                    (c["A"], c["C"], c["starts"].reshape(-1),
                     c["ends"].reshape(-1), c["z"].reshape(-1),
                     c["d"].reshape(-1)), dict(_ZERO),
                    launches=("policy_cost",)),
        ProgramSpec("kernels.hedge_replay", wu.hedge_replay,
                    (hedge["C"], hedge["etas"], hedge["u"],
                     i32(hedge["n_done"])), dict(_ZERO),
                    launches=("hedge_replay",)),
        ProgramSpec("kernels.learner_replay",
                    functools.partial(lk.learner_replay, kinds),
                    (other["C"], other["etas"], other["gammas"], other["u"],
                     i32(other["ev_kind"]), i32(other["ev_j"])),
                    dict(_ZERO), launches=("learner_replay",)),
        ProgramSpec("kernels.flash_attention", ops.flash_attention,
                    (q, f32(1, 8, 2, 8), f32(1, 8, 2, 8)), dict(_ZERO),
                    launches=("flash_attention",)),
        ProgramSpec("kernels.ssd_scan", functools.partial(ops.ssd, chunk=8),
                    ssd_args, dict(_ZERO), launches=("ssd_scan",)),
    ]


def program_inventory(mesh=None, keys: Sequence[str] | None = None,
                      device="cuda"
                      ) -> tuple[list[ProgramSpec], list[CheckResult]]:
    """Build (programs, build_failures) for the canonical inventory on
    ``device`` (the card by default; without one this raises, naming
    ``device="cpu"``).

    ``mesh=None`` takes ``GridMesh.create(1)``: the 1x1 mesh, over the
    process group when one is initialised (a one-rank NCCL group on the
    card, gloo on the CPU) and issuing its collectives to itself without
    one; pass a larger ``GridMesh`` to verify its placement.
    """
    from repro_torch.device import resolve_device
    from repro_torch.engine import GridMesh

    device = resolve_device(device)
    if mesh is None:
        mesh = GridMesh.create(1)
    mesh.check_device(device)
    builders = (
        ("engine.eval.", lambda: _build_eval_programs(mesh, device)),
        ("engine.gather", lambda: _build_gather_program(mesh, device)),
        ("scenarios.", lambda: _build_scenario_programs(mesh, device)),
        ("plan.", lambda: _build_plan_program(device)),
        ("learn.", lambda: _build_learn_programs(mesh, device)),
        ("kernels.", lambda: _build_kernel_programs(device)),
    )
    want = set(PROGRAM_KEYS) if keys is None else set(keys)
    programs: list[ProgramSpec] = []
    failures: list[CheckResult] = []
    for name, build in builders:
        if not any(k.startswith(name) for k in want & set(PROGRAM_KEYS)):
            continue
        try:
            programs.extend(build())
        except Exception as exc:
            failures.append(CheckResult(
                f"inventory:{name}", "build", False,
                f"inventory:{name} {type(exc).__name__}: {exc}"))
    for k in sorted(want - set(PROGRAM_KEYS)):
        failures.append(CheckResult(k, "build", False,
                                    f"{k}: unknown program key"))
    return [p for p in programs if p.key in want], failures


def verify_all(mesh=None, keys: Sequence[str] | None = None,
               device="cuda") -> list[CheckResult]:
    """Verify every inventory program on ``device``; returns all check
    results."""
    import torch

    programs, results = program_inventory(mesh, keys, device)
    for p in programs:
        results.extend(verify_program(
            p.fn, p.args, key=p.key, collectives=p.collectives,
            mutated=p.mutated, device=torch.device(device),
            launches=p.launches))
    return results
