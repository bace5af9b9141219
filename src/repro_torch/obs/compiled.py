"""Kernel-launch capture: per-kernel CUDA-event device time, launch counts
and the work each launch does — the port's counterpart of
``repro.obs.compiled``, whose compiled XLA programs become the port's six
hand-written kernels.

The kernel wrappers announce every launch on the card with
``with record_launch(key, stream, work): <launch>``. Outside a
:func:`capture` context that hook is one ContextVar read (it returns a
shared no-op context). Inside one it records, on the launching stream, a
CUDA event before and after the launch, adds one to each key's
``launches`` and adds the launch's work to the key: the bytes it must move
(each input read once, each output written once) and its operations by
type (``"f32"``, ``"tf32"``, ``"bf16"``: the rate class of the table
``PEAK_OPS_PER_S``). ``work`` is a callable, evaluated only under a
capture; a count that depends on the data stays a device tensor until the
snapshot, so a capture adds no host synchronisation to the launches.
Events are resolved only in :meth:`CompiledRegistry.snapshot`, where each
key's device milliseconds become the sum of its event pairs.

Keys are the names ``kernels.LAUNCHES`` counts under:
``policy_cost_chain`` (and ``policy_cost_chain_smem`` for the shared-memory
route among them), ``policy_cost``, ``hedge_replay``, ``learner_replay``,
``flash_attention`` (and ``flash_attention_tc``) and ``ssd_scan`` (one
event pair around its four passes). A CPU tensor takes a plain version and
records nothing, as ``LAUNCHES`` counts nothing.

:func:`factory_caches` snapshots the hit, miss and eviction counts of every
bounded cache of the port (the cross-call plan and view caches and every
``functools.lru_cache``), and :class:`CompileWatch` counts the ``nvcc``
builds ``device.build_kernels`` starts: a warm path builds nothing.

:func:`collective_counts` is the port's form of the reference's standing
placement metric. The reference counts collective ops in a compiled
program's HLO text; the port issues every collective through the three
helpers of ``engine/mesh.py``, each of which records its kind and its
operand bytes under the program key that is running (:func:`program`).
So ``collective_counts("learn.fold:sharded")`` is the count of
collectives the sharded fold issued, :func:`collective_bytes` their
operand bytes, and :func:`program_runs` how often it ran.
:func:`placement_violations` is the standing form of that contract: the
failed checks of the program verifier (``repro_torch.analysis``).

The per-rank step analysis (``launch/op_analysis.py``) is a dispatch mode
on torch's mode stack, which torch carries to autograd's device thread
with the rest of its thread-local state. :func:`note_collective` hands it
each collective's bytes, and the kernel wrappers mark each kernel call
with :func:`kernel_call`, so the analysis counts a call by its work
function and never the ops of a plain version inside it. Without an
analysis on the stack both are one read of that stack.
"""
from __future__ import annotations

import contextlib
from contextlib import contextmanager
from contextvars import ContextVar

__all__ = [
    "CompiledRegistry",
    "CompileWatch",
    "HBM_BYTES_PER_S",
    "PEAK_OPS_PER_S",
    "capture",
    "capturing",
    "collective",
    "collective_bytes",
    "collective_counts",
    "current_registry",
    "factory_caches",
    "kernel_call",
    "note_collective",
    "placement_violations",
    "program",
    "program_runs",
    "record_launch",
    "reset_collectives",
    "work_bound",
]

_CAPTURE: ContextVar["CompiledRegistry | None"] = ContextVar(
    "repro_torch_obs_compiled", default=None)

# Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit): HBM
# bytes per second and operations per second by rate class.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}


def work_bound(work: dict) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for a work record ``{"bytes": n, "ops": {class: n}}`` — the larger of
    its bytes at the memory rate and its operations at their classes'
    peaks, one class after the other."""
    t_bytes = _number(work["bytes"]) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(_number(n) / PEAK_OPS_PER_S[k]
                for k, n in work["ops"].items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _number(v) -> float:
    """A work count as a float (a device tensor is read here, at the
    snapshot, never at the launch)."""
    item = getattr(v, "item", None)
    return float(item() if item is not None else v)


class _Launch:
    """The event pair of one captured launch."""

    __slots__ = ("_reg", "_keys", "_stream", "_work", "_start", "_end")

    def __init__(self, reg, keys, stream, work):
        self._reg, self._keys, self._stream, self._work = \
            reg, keys, stream, work

    def __enter__(self):
        import torch

        if self._stream is None:
            raise ValueError(f"record_launch({self._keys}): a captured "
                             "launch needs the CUDA stream it launches on")
        self._work = self._work() if self._work is not None else None
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._start.record(self._stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._end.record(self._stream)
            self._reg.record(self._keys, self._start, self._end, self._work)
        return False


class CompiledRegistry:
    """key -> launches, device ms, bytes and operations of every kernel
    launch announced under a capture."""

    def __init__(self):
        self.entries: dict[str, dict] = {}
        self._events: dict[str, list] = {}
        self._pending: dict[str, list] = {}

    def launch(self, keys, stream, work=None) -> _Launch:
        return _Launch(self, (keys,) if isinstance(keys, str) else
                       tuple(keys), stream, work)

    def record(self, keys, start, end, work=None) -> None:
        """Count one launch under each of ``keys`` with its event pair and
        its work. The work is best-effort (a malformed record is kept as
        the entry's ``error``); the launch and its events always count."""
        for key in keys:
            entry = self.entries.setdefault(
                key, {"launches": 0, "device_ms": 0.0, "bytes": 0.0,
                      "ops": {}})
            entry["launches"] += 1
            self._events.setdefault(key, []).append((start, end))
            if work is None:
                continue
            try:
                entry["bytes"] += float(work["bytes"])
                for kind, n in work["ops"].items():
                    entry["ops"].setdefault(kind, 0.0)
                    self._pending.setdefault(key, []).append((kind, n))
            except Exception as exc:  # keep capture best-effort on work
                entry["error"] = f"{type(exc).__name__}: {exc}"

    def _resolve(self) -> None:
        """Fold the outstanding event pairs and device-side counts into the
        entries (each event pair waited for once)."""
        for key, pairs in self._events.items():
            entry = self.entries[key]
            for start, end in pairs:
                end.synchronize()
                entry["device_ms"] += start.elapsed_time(end)
            pairs.clear()
        for key, counts in self._pending.items():
            ops = self.entries[key]["ops"]
            for kind, n in counts:
                ops[kind] += _number(n)
            counts.clear()

    def __getitem__(self, key):
        self._resolve()
        return self.entries[key]

    def __contains__(self, key):
        return key in self.entries

    def snapshot(self):
        """{"kernels": {key: {launches, device_ms, bytes, ops, bound_ms,
        bound_by}}, "factory_caches": ...}; waits for the captured
        launches to finish."""
        self._resolve()
        kernels = {}
        for key, e in sorted(self.entries.items()):
            kernels[key] = dict(e, ops=dict(e["ops"]))
            if "error" not in e:
                kernels[key]["bound_ms"], kernels[key]["bound_by"] = \
                    work_bound(e)
        return {"kernels": kernels, "factory_caches": factory_caches()}

    def table(self):
        """Human-readable kernel x {launches, device ms, bound ms} table."""
        snap = self.snapshot()["kernels"]
        rows = [f"{'kernel':<26} {'launches':>9} {'device ms':>12} "
                f"{'bound ms':>12}"]
        for key, e in snap.items():
            if "error" in e:
                rows.append(f"{key:<26} {e['launches']:>9} "
                            f"{e['device_ms']:>12.4f} <{e['error']}>")
                continue
            rows.append(f"{key:<26} {e['launches']:>9} "
                        f"{e['device_ms']:>12.4f} {e['bound_ms']:>12.4f} "
                        f"({e['bound_by']})")
        return "\n".join(rows)


_NO_CAPTURE = contextlib.nullcontext()


def record_launch(key, stream, work=None):
    """Context manager around one kernel launch on ``stream``; a shared
    no-op unless capturing. ``key`` is a wrapper name or a tuple of them;
    ``work`` a callable returning ``{"bytes": n, "ops": {class: n}}``."""
    reg = _CAPTURE.get()
    if reg is None:
        return _NO_CAPTURE
    return reg.launch(key, stream, work)


@contextmanager
def capture(registry=None):
    """Enable kernel-launch capture for the block; yields the registry."""
    reg = registry if registry is not None else CompiledRegistry()
    token = _CAPTURE.set(reg)
    try:
        yield reg
    finally:
        _CAPTURE.reset(token)


def current_registry():
    return _CAPTURE.get()


def capturing():
    return _CAPTURE.get() is not None


# Every bounded cache of the port, snapshotted for its hit, miss and
# eviction counts: the cross-call plan and view caches and every
# functools.lru_cache. Imported lazily: obs stays import-light.
_FACTORIES = (
    ("engine.plan_cache", "repro_torch.engine.cache", "PLAN_CACHE"),
    ("engine.view_cache", "repro_torch.engine.cache", "VIEW_CACHE"),
    ("scenarios.avail_threshold", "repro_torch.engine.scenarios",
     "_avail_threshold"),
    ("scenarios.padded_traces", "repro_torch.engine.scenarios",
     "_padded_spec_traces"),
    ("market.truncated_exp_rate", "repro_torch.core.market",
     "truncated_exp_rate"),
    ("device.kernel_library", "repro_torch.device", "kernel_library"),
    ("policy_cost.inverse_slot", "repro_torch.kernels.policy_cost",
     "inverse_slot"),
    ("policy_cost.entry", "repro_torch.kernels.policy_cost", "_entry"),
    ("policy_cost.task_layout", "repro_torch.kernels.policy_cost",
     "task_layout"),
    ("policy_cost.sms", "repro_torch.kernels.policy_cost", "_sms"),
    ("flash_attention.tc_arrays", "repro_torch.kernels.flash_attention",
     "_tc_arrays"),
    ("flash_attention.entry", "repro_torch.kernels.flash_attention",
     "_entry"),
    ("ssd_scan.entry", "repro_torch.kernels.ssd_scan", "_entry"),
    ("ssd_scan.plan_args", "repro_torch.kernels.ssd_scan", "_plan_args"),
    ("learner_replay.device_codes", "repro_torch.kernels.learner_replay",
     "_device_codes"),
)


def factory_caches():
    """{name: {hits, misses, maxsize, currsize, evictions}} per cache.

    Every registered cache duck-types ``functools.lru_cache``'s
    ``cache_info()``. Evictions are exact where the cache keeps a counter
    (the cross-call ``_LRU`` caches); for a plain ``lru_cache`` they are
    the ``misses - currsize`` lower bound (every miss inserts, so anything
    not resident was evicted — exact as long as the cache was never
    cleared mid-run).
    """
    import importlib
    import sys

    out = {}
    for name, mod_name, attr in _FACTORIES:
        mod = sys.modules.get(mod_name)
        if mod is None:
            try:
                mod = importlib.import_module(mod_name)
            except Exception:
                continue
        fn = getattr(mod, attr, None)
        info = getattr(fn, "cache_info", None)
        if info is None:
            continue
        ci = info()
        out[name] = {
            "hits": ci.hits,
            "misses": ci.misses,
            "maxsize": ci.maxsize,
            "currsize": ci.currsize,
            "evictions": getattr(fn, "evictions",
                                 max(ci.misses - ci.currsize, 0)),
        }
    return out


class CompileWatch:
    """Count the ``nvcc`` builds ``device.build_kernels`` starts over a
    scope — the ground truth for "the warm path built nothing"::

        watch = CompileWatch()
        with watch:
            run_warm_path()
        assert watch.compiles == 0

    Every kernel library of the port is built by ``build_kernels``, which
    reports each ``nvcc`` it starts through :meth:`note_build`; watches
    count against a baseline, so they nest.
    """

    _count = 0

    @classmethod
    def note_build(cls) -> None:
        cls._count += 1

    def __init__(self):
        self.supported = True
        self._base = 0
        self.compiles = 0

    def __enter__(self):
        self._base = type(self)._count
        return self

    def __exit__(self, *exc):
        self.compiles = type(self)._count - self._base
        return False


# --------------------------------------------------------------------------
# Collectives per program key
# --------------------------------------------------------------------------

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")
_PROGRAM: ContextVar["str | None"] = ContextVar(
    "repro_torch_obs_program", default=None)
_COLLECTIVES: dict[str, dict[str, int]] = {}
_BYTES: dict[str, dict[str, int]] = {}
_RUNS: dict[str, int] = {}
# The process's open program blocks, innermost last: what a thread that a
# block sets working without a context of its own (autograd's device
# thread, which runs a backward on the card and the forwards it
# rematerialises) records under.
_OPEN: list[str] = []


@contextmanager
def program(key: str):
    """Mark the block as one run of the program ``key``: collectives
    issued inside it are recorded under ``key``."""
    _RUNS[key] = _RUNS.get(key, 0) + 1
    _COLLECTIVES.setdefault(key, dict.fromkeys(COLLECTIVE_KINDS, 0))
    _BYTES.setdefault(key, dict.fromkeys(COLLECTIVE_KINDS, 0))
    token = _PROGRAM.set(key)
    _OPEN.append(key)
    try:
        yield
    finally:
        _OPEN.pop()
        _PROGRAM.reset(token)


def _analyses() -> list:
    """The op analyses on this thread's dispatch mode stack (the modes
    that take notes), innermost last."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return [m for m in _get_current_dispatch_mode_stack()
            if hasattr(m, "note_collective")]


def note_collective(kind: str, nbytes: int = 0) -> None:
    """Record one collective of ``kind`` moving ``nbytes`` operand bytes
    under the running program (the mesh helpers call this once per
    collective they issue): the block's own, or on a thread with no
    context of its own the process's innermost open one. An op analysis
    on the mode stack gets the bytes too."""
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    key = _PROGRAM.get() or (_OPEN[-1] if _OPEN else None)
    if key is None:
        raise RuntimeError(
            f"a {kind} was issued outside any program(key) block: every "
            f"collective belongs to a program key")
    _COLLECTIVES[key][kind] += 1
    _BYTES[key][kind] += int(nbytes)
    for mode in _analyses():
        mode.note_collective(kind, int(nbytes))


def collective(kind: str, nbytes: int):
    """Context manager around one collective of a mesh helper: records it
    (:func:`note_collective`) and, under an op analysis, keeps the
    helper's own staging (host copies, the output's assembly) out of the
    analysis's bytes, as a kernel call keeps its plain version's ops."""
    note_collective(kind, nbytes)
    found = _analyses()
    if not found:
        return _NO_CALL
    return found[-1].kernel_call(None, None, ())


def collective_counts(key: str) -> dict:
    """Per-kind collective counts (plus ``"total"``) that the program
    ``key`` issued since the last :func:`reset_collectives`; zeros for a
    key that never ran or never issued one."""
    out = dict(_COLLECTIVES.get(key, dict.fromkeys(COLLECTIVE_KINDS, 0)))
    out["total"] = sum(out.values())
    return out


def collective_bytes(key: str) -> dict:
    """Per-kind operand bytes (plus ``"total"``) of the collectives the
    program ``key`` issued since the last :func:`reset_collectives`: an
    all-reduce's or a permute's tensor, an all-gather's own part."""
    out = dict(_BYTES.get(key, dict.fromkeys(COLLECTIVE_KINDS, 0)))
    out["total"] = sum(out.values())
    return out


def program_runs(key: str) -> int:
    """How often the program ``key`` ran since the last reset."""
    return _RUNS.get(key, 0)


def reset_collectives() -> None:
    _COLLECTIVES.clear()
    _BYTES.clear()
    _RUNS.clear()


class _NoCall:
    """A kernel call that no analysis watches: its body runs as it is."""

    shapes_only = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_CALL = _NoCall()


def kernel_call(name: str, work, *tensors):
    """Context manager around one call of the kernel ``name`` (its launch,
    or its plain version off the card) whose work is ``work()``: ``{"flops":
    n, "bytes": n}``, the products' operations and the bytes the call must
    move. ``tensors`` are the call's inputs. Under an op analysis the call
    counts once by ``work`` and the ops inside it count nothing; the
    context's ``shapes_only`` then tells a call on meta tensors that its
    outputs' shapes will do (empty tensors), so a meta trace does not run a
    plain version that the analysis would not count. Outside one, a shared
    no-op."""
    found = _analyses()
    if not found:
        return _NO_CALL
    return found[-1].kernel_call(name, work, tensors)


def placement_violations(mesh=None, keys=None, device="cuda"):
    """Failed §9-placement (and related) checks over the canonical programs.

    Delegates to the Layer-2 verifier, :func:`repro_torch.analysis.programs.
    verify_all` — the single implementation of the placement contract —
    and returns only the failed ``CheckResult``s (an empty list: the
    contract holds). It runs every program on ``device`` (the card by
    default) over ``mesh`` (the 1x1 mesh when None).
    """
    from repro_torch.analysis.programs import verify_all

    return [c for c in verify_all(mesh=mesh, keys=keys, device=device)
            if not c.ok]
