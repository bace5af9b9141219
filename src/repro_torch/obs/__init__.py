"""repro_torch.obs — the port's observability layer, the counterpart of
``repro.obs`` (which the port does not import).

Three cooperating layers, none of which imports the engine, so every
module of the port can import them:

* :mod:`repro_torch.obs.trace` — a context-var span tracer. ``span("eval",
  chunk=k)`` always measures wall seconds (``sp.seconds`` after exit, the
  single timing source ``EngineResult.timings`` is derived from, and the
  only clock of the port); full span records (nesting, attributes,
  timestamps) are captured only while a ``trace()`` context is active, and
  export to Chrome-trace/Perfetto JSON or a flat JSONL event log.
* :mod:`repro_torch.obs.compiled` — kernel-launch capture. The kernel
  wrappers announce every launch on the card through
  ``record_launch(key, stream, work)``; inside a ``capture()`` context each
  launch gets a CUDA event pair on its stream, a launch count and its work
  (bytes, operations by type), resolved in the snapshot. Outside one the
  hook is a single context-var read.
* :mod:`repro_torch.obs.metrics` — a counter/gauge/histogram registry with
  labeled series (chunk latency, scenarios/sec, adaptive-adversary
  escalations, learner weight entropy, the cache counters), snapshotted
  into ``EngineResult.obs`` / ``StreamLearnResult.obs``.

``observe()`` composes all three; ``maybe_snapshot()`` is what the engine
attaches to its results.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

from . import compiled, metrics, trace
from .compiled import CompiledRegistry, capture, record_launch
from .metrics import METRICS, MetricsRegistry
from .trace import Span, Tracer, current_tracer, span, trace as tracing, tracing_enabled

__all__ = [
    "CompiledRegistry",
    "METRICS",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "capture",
    "compiled",
    "current_tracer",
    "maybe_snapshot",
    "metrics",
    "observe",
    "record_launch",
    "span",
    "trace",
    "tracing",
    "tracing_enabled",
]


@contextlib.contextmanager
def observe(*, spans=True, counters=True, programs=False, tracer=None):
    """Enable span tracing, metrics collection and (optionally) kernel-
    launch capture for the dynamic extent of the block.

    Yields a namespace with ``tracer`` (:class:`Tracer` or None),
    ``metrics`` (the global :data:`METRICS` registry) and ``compiled``
    (:class:`CompiledRegistry` or None).
    """
    with contextlib.ExitStack() as stack:
        tr = stack.enter_context(trace.trace(tracer)) if spans else None
        if counters:
            stack.enter_context(METRICS.collecting())
        reg = stack.enter_context(compiled.capture()) if programs else None
        yield SimpleNamespace(tracer=tr, metrics=METRICS, compiled=reg)


def maybe_snapshot():
    """Snapshot of whatever observability collection is active.

    Returns ``{"metrics": ..., "compiled": ...}`` with only the active
    layers present, or ``None`` when nothing is collecting — what
    ``evaluate_grid`` / ``replay_stream`` attach to their results. A
    capture's snapshot waits for its launches to finish.
    """
    out = {}
    if METRICS.enabled:
        out["metrics"] = METRICS.snapshot()
    reg = compiled.current_registry()
    if reg is not None:
        out["compiled"] = reg.snapshot()
    return out or None
