"""Context-var span tracer (stdlib only), the port's copy of
``repro.obs.trace``.

* ``span(name, **attrs)`` is the single timing primitive of the port: the
  only clock it reads is here. It always measures wall seconds: after the
  ``with`` block ``sp.seconds`` holds the duration, and that exact float is
  what the engine folds into ``EngineResult.timings``. This is why the
  timings dict is bit for bit the span-derived totals: there is only one
  measurement.
* With no tracer installed the cost is one ContextVar read plus two
  ``perf_counter_ns`` calls.
* While a :func:`trace` context is active, finished spans are appended to
  the tracer as flat :class:`SpanRecord` rows (id/parent/name/ts/seconds/
  tid/attrs). Nesting is tracked through a second ContextVar, so the
  records form a tree; generators iterated inside a span parent their
  spans correctly (plain generators run in the caller's context).

Exporters: :meth:`Tracer.to_chrome` emits the Chrome trace-event JSON
dialect (``ph: "X"`` complete events with ts/dur in microseconds), which
https://ui.perfetto.dev loads directly; :meth:`Tracer.to_jsonl` emits one
self-contained JSON object per line.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar

__all__ = [
    "Span",
    "SpanRecord",
    "Tracer",
    "current_tracer",
    "span",
    "trace",
    "tracing_enabled",
]

_TRACER: ContextVar["Tracer | None"] = ContextVar("repro_torch_obs_tracer", default=None)
_ACTIVE: ContextVar["Span | None"] = ContextVar("repro_torch_obs_active_span", default=None)


@dataclasses.dataclass
class SpanRecord:
    """One finished span, flattened for export."""

    id: int
    parent: int | None
    name: str
    ts: float  # seconds since tracer start
    seconds: float
    tid: int
    attrs: dict


class Span:
    """A timed region.  Usable with or without an active tracer."""

    __slots__ = ("name", "attrs", "seconds", "id", "_t0", "_tracer", "_token", "_parent_id")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.seconds = 0.0
        self.id = -1

    def set(self, **attrs):
        """Attach/overwrite attributes after the span was opened."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tracer = _TRACER.get()
        self._tracer = tracer
        if tracer is not None:
            self.id = tracer._next_id()
            parent = _ACTIVE.get()
            self._parent_id = parent.id if parent is not None else None
            self._token = _ACTIVE.set(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self._t0) * 1e-9
        tracer = self._tracer
        if tracer is not None:
            _ACTIVE.reset(self._token)
            tracer._record(self, self._t0)
        return False


def span(name, **attrs):
    """Open a timed (and, under :func:`trace`, recorded) region::

        with span("eval", backend="jax", chunk=k) as sp:
            ...
        timings["eval"] += sp.seconds
    """
    return Span(name, attrs)


class Tracer:
    """Collects finished spans; thread-safe append, flat storage."""

    def __init__(self):
        self.spans: list[SpanRecord] = []
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._t0 = time.perf_counter_ns()

    def _next_id(self):
        return next(self._ids)

    def _record(self, sp: Span, t0_ns: int):
        rec = SpanRecord(
            id=sp.id,
            parent=sp._parent_id,
            name=sp.name,
            ts=(t0_ns - self._t0) * 1e-9,
            seconds=sp.seconds,
            tid=threading.get_ident(),
            attrs=dict(sp.attrs),
        )
        with self._lock:
            self.spans.append(rec)

    # -- queries ----------------------------------------------------------
    def __len__(self):
        return len(self.spans)

    def named(self, name):
        """Records with this span name, in completion order."""
        return [r for r in self.spans if r.name == name]

    def totals(self):
        """name -> summed seconds, accumulated in completion order.

        Spans finish in the same order the engine folds them into
        ``EngineResult.timings``, so for a given name this is the same
        left-to-right float sum — bit-for-bit equal on the numpy path.
        """
        out: dict[str, float] = {}
        for r in self.spans:
            out[r.name] = out.get(r.name, 0.0) + r.seconds
        return out

    def children(self, span_id):
        return [r for r in self.spans if r.parent == span_id]

    def roots(self):
        return [r for r in self.spans if r.parent is None]

    # -- exporters --------------------------------------------------------
    def to_chrome(self):
        """Chrome trace-event JSON (dict) — load at ui.perfetto.dev."""
        tids = {}
        events = []
        for r in self.spans:
            tid = tids.setdefault(r.tid, len(tids))
            args = {k: _json_safe(v) for k, v in r.attrs.items()}
            args["span_id"] = r.id
            if r.parent is not None:
                args["parent_id"] = r.parent
            events.append(
                {
                    "name": r.name,
                    "cat": "repro_torch",
                    "ph": "X",
                    "ts": r.ts * 1e6,
                    "dur": r.seconds * 1e6,
                    "pid": self.pid,
                    "tid": tid,
                    "args": args,
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_jsonl(self):
        """One JSON object per line: id/parent/name/ts/dur/tid/attrs."""
        lines = []
        for r in self.spans:
            lines.append(
                json.dumps(
                    {
                        "id": r.id,
                        "parent": r.parent,
                        "name": r.name,
                        "ts": r.ts,
                        "dur": r.seconds,
                        "pid": self.pid,
                        "tid": r.tid,
                        "attrs": {k: _json_safe(v) for k, v in r.attrs.items()},
                    },
                    sort_keys=True,
                )
            )
        return "\n".join(lines) + ("\n" if lines else "")

    def save(self, path):
        """Write the Chrome/Perfetto trace JSON to ``path``."""
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)
        return path

    def save_jsonl(self, path):
        with open(path, "w") as fh:
            fh.write(self.to_jsonl())
        return path


def _json_safe(v):
    """Coerce span attributes to JSON-native types: numpy scalars and 0-d
    torch tensors (both have ``item()``) become Python numbers."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    item = getattr(v, "item", None)
    if item is not None:
        try:
            return _json_safe(item())
        except Exception:
            pass
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return str(v)


@contextmanager
def trace(tracer=None):
    """Install ``tracer`` (or a fresh :class:`Tracer`) for the block."""
    tr = tracer if tracer is not None else Tracer()
    token = _TRACER.set(tr)
    try:
        yield tr
    finally:
        _TRACER.reset(token)


def current_tracer():
    return _TRACER.get()


def tracing_enabled():
    return _TRACER.get() is not None
