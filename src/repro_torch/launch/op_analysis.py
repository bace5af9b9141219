"""Roofline-grade analysis of one rank's step, op by op: the port's
counterpart of the reference's ``launch/hlo_analysis.py``.

The reference reads its three roofline inputs from the compiled per-device
SPMD program's HLO text. The port runs one rank's step (its slices of the
model, its rows of the batch) under a ``TorchDispatchMode`` and counts the
ops as they run, on meta tensors (the dry-run: shapes, no data, no device)
or on the card. :func:`analyze` returns the reference's keys:

* ``flops`` — products only, the reference's "dots only" convention: every
  op ``torch.utils.flop_counter`` has a formula for (mm, addmm, bmm,
  baddbmm and the products einsum lowers to, convolutions), by that
  formula. Elementwise ops are not counted.
* ``bytes`` — what eager PyTorch moves on the card: each op reads its
  tensor inputs and writes its outputs once (an operand written in place,
  or through ``out=``, counted once, as written). Views, reshapes and
  metadata ops (``empty``, ``detach``, ``alias``, and any op whose
  results all alias its inputs) move nothing. The
  reference's convention is the TPU's, where XLA fuses elementwise chains
  into their neighbours and only fusions touch HBM; an eager step runs
  every op as its own kernel, so that convention does not apply here.
* ``collectives`` — per kind plus ``"total"``, the operand bytes of each
  collective the rank's mesh helpers issue (``engine/mesh.py``: an
  all-reduce's or a permute's tensor, an all-gather's own part). The
  helpers' staging does not count as bytes.
* ``warnings`` — what the count may miss.

A kernel call (the flash and SSD kernels, forward and backward, marked by
``obs.compiled.kernel_call`` in ``kernels/``) counts once, by its own work
function (``flash_work``, ``flash_backward_work``; ``ssd_ops`` once per
product forward, twice backward, as ``ssd_work`` and
``ssd_backward_work`` count them before their three-way tensor-core
split), and the ops inside it count nothing: off the card the wrappers
take their plain versions, whose ops are not the kernel's, so a meta trace
and a card trace of the same step count the same. On meta tensors a call
returns empty outputs of its shapes without running its plain version.

It also returns ``peak_bytes``: the most bytes of storages that the step
itself allocated and held at once (a storage counted from the op that
creates it until it is freed; a kernel call's own temporaries are left
out, its outputs counted as it returns), the reference's
``memory_analysis`` temp; the storages alive before the step (parameters,
optimizer state, batch) are the caller's to add. ``kernels`` holds per
kernel its calls, their FLOPs and bytes and each call's input shapes, and
``result`` is what the step returned.

torch carries the dispatch mode stack to autograd's device thread with the
rest of its thread-local state, so a backward that runs there is counted
too, and the mesh helpers and kernel wrappers find the analysis on that
stack on any thread.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.obs.compiled import COLLECTIVE_KINDS

__all__ = ["analyze"]

_aten = torch.ops.aten
# Ops that allocate or relabel without moving data.
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten.detach,
         _aten.lift_fresh, _aten._unsafe_view, _aten.alias,
         _aten._reshape_alias, _aten.set_, _aten.resize_}
# Products that reach the mode whole where autograd does not decompose
# them first (under inference mode): counted as the ops they lower to.
_COMPOSITE_PRODUCTS = {_aten.einsum, _aten.matmul, _aten.linear,
                       _aten.tensordot, _aten.bilinear, _aten.conv1d,
                       _aten.conv2d, _aten.conv3d, _aten.outer, _aten.inner,
                       _aten.chain_matmul, _aten.kron}
_INFO: dict = {}


def _info(func):
    """Per op, once: (decomposes, free, written positional indices,
    written keyword names, FLOP formula or None)."""
    got = _INFO.get(func)
    if got is None:
        packet = func.overloadpacket
        args = func._schema.arguments
        write = lambda a: a.alias_info is not None \
            and a.alias_info.is_write  # noqa: E731
        got = _INFO[func] = (
            packet in _COMPOSITE_PRODUCTS, func.is_view or packet in _FREE,
            tuple(i for i, a in enumerate(args)
                  if not a.kwarg_only and write(a)),
            tuple(a.name for a in args if a.kwarg_only and write(a)),
            flop_registry.get(packet))
    return got


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or results (one level of lists)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if not isinstance(tree, (list, tuple, type({}.values()))):
        return []                   # a scalar result
    out = []
    for a in tree:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):   # no storage (sparse)
        return None


class _Call:
    """One kernel call (or a collective's staging) under the analysis."""

    def __init__(self, mode, name, work, tensors):
        self.mode, self.name, self.work = mode, name, work
        self.tensors = tensors
        self.shapes_only = mode.depth == 0 and name is not None and any(
            t.is_meta for t in tensors)

    def __enter__(self):
        m = self.mode
        if m.depth == 0 and self.name is not None:
            w = self.work()
            m.flops += int(w["flops"])
            m.bytes += int(w["bytes"])
            k = m.kernels.setdefault(self.name, {"calls": 0, "flops": 0,
                                                 "bytes": 0, "shapes": []})
            k["calls"] += 1
            k["flops"] += int(w["flops"])
            k["bytes"] += int(w["bytes"])
            k["shapes"].append(tuple(tuple(t.shape) for t in self.tensors))
        m.depth += 1
        return self

    def __exit__(self, *exc):
        m = self.mode
        m.depth -= 1
        if m.depth == 0:       # what the call allocated and still holds
            held, m.inside = m.inside, []
            for ref, n in held:
                st = ref()
                if st is not None:
                    m.hold(st, n)
        return False


class _Analysis(TorchDispatchMode):
    """The counting mode (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.kernels: dict[str, dict] = {}
        self.warnings: set[str] = set()
        self.depth = 0              # inside a kernel call or a collective
        self.inside: list = []      # (storage ref, bytes) allocated there
        self.live = self.peak = 0
        self.held: dict[int, weakref.finalize] = {}

    # -- the hooks of obs.compiled --------------------------------------------

    def note_collective(self, kind: str, nbytes: int) -> None:
        if self.depth:
            self.warnings.add(f"a {kind} inside a kernel call")
        self.collectives[kind] += nbytes

    def kernel_call(self, name, work, tensors) -> _Call:
        return _Call(self, name, work, tensors)

    # -- storages ------------------------------------------------------------

    def hold(self, st, n: int) -> None:
        key = id(st)
        if key in self.held:
            return
        self.held[key] = weakref.finalize(st, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int) -> None:
        self.held.pop(key, None)
        self.live -= n

    def _new_storages(self, seen: set, outs) -> None:
        seen = set(seen)
        for t in outs:
            st = _storage(t)
            if st is None or id(st) in seen:
                continue
            seen.add(id(st))
            if self.depth:
                self.inside.append((weakref.ref(st), st.nbytes()))
            else:
                self.hold(st, st.nbytes())

    # -- the ops -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        decomposes, free, w_pos, w_kw, flops = _info(func)
        if decomposes:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out)
        in_st = {id(s) for s in map(_storage, ins) if s is not None}
        self._new_storages(in_st, outs)
        if self.depth:
            return out
        if flops is not None:
            self.flops += int(flops(*args, **kwargs, out_val=out))
        written = [args[i] for i in w_pos if i < len(args)
                   and isinstance(args[i], torch.Tensor)]
        written += [kwargs[k] for k in w_kw
                    if isinstance(kwargs.get(k), torch.Tensor)]
        if free or (not written and all(
                id(_storage(t)) in in_st for t in outs)):
            return out          # a view, or an op that returns its inputs
        w_ids = {id(t) for t in written}
        self.bytes += sum(_nbytes(t) for t in ins if id(t) not in w_ids) \
            + sum(_nbytes(t) for t in {id(t): t
                                       for t in written + outs}.values())
        return out

    def close(self) -> None:
        """Stop following the storages still alive."""
        for f in list(self.held.values()):
            f.detach()
        self.held.clear()


def analyze(step, *args, **kwargs) -> dict:
    """Run ``step(*args, **kwargs)`` (one rank's step) under the analysis
    -> ``{"flops", "bytes", "collectives" (per kind plus "total"),
    "warnings", "peak_bytes", "kernels", "result"}`` (module docstring).
    The counts are the rank's own: per device, as the reference's."""
    mode = _Analysis()
    try:
        with mode:
            result = step(*args, **kwargs)
    finally:
        mode.close()
    coll = dict(mode.collectives)
    coll["total"] = sum(coll.values())
    return {"flops": mode.flops, "bytes": mode.bytes, "collectives": coll,
            "warnings": sorted(mode.warnings), "peak_bytes": mode.peak,
            "kernels": mode.kernels, "result": result}
