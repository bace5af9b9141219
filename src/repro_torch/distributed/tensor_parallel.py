"""Tensor parallelism over a mesh's ``"model"`` dim: what the reference's
GSPMD makes of its rule table (``DEFAULT_RULES``: ``heads``, ``kv_heads``,
``d_ff``, ``vocab`` and ``experts`` over ``"model"``) in the meshed train,
prefill and decode steps, written out.

The residual stream is whole on every ``"model"`` rank. Each split product
is a region: its input enters through :func:`copy_to_model` (identity
forward, all-reduce of the gradient), the rank computes with its slice of
the weights, and its output leaves through :func:`reduce_from_model`
(all-reduce forward, identity backward); the two are the conjugate pair of
Megatron-LM's column and row split. A reduction over a split dim whose
result feeds split work again (a norm over Mamba's inner dim) goes through
both. :func:`max_over_model` is the cross entropy's max (no gradient), and
:func:`gather_from_model` concatenates a split dim (its backward keeps the
rank's slice). Each issues its collective through ``engine.mesh``'s
counted helpers; off a mesh, or on a ``"model"`` one rank wide, each is
the identity and issues none.

:func:`plan` is the slicing rule of every family, in one place: per
module, whether and how it splits (a :class:`Split` on the module's ``tp``
attribute while :func:`applied` is active), and per parameter the slice a
rank computes with (runs of indices along each dim) and how its gradient
combines over ``"model"``:

* ``disjoint``: each rank's slice is its own (heads, columns, experts,
  vocab rows);
* ``partial``: the ranks' slices overlap and each holds a partial sum of
  the gradient there (kv heads that several ranks' q heads share when
  ``kv_heads`` does not divide, Mamba's B and C columns);
* ``identical``: the parameter is used whole outside every split region,
  so every rank computes the same gradient, to be counted once.

A module splits where the fitted specs of its weights split over
``"model"``; where ``_fit_spec`` dropped the axis (it does not divide),
the product stays whole on every rank, as the reference's GSPMD leaves it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.engine.mesh import all_gather, all_reduce, dim_rank, dim_size

__all__ = [
    "Split", "Plan", "plan", "applied", "copy_to_model", "reduce_from_model",
    "max_over_model", "gather_from_model", "sum_over_model", "split_of",
]


# --------------------------------------------------------------------------
# the autograd collectives
# --------------------------------------------------------------------------

def _wide(mesh) -> bool:
    return mesh is not None and dim_size(mesh, "model") > 1


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the incoming gradient may be shared with another branch: a copy
        return all_reduce(ctx.mesh, g.clone(memory_format=torch.contiguous_format),
                          "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(mesh, x.clone(memory_format=torch.contiguous_format),
                          "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MaxOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        out = all_reduce(mesh, x.clone(memory_format=torch.contiguous_format),
                         "model", op="max")
        ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]
        parts = all_gather(mesh, x, "model")
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        at = dim_rank(ctx.mesh, "model") * ctx.width
        return g.narrow(ctx.dim, at, ctx.width), None, None


def copy_to_model(x, mesh):
    """``x`` into a split region: identity forward, the gradient summed
    over ``"model"`` (one all-reduce) backward."""
    return _CopyToModel.apply(x, mesh) if _wide(mesh) else x


def reduce_from_model(x, mesh):
    """The ranks' partial ``x`` summed over ``"model"`` (one all-reduce)
    forward; identity backward."""
    return _ReduceFromModel.apply(x, mesh) if _wide(mesh) else x


def sum_over_model(x, mesh):
    """A partial sum that feeds split work again: all-reduced forward and
    its gradient all-reduced backward (``reduce_from_model`` then
    ``copy_to_model``)."""
    return copy_to_model(reduce_from_model(x, mesh), mesh)


def max_over_model(x, mesh):
    """The elementwise max of ``x`` over ``"model"`` (one all-reduce); no
    gradient flows through it."""
    if not _wide(mesh):
        return x.detach()
    return _MaxOverModel.apply(x.detach(), mesh)


def gather_from_model(x, mesh, dim: int):
    """The ranks' slices of a split dim ``dim`` concatenated in ``"model"``
    order (one all-gather); backward keeps the rank's slice of the
    gradient."""
    return _GatherFromModel.apply(x, mesh, dim) if _wide(mesh) else x


# --------------------------------------------------------------------------
# the slicing rule
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """How a module computes on this ``"model"`` rank: ``lo:hi`` is its
    range of the split axis (q heads, ``d_ff`` columns, experts, vocab
    rows, SSD heads) out of ``size`` ranks. ``kv_index`` (attention only)
    maps each of the rank's q heads to its kv head among those the rank
    computes, where the flash kernel's ``h // (H / K)`` would not."""

    mesh: Any
    size: int
    lo: int
    hi: int
    kv_index: tuple[int, ...] | None = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """The split of a model on one ``"model"`` rank: ``runs`` per
    parameter, per dim, the ``(start, stop)`` index runs of the slice it
    computes with (in order); ``modes`` its gradient rule (``disjoint``,
    ``partial`` or ``identical``);
    ``splits`` per module name (``""``: the model itself, for the vocab)
    its :class:`Split`."""

    runs: dict[str, tuple[tuple[tuple[int, int], ...], ...]]
    modes: dict[str, str]
    splits: dict[str, Split]

    def shape(self, name: str) -> tuple[int, ...]:
        """The shape of the slice ``name`` computes with."""
        return tuple(sum(b - a for a, b in dim) for dim in self.runs[name])

    def take(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """The slice of ``name`` this rank computes with, cut from the
        whole tensor ``whole`` (its runs concatenated along each dim; a
        view where every dim is one run)."""
        out = whole
        for d, dim_runs in enumerate(self.runs[name]):
            if dim_runs == ((0, whole.shape[d]),):
                continue
            parts = [out.narrow(d, a, b - a) for a, b in dim_runs]
            out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)
        return out


def _over_model(spec, i: int) -> bool:
    e = spec[i] if i < len(spec) else None
    return e == "model" or (isinstance(e, tuple) and "model" in e)


def plan(model, specs: dict, mesh, rank: int | None = None) -> Plan:
    """The split of ``model``'s parameters (``specs``: name -> fitted
    ``P``) on ``"model"`` rank ``rank`` (default: this process's) of
    ``mesh``. Every parameter not in a split module is whole and
    ``identical``; on a ``"model"`` of 1 all are."""
    m = dim_size(mesh, "model")
    r = dim_rank(mesh, "model") if rank is None else rank
    params = dict(model.named_parameters())
    runs = {n: tuple(((0, d),) for d in p.shape) for n, p in params.items()}
    modes = dict.fromkeys(params, "identical")
    splits: dict[str, Split] = {}
    if m == 1:
        return Plan(runs, modes, splits)

    def cut(name, dim, dim_runs, mode):
        if name not in params:          # an absent bias
            return
        new = list(runs[name])
        new[dim] = tuple(dim_runs)
        runs[name], modes[name] = tuple(new), mode

    def over(pre, *checks):
        return all(_over_model(specs[pre + n], i) for n, i in checks)

    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if hasattr(mod, "wq"):                       # attention
            H, K = mod.wq.shape[1], mod.wk.shape[1]
            if not over(pre, ("wq", 1), ("wo", 0)):
                continue
            hl = H // m
            h0 = r * hl
            for n, d in (("wq", 1), ("bq", 0), ("wo", 0)):
                cut(pre + n, d, [(h0, h0 + hl)], "disjoint")
            g = H // K
            kv = [(h0 + j) // g for j in range(hl)]
            lo, hi = kv[0], kv[-1] + 1
            kl = hi - lo
            uniform = hl % kl == 0 and all(
                k - lo == j // (hl // kl) for j, k in enumerate(kv))
            mode = "disjoint" if over(pre, ("wk", 1)) else "partial"
            for n, d in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
                cut(pre + n, d, [(lo, hi)], mode)
            splits[name] = Split(mesh, m, h0, h0 + hl, None if uniform
                                 else tuple(k - lo for k in kv))
        elif hasattr(mod, "in_proj"):                # the SSD mixer
            H, di = mod.A_log.shape[0], mod.out_norm.shape[0]
            if H % m or not over(pre, ("in_proj", 1), ("conv_w", 1),
                                 ("out_norm", 0), ("out_proj", 0)):
                continue
            two_gn = mod.in_proj.shape[1] - 2 * di - H   # B and C
            hl, P = H // m, di // H
            h0 = r * hl
            c0, cl = h0 * P, hl * P
            cut(pre + "in_proj", 1, [(c0, c0 + cl), (di + c0, di + c0 + cl),
                                     (2 * di, 2 * di + two_gn),
                                     (2 * di + two_gn + h0,
                                      2 * di + two_gn + h0 + hl)], "partial")
            conv = [(c0, c0 + cl), (di, di + two_gn)]     # x | B C
            cut(pre + "conv_w", 1, conv, "partial")
            cut(pre + "conv_b", 0, conv, "partial")
            for n in ("A_log", "D_skip", "dt_bias"):
                cut(pre + n, 0, [(h0, h0 + hl)], "disjoint")
            for n in ("out_norm", "out_proj"):
                cut(pre + n, 0, [(c0, c0 + cl)], "disjoint")
            splits[name] = Split(mesh, m, h0, h0 + hl)
        elif hasattr(mod, "w_gate"):   # routed experts (E, ...) or SwiGLU
            d = 0 if mod.w_gate.dim() == 3 else 1
            checks = (("w_gate", d), ("w_up", d), ("w_down", 0))
            if not over(pre, *checks):
                continue
            el = mod.w_gate.shape[d] // m
            for n, i in checks:
                cut(pre + n, i, [(r * el, (r + 1) * el)], "disjoint")
            splits[name] = Split(mesh, m, r * el, (r + 1) * el)
    if "embed" in params and _over_model(specs["embed"], 0) and (
            "lm_head" not in params or _over_model(specs["lm_head"], 1)):
        vl = params["embed"].shape[0] // m
        cut("embed", 0, [(r * vl, (r + 1) * vl)], "disjoint")
        cut("lm_head", 1, [(r * vl, (r + 1) * vl)], "disjoint")
        splits[""] = Split(mesh, m, r * vl, (r + 1) * vl)
    return Plan(runs, modes, splits)


@contextlib.contextmanager
def applied(model, splits: dict[str, Split]):
    """Each module named in ``splits`` carries its :class:`Split` as
    ``tp`` while the block runs (the layers read it; a module without one
    computes whole)."""
    mods = dict(model.named_modules())
    try:
        for name, s in splits.items():
            mods[name].tp = s
        yield
    finally:
        for name in splits:
            mods[name].__dict__.pop("tp", None)


def split_of(module) -> Split | None:
    """The module's :class:`Split` inside :func:`applied`, else None."""
    return module.__dict__.get("tp")
