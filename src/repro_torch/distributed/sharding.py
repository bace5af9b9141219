"""Logical-axis sharding (the reference's ``distributed/sharding.py``): one
rule table maps model-semantic axis names to mesh axes; every parameter,
cache entry and batch input is annotated through it.

Logical axes used across the zoo:

  batch      — global batch                      -> ("pod", "data") [+ "model" for decode]
  seq        — sequence (context-parallel)       -> None (or "model" for long prefill)
  d_model    — residual width                    -> None
  heads      — attention query heads             -> "model"
  kv_heads   — attention kv heads                -> "model" (or None when kv < mesh)
  d_ff       — MLP hidden                        -> "model"
  vocab      — embedding/logits vocabulary       -> "model"
  experts    — MoE expert dimension              -> "model" (expert parallelism)
  fsdp       — parameter shard axis (ZeRO-3)     -> ("pod", "data")
  layers     — scan-stacked layer dim            -> None
  conv, d_state, d_head, groups                  -> None

The rules are a plain dict so the variants (``launch/variants.py``) can
override individual entries without touching model code.

The spec type is the port's own :class:`P`, a tuple whose entries are
None, a mesh-axis name or a tuple of names (``tuple(P(...))`` equals
``tuple`` of jax's ``PartitionSpec`` with the same entries). A mesh is
anything that names its axes: a ``torch.distributed`` ``DeviceMesh``
(``mesh_dim_names``), the port's ``GridMesh`` (always ``("data",
"model")``, the model dim 1 wide where it has none) or a stand-in with
``axis_names`` and a ``shape`` mapping (the dry-run's production meshes,
which it never builds).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.engine.mesh import mesh_axes, mesh_shape

__all__ = [
    "P",
    "NamedSharding",
    "ShardingRules",
    "DEFAULT_RULES",
    "logical_to_spec",
    "param_specs",
    "constrain",
]

Rules = dict[str, Any]

# axis name -> mesh axis (str), tuple of mesh axes, or None (replicated)
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "decode_batch": ("pod", "data", "model"),
    "seq": None,
    "seq_shard": "model",       # sequence-parallel prefill variant
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "fsdp": ("pod", "data"),
    "layers": None,
    "conv": None,
    "d_state": None,
    "d_head": None,
    "groups": None,
    "frames": None,
    "patches": None,
    # decode-time cache axes
    "cache_batch": ("pod", "data"),
    "cache_seq": "model",      # context-parallel KV cache
    "ssm_p": "model",          # SSD head_dim (divides for both ssm archs)
    "conv_ch": "model",
}


class P(tuple):
    """A partition spec: one entry per array dim, each None (replicated), a
    mesh-axis name, or a tuple of names (the dim split over their product,
    the first name major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (jax's ``NamedSharding``): the shard shape of
    a global shape, and the block of it that a mesh position holds."""

    mesh: Any
    spec: P

    def _splits(self, shape) -> list[tuple[tuple[str, ...], int]]:
        """Per dim: the mesh axes that split it and their product."""
        sizes = mesh_shape(self.mesh)
        out = []
        for i in range(len(shape)):
            e = self.spec[i] if i < len(self.spec) else None
            axes = () if e is None else (e,) if isinstance(e, str) \
                else tuple(e)
            n = math.prod(sizes[a] for a in axes)
            if shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"over {axes} ({n} ways)")
            out.append((axes, n))
        return out

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of each position's block of a ``shape`` array."""
        return tuple(d // n for d, (_, n) in zip(shape, self._splits(shape)))

    def block(self, shape, coords: dict[str, int]) -> tuple[slice, ...]:
        """The slices of a ``shape`` array held at the mesh position
        ``coords`` (axis name -> index); a dim split over several axes
        takes the first as the major one."""
        sizes = mesh_shape(self.mesh)
        out = []
        for d, (axes, n) in zip(shape, self._splits(shape)):
            i = 0
            for a in axes:
                i = i * sizes[a] + coords[a]
            out.append(slice(i * (d // n), (i + 1) * (d // n)))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Rule table bound to a mesh; filters axes the mesh doesn't have."""

    rules: tuple[tuple[str, Any], ...]
    mesh_axes: tuple[str, ...]

    @classmethod
    def create(cls, mesh, overrides: Rules | None = None):
        rules = dict(DEFAULT_RULES)
        if overrides:
            rules.update(overrides)
        return cls(rules=tuple(rules.items()),
                   mesh_axes=mesh_axes(mesh))

    def _mesh_axis(self, logical: str | None):
        if logical is None:
            return None
        rule = dict(self.rules).get(logical, None)
        if rule is None:
            return None
        if isinstance(rule, str):
            return rule if rule in self.mesh_axes else None
        picked = tuple(a for a in rule if a in self.mesh_axes)
        return picked if picked else None

    def spec(self, *logical_axes: str | None) -> P:
        """Spec for an array whose dims carry these logical names."""
        used: set[str] = set()
        out = []
        for ax in logical_axes:
            m = self._mesh_axis(ax)
            # A mesh axis may appear at most once in a spec.
            if m is None:
                out.append(None)
                continue
            ms = (m,) if isinstance(m, str) else m
            ms = tuple(a for a in ms if a not in used)
            used.update(ms)
            if not ms:
                out.append(None)
            elif len(ms) == 1:
                out.append(ms[0])
            else:
                out.append(ms)
        return P(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, P) and all(
        a is None or isinstance(a, str) for a in x)


def logical_to_spec(rules: ShardingRules, tree):
    """Map a tree (nested dicts) of logical-axis tuples to one of specs."""
    if _is_axes(tree):
        return rules.spec(*tree)
    return {k: logical_to_spec(rules, v) for k, v in tree.items()}


def param_specs(axes_tree, rules: ShardingRules):
    """Spec tree for a parameter tree annotated with logical axes.

    ``axes_tree`` mirrors the parameters (the port's: flat, keyed by
    state-dict name); each leaf is a tuple of logical axis names (length ==
    ndim of the corresponding tensor)."""
    return logical_to_spec(rules, axes_tree)


def constrain(x, rules: ShardingRules | None, *logical_axes: str | None):
    """The reference's ``with_sharding_constraint`` through the rule table.
    The port has no GSPMD to hand a constraint to, so this returns ``x``
    on or off a mesh. The port's models take no ``rules``: in the meshed
    train step (``launch/steps.py::ShardedTrainStep``) each rank runs the
    model on its own ``"data"`` rows of the batch, which is what the
    reference's ``"batch"`` constraints ask for, and the tensor-parallel
    split that its other constraints (heads, kv heads, d_ff, experts,
    vocab over ``"model"``) ask for is written out by
    ``distributed/tensor_parallel.py``: each module computes with its
    rank's slice and all-reduces where GSPMD would."""
    return x
