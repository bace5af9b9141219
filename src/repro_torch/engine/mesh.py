"""Scenario x policy-group mesh on ``torch.distributed`` (DESIGN.md §9).

The port's counterpart of the reference's ``engine/mesh.py``. Scenarios
are independent (only the regret fold crosses them), and so are the
evaluation groups of a grid plan, so a mesh shards the scenario axis over
a dim named ``"data"`` and the group axis over a dim named ``"model"``.
The reference runs one program over many devices; the port runs one
process per mesh position (SPMD): each rank synthesizes, views and scores
only its scenario slab x group block, and the results come back to every
rank through one all-gather per chunk.

``GridMesh`` wraps a ``torch.distributed.device_mesh.DeviceMesh`` with dims
``("data", "model")``, or ``("data",)`` when the model dim is 1 wide, and
owns the padding contract of both axes:

* scenario axis: a chunk of K scenarios is padded to ``pad(K)`` rows, the
  LAST row repeated, so every ``"data"`` rank holds the same row count;
* group axis: a bid's G groups are padded to ``pad_groups(G)``, the LAST
  group repeated, so every ``"model"`` rank owns the same number of whole
  groups.

Padded lanes carry real (duplicated) data, are masked out of every
reduction, and are dropped at the splice. A 1x1 mesh needs no process
group: it is the unsharded computation, through the same code.

Every collective of the port goes through this module's three counted
helpers, each recorded with its operand bytes under the running program
key (``obs.compiled.collective_counts`` and ``collective_bytes``):
:func:`all_gather` (over the whole mesh, or along one dim),
:func:`all_reduce` (SUM or MAX over one dim, ``"data"`` by default, or
over several) and :func:`permute` (a ring's collective permute over one
dim, the pipeline's). On a :class:`StandInMesh` (a mesh's shape seen
from one of its positions, with no process group: the dry-run's
production meshes) each records what that rank would move and returns an
output of the right shape without communicating, so one rank's step
traces on meta tensors. The process group's
backend decides how a tensor on the card reaches the collective: NCCL
takes it as it is; gloo, which has no collectives for CUDA tensors, gets
a host copy. A gloo all-reduce, permute or one-dim all-gather is copied
back to the tensor's device; a gloo all-gather over the whole mesh stays
on the host, where the splice reads it. The tensor-parallel split's
autograd-aware forms of these (``distributed/tensor_parallel.py``) call
the same helpers. The helpers take a ``GridMesh`` or,
for dims other than ``("data", "model")`` (the pipeline's ``"stage"``), a
``DeviceMesh`` from :func:`make_mesh`. The process group itself is
joined, left and shrunk here too (:func:`start_process_group`,
:func:`regroup`): no other module of the port reaches
``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.obs.compiled import collective

__all__ = [
    "GridMesh", "StandInMesh", "ScenarioMesh", "as_scenario_mesh", "pad_to",
    "edge_repeat",
    "scen_rows", "all_gather", "all_reduce", "permute", "mesh_axes",
    "mesh_shape", "dim_size", "dim_rank", "make_mesh", "start_process_group",
    "end_process_group", "process_rank", "regroup",
]

_DIMS = ("data", "model")

# Once-per-process clamp-warning keys: (requested data, requested model,
# ranks in the process group).
_CLAMP_WARNED: set[tuple[int, int, int]] = set()
# Meshes built by GridMesh.create, per (data, model) shape, with the world
# group they were built on: one DeviceMesh (and one set of sub-groups) per
# shape and process group, not one per call.
_MESHES: dict[tuple[int, int], tuple[Any, "GridMesh"]] = {}


def pad_to(k: int, n: int) -> int:
    """Smallest multiple of ``n`` that is ``>= k`` (the padded lane count)."""
    return -(-k // n) * n


def edge_repeat(a: np.ndarray, rows: int) -> np.ndarray:
    """Pad the leading axis to ``rows`` by repeating the last entry.

    The padding contract for both mesh axes: padded lanes are real
    (duplicated) data, never NaN/zero filler, so every shard computes a
    well-posed problem and the splice just drops the extra lanes.
    """
    k = a.shape[0]
    if rows == k:
        return a
    if rows < k:
        raise ValueError(f"cannot pad {k} rows down to {rows}")
    reps = np.repeat(a[-1:], rows - k, axis=0)
    return np.concatenate([a, reps], axis=0)


def scen_rows(a, rows: int):
    """Edge-repeat a leading-scenario stack to ``rows`` rows: numpy arrays
    through :func:`edge_repeat`, tensors on their own device."""
    if not isinstance(a, torch.Tensor):
        return edge_repeat(a, rows)
    k = a.shape[0]
    if rows == k:
        return a
    if rows < k:
        raise ValueError(f"cannot pad {k} rows down to {rows}")
    return torch.cat([a, a[-1:].expand(rows - k, *a.shape[1:])], dim=0)


def _dist():
    """``torch.distributed`` when a process group is initialised, else
    None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def _check_backend(dist) -> None:
    """NCCL refuses two ranks on one card: a mesh whose ranks would share
    one raises here, naming the backend that works. Nothing switches
    backend on its own."""
    if dist.get_backend() != "nccl":
        return
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local > cards:
        raise ValueError(
            f"a mesh of {local} NCCL ranks on {cards} card(s) would put two "
            f"ranks on one device, which NCCL refuses; initialise the "
            f"process group with backend='gloo' for ranks that share a card")


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A ``("data", "model")`` mesh of ranks plus its padding contract.

    Frozen and hashable (it joins the plan-cache key through its
    partition). ``mesh`` is the ``DeviceMesh``; it is None only for the
    1x1 mesh of a process without a process group, which issues its
    collectives to itself.
    """

    mesh: Any                 # torch.distributed.device_mesh.DeviceMesh
    data_shards: int = 1
    model_shards: int = 1
    # (data, model) of every rank, read once from the DeviceMesh when the
    # mesh is built: a launch asks for its position without a tensor op.
    rank_table: tuple = dataclasses.field(default=(), compare=False,
                                          repr=False)

    @classmethod
    def create(cls, n_devices: int | None = None,
               model_devices: int = 1) -> "GridMesh":
        """Mesh of ``n_devices x model_devices`` ranks, clamped to the
        ranks of the process group (1 without one).

        ``n_devices`` (default: every rank the model dim leaves) shards the
        scenario axis as ``"data"``; ``model_devices`` shards the group
        axis as ``"model"``. Clamping warns (once per process per request
        shape) rather than raises, so ``--mesh 8`` runs unchanged on a box
        with one card (the 1x1 mesh is the unsharded computation). Every
        rank of the process group must take a position: a mesh that
        spans fewer ranks raises.
        """
        dist = _dist()
        avail = dist.get_world_size() if dist is not None else 1
        m = int(model_devices)
        if m < 1:
            raise ValueError(
                f"mesh needs >= 1 model device (got {model_devices})")
        n = max(avail // m, 1) if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"mesh needs >= 1 device (got {n_devices})")
        if n * m > avail:
            key = (n, m, avail)
            if key not in _CLAMP_WARNED:
                _CLAMP_WARNED.add(key)
                warnings.warn(
                    f"requested a {n}x{m} ({n * m}-rank) scenario x group "
                    f"mesh but only {avail} rank(s) are in the process "
                    f"group — clamping to {avail} (start more ranks with "
                    f"torch.distributed.init_process_group to shard "
                    f"further)", stacklevel=2)
            m = min(m, avail)
            n = max(avail // m, 1)
        if dist is None:
            return cls(mesh=None)
        if n * m != avail:
            raise ValueError(
                f"a {n}x{m} mesh must span all {avail} ranks of the process "
                f"group (one rank per mesh position)")
        cached = _MESHES.get((n, m))
        if cached is not None and cached[0] is dist.group.WORLD:
            return cached[1]
        _check_backend(dist)
        from torch.distributed.device_mesh import init_device_mesh

        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        shape, dims = ((n, m), _DIMS) if m > 1 else ((n,), _DIMS[:1])
        mesh = cls.from_device_mesh(
            init_device_mesh(device_type, shape, mesh_dim_names=dims))
        _MESHES[(n, m)] = (dist.group.WORLD, mesh)
        return mesh

    @classmethod
    def from_device_mesh(cls, mesh) -> "GridMesh":
        """Wrap a ``DeviceMesh`` whose dims are ``"data"`` and, optionally,
        ``"model"``, spanning every rank of the process group."""
        names = tuple(mesh.mesh_dim_names or ())
        if "data" not in names:
            raise ValueError(
                f"scenario mesh needs a 'data' dim (got dims {names}); "
                f"build one with GridMesh.create(n) or init_device_mesh(..., "
                f"mesh_dim_names=('data',))")
        extra = set(names) - set(_DIMS)
        if extra:
            raise ValueError(f"scenario mesh dims must be 'data' and "
                             f"optionally 'model' (got dims {names})")
        dist = _dist()
        if dist is None or mesh.size() != dist.get_world_size():
            raise ValueError(
                "a scenario mesh must span every rank of the initialised "
                "process group")
        _check_backend(dist)
        shape = dict(zip(names, mesh.mesh.shape))
        grid = cls(mesh=mesh, data_shards=int(shape["data"]),
                   model_shards=int(shape.get("model", 1)))
        return dataclasses.replace(grid, rank_table=tuple(
            grid.coords(r) for r in range(grid.n_shards)))

    # -- partition --------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return self.data_shards * self.model_shards

    @property
    def dims(self) -> tuple[str, ...]:
        return _DIMS if self.model_shards > 1 else _DIMS[:1]

    def coords(self, rank: int) -> tuple[int, int]:
        """(data, model) position of process-group rank ``rank``."""
        if self.mesh is None:
            return 0, 0
        if self.rank_table:
            return self.rank_table[rank]
        names = tuple(self.mesh.mesh_dim_names)
        pos = (self.mesh.mesh == rank).nonzero()[0].tolist()
        at = dict(zip(names, pos))
        return int(at["data"]), int(at.get("model", 0))

    @property
    def rank_coords(self) -> list[tuple[int, int]]:
        """(data, model) position of every rank, in rank order — the order
        :func:`all_gather` stacks its parts in."""
        return [self.coords(r) for r in range(self.n_shards)]

    def position(self, rank: int | None = None) -> dict[str, int]:
        """``{"data": d, "model": m}`` of process-group rank ``rank``
        (default: this process's): the coordinates a ``NamedSharding``'s
        ``block`` takes."""
        d, m = self._here() if rank is None else self.coords(rank)
        return {"data": d, "model": m}

    @property
    def data_rank(self) -> int:
        return self._here()[0]

    @property
    def model_rank(self) -> int:
        return self._here()[1]

    def _here(self) -> tuple[int, int]:
        if self.mesh is None:
            return 0, 0
        return self.coords(_dist().get_rank())

    def pad(self, k: int) -> int:
        """Rows after padding k scenarios to a multiple of ``data_shards``."""
        return pad_to(k, self.data_shards)

    def pad_groups(self, g: int) -> int:
        """Entries after padding g eval groups to a multiple of
        ``model_shards`` (whole groups per ``"model"`` rank)."""
        return pad_to(g, self.model_shards)

    def pad_rows(self, a: np.ndarray) -> np.ndarray:
        """Pad a leading-scenario host array to ``pad(len)`` rows (the last
        row repeated — real data, masked or sliced away downstream)."""
        return edge_repeat(a, self.pad(a.shape[0]))

    def slab(self, k: int, data_rank: int | None = None) -> np.ndarray:
        """Positions (into a chunk of k scenarios) of a ``"data"`` rank's
        padded rows: the rank's block of ``pad(k)`` rows, each padding row
        pointing at the last real one."""
        d = self.data_rank if data_rank is None else data_rank
        per = self.pad(k) // self.data_shards
        return np.minimum(np.arange(d * per, (d + 1) * per), k - 1)

    def slab_valid(self, k: int, data_rank: int | None = None) -> np.ndarray:
        """Which of a ``"data"`` rank's padded rows are real scenarios."""
        d = self.data_rank if data_rank is None else data_rank
        per = self.pad(k) // self.data_shards
        return np.arange(d * per, (d + 1) * per) < k

    def group_block(self, g: int, model_rank: int | None = None) -> range:
        """Indices (into the ``pad_groups(g)`` padded groups) of a
        ``"model"`` rank's whole groups."""
        m = self.model_rank if model_rank is None else model_rank
        per = self.pad_groups(g) // self.model_shards
        return range(m * per, (m + 1) * per)

    def check_device(self, device) -> None:
        """NCCL moves CUDA tensors only: a mesh over NCCL refuses an
        evaluation on another device (no silent move to the card)."""
        dist = _dist()
        if self.mesh is not None and dist is not None \
                and dist.get_backend() == "nccl" \
                and torch.device(device).type != "cuda":
            raise ValueError(
                f"a mesh over NCCL needs device='cuda' (got {device!r}); "
                f"use a gloo process group for CPU ranks")

    def rows(self, a):
        """This rank's slab of a leading-scenario array (host or device,
        kept where it is): padded to ``pad(len)`` rows by repeating the
        last, then the rank's block."""
        per = self.pad(a.shape[0]) // self.data_shards
        d = self.data_rank
        return scen_rows(a, self.pad(a.shape[0]))[d * per:(d + 1) * per]

    def put_rows(self, a, device=None) -> torch.Tensor:
        """This rank's padded slab of a leading-scenario array as a tensor
        on ``device`` (a tensor's own device when None; the card for a
        host array)."""
        t = self.rows(a)
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.ascontiguousarray(t))
            device = "cuda" if device is None else device
        return t if device is None else t.to(device)


# The 1-D scenario mesh is a GridMesh with a 1-wide (absent) "model" dim.
ScenarioMesh = GridMesh


@dataclasses.dataclass(frozen=True)
class StandInMesh:
    """A mesh's axes and sizes seen from one position, ``rank`` (row-major
    over the axes, as a ``DeviceMesh`` numbers its ranks), with no process
    group behind it: the shape of ``launch.mesh.make_production_mesh``
    (16x16 or 2x16x16) or of a small test mesh. The sharding rules fit
    specs against it, ``tensor_parallel.plan`` splits for its position,
    and the collective helpers record the bytes that position would move
    and return outputs of the right shape: an all-gather's other parts are
    zeros, a reduction leaves the rank's own tensor, a permute returns a
    copy. So a rank's step runs (on meta tensors, for its shapes) without
    its peers. Its ``"data"`` is every axis but ``"model"``, the first
    major, as the batch rules (``("pod", "data")``) order them."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int = 0

    @classmethod
    def of(cls, mesh, rank: int = 0) -> "StandInMesh":
        """The stand-in of an abstract mesh (``axis_names``, ``sizes``)."""
        return cls(tuple(mesh.axis_names), tuple(mesh.sizes), rank)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    n_shards = size

    @property
    def model_shards(self) -> int:
        return self.shape.get("model", 1)

    @property
    def data_shards(self) -> int:
        return self.size // self.model_shards

    def position(self, rank: int | None = None) -> dict[str, int]:
        """Axis name -> index of ``rank`` (default: the stand-in's own)."""
        idx = np.unravel_index(self.rank if rank is None else rank,
                               self.sizes)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    @property
    def model_rank(self) -> int:
        return self.position().get("model", 0)

    @property
    def data_rank(self) -> int:
        at = self.position()
        i = 0
        for a, n in zip(self.axis_names, self.sizes):
            if a != "model":
                i = i * n + at[a]
        return i

    def dim_rank(self, dims) -> int:
        """The position along ``dims`` (one name or several, the first
        major)."""
        at = self.position()
        i = 0
        for a in ((dims,) if isinstance(dims, str) else dims):
            i = i * self.shape.get(a, 1) + at.get(a, 0)
        return i

    def dim_size(self, dims) -> int:
        return int(np.prod([self.shape.get(a, 1) for a in (
            (dims,) if isinstance(dims, str) else dims)]))


def as_scenario_mesh(mesh) -> GridMesh | None:
    """Normalise every accepted ``mesh=`` argument.

    Accepts ``None`` (unsharded), a ``GridMesh``/``ScenarioMesh``, an int
    (scenario-shard count, clamped to the process group's ranks), or a
    ``DeviceMesh`` whose dims include ``"data"`` (a ``"model"`` dim, when
    present, shards the eval-group axis).
    """
    if mesh is None or isinstance(mesh, GridMesh):
        return mesh
    if isinstance(mesh, bool):
        raise ValueError(f"mesh must be None, an int shard count, a "
                         f"GridMesh, or a torch DeviceMesh (got {mesh!r})")
    if isinstance(mesh, (int, np.integer)):
        return GridMesh.create(int(mesh))
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        return GridMesh.from_device_mesh(mesh)
    raise ValueError(f"mesh must be None, an int shard count, a "
                     f"GridMesh, or a torch DeviceMesh (got {type(mesh)})")


# --------------------------------------------------------------------------
# The collectives
# --------------------------------------------------------------------------

def _group(mesh, dim: str | tuple[str, ...]):
    """The process group of ``mesh``'s dim ``dim`` for this rank, or None
    when the dim is this process alone (one rank wide, or no mesh). Of a
    tuple of dims: the one dim among them wider than one rank, or the
    world's group when several are (a ``GridMesh`` spans it)."""
    dims = (dim,) if isinstance(dim, str) else tuple(dim)
    wide = [d for d in dims if dim_size(mesh, d) > 1]
    if not wide:
        return None
    if len(wide) == 1:
        return (mesh.mesh if isinstance(mesh, GridMesh)
                else mesh).get_group(wide[0])
    if not isinstance(mesh, GridMesh) or set(wide) != set(_DIMS):
        raise ValueError(f"a reduction over {dims} of a mesh with dims "
                         f"{mesh_axes(mesh)} must span the whole GridMesh")
    return _dist().group.WORLD


def mesh_axes(mesh) -> tuple[str, ...]:
    """The axis names of any mesh the port takes: none for None, always
    ``("data", "model")`` for a ``GridMesh`` (the model dim 1 wide where
    it has none), a stand-in's ``axis_names`` (the dry-run's meshes, never
    built), a ``DeviceMesh``'s dim names."""
    if mesh is None:
        return ()
    if isinstance(mesh, GridMesh):
        return _DIMS
    if hasattr(mesh, "axis_names"):
        return tuple(mesh.axis_names)
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of any mesh ``mesh_axes`` takes (a stand-in's
    from its ``shape`` mapping)."""
    if mesh is None:
        return {}
    if isinstance(mesh, GridMesh):
        return {"data": mesh.data_shards, "model": mesh.model_shards}
    if hasattr(mesh, "axis_names"):
        return {a: int(mesh.shape[a]) for a in mesh.axis_names}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def dim_size(mesh, dim: str) -> int:
    """Ranks along ``mesh``'s dim ``dim`` (1 for None and for a
    ``GridMesh``'s absent model dim)."""
    return 1 if mesh is None else mesh_shape(mesh)[dim]


def dim_rank(mesh, dim: str) -> int:
    """This rank's position along ``mesh``'s dim ``dim``."""
    if mesh is None:
        return 0
    if isinstance(mesh, GridMesh):
        return {"data": mesh.data_rank, "model": mesh.model_rank}[dim]
    if isinstance(mesh, StandInMesh):
        return mesh.dim_rank(dim)
    return int(mesh.get_local_rank(dim))


def all_gather(mesh, t: torch.Tensor, dim: str | None = None
               ) -> torch.Tensor:
    """Gather ``t`` (the same shape on every rank) from the whole mesh (a
    ``GridMesh`` spanning the process group): ``(n_shards, *t.shape)`` in
    rank order, on ``t``'s device under NCCL and on the host under gloo
    (which stages through it; the engine's splice reads the blocks there,
    and a caller that wants them on the card copies them back). With
    ``dim``, from the ranks along that dim alone: ``(dim_size, *t.shape)``
    in their order along it, on ``t``'s device under either backend.
    Recorded as one ``all-gather`` of the running program, its operand
    bytes ``t``'s."""
    with collective("all-gather", _nbytes(t)):
        if isinstance(mesh, StandInMesh):
            return _stand_in_gather(mesh, t, dim)
        if dim is not None:
            group = _group(mesh, dim)
            if group is None:
                return t[None]
            import torch.distributed as dist

            n, t = dim_size(mesh, dim), t.contiguous()
            if dist.get_backend(group) == "nccl":
                out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                  device=t.device)
                dist.all_gather_into_tensor(out, t, group=group)
                return out
            parts = [torch.empty_like(t, device="cpu") for _ in range(n)]
            dist.all_gather(parts, t.cpu(), group=group)
            return torch.stack(parts).to(t.device)
        dist = _dist()
        if mesh.mesh is None or dist is None:
            return t[None]
        t = t.contiguous()
        if dist.get_backend() == "nccl":
            out = torch.empty((mesh.n_shards,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device)
            dist.all_gather_into_tensor(out, t)
            return out
        host = t.cpu()
        parts = [torch.empty_like(host) for _ in range(mesh.n_shards)]
        dist.all_gather(parts, host)
        return torch.stack(parts)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _stand_in_gather(mesh, t, dim):
    """A stand-in's all-gather: the rank's part at its place, zeros at the
    others'."""
    n = mesh.n_shards if dim is None else mesh.dim_size(dim)
    out = t.new_zeros((n,) + tuple(t.shape))
    out[mesh.rank if dim is None else mesh.dim_rank(dim)] = t
    return out


# Elements of a gloo ordered sum's chunk: every rank holds the group's
# parts of one chunk (4 MiB of float32 each) at a time, not of ``t``.
_ORDERED_CHUNK = 1 << 20


def all_reduce(mesh, t: torch.Tensor, dim: str | tuple[str, ...] = "data",
               op: str = "sum", ordered: bool = False) -> torch.Tensor:
    """Reduce ``t`` over the dim ``dim`` of ``mesh`` (a ``GridMesh`` or a
    ``DeviceMesh``), in place (every line along the other dims reduces on
    its own); a tuple of dims reduces over all of them (a ``GridMesh``'s
    ``("data", "model")``: the whole mesh). ``op`` is ``"sum"`` or
    ``"max"``. ``ordered`` sums under gloo as a left fold in rank order
    (the parts all-gathered to the host a chunk at a time), so a sum of
    more than two ranks is the one a single process adds up in that order
    (gloo's own ring adds each chunk in another order); NCCL reduces as it
    does. Recorded as one ``all-reduce`` of the running program, its
    operand bytes ``t``'s."""
    with collective("all-reduce", _nbytes(t)):
        if isinstance(mesh, StandInMesh):
            return t
        group = _group(mesh, dim)
        if group is None:
            return t
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if dist.get_backend(group) == "nccl":
            dist.all_reduce(t, op=red, group=group)
            return t
        if ordered and op == "sum":     # each chunk's parts, then a left fold
            flat, n = t.view(-1), dist.get_world_size(group)
            for at in range(0, flat.numel(), _ORDERED_CHUNK):
                part = flat[at:at + _ORDERED_CHUNK].cpu()
                got = [torch.empty_like(part) for _ in range(n)]
                dist.all_gather(got, part, group=group)
                for g in got[1:]:
                    got[0] += g
                flat[at:at + _ORDERED_CHUNK].copy_(got[0])
            return t
        host = t.cpu()
        dist.all_reduce(host, op=red, group=group)
        t.copy_(host)
        return t


def permute(mesh, t: torch.Tensor, dim: str) -> torch.Tensor:
    """The collective permute of a ring along ``mesh``'s dim ``dim``: each
    rank sends ``t`` to the next rank (the last to the first) and returns
    what the one before it sent (same shape and dtype), on ``t``'s device;
    a paired send and receive, staged through the host under gloo.
    Recorded as one ``collective-permute``, its operand bytes ``t``'s."""
    with collective("collective-permute", _nbytes(t)):
        if isinstance(mesh, StandInMesh):
            return t.clone()
        group = _group(mesh, dim)
        if group is None:
            return t
        import torch.distributed as dist

        ranks = dist.get_process_group_ranks(group)
        i, n = dist.get_rank(group), len(ranks)
        nccl = dist.get_backend(group) == "nccl"
        send = t.contiguous() if nccl else t.cpu()
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, ranks[(i + 1) % n], group),
                dist.P2POp(dist.irecv, recv, ranks[(i - 1) % n], group)]):
            req.wait()
        return recv if nccl else recv.to(t.device)


# --------------------------------------------------------------------------
# Process groups and meshes of ranks
# --------------------------------------------------------------------------

def start_process_group(backend: str, init_method: str = "env://",
                        world_size: int = -1, rank: int = -1,
                        timeout_s: float = 600.0) -> None:
    """Join a process group over ``backend`` (``torchrun``'s environment by
    default): NCCL for one rank a card, gloo for CPU ranks and for ranks
    that share a card (``_check_backend``). A ``tcp://host:port`` group
    gets a store of its own, served by its rank 0: under ``torchrun``
    torch's ``tcp://`` rendezvous would join the launcher's store instead,
    which serves no such port, and wait there until the timeout."""
    import datetime
    import urllib.parse

    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method.startswith("tcp://"):
        url = urllib.parse.urlparse(init_method)
        store = dist.TCPStore(url.hostname, url.port, world_size, rank == 0,
                              timeout)
        dist.init_process_group(backend, store=store, world_size=world_size,
                                rank=rank, timeout=timeout)
        return
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)


def end_process_group() -> None:
    """Leave the process group, if this process is in one."""
    dist = _dist()
    if dist is not None:
        dist.destroy_process_group()


def process_rank() -> tuple[int, int]:
    """(rank, world size) of this process in its group; (0, 1) without
    one."""
    dist = _dist()
    if dist is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def regroup(ranks: int, init_method: str) -> bool:
    """The elastic restart's shrink: leave the process group and form a
    new one, through ``init_method``, of its first ``ranks`` ranks (same
    backend; ``GridMesh.create`` then builds its meshes over the new
    group). Returns whether this process is in the new group; a process
    that is not has left every group. Every rank of the old group calls
    it."""
    import torch.distributed as dist

    rank, _ = process_rank()
    backend = dist.get_backend()
    dist.destroy_process_group()
    if rank >= ranks:
        return False
    start_process_group(backend, init_method, ranks, rank)
    return True


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` with dims ``axes`` over every rank of
    the process group (CUDA ranks under NCCL, CPU ranks under gloo; the
    pipeline's ``("stage",)``, for tests and elastic re-shards). Exported
    as ``launch.mesh.make_mesh``, the reference's name."""
    dist = _dist()
    if dist is None:
        raise ValueError("a DeviceMesh needs an initialised process group "
                         "(start_process_group)")
    _check_backend(dist)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
