"""The port's cost backend: plans -> device tensors -> cost kernels.

Early-start grids go through ``kernels.policy_cost.policy_cost_chain``: every
bid's row batch is zero-padded to the widest bid and stacked with the
per-bid market views, so ONE launch covers the (bid x scenario x policy x
job) sweep; per-scenario plans (pool-refinement rounds) ride a (B, S, R, L)
stack. Planned-start grids (the Even benchmark) go through
``kernels.policy_cost.policy_cost`` with ONE launch per bid, the scenarios a
grid dimension of that launch (the reference loops over scenarios in
Python; the arithmetic is unchanged). Host plans (float64 numpy) are
stacked on the host and uploaded as float32; device plans are stacked by
torch ops on their device, each group's tensors copied once into the
per-bid stack. Results come back to the host in float64 and are scattered
into ``out[key][:, :, g.policy_idx]`` as the reference does.

Sharded path (DESIGN.md §9): with a ``GridMesh`` each rank scores only its
scenario slab (the batch's padded rows of ``"data"``) x group block (whole
groups per ``"model"`` rank, the last group repeated, ``pad_groups``),
per-scenario self-owned stacks sliced on both axes: still one chain launch
per chunk, or one task launch per bid. Those launches issue no collective
(program keys ``engine.eval.*:sharded``). The four output keys of every
bid are packed into one float32 buffer and come back through one
``all_gather`` per chunk (``engine.gather:sharded``); every rank then
splices all of them into ``out``: ``[:S]`` drops scenario padding and only
the real groups are written. The kernels compute each (bid, scenario, row)
cell alone, so a meshed tensor equals the unsharded one bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.mesh import all_gather
from repro_torch.engine.plan import concat_rows, scenario_cat
from repro_torch.kernels import policy_cost as pc
from repro_torch.obs import span
from repro_torch.obs.compiled import program

__all__ = ["run", "splice", "eval_sharded", "gather_sharded"]


def _f32(a, device):
    """A float32 tensor on ``device``: host arrays are uploaded, device
    plan tensors (already there) are cast in place."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def _rows(a, mesh):
    """A leading-scenario array restricted to this rank's slab of a mesh;
    the array itself without one."""
    return a if mesh is None else mesh.rows(a)


def _arrival(gplan, device):
    """The jobs' arrivals as the chain launch reads them: a float32 tensor
    on ``device`` for a device plan (uploaded here, before any program
    opens), the host array for a host plan."""
    return _f32(gplan.arrival, device) if gplan.device else gplan.arrival


def _chain(gplan, batch, groups_per_bid, mesh, arrival_j):
    """ONE ``policy_cost_chain`` launch over every bid's groups
    ``groups_per_bid`` and the chunk's scenarios (this rank's slab under
    ``mesh``): the result dict of (B, S_rows, R_max) tensors.
    ``arrival_j`` is :func:`_arrival`'s."""
    dev = batch.device
    J, L = gplan.n_jobs, gplan.L
    B = len(groups_per_bid)
    S = batch.n_scenarios if mesh is None else \
        batch.n_rows // mesh.data_shards
    per_scenario = gplan.per_scenario
    R_max = max(len(gs) for gs in groups_per_bid) * J
    pshape = (B, S, R_max, L) if per_scenario else (B, R_max, L)
    if gplan.device:
        zeros = lambda shape: torch.zeros(  # noqa: E731
            shape, dtype=torch.float32, device=dev)
    else:
        zeros = np.zeros
    arrival = zeros((B, R_max))
    ends = zeros((B, R_max, L))
    z_t, d_eff, pins = zeros(pshape), zeros(pshape), zeros(pshape)
    for bi, groups in enumerate(groups_per_bid):
        for gi, g in enumerate(groups):
            rows = slice(gi * J, (gi + 1) * J)
            arrival[bi, rows] = arrival_j
            ends[bi, rows] = g.plan.ends
            # A scenario-independent group broadcasts over S.
            sl = (bi, slice(None), rows) if per_scenario else (bi, rows)
            own = (lambda a: _rows(a, mesh)) if g.per_scenario \
                else (lambda a: a)
            z_t[sl] = own(g.z_t)
            d_eff[sl] = own(g.d_eff)
            pins[sl] = own(g.pins)
    AC = [batch.stacked(bid) for bid in gplan.bids]
    return pc.policy_cost_chain(
        torch.stack([a for a, _ in AC]), torch.stack([c for _, c in AC]),
        *(_f32(a, dev) for a in (arrival, ends, z_t, d_eff, pins)),
        slot=batch.slot, p_od=batch.p_ondemand)


def _task(gplan, batch, bid, groups, mesh):
    """ONE ``policy_cost`` launch for one bid's ``groups`` and the chunk's
    scenarios (this rank's slab under ``mesh``): the result dict of
    (S_rows, R * L) tensors."""
    dev = batch.device
    L = gplan.L
    S = batch.n_scenarios
    A, C = batch.stacked(bid)                    # (S_rows, n_slots+1)
    starts = concat_rows([g.plan.starts for g in groups])
    ends = concat_rows([g.plan.ends for g in groups])
    R = starts.shape[0]
    if gplan.per_scenario:
        z_t = _rows(scenario_cat(groups, "z_t", S), mesh).reshape(-1, R * L)
        d_eff = _rows(scenario_cat(groups, "d_eff", S), mesh).reshape(
            -1, R * L)
    else:
        z_t = concat_rows([g.z_t for g in groups]).reshape(R * L)
        d_eff = concat_rows([g.d_eff for g in groups]).reshape(R * L)
    return pc.policy_cost(
        A, C, *(_f32(a, dev) for a in (starts.reshape(R * L),
                                       ends.reshape(R * L), z_t, d_eff)),
        slot=batch.slot, p_od=batch.p_ondemand)


def run(gplan, batch, early_start: bool, out, mesh=None) -> float:
    """Fill the (S, J, P) host arrays in ``out`` for every scenario/group of
    ``batch`` (any ``ScenarioBatch``: a market list or a spec's chunk),
    sharded over ``mesh`` when one is given. Returns the seconds of the
    sharded path's gather and splice (its ``splice`` span; 0.0
    unsharded)."""
    if mesh is not None:
        return _run_sharded(gplan, batch, early_start, out, mesh)
    J, L = gplan.n_jobs, gplan.L
    S = batch.n_scenarios
    groups_per_bid = [gplan.groups_for_bid(b) for b in gplan.bids]

    if early_start:
        res = _chain(gplan, batch, groups_per_bid, None,
                     _arrival(gplan, batch.device))
        for key in pc.OUT_KEYS:
            vals = _host(res[key])                       # (B, S, R_max)
            for bi, groups in enumerate(groups_per_bid):
                per_g = vals[bi, :, :len(groups) * J].reshape(
                    S, len(groups), J)
                for gi, g in enumerate(groups):
                    out[key][:, :, g.policy_idx] = per_g[:, gi, :, None]
        return 0.0

    for bid, groups in zip(gplan.bids, groups_per_bid):
        res = _task(gplan, batch, bid, groups, None)
        for key in pc.OUT_KEYS:
            v = _host(res[key]).reshape(S, len(groups), J, L).sum(axis=3)
            for gi, g in enumerate(groups):
                out[key][:, :, g.policy_idx] = v[:, gi, :, None]
    return 0.0


def _block(mesh, groups, model_rank: int) -> list:
    """A ``"model"`` rank's whole groups of one bid: the bid's groups
    padded to ``pad_groups`` by repeating the last one, then the rank's
    contiguous block."""
    G = len(groups)
    padded = groups + [groups[-1]] * (mesh.pad_groups(G) - G)
    return [padded[i] for i in mesh.group_block(G, model_rank)]


def _run_sharded(gplan, batch, early_start: bool, out, mesh) -> float:
    S = batch.n_scenarios
    groups_per_bid = [gplan.groups_for_bid(b) for b in gplan.bids]
    local = [_block(mesh, gs, mesh.model_rank) for gs in groups_per_bid]
    packed = eval_sharded(gplan, batch, early_start, local, mesh,
                          _arrival(gplan, batch.device) if early_start
                          else None)
    with span("splice", scenarios=S, shards=mesh.n_shards) as sp:
        splice(gather_sharded(mesh, packed), mesh, S, gplan.n_jobs, gplan.L,
               groups_per_bid, early_start, out)
    return sp.seconds


def eval_sharded(gplan, batch, early_start: bool, local, mesh, arrival_j):
    """One rank's launches of a chunk (program ``engine.eval.chain:sharded``
    or ``engine.eval.task:sharded``, ``_ps`` with per-scenario plans):
    its groups ``local`` (per bid) over its scenario slab, the four output
    keys of every bid packed into one flat float32 tensor on the device.
    Issues no collective and reads nothing back to the host."""
    sfx = "_ps" if gplan.per_scenario else ""
    if early_start:
        with program(f"engine.eval.chain{sfx}:sharded"):
            res = _chain(gplan, batch, local, mesh, arrival_j)
            return torch.stack([res[k] for k in pc.OUT_KEYS]).reshape(-1)
    with program(f"engine.eval.task{sfx}:sharded"):
        return torch.cat([
            torch.stack([res[k] for k in pc.OUT_KEYS]).reshape(-1)
            for res in (_task(gplan, batch, bid, gs, mesh)
                        for bid, gs in zip(gplan.bids, local))])


def gather_sharded(mesh, packed):
    """Every rank's packed block, in rank order (program
    ``engine.gather:sharded``: ONE all-gather)."""
    with program("engine.gather:sharded"):
        return all_gather(mesh, packed)


def splice(gathered, mesh, S: int, J: int, L: int, groups_per_bid,
           early_start: bool, out) -> None:
    """Scatter every rank's packed block (``gathered[rank]``, in rank
    order; a tensor on any device, or a host array) into the (S, J, P)
    arrays of ``out``: a rank's rows past ``S`` (scenario padding) and its
    groups past each bid's real count (group padding) are never written.

    Each (rank, key, bid) block comes to the host in float64 on its own,
    as the unsharded path fetches each key of each launch: host buffers
    past glibc's 32 MB mmap threshold get fresh pages on every copy, and
    a rank's whole block of a planned-start chunk is far past it.
    """

    def f64(a):
        return _host(a) if isinstance(a, torch.Tensor) \
            else np.asarray(a, np.float64)

    Sl = mesh.pad(S) // mesh.data_shards
    n_loc = [mesh.pad_groups(len(gs)) // mesh.model_shards
             for gs in groups_per_bid]
    R_max = max(n_loc) * J
    n_keys = len(pc.OUT_KEYS)
    for r, (d, m) in enumerate(mesh.rank_coords):
        s_lo, s_hi = d * Sl, min((d + 1) * Sl, S)
        rows = s_hi - s_lo
        if rows <= 0:
            continue
        # (local slot, group) of the rank's real groups per bid: padding
        # groups past a bid's count are dropped here.
        real = [[(li, gs[gi]) for li, gi in
                 enumerate(mesh.group_block(len(gs), m)) if gi < len(gs)]
                for gs in groups_per_bid]
        if early_start:
            vals = gathered[r].reshape(n_keys, len(groups_per_bid), Sl,
                                       R_max)
        for ki, key in enumerate(pc.OUT_KEYS):
            dst = out[key][s_lo:s_hi]
            off = 0
            for bi, n in enumerate(n_loc):
                if early_start:
                    per_g = f64(vals[ki, bi, :rows, :n * J]).reshape(
                        rows, n, J)
                else:
                    size = Sl * n * J * L
                    at = off + ki * size
                    off += n_keys * size
                    # The planned-start sum over tasks, in float64 on the
                    # host, on a contiguous block as the unsharded path
                    # sums.
                    per_g = np.ascontiguousarray(f64(
                        gathered[r, at:at + size].reshape(Sl, n, J, L)[
                            :rows])).sum(axis=3)
                for li, g in real[bi]:
                    dst[:, :, g.policy_idx] = per_g[:, li, :, None]
