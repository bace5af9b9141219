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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.plan import concat_rows, scenario_cat
from repro_torch.kernels import policy_cost as pc

__all__ = ["run"]


def _f32(a, device):
    """A float32 tensor on ``device``: host arrays are uploaded, device
    plan tensors (already there) are cast in place."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def run(gplan, batch, early_start: bool, out) -> None:
    """Fill the (S, J, P) host arrays in ``out`` for every scenario/group of
    ``batch`` (any ``ScenarioBatch``: a market list or a spec's chunk)."""
    dev = batch.device
    slot = batch.slot
    p_od = batch.p_ondemand
    J = gplan.n_jobs
    S = batch.n_scenarios
    L = gplan.L
    bids = gplan.bids
    groups_per_bid = [gplan.groups_for_bid(b) for b in bids]

    if early_start:
        B = len(bids)
        per_scenario = gplan.per_scenario
        R_max = max(len(gs) for gs in groups_per_bid) * J
        pshape = (B, S, R_max, L) if per_scenario else (B, R_max, L)
        if gplan.device:
            zeros = lambda shape: torch.zeros(  # noqa: E731
                shape, dtype=torch.float32, device=dev)
            arrival_j = _f32(gplan.arrival, dev)
        else:
            zeros, arrival_j = np.zeros, gplan.arrival
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
                z_t[sl] = g.z_t
                d_eff[sl] = g.d_eff
                pins[sl] = g.pins
        AC = [batch.stacked(bid) for bid in bids]
        res = pc.policy_cost_chain(
            torch.stack([a for a, _ in AC]), torch.stack([c for _, c in AC]),
            *(_f32(a, dev) for a in (arrival, ends, z_t, d_eff, pins)),
            slot=slot, p_od=p_od)
        for key in pc.OUT_KEYS:
            vals = _host(res[key])                       # (B, S, R_max)
            for bi, groups in enumerate(groups_per_bid):
                per_g = vals[bi, :, :len(groups) * J].reshape(
                    S, len(groups), J)
                for gi, g in enumerate(groups):
                    out[key][:, :, g.policy_idx] = per_g[:, gi, :, None]
        return

    for bid, groups in zip(bids, groups_per_bid):
        A, C = batch.stacked(bid)                        # (S, n_slots+1)
        starts = concat_rows([g.plan.starts for g in groups])
        ends = concat_rows([g.plan.ends for g in groups])
        R = starts.shape[0]
        if gplan.per_scenario:
            z_t = scenario_cat(groups, "z_t", S).reshape(S, R * L)
            d_eff = scenario_cat(groups, "d_eff", S).reshape(S, R * L)
        else:
            z_t = concat_rows([g.z_t for g in groups]).reshape(R * L)
            d_eff = concat_rows([g.d_eff for g in groups]).reshape(R * L)
        res = pc.policy_cost(
            A, C, *(_f32(a, dev) for a in (starts.reshape(R * L),
                                           ends.reshape(R * L), z_t, d_eff)),
            slot=slot, p_od=p_od)
        for key in pc.OUT_KEYS:
            v = _host(res[key]).reshape(S, len(groups), J, L).sum(axis=3)
            for gi, g in enumerate(groups):
                out[key][:, :, g.policy_idx] = v[:, gi, :, None]
