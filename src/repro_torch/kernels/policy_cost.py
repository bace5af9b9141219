"""Closed-form task costs over a realized market: the engine's two cost
kernels and their plain PyTorch versions.

Replaces the TPU kernels ``repro/kernels/policy_cost.py::policy_cost_chain``
(``_chain_kernel``) and ``::policy_cost`` (``_kernel``). Each task is the
closed form of ``core/simulate.py`` against one (bid, scenario)'s cumulative
arrays A (availability), C (spot payment) and H = k*slot - A: interpolate A
and C at the start, invert H for the turning time and A for the spot-alone
finish, apply the flexibility epsilon, interpolate again at the end.

On the H100 (``csrc/policy_cost.cu``) each active task's two binary
searches are what bound it: about 49 x 32 dependent probes per chain row.
Chains take one of two kernels by a route rule (``chain_plan``):

* ``"smem"`` wherever a (bid, scenario)'s A fits one block's shared memory
  (232448 bytes: up to 58111 slots, Table 6 has 33021): one block per
  (bid, scenario) slice of rows, persistent at about one block per SM,
  stages A once and computes each probed H from it, so the searches never
  leave the SM; a task with no work skips the closed form (its outputs are
  fixed). C is read through L2.
* ``"global"`` for a longer horizon: one thread per (bid, scenario,
  row), the L-window recurrence inside the thread, A/C/H read through L2.

Planned starts take one kernel at any horizon (``task_tree_kernel``): the
A and H searches walk the same ``lower_bound`` tree, whose top levels (A
and H at their nodes, the intervals below them: 16 KB) each block keeps in
shared memory; they finish ATen's loop on the interval reached through
L1/L2, computing H per probe. A grid of blocks that fills the SMs once
(``task_plan``), each on an even share of one scenario's tasks. The
wrapper launches that one kernel and nothing else on the device.

The TPU's comparison counts over 2048-slot chunks and one-hot matmul
gathers become ``lower_bound`` searches and direct loads. Plans are
passed window-major ((B, Sp, L, R)) so a warp's loads of one window are
coalesced; scenario-shared plans are read through a scenario stride of 0.

Semantics (kernels and plain version alike, as in ``_chain_kernel``): a
position is ``lower_bound`` over the n+1 unpadded entries (``torch.
searchsorted(side="left")``); a position past n means +inf, and an A
target <= 0 means t = 0. H is ``h_cum``'s f32 product and subtraction, which
the shared-memory chain kernel and the task kernel repeat per probe (the
task kernel also at its tree's nodes); all are bit-equal.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.simulate import _WORK_EPS, FLEX_ABS, FLEX_REL
from repro_torch.device import kernel_library
from repro_torch.kernels import LAUNCHES
from repro_torch.obs.compiled import record_launch

__all__ = ["policy_cost_chain", "policy_cost_chain_plain", "policy_cost",
           "policy_cost_plain", "h_cum", "chain_plan", "ChainPlan",
           "task_plan", "task_layout", "OUT_KEYS", "task_ops", "chain_work",
           "task_work"]

OUT_KEYS = ("spot_cost", "ondemand_cost", "spot_work", "ondemand_work")
_F32 = torch.float32
SMEM_PER_BLOCK = 232448     # shared memory a block may opt in to on sm_90
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """How one chain call launches: the route (``"smem"`` or ``"global"``),
    the bytes of one (bid, scenario)'s A, which the rule weighs against a
    block's shared memory, and on the shared-memory route the blocks per
    (bid, scenario) (0 on the global route)."""
    route: str
    a_bytes: int
    blocks_per_pair: int


def chain_plan(B: int, S: int, Sp: int, R: int, L: int, n_slots: int,
               sms: int = H100_SMS) -> ChainPlan:
    """The chain route rule. A (bid, scenario)'s A of n_slots + 1 floats
    that fits one block's shared memory takes the shared-memory kernel:
    the B x S pairs share the card's ``sms`` SMs, one block per SM, each
    pair's blocks striding over its R rows (``csrc/policy_cost.cu`` fixes
    the block size and drops blocks that would find no row). A longer
    horizon takes the global-memory kernel, one thread per row. (``Sp``,
    ``R`` and ``L`` size the plans, not the choice.)"""
    if min(B, S, Sp, n_slots) < 1 or min(R, L) < 0 or Sp not in (1, S):
        raise ValueError("chain_plan: need B, S, n_slots >= 1, R, L >= 0 "
                         "and Sp in (1, S)")
    a_bytes = 4 * (n_slots + 1)
    if a_bytes <= SMEM_PER_BLOCK:
        return ChainPlan("smem", a_bytes, max(1, sms // (B * S)))
    return ChainPlan("global", a_bytes, 0)


def task_plan(S: int, T: int, threads: int, blocks_per_sm: int,
              sms: int = H100_SMS) -> int:
    """Blocks per scenario of a task call: the grid fills the card's
    ``sms`` SMs once at the ``blocks_per_sm`` the kernel's occupancy allows
    (``task_layout``), shared out over the S scenarios, at least one each
    and none without a task of its own (``threads`` per block)."""
    if min(S, threads, blocks_per_sm, sms) < 1 or T < 0:
        raise ValueError("task_plan: need S, threads, blocks_per_sm, sms "
                         ">= 1 and T >= 0")
    return max(1, min(sms * blocks_per_sm // S, -(-T // threads)))


def h_cum(A: torch.Tensor, slot: float) -> torch.Tensor:
    """H = k * slot - A in f32 (non-decreasing up to an f32 ulp)."""
    return torch.arange(A.shape[-1], dtype=_F32, device=A.device) * slot - A


@functools.lru_cache(maxsize=64)  # bounded: one entry per slot length
def inverse_slot(slot: float) -> float:
    """1/slot rounded to float32. The reference's programs divide by the
    slot constant, which XLA compiles to a multiply by this reciprocal;
    the kernels and the plain versions multiply by it too."""
    return float(np.float32(1.0) / np.float32(slot))


def _interp(cum, k, frac, inv_slot):
    c0 = torch.gather(cum, -1, k)
    c1 = torch.gather(cum, -1, k + 1)
    return c0 + (c1 - c0) * inv_slot * frac


def _closed_form(A, C, H, start, end, z_t, d_eff, slot, p_od):
    """Per-task closed form; A/C/H (..., n+1), task arrays (..., T) with the
    same leading dims. Returns (spot_cost, ondemand_cost, spot_work,
    ondemand_work, finish)."""
    n = A.shape[-1] - 1
    inv_slot = inverse_slot(slot)
    inf = torch.tensor(float("inf"), dtype=_F32, device=A.device)
    zero = torch.zeros((), dtype=_F32, device=A.device)
    need = z_t / torch.where(d_eff > 0, d_eff, torch.ones_like(d_eff))
    k0 = (start * inv_slot).to(torch.int64).clamp(0, n - 1)
    frac = start - k0.to(_F32) * slot
    A0 = _interp(A, k0, frac, inv_slot)
    C0 = _interp(C, k0, frac, inv_slot)
    H0 = start - A0
    h_target = H0 + (end - start) - need
    a_target = A0 + need
    cnt_h = torch.searchsorted(H, h_target.contiguous(), side="left")
    cnt_a = torch.searchsorted(A, a_target.contiguous(), side="left")
    i_h = cnt_h.clamp(1, n)
    i_a = cnt_a.clamp(1, n)
    h_prev = torch.gather(H, -1, i_h - 1)
    a_prev = torch.gather(A, -1, i_a - 1)
    no_flex = (end - start) - need <= torch.maximum(
        FLEX_REL * (end - start), FLEX_ABS * end).clamp_min(_WORK_EPS)
    t_turn = (i_h - 1).to(_F32) * slot + (h_target - h_prev)
    t_turn = torch.where(no_flex, start, t_turn)
    t_turn = torch.where((cnt_h > n) & ~no_flex, inf, t_turn)
    t_fin = (i_a - 1).to(_F32) * slot + (a_target - a_prev)
    t_fin = torch.where(a_target <= 0.0, zero, t_fin)
    t_fin = torch.where(cnt_a > n, inf, t_fin)
    on_spot = t_fin <= t_turn
    t_end = torch.minimum(torch.where(on_spot, t_fin, t_turn), end)
    ke = (t_end * inv_slot).to(torch.int64).clamp(0, n - 1)
    frace = t_end - ke.to(_F32) * slot
    A_end = _interp(A, ke, frace, inv_slot)
    C_end = _interp(C, ke, frace, inv_slot)
    active = z_t > _WORK_EPS
    spot_work = torch.minimum(d_eff * (A_end - A0).clamp_min(0.0), z_t)
    spot_cost = d_eff * (C_end - C0).clamp_min(0.0)
    od_work = z_t - spot_work
    return (torch.where(active, spot_cost, zero),
            torch.where(active, p_od * od_work, zero),
            torch.where(active, spot_work, zero),
            torch.where(active, od_work, zero),
            torch.where(active, torch.where(on_spot, t_fin, end), start))


def _per_scenario(a: torch.Tensor) -> torch.Tensor:
    """(B, R, L) shared plans -> (B, 1, R, L); (B, S, R, L) passes."""
    return a.unsqueeze(1) if a.dim() == 3 else a


def policy_cost_chain_plain(A, C, arrival, ends, z_t, d_eff, pins, *,
                            slot: float = 1.0 / 12.0, p_od: float = 1.0):
    """Plain PyTorch version of :func:`policy_cost_chain` (same arguments,
    same results); ported from ``kernels/ref.py::chain_costs_ref``."""
    B, S, _ = A.shape
    R, L = ends.shape[-2:]
    z_t, d_eff, pins = map(_per_scenario, (z_t, d_eff, pins))
    H = h_cum(A, slot)
    shape = (B, S, R)
    zero = torch.zeros((), dtype=_F32, device=A.device)
    cur = arrival[:, None, :].expand(shape)
    acc = [torch.zeros(shape, dtype=_F32, device=A.device) for _ in OUT_KEYS]
    for k in range(L):
        end = ends[:, None, :, k].expand(shape)
        z_raw = z_t[..., k].expand(shape)
        d_k = d_eff[..., k].clamp_min(0.0).expand(shape)
        pin = (pins[..., k] > 0.5).expand(shape)
        live = end > cur - _WORK_EPS
        start = torch.minimum(cur, end)
        *costs, fin = _closed_form(A, C, H, start, end,
                                   torch.where(live, z_raw, zero), d_k,
                                   slot, p_od)
        acc = [a + c for a, c in zip(acc, costs)]
        fin = torch.where(pin, end, fin)
        cur = torch.where((z_raw > _WORK_EPS) | pin, fin, cur)
    return dict(zip(OUT_KEYS, acc))


def _check(named: dict, device: torch.device) -> None:
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != _F32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The C entry points of csrc/policy_cost.cu: pointers, then the shapes and
# the scalars; every launch ends with the stream.
_SIGNATURES = {
    "policy_cost_chain_smem_launch": [_P] * 8 + [_I] * 6 + [_F] * 6
    + [_I, _P],
    "policy_cost_chain_launch": [_P] * 9 + [_I] * 6 + [_F] * 6 + [_P],
    "policy_cost_launch": [_P] * 7 + [_I] * 4 + [_F] * 6 + [_I, _P],
    "policy_cost_task_layout": [_I, ctypes.POINTER(_I)],
}
TASK_LAYOUT_KEYS = ("threads", "blocks_per_sm", "depth", "smem_bytes")


@functools.lru_cache(maxsize=len(_SIGNATURES))  # one per C entry point
def _entry(fn_name: str):
    """A C entry point of the library, its ctypes signature set once."""
    fn = getattr(kernel_library("policy_cost"), fn_name)
    fn.restype, fn.argtypes = ctypes.c_int, _SIGNATURES[fn_name]
    return fn


def _launch(fn_name: str, args: list, stream) -> None:
    rc = _entry(fn_name)(*args, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")


def task_ops(n_slots: int) -> int:
    """Operations of one active task: two binary searches of
    ceil(log2(n+2)) comparisons each plus about 60 arithmetic operations
    (four interpolations, the two inversions, the flexibility test and
    the cost sums)."""
    return 2 * math.ceil(math.log2(n_slots + 2)) + 60


def chain_work(B, S, Sp, R, L, n_slots, z_t, pins) -> dict:
    """Work of one chain call (``obs.compiled``'s record): each input read
    once (A, C, arrival, ends, z_t, d_eff, pins), each output written once
    (four (B, S, R) arrays), and ``task_ops`` per active (scenario, task):
    one with work or pinned. ``z_t`` and ``pins`` are the (B, Sp, R, L)
    plans; the active count stays a device tensor (no host sync)."""
    active = ((z_t > 0) | (pins > 0.5)).sum() * (S // Sp)
    return {"bytes": 4 * (2 * B * S * (n_slots + 1) + B * R + B * R * L
                          + 3 * B * Sp * R * L + 4 * B * S * R),
            "ops": {"f32": active * task_ops(n_slots)}}


def task_work(S, Sp, T, n_slots, z_t) -> dict:
    """Work of one planned-start call: inputs A, C, start, end, z_t, d_eff
    read once, the five (S, T) outputs written once, ``task_ops`` per
    (scenario, task) with work; ``z_t`` is (Sp, T)."""
    active = (z_t > 0).sum() * (S // Sp)
    return {"bytes": 4 * (2 * S * (n_slots + 1) + 2 * T + 2 * Sp * T
                          + 5 * S * T),
            "ops": {"f32": active * task_ops(n_slots)}}


# Bounded: one entry per horizon (and card) in use; a miss only asks the
# card again.
@functools.lru_cache(maxsize=256)
def task_layout(n_slots: int, device_index: int = 0) -> dict:
    """The task kernel's layout at ``n_slots`` on a card, as the ``.cu``
    sets it: threads per block, the blocks an SM holds, the search tree's
    levels in shared memory and its bytes per block. Needs the built
    kernel library and the card."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        rc = _entry("policy_cost_task_layout")(n_slots, out)
    if rc:
        raise ValueError(f"policy_cost_task_layout: error {rc} at "
                         f"{n_slots} slots")
    return dict(zip(TASK_LAYOUT_KEYS, out))


@functools.lru_cache(maxsize=16)  # bounded: one entry per card
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def policy_cost_chain(A, C, arrival, ends, z_t, d_eff, pins, *,
                      slot: float = 1.0 / 12.0, p_od: float = 1.0):
    """Early-start CHAIN costs over B bids x S scenarios x R rows.

    A/C: (B, S, n_slots+1) f32 cumulative arrays; arrival: (B, R);
    ends: (B, R, L) planned window ends; z_t/d_eff/pins: (B, R, L) shared
    across scenarios or (B, S, R, L) per scenario (pins as 0/1 floats).
    Rows may be zero-padded (z_t == 0). Returns a dict of (B, S, R) f32
    per-row sums: spot_cost, ondemand_cost, spot_work, ondemand_work.
    CPU tensors take the plain version; CUDA tensors launch the kernel that
    ``chain_plan`` picks.
    """
    z_t, d_eff, pins = map(_per_scenario, (z_t, d_eff, pins))
    if A.device.type == "cpu":
        _chain_shapes(A, C, arrival, ends, z_t, d_eff, pins)
        return policy_cost_chain_plain(A, C, arrival, ends, z_t, d_eff, pins,
                                       slot=slot, p_od=p_od)
    return _chain_on_card(False, A, C, arrival, ends, z_t, d_eff, pins,
                          slot, p_od)


def _chain_global_route(A, C, arrival, ends, z_t, d_eff, pins, *,
                        slot: float = 1.0 / 12.0, p_od: float = 1.0):
    """:func:`policy_cost_chain` through the global-memory kernel
    whatever the horizon, so that ``chip_smoke.py`` can time it on the
    inputs the shared-memory route takes."""
    z_t, d_eff, pins = map(_per_scenario, (z_t, d_eff, pins))
    return _chain_on_card(True, A, C, arrival, ends, z_t, d_eff, pins,
                          slot, p_od)


def _chain_shapes(A, C, arrival, ends, z_t, d_eff, pins):
    """(B, S, Sp, R, L, n_slots) of a chain call, or ValueError."""
    B, S, n1 = A.shape
    R, L = ends.shape[-2:]
    Sp = z_t.shape[1]
    if C.shape != A.shape or arrival.shape != (B, R) \
            or ends.shape != (B, R, L) or Sp not in (1, S) \
            or any(a.shape != (B, Sp, R, L) for a in (z_t, d_eff, pins)):
        raise ValueError("policy_cost_chain: inconsistent shapes")
    return B, S, Sp, R, L, n1 - 1


def _chain_on_card(force_global, A, C, arrival, ends, z_t, d_eff, pins,
                   slot, p_od):
    B, S, Sp, R, L, n_slots = _chain_shapes(A, C, arrival, ends, z_t, d_eff,
                                            pins)
    if A.device.type != "cuda":
        raise ValueError(f"policy_cost_chain has no kernel for {A.device}")
    if n_slots < 1 or max(S, B) > 65535:
        raise ValueError("policy_cost_chain: need n_slots >= 1 and "
                         "B, S <= 65535")
    _check({"A": A, "C": C, "arrival": arrival, "ends": ends, "z_t": z_t,
            "d_eff": d_eff, "pins": pins}, A.device)
    plan = chain_plan(B, S, Sp, R, L, n_slots, _sms(A.device.index))
    A, C, arrival = A.contiguous(), C.contiguous(), arrival.contiguous()
    ends_w = ends.transpose(1, 2).contiguous()             # (B, L, R)
    z_w, d_w, p_w = (a.transpose(2, 3).contiguous()        # (B, Sp, L, R)
                     for a in (z_t, d_eff, pins))
    out = torch.empty((4, B, S, R), dtype=_F32, device=A.device)
    scalars = [B, S, Sp, R, L, n_slots, slot, inverse_slot(slot), p_od,
               FLEX_REL, FLEX_ABS, _WORK_EPS]
    plans = map(torch.Tensor.data_ptr, (arrival, ends_w, z_w, d_w, p_w, out))
    stream = torch.cuda.current_stream(A.device)
    work = lambda: chain_work(B, S, Sp, R, L, n_slots, z_t, pins)  # noqa: E731
    if plan.route == "smem" and not force_global:
        with record_launch(("policy_cost_chain", "policy_cost_chain_smem"),
                           stream, work):
            _launch("policy_cost_chain_smem_launch",
                    [A.data_ptr(), C.data_ptr(), *plans, *scalars,
                     plan.blocks_per_pair], stream)
        LAUNCHES["policy_cost_chain_smem"] += 1
    else:
        H = h_cum(A, slot)                 # held until the launch is queued
        with record_launch("policy_cost_chain", stream, work):
            _launch("policy_cost_chain_launch",
                    [A.data_ptr(), C.data_ptr(), H.data_ptr(), *plans,
                     *scalars], stream)
    LAUNCHES["policy_cost_chain"] += 1
    return dict(zip(OUT_KEYS, out.unbind(0)))


def _task_ondemand_work(oc, sw, z_t, p_od):
    """``ondemand_work`` as ``repro/engine/backend_pallas.py`` derives it
    from the planned-start kernel's outputs."""
    if p_od > 0:
        return oc / p_od
    return (z_t - sw).clamp_min(0.0) * (z_t > _WORK_EPS)


def policy_cost_plain(A, C, start, end, z_t, d_eff, *,
                      slot: float = 1.0 / 12.0, p_od: float = 1.0):
    """Plain PyTorch version of :func:`policy_cost`; ported from
    ``kernels/ref.py::policy_cost_ref``."""
    S = A.shape[0]
    T = start.shape[0]
    H = h_cum(A, slot)
    z_t, d_eff = z_t.expand(S, T), d_eff.expand(S, T)
    sc, oc, sw, _, fin = _closed_form(A, C, H, start.expand(S, T),
                                      end.expand(S, T), z_t, d_eff, slot,
                                      p_od)
    return {"spot_cost": sc, "ondemand_cost": oc, "spot_work": sw,
            "ondemand_work": _task_ondemand_work(oc, sw, z_t, p_od),
            "finish": fin}


def policy_cost(A, C, start, end, z_t, d_eff, *, slot: float = 1.0 / 12.0,
                p_od: float = 1.0):
    """Planned-start task costs of one bid over S scenarios, one launch.

    A/C: (S, n_slots+1) f32; start/end: (T,) planned windows; z_t/d_eff:
    (T,) shared or (S, T) per scenario. Returns a dict of (S, T) f32:
    spot_cost, ondemand_cost, spot_work, ondemand_work, finish.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and nothing else on the device where the inputs are contiguous.
    """
    S, n1 = A.shape
    T = start.shape[0]
    z2, d2 = (a if a.dim() == 2 else a.unsqueeze(0) for a in (z_t, d_eff))
    Sp = z2.shape[0]
    if C.shape != A.shape or end.shape != (T,) or Sp not in (1, S) \
            or z2.shape != (Sp, T) or d2.shape != (Sp, T):
        raise ValueError("policy_cost: inconsistent shapes")
    if A.device.type == "cpu":
        return policy_cost_plain(A, C, start, end, z2, d2, slot=slot,
                                 p_od=p_od)
    if A.device.type != "cuda":
        raise ValueError(f"policy_cost has no kernel for {A.device}")
    if n1 < 2 or S > 65535 or T >= 2 ** 30:
        raise ValueError("policy_cost: need n_slots >= 1, S <= 65535 and "
                         "T < 2**30")
    _check({"A": A, "C": C, "start": start, "end": end, "z_t": z2,
            "d_eff": d2}, A.device)
    ins = [t.contiguous() for t in (A, C, start, end, z2, d2)]
    layout = task_layout(n1 - 1, A.device.index)
    blocks = task_plan(S, T, layout["threads"], layout["blocks_per_sm"],
                       _sms(A.device.index))
    out = torch.empty((5, S, T), dtype=_F32, device=A.device)
    stream = torch.cuda.current_stream(A.device)
    with record_launch("policy_cost", stream,
                       lambda: task_work(S, Sp, T, n1 - 1, z2)):
        _launch("policy_cost_launch",
                [*map(torch.Tensor.data_ptr, (*ins, out)), S, Sp, T, n1 - 1,
                 slot, inverse_slot(slot), p_od, FLEX_REL, FLEX_ABS,
                 _WORK_EPS, blocks], stream)
    LAUNCHES["policy_cost"] += 1
    return dict(zip(OUT_KEYS + ("finish",), out.unbind(0)))
