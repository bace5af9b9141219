"""Hedge weight-update replay (paper Alg. 4 over a precomputed cost tensor):
the kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/weight_update.py::hedge_replay``
(``_hedge_kernel`` via ``_hedge_call``). The full-information update does
not depend on the sampled trace, so each (scenario, schedule) instance
factors into a sequential trajectory pass and a parallel sampling pass
(see ``csrc/hedge_replay.cu``).

On the H100 the trajectory pass is bound by the dependency chain of its J
steps, not by bytes or operations. One warp runs one instance with its P
log-weights in registers (``nj`` per lane); a step's max is an in-lane max
and one ``redux.sync`` over the lanes on the floats' order-preserving
integer images, exact; the cost rows reach the warps from a shared-memory
ring that cp.async fills stages ahead, shared by the up to four schedules
of one scenario that a block holds (``hedge_plan`` chooses the blocks; the
``.cu`` lays out the registers and the ring, and ``ring`` reports that
layout). The trajectory
(J+1, P) per instance does not fit on chip at J = 10000, so it goes to a
device scratch the wrapper allocates. The sampling pass is one warp per
(instance, job): direct loads of trajectory row ``n_done[j]`` and a warp
scan replace the TPU kernel's one-hot matmul gather and triangular-matmul
cumsum.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.device import kernel_library
from repro_torch.kernels import LAUNCHES
from repro_torch.obs.compiled import record_launch

__all__ = ["hedge_replay", "hedge_replay_plain", "hedge_work", "hedge_plan",
           "HedgePlan", "ring"]

MAX_BLOCK_WARPS = 4         # kMaxBlockWarps: one schedule per scheduler


@dataclasses.dataclass(frozen=True)
class HedgePlan:
    """The trajectory pass's blocks: ``warps`` schedules per block,
    ``groups`` blocks per scenario, ``grid`` = S x groups blocks."""
    warps: int
    groups: int
    grid: int


def hedge_plan(S: int, K: int, J: int, P: int) -> HedgePlan:
    """The trajectory pass's blocks for S scenarios x K schedules, J events
    and P policies: the K warps of a scenario in ``groups`` blocks of at
    most four, as even as they split."""
    if not 1 <= P <= 1024 or min(S, K) < 1 or J < 0:
        raise ValueError("hedge_plan: need 1 <= P <= 1024, S, K >= 1 and "
                         "J >= 0")
    groups = math.ceil(K / min(K, MAX_BLOCK_WARPS))
    return HedgePlan(math.ceil(K / groups), groups, S * groups)


def ring(P: int) -> dict:
    """The trajectory kernel's layout at P policies, as the ``.cu`` sets it:
    ``nj`` log-weights per lane, ``rows`` cost rows per ring stage, a
    stage's bytes and the ring's (``smem_bytes``, per block). Needs the
    built kernel library."""
    out = (ctypes.c_int * 4)()
    rc = kernel_library("hedge_replay").hedge_replay_ring(P, out)
    if rc:
        raise ValueError(f"hedge_replay_ring: error {rc} for P={P}")
    return dict(zip(("nj", "rows", "stage_bytes", "smem_bytes"), out))


def hedge_replay_plain(C, etas, u, n_done):
    """Plain PyTorch version of :func:`hedge_replay`; ported from
    ``kernels/ref.py::hedge_replay_ref`` with the kernel's per-step
    log-space renormalization. Works in the dtype of ``C`` (float32 like
    the kernel, or float64). Also returns ``margin``: the distance of
    ``u * total`` from the nearest cdf step, relative to ``total`` — where
    it is below float32 rounding, two correct versions may draw apart."""
    S, J, P = C.shape
    K = etas.shape[0]
    dt = C.dtype
    etas, u = etas.to(dt), u.to(dt)
    logw = torch.full((S, K, P), -math.log(P), dtype=dt, device=C.device)
    traj = torch.empty((S, K, J + 1, P), dtype=dt, device=C.device)
    traj[:, :, 0] = logw
    for i in range(J):
        logw = logw - etas[None, :, i, None] * C[:, None, i, :]
        logw = logw - logw.amax(dim=-1, keepdim=True)
        traj[:, :, i + 1] = logw
    sel = traj[:, :, n_done.long()]                       # (S, K, J, P)
    sel = sel - sel.amax(dim=-1, keepdim=True)
    p = sel.exp()
    p = p / p.sum(dim=-1, keepdim=True)
    cdf = p.cumsum(dim=-1)
    total = cdf[..., -1:]
    thresh = u[:, None, :, None] * total
    chosen = (cdf <= thresh).sum(dim=-1).clamp_max(P - 1)
    return {
        "chosen": chosen,
        "p_chosen": p.gather(-1, chosen[..., None])[..., 0],
        "expected_cost": (p * C[:, None]).sum(dim=-1),
        "logw": logw,
        "margin": ((cdf - thresh).abs() / total).amin(dim=-1),
    }


def hedge_work(S: int, K: int, J: int, P: int) -> dict:
    """Work of one ``hedge_replay`` call: C, etas, u and n_done read once,
    chosen, p_chosen, expected_cost and logw written once, and 12
    operations per (scenario, instance, job, policy): the trajectory's
    update and normalisation, the sample's distribution and cdf."""
    return {"bytes": 4 * (S * J * P + K * J + S * J + J + 3 * S * K * J
                          + S * K * P),
            "ops": {"f32": 12 * S * K * J * P}}


def hedge_replay(C, etas, u, n_done):
    """Fused Hedge replay over a (S, J, P) cost tensor, one launch.

    ``C``: (S, J, P) unit costs; ``etas``: (K, J) per-update learning
    rates (one row per schedule instance); ``u``: (S, J) uniform streams;
    ``n_done``: (J,) int32 updates applied before each job's sample.
    Returns ``chosen`` (S, K, J) int64, ``p_chosen`` and ``expected_cost``
    (S, K, J) and the final log-weights ``logw`` (S, K, P), float32 for
    the kernel, which also returns its ``trajectory`` (S, K, J+1, P): the
    log-weights after each update. CPU tensors take the plain version;
    CUDA tensors launch the kernel.
    """
    S, J, P = C.shape
    K = etas.shape[0]
    if etas.shape != (K, J) or u.shape != (S, J) or n_done.shape != (J,):
        raise ValueError("hedge_replay: inconsistent shapes")
    if C.device.type == "cpu":
        return hedge_replay_plain(C, etas, u, n_done)
    if C.device.type != "cuda":
        raise ValueError(f"hedge_replay has no kernel for {C.device}")
    if not 1 <= P <= 1024 or S * K > 65535:
        raise ValueError("hedge_replay: need 1 <= P <= 1024 and S*K <= 65535")
    for name, t, dt in (("C", C, torch.float32), ("etas", etas, torch.float32),
                        ("u", u, torch.float32), ("n_done", n_done,
                                                  torch.int32)):
        if t.device != C.device or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} on {C.device}")
    C, etas, u, n_done = (t.contiguous() for t in (C, etas, u, n_done))
    dev = C.device
    traj = torch.empty((S * K, J + 1, P), dtype=torch.float32, device=dev)
    chosen = torch.empty((S, K, J), dtype=torch.int32, device=dev)
    p_chosen = torch.empty((S, K, J), dtype=torch.float32, device=dev)
    expected = torch.empty((S, K, J), dtype=torch.float32, device=dev)
    logw = torch.empty((S, K, P), dtype=torch.float32, device=dev)
    plan = hedge_plan(S, K, J, P)
    fn = kernel_library("hedge_replay").hedge_replay_launch
    fn.restype = ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(dev)
    with record_launch("hedge_replay", stream,
                       lambda: hedge_work(S, K, J, P)):
        rc = fn(*map(ptr, (C, etas, u, n_done, traj, chosen, p_chosen,
                           expected, logw)),
                *map(ctypes.c_int, (S, K, J, P)), ctypes.c_float(-math.log(P)),
                *map(ctypes.c_int, (plan.groups, plan.warps)),
                ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"hedge_replay_launch: CUDA error {rc} at launch")
    LAUNCHES["hedge_replay"] += 1
    return {"chosen": chosen.long(), "p_chosen": p_chosen,
            "expected_cost": expected, "logw": logw,
            "trajectory": traj.view(S, K, J + 1, P)}
