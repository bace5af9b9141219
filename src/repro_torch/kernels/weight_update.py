"""Hedge weight-update replay (paper Alg. 4 over a precomputed cost tensor):
the kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/weight_update.py::hedge_replay``
(``_hedge_kernel`` via ``_hedge_call``). The full-information update does
not depend on the sampled trace, so each (scenario, schedule) instance
factors into a sequential trajectory pass and a parallel sampling pass
(see ``csrc/hedge_replay.cu``).

On the H100 the trajectory pass is one block per instance stepping through
the J update events, so it is bound by the latency of J dependent steps
(a load, a block-wide max and a barrier each), not by bytes or operations;
the next cost row is loaded before the current reduction to overlap them.
The trajectory (J+1, P) per instance does not fit one SM's shared memory
at J = 10000, so it goes to a device scratch the wrapper allocates. The
sampling pass is one warp per (instance, job): direct loads of trajectory
row ``n_done[j]`` and a warp scan replace the TPU kernel's one-hot matmul
gather and triangular-matmul cumsum.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.device import kernel_library
from repro_torch.kernels import LAUNCHES

__all__ = ["hedge_replay", "hedge_replay_plain"]


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


def hedge_replay(C, etas, u, n_done):
    """Fused Hedge replay over a (S, J, P) cost tensor, one launch.

    ``C``: (S, J, P) unit costs; ``etas``: (K, J) per-update learning
    rates (one row per schedule instance); ``u``: (S, J) uniform streams;
    ``n_done``: (J,) int32 updates applied before each job's sample.
    Returns ``chosen`` (S, K, J) int64, ``p_chosen`` and ``expected_cost``
    (S, K, J) and the final log-weights ``logw`` (S, K, P), float32 for
    the kernel. CPU tensors take the plain version; CUDA tensors launch
    the kernel.
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
    fn = kernel_library("hedge_replay").hedge_replay_launch
    fn.restype = ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    rc = fn(*map(ptr, (C, etas, u, n_done, traj, chosen, p_chosen, expected,
                       logw)),
            ctypes.c_int(S), ctypes.c_int(K), ctypes.c_int(J), ctypes.c_int(P),
            ctypes.c_float(-math.log(P)),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"hedge_replay_launch: CUDA error {rc} at launch")
    LAUNCHES["hedge_replay"] += 1
    return {"chosen": chosen.long(), "p_chosen": p_chosen,
            "expected_cost": expected, "logw": logw}
