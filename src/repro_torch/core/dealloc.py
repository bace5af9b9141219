"""Algorithm 1 — Dealloc(x): optimal deadline (time-window) allocation.

Given a chain job and a parameter x (the spot availability ``beta``, or the
self-owned sufficiency index ``beta_0`` when self-owned instances are
sufficient — Alg. 2 lines 1–5), distribute the slack
``omega = (d_j - a_j) - sum_i e_i`` greedily to tasks in non-increasing order
of parallelism bound ``delta_i``, capping each task's extra time at
``e_i/x - e_i`` (beyond which its spot-processed workload saturates at z_i,
Prop 4.2). This solves ILP (10) exactly (Prop 4.3), in O(l log l).

The expected spot-processed workload for a window size ``hat_s = e + x_slack``
is (Prop 4.2 / 4.5):

    z_o(hat_s) = min(z, x/(1-x) * delta * x_slack)        for x < 1
    z_o(hat_s) = z  for any hat_s >= e                     for x == 1
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Allocation, ChainJob

__all__ = [
    "dealloc",
    "window_sizes",
    "window_sizes_batch",
    "window_sizes_batch_device",
    "expected_spot_work",
    "expected_spot_work_device",
    "allocation_windows",
]

# Named epsilon guards (DESIGN.md §5/§6).
# _FEAS_EPS: f64 noise floor on the slack omega = window - sum(e) — windows
# are sums of the same task arrays, so a truly infeasible job sits well
# below -1e-9 while round-off sits within it.
_FEAS_EPS = 1e-9
# _CAP_EPS: the x == 1 / fully-capped knife edge of Prop 4.5. sizes == e
# holds exactly in f64 when x == 1 (cap = e/x - e = 0), so 1e-12 only
# absorbs the one-ulp blur of the waterfill's subtract-compare.
_CAP_EPS = 1e-12


def window_sizes(job: ChainJob, x: float) -> np.ndarray:
    """Return optimal window sizes hat_s_i for every task (Algorithm 1).

    x in (0, 1]. With x == 1 every task is expected to finish on spot alone in
    its minimum window, so all slack is parked on the highest-delta task
    (cost-neutral in expectation; keeps windows well formed).
    """
    if not 0.0 < x <= 1.0:
        raise ValueError(f"Dealloc parameter must be in (0, 1], got {x}")
    e = job.e_array()
    delta = job.delta_array()
    l = job.l
    omega = job.window - float(e.sum())
    if omega < -_FEAS_EPS:
        raise ValueError(
            f"infeasible job: window {job.window} < critical path {e.sum()}"
        )
    omega = max(omega, 0.0)

    sizes = e.copy()  # line 1: hat_s_i* = e_i
    # line 3: consider tasks in non-increasing order of parallelism bound.
    order = np.argsort(-delta, kind="stable")
    # Cap per task: e_i/x - e_i (zero when x == 1).
    cap = e / x - e
    for idx in order:
        if omega <= 0.0:
            break
        give = min(cap[idx], omega)
        sizes[idx] += give
        omega -= give
    if omega > 0.0:
        # All tasks saturated; park the residual slack on the task with the
        # largest delta (it changes nothing in expectation — z_o stays z).
        sizes[order[0]] += omega
    return sizes


def window_sizes_batch(
    e: np.ndarray,
    delta: np.ndarray,
    mask: np.ndarray,
    omega: np.ndarray,
    xs: np.ndarray,
) -> np.ndarray:
    """Algorithm 1 over a whole (params x jobs) grid in one array pass.

    ``e``/``delta``/``mask``: (J, L) padded task arrays (e = 0 off-mask);
    ``omega``: (J,) per-job slack, computed by the caller exactly as the
    sequential path does (``job.window - float(e.sum())``); ``xs``: (G,)
    Dealloc parameters. Returns (G, J, L) window sizes, **bit-identical** to
    looping ``window_sizes`` — the greedy waterfill runs as a short loop over
    sorted task positions so every job sees the same float operations in the
    same order as the sequential scan (a closed-form prefix-sum variant would
    drift in the last ulp).
    """
    e = np.asarray(e, dtype=np.float64)
    delta = np.asarray(delta, dtype=np.float64)
    xs = np.asarray(xs, dtype=np.float64)
    J, L = e.shape
    G = len(xs)
    if np.any((xs <= 0.0) | (xs > 1.0)):
        bad = xs[(xs <= 0.0) | (xs > 1.0)][0]
        raise ValueError(f"Dealloc parameter must be in (0, 1], got {bad}")
    if np.any(omega < -_FEAS_EPS):
        raise ValueError("infeasible job: window < critical path")
    omega = np.maximum(np.asarray(omega, dtype=np.float64), 0.0)

    # Non-increasing delta among real tasks (stable, matching the sequential
    # argsort(-delta)); padding sorts last and has cap 0 so it never takes
    # slack — the residual parks on sorted position 0, the max-delta task.
    order = np.argsort(np.where(mask, -delta, np.inf), axis=1, kind="stable")
    e_s = np.take_along_axis(e, order, axis=1)                 # (J, L)
    cap = e_s[None, :, :] / xs[:, None, None] - e_s[None, :, :]  # (G, J, L)
    sizes_s = np.broadcast_to(e_s, (G, J, L)).copy()
    rem = np.broadcast_to(omega, (G, J)).copy()
    for k in range(L):
        if not rem.any():
            break  # slack exhausted everywhere: the rest is give = 0.0
        give = np.minimum(cap[:, :, k], rem)
        sizes_s[:, :, k] += give
        rem -= give
    sizes_s[:, :, 0] += rem  # all caps saturated: park residual on max delta
    out = np.empty((G, J, L))
    np.put_along_axis(out, np.broadcast_to(order[None], (G, J, L)), sizes_s,
                      axis=2)
    return out


def window_sizes_batch_device(
    e: torch.Tensor,
    delta: torch.Tensor,
    mask: torch.Tensor,
    omega: torch.Tensor,
    xs: torch.Tensor,
) -> torch.Tensor:
    """Algorithm 1 over a (params x jobs) grid on the device: the twin of
    the reference's ``window_sizes_batch_jax`` (``_jax_impls()["batch"]``).

    Float32 tensors on one device: ``e``/``delta``/``mask`` (J, L),
    ``omega`` (J,), ``xs`` (G,); returns (G, J, L) window sizes. The same
    greedy waterfill as :func:`window_sizes_batch`, a loop over the L sorted
    task positions (the reference's ``lax.scan``), one IEEE operation at a
    time, so the card and the CPU give the same bits. Parity with the
    float64 host pass is float-level, not bitwise. The caller validates
    ``omega`` and ``xs`` (device code would clamp instead of raising).
    """
    G = xs.shape[0]
    J, L = e.shape
    inf = torch.full_like(delta, float("inf"))
    order = torch.argsort(torch.where(mask, -delta, inf), dim=1, stable=True)
    e_s = torch.gather(e, 1, order)
    cap = e_s[None] / xs[:, None, None] - e_s[None]
    rem = torch.clamp_min(omega, 0.0)[None].expand(G, J)
    sizes_s = torch.empty((G, J, L), dtype=e.dtype, device=e.device)
    for k in range(L):
        give = torch.minimum(cap[:, :, k], rem)
        rem = rem - give
        sizes_s[:, :, k] = e_s[None, :, k] + give
    # All caps saturated: the residual parks on the max-delta task.
    sizes_s[:, :, 0] = sizes_s[:, :, 0] + rem
    inv = torch.argsort(order, dim=1)
    return torch.gather(sizes_s, 2, inv[None].expand(G, J, L))


def expected_spot_work_device(z: torch.Tensor, delta: torch.Tensor,
                              sizes: torch.Tensor, x) -> torch.Tensor:
    """z_o of Prop 4.2/4.5 on the device: the twin of the reference's
    ``expected_spot_work_jax``. ``x`` may be a tensor and broadcasts (whole
    parameter grids at once). Float32; parity with the float64 host
    version is float-level."""
    x = torch.as_tensor(x, dtype=z.dtype, device=z.device)
    e = z / delta
    # x >= 1: any feasible window finishes on spot alone (Prop 4.5). The
    # x < 1 branch guards the 1/(1-x) pole so it stays finite (and
    # irrelevant) where the predicate selects the saturated branch.
    frac = x / torch.clamp_min(1.0 - x, 1e-30)
    capped = torch.minimum(z, frac * delta * torch.clamp_min(sizes - e, 0.0))
    full = torch.where(sizes >= e - _CAP_EPS, z, torch.zeros_like(z))
    return torch.where(x >= 1.0 - _CAP_EPS, full, capped)


def expected_spot_work(
    z: np.ndarray | float,
    delta: np.ndarray | float,
    sizes: np.ndarray | float,
    x: float,
) -> np.ndarray:
    """Vectorized z_o of Prop 4.2/4.5 for window sizes ``sizes``."""
    z = np.asarray(z, dtype=np.float64)
    delta = np.asarray(delta, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.float64)
    e = z / delta
    if x >= 1.0:
        return np.where(sizes >= e - _CAP_EPS, z, 0.0)
    slack = np.maximum(sizes - e, 0.0)
    return np.minimum(z, x / (1.0 - x) * delta * slack)


def allocation_windows(job: ChainJob, sizes: np.ndarray) -> tuple[tuple[float, float], ...]:
    """Chain windows from sizes: task i runs in [s_{i-1}, s_i] (Eq. 4)."""
    bounds = job.arrival + np.concatenate([[0.0], np.cumsum(sizes)])
    return tuple((float(bounds[i]), float(bounds[i + 1])) for i in range(job.l))


def dealloc(job: ChainJob, x: float, r: np.ndarray | None = None) -> Allocation:
    """Full Allocation from Algorithm 1 (self-owned counts default to zero)."""
    sizes = window_sizes(job, x)
    windows = allocation_windows(job, sizes)
    if r is None:
        r_t = tuple(0.0 for _ in range(job.l))
    else:
        r_t = tuple(float(v) for v in r)
    return Allocation(job=job, windows=windows, r=r_t)
