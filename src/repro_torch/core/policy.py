"""Single-task instance policies (paper Section 4.1.2 / 4.2.1).

* Prop 4.1 — expected-optimal spot/on-demand composition for a task in a
  window: all-spot until the *turning point*, then all-on-demand.
* Eq. (11) — f(x): the minimum number of self-owned instances that lets the
  task finish on spot alone when spot availability is x.
* Eq. (12) — the self-owned allocation policy
  r_i = min{f(beta_0), N(window), delta_i}.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "f_selfowned",
    "selfowned_allocation",
    "spot_ondemand_split",
    "flexibility",
    "turning_point_expected",
]


def f_selfowned(
    z: np.ndarray | float,
    delta: np.ndarray | float,
    size: np.ndarray | float,
    x: np.ndarray | float,
) -> np.ndarray:
    """f(x) of Eq. (11), vectorized (including over x).

    f(x) = max{ (z - delta*size*x) / (size*(1-x)), 0 }.

    Monotone non-increasing in x (Prop 4.4); f(beta) is the minimum self-owned
    count after which the task is expected to finish without on-demand usage.
    For x >= 1 the numerator z - delta*size <= 0 whenever the window is
    feasible (size >= e), so f(1) = 0.
    """
    z = np.asarray(z, dtype=np.float64)
    delta = np.asarray(delta, dtype=np.float64)
    size = np.asarray(size, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    one = x >= 1.0 - 1e-12
    den = size * np.where(one, 1.0, 1.0 - x)
    val = (z - delta * size * x) / np.maximum(den, 1e-300)
    return np.where(one, 0.0, np.maximum(val, 0.0))


def selfowned_allocation(
    z: float,
    delta: float,
    size: float,
    beta0: float,
    available: float,
    integral: bool = True,
) -> float:
    """Policy (12): r_i = min{f(beta_0), N(window), delta_i}.

    ``available`` is N(window) — the minimum pool level across the window.
    With ``integral`` the paper's rounding note applies: we round f up (more
    self-owned is never costlier under Assumption 1) but never above the pool
    or the parallelism bound, and never above ceil(z/size) (instances beyond
    z/size would sit idle the whole window).
    """
    f = float(f_selfowned(z, delta, size, beta0))
    if integral:
        f = float(np.ceil(f - 1e-9))
        available = float(np.floor(available + 1e-9))
    # Never allocate instances that cannot possibly have work in the window.
    useful = z / size if size > 0 else 0.0
    if integral:
        useful = float(np.ceil(useful - 1e-9))
    return max(0.0, min(f, available, delta, useful))


def flexibility(z_rem: float, delta_eff: float, deadline: float, t: float) -> bool:
    """Definition 3.1: task still has flexibility to use spot at time t."""
    if z_rem <= 0.0:
        return False
    if delta_eff <= 0.0:
        return False
    return z_rem / delta_eff < (deadline - t)


@dataclasses.dataclass(frozen=True)
class SpotOndemandSplit:
    """Expected composition per Prop 4.1 for a window of size ``size``."""

    s: float        # spot instances requested in phase 1
    o: float        # on-demand instances in phase 1
    phase2: bool    # whether a phase-2 (all on-demand) is expected
    turning: float | None  # expected turning point offset from window start


def spot_ondemand_split(z: float, delta: float, size: float, beta: float) -> SpotOndemandSplit:
    """Prop 4.1 cases. ``size`` is hat_s_i; ``beta`` the spot availability."""
    e = z / delta
    if size < e - 1e-12:
        raise ValueError(f"window {size} below minimum execution time {e}")
    if beta >= 1.0 or size >= e / beta - 1e-12:
        # Expected to finish on spot alone; no turning point.
        return SpotOndemandSplit(s=delta, o=0.0, phase2=False, turning=None)
    if size <= e + 1e-12:
        # Turning point at the window start: all on-demand.
        return SpotOndemandSplit(s=0.0, o=delta, phase2=True, turning=0.0)
    return SpotOndemandSplit(
        s=delta, o=0.0, phase2=True, turning=turning_point_expected(z, delta, size, beta)
    )


def turning_point_expected(z: float, delta: float, size: float, beta: float) -> float:
    """Expected turning point offset tau from the window start (Appendix A.1).

    In expectation spot processes work at rate beta*delta; remaining work
    z(t) = z - beta*delta*t; the turning point solves
    z - beta*delta*tau = (size - tau) * delta  =>
    tau = (size*delta - z) / (delta * (1 - beta)).
    """
    tau = (size * delta - z) / (delta * (1.0 - beta))
    return float(np.clip(tau, 0.0, size))
