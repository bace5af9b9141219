"""Eq. (11) of the paper (Section 4.2.1): f(x), the minimum number of
self-owned instances that lets a task finish on spot alone when spot
availability is x — the core of the self-owned allocation policy (12),
r_i = min{f(beta_0), N(window), delta_i} (``scheduler._selfowned_counts_vec``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["f_selfowned"]


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
