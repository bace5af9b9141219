"""Policy grids of the paper (Section 6.1): C1 (beta_0), C2 (beta), B (bid).

The Even benchmark is not a separate code path: it is TOLA over
``benchmark_bid_policies`` with ``windows="even"``, ``selfowned="naive"``
and planned starts (see ``repro_torch.experiments.table6``).
"""

from __future__ import annotations

from repro_torch.core.scheduler import Policy

__all__ = [
    "C1_BETA0", "C2_BETA", "B_BIDS",
    "spot_od_policies", "selfowned_policies", "benchmark_bid_policies",
]

C1_BETA0 = (2 / 12, 4 / 14, 6 / 16, 8 / 18, 1 / 2, 0.6, 0.7)
C2_BETA = (1.0, 1 / 1.3, 1 / 1.6, 1 / 1.9, 1 / 2.2)
B_BIDS = (0.18, 0.21, 0.24, 0.27, 0.30)


def spot_od_policies() -> list[Policy]:
    """P = {(beta, b)} — 25 policies (Experiment 1)."""
    return [Policy(beta=b2, bid=b) for b2 in C2_BETA for b in B_BIDS]


def selfowned_policies() -> list[Policy]:
    """P = {(beta_0, beta, b)} — 175 policies (Experiments 2-4)."""
    return [Policy(beta=b2, bid=b, beta0=b0)
            for b0 in C1_BETA0 for b2 in C2_BETA for b in B_BIDS]


def benchmark_bid_policies(beta: float = 0.5, beta0: float | None = None) -> list[Policy]:
    """P' = {b} — the benchmarks are parameterized by bid only."""
    return [Policy(beta=beta, bid=b, beta0=beta0) for b in B_BIDS]
