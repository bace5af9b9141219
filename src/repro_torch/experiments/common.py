"""Shared harness of the paper-table drivers (Experiments 1-3), on the port.

Job streams and markets follow Section 6.1 and the reference's
``benchmarks/common.py``: jobs from ``seed``, S market scenarios of one
materialized family (``--scenario-kind``: fresh, regime or adversarial)
from ``seed + 1000`` (S = 1 is the paper's single market). The policy
sweeps run on the card (``device="cuda"``, the default) or, when asked,
on the CPU through the kernels' plain versions; the Greedy benchmark is
host float64 either way.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import generate_chain_jobs, run_greedy, sweep_policies
from repro_torch.core.scheduler import Policy
from repro_torch.device import resolve_device
from repro_torch.engine import make_scenarios

__all__ = ["Setup", "make_setup", "sweep_min", "greedy_min",
           "argparser", "print_table", "Timer", "SCENARIO_KINDS"]

# The materialized scenario families (the reference's streamed ``adaptive``
# kind needs scenario chunks, ROADMAP A6).
SCENARIO_KINDS = ("fresh", "regime", "adversarial")


class Setup:
    """One job stream, its market scenarios and the device the sweeps
    run on."""

    def __init__(self, jobs, markets, device="cuda"):
        self.jobs = jobs
        self.markets = markets          # list of SpotMarket
        self.device = device


def make_setup(n_jobs: int, job_type: int, seed: int = 0,
               scenarios: int = 1, scenario_kind: str = "fresh",
               device="cuda") -> Setup:
    """Job stream + S market scenarios (S=1 reproduces the paper setup).

    ``scenario_kind`` is a materialized family of ``make_scenarios``
    (which refuses ``"adaptive"``: it needs streamed scenario chunks).
    Raises before any work when ``device`` is the card and none is
    visible.
    """
    resolve_device(device)
    jobs = generate_chain_jobs(n_jobs, job_type, seed=seed)
    horizon = max(j.deadline for j in jobs) + 1.0
    markets = make_scenarios(horizon, max(scenarios, 1), seed=seed + 1000,
                             kind=scenario_kind)
    return Setup(jobs, markets, device)


def sweep_min(setup: Setup, policies: list[Policy], **kwargs):
    """min over a policy grid of the realized average unit cost: one
    batched engine pass over policies x bids x scenarios (the alpha of each
    policy is its scenario mean); see ``repro_torch.core.sweep_policies``."""
    kwargs.setdefault("device", setup.device)
    pol, alpha, costs, _ = sweep_policies(setup.jobs, policies,
                                          setup.markets, **kwargs)
    return pol, alpha, costs


def greedy_min(setup: Setup, bids) -> float:
    """min over bids of the (scenario-mean) Greedy benchmark alpha."""
    return min(
        float(np.mean([run_greedy(setup.jobs, b, m).average_unit_cost()
                       for m in setup.markets]))
        for b in bids)


def argparser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--jobs", type=int, default=1500,
                   help="jobs per stream (paper: ~10000)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--types", type=int, nargs="+", default=[1, 2, 3, 4])
    p.add_argument("--r", type=int, nargs="+", default=[300, 600, 900, 1200])
    p.add_argument("--scenarios", type=int, default=1,
                   help="market scenarios evaluated in one engine pass "
                        "(1 = the paper's single market)")
    p.add_argument("--scenario-kind", choices=SCENARIO_KINDS,
                   default="fresh",
                   help="market family (adversarial = lure/spike square "
                        "waves driving worst-case TOLA regret)")
    p.add_argument("--device", default="cuda",
                   help="where the policy sweeps run (cuda, or cpu for the "
                        "kernels' plain versions)")
    return p


def print_table(title: str, header: list[str], rows: list[list[str]]):
    print(f"\n== {title} ==")
    print(",".join(header))
    for r in rows:
        print(",".join(str(x) for x in r))


class Timer:
    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        print(f"[{self.label}: {time.perf_counter() - self.t0:.1f}s]")
