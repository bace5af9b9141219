"""Shared harness of the paper-table drivers (Experiments 1-4), on the port.

Job streams and markets follow Section 6.1 and the reference's
``benchmarks/common.py``: jobs from ``seed``, S market scenarios of one
family (``--scenario-kind``) from ``seed + 1000`` (S = 1 is the paper's
single market). Without ``--scenario-chunk`` the scenarios are the
materialized ``make_scenarios`` list; with it, a ``ScenarioSpec`` streamed
through the engine K scenarios per pass and synthesized on the device
(``adaptive`` needs this path: its adversary reacts at chunk boundaries).
The policy sweeps run on the card (``device="cuda"``, the default) or,
when asked, on the CPU through the kernels' plain versions; the Greedy
benchmark is host float64 either way. ``--mesh N`` shards the sweeps'
scenario axis over N ranks of a ``torch.distributed`` process group
(DESIGN.md §9), clamped with a warning to the ranks there are (1 without
a process group).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import generate_chain_jobs, run_greedy, sweep_policies
from repro_torch.core.scheduler import Policy
from repro_torch.device import resolve_device
from repro_torch.engine import ScenarioSpec, as_source, make_scenarios
from repro_torch.engine.mesh import as_scenario_mesh
from repro_torch.obs import span

__all__ = ["Setup", "make_setup", "sweep_min", "greedy_min",
           "argparser", "print_table", "Timer", "SCENARIO_KINDS"]

# The generative scenario families the drivers offer (``adaptive`` only
# with scenario chunks).
SCENARIO_KINDS = ("fresh", "regime", "adversarial", "adaptive")


class Setup:
    """One job stream, its market scenarios (a materialized list or a
    ``ScenarioSpec``), the device the sweeps run on, the scenario chunk
    they stream with and the mesh they shard over."""

    def __init__(self, jobs, scenarios, device="cuda",
                 scenario_chunk: int | None = None, mesh=None):
        self.jobs = jobs
        self.scenarios = scenarios      # list of SpotMarket | ScenarioSpec
        self.device = device
        self.scenario_chunk = scenario_chunk
        self.mesh = mesh                # GridMesh | int | None
        self._source = as_source(scenarios)

    @property
    def markets(self):
        """Materialized scenario markets (host-only consumers: the Greedy
        baseline, TOLA's realized shared-pool replay)."""
        return self._source.markets


def make_setup(n_jobs: int, job_type: int, seed: int = 0,
               scenarios: int = 1, scenario_kind: str = "fresh",
               device="cuda", scenario_chunk: int | None = None,
               mesh=None) -> Setup:
    """Job stream + S market scenarios (S=1 reproduces the paper setup).

    Without ``scenario_chunk`` the scenarios are the materialized
    ``make_scenarios`` list; with it, a ``ScenarioSpec`` the sweeps stream
    ``scenario_chunk`` scenarios per pass (``"adaptive"`` requires it).
    ``mesh`` (an int shard count from ``--mesh``, a ``GridMesh`` or None)
    is normalised here, so an oversized request warns once, at set-up.
    Raises before any work when ``device`` is the card and none is
    visible.
    """
    resolve_device(device)
    mesh = as_scenario_mesh(mesh)
    if scenario_kind == "adaptive" and scenario_chunk is None:
        raise ValueError(
            "--scenario-kind adaptive needs --scenario-chunk: the adversary "
            "takes chunk-boundary feedback")
    jobs = generate_chain_jobs(n_jobs, job_type, seed=seed)
    horizon = max(j.deadline for j in jobs) + 1.0
    if scenario_chunk is not None:
        scn = ScenarioSpec(scenario_kind, horizon, max(scenarios, 1),
                           seed=seed + 1000)
    else:
        scn = make_scenarios(horizon, max(scenarios, 1), seed=seed + 1000,
                             kind=scenario_kind)
    return Setup(jobs, scn, device, scenario_chunk=scenario_chunk,
                 mesh=mesh)


def sweep_min(setup: Setup, policies: list[Policy], **kwargs):
    """min over a policy grid of the realized average unit cost: one
    batched engine pass over policies x bids x scenarios (the alpha of each
    policy is its scenario mean); see ``repro_torch.core.sweep_policies``.
    The setup's scenario source is reused across sweeps, so a materialized
    list's per-bid views are built once per bid, not once per sweep."""
    kwargs.setdefault("device", setup.device)
    kwargs.setdefault("scenario_chunk", setup.scenario_chunk)
    kwargs.setdefault("mesh", setup.mesh)
    pol, alpha, costs, _ = sweep_policies(setup.jobs, policies,
                                          setup._source, **kwargs)
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
                        "waves driving worst-case TOLA regret; adaptive = "
                        "spikes chosen by watching the learner, needs "
                        "--scenario-chunk)")
    p.add_argument("--scenario-chunk", type=int, default=None,
                   help="stream the scenarios K per engine pass from a "
                        "ScenarioSpec synthesized on the device")
    p.add_argument("--device", default="cuda",
                   help="where the policy sweeps run (cuda, or cpu for the "
                        "kernels' plain versions)")
    p.add_argument("--mesh", type=int, default=None,
                   help="shard the scenario axis over an N-rank mesh of the "
                        "torch.distributed process group (clamped to its "
                        "ranks with a warning; 1 without one)")
    return p


def print_table(title: str, header: list[str], rows: list[list[str]]):
    print(f"\n== {title} ==")
    print(",".join(header))
    for r in rows:
        print(",".join(str(x) for x in r))


class Timer:
    """A span named ``label`` that prints its seconds at exit."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self._span = span(self.label).__enter__()
        return self

    def __exit__(self, *a):
        self._span.__exit__(*a)
        print(f"[{self.label}: {self._span.seconds:.1f}s]")
