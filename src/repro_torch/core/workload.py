"""Paper Section 6.1 workload generator.

* Job arrivals: Poisson process, rate 4 per unit time.
* Tasks per job: l drawn uniformly from {7, 49}.
* DAG edges: each (i1 < i2) pair independently with probability 0.5; tasks
  without successors/predecessors get one random connection to keep the DAG
  connected (paper's exact construction — generation order IS the topological
  order).
* Parallelism bound: delta_i uniform over {8, 64}.
* Minimum execution time e_i: bounded (generalized) Pareto, shape 7/8,
  scale 7/32, location 1/4, truncated to [2, 10] via exact inverse CDF.
* Task size: z_i = e_i * delta_i.
* Relative deadline: x * e_c (critical path), x uniform on [1, x0] with
  x0 in {1.5, 2, 2.5, 3} for job types 1..4.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.transform import transform
from repro_torch.core.types import ChainJob, DAGJob, Task

__all__ = ["JOB_TYPE_X0", "sample_bounded_pareto", "generate_dag_jobs", "generate_chain_jobs"]

JOB_TYPE_X0 = {1: 1.5, 2: 2.0, 3: 2.5, 4: 3.0}

# Bounded-Pareto parameters for e_i (paper Section 6.1).
PARETO_SHAPE = 7.0 / 8.0
PARETO_SCALE = 7.0 / 32.0
PARETO_LOC = 1.0 / 4.0
E_MIN, E_MAX = 2.0, 10.0

ARRIVAL_RATE = 4.0          # jobs per unit time
TASK_COUNTS = (7, 49)
PARALLELISM = (8.0, 64.0)


def _gpd_cdf(x: np.ndarray, xi: float, sigma: float, mu: float) -> np.ndarray:
    return 1.0 - np.power(1.0 + xi * (x - mu) / sigma, -1.0 / xi)


def _gpd_icdf(u: np.ndarray, xi: float, sigma: float, mu: float) -> np.ndarray:
    return mu + sigma / xi * (np.power(1.0 - u, -xi) - 1.0)


def sample_bounded_pareto(rng: np.random.Generator, n: int) -> np.ndarray:
    """e_i ~ generalized Pareto truncated to [E_MIN, E_MAX], exact inverse CDF."""
    lo = _gpd_cdf(np.array(E_MIN), PARETO_SHAPE, PARETO_SCALE, PARETO_LOC)
    hi = _gpd_cdf(np.array(E_MAX), PARETO_SHAPE, PARETO_SCALE, PARETO_LOC)
    u = lo + rng.random(n) * (hi - lo)
    return _gpd_icdf(u, PARETO_SHAPE, PARETO_SCALE, PARETO_LOC)


def _random_dag_edges(rng: np.random.Generator, l: int) -> list[list[int]]:
    """preds[i] per the paper's construction; indices are topological."""
    adj = rng.random((l, l)) < 0.5
    adj = np.triu(adj, k=1)  # adj[i1, i2] edge i1 -> i2, i1 < i2
    # Connectivity fixes: childless non-terminal tasks get a random successor;
    # parentless non-initial tasks get a random predecessor.
    for i in range(l - 1):
        if not adj[i, i + 1:].any():
            adj[i, rng.integers(i + 1, l)] = True
    for i in range(1, l):
        if not adj[:i, i].any():
            adj[rng.integers(0, i), i] = True
    return [list(np.nonzero(adj[:, i])[0]) for i in range(l)]


def generate_dag_jobs(
    n_jobs: int,
    job_type: int,
    seed: int = 0,
) -> list[DAGJob]:
    rng = np.random.default_rng(seed)
    x0 = JOB_TYPE_X0[job_type]
    arrivals = np.cumsum(rng.exponential(1.0 / ARRIVAL_RATE, n_jobs))
    jobs: list[DAGJob] = []
    for j in range(n_jobs):
        l = int(rng.choice(TASK_COUNTS))
        e = sample_bounded_pareto(rng, l)
        delta = rng.choice(PARALLELISM, l)
        tasks = tuple(Task(z=float(e[i] * delta[i]), delta=float(delta[i]))
                      for i in range(l))
        preds = tuple(tuple(p) for p in _random_dag_edges(rng, l))
        job = DAGJob(arrival=float(arrivals[j]), deadline=float(arrivals[j]) + 1.0,
                     tasks=tasks, preds=preds)
        x = rng.uniform(1.0, x0)
        job = DAGJob(arrival=job.arrival,
                     deadline=job.arrival + x * job.critical_path,
                     tasks=tasks, preds=preds)
        jobs.append(job)
    return jobs


def generate_chain_jobs(
    n_jobs: int,
    job_type: int,
    seed: int = 0,
) -> list[ChainJob]:
    """DAG jobs passed through the Nagarajan transform (Algorithm 3)."""
    return [transform(j) for j in generate_dag_jobs(n_jobs, job_type, seed)]
