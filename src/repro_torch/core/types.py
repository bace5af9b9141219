"""Core data types for the paper's scheduling problem.

A *job* is a DAG of malleable tasks (Section 3.2 of the paper). Each task i has
a workload ``z_i`` (instance-time), a parallelism bound ``delta_i`` (max number
of instances usable simultaneously) and therefore a minimum execution time
``e_i = z_i / delta_i`` (Eq. 1). A job arrives at ``a_j`` and must finish by its
deadline ``d_j``.

After the Nagarajan transform (Appendix B.1) every job becomes a *chain* of
pseudo-tasks executed strictly in order; the chain is what the deadline
allocator (Algorithm 1) and the instance policies (Section 4) operate on.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["Task", "ChainJob", "DAGJob", "Allocation", "TaskCost", "JobCost",
           "chain_from_arrays"]


@dataclasses.dataclass(frozen=True)
class Task:
    """A malleable task (paper Section 3.2)."""

    z: float      # workload, in instance-time
    delta: float  # parallelism bound (max simultaneous instances)

    def __post_init__(self) -> None:
        if self.z < 0:
            raise ValueError(f"task workload must be >= 0, got {self.z}")
        if self.delta <= 0:
            raise ValueError(f"parallelism bound must be > 0, got {self.delta}")

    @property
    def e(self) -> float:
        """Minimum execution time e_i = z_i / delta_i (Eq. 1)."""
        return self.z / self.delta


@dataclasses.dataclass(frozen=True)
class ChainJob:
    """A job with a chain precedence constraint: task k+1 starts after task k.

    ``arrival`` and ``deadline`` delimit the window [a_j, d_j] in which all
    tasks must run (Eq. 4).
    """

    arrival: float
    deadline: float
    tasks: tuple[Task, ...]

    def __post_init__(self) -> None:
        if self.deadline < self.arrival:
            raise ValueError("deadline before arrival")
        if not self.tasks:
            raise ValueError("job must have at least one task")

    @property
    def l(self) -> int:
        return len(self.tasks)

    @property
    def window(self) -> float:
        return self.deadline - self.arrival

    @property
    def total_work(self) -> float:
        return float(sum(t.z for t in self.tasks))

    @property
    def min_makespan(self) -> float:
        """Sum of minimum execution times — the chain's critical path."""
        return float(sum(t.e for t in self.tasks))

    @property
    def slack(self) -> float:
        """omega = (d_j - a_j) - sum_i e_i; must be >= 0 for feasibility."""
        return self.window - self.min_makespan

    def feasible(self) -> bool:
        return self.slack >= -1e-9

    def z_array(self) -> np.ndarray:
        return np.array([t.z for t in self.tasks], dtype=np.float64)

    def delta_array(self) -> np.ndarray:
        return np.array([t.delta for t in self.tasks], dtype=np.float64)

    def e_array(self) -> np.ndarray:
        return np.array([t.e for t in self.tasks], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class DAGJob:
    """A general DAG job. ``preds[i]`` lists the predecessors of task i.

    Tasks are indexed in a topological order (the generator of Section 6.1
    emits them that way; ``validate`` checks it).
    """

    arrival: float
    deadline: float
    tasks: tuple[Task, ...]
    preds: tuple[tuple[int, ...], ...]

    def __post_init__(self) -> None:
        if len(self.preds) != len(self.tasks):
            raise ValueError("preds length must match tasks length")
        for i, ps in enumerate(self.preds):
            for p in ps:
                if not (0 <= p < i):
                    raise ValueError(
                        f"predecessor {p} of task {i} violates topological order"
                    )

    @property
    def l(self) -> int:
        return len(self.tasks)

    @property
    def window(self) -> float:
        return self.deadline - self.arrival

    @property
    def total_work(self) -> float:
        return float(sum(t.z for t in self.tasks))

    def earliest_starts(self) -> np.ndarray:
        """Earliest start q_i when every task runs at full parallelism
        (the pseudo-schedule of Appendix B.1): q_i = max_{i' < i} (q_i' + e_i').
        """
        q = np.zeros(self.l, dtype=np.float64)
        e = np.array([t.e for t in self.tasks], dtype=np.float64)
        for i in range(self.l):
            if self.preds[i]:
                q[i] = max(q[p] + e[p] for p in self.preds[i])
        return q

    @property
    def critical_path(self) -> float:
        """e_j^c — the minimum time to finish the whole DAG (Section 6.1)."""
        q = self.earliest_starts()
        e = np.array([t.e for t in self.tasks], dtype=np.float64)
        return float(np.max(q + e)) if self.l else 0.0


@dataclasses.dataclass(frozen=True)
class Allocation:
    """The scheduler's decision for one chain job.

    ``windows[i] = (start_i, deadline_i)`` — task i executes in this window;
    start_0 = arrival, start_i = deadline_{i-1} (planned starts, Alg. 2).
    ``r[i]`` — self-owned instances reserved for task i over its whole window.
    """

    job: ChainJob
    windows: tuple[tuple[float, float], ...]
    r: tuple[float, ...]

    def __post_init__(self) -> None:
        if len(self.windows) != self.job.l or len(self.r) != self.job.l:
            raise ValueError("allocation arity mismatch")

    @property
    def sizes(self) -> np.ndarray:
        """hat-sigma_i — window sizes."""
        return np.array([b - a for a, b in self.windows], dtype=np.float64)


def chain_from_arrays(
    arrival: float,
    deadline: float,
    z: Sequence[float],
    delta: Sequence[float],
) -> ChainJob:
    return ChainJob(
        arrival=float(arrival),
        deadline=float(deadline),
        tasks=tuple(Task(z=float(a), delta=float(b)) for a, b in zip(z, delta, strict=True)),
    )


@dataclasses.dataclass(frozen=True)
class TaskCost:
    """Realized cost decomposition for one task under one policy."""

    spot_cost: float
    ondemand_cost: float
    spot_work: float       # workload processed by spot instances
    ondemand_work: float   # workload processed by on-demand instances
    selfowned_work: float  # workload processed by self-owned instances
    finish_time: float     # realized completion time
    turning_point: float | None  # None if the task never lost flexibility

    @property
    def total(self) -> float:
        return self.spot_cost + self.ondemand_cost


@dataclasses.dataclass(frozen=True)
class JobCost:
    """Aggregate over a job's tasks."""

    tasks: tuple[TaskCost, ...]

    @property
    def total(self) -> float:
        return float(sum(t.total for t in self.tasks))

    @property
    def spot_cost(self) -> float:
        return float(sum(t.spot_cost for t in self.tasks))

    @property
    def ondemand_cost(self) -> float:
        return float(sum(t.ondemand_cost for t in self.tasks))

    @property
    def spot_work(self) -> float:
        return float(sum(t.spot_work for t in self.tasks))

    @property
    def selfowned_work(self) -> float:
        return float(sum(t.selfowned_work for t in self.tasks))
