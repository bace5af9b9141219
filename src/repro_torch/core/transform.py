"""DAG -> chain transform of Nagarajan et al. (paper Appendix B.1).

The *pseudo-schedule* runs every task at its full parallelism bound as early as
its predecessors allow. Slicing the pseudo-schedule's makespan at every task
start/finish produces intervals I_1..I_l'; interval k becomes pseudo-task k of
a chain job with

    delta(k) = sum of instances running during I_k
    z(k)     = delta(k) * |I_k|        (hence e(k) = |I_k|)

Any feasible schedule of the chain is feasible for the DAG (tasks' work is only
ever moved *later*, and within an interval the original tasks run side by side
at rates proportional to their instance shares).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.types import ChainJob, DAGJob, Task

__all__ = ["transform", "pseudo_schedule_intervals"]

_EPS = 1e-12


def pseudo_schedule_intervals(job: DAGJob) -> tuple[np.ndarray, np.ndarray]:
    """Return (boundaries, load) of the pseudo-schedule.

    ``boundaries`` is the sorted array of unique event times (task starts and
    finishes, relative to the job arrival); ``load[k]`` is the total number of
    instances running in interval [boundaries[k], boundaries[k+1]).
    """
    q = job.earliest_starts()
    e = np.array([t.e for t in job.tasks], dtype=np.float64)
    d = np.array([t.delta for t in job.tasks], dtype=np.float64)

    events = np.unique(np.concatenate([q, q + e]))
    # Filter zero-length artifacts caused by floating point.
    keep = np.ones(len(events), dtype=bool)
    keep[1:] = np.diff(events) > _EPS
    events = events[keep]

    load = np.zeros(max(len(events) - 1, 0), dtype=np.float64)
    for k in range(len(load)):
        lo, hi = events[k], events[k + 1]
        running = (q < hi - _EPS) & (q + e > lo + _EPS)
        load[k] = float(np.sum(d[running]))
    return events, load


def transform(job: DAGJob) -> ChainJob:
    """j' <- transform(j): build the chain pseudo-job (Eq. 19)."""
    events, load = pseudo_schedule_intervals(job)
    tasks = []
    for k in range(len(load)):
        length = events[k + 1] - events[k]
        if length <= _EPS or load[k] <= _EPS:
            continue  # idle gap (cannot happen with earliest starts, but safe)
        tasks.append(Task(z=float(load[k] * length), delta=float(load[k])))
    if not tasks:
        # Degenerate: all tasks empty. Keep a single zero-ish task.
        tasks = [Task(z=0.0, delta=1.0)]
    return ChainJob(arrival=job.arrival, deadline=job.deadline, tasks=tuple(tasks))
