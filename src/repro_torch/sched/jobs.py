"""Training/eval pipelines as the paper's DAG jobs.

A pretraining run decomposes into malleable stages:

    tokenize -> shard -> [train segment x N] -> eval -> export
                     \\-> [eval sweep branches]

Each stage is data-parallel across pods up to its scaling bound delta_i
(pods), with workload z_i in pod-time units. Segments between checkpoints
are independent units of preemptible progress — exactly the malleable tasks
of the paper: a segment can run on fewer pods for longer (down to its
minimum window z_i / delta_i).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.types import DAGJob, Task
from repro_torch.sched.fleet import estimate_stage_seconds

__all__ = ["training_job_dag"]


def training_job_dag(
    arch: str,
    arrival: float,
    deadline_factor: float = 2.0,
    n_segments: int = 4,
    steps_per_segment: int = 250,
    max_pods: int = 8,
    n_evals: int = 2,
    time_unit_s: float = 3600.0,
    cache=None,
) -> DAGJob:
    """Build the DAG for one training job of ``arch``.

    z_i is pod-hours (time_unit_s = one paper time-unit); the train segments
    form a chain; eval stages branch off each segment's completion and join
    at export.
    """
    seg_pod_s = estimate_stage_seconds(
        arch, steps=steps_per_segment, cache=cache) * max_pods
    seg_z = seg_pod_s / time_unit_s                    # pod-units of work
    prep_z = max(0.05 * seg_z, 0.01)
    eval_z = max(0.1 * seg_z, 0.01)

    tasks: list[Task] = []
    preds: list[tuple[int, ...]] = []

    def add(z, delta, *ps):
        tasks.append(Task(z=float(max(z, 1e-6)), delta=float(delta)))
        preds.append(tuple(ps))
        return len(tasks) - 1

    tok = add(prep_z, max_pods)                  # tokenize/shard
    prev = tok
    seg_ids = []
    for _ in range(n_segments):
        prev = add(seg_z, max_pods, prev)        # train segment (chain)
        seg_ids.append(prev)
    ev_ids = []
    for i in range(min(n_evals, len(seg_ids))):
        ev_ids.append(add(eval_z, max(max_pods // 2, 1), seg_ids[-(i + 1)]))
    add(prep_z, max(max_pods // 2, 1), seg_ids[-1], *ev_ids)  # export

    e_c = 0.0  # critical path computed by DAGJob itself
    job = DAGJob(arrival=arrival, deadline=arrival + 1.0,
                 tasks=tuple(tasks), preds=tuple(preds))
    e_c = job.critical_path
    return DAGJob(arrival=arrival, deadline=arrival + deadline_factor * e_c,
                  tasks=tuple(tasks), preds=tuple(preds))
