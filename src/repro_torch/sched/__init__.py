"""Fleet orchestration: training DAG jobs scheduled by the paper's policies
and TOLA over the port's core (host float64; TOLA's cost tensor on the
card)."""

from repro_torch.sched.fleet import FleetSpec, estimate_stage_seconds
from repro_torch.sched.jobs import training_job_dag
from repro_torch.sched.orchestrator import FleetOrchestrator, ScheduleReport
from repro_torch.sched.straggler import StragglerDetector

__all__ = ["FleetSpec", "estimate_stage_seconds", "training_job_dag",
           "FleetOrchestrator", "ScheduleReport", "StragglerDetector"]
