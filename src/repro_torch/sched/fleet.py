"""Fleet model: accelerator pods as the paper's "instances".

The paper's three instance classes map onto real fleet procurement:
  self-owned = reserved pods (sunk cost), spot = preemptible pods,
  on-demand = on-demand pods. A *task*'s workload z_i is pod-seconds derived
  from a dry-run roofline (the compiled step's dominant term x steps), and
  its parallelism bound delta_i is the data-parallel scaling limit
  (global_batch / per-pod minimum batch).

The roofline cache is ``benchmarks/roofline_cache.json`` at the
repository's root, which the reference package's dry-run writes; the repo
does not ship it. It is read only if it exists; without it every training
step is taken to last 1 s.
"""

from __future__ import annotations

import dataclasses
import json
import os

__all__ = ["FleetSpec", "estimate_stage_seconds", "load_roofline_cache"]

_CACHE = os.path.join(os.path.dirname(__file__),
                      "../../../benchmarks/roofline_cache.json")


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Per-pod-hour prices normalized like the paper (on-demand = 1)."""

    reserved_pods: int = 0          # self-owned
    spot_discount: float = 0.3      # spot ~ 70% cheaper
    chips_per_pod: int = 256


def load_roofline_cache(path: str | None = None) -> list[dict]:
    p = os.path.abspath(path or _CACHE)
    if not os.path.exists(p):
        return []
    with open(p) as f:
        return json.load(f)


def estimate_stage_seconds(arch: str, shape: str = "train_4k",
                           steps: int = 1000, variant: str = "base",
                           cache: list[dict] | None = None) -> float:
    """Pod-seconds for `steps` training steps of an arch, from the dry-run
    roofline cache (1 s per step when the cache has no entry for it).

    The per-step time estimate is the max of the three roofline terms of the
    single-pod compiled cell (the roofline LOWER bound on step time — a
    deliberately optimistic z_i; the orchestrator's online learning absorbs
    systematic bias via the beta/beta_0 knobs).
    """
    cache = cache if cache is not None else load_roofline_cache()
    for r in cache:
        if (r.get("arch") == arch and r.get("shape") == shape
                and not r.get("multi_pod") and r.get("variant") == variant
                and r.get("status") == "ok"):
            step_s = max(r["compute_s"], r["memory_s"], r["collective_s"])
            return step_s * steps
    # Fallback when the dry-run cache is absent: 1s/step.
    return float(steps)
