"""Rank processes for the port's multi-rank mesh tests (not a test module).

``spawn_ranks`` starts ``world`` processes with ``torch.multiprocessing``
(start method ``spawn``), each joining a gloo process group through a
``file://`` store, so concurrent test workers never race for a TCP port.
The spawn has its own join timeout: a rank that hangs fails its test (the
ranks are killed) instead of eating the suite's time limit. A rank that
raises fails the spawn with the rank's traceback.

``grid_rank`` is what each rank of ``tests/test_torch_mesh.py``'s
multi-rank cases runs. This module imports only the standard library,
numpy, torch and ``repro_torch``, so the rank processes import nothing
else (each rank records what it imported, and the test checks).
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np

GRID_JOBS = 13          # jobs of the multi-rank cases (tests/test_shard.py)
GRID_POLICIES = 7       # policies: 5 groups, one per bid
TOLA_POLICIES = 12
S_MARKETS = 13          # scenarios: padding on every data dim but 1
S_TOLA = 5
FOLD_CHUNK = 5
FOLD_LEARNERS = ("hedge", "exp3")


def _entry(rank, fn, world, init_file, timeout_s, args):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
        # No rank tears its connections down while another is still in a
        # collective with it.
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, init_file, args=(), timeout: float = 120.0):
    """Run ``fn(rank, *args)`` in ``world`` gloo ranks; raise if a rank
    fails or the ranks are not all done within ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _entry, args=(fn, world, str(init_file), timeout, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} rank(s) still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def grid_inputs():
    """Jobs, grids and scenarios of the multi-rank cases (the reference's
    ``test_2d_mesh_eval_parity`` and ``test_2d_mesh_refinement_rounds``)."""
    from repro_torch.core import generate_chain_jobs, selfowned_policies
    from repro_torch.engine import ScenarioSpec, make_scenarios

    jobs = generate_chain_jobs(GRID_JOBS, 2, seed=3)
    horizon = max(j.deadline for j in jobs) + 1.0
    return {
        "jobs": jobs,
        "grid": selfowned_policies()[:GRID_POLICIES],
        "tola_grid": selfowned_policies()[:TOLA_POLICIES],
        "markets": make_scenarios(horizon, S_MARKETS, seed=1),
        "tola_markets": make_scenarios(horizon, S_TOLA, seed=1),
        "spec": ScenarioSpec("fresh", horizon, S_MARKETS, seed=7),
        "fold_spec": ScenarioSpec("fresh", horizon, S_MARKETS, seed=5),
    }


FIELDS = ("unit_cost", "spot_cost", "ondemand_cost", "spot_work",
          "ondemand_work")
KEYS = ("engine.eval.chain:sharded", "engine.eval.task:sharded",
        "engine.eval.chain_ps:sharded", "engine.eval.task_ps:sharded",
        "engine.gather:sharded", "learn.fold:sharded")


def grid_calls(x, device="cpu", mesh=None):
    """Every call of the multi-rank cases, by name: both start modes on a
    market list, a chunked spec, TOLA with refinement rounds and the fold.
    The unsharded run (``mesh=None``) is the parent's reference."""
    from repro_torch.core import run_tola_scenarios
    from repro_torch.engine import evaluate_grid
    from repro_torch.learn import replay_stream

    out = {}
    for name, kw in (("early", {}), ("task", {"early_start": False})):
        res = evaluate_grid(x["jobs"], x["grid"], x["markets"], 300,
                            device=device, mesh=mesh, **kw)
        out.update({f"{name}.{f}": getattr(res, f) for f in FIELDS})
    res = evaluate_grid(x["jobs"], x["grid"], x["spec"], 300,
                        scenario_chunk=FOLD_CHUNK, device=device, mesh=mesh)
    out["spec.unit_cost"] = res.unit_cost
    tola = run_tola_scenarios(x["jobs"], x["tola_grid"], x["tola_markets"],
                              r_total=6, seed=0, pool_iters=2, device=device,
                              mesh=mesh)
    out["tola.cost"] = np.stack([t.cost_matrix for t in tola])
    out["tola.chosen"] = np.stack([t.chosen for t in tola])
    fold = replay_stream(x["jobs"], x["grid"], x["fold_spec"], 300,
                         learners=FOLD_LEARNERS, seed=11,
                         scenario_chunk=FOLD_CHUNK, device=device, mesh=mesh)
    mean, lo, hi = fold.confidence_bands()
    out.update({"fold.regret": fold.regret_per_job(),
                "fold.expected": fold.regret_per_job(expected=True),
                "fold.realized": fold.realized_unit(),
                "fold.best_fixed": np.asarray(fold.best_fixed()),
                "fold.weights": fold.weights(),
                "fold.curve": mean, "fold.band": hi,
                "fold.n": np.asarray([fold.n_scenarios, fold.n_chunks])})
    return out


def grid_rank(rank, shape, out_dir):
    """One rank of a ``shape`` mesh: every call of :func:`grid_calls`,
    saved with the rank's collective counts, program runs and imports."""
    from repro_torch.engine import GridMesh
    from repro_torch.obs import compiled

    mesh = GridMesh.create(*shape)
    compiled.reset_collectives()
    out = grid_calls(grid_inputs(), mesh=mesh)
    meta = {
        "coords": [mesh.data_rank, mesh.model_rank],
        "shards": [mesh.data_shards, mesh.model_shards],
        "counts": {k: compiled.collective_counts(k) for k in KEYS},
        "runs": {k: compiled.program_runs(k) for k in KEYS},
        "modules": sorted({m.split(".")[0] for m in sys.modules}),
    }
    out_dir = pathlib.Path(out_dir)
    np.savez(out_dir / f"rank{rank}.npz", **out)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(meta))
