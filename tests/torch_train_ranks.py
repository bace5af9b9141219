"""Rank processes for the port's meshed-trainer tests (not a test module).

``substrate_rank`` is what each of four gloo ranks runs for
``tests/test_torch_train_mesh.py``, all in one spawn: the meshed train
step on a 2x2 mesh for three smoke architectures, ``compressed_psum_tree``
and ``pipeline_apply`` over the four ranks, a ``train_loop`` preempted on
the 2x2 mesh; then the process group shrinks to its first two ranks
(``engine.mesh.regroup``), which resume that run on a 1x2 mesh and run the
three architectures' steps there. Ranks write what they saw under the
test's directory. This module imports only the standard library, numpy,
torch and ``repro_torch`` (each rank records what it imported).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import sys

import numpy as np

ARCHS = ("tinyllama_1_1b", "olmoe_1b_7b", "mamba2_2_7b")
B, S, SEED = 4, 32, 5     # global batch, sequence, data seed
STEPS = 3
LR = 1e-2                 # tests/test_torch_train_loop.py's
LOOP = dict(global_batch=4, seq_len=32, log_every=100, ckpt_every=2,
            microbatches=2)
LOOP_STEPS, PREEMPT = 8, 4
COMP_SHAPE = (4, 32)
PIPE = (4, 8, 2, 16)      # stages, microbatches, rows, width (the reference's)


def _extras(cfg) -> dict:
    from repro_torch.launch.train import _extras as extras
    return extras(cfg, S)


def arch_config(arch: str):
    import dataclasses

    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(arch), dtype="float32")


def batches(cfg, rank: int = 0, count: int = 1) -> list[dict]:
    """The rows of the ``STEPS`` global batches that ``"data"`` rank
    ``rank`` of ``count`` trains on."""
    from repro_torch.data import SyntheticTokens
    ds = SyntheticTokens(cfg.vocab, B, S, seed=SEED, host_rank=rank,
                         host_count=count, extras=_extras(cfg))
    return [ds.batch(s) for s in range(STEPS)]


def comp_inputs(rank: int):
    rng = np.random.default_rng(100 + rank)
    return {"w": rng.normal(size=COMP_SHAPE).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32) * 1e-3}


def pipe_inputs():
    n_stages, n_micro, bm, d = PIPE
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(n_stages, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n_micro, bm, d)).astype(np.float32)
    return w, x


def stage_fn(w, a):
    import torch
    return torch.tanh(a @ w)


def _meshed_steps(mesh, arch, n_micro, out, tag, rank):
    """STEPS meshed steps of ``arch`` from the whole initial parameters in
    ``out``; records losses, grad norms, the collectives of each step,
    the shards' shapes and bytes, the size of each all-gather of the
    checkpoint gathers, and (rank 0, which alone keeps it) the gathered
    state after the first and the last step."""
    import torch

    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.steps import ShardedTrainStep
    from repro_torch.models import build
    from repro_torch.obs import compiled
    from repro_torch.optim import AdamW

    cfg = arch_config(arch)
    model = build(cfg, "cpu")
    with np.load(out / f"init_{arch}.npz") as z:
        init = {k: torch.from_numpy(z[k]) for k in z.files}
    opt = AdamW(lr=LR)
    step = ShardedTrainStep(model, opt, mesh, n_micro)
    shards = step.shard(init)
    step.release()
    state = opt.init(shards)
    rec = {"losses": [], "gnorms": [], "counts": [],
           "shard_shapes": {n: list(t.shape) for n, t in shards.items()},
           "m_shapes": {n: list(t.shape) for n, t in state.m.items()},
           "v_shapes": {n: list(t.shape) for n, t in state.v.items()},
           "held_bytes": sum(t.numel() * t.element_size() for d in
                             (shards, state.m, state.v) for t in d.values()),
           "shard_bytes": step.shard_bytes(),
           "param_numel_between": sum(p.numel() for p in model.parameters())}
    gathered = []

    def all_gather(mesh, t):
        gathered.append(t.numel())
        return real_all_gather(mesh, t)

    real_all_gather = steps_mod.all_gather
    for s, b in enumerate(batches(cfg, mesh.data_rank, mesh.data_shards)):
        compiled.reset_collectives()
        state, m = step(shards, state, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
        rec["counts"].append(compiled.collective_counts(step.KEY))
        rec["losses"].append(m["loss"].item())
        rec["gnorms"].append(m["grad_norm"].item())
        if s in (0, STEPS - 1):
            compiled.reset_collectives()
            gathered.clear()
            steps_mod.all_gather = all_gather
            try:
                got = step.gather_state(shards, state, keep=rank == 0)
            finally:
                steps_mod.all_gather = real_all_gather
            rec["ckpt_counts"] = compiled.collective_counts(step.CKPT_KEY)
            rec["ckpt_gathered"] = list(gathered)
            rec["ckpt_kept"] = got is not None
            if rank == 0:
                whole, whole_opt = got
                np.savez(out / f"{tag}_{arch}_step{s + 1}.npz",
                         **{f"p.{n}": t.numpy() for n, t in whole.items()},
                         **{f"m.{n}": t.numpy() for n, t in whole_opt.m.items()},
                         **{f"v.{n}": t.numpy() for n, t in whole_opt.v.items()})
    rec["param_numel_after"] = sum(p.numel() for p in model.parameters())
    return rec


def substrate_rank(rank: int, out_dir: str) -> None:
    """One of the four ranks (module docstring)."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import torch

    from repro_torch.distributed import compressed_psum_tree, pipeline_apply
    from repro_torch.engine.mesh import (
        GridMesh, end_process_group, regroup, start_process_group)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.obs import compiled

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    start_process_group("gloo", f"file://{out / 'store'}", 4, rank)
    meta = {"rank": rank}
    try:
        mesh = GridMesh.create(2, 2)
        meta["coords"] = [mesh.data_rank, mesh.model_rank]
        meta["2x2"] = {a: _meshed_steps(mesh, a, 2, out, "2x2", rank)
                       for a in ARCHS}

        g = {k: torch.from_numpy(v) for k, v in comp_inputs(rank).items()}
        e = {k: torch.zeros_like(v) for k, v in g.items()}
        dm = make_mesh((4,), ("data",))
        compiled.reset_collectives()
        with compiled.program("compress"):
            mean, new_e = compressed_psum_tree(g, e, dm, "data")
        meta["compress_counts"] = compiled.collective_counts("compress")
        np.savez(out / f"compress{rank}.npz",
                 **{f"mean.{k}": v.numpy() for k, v in mean.items()},
                 **{f"err.{k}": v.numpy() for k, v in new_e.items()})

        w, x = pipe_inputs()
        sm = make_mesh((4,), ("stage",))
        compiled.reset_collectives()
        with compiled.program("pipeline"):
            y = pipeline_apply(stage_fn, torch.from_numpy(w),
                               torch.from_numpy(x), PIPE[0], sm)
        meta["pipeline_counts"] = compiled.collective_counts("pipeline")
        np.save(out / f"pipe{rank}.npy", y.numpy())

        cfg = arch_config("tinyllama_1_1b")
        cut = out / "ckpt_cut"
        r = train_loop(cfg, LOOP_STEPS, str(cut), device="cpu",
                       preempt_at=PREEMPT, mesh=mesh, **LOOP)
        meta["preempted"] = r
        if rank == 0:      # the same checkpoint, for a one-process resume
            shutil.copytree(cut, out / "ckpt_single")

        if regroup(2, f"file://{out / 'store2'}"):
            small = GridMesh.create(1, 2)
            meta["small_coords"] = [small.data_rank, small.model_rank]
            meta["resumed"] = train_loop(cfg, LOOP_STEPS, str(cut),
                                         device="cpu", resume=True,
                                         mesh=small, **LOOP)
            meta["1x2"] = {a: _meshed_steps(small, a, 2, out, "1x2",
                                            rank) for a in ARCHS}
            import torch.distributed as dist
            dist.barrier()
        meta["modules"] = sorted({m.split(".")[0] for m in sys.modules})
        (out / f"rank{rank}.json").write_text(json.dumps(meta))
    finally:
        end_process_group()


def spawn(out_dir, timeout: float) -> None:
    """Run ``substrate_rank`` in four spawned gloo ranks; raise if one
    fails or they are not all done within ``timeout`` seconds."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(substrate_rank, args=(str(out_dir),), nprocs=4,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
