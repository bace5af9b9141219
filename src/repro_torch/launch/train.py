"""Elastic trainer CLI (the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --smoke --steps 30 --device cpu [--preempt-at 20] [--resume]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch tinyllama_1_1b --smoke --steps 30 [--elastic-demo]

What it runs: the model's own init from a seeded ``torch.Generator`` on the
device (a fresh start), ``launch.steps.make_train_step`` with AdamW on the
reference's ``cosine_schedule(3e-4, 10, steps)``, the deterministic data
pipeline (batches made on the host from the step number, put on the
device), async checkpoints with an atomic commit every ``ckpt_every`` steps
and at the last, and preemption: ``preempt_at`` waits for the save in
flight and stops before that step, as a spot reclaim would; ``resume``
restores the latest committed step and goes on from there, bit for bit the
run that was not stopped on the CPU.

On a mesh (``mesh=``: a ``GridMesh``, or a rank count for ``_mesh_for``;
under ``torchrun`` one rank a card over NCCL, the reference's
``_mesh_for`` shape) each step is ``launch.steps.ShardedTrainStep``: every
rank keeps only its shards of the masters and moments and trains on its
``"data"`` rows of the global batch, and the ranks of a ``"data"`` row
split each product over ``"model"`` as the reference's rules split it
(heads, kv heads, ``d_ff``, experts and vocab, the flash and SSD kernels
on the rank's heads; ``distributed/tensor_parallel.py``). A rank writes
each gradient into the step's whole flat buffer by its rule: a disjoint
one (its own heads, columns, experts or vocab rows) and a partial one
(kv heads or Mamba's B and C columns that several ranks read, each rank
holding part of the sum) at its slice, an identical one (a parameter
used whole, outside every split region) only from ``"model"`` rank 0;
one all-reduce over the mesh then gives every rank the whole
gradients, so the update, the state between steps and the checkpoints
are those of the unsplit step. Checkpoints keep the one-card flat
tree (``_state_tree``): the ranks gather it to rank 0's host a tensor at
a time, rank 0 writes it, and every rank restores the whole tree and
keeps its shard, so a run preempted on one mesh resumes on a smaller one,
or on one card without a process group (the reference's elastic restart
onto fewer devices). ``--elastic-demo``
preempts half way and, under ``torchrun``, shrinks the process group to
its first half of the ranks (``engine.mesh.regroup``: a new group formed
in the same launch, the reference's ``jax.devices()[:half]``), which
resume on the mesh of that half; without ``torchrun`` it resumes in the
same process. ``donate_argnums`` has no counterpart: the port updates its
tensors in place, which is what donation buys.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.data import SyntheticTokens, make_batches
from repro_torch.device import resolve_device
from repro_torch.engine.mesh import (
    GridMesh, all_gather, end_process_group, process_rank, regroup,
    start_process_group)
from repro_torch.launch import steps as step_lib
from repro_torch.models import build
from repro_torch.obs import span
from repro_torch.obs.compiled import program
from repro_torch.optim import AdamW, OptState, cosine_schedule

__all__ = ["train_loop", "main"]


def _mesh_for(n: int | None = None) -> GridMesh:
    """The reference's mesh of ``n`` ranks (default: every rank of the
    process group): ("data", "model") with a model dim of 4, 2 or 1,
    whichever divides ``n`` first."""
    n = process_rank()[1] if n is None else n
    model = 1
    for m in (4, 2, 1):
        if n % m == 0 and n >= m:
            model = m
            break
    return GridMesh.create(n // model, model)


def _extras(cfg, seq_len: int) -> dict:
    """The frontend stubs' inputs, as the reference's trainer makes them."""
    extras = {}
    if cfg.kind == "encdec":
        extras["frames"] = (max(seq_len // 4, 1), cfg.d_model)
    if cfg.kind == "vlm":
        extras["vision"] = (cfg.frontend_len, cfg.d_model)
    return extras


def _state_tree(params: dict, opt_state: OptState) -> dict:
    """The flat checkpoint of a run: the model's state dict (``params``),
    then ``opt.m.<name>``, ``opt.v.<name>`` and ``opt.step``."""
    tree = dict(params)
    tree.update({f"opt.m.{n}": t for n, t in opt_state.m.items()})
    tree.update({f"opt.v.{n}": t for n, t in opt_state.v.items()})
    tree["opt.step"] = opt_state.step
    return tree


@torch.no_grad()
def _load(tree: dict, loaded: dict) -> None:
    """Copy a restored checkpoint into the run's tensors."""
    for k, t in tree.items():
        t.copy_(loaded[k])


def train_loop(cfg, steps: int, ckpt_dir: str, global_batch: int = 8,
               seq_len: int = 128, device="cuda", resume: bool = False,
               preempt_at: int | None = None, log_every: int = 10,
               ckpt_every: int = 20, microbatches: int = 1, mesh=None):
    """Train ``cfg`` for ``steps`` steps on ``device`` (default the GPU),
    on one card (``mesh`` None: no process group, no collective) or on a
    mesh of ranks (a ``GridMesh``, or a rank count for ``_mesh_for``; every
    rank calls it). ``microbatches`` counts the global batch's slices on
    any mesh (``ShardedTrainStep``), so one run resumes on another mesh
    with the same steps. Returns {"status": "done" or "preempted", "step",
    "losses" (this run's, one float per step), "final_loss"}."""
    if mesh is not None:
        mesh = _mesh_for(mesh) if isinstance(mesh, int) else mesh
        return _train_meshed(cfg, steps, ckpt_dir, global_batch, seq_len,
                             device, resume, preempt_at, log_every,
                             ckpt_every, microbatches, mesh)
    dev = resolve_device(device)
    model = build(cfg, dev)
    params = dict(model.named_parameters())
    opt = AdamW(lr=cosine_schedule(3e-4, 10, steps))
    mgr = CheckpointManager(ckpt_dir)
    ds = SyntheticTokens(cfg.vocab, global_batch, seq_len,
                         extras=_extras(cfg, seq_len), host_rank=0,
                         host_count=1)
    step_fn = step_lib.make_train_step(model, opt,
                                       n_microbatches=microbatches)
    opt_state = opt.init(params)

    start = 0
    if resume and mgr.latest_step() is not None:
        tree = _state_tree(model.state_dict(), opt_state)
        loaded, start = mgr.restore(tree, device=dev)
        _load(tree, loaded)
        print(f"[train] restored step {start} onto {dev}")
    else:
        model.init_weights(torch.Generator(dev).manual_seed(0))

    return _run(ds, start, steps, dev, lambda b: step_fn(opt_state, b)[1],
                lambda s: mgr.save(s, _state_tree(model.state_dict(),
                                                  opt_state)),
                mgr.wait, preempt_at, log_every, ckpt_every)


def _run(ds, start, steps, dev, run_step, save, wait, preempt_at, log_every,
         ckpt_every, say=print) -> dict:
    """The loop both paths share: steps ``start``..``steps`` - 1 of
    ``ds``'s batches through ``run_step(batch) -> metrics`` (the state is
    updated in place), ``save(step)`` every ``ckpt_every`` steps and at the
    last, ``wait()`` (the save in flight committed) at a preemption and at
    the end."""
    losses = []
    window = 0.0
    for s, host_batch in make_batches(ds, start, steps - start):
        if preempt_at is not None and s == preempt_at:
            wait()
            say(f"[train] PREEMPTED at step {s} (spot reclaim simulated)")
            return {"status": "preempted", "step": s, "losses": losses}
        with span("train.step", step=s) as sp:
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in host_batch.items()}
            losses.append(float(run_step(batch)["loss"]))
        window += sp.seconds
        if (s + 1) % log_every == 0:
            say(f"[train] step {s + 1} loss {losses[-1]:.4f} "
                f"({window / log_every * 1e3:.0f} ms/step)")
            window = 0.0
        if (s + 1) % ckpt_every == 0 or s + 1 == steps:
            save(s + 1)
    wait()
    return {"status": "done", "step": steps, "losses": losses,
            "final_loss": losses[-1] if losses else None}


def _committed(mesh: GridMesh, mgr: CheckpointManager, lead: bool,
               dev: torch.device) -> None:
    """Rank 0 waits for its save in flight to commit, then every rank
    passes one all-gather of a token on the run's device ``dev`` (NCCL
    takes CUDA tensors only): no rank goes on (to a resume that reads the
    checkpoint) before it is on disk."""
    if lead:
        mgr.wait()
    with program(step_lib.ShardedTrainStep.CKPT_KEY):
        all_gather(mesh, torch.zeros(1, device=dev))


def _train_meshed(cfg, steps, ckpt_dir, global_batch, seq_len, device,
                  resume, preempt_at, log_every, ckpt_every, microbatches,
                  mesh: GridMesh):
    """``train_loop`` on ``mesh``: ``ShardedTrainStep`` on each rank's
    ``"data"`` rows, checkpoints as the one-card loop's."""
    dev = resolve_device(device)
    mesh.check_device(dev)
    lead = process_rank()[0] == 0
    say = print if lead else (lambda *a, **k: None)
    model = build(cfg, dev)
    opt = AdamW(lr=cosine_schedule(3e-4, 10, steps))
    mgr = CheckpointManager(ckpt_dir)
    ds = SyntheticTokens(cfg.vocab, global_batch, seq_len,
                         extras=_extras(cfg, seq_len),
                         host_rank=mesh.data_rank,
                         host_count=mesh.data_shards)
    step_fn = step_lib.ShardedTrainStep(model, opt, mesh, microbatches)

    start = 0
    if resume and mgr.latest_step() is not None:
        meta = {n: torch.empty(s, device="meta")
                for n, s in step_fn.shapes.items()}
        step = torch.empty((), dtype=torch.int32, device="meta")
        loaded, start = mgr.restore(_state_tree(
            meta, OptState(step=step, m=meta, v=meta)))
        pick = lambda pre: {n: loaded[pre + n] for n in meta}  # noqa: E731
        shards = step_fn.shard(pick(""))
        opt_state = OptState(step=loaded["opt.step"].to(dev),
                             m=step_fn.shard(pick("opt.m.")),
                             v=step_fn.shard(pick("opt.v.")))
        say(f"[train] restored step {start} onto a {mesh.data_shards}x"
            f"{mesh.model_shards} mesh (elastic re-shard)")
    else:
        model.init_weights(torch.Generator(dev).manual_seed(0))
        shards = step_fn.shard(dict(model.named_parameters()))
        opt_state = opt.init(shards)
    step_fn.release()

    def save(step: int) -> None:
        state = step_fn.gather_state(shards, opt_state, keep=lead)
        if lead:
            mgr.save(step, _state_tree(*state))

    return _run(ds, start, steps, dev,
                lambda b: step_fn(shards, opt_state, b)[1], save,
                lambda: _committed(mesh, mgr, lead, dev), preempt_at,
                log_every, ckpt_every, say)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="tinyllama_1_1b", choices=ARCH_NAMES)
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "repro_torch_ckpt"))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--preempt-at", type=int, default=None)
    p.add_argument("--elastic-demo", action="store_true",
                   help="preempt half way, resume on half the ranks (the "
                        "same process without torchrun)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device, mesh = args.device, None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        if torch.device(device).type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(local)
            device = f"cuda:{local}"
        start_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo")
        mesh = _mesh_for()
    lead = process_rank()[0] == 0
    common = dict(global_batch=args.batch, seq_len=args.seq, device=device,
                  microbatches=args.microbatches)
    try:
        if args.elastic_demo:
            r = train_loop(cfg, args.steps, args.ckpt_dir,
                           preempt_at=args.steps // 2, mesh=mesh, **common)
            if mesh is not None:
                keep = max(1, process_rank()[1] // 2)
                addr = os.environ.get("MASTER_ADDR", "localhost")
                port = int(os.environ.get("MASTER_PORT", 29500)) + 1
                if not regroup(keep, f"tcp://{addr}:{port}"):
                    return r
                mesh = _mesh_for()
            if lead:
                print(f"[train] elastic restart after {r['step']} on "
                      f"{process_rank()[1]} rank(s)")
            r = train_loop(cfg, args.steps, args.ckpt_dir, resume=True,
                           mesh=mesh, **common)
        else:
            r = train_loop(cfg, args.steps, args.ckpt_dir,
                           resume=args.resume, preempt_at=args.preempt_at,
                           mesh=mesh, **common)
    finally:
        end_process_group()
    if lead:
        print(f"[train] finished: {r['status']} at step {r['step']}")
    return r


if __name__ == "__main__":
    main()
