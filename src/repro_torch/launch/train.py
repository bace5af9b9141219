"""Trainer CLI on one card (the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --smoke --steps 30 --device cpu [--preempt-at 20] [--resume]

What it runs: the model's own init from a seeded ``torch.Generator`` on the
device (a fresh start), ``launch.steps.make_train_step`` with AdamW on the
reference's ``cosine_schedule(3e-4, 10, steps)``, the deterministic data
pipeline (batches made on the host from the step number, put on the
device), async checkpoints with an atomic commit every ``ckpt_every`` steps
and at the last, and preemption: ``preempt_at`` waits for the save in
flight and stops before that step, as a spot reclaim would; ``resume``
restores the latest committed step and goes on from there, bit for bit the
run that was not stopped on the CPU. ``--elastic-demo`` preempts half way
and resumes on the same card.

Left out, for the port's ``distributed/`` slice (ROADMAP A11.8): the
reference's ``_mesh_for`` and ``train_shardings`` (its mesh of devices and
the shardings of the step) and ``donate_argnums`` (the port updates the
parameters and moments in place, which is what donation buys). Its elastic
restart onto fewer devices is a restart on the same card here.
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
from repro_torch.launch import steps as step_lib
from repro_torch.models import build
from repro_torch.obs import span
from repro_torch.optim import AdamW, OptState, cosine_schedule

__all__ = ["train_loop", "main"]


def _extras(cfg, seq_len: int) -> dict:
    """The frontend stubs' inputs, as the reference's trainer makes them."""
    extras = {}
    if cfg.kind == "encdec":
        extras["frames"] = (max(seq_len // 4, 1), cfg.d_model)
    if cfg.kind == "vlm":
        extras["vision"] = (cfg.frontend_len, cfg.d_model)
    return extras


def _state_tree(model, opt_state: OptState) -> dict:
    """The flat checkpoint of a run: the model's state dict, then
    ``opt.m.<name>``, ``opt.v.<name>`` and ``opt.step``."""
    tree = dict(model.state_dict())
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
               ckpt_every: int = 20, microbatches: int = 1):
    """Train ``cfg`` for ``steps`` steps on ``device`` (default the GPU).
    Returns {"status": "done" or "preempted", "step", "losses" (this run's,
    one float per step), "final_loss"}."""
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
        tree = _state_tree(model, opt_state)
        loaded, start = mgr.restore(tree, device=dev)
        _load(tree, loaded)
        print(f"[train] restored step {start} onto {dev}")
    else:
        model.init_weights(torch.Generator(dev).manual_seed(0))

    losses = []
    window = 0.0
    for s, host_batch in make_batches(ds, start, steps - start):
        if preempt_at is not None and s == preempt_at:
            mgr.wait()
            print(f"[train] PREEMPTED at step {s} (spot reclaim simulated)")
            return {"status": "preempted", "step": s, "losses": losses}
        with span("train.step", step=s) as sp:
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in host_batch.items()}
            opt_state, metrics = step_fn(opt_state, batch)
            losses.append(float(metrics["loss"]))
        window += sp.seconds
        if (s + 1) % log_every == 0:
            print(f"[train] step {s + 1} loss {losses[-1]:.4f} "
                  f"({window / log_every * 1e3:.0f} ms/step)")
            window = 0.0
        if (s + 1) % ckpt_every == 0 or s + 1 == steps:
            mgr.save(s + 1, _state_tree(model, opt_state))
    mgr.wait()
    return {"status": "done", "step": steps, "losses": losses,
            "final_loss": losses[-1] if losses else None}


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
                   help="preempt half way, resume on the same card")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    common = dict(global_batch=args.batch, seq_len=args.seq,
                  device=args.device, microbatches=args.microbatches)
    if args.elastic_demo:
        r = train_loop(cfg, args.steps, args.ckpt_dir,
                       preempt_at=args.steps // 2, **common)
        print(f"[train] restart after {r['step']} on the same device")
        r = train_loop(cfg, args.steps, args.ckpt_dir, resume=True, **common)
    else:
        r = train_loop(cfg, args.steps, args.ckpt_dir, resume=args.resume,
                       preempt_at=args.preempt_at, **common)
    print(f"[train] finished: {r['status']} at step {r['step']}")
    return r


if __name__ == "__main__":
    main()
