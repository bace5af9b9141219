"""Rank processes for the port's meshed-trainer tests (not a test module).

``substrate_rank`` is what each of four gloo ranks runs for
``tests/test_torch_train_mesh.py``, all in one spawn: the meshed train
step on a 2x2 mesh for three smoke architectures (with the split forward's
logits), ``compressed_psum_tree`` and ``pipeline_apply`` over the four
ranks, a ``train_loop`` preempted on the 2x2 mesh, the three
architectures on a 1x4 and a 4x1 mesh; then the process group shrinks to
its first two ranks (``engine.mesh.regroup``), which resume that run on a
1x2 mesh and run the three architectures' steps there, and one step of
every other family. Ranks write what they saw under the test's
directory; rank 0 keeps the gathered state after every step.
``serve_rank`` is what each of four ranks runs for
``tests/test_torch_serve_split.py``: every family's split serve and the
collective bytes of its split prefill, decode and train steps on a 2x2
mesh, then regrouped on 1x2. This module imports only the standard
library, numpy, torch and ``repro_torch`` (each rank records what it
imported).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import sys

import numpy as np

ARCHS = ("tinyllama_1_1b", "olmoe_1b_7b", "mamba2_2_7b")
OTHERS = ("seamless_m4t_medium", "granite_3_8b", "qwen2_5_32b", "llama3_8b",
          "phi_3_vision_4_2b", "deepseek_moe_16b", "hymba_1_5b")
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


def _meshed_steps(mesh, arch, n_micro, out, tag, rank, steps=STEPS,
                  logits=False):
    """``steps`` meshed steps of ``arch`` from the whole initial
    parameters in ``out``; records losses, grad norms, the collectives of
    each step, the shards' shapes and bytes, the parameters held during
    the step (elements, read as the forward starts, and the step's own
    count of bytes), the size of each all-gather of the checkpoint
    gathers, and (rank 0, which alone keeps it) the gathered state after
    every step. With ``logits`` each rank first saves the split forward's
    logits of its rows."""
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
    held = []
    model.register_forward_pre_hook(
        lambda mod, args: held.append(sum(p.numel()
                                          for p in mod.parameters())))
    if logits:
        compiled.reset_collectives()
        b0 = batches(cfg, mesh.data_rank, mesh.data_shards)[0]
        got = step.logits(shards, {k: torch.as_tensor(v)
                                   for k, v in b0.items()})
        np.save(out / f"{tag}_{arch}_logits{rank}.npy", got.numpy())
        held.clear()
    rec = {"losses": [], "gnorms": [], "counts": [], "held_numel": held,
           "compute_bytes": step.compute_bytes(),
           "modes": step.plan.modes,
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
    for s, b in enumerate(batches(cfg, mesh.data_rank,
                                  mesh.data_shards)[:steps]):
        compiled.reset_collectives()
        state, m = step(shards, state, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
        rec["counts"].append(compiled.collective_counts(step.KEY))
        rec["losses"].append(m["loss"].item())
        rec["gnorms"].append(m["grad_norm"].item())
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
        meta["2x2"] = {a: _meshed_steps(mesh, a, 2, out, "2x2", rank,
                                        logits=True) for a in ARCHS}

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

        for tag, (d, m), n_micro in (("1x4", (1, 4), 2), ("4x1", (4, 1), 4)):
            other = GridMesh.create(d, m)
            meta[f"{tag}_coords"] = [other.data_rank, other.model_rank]
            meta[tag] = {a: _meshed_steps(other, a, n_micro, out, tag, rank)
                         for a in ARCHS}

        if regroup(2, f"file://{out / 'store2'}"):
            small = GridMesh.create(1, 2)
            meta["small_coords"] = [small.data_rank, small.model_rank]
            meta["resumed"] = train_loop(cfg, LOOP_STEPS, str(cut),
                                         device="cpu", resume=True,
                                         mesh=small, **LOOP)
            meta["1x2"] = {a: _meshed_steps(small, a, 2, out, "1x2",
                                            rank) for a in ARCHS}
            meta["1x2"].update({a: _meshed_steps(small, a, 2, out, "1x2",
                                                 rank, steps=1)
                                for a in OTHERS})
            import torch.distributed as dist
            dist.barrier()
        meta["modules"] = sorted({m.split(".")[0] for m in sys.modules})
        (out / f"rank{rank}.json").write_text(json.dumps(meta))
    finally:
        end_process_group()


def spawn(out_dir, timeout: float) -> None:
    """Run ``substrate_rank`` in four spawned gloo ranks; raise if one
    fails or they are not all done within ``timeout`` seconds."""
    _spawn(substrate_rank, 4, out_dir, timeout)


def _spawn(fn, nprocs: int, out_dir, timeout: float) -> None:
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(str(out_dir),), nprocs=nprocs,
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


# --------------------------------------------------------------------------
# tests/test_torch_tensor_parallel.py: two gloo ranks on a 1x2 mesh
# --------------------------------------------------------------------------

XENT_SHAPE = (3, 7, 50)     # tests/test_torch_train.py's, the vocab last


def uneven_gqa_config():
    """A dense smoke config whose 6 q heads over 3 kv heads split over a
    ``"model"`` of 2 as q heads 0-2 and 3-5, reading kv heads 0, 0, 1
    and 1, 2, 2: no uniform GQA ratio on a rank."""
    import dataclasses
    return dataclasses.replace(arch_config("granite_3_8b"), n_heads=6,
                               n_kv_heads=3, head_dim=8)


def tp_inputs() -> dict:
    """Seeded inputs of every rank: per-rank parts stacked on a leading
    axis of 2 where the ranks differ."""
    rng = np.random.default_rng(7)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    V = XENT_SHAPE[-1]
    return {"x": f(3, 4), "w": f(2, 3, 4), "parts": f(2, 3, 4), "u": f(3, 4),
            "narrow": f(2, 3, 2),
            "logits": (rng.normal(size=XENT_SHAPE) * 4).astype(np.float32),
            "labels": rng.integers(0, V, XENT_SHAPE[:2]).astype(np.int32),
            "mask": (rng.random(XENT_SHAPE[:2]) < 0.6).astype(np.float32)}


def tp_rank(rank: int, out_dir: str) -> None:
    """One of the two ranks: each autograd collective's value and
    gradient, the vocab-parallel cross entropy on the rank's half of the
    vocab (and its gradient), and one meshed step of
    ``uneven_gqa_config``, each counted."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import torch

    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.xent import cross_entropy
    from repro_torch.engine.mesh import (
        GridMesh, end_process_group, start_process_group)
    from repro_torch.launch.steps import ShardedTrainStep
    from repro_torch.models import build
    from repro_torch.obs import compiled
    from repro_torch.optim import AdamW

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    start_process_group("gloo", f"file://{out / 'store'}", 2, rank)
    try:
        mesh = GridMesh.create(1, 2)
        r = mesh.model_rank
        a = {k: torch.from_numpy(v) for k, v in tp_inputs().items()}
        got, counts = {}, {}

        def run(name, fn):
            compiled.reset_collectives()
            with compiled.program(name):
                fn()
            counts[name] = compiled.collective_counts(name)

        def copy():
            x = a["x"].clone().requires_grad_()
            y = tp.copy_to_model(x, mesh)
            (y * a["w"][r]).sum().backward()
            got["copy.y"], got["copy.grad"] = y.detach(), x.grad

        def reduce():
            x = a["parts"][r].clone().requires_grad_()
            y = tp.reduce_from_model(x, mesh)
            (y * a["u"]).sum().backward()
            got["reduce.y"], got["reduce.grad"] = y.detach(), x.grad

        def total():
            x = a["parts"][r].clone().requires_grad_()
            y = tp.sum_over_model(x, mesh)
            (y * a["w"][r]).sum().backward()
            got["sum.y"], got["sum.grad"] = y.detach(), x.grad

        def largest():
            x = a["parts"][r].clone().requires_grad_()
            y = tp.max_over_model(x, mesh)
            got["max.y"] = y
            got["max.requires_grad"] = torch.tensor(y.requires_grad)

        def gather():
            x = a["narrow"][r].clone().requires_grad_()
            y = tp.gather_from_model(x, mesh, 1)
            (y * a["u"]).sum().backward()
            got["gather.y"], got["gather.grad"] = y.detach(), x.grad

        def xent(masked):
            def fn():
                half = XENT_SHAPE[-1] // 2
                split = tp.Split(mesh, 2, r * half, (r + 1) * half)
                x = a["logits"][..., r * half:(r + 1) * half].clone() \
                    .requires_grad_()
                loss = cross_entropy(x, a["labels"],
                                     a["mask"] if masked else None, split)
                loss.backward()
                got[f"xent{int(masked)}.loss"] = loss.detach()
                got[f"xent{int(masked)}.grad"] = x.grad
            return fn

        for name, fn in (("copy", copy), ("reduce", reduce), ("sum", total),
                         ("max", largest), ("gather", gather),
                         ("xent0", xent(False)), ("xent1", xent(True))):
            run(name, fn)

        cfg = uneven_gqa_config()
        model = build(cfg, "cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        opt = AdamW(lr=LR)
        step = ShardedTrainStep(model, opt, mesh, 2)
        shards = step.shard(dict(model.named_parameters()))
        step.release()
        state = opt.init(shards)
        b = batches(cfg)[0]
        state, m = step(shards, state, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
        meta = {"counts": counts, "loss": m["loss"].item(),
                "gnorm": m["grad_norm"].item(),
                "kv_index": step.plan.splits["layers.0.attn"].kv_index,
                "modes": step.plan.modes}
        whole = step.gather_state(shards, state)[0]
        np.savez(out / f"tp{rank}.npz",
                 **{k: v.numpy() for k, v in got.items()},
                 **{f"p.{n}": t.numpy() for n, t in whole.items()})
        (out / f"tp{rank}.json").write_text(json.dumps(meta))
    finally:
        end_process_group()


def spawn_tp(out_dir, timeout: float) -> None:
    """``tp_rank`` in two spawned gloo ranks, as ``spawn`` runs its four."""
    _spawn(tp_rank, 2, out_dir, timeout)


# --------------------------------------------------------------------------
# tests/test_torch_serve_split.py: the split serve and the collective bytes
# of every family, on a 2x2 mesh of four gloo ranks, then (regrouped) 1x2
# --------------------------------------------------------------------------

SERVE_ARCHS = ARCHS + OTHERS
SERVE_B, SERVE_S, SERVE_NEW = 4, 16, 5     # rows, prompt, prefill + 4 decodes


def serve_max_len(cfg) -> int:
    return SERVE_S + SERVE_NEW + (cfg.n_meta_tokens or 0)


def serve_inputs(cfg) -> dict:
    """The seeded prompts (and the frontends' seeded embeddings) of the
    ``SERVE_B`` requests."""
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, cfg.vocab, (SERVE_B, SERVE_S),
                                  dtype=np.int32)}
    if cfg.kind == "encdec":
        out["frames"] = rng.normal(size=(SERVE_B, SERVE_S // 4, cfg.d_model)
                                   ).astype(np.float32)
    if cfg.kind == "vlm":
        out["vision"] = (0.02 * rng.normal(
            size=(SERVE_B, cfg.frontend_len, cfg.d_model))).astype(np.float32)
    return out


def _split_serve(mesh, arch: str, out, tag: str, rank: int) -> dict:
    """``arch``'s split prefill and ``SERVE_NEW - 1`` decodes on the rank's
    ``"data"`` rows from the whole parameters in ``out``: tokens, the
    rank's cache, each step's logits over the whole vocab (teacher-forced
    on the served tokens, gathered for the check under a program key of
    its own) and each step's collective bytes; then one split train step
    on the rank's rows of ``batches``' first batch, with its bytes."""
    import torch

    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.steps import ShardedServeStep, ShardedTrainStep
    from repro_torch.models import build
    from repro_torch.obs import compiled
    from repro_torch.optim import AdamW

    cfg = arch_config(arch)
    with np.load(out / f"serve_init_{arch}.npz") as z:
        whole = {k: torch.from_numpy(z[k]) for k in z.files}
    step = ShardedServeStep(build(cfg, "meta"), mesh, serve_max_len(cfg))
    step.load(whole, "cpu")
    per = SERVE_B // mesh.data_shards
    rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    batch = {k: torch.from_numpy(v[rows])
             for k, v in serve_inputs(cfg).items()}
    pos0 = SERVE_S + (cfg.n_meta_tokens or 0)
    rec = {"bytes": {}}
    compiled.reset_collectives()
    tok, cache = step.prefill(batch)
    rec["bytes"]["prefill"] = compiled.collective_bytes(step.PREFILL_KEY)
    toks, rec["bytes"]["decode"] = [tok], []
    for t in range(SERVE_NEW - 1):
        compiled.reset_collectives()
        tok, cache = step.decode(cache, tok, pos0 + t)
        rec["bytes"]["decode"].append(
            compiled.collective_bytes(step.DECODE_KEY))
        toks.append(tok)
    tokens = torch.cat(toks, 1)
    np.savez(out / f"{tag}_serve_{arch}_cache{rank}.npz",
             **{k: v.float().numpy() for k, v in cache.items()})
    vocab = step.plan.splits.get("")

    def whole_logits(lg):
        lg = lg[:, -1]
        return (tp.gather_from_model(lg, mesh, -1) if vocab else lg).float()

    model = step.model
    with compiled.program("serve.check"), tp.applied(model, step.plan.splits):
        lg, cache = model.prefill(batch, max_len=serve_max_len(cfg))
        got = [whole_logits(lg)]
        for t in range(SERVE_NEW - 1):
            lg, cache = model.decode(cache, tokens[:, t:t + 1], pos0 + t)
            got.append(whole_logits(lg))
    np.save(out / f"{tag}_serve_{arch}_logits{rank}.npy",
            torch.stack(got, 1).numpy())
    rec["tokens"] = tokens.tolist()
    rec["cache_shapes"] = {k: list(v.shape) for k, v in cache.items()}
    rec["param_bytes"] = step.param_bytes()

    model = build(cfg, "cpu")
    opt = AdamW(lr=LR)
    train = ShardedTrainStep(model, opt, mesh, 2)
    shards = train.shard(whole)
    train.release()
    b = batches(cfg, mesh.data_rank, mesh.data_shards)[0]
    compiled.reset_collectives()
    train(shards, opt.init(shards), {k: torch.as_tensor(v)
                                     for k, v in b.items()})
    rec["bytes"]["train"] = compiled.collective_bytes(train.KEY)
    return rec


def serve_rank(rank: int, out_dir: str) -> None:
    """One of four ranks: every family's split serve and train step's
    bytes on a 2x2 mesh, then, regrouped to two ranks, on 1x2."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import torch

    from repro_torch.engine.mesh import (
        GridMesh, end_process_group, regroup, start_process_group)

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    start_process_group("gloo", f"file://{out / 'store'}", 4, rank)
    meta = {"rank": rank}
    try:
        mesh = GridMesh.create(2, 2)
        meta["coords"] = {"2x2": [mesh.data_rank, mesh.model_rank]}
        meta["2x2"] = {a: _split_serve(mesh, a, out, "2x2", rank)
                       for a in SERVE_ARCHS}
        if regroup(2, f"file://{out / 'store2'}"):
            small = GridMesh.create(1, 2)
            meta["coords"]["1x2"] = [small.data_rank, small.model_rank]
            meta["1x2"] = {a: _split_serve(small, a, out, "1x2", rank)
                           for a in SERVE_ARCHS}
            import torch.distributed as dist
            dist.barrier()
        meta["modules"] = sorted({m.split(".")[0] for m in sys.modules})
        (out / f"serve{rank}.json").write_text(json.dumps(meta))
    finally:
        end_process_group()


def spawn_serve(out_dir, timeout: float) -> None:
    """``serve_rank`` in four spawned gloo ranks, as ``spawn`` runs its."""
    _spawn(serve_rank, 4, out_dir, timeout)
