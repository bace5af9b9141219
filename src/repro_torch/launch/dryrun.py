"""Multi-pod dry-run on the meta device: trace every (arch x shape x mesh
x variant) cell (the reference's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--variant v] [--out dryrun.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Proves the distribution config is coherent without hardware: the model
is built on ``torch.device("meta")`` and the cell's step runs on the
registry's ``input_specs`` (meta tensors: shapes and dtypes, no data, no
device) — the train step with the cell's microbatches, prefill, or one
decode step against ``init_cache``; the kernel wrappers take their plain
versions on meta tensors. Per cell it reports the trace's seconds (an
``obs`` span), the FLOPs ``torch.utils.flop_counter.FlopCounterMode``
counts in it against ``model_flops``, and the bytes per card of the
parameters, optimizer state, batch and cache, from the fitted specs on
the production mesh (``launch.mesh.make_production_mesh``: 16x16 or
2x16x16, never built), against ``launch.mesh.HW``. That trace is of the
whole global step on one meta device, and ``traced_flops_per_device`` its
share over the mesh's cards.

The roofline is the reference's, from a second trace: rank 0's own step
on a ``StandInMesh`` of the production mesh's shape (its position, no
ranks behind it), split over ``"model"`` as the meshed steps split it —
``ShardedTrainStep`` with the cell's microbatches, or
``ShardedServeStep``'s prefill or decode — on the rank's ``"data"`` rows,
analysed op by op (``launch/op_analysis.py``, the counterpart of the
reference's ``hlo_analysis``): per-device ``flops`` (products only),
``bytes`` (what eager PyTorch moves on the card) and ``collective_bytes``
(per kind plus ``total``, the operand bytes the rank's collectives
move), and from them ``compute_s`` (FLOPs at the bf16 peak), ``memory_s``
(bytes at the HBM rate), ``collective_s`` (collective bytes at one
card's NVLink rate: a 16-wide ``"model"`` spans two 8-card NVLink domains,
whose traffic would cross the slower network between them, so this term
is a lower bound there) and ``bottleneck``, the largest. ``fits_hbm``
counts what the rank holds entering the step plus the trace's peak live
bytes (``rank_bytes``). Left out: the compile seconds and the HLO bytes,
which the port has no compiler to report.

Output: one JSON line per cell on stdout, or under the git-ignored
``build/archive/`` with ``--out`` (never ``benchmarks/``); a one-line
summary per cell on stderr.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import traceback

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (
    ARCH_NAMES, SHAPES, get_config, input_specs, supports)
from repro_torch.distributed.sharding import ShardingRules, logical_to_spec
from repro_torch.engine.mesh import StandInMesh
from repro_torch.launch import steps as step_lib
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.launch.variants import VARIANTS
from repro_torch.models import build
from repro_torch.obs import span
from repro_torch.optim import AdamW

__all__ = ["model_flops", "collective_bytes", "lower_cell", "main",
           "ARCHIVE"]

ARCHIVE = pathlib.Path(__file__).resolve().parents[3] / "build" / "archive"
ENC_LEN = 4096      # the encoder-decoder's frames in a decode cell


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) useful-work estimate."""
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * cfg.active_params * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * cfg.active_params * tokens
    # decode: one token per sequence
    return 2.0 * cfg.active_params * shape.global_batch


def _bytes(shardings, tensors) -> int:
    """Bytes of one mesh position's blocks of ``tensors`` (name ->
    tensor) under ``shardings`` (name -> ``NamedSharding``)."""
    return sum(math.prod(shardings[name].shard_shape(tuple(t.shape)))
               * t.element_size() for name, t in tensors.items())


def collective_bytes(step, *args, **kwargs) -> dict:
    """Operand bytes of every collective that one rank's step (``step(*args,
    **kwargs)``) issues, per kind plus ``"total"``: the reference's
    breakdown of its compiled program's collectives, read here from the
    mesh helpers as the step runs (``op_analysis.analyze``)."""
    return analyze(step, *args, **kwargs)["collectives"]


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _rows(mesh, rules, model, mode: str, batch: dict) -> dict:
    """A position's rows of the global ``batch`` under the fitted batch
    specs."""
    sh = step_lib.fitted(mesh, logical_to_spec(
        rules, step_lib.batch_axes_tree(model, mode)), batch)
    here = mesh.position()
    return {k: t[sh[k].block(tuple(t.shape), here)]
            for k, t in batch.items()}


def _rank_roofline(cfg, shape, multi_pod: bool, overrides: dict,
                  n_microbatches: int) -> dict:
    """Rank 0's split step of the cell on the production mesh's stand-in,
    analysed: its roofline fields (module docstring)."""
    mesh = StandInMesh.of(make_production_mesh(multi_pod=multi_pod))
    rules = ShardingRules.create(mesh, overrides)
    model = build(cfg, "meta")
    whole = {n: p.detach() for n, p in model.named_parameters()}
    batch = input_specs(cfg, shape)
    if shape.mode == "train":
        opt = AdamW(lr=3e-4)
        step = step_lib.ShardedTrainStep(model, opt, mesh, n_microbatches)
        shards = step.shard(whole)
        step.release()
        state = opt.init(shards)
        rows = _rows(mesh, rules, model, "train", batch)
        held = _nbytes(shards) + _nbytes(state.m) + _nbytes(state.v) \
            + _nbytes(rows)
        ana = analyze(step, shards, state, rows)
    else:
        mode = "prefill" if shape.mode == "prefill" else "decode"
        step = step_lib.ShardedServeStep(model, mesh)
        step.load(whole, "meta")
        rows = _rows(mesh, rules, model, mode, batch)
        held = step.param_bytes() + _nbytes(rows)
        if mode == "prefill":
            ana = analyze(step.prefill, rows)
        else:
            B, S = rows["token"].shape[0], shape.seq_len
            cache = step.init_cache(B, S, ENC_LEN) \
                if cfg.kind == "encdec" else step.init_cache(B, S)
            held += _nbytes(cache)
            ana = analyze(step.decode, cache, rows["token"], S - 1)
    coll = {k: float(v) for k, v in ana["collectives"].items()}
    terms = {"compute_s": ana["flops"] / HW.PEAK_FLOPS_BF16,
             "memory_s": ana["bytes"] / HW.HBM_BW,
             "collective_s": coll["total"] / HW.NVLINK_BW}
    return {"flops": float(ana["flops"]), "bytes": float(ana["bytes"]),
            "collective_bytes": coll, **terms,
            "bottleneck": max(terms, key=terms.get),
            "collective_domain": (
                f"NVLink at {HW.NVLINK_BW:.3g} B/s within an 8-card domain"
                + (f"; a {mesh.model_shards}-wide \"model\" crosses "
                   f"{-(-mesh.model_shards // 8)} domains, so collective_s "
                   "is a lower bound" if mesh.model_shards > 8 else "")),
            "kernel_calls": {k: v["calls"] for k, v in ana["kernels"].items()},
            "analyzer_warnings": ana["warnings"][:5],
            "rank_bytes": {"held": held, "peak": ana["peak_bytes"],
                           "total": held + ana["peak_bytes"]}}


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               variant: str = "base", n_microbatches: int = 4) -> dict:
    """Trace one cell on the meta device and reckon its bytes per card."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = supports(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "variant": variant, "status": "skipped", "reason": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    overrides, cfg = VARIANTS[variant](cfg, shape)
    overrides = dict(overrides)
    n_microbatches = int(overrides.pop("_microbatches", n_microbatches))
    rules = ShardingRules.create(mesh, overrides)
    model = build(cfg, "meta")
    params = dict(model.named_parameters())
    batch = input_specs(cfg, shape)
    counter = FlopCounterMode(display=False, depth=0)
    with span("dryrun.trace", arch=arch, shape=shape_name) as sp, counter:
        if shape.mode == "train":
            opt = AdamW(lr=3e-4)
            opt_state = opt.init(params)
            step_lib.make_train_step(model, opt, n_microbatches)(opt_state,
                                                                 batch)
            (p_sh, opt_sh, b_sh), _ = step_lib.train_shardings(
                model, rules, mesh, params, opt_state, batch)
            state = {"opt_state": _bytes(opt_sh.m, opt_state.m)
                     + _bytes(opt_sh.v, opt_state.v)
                     + opt_state.step.element_size()}
        elif shape.mode == "prefill":
            _, cache = step_lib.make_prefill_step(model)(batch)
            (p_sh, b_sh), (_, c_sh) = step_lib.prefill_shardings(
                model, rules, mesh, params, batch, cache)
            state = {"cache": _bytes(c_sh, cache)}
        else:
            B, S = shape.global_batch, shape.seq_len
            cache = model.init_cache(B, S, ENC_LEN) \
                if cfg.kind == "encdec" else model.init_cache(B, S)
            step_lib.make_decode_step(model)(cache, batch["token"], S - 1)
            p_sh, c_sh, b_sh, _ = step_lib.decode_shardings(
                model, rules, mesh, params, cache, batch["token"])[0]
            b_sh = {"token": b_sh}
            state = {"cache": _bytes(c_sh, cache)}
    chips = mesh.size
    per_device = {"params": _bytes(p_sh, params), **state,
                  "batch": _bytes(b_sh, batch)}
    per_device["total"] = sum(per_device.values())
    flops = float(counter.get_total_flops())
    mf = model_flops(cfg, shape)
    with span("dryrun.rank", arch=arch, shape=shape_name) as rank_sp:
        roof = _rank_roofline(cfg, shape, multi_pod, overrides,
                             n_microbatches)
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "variant": variant, "status": "ok", "chips": chips,
        "n_microbatches": n_microbatches if shape.mode == "train" else None,
        "trace_s": sp.seconds,
        "traced_flops": flops,
        "traced_flops_per_device": flops / chips,
        "model_flops": mf,
        "model_flops_per_device": mf / chips,
        "useful_flops_ratio": mf / flops if flops else 0.0,
        "bytes_per_device": per_device,
        **roof,
        "rank_trace_s": rank_sp.seconds,
        "fits_hbm": roof["rank_bytes"]["total"] < HW.HBM_BYTES,
    }


def _out_path(name: str) -> pathlib.Path:
    """``name`` under ``ARCHIVE``: a relative path that stays inside it."""
    path = (ARCHIVE / name).resolve()
    if pathlib.Path(name).is_absolute() or ARCHIVE.resolve() not in \
            path.parents:
        raise SystemExit(f"--out {name!r} must be a path under {ARCHIVE}")
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None, choices=ARCH_NAMES)
    p.add_argument("--shape", default=None, choices=list(SHAPES))
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--variant", default="base", choices=list(VARIANTS))
    p.add_argument("--out", default=None,
                   help="JSON lines file under build/archive/ (default: "
                        "stdout)")
    args = p.parse_args(argv)

    archs = ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out = None
    if args.out:
        path = _out_path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        out = open(path, "w")
    n_fail = 0
    try:
        for a in archs:
            for s in shapes:
                for mp in meshes:
                    label = (f"{a} x {s} x {'2x16x16' if mp else '16x16'} "
                             f"[{args.variant}]")
                    try:
                        rec = lower_cell(a, s, multi_pod=mp,
                                         variant=args.variant)
                    except Exception as e:  # noqa: BLE001 — report, go on
                        n_fail += 1
                        traceback.print_exc()
                        rec = {"arch": a, "shape": s, "multi_pod": mp,
                               "variant": args.variant, "status": "fail",
                               "error": f"{type(e).__name__}: {e}"}
                    print(json.dumps(rec), file=out or sys.stdout,
                          flush=True)
                    if rec["status"] == "ok":
                        b = rec["bytes_per_device"]
                        print(f"[ok]   {label}: traced {rec['traced_flops']:.3e}"
                              f" FLOPs ({rec['useful_flops_ratio']:.3f} "
                              f"useful), {b['total'] / 2**30:.2f} GiB a "
                              f"card; rank 0 {rec['flops']:.3e} FLOPs, "
                              f"{rec['bytes']:.3e} B, collectives "
                              f"{rec['collective_bytes']['total']:.3e} B, "
                              f"bottleneck {rec['bottleneck']}, peak "
                              f"{rec['rank_bytes']['total'] / 2**30:.2f} GiB"
                              f", fits {rec['fits_hbm']} (traces "
                              f"{rec['trace_s']:.1f}s, "
                              f"{rec['rank_trace_s']:.1f}s)",
                              file=sys.stderr)
                    else:
                        print(f"[{rec['status']}] {label}: "
                              f"{rec.get('reason') or rec.get('error')}",
                              file=sys.stderr)
    finally:
        if out is not None:
            out.close()
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")
    print("dry-run complete", file=sys.stderr)


if __name__ == "__main__":
    main()
