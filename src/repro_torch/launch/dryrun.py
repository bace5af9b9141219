"""Multi-pod dry-run on the meta device: trace every (arch x shape x mesh
x variant) cell (the reference's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--variant v] [--out dryrun.jsonl]

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
2x16x16, never built), against ``launch.mesh.HW``. The trace is of the
whole global step on one meta device; per-card FLOPs are its share over
the mesh's cards.

Left out, because they parse the XLA HLO text that torch does not
produce: ``collective_bytes`` (collective operand bytes), the reference's
``launch/hlo_analysis.py`` (``analyze``: trip-count-aware HLO FLOPs and
bytes), the compile seconds and the HLO bytes, and with them the
roofline terms built on those. ``fits_hbm`` counts the persistent state
only: a meta trace has no allocator, so activations and temporaries are
not in it.

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
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import steps as step_lib
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.variants import VARIANTS
from repro_torch.models import build
from repro_torch.obs import span
from repro_torch.optim import AdamW

__all__ = ["model_flops", "lower_cell", "main", "ARCHIVE"]

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
        "fits_hbm": per_device["total"] < HW.HBM_BYTES,
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
                              f"card, fits {rec['fits_hbm']} (trace "
                              f"{rec['trace_s']:.1f}s)", file=sys.stderr)
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
