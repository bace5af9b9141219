"""CLI: ``python -m repro_torch.analysis [opts] [paths...]``.

Exit codes: 0 = clean, 1 = findings (lint or program-contract
violations), 2 = internal error. Default path: ``src/repro_torch`` under
the repo root; default baseline: ``analysis-baseline-torch.json`` there.
``--programs`` runs the Layer-2 verifier on ``--device`` (the card by
default; without one it raises, naming ``device="cpu"``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import traceback

from .engine import load_baseline, run_source_analysis
from .report import render_json, render_text


def _repo_root() -> pathlib.Path:
    # src/repro_torch/analysis/__main__.py -> repo root three levels above
    return pathlib.Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="Static contract checker (source rules + program "
                    "verifier) for the PyTorch/CUDA port.")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (default: <root>/analysis-"
                         "baseline-torch.json if present)")
    ap.add_argument("--root", default=None,
                    help="repo root for relative paths (default: "
                         "autodetected)")
    ap.add_argument("--programs", action="store_true",
                    help="also run the Layer-2 program verifier "
                         "(requires torch)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where --programs runs the programs (default: "
                         "the card)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the Layer-1 source rules (with --programs: "
                         "verifier only)")
    args = ap.parse_args(argv)

    root = pathlib.Path(args.root).resolve() if args.root else _repo_root()
    baseline_path = args.baseline
    if baseline_path is None:
        cand = root / "analysis-baseline-torch.json"
        baseline_path = cand if cand.exists() else None

    active, baselined = [], []
    if not args.no_lint:
        default = pathlib.Path("src") / "repro_torch"
        paths = args.paths or ([default] if (root / default).is_dir()
                               else [])
        baseline = load_baseline(baseline_path)
        active, baselined = run_source_analysis(paths, root, baseline)

    checks = []
    if args.programs:
        from .programs import verify_all

        checks = verify_all(device=args.device)

    failed = [c for c in checks if not c.ok]
    if args.format == "json":
        payload = json.loads(render_json(active, baselined))
        if args.programs:
            payload["programs"] = [c.to_dict() for c in checks]
            payload["counts"]["program_failures"] = len(failed)
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        if not args.no_lint:
            print(render_text(active, baselined))
        if args.programs:
            print()
            width = max((len(c.program) for c in checks), default=8)
            for c in checks:
                mark = "ok " if c.ok else "FAIL"
                print(f"[{mark}] {c.program:<{width}} {c.check:<12} "
                      f"{c.detail}")
            print(f"\nprograms: {len({c.program for c in checks})} verified, "
                  f"{len(failed)} failed checks")
    return 1 if (active or failed) else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        sys.exit(2)
