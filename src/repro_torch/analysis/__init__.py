"""repro_torch.analysis — the static contract checker of the port, the
counterpart of ``repro.analysis`` (which the port does not import).

Two layers:

- **Layer 1** (``rules``/``engine``): stdlib-``ast`` source rules
  ``RPR0xx`` over the port's written invariants — timing, cache bounds,
  float64 discipline on the device, named epsilon guards, host syncs in
  hot functions, the (inert) donation whitelist, debug-free hot path. No
  code execution, no torch required.
- **Layer 2** (``programs``): the program verifier — runs the registered
  programs (the sharded eval and gather, synthesis and views, the device
  plan, the learners' scan and sharded fold, every kernel wrapper) once at
  canonical small shapes on the requested device and asserts no host
  sync, no float64 output outside named allowances, no argument written
  but the fold's accumulator, the §9 placement contract's collective
  counts and, on the card, each kernel's launch.

CLI: ``python -m repro_torch.analysis [--format text|json]
[--baseline analysis-baseline-torch.json] [--programs [--device
cpu|cuda]] [paths...]``; exits 0 (clean) / 1 (findings) / 2 (internal
error).
"""

from .engine import (Baseline, analyze_source, load_baseline,
                     run_source_analysis)
from .rules import RULES, RULES_BY_CODE, Finding

__all__ = [
    "Baseline", "Finding", "RULES", "RULES_BY_CODE", "analyze_source",
    "load_baseline", "run_source_analysis",
]
