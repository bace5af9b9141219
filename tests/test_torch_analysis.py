"""The port's static contract checker, ``repro_torch.analysis``, held
against the reference's ``repro.analysis``.

Layer 1: the rules the port copies (RPR001, RPR002, RPR004, noqa and the
parse error) give the same findings as the reference on the same fixture
sources, with the path mapped from ``src/repro/`` to ``src/repro_torch/``;
the report renders byte for byte as the reference's; the baseline round
trips; the torch forms of RPR003, RPR005 and RPR007 fire and stay silent
on their fixtures; ``src/repro_torch`` is clean under its baseline; the
CLI's exit codes. Layer 2 on the CPU: the full inventory passes on a 1x1
gloo mesh, and each check fails on a planted fault.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import analyze_source as ref_analyze  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402

from repro_torch.analysis import (Baseline, analyze_source,  # noqa: E402
                                  load_baseline, run_source_analysis)
from repro_torch.analysis import report  # noqa: E402
from repro_torch.analysis.engine import BaselineEntry  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
BASELINE = REPO / "analysis-baseline-torch.json"

LIB = "src/repro_torch/engine/foo.py"          # generic library module
DEVICE = "src/repro_torch/kernels/foo.py"      # device-path module
GUARDED = "src/repro_torch/core/simulate.py"   # knife-edge module
HOST = "src/repro_torch/core/foo.py"           # off the device path


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _codes(src, path):
    return [f.code for f in analyze_source(src, path)]


# --------------------------------------------------------------------------
# Parity with the reference on the copied rules
# --------------------------------------------------------------------------

_COPIED = {"RPR000", "RPR001", "RPR002", "RPR004"}
_REF_LIB = "src/repro/engine/foo.py"
_REF_GUARDED = "src/repro/core/simulate.py"

PARITY = {
    "timing": ("import time\nt0 = time.perf_counter()\n", _REF_LIB),
    "timing-import": ("from time import perf_counter, monotonic\n",
                      _REF_LIB),
    "timing-in-trace": ("import time\nt0 = time.perf_counter_ns()\n",
                        "src/repro/obs/trace.py"),
    "span": ("from repro.obs import span\n"
             "with span('phase') as sp:\n    pass\n", _REF_LIB),
    "cache-unbounded": ("import functools\n"
                        "@functools.lru_cache(maxsize=None)\n"
                        "def f():\n    return 1\n"
                        "g = functools.lru_cache(None)(len)\n", _REF_LIB),
    "cache-bare": ("import functools\n"
                   "@functools.lru_cache\ndef f():\n    return 1\n"
                   "@functools.cache\ndef g():\n    return 2\n", _REF_LIB),
    "cache-bounded": ("import functools\n"
                      "@functools.lru_cache(maxsize=64)\n"
                      "def f():\n    return 1\n", _REF_LIB),
    "epsilon": ("def clip(x):\n    if x > 1e-9:\n        return 0.0\n"
                "    return x\n", _REF_GUARDED),
    "epsilon-chain": ("def f(x, y):\n    return 0.0 < x - y <= 5e-7\n",
                      "src/repro/core/scheduler.py"),
    "named-guard": ("FLEX_REL = 1e-6\ndef clip(x, y):\n"
                    "    if x > FLEX_REL * 1e-5:\n        return 0.0\n"
                    "    return x\n", _REF_GUARDED),
    "known-guard": ("def f(x):\n    return x < _DEVICE_CEIL_EPS + 1e-7\n",
                    "src/repro/core/dealloc.py"),
    "large-literal": ("def f(x):\n    return x > 0.5\n", _REF_GUARDED),
    "epsilon-out-of-scope": ("def f(x):\n    return x > 1e-9\n", _REF_LIB),
    "noqa": ("def f(x):\n    return x > 1e-9  # repro: noqa RPR004\n",
             _REF_GUARDED),
    "noqa-bare": ("def f(x):\n    return x > 1e-9  # repro: noqa\n",
                  _REF_GUARDED),
    "noqa-other": ("def f(x):\n    return x > 1e-9  # repro: noqa RPR001\n",
                   _REF_GUARDED),
    "noqa-list": ("import time\nt = time.time() > 1e-9  "
                  "# repro: noqa RPR001, RPR004\n", _REF_GUARDED),
    "syntax": ("def broken(:\n", _REF_LIB),
    "mixed": ("import time\nt0 = time.time()\n"
              "def f(x):\n    return x > 1e-9\n", _REF_GUARDED),
}


def _port_path(ref_path: str) -> str:
    return ref_path.replace("src/repro/", "src/repro_torch/", 1)


def _key(findings):
    return [(f.code, f.line, f.col) for f in findings if f.code in _COPIED]


@pytest.mark.parametrize("name", sorted(PARITY))
def test_copied_rules_match_the_reference(name):
    src, ref_path = PARITY[name]
    ref = ref_analyze(src, ref_path)
    got = analyze_source(src, _port_path(ref_path))
    assert _key(got) == _key(ref)
    assert {f.path for f in got} <= {_port_path(ref_path)}


def test_parity_fixtures_cover_every_copied_code():
    seen = {f.code for src, path in PARITY.values()
            for f in ref_analyze(src, path)}
    assert _COPIED <= seen


@pytest.mark.parametrize("name", ["mixed", "timing", "cache-bare", "syntax",
                                  "cache-bounded"])
def test_report_renders_as_the_reference(name):
    src, ref_path = PARITY[name]
    found = analyze_source(src, _port_path(ref_path))
    active, baselined = found[:1], found[1:]
    for a, b in ((active, baselined), (found, []), ([], found)):
        assert report.render_json(a, b) == ref_report.render_json(a, b)
        assert report.summary_table(a, b) == ref_report.summary_table(a, b)
        assert report.render_text(a, b) == ref_report.render_text(a, b)


def test_public_names_are_the_reference_s():
    import repro.analysis as ref
    import repro_torch.analysis as port

    assert port.__all__ == ref.__all__
    assert [r.code for r in port.RULES] == [r.code for r in ref.RULES]


# --------------------------------------------------------------------------
# Suppression: inline noqa + content-keyed baseline (tests/test_analysis.py)
# --------------------------------------------------------------------------

def test_baseline_roundtrip_is_content_keyed(tmp_path):
    mod = tmp_path / "src" / "repro_torch" / "core"
    mod.mkdir(parents=True)
    target = mod / "simulate.py"
    target.write_text("def g(x):\n    return x > 1e-9\n")

    active, baselined = run_source_analysis(["src"], tmp_path, Baseline())
    assert [f.code for f in active] == ["RPR004"] and baselined == []

    bl_path = tmp_path / "analysis-baseline-torch.json"
    bl_path.write_text(json.dumps({"version": 1, "entries": [{
        "rule": "RPR004", "path": "src/repro_torch/core/simulate.py",
        "line_text": "return x > 1e-9", "justification": "fixture"}]}))
    active, baselined = run_source_analysis(
        ["src"], tmp_path, load_baseline(bl_path))
    assert active == [] and [f.code for f in baselined] == ["RPR004"]

    # a shifted line keeps its entry: the key is the line's text
    target.write_text("# padding\n\n\ndef g(x):\n    return x > 1e-9\n")
    active, baselined = run_source_analysis(
        ["src"], tmp_path, load_baseline(bl_path))
    assert active == [] and len(baselined) == 1
    assert baselined[0].line == 5


def test_missing_baseline_is_empty():
    assert len(load_baseline("/no/such/baseline.json")) == 0
    assert len(load_baseline(None)) == 0


def test_one_baseline_entry_covers_identical_lines(tmp_path):
    mod = tmp_path / "src" / "repro_torch" / "core"
    mod.mkdir(parents=True)
    (mod / "simulate.py").write_text(
        "def g(x):\n    return x > 1e-9\ndef h(x):\n    return x > 1e-9\n")
    bl = Baseline([BaselineEntry("RPR004", "src/repro_torch/core/simulate.py",
                                 "return x > 1e-9", "fixture")])
    active, baselined = run_source_analysis(["src"], tmp_path, bl)
    assert active == [] and len(baselined) == 2


# --------------------------------------------------------------------------
# The torch forms: RPR003, RPR005, RPR006, RPR007
# --------------------------------------------------------------------------

_LAUNCH = "with record_launch('k', stream):\n"

TORCH_FIRES = {
    "rpr003-dtype": ("import torch\nx = torch.zeros(3, dtype=torch.float64)\n",
                     DEVICE, ["RPR003"]),
    "rpr003-double": ("def f(x):\n    return x.double()\n", DEVICE,
                      ["RPR003"]),
    "rpr003-hot-elsewhere": (
        "import torch\ndef _inner(x):\n    return x.to(torch.double)\n"
        "def launch(x, stream):\n    " + _LAUNCH + "        _inner(x)\n",
        LIB, ["RPR003"]),
    "rpr005-item": ("def run(x):\n    with program('p'):\n"
                    "        return x.sum().item()\n", LIB, ["RPR005"]),
    "rpr005-callee": ("def _host(t):\n    return t.cpu().numpy()\n"
                      "def run(x):\n    with compiled.program('p'):\n"
                      "        return _host(x)\n", LIB,
                      ["RPR005", "RPR005"]),
    "rpr005-tolist": ("def launch(x, stream):\n    " + _LAUNCH
                      + "        return x.tolist()\n", DEVICE, ["RPR005"]),
    "rpr005-synchronize": ("import torch\ndef launch(x, stream):\n    "
                           + _LAUNCH + "        torch.cuda.synchronize()\n",
                           DEVICE, ["RPR005"]),
    "rpr005-float": ("def launch(x, stream):\n    " + _LAUNCH
                     + "        return float(x[0])\n", LIB, ["RPR005"]),
    "rpr005-table-root": ("def _device_views(h):\n    return int(h.sum())\n",
                          "src/repro_torch/engine/scenarios.py", ["RPR005"]),
    "rpr007-print": ("def f(x):\n    print(x)\n", DEVICE, ["RPR007"]),
    "rpr007-breakpoint": ("def f(x):\n    breakpoint()\n",
                          "src/repro_torch/learn/replay.py", ["RPR007"]),
    "rpr007-pdb": ("import pdb\npdb.set_trace()\n",
                   "src/repro_torch/engine/mesh.py", ["RPR007", "RPR007"]),
}

TORCH_SILENT = {
    "rpr003-host-numpy": ("import numpy as np\n"
                          "def oracle(x):\n"
                          "    return np.asarray(x, dtype=np.float64)\n",
                          DEVICE),
    "rpr003-off-device-path": ("import torch\nD = torch.float64\n"
                               "def f(x):\n    return x.double()\n", HOST),
    "rpr005-outside-hot": ("def report(x):\n    return float(x.sum().item())\n"
                           "def launch(x, stream):\n    " + _LAUNCH
                           + "        pass\n", LIB),
    "rpr005-host-constant": ("import numpy as np\n_MIX = np.uint32(3)\n"
                             "def launch(x, stream):\n    " + _LAUNCH
                             + "        return int(_MIX) + float(2.0 * 1)\n",
                             DEVICE),
    "rpr006-inert": ("import jax\nfn = jax.jit(f, donate_argnums=(0,))\n",
                     LIB),
    "rpr007-off-device-path": ("def f(x):\n    print(x)\n    breakpoint()\n",
                               HOST),
}


@pytest.mark.parametrize("name", sorted(TORCH_FIRES))
def test_torch_rule_fires(name):
    src, path, want = TORCH_FIRES[name]
    assert _codes(src, path) == want


@pytest.mark.parametrize("name", sorted(TORCH_SILENT))
def test_torch_rule_silent(name):
    src, path = TORCH_SILENT[name]
    assert _codes(src, path) == []


def test_rpr004_knows_the_port_s_guards():
    for guard in ("_DEVICE_CEIL_EPS", "_DEVICE_DUST", "_BETA_ONE_EPS",
                  "FLEX_REL"):
        src = f"def f(x):\n    return x <= {guard} * 1e-7\n"
        assert _codes(src, "src/repro_torch/core/scheduler.py") == []


# --------------------------------------------------------------------------
# The port is clean under its baseline, and the baseline is current
# --------------------------------------------------------------------------

def test_port_source_is_clean_under_baseline():
    active, baselined = run_source_analysis(
        ["src/repro_torch"], REPO, load_baseline(BASELINE))
    assert active == [], "\n".join(
        f"{f.location}: {f.code} {f.message}" for f in active)
    assert baselined


def test_every_baseline_entry_is_used_and_justified():
    entries = json.loads(BASELINE.read_text())["entries"]
    _, baselined = run_source_analysis(["src/repro_torch"], REPO,
                                       load_baseline(BASELINE))
    used = {(f.code, f.path, f.line_text) for f in baselined}
    for e in entries:
        assert (e["rule"], e["path"], e["line_text"]) in used, e
        assert len(e["justification"]) > 20, e
        if e["rule"] == "RPR003":
            assert "queue C" in e["justification"], e


# --------------------------------------------------------------------------
# CLI: exit codes 0 / 1 / 2
# --------------------------------------------------------------------------

def _cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=cwd, env=env, capture_output=True, text=True)


def test_cli_exit_codes(tmp_path):
    mod = tmp_path / "src" / "repro_torch" / "core"
    mod.mkdir(parents=True)
    target = mod / "simulate.py"

    target.write_text("def g(x):\n    return x\n")
    assert _cli(["--root", str(tmp_path)], tmp_path).returncode == 0

    target.write_text("def g(x):\n    return x > 1e-9\n")
    proc = _cli(["--root", str(tmp_path)], tmp_path)
    assert proc.returncode == 1
    assert "RPR004" in proc.stdout
    assert "src/repro_torch/core/simulate.py:2" in proc.stdout

    bad_baseline = tmp_path / "corrupt.json"
    bad_baseline.write_text("{not json")
    proc = _cli(["--root", str(tmp_path), "--baseline", str(bad_baseline)],
                tmp_path)
    assert proc.returncode == 2


def test_cli_json_format(tmp_path):
    mod = tmp_path / "src" / "repro_torch" / "core"
    mod.mkdir(parents=True)
    (mod / "simulate.py").write_text("def g(x):\n    return x > 1e-9\n")
    proc = _cli(["--root", str(tmp_path), "--format", "json"], tmp_path)
    payload = json.loads(proc.stdout)
    assert payload["counts"]["active"] == 1
    assert payload["findings"][0]["code"] == "RPR004"


def test_cli_on_the_repo_is_clean():
    proc = _cli([], REPO)
    assert proc.returncode == 0, proc.stdout
    assert proc.stdout.splitlines()[-1].split()[0] == "total"


def test_cli_programs_default_to_the_card():
    proc = _cli(["--no-lint", "--programs"], REPO)
    assert proc.returncode == 2
    assert "device='cpu'" in proc.stderr


# --------------------------------------------------------------------------
# Layer 2 on the CPU
# --------------------------------------------------------------------------

@pytest.fixture
def gloo_mesh(tmp_path):
    """The 1x1 mesh over a one-rank gloo process group."""
    import torch.distributed as dist

    from repro_torch.engine import GridMesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = GridMesh.create(1)
        assert mesh.mesh is not None
        yield mesh
    finally:
        dist.destroy_process_group()


def test_full_inventory_passes_on_a_gloo_mesh(gloo_mesh):
    from repro_torch.analysis.programs import PROGRAM_KEYS, verify_all

    checks = verify_all(device="cpu")
    failed = [c for c in checks if not c.ok]
    assert not failed, "\n".join(
        f"{c.program}/{c.check}: {c.detail}" for c in failed)
    assert {c.program for c in checks} == set(PROGRAM_KEYS)
    by = {(c.program, c.check): c for c in checks}
    for key in PROGRAM_KEYS:
        assert {c.check for c in checks if c.program == key} == {
            "build", "syncs", "dtype", "mutation", "collectives"}, key
    fold = by["learn.fold:sharded", "mutation"]
    assert "accumulator" in fold.detail
    assert "'all-reduce': 1" in by["learn.fold:sharded",
                                  "collectives"].detail
    assert "'all-gather': 1" in by["engine.gather:sharded",
                                  "collectives"].detail
    assert "allowances" in by["scenarios.views:sharded", "dtype"].detail


def test_inventory_passes_without_a_process_group():
    from repro_torch.analysis.programs import verify_all
    from repro_torch.obs.compiled import placement_violations

    keys = ["engine.eval.chain:sharded", "engine.gather:sharded",
            "learn.fold:sharded"]
    checks = verify_all(keys=keys, device="cpu")
    assert {c.program for c in checks} == set(keys)
    assert all(c.ok for c in checks)
    assert placement_violations(keys=keys, device="cpu") == []


def test_unknown_key_is_a_failure():
    from repro_torch.analysis.programs import verify_all

    checks = verify_all(keys=["no.such.program"], device="cpu")
    assert [(c.program, c.check, c.ok) for c in checks] == [
        ("no.such.program", "build", False)]


def test_programs_default_to_the_card(monkeypatch):
    from repro_torch.analysis.programs import verify_all

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        verify_all(keys=["kernels.ssd_scan"])


def _one(checks, name):
    (c,) = [c for c in checks if c.check == name]
    return c


def test_broken_placement_contract_fails_with_program_key():
    from repro_torch.analysis.programs import verify_program
    from repro_torch.engine import GridMesh
    from repro_torch.engine.mesh import all_gather

    mesh = GridMesh.create(1)
    checks = verify_program(lambda x: all_gather(mesh, x) * 2.0,
                            (torch.ones(4),), key="demo.sneaky-gather",
                            collectives={"total": 0}, device="cpu")
    coll = _one(checks, "collectives")
    assert not coll.ok and coll.program == "demo.sneaky-gather"
    assert "demo.sneaky-gather" in coll.detail
    assert "off contract" in coll.detail and "total=1" in coll.detail


@pytest.mark.parametrize("fault", ["item", "float", "nonzero", "mask"])
def test_host_sync_fails_syncs(fault):
    from repro_torch.analysis.programs import verify_program

    fns = {"item": lambda x: x * x.sum().item(),
           "float": lambda x: x * float(x[0]),
           "nonzero": lambda x: torch.nonzero(x > 0),
           "mask": lambda x: x[x > 0]}
    checks = verify_program(fns[fault], (torch.arange(4.0) - 1.0,),
                            key=f"demo.{fault}", device="cpu")
    syncs = _one(checks, "syncs")
    assert not syncs.ok and f"demo.{fault}" in syncs.detail
    assert _one(checks, "build").ok


def test_float64_output_fails_dtype():
    from repro_torch.analysis.programs import verify_program

    checks = verify_program(lambda x: x.double() * 2.0, (torch.ones(4),),
                            key="demo.f64", device="cpu")
    dt = _one(checks, "dtype")
    assert not dt.ok and "demo.f64" in dt.detail and "float64" in dt.detail
    # the same op is allowed only where a named allowance lists it
    ok = verify_program(lambda x: torch.cumsum(x, 0, dtype=torch.float64)
                        .float(), (torch.ones(4),),
                        key="scenarios.views:sharded", device="cpu")
    assert _one(ok, "dtype").ok


def test_mutated_argument_fails_mutation():
    from repro_torch.analysis.programs import verify_program

    x = torch.ones(4)
    checks = verify_program(lambda a, b: a.add_(b), (x, torch.ones(4)),
                            key="demo.write", device="cpu")
    mut = _one(checks, "mutation")
    assert not mut.ok and "demo.write" in mut.detail and "[0]" in mut.detail
    # declared: the accumulator must move, and nothing else
    ok = verify_program(lambda a, b: a.add_(b), (x, torch.ones(4)),
                        key="demo.acc", mutated=(0,), device="cpu")
    assert _one(ok, "mutation").ok
    idle = verify_program(lambda a, b: a + b, (x, torch.ones(4)),
                          key="demo.idle", mutated=(0,), device="cpu")
    assert not _one(idle, "mutation").ok


def test_a_failing_program_fails_build():
    from repro_torch.analysis.programs import verify_program

    def broken(x):
        raise ValueError("no")

    checks = verify_program(broken, (torch.ones(2),), key="demo.broken",
                            device="cpu")
    assert [(c.check, c.ok) for c in checks] == [("build", False)]
    assert "demo.broken" in checks[0].detail
