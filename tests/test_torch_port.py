"""The port's own rules: ``src/repro_torch`` and ``chip_smoke.py`` import
neither jax nor the reference package; every entry point defaults to the
GPU and raises without one; a kernel wrapper takes its plain version only
for CPU tensors; kernel builds stay out of the linted source tree; and
``interop`` carries jobs and markets across unchanged."""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SpotMarket, generate_chain_jobs, spot_od_policies  # noqa: E402

from repro_torch import device as port_device  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import cost_matrix, run_tola, run_tola_scenarios  # noqa: E402
from repro_torch.core import evaluate_policy_fullpool, sweep_policies  # noqa: E402
from repro_torch.engine import evaluate_grid  # noqa: E402
from repro_torch.experiments import exp1_spot_ondemand as exp1  # noqa: E402
from repro_torch.experiments import exp2_self_owned as exp2  # noqa: E402
from repro_torch.experiments import exp3_policy12 as exp3  # noqa: E402
from repro_torch.experiments import table6  # noqa: E402
from repro_torch.kernels import policy_cost as pc  # noqa: E402
from repro_torch.learn import replay  # noqa: E402
from repro_torch.sched import FleetOrchestrator, FleetSpec  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 15
    # the rank processes of the mesh tests import what this module does
    return files + [REPO / "chip_smoke.py", REPO / "tests" /
                    "torch_mesh_ranks.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small():
    jobs = generate_chain_jobs(6, job_type=1, seed=2)
    m = SpotMarket(max(j.deadline for j in jobs) + 1, seed=3)
    jobs_t = interop.chain_jobs_from_arrays(*interop.chain_jobs_to_arrays(jobs))
    market_t = interop.markets_from_prices(m.price, m.slot)[0]
    pols_t = interop.policies_from_tuples(
        [(p.beta, p.bid, p.beta0) for p in spot_od_policies()[:3]])
    return jobs_t, market_t, pols_t


ENTRY_POINTS = {
    "evaluate_grid": lambda j, m, p: evaluate_grid(j, p, [m]),
    "cost_matrix": lambda j, m, p: cost_matrix(j, p, m),
    "run_tola": lambda j, m, p: run_tola(j, p, m),
    "run_tola_scenarios": lambda j, m, p: run_tola_scenarios(j, p, [m]),
    "replay": lambda j, m, p: replay(np.ones((4, 3)), np.arange(4.0), 1.0),
    "replay(learner_replay)": lambda j, m, p: replay(
        np.ones((4, 3)), np.arange(4.0), 1.0, learners=["exp3", "ftl"]),
    "FleetOrchestrator.schedule": lambda j, m, p: FleetOrchestrator(
        FleetSpec(reserved_pods=1), 10.0).schedule([]),
    "table6.run": lambda j, m, p: table6.run(4, [0]),
    "exp1.run": lambda j, m, p: exp1.run(4, [1]),
    "exp2.run": lambda j, m, p: exp2.run(4, [1], [0]),
    "exp3.run": lambda j, m, p: exp3.run(4, [1], [0]),
    "sweep_policies": lambda j, m, p: sweep_policies(j, p, m),
    "evaluate_policy_fullpool":
        lambda j, m, p: evaluate_policy_fullpool(j, p[0], m),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_gpu(no_gpu, small, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](*small)


def test_cpu_is_only_by_request(small):
    jobs_t, market_t, pols_t = small
    res = evaluate_grid(jobs_t, pols_t, market_t, device="cpu")
    assert res.device == "cpu" and res.unit_cost.shape == (1, 6, 3)
    # scenario chunks are ported (one chunk of one market: the same pass)
    chunked = evaluate_grid(jobs_t, pols_t, market_t, device="cpu",
                            scenario_chunk=1)
    np.testing.assert_array_equal(chunked.unit_cost, res.unit_cost)
    # a 1x1 mesh (no process group) is the unsharded computation
    meshed = evaluate_grid(jobs_t, pols_t, market_t, device="cpu", mesh=1)
    np.testing.assert_array_equal(meshed.unit_cost, res.unit_cost)


def test_wrapper_raises_for_a_device_without_kernel():
    """Only CPU tensors take the plain version; any other device launches
    the kernel or raises (here: a device that has no kernel at all)."""
    args = [torch.zeros((1, 1, 5)), torch.zeros((1, 1, 5)), torch.zeros((1, 2)),
            torch.ones((1, 2, 3)), torch.ones((1, 2, 3)),
            torch.ones((1, 2, 3)), torch.zeros((1, 2, 3))]
    out = pc.policy_cost_chain(*args)
    assert out["spot_cost"].shape == (1, 1, 2)
    with pytest.raises(ValueError, match="no kernel"):
        pc.policy_cost_chain(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="inconsistent"):
        pc.policy_cost_chain(*args[:3], torch.ones((1, 3, 3)), *args[4:])


def test_resolve_device_without_gpu(no_gpu):
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        port_device.resolve_device("cuda")


def test_kernel_builds_stay_out_of_the_source_tree():
    build = port_device.BUILD_DIR.resolve()
    assert build == REPO / "build" / "torch_kernels"
    assert "build/torch_kernels/" in (REPO / ".gitignore").read_text().split()
    assert {p.name for p in port_device.CSRC.glob("*.cu")} == {
        f"{n}.cu" for n in port_device.KERNEL_SOURCES}


def test_interop_round_trips_jobs_and_markets():
    jobs = generate_chain_jobs(5, job_type=2, seed=7)
    jobs_t = interop.chain_jobs_from_arrays(*interop.chain_jobs_to_arrays(jobs))
    for a, b in zip(jobs, jobs_t):
        assert (a.arrival, a.deadline) == (b.arrival, b.deadline)
        assert [(t.z, t.delta) for t in a.tasks] == \
            [(t.z, t.delta) for t in b.tasks]
    for back in (interop.chain_jobs_to_arrays(jobs_t),):
        for x, y in zip(back[:2], interop.chain_jobs_to_arrays(jobs)[:2]):
            np.testing.assert_array_equal(x, y)
    markets = [SpotMarket(40.0, seed=s) for s in (1, 2)]
    markets_t = interop.markets_from_prices(
        np.stack([m.price for m in markets]), markets[0].slot)
    for m, mt in zip(markets, markets_t):
        assert (mt.n_slots, mt.slot, mt.p_ondemand) == \
            (m.n_slots, m.slot, m.p_ondemand)
        np.testing.assert_array_equal(mt.price, m.price)
        np.testing.assert_array_equal(mt.view(0.24).A_cum, m.view(0.24).A_cum)
        np.testing.assert_array_equal(mt.view(0.24).C_cum, m.view(0.24).C_cum)
    pols = interop.policies_from_tuples([(0.5, 0.18), (1.0, 0.3, 0.6)])
    assert pols[0].beta0 is None and pols[1].beta0 == 0.6
    with pytest.raises(ValueError):
        interop.markets_from_prices(markets[0].price, slot=0.07)


# ---------------------------------------------------------------------------
# One clock (the reference's rule RPR001): spans in obs/trace.py time all
# ---------------------------------------------------------------------------

_CLOCKS = {"perf_counter", "perf_counter_ns", "time", "time_ns", "monotonic",
           "monotonic_ns"}


def _clock_reads(tree: ast.AST) -> list[int]:
    """Lines that name one of ``time``'s clocks: ``time.<clock>`` or a
    clock imported from ``time``."""
    mods = {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.Import) for a in node.names
            if a.name == "time"}
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time" \
                and any(a.name in _CLOCKS for a in node.names):
            bad.append(node.lineno)
        elif isinstance(node, ast.Attribute) and node.attr in _CLOCKS \
                and isinstance(node.value, ast.Name) and node.value.id in mods:
            bad.append(node.lineno)
    return sorted(bad)


def test_clock_scan_finds_every_form():
    src = ("import time\nimport time as t\nfrom time import monotonic\n"
           "a = time.perf_counter()\nb = t.time()\nc = time.sleep\n"
           "d = time.monotonic_ns\nclass X:\n    time = 1\nX.time\n")
    assert _clock_reads(ast.parse(src)) == [3, 4, 5, 7]


@pytest.mark.parametrize(
    "path", sorted((REPO / "src" / "repro_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(REPO)))
def test_only_obs_trace_reads_a_clock(path):
    lines = _clock_reads(ast.parse(path.read_text()))
    if path.relative_to(REPO / "src" / "repro_torch").as_posix() \
            == "obs/trace.py":
        assert lines, "obs/trace.py is where the spans read the clock"
    else:
        assert not lines, f"a clock outside obs/trace.py at lines {lines}"


# ---------------------------------------------------------------------------
# Every collective is one of engine/mesh.py's three counted helpers, so
# obs.compiled.collective_counts sees all that the port can issue
# ---------------------------------------------------------------------------

_COLLECTIVES = {
    "all_reduce", "all_reduce_coalesced", "all_gather",
    "all_gather_into_tensor", "all_gather_coalesced", "all_gather_object",
    "all_to_all", "all_to_all_single", "broadcast", "broadcast_object_list",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "gather",
    "gather_object", "scatter", "scatter_object_list", "barrier",
    "monitored_barrier", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "send_object_list", "recv_object_list"}


def _dist_reach(tree: ast.AST) -> list[int]:
    """Lines that reach ``torch.distributed``: an import of it or of a
    module under it, or the attribute ``torch.distributed``."""

    def under(name):
        return name == "torch.distributed" \
            or name.startswith("torch.distributed.")

    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) \
                and any(under(a.name) for a in node.names):
            bad.append(node.lineno)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and (
                under(node.module or "") or node.module == "torch"
                and any(a.name == "distributed" for a in node.names)):
            bad.append(node.lineno)
        elif isinstance(node, ast.Attribute) and node.attr == "distributed" \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "torch":
            bad.append(node.lineno)
    return sorted(set(bad))


def _collective_calls(tree: ast.Module) -> dict[str, set[str]]:
    """The collectives each top-level function calls on a name
    (``dist.all_reduce(...)``); ``"<module>"`` for calls anywhere else
    (module level, class bodies and methods)."""
    found: dict[str, set[str]] = {}
    for top in tree.body:
        owner = top.name if isinstance(top, ast.FunctionDef) else "<module>"
        for node in ast.walk(top):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _COLLECTIVES \
                    and isinstance(node.func.value, ast.Name):
                found.setdefault(owner, set()).add(node.func.attr)
    return found


def test_collective_scans_find_every_form():
    src = ("import torch.distributed as dist\n"
           "from torch.distributed import all_reduce\n"
           "from torch import distributed\n"
           "x = torch.distributed.barrier\n"
           "import torch.distributed.device_mesh\n"
           "from torch.distributed._functional_collectives import f\n"
           "import torch\nfrom torch import nn\ny = torch.cuda\n")
    assert _dist_reach(ast.parse(src)) == [1, 2, 3, 4, 5, 6]
    src = ("def f(d):\n    d.all_reduce(1)\n    d.get_rank()\n"
           "class C:\n    def g(self, d):\n        d.barrier()\n"
           "def h(t):\n    t.x.gather(0)\n")
    assert _collective_calls(ast.parse(src)) == {
        "f": {"all_reduce"}, "<module>": {"barrier"}}


@pytest.mark.parametrize(
    "path", sorted((REPO / "src" / "repro_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(REPO)))
def test_only_engine_mesh_issues_collectives(path):
    tree = ast.parse(path.read_text())
    if path.relative_to(REPO / "src" / "repro_torch").as_posix() \
            == "engine/mesh.py":
        # each helper issues its own kind (gloo and NCCL forms; the
        # ordered gloo sum gathers each chunk's parts) and no other
        # function of the module issues any
        assert _collective_calls(tree) == {
            "all_gather": {"all_gather", "all_gather_into_tensor"},
            "all_reduce": {"all_reduce", "all_gather"},
            "permute": {"batch_isend_irecv"}}
    else:
        lines = _dist_reach(tree)
        assert not lines, \
            f"torch.distributed outside engine/mesh.py at lines {lines}"


# ---------------------------------------------------------------------------
# Every bounded cache is in obs.compiled's factory list
# ---------------------------------------------------------------------------

def _bounded_caches(path) -> set[tuple[str, str]]:
    """(module, name) of each ``functools.lru_cache``-decorated function
    and each module-level ``_LRU(...)`` of a port file."""
    tree = ast.parse(path.read_text())
    mod = "repro_torch." + path.relative_to(
        REPO / "src" / "repro_torch").with_suffix("").as_posix().replace(
        "/", ".")
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                fn = dec.func if isinstance(dec, ast.Call) else dec
                if isinstance(fn, ast.Attribute) and fn.attr in (
                        "lru_cache", "cache") or isinstance(fn, ast.Name) \
                        and fn.id in ("lru_cache", "cache"):
                    found.add((mod, node.name))
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Name) \
                and node.value.func.id == "_LRU":
            found |= {(mod, t.id) for t in node.targets}
    return found


def test_every_bounded_cache_is_registered():
    from repro_torch.obs.compiled import _FACTORIES, factory_caches

    found = set()
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        found |= _bounded_caches(path)
    registered = {(m, a) for _, m, a in _FACTORIES}
    assert found == registered
    assert len(found) == 15
    names = [n for n, _, _ in _FACTORIES]
    assert len(set(names)) == len(names)
    assert set(factory_caches()) == set(names)


# ---------------------------------------------------------------------------
# The reference's public names (ROADMAP A13)
# ---------------------------------------------------------------------------

# Names of the reference's __all__ the port leaves out, and why:
# policy_cost_batch is the reference's jnp cost path (the port's cost
# kernels are reached through the engine), record_jit announces a
# compiled XLA program (the port compiles none; record_launch takes its
# place), and the engine has no backend switch (available_backends,
# resolve_backend: the port has one backend) and no XLA compilation cache
# (setup_persistent_cache: its nvcc builds persist in build/).
OMITTED = {
    "analysis": set(),
    "ckpt": set(),
    "configs": set(),
    "core": set(),
    "data": set(),
    "distributed": set(),
    "engine": {"available_backends", "resolve_backend",
               "setup_persistent_cache"},
    "kernels": {"policy_cost_batch"},
    "obs": {"record_jit"},
    "optim": set(),
}
# Names the port adds: its own result types, the launch counter, the
# launch-capture hook, the engine's scenario batches and sources, and the
# registry's list of ported architectures.
ADDED = {
    "analysis": set(),
    "ckpt": set(),
    "configs": {"PORTED"},
    "core": {"JobCost", "TaskCost", "TolaResult"},
    "data": set(),
    "distributed": set(),
    "engine": {"MarketListBatch", "SCENARIO_KINDS", "ScenarioSource",
               "SynthBatch"},
    "kernels": {"LAUNCHES"},
    "obs": {"record_launch"},
    "optim": set(),
}


@pytest.mark.parametrize("pkg", sorted(OMITTED))
def test_public_names_match_the_reference(pkg):
    import importlib

    ref = set(importlib.import_module(f"repro.{pkg}").__all__)
    port_mod = importlib.import_module(f"repro_torch.{pkg}")
    port = set(port_mod.__all__)
    assert OMITTED[pkg] <= ref and not ADDED[pkg] & ref
    assert port == (ref - OMITTED[pkg]) | ADDED[pkg]
    for name in port:
        assert hasattr(port_mod, name), name


def test_a13_names_are_the_port_s_own():
    import repro_torch.core as core
    import repro_torch.kernels as kernels
    from repro_torch.core import scheduler, simulate, workload
    from repro_torch.kernels import ops

    assert core.build_plans_batch is scheduler.build_plans_batch
    assert core.job_arrays is scheduler.job_arrays
    assert core.simulate_tasks is simulate.simulate_tasks
    assert core.generate_dag_jobs is workload.generate_dag_jobs
    assert kernels.flash_attention is ops.flash_attention
    assert kernels.ssd is ops.ssd
    q = torch.randn(1, 5, 2, 8, generator=torch.Generator().manual_seed(0))
    assert kernels.flash_attention(q, q, q).shape == q.shape


# The reference's launch/ modules and their public names (its __all__, or
# its public top-level definitions where it has none), and what the port
# leaves out: the dry-run's append_cache, which writes
# benchmarks/roofline_cache.json (the port's dry-run writes JSON lines
# under build/archive/ and never there). The reference's hlo_analysis
# (trip-count-aware FLOPs, bytes and collective bytes of XLA HLO text) has
# its counterpart under another name, op_analysis (the same three terms
# counted op by op over one rank's step), with the same public names. The
# port adds the production mesh's abstract type, the dry-run's archive
# path, the fitted shardings and the meshed train and serve steps.
LAUNCH_OMITTED = {"dryrun": {"append_cache"},
                  "hlo_analysis": None, "mesh": set(), "serve": set(),
                  "steps": set(), "train": set(), "variants": set()}
LAUNCH_COUNTERPART = {"hlo_analysis": "op_analysis"}
LAUNCH_ADDED = {"dryrun": {"ARCHIVE"}, "mesh": {"AbstractMesh"},
                "op_analysis": set(), "serve": set(),
                "steps": {"fitted", "ShardedTrainStep", "ShardedServeStep"},
                "train": set(), "variants": set()}


def _public_names(path) -> set[str]:
    """A module's ``__all__``, or its public top-level definitions, read
    from its source (importing the reference's dry-run would set its
    512-device XLA flag in this process)."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


@pytest.mark.parametrize("module", sorted(LAUNCH_OMITTED))
def test_launch_modules_match_the_reference(module):
    import importlib

    ref_path = REPO / "src" / "repro" / "launch" / f"{module}.py"
    assert ref_path.is_file()
    assert {p.stem for p in ref_path.parent.glob("*.py")} \
        == set(LAUNCH_OMITTED)
    port_path = REPO / "src" / "repro_torch" / "launch" / f"{module}.py"
    ref = _public_names(ref_path)
    omitted = LAUNCH_OMITTED[module]
    if omitted is None:      # ported under another name
        assert not port_path.exists()
        module, omitted = LAUNCH_COUNTERPART[module], set()
        assert ref == {"analyze"}
        port_path = REPO / "src" / "repro_torch" / "launch" / f"{module}.py"
        assert port_path.is_file()
    port_mod = importlib.import_module(f"repro_torch.launch.{module}")
    assert omitted <= ref
    assert not LAUNCH_ADDED[module] & ref
    assert set(port_mod.__all__) == (ref - omitted) | LAUNCH_ADDED[module]
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), name
