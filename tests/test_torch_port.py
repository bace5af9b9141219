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
    return files + [REPO / "chip_smoke.py"]


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
    with pytest.raises(TypeError):
        evaluate_grid(jobs_t, pols_t, market_t, device="cpu",
                      scenario_chunk=1)
    with pytest.raises(TypeError):
        evaluate_grid(jobs_t, pols_t, market_t, device="cpu", mesh=1)


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
