"""The rest of the port's host core and its fleet orchestrator against the
reference, on the same inputs:

* ``SpotMarket(price_model=...)`` (shifted, clip, truncate) bit for bit —
  prices, availability, per-bid views and ``beta_realized`` — and the
  truncated exponential's rate;
* ``SelfOwnedPool.available``, ``reserve`` and ``utilization`` on
  hypothesis-drawn reservation sequences, over-reservation included;
* ``chain_of``, ``TaskCost`` and ``JobCost``;
* ``sched/``: ``StragglerDetector`` (as ``test_substrate.py``'s
  ``TestStraggler``), ``training_job_dag`` and ``estimate_stage_seconds``
  bit for bit, and ``FleetOrchestrator.schedule`` (with and without
  learning) and ``stage_plan`` on ``device="cpu"`` at
  ``tests/test_system.py``'s inputs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.sched as ref_sched  # noqa: E402
import repro.sched.orchestrator as ref_orchestrator  # noqa: E402
from repro.core.market import truncated_exp_rate as ref_rate  # noqa: E402
from repro.core.types import JobCost as RefJobCost  # noqa: E402
from repro.core.types import TaskCost as RefTaskCost  # noqa: E402

import repro_torch.core as core  # noqa: E402
import repro_torch.sched as sched  # noqa: E402
from repro_torch.core.market import sample_truncated_exp, truncated_exp_rate  # noqa: E402
from repro_torch.core.types import JobCost, TaskCost  # noqa: E402

TOL = 1e-5
BIDS = (0.12, 0.18, 0.21, 0.24, 0.27, 0.30, 0.5, 1.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- the market's price models ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 1000])
@pytest.mark.parametrize("price_model", ["shifted", "clip", "truncate"])
def test_price_models_bit_identical(price_model, seed):
    ref = ref_core.SpotMarket(40.0, seed=seed, price_model=price_model)
    got = core.SpotMarket(40.0, seed=seed, price_model=price_model)
    np.testing.assert_array_equal(got.price, ref.price)
    assert (got.n_slots, got.slot) == (ref.n_slots, ref.slot)
    for bid in BIDS:
        np.testing.assert_array_equal(got.availability(bid),
                                      ref.availability(bid))
        assert got.beta_realized(bid) == ref.beta_realized(bid)
        gv, rv = got.view(bid), ref.view(bid)
        np.testing.assert_array_equal(gv.A_cum, rv.A_cum)
        np.testing.assert_array_equal(gv.C_cum, rv.C_cum)


def test_price_model_ablations_differ_and_unknown_raises():
    """The three readings of the paper's price law give different markets
    (the truncated one is available almost everywhere); an unknown name
    raises as the reference's does."""
    betas = {pm: core.SpotMarket(200.0, seed=1, price_model=pm)
             .beta_realized(0.24) for pm in ("shifted", "clip", "truncate")}
    assert betas["shifted"] < betas["clip"] < betas["truncate"]
    with pytest.raises(ValueError, match="price_model"):
        core.SpotMarket(10.0, price_model="lognormal")
    with pytest.raises(ValueError, match="price_model"):
        ref_core.SpotMarket(10.0, price_model="lognormal")


@pytest.mark.parametrize("mean, lo, hi", [(0.13, 0.12, 1.0), (0.5, 0.0, 2.0),
                                          (0.2, 0.1, 0.3)])
def test_truncated_exponential_bit_identical(mean, lo, hi):
    assert truncated_exp_rate(mean, lo, hi) == ref_rate(mean, lo, hi)
    from repro.core.market import sample_truncated_exp as ref_sample
    got = sample_truncated_exp(np.random.default_rng(5), 2000, mean, lo, hi)
    want = ref_sample(np.random.default_rng(5), 2000, mean, lo, hi)
    np.testing.assert_array_equal(got, want)
    assert np.all((got >= lo) & (got <= hi))
    with pytest.raises(ValueError):
        truncated_exp_rate(hi, lo, hi)


# -- the self-owned pool --------------------------------------------------------

_window = st.tuples(st.floats(0.0, 12.0), st.floats(0.0, 4.0),
                    st.integers(-1, 4), st.one_of(st.none(),
                                                  st.floats(0.0, 5.0)))


@settings(max_examples=60, deadline=None)
@given(total=st.integers(0, 6), horizon=st.floats(1.0, 12.0),
       ops=st.lists(_window, max_size=25))
def test_pool_matches_reference(total, horizon, ops):
    """available / reserve / utilization on a drawn reservation sequence,
    the over-reservation error included, step for step."""
    got = core.SelfOwnedPool(total, horizon)
    ref = ref_core.SelfOwnedPool(total, horizon)
    for t1, span, count, worked in ops:
        t2 = t1 + span
        assert got.available(t1, t2) == ref.available(t1, t2)
        errors = []
        for pool in (got, ref):
            try:
                pool.reserve(t1, t2, count, worked)
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        assert errors[0] == errors[1]
        np.testing.assert_array_equal(got.used, ref.used)
        assert got.utilization(horizon) == ref.utilization(horizon)
        assert got.reserved_instance_time == ref.reserved_instance_time


def test_pool_over_reservation_raises():
    pool = core.SelfOwnedPool(2, 10.0)
    pool.reserve(1.0, 3.0, 2)
    assert pool.available(2.0, 2.5) == 0 and pool.available(3.0, 4.0) == 2
    with pytest.raises(ValueError, match="over-reservation"):
        pool.reserve(2.0, 5.0, 1)
    assert pool.utilization(10.0) == pytest.approx(4.0 / 20.0)


# -- chains and cost records --------------------------------------------------

def test_chain_of_matches_reference():
    dags = core.workload.generate_dag_jobs(8, job_type=3, seed=4)
    ref_dags = ref_core.generate_dag_jobs(8, job_type=3, seed=4)
    for dag, ref_dag in zip(dags, ref_dags):
        got, want = core.chain_of(dag), ref_core.chain_of(ref_dag)
        assert (got.arrival, got.deadline) == (want.arrival, want.deadline)
        assert [(t.z, t.delta) for t in got.tasks] == \
            [(t.z, t.delta) for t in want.tasks]
    chain = core.generate_chain_jobs(1, job_type=1, seed=0)[0]
    assert core.chain_of(chain) is chain


def test_task_and_job_cost_match_reference():
    rows = [(0.5, 1.25, 2.0, 1.0, 0.5, 3.0, 2.5),
            (0.0, 2.0, 0.0, 2.0, 0.0, 4.0, None),
            (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7)]
    got = JobCost(tuple(TaskCost(*r) for r in rows))
    want = RefJobCost(tuple(RefTaskCost(*r) for r in rows))
    for name in ("total", "spot_cost", "ondemand_cost", "spot_work",
                 "selfowned_work"):
        assert getattr(got, name) == getattr(want, name), name
    assert [t.total for t in got.tasks] == [t.total for t in want.tasks]
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.tasks[0].spot_cost = 1.0


# -- sched/ ---------------------------------------------------------------------

def test_straggler_detects_persistent_straggler():
    det = sched.StragglerDetector(patience=2)
    hb = np.ones(8)
    hb[3] = 50.0
    assert det.update(hb) == []          # strike 1
    assert det.update(hb) == [3]         # strike 2 -> speculate
    assert det.update(np.ones(8)) == []  # recovered


def test_straggler_progress_speculation():
    det = sched.StragglerDetector()
    assert det.should_speculate(np.array([1.0, 0.95, 1.05, 0.3])) == [3]


@pytest.mark.parametrize("seed", range(3))
def test_straggler_matches_reference_on_random_heartbeats(seed):
    rng = np.random.default_rng(seed)
    got = sched.StragglerDetector(k_iqr=1.5, patience=2)
    want = ref_sched.StragglerDetector(k_iqr=1.5, patience=2)
    for _ in range(30):
        hb = rng.lognormal(0.0, 0.6, 16)
        assert got.update(hb) == want.update(hb)
        prog = rng.random(16)
        assert got.should_speculate(prog) == want.should_speculate(prog)


@pytest.mark.parametrize("arch, kw", [
    ("llama3_8b", dict(deadline_factor=2.0, max_pods=8)),
    ("mamba2_2_7b", dict(max_pods=4)),
    ("tinyllama_1_1b", dict(n_segments=6, n_evals=3, max_pods=1)),
])
def test_training_job_dag_matches_reference(arch, kw):
    got = sched.training_job_dag(arch, 2.5, cache=[], **kw)
    want = ref_sched.training_job_dag(arch, 2.5, cache=[], **kw)
    assert (got.arrival, got.deadline, got.preds) == \
        (want.arrival, want.deadline, want.preds)
    assert [(t.z, t.delta) for t in got.tasks] == \
        [(t.z, t.delta) for t in want.tasks]


def test_estimate_stage_seconds_matches_reference():
    cache = [{"arch": "a", "shape": "train_4k", "variant": "base",
              "status": "ok", "compute_s": 0.3, "memory_s": 0.7,
              "collective_s": 0.1},
             {"arch": "a", "shape": "train_4k", "variant": "base",
              "status": "ok", "multi_pod": True, "compute_s": 9.0,
              "memory_s": 9.0, "collective_s": 9.0}]
    for arch in ("a", "b"):
        assert sched.estimate_stage_seconds(arch, steps=50, cache=cache) == \
            ref_sched.estimate_stage_seconds(arch, steps=50, cache=cache)
    assert sched.estimate_stage_seconds("b", steps=50, cache=[]) == 50.0
    assert sched.fleet.load_roofline_cache("/nonexistent/cache.json") == []


@pytest.fixture(scope="module")
def fleet_jobs():
    """tests/test_system.py::test_fleet_orchestrator_end_to_end's jobs."""
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1.0, 30))
    mk = lambda f: [f("llama3_8b", float(a), deadline_factor=2.0,  # noqa: E731
                      max_pods=8, cache=[]) for a in arrivals]
    return (mk(ref_sched.training_job_dag), mk(sched.training_job_dag),
            float(arrivals[-1] + 50))


@pytest.mark.parametrize("learn", [True, False])
def test_fleet_orchestrator_matches_reference(fleet_jobs, learn,
                                              monkeypatch):
    """Without learning the reports are bit-identical (host float64). With
    TOLA both sides learn over a float32 cost matrix: the reference's jax
    backend against the port's plain versions, within 1e-5 and with the
    same best policy. (The reference's float64 numpy backend lands
    elsewhere on this input: a float32 turning-point knife edge of its
    cost matrix moves its Hedge trace, ROADMAP queue C.)"""
    ref_jobs, jobs, horizon = fleet_jobs
    monkeypatch.setattr(
        ref_orchestrator, "run_tola",
        lambda *a, **k: ref_core.run_tola(*a, backend="jax", **k))
    want = ref_sched.FleetOrchestrator(
        ref_sched.FleetSpec(reserved_pods=4), horizon).schedule(
            ref_jobs, learn=learn)
    got = sched.FleetOrchestrator(
        sched.FleetSpec(reserved_pods=4), horizon, device="cpu").schedule(
            jobs, learn=learn)
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.pop("best_policy") == w.pop("best_policy")
    for key, v in g.items():
        if learn:
            assert v == pytest.approx(w[key], abs=TOL), key
        else:
            assert v == w[key], key
    fr = got.spot_fraction + got.selfowned_fraction + got.ondemand_fraction
    assert abs(fr - 1.0) < 1e-6 and got.unit_cost < 1.0
    assert got.selfowned_fraction > 0


def test_fleet_stage_plan_matches_reference():
    dag = sched.training_job_dag("mamba2_2_7b", 0.0, max_pods=4, cache=[])
    ref_dag = ref_sched.training_job_dag("mamba2_2_7b", 0.0, max_pods=4,
                                         cache=[])
    got = sched.FleetOrchestrator(sched.FleetSpec(reserved_pods=2), 200.0,
                                  device="cpu").stage_plan(
        dag, core.Policy(beta=0.625, bid=0.24, beta0=0.5))
    want = ref_sched.FleetOrchestrator(
        ref_sched.FleetSpec(reserved_pods=2), 200.0).stage_plan(
        ref_dag, ref_core.Policy(beta=0.625, bid=0.24, beta0=0.5))
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name))
    sizes = got.sizes[got.mask]
    assert np.all(sizes > 0)
    assert got.ends[0, got.mask[0]][-1] <= dag.deadline + 1e-6
