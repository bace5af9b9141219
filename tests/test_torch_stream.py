"""The port's streamed scenarios against ``repro``'s.

* ``evaluate_grid`` over a ``ScenarioSpec`` with ``scenario_chunk``
  (synthesized by the port's device path, here on the CPU) within 1e-5 of
  the reference's numpy oracle and jax backend for the fresh, regime and
  adversarial families; chunked equal to monolithic bit for bit, on specs
  and on lists; ``reduce="mean"``; the ``scenario_chunk`` and ``overlap``
  validation; ``evaluate_grid_chunks``.
* ``ScenarioStream``'s adaptive stage machine: the same issued periods and
  offsets as the reference's stream under the same synthetic feedback.
* ``replay_stream``: within 1e-5 of ``repro.learn.replay_stream`` (jax
  engine, jax replay), within the reference's bars of the port's own
  monolithic ``replay`` (``tests/test_scenarios.py``), and the
  adaptive-beats-fixed regression locking the reference's period.
* The drivers: ``--scenario-chunk`` and ``--scenario-kind adaptive``, and
  Table 6's streamed rows against the reference's exp4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.engine as ref_engine  # noqa: E402
from repro.core import generate_chain_jobs, spot_od_policies  # noqa: E402
from repro.engine import ScenarioSpec as RefSpec  # noqa: E402
from repro.engine import ScenarioStream as RefStream  # noqa: E402
from repro.learn import replay_stream as ref_replay_stream  # noqa: E402

from repro_torch.core.market import SpotMarket  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ScenarioSpec,
    ScenarioStream,
    evaluate_grid,
    evaluate_grid_chunks,
    make_scenarios,
)
from repro_torch.experiments import common, table6  # noqa: E402
from repro_torch.experiments import exp1_spot_ondemand as exp1  # noqa: E402
from repro_torch.learn import replay, replay_stream  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def ref_bench():
    """The reference's drivers, with jax's persistent compilation cache
    kept off (``benchmarks/common.py`` turns it on when imported)."""
    saved = ref_engine.setup_persistent_cache
    ref_engine.setup_persistent_cache = lambda *a, **k: None
    try:
        from benchmarks import common as ref_common
        from benchmarks import exp1_spot_ondemand as r1
        from benchmarks import exp4_online_learning as r4
    finally:
        ref_engine.setup_persistent_cache = saved
    return ref_common, r1, r4


def _setup(n=16, jt=1, seed=5):
    jobs = generate_chain_jobs(n, job_type=jt, seed=seed)
    return jobs, max(j.deadline for j in jobs) + 1.0


def _grid(n=8):
    return spot_od_policies()[:n]


# -- streamed evaluation ---------------------------------------------------

@pytest.mark.parametrize("ref_backend", ["numpy", "jax"])
@pytest.mark.parametrize("kind", ["fresh", "regime", "adversarial"])
def test_spec_chunked_matches_reference(kind, ref_backend):
    jobs, horizon = _setup(n=10)
    ref = ref_engine.evaluate_grid(jobs, _grid(6), RefSpec(kind, horizon, 4,
                                                            seed=13),
                                   20, backend=ref_backend)
    got = evaluate_grid(jobs, _grid(6), ScenarioSpec(kind, horizon, 4,
                                                     seed=13),
                        20, scenario_chunk=2, device="cpu")
    np.testing.assert_allclose(got.unit_cost, ref.unit_cost, atol=TOL,
                               rtol=TOL)
    assert got.n_scenarios_total == 4
    assert [c["scenarios"] for c in got.timings["chunks"]] == [[0, 2], [2, 4]]
    assert got.timings["overlap"] is False
    assert got.timings["synth"] >= 0.0


@pytest.mark.parametrize("kind", ["fresh", "adversarial", "adaptive"])
def test_chunked_equals_monolithic_bit_for_bit(kind):
    jobs, horizon = _setup()
    spec = ScenarioSpec(kind, horizon, 5, seed=9)
    whole = evaluate_grid(jobs, _grid(), spec, 30, device="cpu")
    for k in (1, 2, 5):
        got = evaluate_grid(jobs, _grid(), spec, 30, scenario_chunk=k,
                            device="cpu")
        np.testing.assert_array_equal(got.unit_cost, whole.unit_cost)
        np.testing.assert_array_equal(got.spot_work, whole.spot_work)
    # double-buffered (dispatch ahead) gives the same bits
    pre = evaluate_grid(jobs, _grid(), spec, 30, scenario_chunk=2,
                        overlap=kind != "adaptive", device="cpu")
    np.testing.assert_array_equal(pre.unit_cost, whole.unit_cost)
    # the materialized list path: chunked equal to one pass
    markets = make_scenarios(horizon, 5, seed=21, kind="regime")
    ref = evaluate_grid(jobs, _grid(), markets, 30, device="cpu")
    got = evaluate_grid(jobs, _grid(), markets, 30, scenario_chunk=2,
                        device="cpu")
    np.testing.assert_array_equal(got.unit_cost, ref.unit_cost)


def test_spec_host_oracle_against_materialized_list():
    """The spec's device path against its own materialized markets through
    the list path: the same availability, so within the engine's 1e-5."""
    jobs, horizon = _setup()
    spec = ScenarioSpec("adversarial", horizon, 5, seed=9)
    ref = evaluate_grid(jobs, _grid(), spec.materialize(), 30, device="cpu")
    got = evaluate_grid(jobs, _grid(), spec, 30, scenario_chunk=2,
                        device="cpu")
    np.testing.assert_allclose(got.unit_cost, ref.unit_cost, atol=TOL,
                               rtol=TOL)


def test_reduce_mean_matches_stacked_mean():
    jobs, horizon = _setup()
    spec = ScenarioSpec("fresh", horizon, 6, seed=2)
    ref = evaluate_grid(jobs, _grid(), spec, 30, device="cpu")
    red = evaluate_grid(jobs, _grid(), spec, 30, scenario_chunk=4,
                        reduce="mean", device="cpu")
    assert red.unit_cost.shape[0] == 1 and red.n_scenarios_total == 6
    assert not red.single_market
    np.testing.assert_allclose(red.unit_cost[0], ref.unit_cost.mean(axis=0),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="reduce"):
        evaluate_grid(jobs, _grid(), spec, 30, reduce="median", device="cpu")


def test_scenario_chunk_and_overlap_validated():
    jobs, horizon = _setup(n=4)
    m = SpotMarket(horizon, seed=1)
    for bad in (0, -3, 2.5, True, "4"):
        with pytest.raises(ValueError, match="scenario_chunk"):
            evaluate_grid(jobs, _grid(4), m, scenario_chunk=bad,
                          device="cpu")
    markets = [SpotMarket(horizon, seed=s) for s in range(2)]
    queries = [lambda s, e: np.full(s.shape, 3.0)] * 2
    with pytest.raises(ValueError, match="per-scenario"):
        evaluate_grid(jobs, _grid(4), markets, 30, availability=queries,
                      scenario_chunk=1, device="cpu")
    with pytest.raises(ValueError, match="reduce='mean'"):
        evaluate_grid(jobs, _grid(4), markets, 30, availability=queries,
                      reduce="mean", device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        evaluate_grid(jobs, _grid(4), [], device="cpu")
    spec = ScenarioSpec("adaptive", horizon, 4)
    with pytest.raises(ValueError, match="reactive"):
        evaluate_grid(jobs, _grid(4), spec, scenario_chunk=2, overlap=True,
                      device="cpu")
    with pytest.raises(ValueError, match="scenario_chunk"):
        evaluate_grid_chunks(jobs, _grid(4), spec, scenario_chunk=0,
                             device="cpu")   # at the call, not at next()


def test_grid_chunks_stream_the_stacked_tensor():
    jobs, horizon = _setup()
    spec = ScenarioSpec("regime", horizon, 5, seed=4)
    whole = evaluate_grid(jobs, _grid(), spec, 0, device="cpu")
    chunks = list(evaluate_grid_chunks(jobs, _grid(), spec, 0,
                                       scenario_chunk=2, device="cpu"))
    assert [(c.s0, c.s1) for c in chunks] == [(0, 2), (2, 4), (4, 5)]
    np.testing.assert_array_equal(
        np.concatenate([c.unit_cost for c in chunks]), whole.unit_cost)
    np.testing.assert_array_equal(chunks[1].out["spot_cost"],
                                  whole.spot_cost[2:4])
    np.testing.assert_array_equal(chunks[0].workload, whole.workload)


# -- the adaptive adversary ------------------------------------------------

def test_stage_machine_matches_reference():
    """Both streams under the same synthetic feedback issue the same
    periods and offsets, pass through the same stages and lock the same
    cell."""
    kw = dict(seed=1, n_periods=3, n_phases=4, spike_range=(0.5, 4.0))
    got = ScenarioStream(ScenarioSpec("adaptive", 10.0, 40, **kw))
    want = RefStream(RefSpec("adaptive", 10.0, 40, **kw))
    rng = np.random.default_rng(7)
    stages = []
    for (s0, s1, batch), (r0, r1, _) in zip(got.chunks(3, "cpu"),
                                            want.chunks(3)):
        assert (s0, s1) == (r0, r1)
        stages.append(got.stage)
        assert got.stage == want.stage
        fb = rng.random(s1 - s0) + 0.3 * (np.asarray(got.chunk_periods[-1])
                                          == got._menu[1])
        got.observe(fb)
        want.observe(fb)
    assert {"periods", "phases", "locked"} <= set(stages)
    assert got._locked_period == want._locked_period
    for a, b in zip(got.chunk_periods + got.chunk_offsets,
                    want.chunk_periods + want.chunk_offsets):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="observe got"):
        stream = ScenarioStream(ScenarioSpec("adaptive", 10.0, 4))
        next(stream.chunks(2, "cpu"))
        stream.observe(np.zeros(3))


# -- replay_stream ---------------------------------------------------------

def _stream_meta(jobs):
    arrivals = np.array([j.arrival for j in jobs])
    return (arrivals, max(j.deadline - j.arrival for j in jobs),
            np.array([j.total_work for j in jobs]))


def test_replay_stream_matches_reference_and_monolithic():
    jobs, horizon = _setup(n=12, jt=2)
    grid = _grid(6)
    learners = ["hedge", "exp3", "ucb1"]
    spec = ScenarioSpec("fresh", horizon, 6, seed=4)
    got = replay_stream(jobs, grid, spec, 0, learners=learners, seed=0,
                        scenario_chunk=2, device="cpu")
    want = ref_replay_stream(jobs, grid, RefSpec("fresh", horizon, 6, seed=4),
                             0, learners=learners, seed=0, scenario_chunk=2,
                             backend="jax", engine_backend="jax")
    assert (got.n_scenarios, got.n_chunks) == (6, 3)
    for a, b in zip(got.summary(), want.summary()):
        assert a["learner"] == b["learner"]
        for key in ("realized_unit", "regret", "expected_regret",
                    "top_weight"):
            assert abs(a[key] - b[key]) <= TOL, (a, b)
    # the port's own monolithic replay over the streamed tensor, at the
    # reference's bars (tests/test_scenarios.py)
    arrivals, d, Z = _stream_meta(jobs)
    res = evaluate_grid(jobs, grid, spec, 0, device="cpu")
    lr = replay(res.unit_cost, arrivals, d, workload=Z, learners=learners,
                seed=0, device="cpu")
    np.testing.assert_allclose(got.realized_unit(),
                               lr.realized_unit().mean(axis=0), rtol=1e-12)
    np.testing.assert_allclose(got.regret_per_job(),
                               lr.regret_per_job().mean(axis=0),
                               rtol=1e-9, atol=1e-13)
    m_s, lo_s, hi_s = got.confidence_bands()
    m_m, lo_m, hi_m = lr.confidence_bands()
    np.testing.assert_allclose(m_s, m_m, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(lo_s, lo_m, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(hi_s, hi_m, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.weights(), lr.weights.mean(axis=0),
                               rtol=1e-12)


def test_adaptive_adversary_beats_best_fixed_family():
    """tests/test_scenarios.py's regression on the port (the plain
    versions on the CPU): on the same scenario budget the adaptive family's
    realized Hedge regret is at least every fixed square-wave family's,
    and its stream locks the period the reference's locks."""
    jobs = generate_chain_jobs(20, 2, seed=4)
    grid = spot_od_policies()[:10]
    horizon = max(j.deadline for j in jobs) + 1.0
    S, K = 48, 8
    kw = dict(learners=["hedge"], seed=0, device="cpu")
    fixed = {}
    for p in (0.25, 8.0):
        spec_p = ScenarioSpec("adversarial", horizon, S, seed=7,
                              spike_range=(p, p))
        fixed[p] = float(replay_stream(jobs, grid, spec_p, 0,
                                       scenario_chunk=S, **kw)
                         .regret_per_job()[0])
    akw = dict(seed=7, spike_range=(0.25, 8.0), n_periods=2, n_phases=4)
    stream = ScenarioStream(ScenarioSpec("adaptive", horizon, S, **akw))
    adaptive = float(replay_stream(jobs, grid, stream, 0, scenario_chunk=K,
                                   **kw).regret_per_job()[0])
    assert stream.stage == "locked"
    assert stream._menu[stream._locked_period] == max(fixed, key=fixed.get)
    assert adaptive >= max(fixed.values()), (adaptive, fixed)
    ref = RefStream(RefSpec("adaptive", horizon, S, **akw))
    ref_replay_stream(jobs, grid, ref, 0, scenario_chunk=K, learners=["hedge"],
                      seed=0, backend="numpy", engine_backend="numpy")
    assert stream._locked_period == ref._locked_period
    assert stream.stage == ref.stage


# -- the drivers -----------------------------------------------------------

def test_drivers_take_scenario_chunk(ref_bench):
    ref_common, r1, _ = ref_bench
    args = common.argparser("t").parse_args(
        ["--scenario-kind", "adaptive", "--scenario-chunk", "4"])
    assert (args.scenario_kind, args.scenario_chunk) == ("adaptive", 4)
    assert common.argparser("t").parse_args([]).scenario_chunk is None
    got = common.make_setup(20, 3, seed=4, scenarios=3,
                            scenario_kind="regime", scenario_chunk=2,
                            device="cpu")
    want = ref_common.make_setup(20, 3, seed=4, scenarios=3,
                                 scenario_kind="regime", backend="numpy",
                                 scenario_chunk=2)
    assert isinstance(got.scenarios, ScenarioSpec)
    for g, w in zip(got.markets, want.markets):
        np.testing.assert_array_equal(g.price, w.price)
    with pytest.raises(ValueError, match="chunk-boundary feedback"):
        common.make_setup(6, 2, scenario_kind="adaptive", device="cpu")
    res = exp1.main(["--jobs", "12", "--types", "1", "--scenarios", "3",
                     "--scenario-chunk", "2", "--device", "cpu"])
    ref = r1.run(12, [1], 0, 3, "fresh", "numpy", 2)
    assert abs(res[1]["alpha"] - ref[1]["alpha"]) <= TOL
    for key in ("rho_vs_greedy", "rho_vs_even", "rho_vs_even_early"):
        assert abs(res[1][key] - ref[1][key]) <= TOL


def test_table6_streamed_rows_match_reference_exp4(ref_bench):
    """Table 6 at 40 jobs on an adaptive spec, S = 8 in chunks of 4, hedge
    and ucb1: the port's ``table6.main`` on the CPU against the reference's
    exp4 ``run(..., backend="numpy", scenario_chunk=4)``, whose streamed
    rows replay with jax. The realized alphas are host float64 replays of
    equal traces, so equal; the rest within 1e-5."""
    _, _, r4 = ref_bench
    got = table6.main(["--jobs", "40", "--r", "0", "--scenarios", "8",
                       "--scenario-kind", "adaptive", "--scenario-chunk",
                       "4", "--learner", "hedge", "ucb1", "--device", "cpu"])
    want = r4.run(40, [0], seed=0, scenarios=8, scenario_kind="adaptive",
                  backend="numpy", learners=["hedge", "ucb1"],
                  scenario_chunk=4)
    g, w = got[0], want[0]
    for key in ("alpha_tola", "alpha_bench", "rho_bar"):
        assert g[key] == w[key], (key, g[key], w[key])
    for a, b in zip(g["stream"], w["stream"]):
        assert a["learner"] == b["learner"]
        for key in ("realized_unit", "regret", "expected_regret",
                    "top_weight"):
            assert abs(a[key] - b[key]) <= TOL, (key, a, b)
    with pytest.raises(SystemExit):
        table6.main(["--scenario-kind", "adaptive", "--device", "cpu"])
