"""Paper Tables 2-5 on the port (``device="cpu"``) against ``repro``.

* ``exp1``/``exp2``/``exp3``'s ``run`` against the reference's
  ``benchmarks.exp*.run(..., backend="numpy")`` on the same jobs and
  markets (the reference's seeds): alphas and rhos within 1e-5, the best
  policy equal unless the two best alphas lie within 1e-5.
* The host float64 paths bit for bit: ``run_greedy`` (batch and
  sequential), ``run_jobs`` and ``run_even``.
* ``sweep_policies`` (shared pool) per policy within 1e-5 of the port's
  ``run_jobs``; ``evaluate_policy_fullpool`` within 1e-5 of the
  reference's numpy one.
* ``EngineResult``'s reductions bit for bit, with and without the
  scenario axis.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.engine as ref_engine  # noqa: E402
from repro.core import (  # noqa: E402
    SpotMarket,
    benchmark_bid_policies,
    generate_chain_jobs,
    selfowned_policies,
    spot_od_policies,
)
from repro.core import evaluate_policy_fullpool as ref_fullpool  # noqa: E402
from repro.core import run_even as ref_run_even  # noqa: E402
from repro.core import run_greedy as ref_run_greedy  # noqa: E402
from repro.core import run_jobs as ref_run_jobs  # noqa: E402
from repro.engine import evaluate_grid as ref_evaluate_grid  # noqa: E402
from repro.engine.result import EngineResult as RefResult  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import (  # noqa: E402
    evaluate_policy_fullpool,
    run_even,
    run_greedy,
    run_jobs,
    sweep_policies,
)
from repro_torch.engine import EngineResult  # noqa: E402
from repro_torch.experiments import exp1_spot_ondemand as exp1  # noqa: E402
from repro_torch.experiments import exp2_self_owned as exp2  # noqa: E402
from repro_torch.experiments import exp3_policy12 as exp3  # noqa: E402

TOL = 1e-5
N_JOBS = 60
SC_FIELDS = ("spot_cost", "ondemand_cost", "spot_work", "ondemand_work",
             "selfowned_work", "workload", "selfowned_reserved")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def ref_exps():
    """The reference's drivers. ``benchmarks/common.py`` turns on jax's
    persistent compilation cache when imported; the import here keeps it
    off (the numpy backend compiles nothing)."""
    saved = ref_engine.setup_persistent_cache
    ref_engine.setup_persistent_cache = lambda *a, **k: None
    try:
        from benchmarks import exp1_spot_ondemand as r1
        from benchmarks import exp2_self_owned as r2
        from benchmarks import exp3_policy12 as r3
    finally:
        ref_engine.setup_persistent_cache = saved
    return r1, r2, r3


@pytest.fixture(scope="module")
def stream():
    """Table 2's inputs at 60 jobs of type 1 (jobs from seed 0, the market
    from seed 1000), as the reference's and the port's objects."""
    jobs = generate_chain_jobs(N_JOBS, job_type=1, seed=0)
    market = SpotMarket(max(j.deadline for j in jobs) + 1.0, seed=1000)
    jobs_t = interop.chain_jobs_from_arrays(*interop.chain_jobs_to_arrays(jobs))
    market_t = interop.markets_from_prices(market.price, market.slot)[0]
    return jobs, market, jobs_t, market_t


def port_policies(pols):
    return interop.policies_from_tuples([(p.beta, p.bid, p.beta0)
                                         for p in pols])


def assert_costs_equal(got, want):
    for f in SC_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def ref_alpha(jt, policy, r, **kw):
    """The reference's numpy alpha of one policy on Table 2-5's inputs."""
    jobs = generate_chain_jobs(N_JOBS, job_type=jt, seed=0)
    market = SpotMarket(max(j.deadline for j in jobs) + 1.0, seed=1000)
    res = ref_evaluate_grid(jobs, [policy], market, r, pool="shared",
                            backend="numpy", **kw)
    return res.best()[1]


def assert_best_equal_or_tied(got, want, grid, jt, r, **kw):
    """The best policy is the reference's unless the two best alphas lie
    within TOL (a tie the float32 cost tensor may break either way)."""
    if got == want:
        return
    key = lambda p: tuple(round(v, 3) for v in (p.beta, p.bid) +  # noqa: E731
                          ((p.beta0,) if len(got) == 3 else ()))
    pol = {key(p): p for p in grid}
    gap = abs(ref_alpha(jt, pol[got], r, **kw) - ref_alpha(jt, pol[want], r,
                                                          **kw))
    assert gap <= TOL, (got, want, gap)


def assert_rows_close(got, want, keys):
    assert got.keys() == want.keys()
    for cell in want:
        for k in keys:
            np.testing.assert_allclose(got[cell][k], want[cell][k], rtol=0,
                                       atol=TOL, err_msg=f"{cell} {k}")


def test_exp1_matches_reference(ref_exps):
    got = exp1.run(N_JOBS, [1, 2], device="cpu")
    want = ref_exps[0].run(N_JOBS, [1, 2], backend="numpy")
    assert_rows_close(got, want, ("alpha", "rho_vs_greedy", "rho_vs_even",
                                  "rho_vs_even_early"))
    for jt in want:
        assert_best_equal_or_tied(got[jt]["best_policy"],
                                  want[jt]["best_policy"], spot_od_policies(),
                                  jt, 0)


def test_exp2_matches_reference(ref_exps):
    got = exp2.run(N_JOBS, [1], [0, 60], device="cpu")
    want = ref_exps[1].run(N_JOBS, [1], [0, 60], backend="numpy")
    assert_rows_close(got, want, ("alpha", "bench", "rho"))
    for (r, jt) in want:
        assert_best_equal_or_tied(got[(r, jt)]["best_policy"],
                                  want[(r, jt)]["best_policy"],
                                  selfowned_policies(), jt, r)


def test_exp3_matches_reference(ref_exps):
    """At r = 0 both sides have no pool: rho is 0 and mu is 0/0 (nan) in
    the reference, and so in the port."""
    with np.errstate(invalid="ignore", divide="ignore"):
        got = exp3.run(N_JOBS, [2], [0, 60], device="cpu")
        want = ref_exps[2].run(N_JOBS, [2], [0, 60], backend="numpy")
    assert_rows_close(got, want, ("rho", "alpha_prop", "alpha_naive", "mu"))
    assert np.isnan(got[(0, 2)]["mu"]) and got[(60, 2)]["mu"] > 0


def test_drivers_print_their_tables(capsys):
    exp1.main(["--jobs", "12", "--types", "1", "--device", "cpu"])
    exp2.main(["--jobs", "12", "--types", "1", "--r", "30", "--device", "cpu"])
    exp3.main(["--jobs", "12", "--types", "1", "--r", "30", "--device", "cpu"])
    out = capsys.readouterr().out
    for title in ("Table 2 ", "Table 3 ", "Tables 4+5 "):
        assert f"== {title}" in out
    assert "\n1,0." in out and "\n30,1,0." in out


@pytest.mark.parametrize("batch", [True, False])
@pytest.mark.parametrize("bid", [0.18, 0.30])
def test_run_greedy_bit_identical(stream, batch, bid):
    jobs, market, jobs_t, market_t = stream
    assert_costs_equal(run_greedy(jobs_t, bid, market_t, batch=batch),
                       ref_run_greedy(jobs, bid, market, batch=batch))


RUN_JOBS_CASES = {
    "proposed r=0": (spot_od_policies()[7], 0, "dealloc", "prop12", True),
    "proposed r=60": (selfowned_policies()[40], 60, "dealloc", "prop12", True),
    "naive r=60 planned": (selfowned_policies()[90], 60, "dealloc", "naive",
                           False),
    "even naive r=60 planned": (benchmark_bid_policies()[2], 60, "even",
                                "naive", False),
    "even prop12 r=25 early": (selfowned_policies()[3], 25, "even", "prop12",
                               True),
}


@pytest.mark.parametrize("case", sorted(RUN_JOBS_CASES))
def test_run_jobs_bit_identical(stream, case):
    jobs, market, jobs_t, market_t = stream
    pol, r, windows, selfowned, early = RUN_JOBS_CASES[case]
    got, r_got, pool_got = run_jobs(jobs_t, port_policies([pol])[0], market_t,
                                    r, windows, selfowned, early,
                                    return_pool=True)
    want, r_want, pool_want = ref_run_jobs(jobs, pol, market, r, windows,
                                           selfowned, early, return_pool=True)
    assert_costs_equal(got, want)
    np.testing.assert_array_equal(r_got, r_want)
    assert (pool_got is None) == (pool_want is None) == (r == 0)
    if r:
        np.testing.assert_array_equal(pool_got.used, pool_want.used)
        assert pool_got.worked_instance_time == pool_want.worked_instance_time
        assert r_got.any()


def test_run_jobs_with_a_policy_per_job_bit_identical(stream):
    jobs, market, jobs_t, market_t = stream
    grid = selfowned_policies()
    pols = [grid[(7 * j) % len(grid)] for j in range(len(jobs))]
    assert_costs_equal(
        run_jobs(jobs_t, port_policies(pols), market_t, r_total=40),
        ref_run_jobs(jobs, pols, market, r_total=40))


def test_run_even_bit_identical(stream):
    jobs, market, jobs_t, market_t = stream
    pol = benchmark_bid_policies()[1]
    assert_costs_equal(run_even(jobs_t, port_policies([pol])[0], market_t, 60),
                       ref_run_even(jobs, pol, market, 60))


SWEEPS = {
    "proposed r=60": (selfowned_policies()[::6], dict(r_total=60)),
    "naive r=60": (selfowned_policies()[::6], dict(r_total=60,
                                                   selfowned="naive")),
    "even r=60 planned": (benchmark_bid_policies(), dict(
        r_total=60, windows="even", selfowned="naive", early_start=False)),
    "proposed r=0": (spot_od_policies(), dict()),
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_sweep_policies_matches_run_jobs(stream, case):
    """Shared pool: each policy of the sweep owns a fresh pool, as
    ``run_jobs`` does; the float32 unit costs lie within 1e-5 of the host
    float64 realization, and the sweep's best and costs are its result's."""
    _, _, jobs_t, market_t = stream
    pols, kw = SWEEPS[case]
    pols_t = port_policies(pols)
    best, alpha, costs, res = sweep_policies(jobs_t, pols_t, market_t,
                                             device="cpu", **kw)
    p, a = res.best()
    assert (best, alpha) == (pols_t[p], a)
    assert_costs_equal(costs, res.stream_costs(p, 0))
    host_kw = dict(kw, r_total=kw.get("r_total", 0))
    for pi, pol in enumerate(pols_t):
        host = run_jobs(jobs_t, pol, market_t, **host_kw)
        unit = host.total_cost / np.maximum(host.workload, 1e-12)
        np.testing.assert_allclose(res.unit_cost[0, :, pi], unit, rtol=TOL,
                                   atol=TOL, err_msg=f"policy {pi}")
        np.testing.assert_array_equal(res.selfowned_work[:, pi],
                                      host.selfowned_work)
    assert abs(alpha - min(run_jobs(jobs_t, pol, market_t, **host_kw)
                           .average_unit_cost() for pol in pols_t)) <= TOL


@pytest.mark.parametrize("with_availability", [False, True])
def test_evaluate_policy_fullpool_matches_reference(stream, with_availability):
    jobs, market, jobs_t, market_t = stream
    pol = selfowned_policies()[60]
    avail = (lambda s, e: np.full(s.shape, 7.0)) if with_availability \
        else None
    got = evaluate_policy_fullpool(jobs_t, port_policies([pol])[0], market_t,
                                   r_total=30, availability=avail,
                                   device="cpu")
    want = ref_fullpool(jobs, pol, market, r_total=30, availability=avail,
                        backend="numpy")
    for f in ("selfowned_work", "workload", "selfowned_reserved"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.total_cost / got.workload,
                               want.total_cost / want.workload, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("per_scenario", [False, True])
def test_engine_result_reductions_bit_identical(per_scenario):
    rng = np.random.default_rng(3)
    S, J, P = 3, 11, 7
    arrays = {k: rng.random((S, J, P)) for k in
              ("unit_cost", "spot_cost", "ondemand_cost", "spot_work",
               "ondemand_work")}
    so_shape = (S, J, P) if per_scenario else (J, P)
    arrays.update(workload=rng.random(J) + 0.5,
                  selfowned_work=rng.random(so_shape),
                  selfowned_reserved=rng.random(so_shape))
    got, want = EngineResult(**arrays), RefResult(**arrays)
    np.testing.assert_array_equal(got.total_cost, want.total_cost)
    np.testing.assert_array_equal(got.avg_unit_cost(), want.avg_unit_cost())
    for s in (None, 0, 2):
        assert got.best(s) == want.best(s)
    for p, s in ((0, 0), (4, 2), (6, 1)):
        assert_costs_equal(got.stream_costs(p, s), want.stream_costs(p, s))
