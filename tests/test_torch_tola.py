"""Table 6 as a whole: the port's TOLA (``run_tola_scenarios`` on the CPU)
against the reference's, for the proposed grid (early starts) and the Even
benchmark (Even windows, naive self-owned, planned starts), at r = 0 and
r > 0 with one pool-refinement round, S = 2 market scenarios.

* Given the same cost matrix (the reference's float64 numpy one), the host
  rounds — sampled traces, realized ``StreamCosts``, the refined
  residual-availability query — are bit-identical to ``repro``'s.
* End to end, with the port's own float32 cost tensor, the sampled traces
  equal those of ``repro``'s ``backend="jax"`` run and the Table 6 alphas
  agree to 1e-9.
* ROADMAP queue C's knife-edge task, and which reference each path of the
  port matches there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (  # noqa: E402
    SpotMarket,
    benchmark_bid_policies,
    generate_chain_jobs,
    selfowned_policies,
    spot_od_policies,
)
from repro.core import tola as ref_tola  # noqa: E402
from repro.core.oracle import oracle_task  # noqa: E402
from repro.core.simulate import simulate_tasks as ref_simulate_tasks  # noqa: E402
from repro.engine import evaluate_grid as ref_evaluate_grid  # noqa: E402
from repro.engine import make_scenarios as ref_make_scenarios  # noqa: E402
from repro.learn import LearnerSpec as RefSpec  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import tola  # noqa: E402
from repro_torch.core.market import SpotMarket as PortMarket  # noqa: E402
from repro_torch.core.simulate import simulate_tasks  # noqa: E402
from repro_torch.core.tola import run_tola_scenarios  # noqa: E402
from repro_torch.kernels import policy_cost as pc  # noqa: E402
from repro_torch.learn import LearnerSpec  # noqa: E402

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
def stream():
    jobs = generate_chain_jobs(40, job_type=2, seed=0)
    horizon = max(j.deadline for j in jobs) + 1.0
    markets = ref_make_scenarios(horizon, 2, seed=1000)
    jobs_t = interop.chain_jobs_from_arrays(*interop.chain_jobs_to_arrays(jobs))
    markets_t = interop.markets_from_prices(
        np.stack([m.price for m in markets]), markets[0].slot)
    return jobs, markets, jobs_t, markets_t


def _grid(grid, r):
    if grid == "proposed":
        pols = selfowned_policies() if r > 0 else spot_od_policies()
        kw = dict(windows="dealloc", selfowned="prop12", early_start=True)
    else:
        pols = benchmark_bid_policies()
        kw = dict(windows="even", selfowned="naive", early_start=False)
    pols_t = interop.policies_from_tuples(
        [(p.beta, p.bid, p.beta0) for p in pols])
    return pols, pols_t, kw


GRIDS = [("proposed", 0), ("proposed", 150), ("even", 0), ("even", 150)]


@pytest.mark.parametrize("grid,r", GRIDS)
def test_host_rounds_bit_identical_given_reference_costs(stream, grid, r):
    """Both sides replay the same float64 cost matrix per round; every host
    product of the round must then be bit-identical."""
    jobs, markets, jobs_t, markets_t = stream
    pols, pols_t, kw = _grid(grid, r)
    arrivals, d, Z = ref_tola._stream_meta(jobs)
    rngs_ref = [np.random.default_rng(s) for s in range(2)]
    rngs_port = [np.random.default_rng(s) for s in range(2)]
    avails = None
    probe = (np.asarray([[j.arrival, j.arrival + 1.0] for j in jobs]),
             np.asarray([[j.arrival + 2.0, j.deadline] for j in jobs]))
    for _ in range(2 if r > 0 else 1):
        C = ref_evaluate_grid(jobs, pols, markets, r, backend="numpy",
                              pool="dedicated", availability=avails,
                              **kw).unit_cost
        new_avails = []
        for s in range(2):
            lr_r, ch_r, real_r, av_r = ref_tola._tola_round(
                jobs, pols, C[s], arrivals, d, Z, RefSpec("hedge"),
                rngs_ref[s], markets[s], r, kw["windows"], kw["selfowned"],
                kw["early_start"])
            lr_p, ch_p, real_p, av_p = tola._tola_round(
                jobs_t, pols_t, C[s], arrivals, d, Z, LearnerSpec("hedge"),
                rngs_port[s], markets_t[s], r, kw["windows"],
                kw["selfowned"], kw["early_start"])
            np.testing.assert_array_equal(ch_p, ch_r)
            np.testing.assert_array_equal(lr_p.weights, lr_r.weights)
            for f in SC_FIELDS:
                np.testing.assert_array_equal(getattr(real_p, f),
                                              getattr(real_r, f), err_msg=f)
            assert (av_p is None) == (av_r is None) == (r == 0)
            if r > 0:
                np.testing.assert_array_equal(av_p(*probe), av_r(*probe))
            new_avails.append(av_r)
        avails = new_avails if r > 0 else None


@pytest.mark.parametrize("grid,r", GRIDS)
def test_table6_matches_reference_jax_run(stream, grid, r):
    """End to end with the port's own cost tensor: the sampled traces equal
    repro's jax-backend run, and the Table 6 alphas agree to 1e-9."""
    jobs, markets, jobs_t, markets_t = stream
    pols, pols_t, kw = _grid(grid, r)
    ref = ref_tola.run_tola_scenarios(jobs, pols, markets, r_total=r, seed=0,
                                      pool_iters=1, backend="jax", **kw)
    got = run_tola_scenarios(jobs_t, pols_t, markets_t, r_total=r, seed=0,
                             pool_iters=1, device="cpu", **kw)
    assert len(got) == len(ref) == 2
    for g, f in zip(got, ref):
        np.testing.assert_array_equal(g.chosen, f.chosen)
        assert abs(g.average_unit_cost() - f.average_unit_cost()) <= 1e-9
        np.testing.assert_allclose(g.weights, f.weights, atol=1e-5)
        assert set(g.timings) >= {"plan", "pool", "eval", "replay",
                                  "realize"}


def test_run_tola_is_one_scenario(stream):
    jobs, markets, jobs_t, markets_t = stream
    pols, pols_t, kw = _grid("proposed", 150)
    one = tola.run_tola(jobs_t, pols_t, markets_t[1], r_total=150, seed=1,
                        device="cpu", **kw)
    ref = ref_tola.run_tola(jobs, pols, markets[1], r_total=150, seed=1,
                            backend="jax", **kw)
    np.testing.assert_array_equal(one.chosen, ref.chosen)
    assert abs(one.average_unit_cost() - ref.average_unit_cost()) <= 1e-9


def test_knife_edge_task_of_roadmap_c():
    """start=0, size=5, frac=0.25, delta=1, bid=0.18 on SpotMarket(250,
    seed=42): spot work lands exactly on an availability gap. The port's
    float64 host simulator (the realized pass of TOLA's rounds) matches
    ``simulate_tasks`` bit for bit: finish 2.75. The port's float32 cost
    kernel (plain version) finishes at 2.5833 = ``oracle_task`` — as
    repro's own Pallas kernel does. Costs and work agree on every path."""
    start, size, frac, delta, bid = 0.0, 5.0, 0.25, 1.0, 0.18
    end, z = start + size, frac * delta * size
    args = [np.array([x]) for x in (start, end, z, delta)]
    ref_view = SpotMarket(250.0, seed=42).view(bid)
    ref = ref_simulate_tasks(ref_view, *args)
    orc = oracle_task(SpotMarket(250.0, seed=42), bid, start, end, z, delta)
    host = simulate_tasks(PortMarket(250.0, seed=42).view(bid), *args)
    for f in ("spot_cost", "ondemand_cost", "spot_work", "finish"):
        np.testing.assert_array_equal(getattr(host, f), getattr(ref, f))
    assert host.finish[0] == 2.75
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa
    dev = pc.policy_cost_plain(f32(ref_view.A_cum)[None],
                               f32(ref_view.C_cum)[None], *map(f32, args))
    assert abs(float(dev["finish"][0, 0]) - orc["finish"]) < 1e-6
    assert abs(float(dev["finish"][0, 0]) - ref.finish[0]) > 0.1
    for key, want in (("spot_cost", orc["spot_cost"]),
                      ("ondemand_cost", orc["ondemand_cost"]),
                      ("spot_work", orc["spot_work"])):
        assert abs(float(dev[key][0, 0]) - want) < 1e-6
