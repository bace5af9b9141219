"""The port's device plan layer (``plan_backend="device"``, float32 torch
ops; here on the CPU) against ``repro``'s, at the bars the reference sets
for its own device plan path (``tests/test_plan_batch.py``):

* the three twins — the Alg.-1 waterfill (2e-4), the expected spot work
  (1e-4) and the policy-(12) counts in both modes (exact against the
  float64 oracle where the availability is integral, 1e-6 where a
  continuous query binds) — against the float64 host functions and
  ``repro``'s jax twins;
* ``evaluate_grid(device="cpu", plan_backend="device")`` within 1e-5 on
  unit costs of ``repro``'s float64 ``backend="numpy"`` and of its
  ``backend="jax", plan_backend="device"``, over job types 1-4, on the
  early-start (Dealloc, policy (12)) and planned-start (Even, naive) paths,
  with availability absent, a single query, and one query per scenario;
  the self-owned work at the reference's 1e-2 / 1e-4;
* the device path never calls the host plan layer;
* ``resolve_plan_backend``'s rule;
* TOLA's rounds with device plans against ``repro``'s jax device-plan
  path: cost matrices within 1e-5 and the same sampled traces;
* the float32 knife-edge count on the self-owned grid at r = 300, where
  the counts' widened ceil epsilon acts.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (  # noqa: E402
    benchmark_bid_policies,
    generate_chain_jobs,
    selfowned_policies,
    spot_od_policies,
)
from repro.core import tola as ref_tola  # noqa: E402
from repro.core.dealloc import expected_spot_work as ref_spot_work  # noqa: E402
from repro.core.dealloc import (  # noqa: E402
    expected_spot_work_jax,
    window_sizes_batch,
    window_sizes_batch_jax,
)
from repro.core.scheduler import (  # noqa: E402
    _selfowned_counts_vec,
    job_arrays,
    selfowned_counts_vec_jax,
)
from repro.engine import evaluate_grid as ref_evaluate_grid  # noqa: E402
from repro.engine import make_scenarios as ref_make_scenarios  # noqa: E402

import repro_torch.core.scheduler as sched_mod  # noqa: E402
import repro_torch.engine.plan as plan_mod  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.dealloc import (  # noqa: E402
    expected_spot_work_device,
    window_sizes_batch_device,
)
from repro_torch.core.scheduler import selfowned_counts_vec_device  # noqa: E402
from repro_torch.core.tola import run_tola_scenarios  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    build_grid_plan,
    clear_caches,
    evaluate_grid,
    resolve_plan_backend,
)

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def f32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def port_inputs(jobs, markets, policies):
    """The same jobs, markets and policies as the port's objects."""
    jobs_t = interop.chain_jobs_from_arrays(*interop.chain_jobs_to_arrays(jobs))
    markets_t = interop.markets_from_prices(
        np.stack([m.price for m in markets]), markets[0].slot)
    pols_t = interop.policies_from_tuples(
        [(p.beta, p.bid, p.beta0) for p in policies])
    return jobs_t, markets_t, pols_t


# ---------------------------------------------------------------------------
# The twins
# ---------------------------------------------------------------------------

def test_window_sizes_twin():
    """tests/test_plan_batch.py::test_window_sizes_jax_twin_parity's input
    and bar (2e-4), against the float64 pass and repro's jax twin."""
    a = job_arrays(generate_chain_jobs(30, 3, seed=4))
    xs = np.array([0.3, 0.625, 1.0])
    want = window_sizes_batch(a.e, a.delta, a.mask, a.omega, xs)
    ref32 = np.asarray(window_sizes_batch_jax(a.e, a.delta, a.mask, a.omega,
                                              xs))
    got = window_sizes_batch_device(f32(a.e), f32(a.delta),
                                    torch.as_tensor(a.mask), f32(a.omega),
                                    f32(xs))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), ref32, rtol=2e-4, atol=2e-4)
    assert np.all(got.numpy()[:, ~a.mask] == 0.0)   # padding takes none


def test_expected_spot_work_twin():
    """test_expected_spot_work_jax_parity's input and bar (1e-4), with x a
    scalar and, as the device plan path passes it, a broadcast tensor."""
    rng = np.random.default_rng(2)
    z = rng.uniform(0.1, 30.0, (40, 5))
    delta = rng.choice([1.0, 2.0, 8.0], (40, 5))
    sizes = z / delta + rng.uniform(0.0, 4.0, (40, 5))
    xs = (0.3, 0.625, 1.0)
    for x in xs:
        want = ref_spot_work(z, delta, sizes, x)
        ref32 = np.asarray(expected_spot_work_jax(z, delta, sizes, x))
        got = expected_spot_work_device(f32(z), f32(delta), f32(sizes), x)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), ref32, rtol=1e-4, atol=1e-4)
    grid = expected_spot_work_device(f32(z), f32(delta), f32(sizes),
                                     f32(xs)[:, None, None])
    for g, x in enumerate(xs):
        np.testing.assert_allclose(grid[g].numpy(),
                                   ref_spot_work(z, delta, sizes, x),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["prop12", "naive"])
def test_selfowned_counts_twin(mode):
    """test_selfowned_counts_jax_parity's input and bars: exact against the
    float64 oracle with an integral pool bound (NaN beta0 included), 1e-6
    where a continuous availability query can bind; and against repro's jax
    twin at the same bars."""
    rng = np.random.default_rng(7)
    z = rng.uniform(0.3, 6.0, (30, 4))
    delta = rng.choice([1.0, 2.0, 4.0], (30, 4))
    sizes = rng.uniform(0.4, 3.0, (30, 4))
    beta0 = rng.choice([0.31, 0.57, np.nan], (30, 1))
    for avail in (7.0, rng.uniform(0.0, 5.0, (2, 30, 4))):
        want = _selfowned_counts_vec(z, delta, sizes, beta0, avail, mode)
        ref32 = np.asarray(selfowned_counts_vec_jax(z, delta, sizes, beta0,
                                                    avail, mode=mode))
        got = selfowned_counts_vec_device(
            f32(z), f32(delta), f32(sizes), f32(beta0),
            avail if np.isscalar(avail) else f32(avail), mode=mode).numpy()
        if np.isscalar(avail):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, ref32)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got, ref32, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown self-owned mode"):
        selfowned_counts_vec_device(f32(z), f32(delta), f32(sizes),
                                    f32(beta0), 7.0, mode="greedy")


def test_counts_snap_fully_capped_tasks():
    """Every task the waterfill fills to its cap sits exactly at
    f(beta_0) = 0 (size = e / beta_0): the device counts snap the float32
    blur there to the float64 oracle's 0, from the device waterfill's own
    sizes."""
    a = job_arrays(generate_chain_jobs(40, 2, seed=1))
    xs = np.array([0.3, 0.5, 0.7])
    sizes = window_sizes_batch_device(f32(a.e), f32(a.delta),
                                      torch.as_tensor(a.mask), f32(a.omega),
                                      f32(xs))
    host = window_sizes_batch(a.e, a.delta, a.mask, a.omega, xs)
    for g, x in enumerate(xs):
        want = _selfowned_counts_vec(a.z, a.delta, host[g], x, 1e9, "prop12")
        got = selfowned_counts_vec_device(f32(a.z), f32(a.delta), sizes[g],
                                          x, 1e9).numpy()
        capped = a.mask & np.isclose(host[g], a.e / x, rtol=1e-12)
        assert capped.sum() > 10
        assert np.all(want[capped] == 0.0) and np.all(got[capped] == 0.0)
        np.testing.assert_array_equal(np.where(a.mask, got, 0.0),
                                      np.where(a.mask, want, 0.0))


# ---------------------------------------------------------------------------
# evaluate_grid on device plans against the reference
# ---------------------------------------------------------------------------

def _queries(kind):
    """Availability: absent, one query, or one per scenario (the
    reference's parity-test queries)."""
    if kind == "absent":
        return None
    if kind == "single":
        return lambda s0, e0: np.maximum(35.0 - 0.25 * s0, 0.0)
    return [lambda s0, e0: np.full_like(s0, 9.0),
            lambda s0, e0: np.maximum(30.0 - 0.5 * s0, 0.0)]


@pytest.mark.parametrize("avail", ["absent", "single", "list"])
@pytest.mark.parametrize("path", ["early", "planned"])
@pytest.mark.parametrize("job_type", [1, 2, 3, 4])
def test_device_plans_match_reference(job_type, path, avail):
    """test_device_plan_parity_exp_grids' streams (30 jobs of each type,
    two markets, r = 60) on the early-start grid (spot/on-demand policies
    and every seventh self-owned one) and on Table 6's Even benchmark grid
    (planned starts, naive counts: with no query that is the naive-scalar
    availability), against repro's numpy oracle and its jax device plans."""
    jobs = generate_chain_jobs(30, job_type, seed=5 + job_type)
    markets = ref_make_scenarios(max(j.deadline for j in jobs) + 1, 2, seed=7)
    if path == "early":
        pols = spot_od_policies() + selfowned_policies()[::7]
        kw = dict(windows="dealloc", selfowned="prop12", early_start=True)
    else:
        pols = benchmark_bid_policies()
        kw = dict(windows="even", selfowned="naive", early_start=False)
    kw["availability"] = _queries(avail)
    oracle = ref_evaluate_grid(jobs, pols, markets, 60, backend="numpy", **kw)
    ref32 = ref_evaluate_grid(jobs, pols, markets, 60, backend="jax",
                              plan_backend="device", **kw)
    jobs_t, markets_t, pols_t = port_inputs(jobs, markets, pols)
    # The check below times a device build: start from an empty
    # cross-call plan cache, so that the call builds its groups.
    clear_caches()
    got = evaluate_grid(jobs_t, pols_t, markets_t, 60, device="cpu",
                        plan_backend="device", **kw)
    assert got.timings["plan_device"] > 0.0
    assert (got.timings["pool"] > 0.0) == (avail != "absent")
    np.testing.assert_allclose(got.unit_cost, oracle.unit_cost, atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.unit_cost, ref32.unit_cost, atol=TOL,
                               rtol=TOL)
    assert got.selfowned_work.shape == oracle.selfowned_work.shape
    np.testing.assert_allclose(got.selfowned_work, oracle.selfowned_work,
                               atol=1e-2, rtol=1e-4)
    np.testing.assert_allclose(got.selfowned_reserved,
                               oracle.selfowned_reserved, atol=1e-2,
                               rtol=1e-4)


def test_device_plan_never_calls_host_plan_layer(monkeypatch):
    """test_device_plan_hot_path_never_calls_host_plan_layer on the port:
    the host float64 plan builders are stubbed to fail, on the query-free
    and on the staged (per-scenario queries) path."""
    dealloc_mod = sys.modules["repro_torch.core.dealloc"]
    jobs = generate_chain_jobs(12, 2, seed=4)
    markets = ref_make_scenarios(max(j.deadline for j in jobs) + 1, 2, seed=9)
    pols = selfowned_policies()[::40]
    jobs_t, markets_t, pols_t = port_inputs(jobs, markets, pols)

    def boom(*a, **k):
        raise AssertionError("host plan layer called on the device path")

    got = {}
    # The device path must really build here, not serve the groups from
    # the cross-call plan cache.
    clear_caches()
    with monkeypatch.context() as m:
        m.setattr(plan_mod, "build_plans_batch", boom)
        m.setattr(plan_mod, "_selfowned_counts_vec", boom)
        m.setattr(sched_mod, "window_sizes_batch", boom)
        m.setattr(dealloc_mod, "window_sizes_batch", boom)
        for avail in ("absent", "list"):
            got[avail] = evaluate_grid(
                jobs_t, pols_t, markets_t, 50, device="cpu",
                plan_backend="device", availability=_queries(avail))
            assert got[avail].timings["plan_device"] > 0.0
    for avail, res in got.items():
        ref = ref_evaluate_grid(jobs, pols, markets, 50, backend="numpy",
                                availability=_queries(avail))
        np.testing.assert_allclose(res.unit_cost, ref.unit_cost, atol=TOL,
                                   rtol=TOL)


def test_device_plan_tensors_stay_float32_tensors():
    """The device plan's groups carry float32 tensors on the evaluation
    device for everything the cost kernels read, views of one stack per
    (window plan, beta_0) cell; the self-owned stats are host numpy."""
    jobs = generate_chain_jobs(10, 1, seed=3)
    jobs_t, _, pols_t = port_inputs(
        jobs, ref_make_scenarios(max(j.deadline for j in jobs) + 1, 1),
        selfowned_policies()[::20])
    # A fresh build (the cross-call plan cache emptied): its seconds are
    # checked below, and cached groups would be views of earlier stacks.
    clear_caches()
    gplan = build_grid_plan(jobs_t, pols_t, 40, plan_backend="device",
                            device="cpu")
    assert gplan.device and gplan.plan_backend == "device"
    assert gplan.pool_seconds == 0.0 and gplan.plan_seconds > 0.0
    base = gplan.groups[0].z_t._base
    for g in gplan.groups:
        for t in (g.plan.starts, g.plan.ends, g.z_t, g.d_eff, g.r_alloc):
            assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
            assert t.shape == (10, gplan.L)
        assert g.pins.dtype == torch.bool
        assert g.z_t._base is base
        assert isinstance(g.selfowned_work, np.ndarray)
    host = build_grid_plan(jobs_t, pols_t, 40)
    assert not host.device and len(host.groups) == len(gplan.groups)
    for gh, gd in zip(host.groups, gplan.groups):
        np.testing.assert_array_equal(gh.policy_idx, gd.policy_idx)
        np.testing.assert_allclose(gd.plan.ends.numpy(), gh.plan.ends,
                                   rtol=1e-6)


def test_device_plan_validates_like_the_host():
    """The host path's validation errors: a Dealloc parameter outside
    (0, 1] and a window shorter than the critical path."""
    jobs = generate_chain_jobs(5, 1, seed=1)
    arrival, deadline, z, d = interop.chain_jobs_to_arrays(jobs)
    jobs_t = interop.chain_jobs_from_arrays(arrival, deadline, z, d)
    bad = interop.policies_from_tuples([(1.5, 0.2, None)])
    for kw in ({}, dict(plan_backend="device", device="cpu")):
        with pytest.raises(ValueError, match=r"must be in \(0, 1\]"):
            build_grid_plan(jobs_t, bad, **kw)
    e_sum = np.array([j.min_makespan for j in jobs])
    late = interop.chain_jobs_from_arrays(arrival, arrival + 0.5 * e_sum, z,
                                          d)
    pol = interop.policies_from_tuples([(0.5, 0.2, None)])
    for kw in ({}, dict(plan_backend="device", device="cpu")):
        with pytest.raises(ValueError, match="infeasible job"):
            build_grid_plan(late, pol, **kw)


# ---------------------------------------------------------------------------
# resolve_plan_backend
# ---------------------------------------------------------------------------

def test_plan_backend_resolution():
    """The port's reading of the reference's rule: "auto" is device plans
    on a CUDA card with the dedicated pool, host plans on the CPU or with
    the shared pool; an explicit "device" runs on the CPU too."""
    assert resolve_plan_backend("auto", "cuda") == "device"
    assert resolve_plan_backend("auto", torch.device("cuda", 0)) == "device"
    assert resolve_plan_backend("auto", "cuda", pool="shared") == "host"
    assert resolve_plan_backend("auto", "cpu") == "host"
    assert resolve_plan_backend("host", "cuda") == "host"
    assert resolve_plan_backend("device", "cpu") == "device"
    with pytest.raises(ValueError, match="shared"):
        resolve_plan_backend("device", "cuda", pool="shared")
    with pytest.raises(ValueError, match="unknown plan backend"):
        resolve_plan_backend("tpu", "cuda")

    jobs = generate_chain_jobs(4, 1, seed=1)
    m = ref_make_scenarios(max(j.deadline for j in jobs) + 1, 1, seed=1)
    jobs_t, markets_t, pols_t = port_inputs(jobs, m, spot_od_policies()[:2])
    with pytest.raises(ValueError, match="shared"):
        evaluate_grid(jobs_t, pols_t, markets_t, 10, pool="shared",
                      plan_backend="device", device="cpu")
    with pytest.raises(ValueError, match="shared"):
        build_grid_plan(jobs_t, pols_t, 10, pool="shared",
                        plan_backend="device", device="cpu")
    with pytest.raises(ValueError, match="unknown plan backend"):
        build_grid_plan(jobs_t, pols_t, plan_backend="auto")
    res = evaluate_grid(jobs_t, pols_t, markets_t, device="cpu")
    assert res.timings["plan_device"] == 0.0      # auto on the CPU: host


# ---------------------------------------------------------------------------
# TOLA on device plans
# ---------------------------------------------------------------------------

GRIDS = [("proposed", 0), ("proposed", 150), ("even", 0), ("even", 150)]


@pytest.mark.parametrize("grid,r", GRIDS)
def test_tola_on_device_plans_matches_reference(grid, r):
    """Table 6's stream at 40 jobs of type 2 (jobs from seed 0, two markets
    from seed 1000), one refinement round at r = 150: the round-0 plans
    query-free, the refinement's staged with the realized per-scenario
    queries. Every cost matrix within 1e-5 of repro's jax device-plan run;
    at this size no knife edge is met, so the sampled traces, the realized
    alphas and the weights (1e-5) are the reference's."""
    jobs = generate_chain_jobs(40, job_type=2, seed=0)
    markets = ref_make_scenarios(max(j.deadline for j in jobs) + 1.0, 2,
                                 seed=1000)
    if grid == "proposed":
        pols = selfowned_policies() if r > 0 else spot_od_policies()
        kw = dict(windows="dealloc", selfowned="prop12", early_start=True)
    else:
        pols = benchmark_bid_policies()
        kw = dict(windows="even", selfowned="naive", early_start=False)
    ref = ref_tola.run_tola_scenarios(jobs, pols, markets, r_total=r, seed=0,
                                      pool_iters=1, backend="jax", **kw)
    jobs_t, markets_t, pols_t = port_inputs(jobs, markets, pols)
    # Round 0's device build is timed below: no cross-call plan cache hit.
    clear_caches()
    got = run_tola_scenarios(jobs_t, pols_t, markets_t, r_total=r, seed=0,
                             pool_iters=1, plan_backend="device",
                             device="cpu", **kw)
    assert got[0].timings["plan_device"] > 0.0
    for g, f in zip(got, ref):
        np.testing.assert_allclose(g.cost_matrix, f.cost_matrix, atol=TOL,
                                   rtol=TOL)
        np.testing.assert_array_equal(g.chosen, f.chosen)
        assert g.average_unit_cost() == f.average_unit_cost()
        np.testing.assert_allclose(g.weights, f.weights, atol=TOL)


# ---------------------------------------------------------------------------
# The knife-edge count where the widened ceil epsilon acts
# ---------------------------------------------------------------------------

KNIFE_JOBS, KNIFE_R = 100, 300


def test_knife_edges_no_worse_than_reference_device_plans():
    """The self-owned grid (175 policies, 35 groups) at r = 300, dedicated
    pool, early starts, 100 jobs of each type 1-4 (seed 0), one market
    (seed 1000): unit costs off repro's float64 ``backend="numpy"`` by more
    than 1e-5. The port's device plans may meet no more such cells than
    repro's own device plans (``backend="jax"``), and its largest gap may
    exceed the reference's by no more than 1e-5, the count's resolution.

    Here the port meets 11 cells and the reference 12; both meet the
    largest, 6.94e-2 (type 4, job 15, policy 151), where the float64 f of
    Eq. (11) is 3.7e-9: the host's ceil epsilon (1e-9) gives one instance,
    the device's (1e-5) none (ROADMAP queue C). Each path also meets knife
    edges of its own, in threes (the policies sharing one (window, beta_0,
    bid) group), so the comparison can go either way at other sizes: at 300
    jobs of each type the port meets 43 cells and the reference 42."""
    pols = selfowned_policies()
    count, worst = {"port": 0, "reference": 0}, {"port": 0.0,
                                                "reference": 0.0}
    for jt in (1, 2, 3, 4):
        jobs = generate_chain_jobs(KNIFE_JOBS, jt, seed=0)
        markets = ref_make_scenarios(max(j.deadline for j in jobs) + 1.0, 1,
                                     seed=1000)
        oracle = ref_evaluate_grid(jobs, pols, markets, KNIFE_R,
                                   backend="numpy").unit_cost
        ref32 = ref_evaluate_grid(jobs, pols, markets, KNIFE_R,
                                  backend="jax",
                                  plan_backend="device").unit_cost
        jobs_t, markets_t, pols_t = port_inputs(jobs, markets, pols)
        port = evaluate_grid(jobs_t, pols_t, markets_t, KNIFE_R,
                             device="cpu", plan_backend="device").unit_cost
        for key, got in (("port", port), ("reference", ref32)):
            gap = np.abs(got - oracle)
            count[key] += int((gap > TOL).sum())
            worst[key] = max(worst[key], float(gap.max()))
    assert count["port"] <= count["reference"], (count, worst)
    assert worst["port"] <= worst["reference"] + TOL, (count, worst)
