"""The port's cost tensor (``repro_torch.engine.evaluate_grid`` on the CPU,
i.e. the cost kernels' plain PyTorch versions) against the reference
``repro.engine.evaluate_grid`` — the float64 numpy oracle, the jax backend
and the Pallas kernels in interpret mode — and the plain kernel versions
directly against the reference's Pallas kernels.

Tolerance: the reference's own ``TOL`` = 1e-5 (``tests/test_engine.py``),
on unit costs, i.e. costs per unit of workload, the scale the reference
defines it on. The inputs are the reference's own parity-test inputs
(``tests/test_engine.py``, ``tests/test_plan_batch.py``), built with
``repro`` from numpy seeds and handed to the port as plain arrays through
``repro_torch.interop``. One more input carries a float32 knife edge of the
turning-point inversion (ROADMAP queue C) and states what the port does
there.
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
from repro.engine import build_grid_plan as ref_build_grid_plan  # noqa: E402
from repro.engine import evaluate_grid as ref_evaluate_grid  # noqa: E402
from repro.engine import make_scenarios as ref_make_scenarios  # noqa: E402
from repro.kernels import policy_cost as ref_pc  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.engine import evaluate_grid  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import policy_cost as pc  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def port_inputs(jobs, markets, policies):
    """The same jobs, markets and policies as the port's objects."""
    jobs_t = interop.chain_jobs_from_arrays(*interop.chain_jobs_to_arrays(jobs))
    single = isinstance(markets, SpotMarket)
    ms = [markets] if single else list(markets)
    markets_t = interop.markets_from_prices(np.stack([m.price for m in ms]),
                                            ms[0].slot)
    pols_t = interop.policies_from_tuples(
        [(p.beta, p.bid, p.beta0) for p in policies])
    return jobs_t, markets_t[0] if single else markets_t, pols_t


def _ref_setup(n=25, jt=1, seed=5, mseed=7):
    jobs = generate_chain_jobs(n, job_type=jt, seed=seed)
    return jobs, SpotMarket(max(j.deadline for j in jobs) + 1, seed=mseed)


def _ref_grid():
    return spot_od_policies()[:6] + selfowned_policies()[:6]


def _case(name):
    """(jobs, markets, policies, kwargs) of the reference parity tests."""
    if name == "randomized_seed0":
        jobs, m = _ref_setup(seed=0, mseed=10)
        return jobs, m, _ref_grid(), dict(r_total=60)
    if name == "planned_starts_shared_pool":
        jobs, m = _ref_setup(jt=2)
        return jobs, m, _ref_grid(), dict(
            r_total=40, windows="even", selfowned="naive",
            early_start=False, pool="shared")
    if name == "scenario_batch_regime":
        jobs, m = _ref_setup()
        return jobs, ref_make_scenarios(m.horizon, 3, seed=21, kind="regime"), \
            _ref_grid(), dict(r_total=30)
    if name == "spot_od_r0_fresh":
        jobs, m = _ref_setup()
        return jobs, ref_make_scenarios(m.horizon, 2, seed=21), \
            spot_od_policies(), dict(r_total=0)
    jobs = generate_chain_jobs(20, 2, seed=8)
    markets = ref_make_scenarios(max(j.deadline for j in jobs) + 1, 2, seed=13)
    qs = [lambda s0, e0: np.full_like(s0, 9.0),
          lambda s0, e0: np.maximum(30.0 - 0.5 * s0, 0.0)]
    kw = dict(r_total=50, availability=qs)
    if name == "per_scenario_availability_planned":
        kw.update(windows="even", selfowned="naive", early_start=False)
    return jobs, markets, selfowned_policies()[::40], kw


CASES = ["randomized_seed0", "planned_starts_shared_pool",
         "scenario_batch_regime", "spot_od_r0_fresh",
         "per_scenario_availability_early",
         "per_scenario_availability_planned"]


def _assert_matches(got, ref, exact_plan: bool):
    assert got.unit_cost.shape == ref.unit_cost.shape
    np.testing.assert_allclose(got.unit_cost, ref.unit_cost, atol=TOL,
                               rtol=TOL)
    per_unit = 1.0 / ref.workload[None, :, None]
    for key in ("spot_cost", "ondemand_cost", "spot_work", "ondemand_work"):
        np.testing.assert_allclose(getattr(got, key) * per_unit,
                                   getattr(ref, key) * per_unit,
                                   atol=TOL, rtol=TOL, err_msg=key)
    np.testing.assert_array_equal(got.workload, ref.workload)
    if exact_plan:     # both float64 host plans: bit-identical
        np.testing.assert_array_equal(got.selfowned_work, ref.selfowned_work)
    else:              # the reference's float32 device plan
        np.testing.assert_allclose(got.selfowned_work, ref.selfowned_work,
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend", ["numpy", "jax", "pallas"])
@pytest.mark.parametrize("case", CASES)
def test_cost_tensor_matches_reference(case, backend):
    jobs, markets, pols, kw = _case(case)
    extra = {"interpret": True} if backend == "pallas" else {}
    ref = ref_evaluate_grid(jobs, pols, markets, backend=backend, **kw,
                            **extra)
    jobs_t, markets_t, pols_t = port_inputs(jobs, markets, pols)
    got = evaluate_grid(jobs_t, pols_t, markets_t, device="cpu", **kw)
    assert got.single_market == ref.single_market
    exact_plan = backend == "numpy" or kw.get("pool") == "shared"
    _assert_matches(got, ref, exact_plan)


def test_turning_point_knife_edge_no_worse_than_reference_kernel():
    """Planned starts, Even windows: one task of job 11 has its H target
    within 4e-6 of a plateau of H = t - A(t), below float32 resolution
    (ROADMAP queue C). Every float32 backend leaves the f64 oracle there:
    repro's Pallas kernel by 9.6e-4 in unit cost, the port by 7.0e-4. The
    port matches the oracle within TOL on every other job, and its largest
    deviation is no larger than the reference kernel's."""
    jobs = generate_chain_jobs(16, job_type=2, seed=4)
    markets = ref_make_scenarios(max(j.deadline for j in jobs) + 1.0, 2,
                                 seed=9)
    pols = benchmark_bid_policies()
    kw = dict(r_total=40, windows="even", selfowned="naive",
              early_start=False)
    oracle = ref_evaluate_grid(jobs, pols, markets, backend="numpy", **kw)
    kernel = ref_evaluate_grid(jobs, pols, markets, backend="pallas",
                               interpret=True, **kw)
    jobs_t, markets_t, pols_t = port_inputs(jobs, markets, pols)
    got = evaluate_grid(jobs_t, pols_t, markets_t, device="cpu", **kw)
    dev_port = np.abs(got.unit_cost - oracle.unit_cost)
    dev_kernel = np.abs(kernel.unit_cost - oracle.unit_cost)
    off = dev_port > TOL + TOL * np.abs(oracle.unit_cost)
    assert set(np.argwhere(off)[:, 1].tolist()) == {11}
    assert dev_port.max() <= dev_kernel.max()
    others = np.arange(len(jobs)) != 11
    np.testing.assert_allclose(got.unit_cost[:, others],
                               oracle.unit_cost[:, others], atol=TOL,
                               rtol=TOL)


def _bid_stacked_chain_inputs():
    """tests/test_plan_batch.py::test_chain_kernel_bid_stacked_parity's
    inputs: two bids with unequal row counts (rows zero-padded across bids)
    and scenario-specific plans."""
    rng = np.random.default_rng(0)
    S, L = 2, 4
    rows_per_bid = [10, 7]
    bids = [0.18, 0.27]
    markets = ref_make_scenarios(60.0, S, seed=5)
    R_max, B = max(rows_per_bid), len(bids)
    A = np.stack([np.stack([m.view(b).A_cum for m in markets]) for b in bids])
    C = np.stack([np.stack([m.view(b).C_cum for m in markets]) for b in bids])
    arrival = np.zeros((B, R_max))
    ends = np.zeros((B, R_max, L))
    z_t = np.zeros((B, S, R_max, L))
    d_eff = np.zeros((B, S, R_max, L))
    pins = np.zeros((B, S, R_max, L), dtype=bool)
    for bi, R in enumerate(rows_per_bid):
        arrival[bi, :R] = rng.uniform(0, 20, R)
        sizes = rng.uniform(0.2, 6, (R, L))
        ends[bi, :R] = arrival[bi, :R, None] + np.cumsum(sizes, axis=1)
        d = rng.choice([1.0, 8.0, 64.0], (S, R, L))
        z_t[bi, :, :R] = rng.uniform(0, 1, (S, R, L)) * d * sizes
        d_eff[bi, :, :R] = d
        pins[bi, :, :R] = rng.random((S, R, L)) < 0.15
    return [a.astype(np.float32) for a in
            (A, C, arrival, ends, z_t, d_eff, pins)]


@pytest.mark.parametrize("per_scenario", [True, False])
def test_chain_plain_matches_pallas_kernel(per_scenario):
    """policy_cost_chain_plain == repro's policy_cost_chain (interpret) on
    bid-stacked inputs with zero-padded rows, per unit of row workload."""
    A, C, arrival, ends, z_t, d_eff, pins = _bid_stacked_chain_inputs()
    if not per_scenario:
        z_t, d_eff, pins = z_t[:, 0], d_eff[:, 0], pins[:, 0]
    ref = ref_pc.policy_cost_chain(A, C, arrival, ends, z_t, d_eff, pins,
                                   interpret=True)
    got = pc.policy_cost_chain_plain(
        *(torch.from_numpy(a) for a in (A, C, arrival, ends, z_t, d_eff,
                                        pins)))
    row_work = z_t.sum(axis=-1)                  # (B, S, R) or (B, R)
    if not per_scenario:
        row_work = row_work[:, None, :]
    work = np.maximum(np.broadcast_to(row_work, got["spot_cost"].shape), 1.0)
    for key in pc.OUT_KEYS:
        np.testing.assert_allclose(got[key].numpy() / work,
                                   np.asarray(ref[key]) / work,
                                   atol=TOL, rtol=TOL, err_msg=key)
    assert np.all(got["spot_cost"].numpy()[1, :, 7:] == 0.0)  # padded rows


@pytest.mark.parametrize("per_scenario", [True, False])
def test_task_plain_matches_pallas_kernel(per_scenario):
    """policy_cost_plain == repro's policy_cost (interpret) on the flattened
    Even-plan tasks of one bid, summed per job, per unit of job workload."""
    jobs, markets, pols, kw = _case("per_scenario_availability_planned")
    if not per_scenario:
        kw.pop("availability")
    kw.pop("early_start")
    gplan = ref_build_grid_plan(jobs, pols, n_scenarios=2, **kw)
    g = gplan.groups[0]
    J, L = g.plan.ends.shape
    A = np.stack([m.view(g.bid).A_cum for m in markets]).astype(np.float32)
    C = np.stack([m.view(g.bid).C_cum for m in markets]).astype(np.float32)
    flat = lambda a: np.ascontiguousarray(a, np.float32).reshape(  # noqa: E731
        a.shape[:-2] + (J * L,))
    start, end = flat(g.plan.starts), flat(g.plan.ends)
    z, d = flat(g.z_t), flat(g.d_eff)
    got = pc.policy_cost_plain(*(torch.from_numpy(a)
                                 for a in (A, C, start, end, z, d)))
    for s in range(2):
        ref = ref_pc.policy_cost(A[s], C[s], start, end, z[s] if z.ndim == 2
                                 else z, d[s] if d.ndim == 2 else d,
                                 interpret=True)
        for key in ("spot_cost", "ondemand_cost", "spot_work"):
            per_job = lambda a: np.asarray(a, np.float64).reshape(  # noqa
                J, L).sum(axis=1) / gplan.workload
            np.testing.assert_allclose(per_job(got[key][s].numpy()),
                                       per_job(ref[key]), atol=TOL,
                                       rtol=TOL, err_msg=key)
        np.testing.assert_allclose(got["finish"][s].numpy(),
                                   np.asarray(ref["finish"]), atol=TOL,
                                   rtol=TOL)


def test_wrappers_take_plain_version_on_cpu():
    A, C, arrival, ends, z_t, d_eff, pins = (
        torch.from_numpy(a) for a in _bid_stacked_chain_inputs())
    before = dict(LAUNCHES)
    got = pc.policy_cost_chain(A, C, arrival, ends, z_t, d_eff, pins)
    want = pc.policy_cost_chain_plain(A, C, arrival, ends, z_t, d_eff, pins)
    for key in pc.OUT_KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    T = ends.shape[1] * ends.shape[2]
    got = pc.policy_cost(A[0], C[0], ends[0].reshape(T) - 1.0,
                         ends[0].reshape(T), z_t[0].reshape(2, T),
                         d_eff[0].reshape(2, T))
    assert got["finish"].shape == (2, T)
    assert dict(LAUNCHES) == before  # plain versions launch nothing
