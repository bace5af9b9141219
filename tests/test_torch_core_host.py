"""The port's host scheduling core against ``repro.core``, bit for bit:
the slot-stepping oracle (``oracle_task``, ``oracle_greedy_chain``), the
single-task policies of ``core/policy.py`` and Algorithm 1's ``dealloc``
with its window and expected-spot-work helpers, on hypothesis-drawn inputs
and on the paper's worked examples (the cases of
``tests/test_paper_examples.py``). Also the port's batch Greedy against its
own sequential oracle (the reference's 1e-6 bar), and ROADMAP queue C's
knife-edge task, where the port's oracle matches the reference's oracle."""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis (requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import SpotMarket as RefMarket  # noqa: E402
from repro.core import chain_from_arrays as ref_chain  # noqa: E402
from repro.core import generate_chain_jobs as ref_jobs  # noqa: E402
from repro.core import oracle as ref_oracle  # noqa: E402
from repro.core import policy as ref_policy  # noqa: E402
from repro.core.simulate import simulate_tasks as ref_simulate_tasks  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import SpotMarket, chain_from_arrays, run_greedy  # noqa: E402
from repro_torch.core import oracle, policy  # noqa: E402

# The modules, not the ``dealloc`` functions their packages export.
ref_dealloc_mod = importlib.import_module("repro.core.dealloc")
dealloc_mod = importlib.import_module("repro_torch.core.dealloc")
# No example database: the tests write nothing into the checkout.
PROPS = settings(max_examples=60, deadline=None, database=None)
MARKET_ARGS = (250.0, 42)
REF_MARKET = RefMarket(*MARKET_ARGS[:1], seed=MARKET_ARGS[1])
PORT_MARKET = SpotMarket(*MARKET_ARGS[:1], seed=MARKET_ARGS[1])
BIDS = [0.18, 0.21, 0.24, 0.27, 0.30]
DELTAS = [1.0, 2.0, 8.0, 64.0]
# Section 4.1.1's example chain (Figs. 3-4): l=4, window [0, 4].
FIG34 = (0.0, 4.0, [1.5, 0.5, 2.5, 0.5], [2.0, 1.0, 3.0, 1.0])


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def assert_same(a, b):
    """Bit-identical results: dicts, dataclasses, arrays and floats."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif dataclasses.is_dataclass(a):
        assert_same(dataclasses.asdict(a), dataclasses.asdict(b))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


chains = st.tuples(
    st.lists(st.floats(0.1, 30.0), min_size=1, max_size=8),
    st.lists(st.sampled_from(DELTAS), min_size=8, max_size=8),
    st.floats(0.0, 20.0),     # slack
    st.floats(0.0, 150.0),    # arrival
)


def both_chains(args):
    zs, ds, slack, arrival = args
    ds = ds[:len(zs)]
    deadline = arrival + sum(z / d for z, d in zip(zs, ds)) + slack
    return (ref_chain(arrival, deadline, zs, ds),
            chain_from_arrays(arrival, deadline, zs, ds))


def test_markets_are_the_same():
    np.testing.assert_array_equal(PORT_MARKET.price, REF_MARKET.price)
    assert (PORT_MARKET.slot, PORT_MARKET.p_ondemand) == \
        (REF_MARKET.slot, REF_MARKET.p_ondemand)


@PROPS
@given(st.floats(0.0, 150.0), st.floats(0.05, 40.0), st.floats(0.0, 1.0),
       st.sampled_from(DELTAS), st.sampled_from(BIDS))
def test_oracle_task_bit_identical(start, size, frac, delta, bid):
    end, z = start + size, frac * delta * size
    assert_same(oracle.oracle_task(PORT_MARKET, bid, start, end, z, delta),
                ref_oracle.oracle_task(REF_MARKET, bid, start, end, z, delta))


@pytest.mark.parametrize("d_eff", [0.0, -1.0])
def test_oracle_task_without_instances_raises_like_the_reference(d_eff):
    for mod, m in ((oracle, PORT_MARKET), (ref_oracle, REF_MARKET)):
        with pytest.raises(ValueError, match="no cloud instances"):
            mod.oracle_task(m, 0.24, 0.0, 5.0, 1.0, d_eff)
    assert_same(oracle.oracle_task(PORT_MARKET, 0.24, 3.0, 5.0, 0.0, 0.0),
                ref_oracle.oracle_task(REF_MARKET, 0.24, 3.0, 5.0, 0.0, 0.0))


@PROPS
@given(chains, st.sampled_from(BIDS))
def test_oracle_greedy_chain_bit_identical(args, bid):
    ref_job, job = both_chains(args)
    assert_same(
        oracle.oracle_greedy_chain(PORT_MARKET, bid, job.arrival,
                                   job.deadline, job.z_array(),
                                   job.delta_array()),
        ref_oracle.oracle_greedy_chain(REF_MARKET, bid, ref_job.arrival,
                                       ref_job.deadline, ref_job.z_array(),
                                       ref_job.delta_array()))


@PROPS
@given(st.floats(0.0, 200.0), st.sampled_from(DELTAS), st.floats(0.01, 40.0),
       st.floats(0.0, 1.0), st.floats(0.0, 200.0), st.booleans())
def test_policy_functions_bit_identical(z, delta, size, x, avail, integral):
    assert_same(policy.f_selfowned(z, delta, size, x),
                ref_policy.f_selfowned(z, delta, size, x))
    assert_same(policy.selfowned_allocation(z, delta, size, x, avail, integral),
                ref_policy.selfowned_allocation(z, delta, size, x, avail,
                                                integral))
    for t in (0.0, size / 2, size):
        assert policy.flexibility(z, delta, size, t) == \
            ref_policy.flexibility(z, delta, size, t)
    beta = min(max(x, 0.01), 0.99)
    assert_same(policy.turning_point_expected(z, delta, size, beta),
                ref_policy.turning_point_expected(z, delta, size, beta))
    for b in (beta, 1.0):
        try:
            want = ref_policy.spot_ondemand_split(z, delta, size, b)
        except ValueError:
            with pytest.raises(ValueError, match="below minimum"):
                policy.spot_ondemand_split(z, delta, size, b)
            continue
        got = policy.spot_ondemand_split(z, delta, size, b)
        assert type(got).__name__ == type(want).__name__ == "SpotOndemandSplit"
        assert_same(got, want)


PAPER_SPLITS = [  # (z, delta, size, beta) of test_paper_examples.py
    (1.5, 2.0, 2.0, 0.5), (4.0, 2.0, 4.0, 0.5), (4.0, 2.0, 3.9, 0.5),
    (4.0, 2.0, 2.0, 0.5)]
PAPER_ALLOCS = [  # (z, delta, size, beta0, available)
    (100.0, 4.0, 3.0, 0.1, 2.0), (100.0, 4.0, 3.0, 0.1, 100.0),
    (1.0, 64.0, 10.0, 0.01, 100.0)]


def test_policy_paper_examples_bit_identical():
    for args in PAPER_SPLITS:
        assert_same(policy.spot_ondemand_split(*args),
                    ref_policy.spot_ondemand_split(*args))
    s = policy.spot_ondemand_split(1.5, 2.0, 2.0, 0.5)
    assert s.turning is None and s.s == 2
    s = policy.spot_ondemand_split(4.0, 2.0, 2.0, 0.5)
    assert s.o == 2.0 and s.turning == 0.0
    for mod in (policy, ref_policy):
        with pytest.raises(ValueError):
            mod.spot_ondemand_split(z=4.0, delta=2.0, size=1.9, beta=0.5)
    assert policy.turning_point_expected(3.5, 2.0, 2.0, 0.5) == \
        ref_policy.turning_point_expected(3.5, 2.0, 2.0, 0.5) == 0.5
    for args in PAPER_ALLOCS:
        assert policy.selfowned_allocation(*args) == \
            ref_policy.selfowned_allocation(*args)
    xs = np.linspace(0.05, 0.99, 50)
    assert_same(policy.f_selfowned(10.0, 4.0, 3.0, xs),
                ref_policy.f_selfowned(10.0, 4.0, 3.0, xs))
    for (z, d, size, beta) in [(10, 4, 3, 0.5), (5, 8, 1, 0.3), (20, 4, 6, 0.9),
                               (6.0, 3.0, 4.0, 0.5)]:
        assert policy.f_selfowned(z, d, size, beta) == \
            ref_policy.f_selfowned(z, d, size, beta)


def _dealloc_same(ref_job, job, x, r):
    got = dealloc_mod.dealloc(job, x, r)
    want = ref_dealloc_mod.dealloc(ref_job, x, r)
    assert got.windows == want.windows and got.r == want.r
    assert_same(got.sizes, want.sizes)
    sizes = dealloc_mod.window_sizes(job, x)
    assert dealloc_mod.allocation_windows(job, sizes) == \
        ref_dealloc_mod.allocation_windows(ref_job, sizes)
    for xx in (x, 1.0):
        assert_same(
            dealloc_mod.expected_spot_work(job.z_array(), job.delta_array(),
                                           sizes, xx),
            ref_dealloc_mod.expected_spot_work(ref_job.z_array(),
                                               ref_job.delta_array(), sizes,
                                               xx))
    return got


@PROPS
@given(chains, st.floats(0.05, 1.0), st.booleans())
def test_dealloc_bit_identical(args, x, with_r):
    ref_job, job = both_chains(args)
    r = np.arange(job.l, dtype=np.float64) if with_r else None
    _dealloc_same(ref_job, job, x, r)


def test_dealloc_paper_example_bit_identical():
    """Figs. 3-4: sizes (4/3, 1/2, 5/3, 1/2) and 22/6 units on spot; the
    artificial split s_i = 1 gets 2."""
    job = chain_from_arrays(*FIG34)
    got = _dealloc_same(ref_chain(*FIG34), job, 0.5, None)
    np.testing.assert_allclose(got.sizes, [4 / 3, 0.5, 5 / 3, 0.5], atol=1e-12)
    assert got.r == (0.0,) * 4
    zo = dealloc_mod.expected_spot_work(job.z_array(), job.delta_array(),
                                        got.sizes, 0.5)
    assert abs(zo.sum() - 22 / 6) < 1e-12
    zo = dealloc_mod.expected_spot_work(job.z_array(), job.delta_array(),
                                        np.ones(4), 0.5)
    assert abs(zo.sum() - 2.0) < 1e-12
    with pytest.raises(ValueError, match="arity"):
        dealloc_mod.dealloc(job, 0.5, np.ones(3))


def test_batch_greedy_equals_oracle_greedy():
    """The reference's bar (test_core_properties.py): the slot-synchronous
    batch Greedy within 1e-6 of the sequential oracle, per job."""
    ref = ref_jobs(60, job_type=1, seed=5)
    jobs = interop.chain_jobs_from_arrays(*interop.chain_jobs_to_arrays(ref))
    m = SpotMarket(max(j.deadline for j in jobs) + 1, seed=6)
    for bid in (0.18, 0.30):
        batch = run_greedy(jobs, bid, m, batch=True)
        seq = run_greedy(jobs, bid, m, batch=False)
        for ji, job in enumerate(jobs):
            orc = oracle.oracle_greedy_chain(m, bid, job.arrival, job.deadline,
                                             job.z_array(), job.delta_array())
            assert abs(batch.spot_cost[ji] - orc["spot_cost"]) < 1e-6
            assert abs(batch.ondemand_cost[ji] - orc["ondemand_cost"]) < 1e-6
            assert seq.spot_cost[ji] == orc["spot_cost"]
            assert seq.ondemand_work[ji] == orc["ondemand_work"]


def test_knife_edge_task_of_roadmap_c():
    """start=0, size=5, frac=0.25, delta=1, bid=0.18 on SpotMarket(250,
    seed=42): the reference's ``simulate_tasks`` finishes at 2.75, its
    slot-stepping ``oracle_task`` at 2.5833 (queue C). The port's oracle
    matches the reference's oracle bit for bit, finish included; costs and
    work agree with the closed-form simulator."""
    start, size, frac, delta, bid = 0.0, 5.0, 0.25, 1.0, 0.18
    end, z = start + size, frac * delta * size
    got = oracle.oracle_task(PORT_MARKET, bid, start, end, z, delta)
    assert_same(got, ref_oracle.oracle_task(REF_MARKET, bid, start, end, z,
                                            delta))
    assert abs(got["finish"] - 2.5833333) < 1e-6
    sim = ref_simulate_tasks(REF_MARKET.view(bid), *[np.array([v]) for v in
                                                    (start, end, z, delta)])
    assert sim.finish[0] == 2.75
    for key in ("spot_cost", "ondemand_cost", "spot_work"):
        assert abs(got[key] - getattr(sim, key)[0]) < 1e-8
