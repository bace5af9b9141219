"""The port's materialized scenario families against ``repro``'s.

* ``make_scenarios`` for ``fresh``, ``regime`` and ``adversarial`` under
  the ``shifted`` and ``truncate`` price models, and
  ``adversarial_scenarios``: prices and each bid's cumulative A and C bit
  for bit (the same numpy ``Generator`` streams).
* ``adaptive`` and unknown kinds are refused.
* ``make_setup`` and the drivers take ``--scenario-kind``; Table 6 on the
  adversarial family matches the reference's exp4 ``run`` with its numpy
  backend at 40 jobs: the same sampled traces, so the realized alphas are
  equal, and the rest within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.engine as ref_engine  # noqa: E402
from repro.core import B_BIDS  # noqa: E402
from repro.engine import adversarial_scenarios as ref_adversarial  # noqa: E402
from repro.engine import make_scenarios as ref_make_scenarios  # noqa: E402

from repro_torch.engine import adversarial_scenarios, make_scenarios  # noqa: E402
from repro_torch.experiments import common, table6  # noqa: E402
from repro_torch.experiments import exp1_spot_ondemand as exp1  # noqa: E402

TOL = 1e-5
HORIZON = 173.4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def ref_exp4():
    """The reference's exp4 driver. ``benchmarks/common.py`` turns on jax's
    persistent compilation cache when imported; the import here keeps it
    off (the numpy backend compiles nothing)."""
    saved = ref_engine.setup_persistent_cache
    ref_engine.setup_persistent_cache = lambda *a, **k: None
    try:
        from benchmarks import common as ref_common
        from benchmarks import exp4_online_learning as r4
    finally:
        ref_engine.setup_persistent_cache = saved
    return ref_common, r4


def assert_markets_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.n_slots, g.slots_per_unit, g.p_ondemand) == \
            (w.n_slots, w.slots_per_unit, w.p_ondemand)
        np.testing.assert_array_equal(g.price, w.price)
        for bid in B_BIDS:
            np.testing.assert_array_equal(g.view(bid).A_cum, w.view(bid).A_cum)
            np.testing.assert_array_equal(g.view(bid).C_cum, w.view(bid).C_cum)


@pytest.mark.parametrize("price_model", ["shifted", "truncate"])
@pytest.mark.parametrize("kind", ["fresh", "regime", "adversarial"])
@pytest.mark.parametrize("S", [1, 3])
def test_make_scenarios_bit_for_bit(kind, price_model, S):
    got = make_scenarios(HORIZON, S, seed=11, kind=kind,
                         price_model=price_model)
    want = ref_make_scenarios(HORIZON, S, seed=11, kind=kind,
                              price_model=price_model)
    assert_markets_equal(got, want)


def test_family_options_bit_for_bit():
    """The regime sweep's mean range and the adversarial spike range and
    fraction pass through."""
    kw = dict(mean_range=(0.14, 0.3), spike_range=(1.0, 6.0), spike_frac=0.3)
    for kind in ("regime", "adversarial"):
        assert_markets_equal(make_scenarios(HORIZON, 4, seed=2, kind=kind, **kw),
                             ref_make_scenarios(HORIZON, 4, seed=2, kind=kind,
                                                **kw))


@pytest.mark.parametrize("S,spu", [(1, None), (2, None), (5, 6)])
def test_adversarial_scenarios_bit_for_bit(S, spu):
    got = adversarial_scenarios(HORIZON, S, seed=5, slots_per_unit=spu)
    want = ref_adversarial(HORIZON, S, seed=5, slots_per_unit=spu)
    assert_markets_equal(got, want)
    # the spike phase sits above every bid: no bid clears there
    assert all(m.price.max() == 1.0 for m in got)


def test_refused_kinds():
    with pytest.raises(ValueError, match="chunk-boundary feedback"):
        make_scenarios(HORIZON, 2, kind="adaptive")
    with pytest.raises(ValueError, match="unknown scenario kind"):
        make_scenarios(HORIZON, 2, kind="weekly")
    with pytest.raises(ValueError, match="at least one scenario"):
        make_scenarios(HORIZON, 0, kind="regime")
    with pytest.raises(ValueError, match="chunk-boundary feedback"):
        common.make_setup(6, 2, scenarios=2, scenario_kind="adaptive",
                          device="cpu")
    with pytest.raises(SystemExit):
        table6.main(["--scenario-kind", "adaptive", "--device", "cpu"])


@pytest.mark.parametrize("kind", ["fresh", "regime", "adversarial"])
def test_make_setup_matches_reference(ref_exp4, kind):
    ref_common, _ = ref_exp4
    got = common.make_setup(20, 3, seed=4, scenarios=2, scenario_kind=kind,
                            device="cpu")
    want = ref_common.make_setup(20, 3, seed=4, scenarios=2,
                                 scenario_kind=kind, backend="numpy")
    assert [j.arrival for j in got.jobs] == [j.arrival for j in want.jobs]
    assert_markets_equal(got.markets, want.markets)


def test_drivers_take_scenario_kind():
    args = common.argparser("t").parse_args(["--scenario-kind", "regime"])
    assert args.scenario_kind == "regime"
    assert common.argparser("t").parse_args([]).scenario_kind == "fresh"
    res = exp1.main(["--jobs", "12", "--types", "1", "--scenarios", "2",
                     "--scenario-kind", "adversarial", "--device", "cpu"])
    assert 0.0 < res[1]["alpha"] <= 1.0


def test_table6_adversarial_matches_reference_exp4(ref_exp4):
    """Table 6 at 40 jobs, S = 2 adversarial markets, r in {0, 150}: the
    port's ``table6.main`` on the CPU against the reference's exp4
    ``run(..., backend="numpy")``. The realized alphas are host float64
    replays of the sampled traces, so equal traces make them equal; the
    learner's weights and the best fixed policy come from the float32
    cost tensor (1e-5)."""
    _, r4 = ref_exp4
    got = table6.main(["--jobs", "40", "--r", "0", "150", "--scenarios", "2",
                       "--scenario-kind", "adversarial", "--device", "cpu"])
    want = r4.run(40, [0, 150], seed=0, scenarios=2,
                  scenario_kind="adversarial", backend="numpy")
    for r in (0, 150):
        g, w = got[r], want[r]
        for key in ("alpha_tola", "alpha_bench", "rho_bar"):
            assert g[key] == w[key], (r, key, g[key], w[key])
        for key in ("best_fixed", "regret", "top_weight", "alpha_tola_std"):
            assert abs(g[key] - w[key]) <= TOL, (r, key, g[key], w[key])
