"""The port's ``ScenarioSpec``, its counter hash and its device synthesis
against ``repro``'s.

* ``_mix`` / ``_levels``: the port's int64 torch hash (16-bit split
  multiplies) and its numpy copy bit for bit against the reference's,
  seeds near 2^32, large stream ids and global indices up to 2^31 - 1
  included; ``_avail_threshold`` equal.
* ``ScenarioSpec``: validation, hashing, ``prices`` and ``materialize`` bit
  for bit for all five kinds (chunk slices, adaptive periods and offsets,
  the replay padding warning).
* Device synthesis on the CPU against the reference's jitted
  ``_device_synth_fn`` / ``_device_views_fn``: levels, spike masks and A
  bit for bit; C within 1e-4 (``tests/test_scenarios.py``'s bar); prices
  within 2 float32 ulps. The reference's float32 prices themselves leave
  the float64 oracle rounded to float32 by up to 2 ulps (XLA's fused
  multiply-add and its float32 ``log1p``, 1 ulp each), so no other float32
  evaluation of the transform can be held closer to them.
* ``SynthBatch`` on the device and on the host (the float64 oracle):
  identical availability for every bid of the paper's grids.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import B_BIDS  # noqa: E402
from repro.engine import ScenarioSpec as RefSpec  # noqa: E402
from repro.engine import scenarios as ref_sc  # noqa: E402

from repro_torch.core.market import SpotMarket  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ScenarioSpec,
    SynthBatch,
    replay_scenarios,
)
from repro_torch.engine import scenarios as sc  # noqa: E402

KINDS = ("fresh", "regime", "replay", "adversarial", "adaptive")
GENERATIVE = ("fresh", "regime", "adversarial", "adaptive")
C_TOL = 1e-4          # tests/test_scenarios.py: device C against the oracle
PRICE_ULPS = 2
BIDS = sorted(set(B_BIDS) | {0.12, 0.13, 1.0})


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _traces(rng, S=3, n=40):
    return [0.12 + rng.exponential(0.13, n - 7 * s) for s in range(S)]


def _pair(kind, horizon=20.0, S=7, **kw):
    """The same spec in the port and in the reference."""
    if kind == "replay":
        tr = _traces(np.random.default_rng(3), S=S)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return (ScenarioSpec.from_traces(tr), RefSpec.from_traces(tr))
    return (ScenarioSpec(kind, horizon, S, **kw), RefSpec(kind, horizon, S,
                                                          **kw))


def _ulps(a, b):
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    return np.abs(a - b)


# -- the counter hash ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 99, 1000, 2**32 - 1, 2**32 - 5,
                                  12345678901])
@pytest.mark.parametrize("stream", [0, 1, 2**31 - 1, 98765432109])
def test_levels_bit_for_bit(seed, stream):
    idx = np.array([0, 1, 5, 17, 2**20 + 3, 2**31 - 2, 2**31 - 1])
    want = ref_sc._levels(seed, stream, idx, 257)
    host = sc._levels(seed, stream, idx, 257)
    dev = sc._levels_t(seed, stream, torch.tensor(idx), 257)
    assert dev.dtype == torch.int64
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev.numpy(), want.astype(np.int64))
    assert want.max() < 2**24


def test_mix_bit_for_bit():
    x = np.random.default_rng(1).integers(0, 2**32, 100000, dtype=np.uint32)
    x = np.concatenate([x, np.array([0, 1, 2**31, 2**32 - 1], np.uint32)])
    want = ref_sc._mix(x)
    np.testing.assert_array_equal(sc._mix(x), want)
    got = sc._mix_t(torch.tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for v in (0, 7, 2**32 - 1, 2**40 + 5):
        assert sc._mix_int(v) == ref_sc._mix_int(v)


def test_avail_threshold_equal():
    rng = np.random.default_rng(0)
    for _ in range(60):
        args = (float(rng.uniform(0.05, 0.3)), 0.12, 1.0,
                float(rng.uniform(0.1, 1.1)))
        assert sc._avail_threshold(*args) == ref_sc._avail_threshold(*args)
    for bid in BIDS:
        assert sc._avail_threshold(0.065, 0.12, 1.0, bid) == \
            ref_sc._avail_threshold(0.065, 0.12, 1.0, bid)


# -- the spec -------------------------------------------------------------

def test_spec_hashable_and_validated():
    spec = ScenarioSpec("fresh", 20.0, 4, seed=3)
    assert {spec: 1}[ScenarioSpec("fresh", 20.0, 4, seed=3)] == 1
    assert spec != ScenarioSpec("fresh", 20.0, 4, seed=4)
    for args, kw, msg in ((("bogus", 20.0, 4), {}, "kind"),
                          (("fresh", 20.0, 0), {}, "scenario"),
                          (("replay", 20.0, 1), {}, "trace"),
                          (("fresh", 20.0, 1), {"traces": ((1.0,),)},
                           "replay"),
                          (("replay", 1.0, 3), {"traces": ((1.0,), (0.5,))},
                           "2 traces")):
        with pytest.raises(ValueError, match=msg):
            ScenarioSpec(*args, **kw)
    with pytest.raises(ValueError, match="bad scenario slice"):
        spec.prices(3, 3)
    with pytest.raises(ValueError, match="generative"):
        SynthBatch(_pair("replay", S=3)[0], 0, 2, "cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_prices_and_materialize_bit_for_bit(kind):
    if kind == "replay":
        got, want = _pair(kind, S=3)
        with warnings.catch_warnings():       # the padding warning, once
            warnings.simplefilter("ignore")
            got.prices(), want.prices()
    else:
        got, want = _pair(kind, seed=11, S=7)
    S = got.n_scenarios
    assert (got.n_slots, got.slot, got.generative) == \
        (want.n_slots, want.slot, want.generative)
    P = got.prices()
    np.testing.assert_array_equal(P, want.prices())
    for s0, s1 in ((0, 1), (1, S), (S - 1, S)):
        np.testing.assert_array_equal(got.prices(s0, s1), want.prices(s0, s1))
        np.testing.assert_array_equal(got.prices(s0, s1), P[s0:s1])
    mats = got.materialize(1, S)
    assert all(isinstance(m, SpotMarket) for m in mats)
    for g, w in zip(mats, want.materialize(1, S)):
        np.testing.assert_array_equal(g.price, w.price)
        for bid in (0.13, 0.21, 1.0):
            np.testing.assert_array_equal(g.view(bid).A_cum,
                                          w.view(bid).A_cum)
            np.testing.assert_array_equal(g.view(bid).C_cum,
                                          w.view(bid).C_cum)
    if kind != "replay":
        idx = np.arange(S)
        for bid in (0.13, 0.21):
            np.testing.assert_array_equal(got.thresholds(bid, idx),
                                          want.thresholds(bid, idx))


@pytest.mark.parametrize("kind", ["adversarial", "adaptive"])
def test_wave_overrides_bit_for_bit(kind):
    got, want = _pair(kind, horizon=30.0, S=6, seed=5, n_periods=3,
                      n_phases=4, spike_range=(0.25, 6.0))
    np.testing.assert_array_equal(got.period_menu(), want.period_menu())
    idx = np.arange(6)
    np.testing.assert_array_equal(got.default_periods(idx),
                                  want.default_periods(idx))
    periods = np.array([0.5, 0.5, 2.0, 2.0, 6.0, 0.25])
    offsets = np.array([0, 3, -1, 7, 100, -1])
    for a, b in zip(got.wave_slots(periods), want.wave_slots(periods)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        got.prices(0, 6, periods=periods, offsets=offsets),
        want.prices(0, 6, periods=periods, offsets=offsets))


def test_replay_padding_warning_bit_for_bit():
    m = SpotMarket(30.0, seed=3)
    short = m.price[:m.n_slots // 2]
    with pytest.warns(UserWarning, match="1 trace"):
        got = replay_scenarios([m.price, short])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_sc.replay_scenarios([m.price, short])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.price, w.price)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        replay_scenarios([m.price, m.price * 0.5])
    with pytest.warns(UserWarning, match="padded"):
        spec = ScenarioSpec.from_traces([m.price, short])
        np.testing.assert_array_equal(spec.prices()[1], want[1].price)


# -- device synthesis -------------------------------------------------------

def _wave_rows(spec, idx, periods=None, offsets=None):
    if spec.kind in ("adversarial", "adaptive"):
        ps, ss = spec.wave_slots(spec.default_periods(idx) if periods is None
                                 else periods)
    else:
        ps, ss = np.full(len(idx), 2), np.ones(len(idx), np.int64)
    off = np.full(len(idx), -1) if offsets is None else offsets
    return [np.asarray(a, np.int64) for a in (idx, ps, ss, off)]


@pytest.mark.parametrize("kind", GENERATIVE)
def test_device_synthesis_matches_reference(kind):
    got, want = _pair(kind, horizon=150.0, S=9, seed=1000)
    idx = np.arange(2, 9)
    offsets = np.array([0, 3, -1, 7, 100, -1, 5]) if kind == "adaptive" \
        else None
    rows = _wave_rows(want, idx, offsets=offsets)
    hj, pj, sj = (np.asarray(x) for x in ref_sc._device_synth_fn(want)(
        *(jnp.asarray(a, jnp.int32) for a in rows)))
    h, p, spike = sc._device_synth(got, *(torch.tensor(a) for a in rows))
    assert (h.dtype, p.dtype, spike.dtype) == \
        (torch.int32, torch.float32, torch.bool)
    np.testing.assert_array_equal(h.numpy(), hj)
    np.testing.assert_array_equal(spike.numpy(), sj)
    assert _ulps(p.numpy(), pj).max() <= PRICE_ULPS
    if kind in ("adversarial", "adaptive"):
        host = got.spike_mask(2, 9, offsets=offsets)
        np.testing.assert_array_equal(spike.numpy(), host)
        np.testing.assert_array_equal(
            np.where(host, got.price_hi, 0.0),
            np.where(host, got.prices(2, 9, offsets=offsets), 0.0))
    views = ref_sc._device_views_fn(want.slot)
    for bid in BIDS:
        th = want.thresholds(bid, idx)
        clears = want.price_hi <= bid + 1e-12
        Aj, Cj = (np.asarray(x) for x in views(
            jnp.asarray(hj), jnp.asarray(pj), jnp.asarray(sj),
            jnp.asarray(th), clears))
        A, C = sc._device_views(h, p, spike, torch.tensor(th), clears,
                                got.slot)
        np.testing.assert_array_equal(A.numpy(), Aj)
        np.testing.assert_allclose(C.numpy(), Cj, atol=C_TOL, rtol=0)


@pytest.mark.parametrize("kind", GENERATIVE)
def test_synth_batch_device_availability_is_the_hosts(kind):
    """Device and host (float64 oracle) chunks: the same available slots for
    every bid, A within one rounding of the host's, C within 1e-4."""
    spec = ScenarioSpec(kind, 60.0, 5, seed=13, n_periods=2, n_phases=2)
    kw = {}
    if kind == "adaptive":
        kw = dict(periods=np.array([0.5, 0.5, 4.0]),
                  offsets=np.array([0, 3, -1]))
    dev = SynthBatch(spec, 2, 5, "cpu", **kw).prepare()
    host = SynthBatch(spec, 2, 5, "cpu", host=True, **kw).prepare()
    np.testing.assert_array_equal(
        np.stack([m.price for m in host.markets]),
        spec.prices(2, 5, kw.get("periods"), kw.get("offsets")))
    for bid in BIDS:
        Ah, Ch = host.stacked(bid)
        Ad, Cd = dev.stacked(bid)
        assert dev.stacked(bid)[0] is Ad          # built once per bid
        np.testing.assert_array_equal(np.diff(Ad.numpy(), axis=1) > 0,
                                      np.diff(Ah.numpy(), axis=1) > 0)
        np.testing.assert_allclose(Ad.numpy(), Ah.numpy(), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(Cd.numpy(), Ch.numpy(), atol=C_TOL,
                                   rtol=0)


def test_device_views_count_a_exactly():
    """A is the exact available-slot count times the slot: one float32
    rounding at every length, where a float32 running sum would drift."""
    n = 33021
    h = torch.zeros((1, n), dtype=torch.int32)
    p = torch.full((1, n), 0.5)
    A, C = sc._device_views(h, p, torch.zeros((1, n), dtype=torch.bool),
                            torch.tensor([0], dtype=torch.int32), False,
                            1.0 / 12)
    k = torch.arange(n + 1, dtype=torch.float32)
    assert torch.equal(A[0], k * (1.0 / 12))
    np.testing.assert_array_equal(
        C[0].numpy(), (np.arange(n + 1) * np.float64(np.float32(0.5 / 12)))
        .astype(np.float32))
