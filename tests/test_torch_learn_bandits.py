"""The port's bandit and follow-the-leader replay (``backend="torch"``:
``kernels/learner_replay.py``'s plain version on the CPU, float32 like the
kernel) against the reference ``repro.learn.replay`` on the same numpy
inputs.

* Every learner kind against the reference's float64 loop and its jax scan
  at ``tests/test_learn.py``'s bars: identical sampled traces; weights,
  probabilities, expected costs and regret curves within 1e-5 — on the
  synthetic 2 x 45 x 7 tensor and on the engine tensor of
  ``test_learner_sweep_end_to_end`` (300 jobs, 25 policies, 3 scenarios).
* The plain version in float64 against ``_replay_numpy_one`` within 1e-12.
* At 4000 jobs x 175 policies: hedge, ucb1, egreedy and ftl follow the
  float64 loop to the end; each exp3 instance leaves it only at a draw
  whose float64 margin is under ``learner_replay.margin_bound`` (exp3's
  importance weight makes it chaotic: ROADMAP queue C).
* Seed determinism, the feedback models, FTL's leader, the result's
  confidence bands and ``prop_b1_bound``; the wrapper's routes; the
  kernel's lane layout as the ``.cu`` declares it.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import generate_chain_jobs, spot_od_policies  # noqa: E402
from repro.engine import evaluate_grid as ref_evaluate_grid  # noqa: E402
from repro.engine import make_scenarios as ref_make_scenarios  # noqa: E402
from repro.learn import LEARNER_KINDS as REF_KINDS  # noqa: E402
from repro.learn import LearnerSpec as RefSpec  # noqa: E402
from repro.learn import Schedule as RefSchedule  # noqa: E402
from repro.learn import prop_b1_bound as ref_prop_b1_bound  # noqa: E402
from repro.learn import replay as ref_replay  # noqa: E402
from repro.learn.replay import _replay_numpy_one as ref_host_loop  # noqa: E402

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import learner_replay as lk  # noqa: E402
from repro_torch.learn import (  # noqa: E402
    FULL_INFO_KINDS,
    LEARNER_KINDS,
    LearnerSpec,
    Schedule,
    build_events,
    prop_b1_bound,
    replay,
)

TOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _tensor(S=2, n=45, m=7, seed=0, spread=0.4):
    """tests/test_learn.py's synthetic (S, n, m) unit-cost tensor."""
    rng = np.random.default_rng(seed)
    C = rng.random((S, n, m)) * (1 - spread) + np.linspace(
        0, spread, m)[None, None, :]
    arrivals = np.cumsum(rng.exponential(0.25, n))
    d = 3.0
    Z = rng.random(n) + 0.5
    return C, arrivals, d, Z


def _engine_tensor():
    """test_learn.py::test_learner_sweep_end_to_end's engine tensor: 300
    jobs of type 2, the 25 spot/on-demand policies, 3 fresh scenarios."""
    jobs = generate_chain_jobs(300, job_type=2, seed=1)
    h = max(j.deadline for j in jobs) + 1
    markets = ref_make_scenarios(h, 3, seed=100, kind="fresh")
    res = ref_evaluate_grid(jobs, spot_od_policies(), markets,
                            backend="numpy")
    arrivals = np.array([j.arrival for j in jobs])
    d = max(j.deadline - j.arrival for j in jobs)
    return res.unit_cost, arrivals, d, res.workload


def _specs(spec, schedule, kinds=LEARNER_KINDS):
    """Every kind with its defaults, plus two constant-eta Hedge and exp3
    instances (the sweep of test_learner_sweep_end_to_end, with exp3's)."""
    return [spec(k) for k in kinds] + [
        spec(k, eta=schedule("const", c))
        for k in ("hedge", "exp3") for c in (0.05, 0.2)]


def _inputs(name):
    return _tensor() if name == "small" else _engine_tensor()


@pytest.mark.parametrize("ref_backend", ["numpy", "jax"])
@pytest.mark.parametrize("tensor", ["small", "engine"])
def test_torch_backend_matches_reference_every_learner(tensor, ref_backend):
    C, arrivals, d, Z = _inputs(tensor)
    ref = ref_replay(C, arrivals, d, workload=Z,
                     learners=_specs(RefSpec, RefSchedule), seed=3,
                     backend=ref_backend)
    got = replay(C, arrivals, d, workload=Z,
                 learners=_specs(LearnerSpec, Schedule), seed=3,
                 backend="torch", device="cpu")
    assert got.labels == ref.labels
    np.testing.assert_array_equal(got.chosen, ref.chosen)
    np.testing.assert_allclose(got.weights, ref.weights, atol=TOL)
    np.testing.assert_allclose(got.p_chosen, ref.p_chosen, atol=TOL)
    np.testing.assert_allclose(got.expected_unit, ref.expected_unit,
                               atol=TOL)
    np.testing.assert_allclose(got.regret_curve(), ref.regret_curve(),
                               atol=TOL)


def _plain_inputs(C, arrivals, d, specs, seed, dtype=torch.float64):
    m = C.shape[-1]
    ev_kind, ev_j, n_done = build_events(arrivals, d)
    etas = np.stack([sp.eta.values(arrivals, d, m) for sp in specs])
    gammas = np.stack([sp.explore.values(arrivals, d, m) for sp in specs])
    u = np.stack([np.random.default_rng(seed + s).random(len(arrivals))
                  for s in range(C.shape[0])])
    args = ([sp.kind for sp in specs], torch.tensor(C, dtype=dtype),
            torch.tensor(etas), torch.tensor(gammas), torch.tensor(u),
            torch.from_numpy(ev_kind), torch.from_numpy(ev_j))
    return args, (ev_kind, ev_j, n_done, etas, gammas, u)


@pytest.mark.parametrize("kind", ["exp3", "ucb1", "egreedy", "ftl"])
@pytest.mark.parametrize("shape", [(2, 45, 7, 0), (1, 300, 175, 5)])
def test_plain_float64_matches_reference_host_loop(kind, shape):
    S, n, m, seed = shape
    C, arrivals, d, _ = _tensor(S=S, n=n, m=m, seed=seed)
    specs = [LearnerSpec(kind), LearnerSpec(kind, eta=Schedule("const", 1.0),
                                            explore=Schedule("const", 0.3))]
    args, (ev_kind, ev_j, _, etas, gammas, u) = _plain_inputs(
        C, arrivals, d, specs, seed=7)
    out = lk.learner_replay_plain(*args)
    for s in range(S):
        for k in range(len(specs)):
            ch, p, e, w = ref_host_loop(
                C[s], RefSpec(kind), u[s], ev_kind, ev_j, etas[k], gammas[k])
            np.testing.assert_array_equal(out["chosen"][s, k].numpy(), ch)
            np.testing.assert_allclose(out["p_chosen"][s, k].numpy(), p,
                                       rtol=0, atol=1e-12)
            np.testing.assert_allclose(out["expected_cost"][s, k].numpy(), e,
                                       rtol=0, atol=1e-12)
            np.testing.assert_allclose(out["weights"][s, k].numpy(), w,
                                       rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def long_stream():
    """A long stream: _tensor(S=2, n=4000, m=175, seed=0), replay
    seed 3, every kind with its defaults (the float64 loop's traces too)."""
    C, arrivals, d, _ = _tensor(S=2, n=4000, m=175, seed=0)
    specs = [LearnerSpec(k) for k in LEARNER_KINDS]
    lr = replay(C, arrivals, d, learners=specs, seed=3, backend="torch",
                device="cpu")
    _, (ev_kind, ev_j, n_done, etas, gammas, u) = _plain_inputs(
        C, arrivals, d, specs, seed=3)
    host = [[ref_host_loop(C[s], RefSpec(sp.kind), u[s], ev_kind, ev_j,
                           etas[k], gammas[k])[0]
             for k, sp in enumerate(specs)] for s in range(2)]
    return C, arrivals, d, specs, lr, host, n_done


def _host_draw(C, kind, u, ev_kind, ev_j, etas, gammas, j_star):
    """The reference's float64 loop up to the sample of j_star: that draw's
    margin, and the state's largest |logw| (the plain version's scale)."""
    from repro.learn.learners import init_state, sample_probs, update_state
    from repro.learn.replay import _sample_cdf

    m = C.shape[1]
    st_, chosen, p_sel = init_state(m), {}, {}
    for e, j in zip(ev_kind, ev_j):
        if e == 1:
            oh = np.where(np.arange(m) == chosen[j], 1.0, 0.0)
            st_ = update_state(kind, st_, C[j], oh, p_sel[j], etas[j])
            continue
        p = sample_probs(kind, st_, gammas[j])
        if j == j_star:
            cdf = np.cumsum(p)
            return (float(np.abs(cdf / cdf[-1] - u[j]).min()),
                    float(np.abs(st_["logw"]).max()))
        chosen[j] = _sample_cdf(p, u[j])
        p_sel[j] = p[chosen[j]]
    raise AssertionError(j_star)


@pytest.mark.parametrize("kind", LEARNER_KINDS)
def test_long_stream_traces_against_float64_loop(long_stream, kind):
    """Hedge, ucb1, egreedy and ftl follow the float64 loop over all 4000
    draws; exp3 leaves it, in each scenario, only at a draw whose float64
    margin is under margin_bound (f32's unit roundoff times the roundings
    that the draw and the update before it add, derived in
    learner_replay.py), and that bound is under 1."""
    C, arrivals, d, specs, lr, host, _ = long_stream
    k = [sp.kind for sp in specs].index(kind)
    _, (ev_kind, ev_j, _, etas, gammas, u) = _plain_inputs(
        C, arrivals, d, specs, seed=3)
    for s in range(2):
        diff = np.nonzero(lr.chosen[s, k] != host[s][k])[0]
        if kind != "exp3":
            assert len(diff) == 0, (kind, s, diff[:5])
            continue
        assert len(diff), "exp3 followed the float64 loop over 4000 draws"
        j = int(diff[0])
        margin, scale = _host_draw(C[s], kind, u[s], ev_kind, ev_j, etas[k],
                                   gammas[k], j)
        bound = lk.margin_bound(kind, scale, C.shape[-1])
        assert margin <= bound < 1, (s, j, margin, bound)


def test_exp3_float64_loop_is_chaotic():
    """Why no float32 replay can promise exp3's float64 trace at long
    horizons: the reference's own float64 loop leaves itself when the cost
    tensor moves by one part in 1e15 (ROADMAP queue C)."""
    C, arrivals, d, _ = _tensor(S=1, n=4000, m=175, seed=0)
    spec = RefSpec("exp3")
    ev_kind, ev_j, _ = build_events(arrivals, d)
    etas = spec.eta.values(arrivals, d, 175)
    gammas = spec.explore.values(arrivals, d, 175)
    u = np.random.default_rng(3).random(4000)
    a = ref_host_loop(C[0], spec, u, ev_kind, ev_j, etas, gammas)[0]
    b = ref_host_loop(C[0] * (1 + 1e-15), spec, u, ev_kind, ev_j, etas,
                      gammas)[0]
    diff = np.nonzero(a != b)[0]
    assert len(diff) > 100 and diff[0] > 500


def test_seed_determinism():
    C, arrivals, d, _ = _tensor(S=2, n=50, m=6, seed=4)
    specs = [LearnerSpec(k) for k in LEARNER_KINDS]
    runs = [replay(C, arrivals, d, learners=specs, seed=11, backend=bk,
                   device="cpu") for bk in ("torch", "torch", "numpy")]
    for key in ("chosen", "weights", "p_chosen", "expected_unit"):
        np.testing.assert_array_equal(getattr(runs[0], key),
                                      getattr(runs[1], key))
    np.testing.assert_array_equal(runs[0].chosen, runs[2].chosen)
    other = replay(C, arrivals, d, learners=specs, seed=12, backend="torch",
                   device="cpu")
    assert not np.array_equal(other.chosen, runs[0].chosen)


@pytest.mark.parametrize("kind", ["exp3", "ucb1", "egreedy", "ftl"])
def test_feedback_model(kind):
    """test_bandit_learners_only_see_sampled_column on the port: corrupting
    every cost entry the learner did not sample leaves a bandit learner's
    trace and final state unchanged, and moves a full-information
    learner's (ftl here; Hedge beside it in every case)."""
    C, arrivals, d, _ = _tensor(S=1, n=60, m=6, seed=6)
    args, _ = _plain_inputs(C, arrivals, d, [LearnerSpec(kind)], 2,
                            torch.float32)
    base = lk.learner_replay_plain(*args)
    C2 = C * 2.0
    rows, ch = np.arange(C.shape[1]), base["chosen"][0, 0].numpy()
    C2[0, rows, ch] = C[0, rows, ch]
    args2, _ = _plain_inputs(C2, arrivals, d, [LearnerSpec(kind)], 2,
                             torch.float32)
    again = lk.learner_replay_plain(*args2)
    if kind in FULL_INFO_KINDS:
        assert not torch.equal(base["sums"], again["sums"])
    else:
        for key in ("chosen", "p_chosen", "weights", "logw", "sums",
                    "counts"):
            assert torch.equal(base[key], again[key]), key
    hedge = [replay(c, arrivals, d, learners=["hedge"], seed=2,
                    backend="torch", device="cpu").weights for c in (C, C2)]
    assert not np.array_equal(*hedge)


def test_ftl_plays_cumulative_leader():
    C, arrivals, d, _ = _tensor(S=1, n=40, m=5, seed=8)
    lr = replay(C, arrivals, d, learners=["ftl"], seed=0, backend="torch",
                device="cpu")
    _, _, n_done = build_events(arrivals, d)
    cum = np.concatenate([np.zeros((1, C.shape[2])),
                          np.cumsum(C[0], axis=0)])
    np.testing.assert_array_equal(lr.chosen[0, 0],
                                  cum[n_done].argmin(axis=1))


def test_learn_result_accessors_and_confidence_bands():
    C, arrivals, d, Z = _tensor()
    specs = [LearnerSpec(k) for k in LEARNER_KINDS]
    lr = replay(C, arrivals, d, workload=Z, learners=specs, seed=1,
                backend="torch", device="cpu")
    ref = ref_replay(C, arrivals, d, workload=Z,
                     learners=[RefSpec(k) for k in REF_KINDS], seed=1,
                     backend="numpy")
    S, K, n = lr.chosen.shape
    assert (S, K) == (2, len(LEARNER_KINDS))
    curves = lr.regret_curve()
    np.testing.assert_allclose(curves[..., -1], lr.regret_per_job(),
                               atol=1e-12)
    mean, lo, hi = lr.confidence_bands()
    assert mean.shape == (K, n)
    assert np.all(lo <= mean + 1e-12) and np.all(mean <= hi + 1e-12)
    for a, b in zip(lr.confidence_bands(z=2.5, expected=True),
                    ref.confidence_bands(z=2.5, expected=True)):
        np.testing.assert_allclose(a, b, atol=TOL)
    assert len(lr.summary()) == K


@settings(max_examples=40, deadline=None)
@given(gaps=st.lists(st.floats(0.0, 2.0), min_size=1, max_size=60),
       d=st.floats(0.01, 5.0), m=st.integers(2, 200),
       c_max=st.floats(0.1, 3.0))
def test_prop_b1_bound_equals_reference(gaps, d, m, c_max):
    arrivals = np.cumsum(gaps)
    assert prop_b1_bound(arrivals, d, m, c_max) == \
        ref_prop_b1_bound(arrivals, d, m, c_max)


@pytest.mark.parametrize("seed", range(4))
def test_hedge_regret_respects_prop_b1_scaling(seed):
    """test_learn.py's property on the port's replay: expected Hedge regret
    on synthetic cost matrices stays within the Prop. B.1 bound."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(80, 300))
    m = int(rng.integers(3, 25))
    C = rng.random((1, n, m))
    arrivals = np.cumsum(rng.exponential(float(rng.uniform(0.1, 0.6)), n))
    d = float(rng.uniform(0.5, 4.0))
    lr = replay(C, arrivals, d, learners=["hedge"], seed=seed,
                backend="torch", device="cpu")
    total_regret = float(lr.regret_per_job(expected=True)[0, 0]) * n
    assert total_regret <= prop_b1_bound(arrivals, d, m, c_max=1.0)


def test_wrapper_takes_plain_version_on_cpu():
    C, arrivals, d, _ = _tensor(n=30, seed=6)
    specs = [LearnerSpec(k) for k in ("exp3", "ucb1", "egreedy", "ftl")]
    args, _ = _plain_inputs(C, arrivals, d, specs, 1, torch.float32)
    args = (args[0],) + tuple(a.float() if a.is_floating_point() else
                              a.int() for a in args[1:])
    before = dict(LAUNCHES)
    got = lk.learner_replay(*args)
    want = lk.learner_replay_plain(*args)
    for key in ("chosen", "p_chosen", "expected_cost", "weights", "logw",
                "sums", "counts"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError, match="no kernel"):
        lk.learner_replay(args[0], *(a.to("meta") for a in args[1:]))
    with pytest.raises(ValueError, match="no kernel"):
        lk.learner_replay(["hedge"] * 4, *args[1:])
    with pytest.raises(ValueError, match="inconsistent"):
        lk.learner_replay(args[0], args[1], args[2][:, :-1], *args[3:])


def test_lane_layout_matches_the_kernel_source():
    """The plain version sums in the kernel's order only at the kernel's
    values per lane: LANE_COUNTS is the .cu's kLaneCounts and its switch."""
    src = (REPO / "src/repro_torch/kernels/csrc/learner_replay.cu").read_text()
    decl = re.search(r"kLaneCounts\[\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(x) for x in decl.split(",")) == lk.LANE_COUNTS
    cases = tuple(int(x) for x in re.findall(r"LEARNER_NJ\((\d+)\)", src)
                  if x != "N")
    assert cases == lk.LANE_COUNTS
    assert [lk.lanes(P) for P in (1, 32, 33, 175, 257, 300, 1024)] == \
        [1, 1, 2, 6, 12, 12, 32]
    with pytest.raises(ValueError):
        lk.lanes(1025)


@pytest.mark.parametrize("P", [1, 2, 33, 300])
def test_plain_lane_sums_match_the_kernel_order(P):
    """_lane_sum and _lane_cdf against a scalar walk of the kernel's steps
    (in-lane serial, xor butterfly; in-lane prefix, Hillis-Steele scan)."""
    nj = lk.lanes(P)
    rng = np.random.default_rng(P)
    x = np.zeros((3, 32 * nj), np.float32)
    x[:, :P] = rng.random((3, P)).astype(np.float32)
    got_sum = lk._lane_sum(torch.from_numpy(x), nj).numpy()[:, 0]
    got_cdf = lk._lane_cdf(torch.from_numpy(x), nj).numpy()
    for b in range(3):
        lanes_ = x[b].reshape(32, nj)
        acc = [lanes_[l, 0] for l in range(32)]
        for l in range(32):
            for i in range(1, nj):
                acc[l] = np.float32(acc[l] + lanes_[l, i])
        tot = list(acc)
        for o in (16, 8, 4, 2, 1):
            acc = [np.float32(acc[l] + acc[l ^ o]) for l in range(32)]
        assert got_sum[b] == acc[0]
        incl = list(tot)
        for o in (1, 2, 4, 8, 16):
            incl = [np.float32(incl[l] + incl[l - o]) if l >= o else incl[l]
                    for l in range(32)]
        for l in range(32):
            excl = incl[l - 1] if l else np.float32(0)
            pre = np.float32(0)
            for i in range(nj):
                pre = lanes_[l, 0] if i == 0 else np.float32(
                    pre + lanes_[l, i])
                assert got_cdf[b, l * nj + i] == np.float32(excl + pre)


def test_margin_and_gap_bounds():
    """The stated bounds: f32's unit roundoff times the derived factors."""
    u = 2.0 ** -24
    assert lk.F32_UNIT == u
    assert lk.margin_bound("exp3", 500.0, 175) == \
        u * (12 * 500.0 + 4 * 175 + 16)
    assert lk.margin_bound("egreedy", 5.0, 175) == u * (4 * 175 + 16)
    assert lk.margin_bound("ftl", 5.0, 175) == 2 * u
    assert lk.gap_bound("ftl", 10, 5.0) == u * 2 * 25 * 5.0
    with pytest.raises(ValueError, match="no argmin"):
        lk.gap_bound("exp3", 10, 5.0)


def test_exp3_no_further_from_float64_than_reference_scan():
    """At chip_smoke.py's small input (2 x 300 jobs x 25 policies) exp3's
    importance weight amplifies float32 rounding past tests/test_learn.py's
    1e-5: the reference's own jax scan leaves its float64 loop by about
    5e-5 in the weights. The port (the plain version, bit for bit the
    kernel's arithmetic) draws the same trace and is no further off."""
    rng = np.random.default_rng(4)
    C = rng.random((2, 300, 25)) * 0.6 + np.linspace(0, 0.4, 25)
    arrivals = np.cumsum(rng.exponential(0.25, 300))
    host = ref_replay(C, arrivals, 3.0, learners=["exp3"], seed=5,
                      backend="numpy")
    scan = ref_replay(C, arrivals, 3.0, learners=["exp3"], seed=5,
                      backend="jax")
    got = replay(C, arrivals, 3.0, learners=["exp3"], seed=5,
                 backend="torch", device="cpu")
    np.testing.assert_array_equal(got.chosen, host.chosen)
    np.testing.assert_array_equal(scan.chosen, host.chosen)
    for key in ("weights", "p_chosen", "expected_unit"):
        off = np.abs(getattr(got, key) - getattr(host, key)).max()
        assert off <= np.abs(getattr(scan, key) - getattr(host, key)).max(), key
    assert np.abs(scan.weights - host.weights).max() > TOL
