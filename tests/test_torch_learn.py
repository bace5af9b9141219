"""The port's Hedge replay against the reference ``repro.learn.replay``
(the other learners: ``test_torch_learn_bandits.py``): the Hedge kernel's
plain version (``backend="torch"`` on the CPU) against
the float64 numpy oracle and the reference's Pallas kernel in interpret
mode — sampled traces equal, weights and probabilities within 1e-5, the
bar of ``tests/test_learn.py`` — the plain version against
``repro.kernels.ref.hedge_replay_ref`` at 1e-12 in float64, and the port's
float64 host loop bit-identical to the reference's for every learner."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ref import hedge_replay_ref  # noqa: E402
from repro.learn import LEARNER_KINDS as REF_KINDS  # noqa: E402
from repro.learn import LearnerSpec as RefSpec  # noqa: E402
from repro.learn import Schedule as RefSchedule  # noqa: E402
from repro.learn import build_events as ref_build_events  # noqa: E402
from repro.learn import replay as ref_replay  # noqa: E402

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.weight_update import (  # noqa: E402
    hedge_replay,
    hedge_replay_plain,
)
from repro_torch.learn import LearnerSpec, Schedule, build_events, replay  # noqa: E402

TOL = 1e-5


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


def _hedge_specs(spec, schedule):
    return [spec("hedge"), spec("hedge", eta=schedule("const", 0.3)),
            spec("hedge", eta=schedule("invsqrt", 0.5))]


@pytest.mark.parametrize("ref_backend", ["numpy", "pallas"])
def test_hedge_kernel_plain_matches_reference(ref_backend):
    C, arrivals, d, Z = _tensor(n=60, m=9, seed=1)
    ref = ref_replay(C, arrivals, d, workload=Z,
                     learners=_hedge_specs(RefSpec, RefSchedule), seed=5,
                     backend=ref_backend)
    got = replay(C, arrivals, d, workload=Z,
                 learners=_hedge_specs(LearnerSpec, Schedule), seed=5,
                 backend="torch", device="cpu")
    np.testing.assert_array_equal(got.chosen, ref.chosen)
    np.testing.assert_allclose(got.weights, ref.weights, atol=TOL)
    np.testing.assert_allclose(got.p_chosen, ref.p_chosen, atol=TOL)
    np.testing.assert_allclose(got.expected_unit, ref.expected_unit,
                               atol=TOL)
    np.testing.assert_allclose(got.regret_curve(), ref.regret_curve(),
                               atol=TOL)


def test_hedge_plain_matches_ref_oracle_float64():
    """hedge_replay_plain in float64 == kernels/ref.py::hedge_replay_ref
    (the loop-free trajectory formulation) at 1e-12."""
    C, arrivals, d, _ = _tensor(S=1, seed=2)
    _, _, n_done = ref_build_events(arrivals, d)
    etas = RefSchedule().values(arrivals, d, C.shape[-1])
    u = np.random.default_rng(9).random(len(arrivals))
    ref = hedge_replay_ref(C[0], etas, u, n_done)
    got = hedge_replay_plain(torch.from_numpy(C), torch.from_numpy(etas[None]),
                             torch.from_numpy(u[None]),
                             torch.from_numpy(n_done))
    np.testing.assert_array_equal(got["chosen"][0, 0].numpy(), ref["chosen"])
    np.testing.assert_allclose(got["p_chosen"][0, 0].numpy(),
                               ref["p_chosen"], atol=1e-12)
    np.testing.assert_allclose(got["expected_cost"][0, 0].numpy(),
                               ref["expected_cost"], atol=1e-12)
    lw = got["logw"][0, 0].numpy()
    w = np.exp(lw - lw.max())
    np.testing.assert_allclose(w / w.sum(), ref["weights"], atol=1e-12)


def test_host_loop_bit_identical_every_learner():
    """backend="numpy" is the reference's float64 event loop, copied."""
    C, arrivals, d, Z = _tensor()
    ref = ref_replay(C, arrivals, d, workload=Z,
                     learners=[RefSpec(k) for k in REF_KINDS], seed=3,
                     backend="numpy")
    got = replay(C, arrivals, d, workload=Z,
                 learners=[LearnerSpec(k) for k in REF_KINDS], seed=3,
                 backend="numpy")
    for key in ("chosen", "p_chosen", "expected_unit", "weights"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key))
    assert got.summary() == ref.summary()


def test_build_events_matches_reference():
    _, arrivals, d, _ = _tensor(n=80, seed=4)
    for a, b in zip(build_events(arrivals, d), ref_build_events(arrivals, d)):
        np.testing.assert_array_equal(a, b)


def test_wrapper_takes_plain_version_on_cpu():
    C, arrivals, d, _ = _tensor(n=30, seed=6)
    _, _, n_done = build_events(arrivals, d)
    args = (torch.from_numpy(C.astype(np.float32)),
            torch.rand(2, 30, dtype=torch.float32),
            torch.rand(2, 30, dtype=torch.float32),
            torch.from_numpy(n_done))
    before = dict(LAUNCHES)
    got = hedge_replay(*args)
    want = hedge_replay_plain(*args)
    for key in ("chosen", "p_chosen", "expected_cost", "logw"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError):
        hedge_replay(*(a.to("meta") for a in args))

