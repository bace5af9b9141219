"""The Hedge trajectory kernel's exact max and its launch plan, checked on
the CPU. The kernel (``csrc/hedge_replay.cu``) runs only on the card, where
``chip_smoke.py`` holds its trajectory bit for bit against
``hedge_replay_plain``. Here:

* the order-preserving integer image of a float32, i ^ ((i >> 31) &
  0x7fffffff), on numpy arrays with +-0, +-inf, subnormals and extremes:
  integer order is float order (-0 just below +0), and the map is its own
  inverse;
* an emulation of the kernel's warp layout (policy p = j * 32 + lane,
  ceil(P / 32) values per lane or more, padding slots at -inf with a zero
  cost), a step's max taken in-lane and then over the 32 lanes on the
  integer images, equal bit for bit to ``hedge_replay_plain``'s trajectory;
  and, at 1e-5 on the final weights, to the reference's float64 oracle
  ``repro/kernels/ref.py::hedge_replay_ref``;
* ``hedge_plan`` (the blocks) at Table 6's Hedge shape and over the range
  of K and P the kernel takes. The ``.cu`` lays out the registers and the
  cost ring itself; ``chip_smoke.py`` reads that layout from it
  (``weight_update.ring``) and checks the ring against the card's shared
  memory.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ref import hedge_replay_ref  # noqa: E402

from repro_torch.kernels import weight_update as wu  # noqa: E402

@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def ordered(i: np.ndarray) -> np.ndarray:
    """The kernel's map on int32 bit patterns (numpy's >> is arithmetic)."""
    return i ^ ((i >> 31) & np.int32(0x7FFFFFFF))


# -- the integer image ---------------------------------------------------------

def _special_floats() -> np.ndarray:
    f32 = np.finfo(np.float32)
    tiny_sub = np.float32(1e-45)                 # the smallest subnormal
    vals = [0.0, -0.0, np.inf, -np.inf, f32.max, -f32.max, f32.tiny,
            -f32.tiny, tiny_sub, -tiny_sub, f32.tiny - tiny_sub,
            -(f32.tiny - tiny_sub), 1.0, -1.0, f32.eps, -f32.eps,
            np.nextafter(np.float32(1), np.float32(2)),
            np.nextafter(np.float32(-1), np.float32(-2)), -5.1929, 123.5]
    return np.array(vals, dtype=np.float32)


def test_ordered_map_keeps_float_order_on_special_values():
    x = _special_floats()
    k = ordered(x.view(np.int32))
    for a in range(len(x)):
        for b in range(len(x)):
            if x[a] < x[b]:
                assert k[a] < k[b], (x[a], x[b])
            elif x[a] == x[b] and np.signbit(x[a]) == np.signbit(x[b]):
                assert k[a] == k[b]
    # -0 sits just below +0, so a max over the images is a max of floats.
    assert ordered(np.array([-0.0], np.float32).view(np.int32))[0] \
        == ordered(np.array([0.0], np.float32).view(np.int32))[0] - 1
    np.testing.assert_array_equal(ordered(k), x.view(np.int32))


def test_ordered_map_on_random_bit_patterns():
    rng = np.random.default_rng(0)
    bits = rng.integers(-2**31, 2**31, 200000, dtype=np.int64).astype(
        np.int32)
    x = bits.view(np.float32)
    keep = ~np.isnan(x)
    bits, x = bits[keep], x[keep]
    k = ordered(bits)
    np.testing.assert_array_equal(ordered(k), bits)     # its own inverse
    order = np.argsort(k, kind="stable")
    assert np.all(np.diff(x[order].astype(np.float64)) >= 0)
    # The max over the images is the max of the floats.
    for chunk in np.array_split(np.arange(len(x)), 50):
        top = ordered(np.array([k[chunk].max()], np.int32))
        assert top.view(np.float32)[0] == x[chunk].max()


# -- the warp layout -----------------------------------------------------------

def _trajectory_warp_layout(C, etas, nj):
    """The trajectory pass as the kernel lays it out: per instance a
    (nj, 32) register file, slot (j, lane) = policy j * 32 + lane, slots
    past P at -inf with cost 0. A step is the kernel's: the product, the
    subtraction, the in-lane max, the max over lanes of the integer images
    and the subtraction of the max, each a float32 operation."""
    S, J, P = C.shape
    K = etas.shape[0]
    pad = 32 * nj - P
    Cp = torch.cat([C, torch.zeros(S, J, pad)], -1).view(S, J, nj, 32)
    lw = torch.full((S, K, nj * 32), -math.log(P), dtype=torch.float32)
    lw[..., P:] = -math.inf
    lw = lw.view(S, K, nj, 32)
    rows = [lw.reshape(S, K, -1)[..., :P].clone()]
    for i in range(J):
        x = lw - etas[None, :, i, None, None] * Cp[:, None, i]
        in_lane = x.amax(dim=2)                                   # (S, K, 32)
        img = torch.from_numpy(ordered(in_lane.numpy().view(np.int32)))
        top = img.amax(dim=-1, keepdim=True)
        mx = torch.from_numpy(ordered(top.numpy()).view(np.float32))
        lw = x - mx[:, :, None, :]
        rows.append(lw.reshape(S, K, -1)[..., :P].clone())
    return torch.stack(rows, 2)                               # (S, K, J+1, P)


def _hedge_inputs(S, K, J, P, seed):
    """Costs with ties and zeros (the max then lands on several policies
    and on +-0), and a learning-rate schedule per instance."""
    rng = np.random.default_rng(seed)
    C = np.round(rng.random((S, J, P)) * 8) / 8            # many ties
    C[rng.random((S, J, P)) < 0.1] = 0.0
    etas = np.sqrt(8 * np.log(max(P, 2)) / np.arange(1, J + 1))[None] \
        * np.geomspace(0.01, 30, K)[:, None]
    u = rng.random((S, J))
    n_done = np.maximum(np.arange(J) - rng.integers(0, 20, J), 0)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return f32(C), f32(etas), f32(u), torch.tensor(n_done, dtype=torch.int32)


@pytest.mark.parametrize("S, K, J, P", [
    (2, 9, 500, 175),        # Table 6's widths over 500 updates
    (1, 3, 300, 1),
    (1, 3, 300, 31),
    (2, 2, 300, 33),
    (1, 2, 48, 1024),
])
def test_warp_layout_trajectory_is_bit_equal_to_plain(S, K, J, P):
    C, etas, u, n_done = _hedge_inputs(S, K, J, P, seed=P)
    traj = _trajectory_warp_layout(C, etas, math.ceil(P / 32))
    plain = wu.hedge_replay_plain(C, etas, u, n_done)
    assert torch.equal(traj[:, :, -1], plain["logw"])
    for n in sorted({0, 1, 2, 17, J // 2, J - 1}):
        prefix = wu.hedge_replay_plain(C[:, :n], etas[:, :n], u[:, :n],
                                       n_done[:n].clamp_max(n))
        assert torch.equal(traj[:, :, n], prefix["logw"]), n
    # The max does land on ties: some states hold several 0s.
    assert int((traj[:, :, 1:] == 0).sum(-1).max()) > (1 if P > 1 else 0)


def test_warp_layout_final_weights_match_the_reference_oracle():
    """The reference's float64 oracle over the same inputs (one scenario,
    one schedule): the float32 trajectory's final weights within 1e-5."""
    C, etas, u, n_done = _hedge_inputs(1, 1, 400, 175, seed=4)
    traj = _trajectory_warp_layout(C, etas, 6)
    ref = hedge_replay_ref(C[0].double().numpy(), etas[0].double().numpy(),
                           u[0].double().numpy(), n_done.numpy())
    lw = traj[0, 0, -1].double().numpy()
    w = np.exp(lw - lw.max())
    np.testing.assert_allclose(w / w.sum(), ref["weights"], atol=1e-5)


@pytest.mark.parametrize("P, nj", [(300, 12), (33, 3), (700, 24)])
def test_warp_layout_padding_lanes_change_nothing(P, nj):
    """The kernel holds more values per lane than ceil(P / 32) where it has
    no build for that count (12 at P 300): the extra slots sit at -inf
    with a zero cost and never move a state, bit for bit."""
    C, etas, _, _ = _hedge_inputs(1, 2, 120, P, seed=nj)
    tight = _trajectory_warp_layout(C, etas, math.ceil(P / 32))
    assert nj > math.ceil(P / 32)
    assert torch.equal(_trajectory_warp_layout(C, etas, nj), tight)


# -- the plan ------------------------------------------------------------------

def test_table6_hedge_plan():
    """Table 6's Hedge replay (2 scenarios x 9 schedules, 10000 updates, 175
    policies): three blocks of three warps per scenario, six in all."""
    plan = wu.hedge_plan(2, 9, 10000, 175)
    assert plan == wu.HedgePlan(warps=3, groups=3, grid=6)


@pytest.mark.parametrize("K", [1, 2, 5, 9, 17])
def test_hedge_plan_invariants(K):
    for P in list(range(1, 70)) + [175, 255, 256, 257, 768, 769, 1000, 1024]:
        plan = wu.hedge_plan(3, K, 777, P)
        assert 1 <= plan.warps <= 4 and plan.warps * plan.groups >= K
        assert (plan.warps - 1) * plan.groups < K          # no idle block
        assert plan.grid == 3 * plan.groups
        assert plan == wu.hedge_plan(3, K, 777, 1)         # P sizes no block


def test_hedge_plan_rejects_what_the_kernel_does_not_take():
    for args in ((1, 1, 10, 0), (1, 1, 10, 1025), (0, 1, 10, 5),
                 (1, 0, 10, 5), (1, 1, -1, 5)):
        with pytest.raises(ValueError):
            wu.hedge_plan(*args)
