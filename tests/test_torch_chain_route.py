"""The chain-cost kernel's route rule and the two ideas its shared-memory
kernel rests on, checked on the CPU. The kernels (``csrc/policy_cost.cu``)
run only on the card, where ``chip_smoke.py`` holds both routes bit for
bit against ``policy_cost_chain_plain``. Here:

* ``chain_plan`` at Table 6's shapes, on both sides of the shared-memory
  route's slot limit and at a tiny grid;
* the searched H computed per probe, ``(float)i * slot - A[i]`` in float32
  one operation at a time (numpy), equal bit for bit to ``h_cum`` over the
  A arrays of the markets Table 6 runs on;
* the kernel's ``lower_bound`` loop (ATen's probe sequence) over the
  per-probe H, equal to ``torch.searchsorted`` over ``h_cum`` at the
  entries where Table 6's H falls by an ulp;
* the skip rule (only tasks with work in a live window run the closed
  form; the rest take zero costs and finish = start), emulated with the
  plain version's own closed form and the kernel's search loop, and equal
  bit for bit to ``policy_cost_chain_plain`` on plans full of empty rows,
  elapsed windows and pins.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    benchmark_bid_policies,
    generate_chain_jobs,
    selfowned_policies,
)
from repro_torch.core.simulate import _WORK_EPS  # noqa: E402
from repro_torch.engine import make_scenarios  # noqa: E402
from repro_torch.engine.scenarios import MarketListBatch  # noqa: E402
from repro_torch.kernels import policy_cost as pc  # noqa: E402

SLOT = 1.0 / 12.0
TABLE6 = dict(B=5, S=2, R=130000, L=49, n_slots=33021)   # PERF.md rows 1-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- the route rule ------------------------------------------------------------

@pytest.mark.parametrize("Sp", [1, 2])
def test_table6_chain_takes_the_shared_memory_route(Sp):
    """Table 6's chains (5 bids x 2 scenarios x 130000 rows over 33021
    slots): A fits one block, 13 blocks per (bid, scenario) fill 130 of the
    132 SMs."""
    t = TABLE6
    plan = pc.chain_plan(t["B"], t["S"], Sp, t["R"], t["L"], t["n_slots"])
    assert plan == pc.ChainPlan("smem", 4 * 33022, 13)
    assert plan.a_bytes == 132088 <= pc.SMEM_PER_BLOCK == 232448
    assert plan.blocks_per_pair * t["B"] * t["S"] <= pc.H100_SMS


@pytest.mark.parametrize("n_slots, route", [(58111, "smem"),
                                            (58112, "global"),
                                            (70000, "global")])
def test_slot_limit_splits_the_routes(n_slots, route):
    """The last horizon whose A (n_slots + 1 floats) fits 232448 bytes takes
    the shared-memory kernel; one slot more takes the global-memory kernel,
    which has no blocks per pair to choose."""
    plan = pc.chain_plan(2, 2, 2, 20000, 49, n_slots)
    assert plan.route == route and plan.a_bytes == 4 * (n_slots + 1)
    if route == "smem":
        assert plan.a_bytes <= pc.SMEM_PER_BLOCK
        assert plan == pc.ChainPlan("smem", plan.a_bytes, 33)
    else:
        assert plan.a_bytes > pc.SMEM_PER_BLOCK
        assert plan == pc.ChainPlan("global", plan.a_bytes, 0)


@pytest.mark.parametrize("B, S, R, sms, per_pair", [
    (1, 1, 10, 132, 132),        # a tiny grid (the .cu drops empty blocks)
    (1, 1, 5000, 132, 132),      # fewer rows than the SMs could take
    (70, 2, 130000, 132, 1),     # more pairs than SMs: one block each
    (5, 2, 130000, 8, 1),        # a smaller card
    (1, 2, 1_000_000, 132, 66),
])
def test_blocks_per_pair(B, S, R, sms, per_pair):
    """One block per SM, shared out over the (bid, scenario) pairs, at
    least one each; the rows do not change the choice."""
    plan = pc.chain_plan(B, S, 1, R, 3, 100, sms=sms)
    assert plan == pc.ChainPlan("smem", 404, per_pair)
    assert per_pair * B * S <= max(sms, B * S)


def test_chain_plan_rejects_bad_shapes():
    with pytest.raises(ValueError):
        pc.chain_plan(2, 3, 2, 10, 3, 100)        # Sp neither 1 nor S
    with pytest.raises(ValueError):
        pc.chain_plan(2, 2, 1, 10, 3, 0)          # no slots
    with pytest.raises(ValueError):
        pc.chain_plan(2, 2, 1, -1, 3, 10)         # negative rows


# -- H on the fly ---------------------------------------------------------------

@pytest.fixture(scope="module")
def table6_markets():
    """The markets of ``table6.run(10000, ..., seed=0, scenarios=2)``."""
    jobs = generate_chain_jobs(10000, 2, seed=0)
    horizon = max(j.deadline for j in jobs) + 1.0
    return MarketListBatch(make_scenarios(horizon, 2, seed=1000), "cpu")


def test_h_on_the_fly_is_h_cum_bit_for_bit(table6_markets):
    """Every bid of Table 6's two grids: the per-probe H of the
    shared-memory kernel, float32 product then float32 subtraction, is
    h_cum's H in every bit, over all 33021 + 1 entries."""
    bids = sorted({p.bid for p in selfowned_policies()}
                  | {p.bid for p in benchmark_bid_policies()})
    assert table6_markets.n_slots == 33021 and len(bids) >= 5
    slot = np.float32(table6_markets.slot)
    for bid in bids:
        A, _ = table6_markets.stacked(bid)
        a = A.numpy()
        i = np.arange(a.shape[-1], dtype=np.int32)
        assert np.all(i.astype(np.float32).astype(np.int32) == i)
        prod = i.astype(np.float32) * slot
        assert prod.dtype == np.float32
        h = prod - a
        assert h.dtype == np.float32
        want = pc.h_cum(A, table6_markets.slot).numpy()
        np.testing.assert_array_equal(h.view(np.int32), want.view(np.int32))


# -- the search loop -------------------------------------------------------------

def _lower_bound(x, v):
    """The kernel's ``lower_bound`` on numpy: the first i in [0, n1) with
    !(x[..., i] < v), by ATen's loop (mid = lo + ((hi - lo) >> 1)), so its
    probes are the kernel's; x (..., n1) and v (..., T) share their leading
    dims."""
    n1 = x.shape[-1]
    lo = np.zeros(v.shape, np.int64)
    hi = np.full(v.shape, n1, np.int64)
    while (open_ := lo < hi).any():
        mid = lo + ((hi - lo) >> 1)
        probe = np.take_along_axis(x, np.minimum(mid, n1 - 1), -1)
        below = ~(probe >= v)
        lo = np.where(open_ & below, mid + 1, lo)
        hi = np.where(open_ & ~below, mid, hi)
    return lo


def _h_per_probe(a: np.ndarray, slot: float) -> np.ndarray:
    """H as the shared-memory kernel computes it for each probed index:
    the index to float32, times the float32 slot, minus A."""
    i = np.arange(a.shape[-1], dtype=np.int32).astype(np.float32)
    return i * np.float32(slot) - a


def test_search_loop_matches_searchsorted_where_h_falls(table6_markets):
    """Where H = k * slot - A falls by an ulp, which index a search returns
    depends on its probes. At every such entry of Table 6's markets (and
    one float32 step either side of it) and at random targets, the
    kernel's loop over the per-probe H returns torch.searchsorted's index
    over h_cum; so does its loop over A."""
    rng = np.random.default_rng(6)
    n_falls = 0
    for bid in (0.3, 0.45):
        A, _ = table6_markets.stacked(bid)
        a = A.numpy()
        h = _h_per_probe(a, table6_markets.slot)
        falls = np.argwhere(np.diff(h, axis=-1) < 0)
        n_falls += len(falls)
        targets = []
        for s in range(a.shape[0]):
            at = h[s, falls[falls[:, 0] == s, 1]]
            at = np.concatenate([at, h[s, falls[falls[:, 0] == s, 1] + 1]])
            near = np.concatenate([np.nextafter(at, np.float32(-np.inf)), at,
                                   np.nextafter(at, np.float32(np.inf))])
            rand = rng.uniform(-1.0, float(h[s, -1]) + 1.0, 4000)
            targets.append(np.concatenate([near, rand]).astype(np.float32))
        T = min(len(t) for t in targets)
        v = np.stack([t[:T] for t in targets])
        want = torch.searchsorted(pc.h_cum(A, table6_markets.slot),
                                  torch.from_numpy(v), side="left")
        np.testing.assert_array_equal(_lower_bound(h, v), want.numpy())
        va = v - v.min() + a[:, :1]
        want_a = torch.searchsorted(A, torch.from_numpy(va), side="left")
        np.testing.assert_array_equal(_lower_bound(a, va), want_a.numpy())
    assert n_falls > 0                  # the knife edge is on these markets


# -- the skip rule ---------------------------------------------------------------

def _chain_with_skip(A, C, arrival, ends, z_t, d_eff, pins, slot, p_od):
    """The shared-memory kernel's recurrence: the closed form runs only on
    the tasks with work in a live window, every other task keeps zero
    costs and finishes at its start. H comes from the per-probe formula.
    Also returns how many tasks with work found their window elapsed."""
    B, S, n1 = A.shape
    R, L = ends.shape[-2:]
    z_t, d_eff, pins = (a if a.dim() == 4 else a[:, None]
                        for a in (z_t, d_eff, pins))
    H = torch.from_numpy(_h_per_probe(A.numpy(), slot))
    shape = (B, S, R)
    cur = arrival[:, None, :].expand(shape).clone()
    acc = [torch.zeros(shape) for _ in pc.OUT_KEYS]
    bi, si = torch.meshgrid(torch.arange(B), torch.arange(S), indexing="ij")
    bi, si = bi[..., None].expand(shape), si[..., None].expand(shape)
    n_elapsed = 0
    for k in range(L):
        end = ends[:, None, :, k].expand(shape)
        z_raw = z_t[..., k].expand(shape)
        d_k = d_eff[..., k].clamp_min(0.0).expand(shape)
        pin = (pins[..., k] > 0.5).expand(shape)
        live = end > cur - _WORK_EPS
        start = torch.minimum(cur, end)
        act = live & (z_raw > _WORK_EPS)
        n_elapsed += int((~live & (z_raw > _WORK_EPS)).sum())
        fin = start.clone()
        if act.any():
            b, s = bi[act], si[act]
            *costs, f = pc._closed_form(
                A[b, s], C[b, s], H[b, s], start[act][:, None],
                end[act][:, None], z_raw[act][:, None], d_k[act][:, None],
                slot, p_od)
            for a, c in zip(acc, costs):
                a[act] += c[:, 0]
            fin[act] = f[:, 0]
        fin = torch.where(pin, end, fin)
        cur = torch.where((z_raw > _WORK_EPS) | pin, fin, cur)
    return dict(zip(pc.OUT_KEYS, acc)), n_elapsed


def _searchsorted_by_the_loop(sorted_sequence, values, *, side="left"):
    assert side == "left"
    x = sorted_sequence.numpy()
    v = values.numpy()
    x = np.broadcast_to(x, v.shape[:-1] + x.shape[-1:])
    return torch.from_numpy(_lower_bound(x, v))
def _skip_inputs(per_scenario: bool, seed: int):
    """Two bids x two scenarios over a real 60-unit market; half the rows
    empty, many zero-work windows, windows that end before the chain gets
    there (elapsed), and pins."""
    rng = np.random.default_rng(seed)
    batch = MarketListBatch(make_scenarios(60.0, 2, seed=seed), "cpu")
    AC = [batch.stacked(b) for b in (0.3, 0.45)]
    A = torch.stack([a for a, _ in AC])
    C = torch.stack([c for _, c in AC])
    B, R, L = 2, 96, 7
    Sp = 2 if per_scenario else 1
    arrival = rng.random((B, R)) * 30.0
    widths = rng.exponential(2.0, (B, R, L))
    widths[rng.random((B, R, L)) < 0.25] = 0.0          # zero-length windows
    ends = arrival[..., None] + np.cumsum(widths, -1)
    ends[:, ::5] -= 4.0                                 # elapsed windows
    z = rng.random((B, Sp, R, L)) * 3.0
    z[rng.random(z.shape) < 0.5] = 0.0                  # tasks without work
    z[:, :, R // 2:] = 0.0                              # padded rows
    d = rng.integers(0, 4, z.shape).astype(np.float64)  # d_eff 0 included
    pins = (rng.random(z.shape) < 0.15).astype(np.float64)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    squeeze = (lambda a: a[:, 0]) if not per_scenario else (lambda a: a)
    return (A, C, f32(arrival), f32(ends), f32(squeeze(z)), f32(squeeze(d)),
            f32(squeeze(pins)))


@pytest.mark.parametrize("per_scenario", [False, True])
@pytest.mark.parametrize("seed", [3, 8])
def test_skip_rule_is_bit_equal_to_the_plain_chain(per_scenario, seed,
                                                   monkeypatch):
    """The skip rule, its searches by the kernel's loop, against the plain
    chain (every task through the closed form, torch.searchsorted over
    h_cum) bit for bit."""
    args = _skip_inputs(per_scenario, seed)
    want = pc.policy_cost_chain_plain(*args, slot=SLOT, p_od=1.0)
    monkeypatch.setattr(torch, "searchsorted", _searchsorted_by_the_loop)
    got, n_elapsed = _chain_with_skip(*args, slot=SLOT, p_od=1.0)
    monkeypatch.undo()
    for key in pc.OUT_KEYS:
        assert torch.equal(got[key], want[key]), key
    # The inputs do exercise the rule: some costs, many skipped tasks, some
    # of them with work in an elapsed window.
    assert float(want["spot_cost"].sum()) > 0 and n_elapsed > 0
    z = args[4]
    assert 0.1 < float((z > _WORK_EPS).float().mean()) < 0.4
