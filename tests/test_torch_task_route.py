"""The planned-start task kernel's search and launch plan, checked on the
CPU. The kernel (``csrc/policy_cost.cu``: ``task_tree_kernel``) runs only
on the card, where ``chip_smoke.py`` holds it bit for bit against
``policy_cost_plain`` at Table 6's inputs and at synthetic horizons. Here:

* a numpy emulation of the kernel's search: A and H at the nodes of the
  first levels of ``lower_bound``'s search tree, stored breadth-first
  (root 0, children 2j+1 and 2j+2), both searches walking those levels,
  then ATen's loop on the interval of the node reached, for the same
  number of steps in every search (H computed per probe); equal to
  ``torch.searchsorted`` over A and over ``h_cum(A)`` on Table 6's
  markets, at edge sizes of the array and where H falls by an ulp;
* the tree's node indices equal to the probe sequence of the chain
  kernel's loop (``test_torch_chain_route._lower_bound``);
* the closed form over the emulated search, bit for bit against
  ``policy_cost_plain`` with shared and per-scenario plans;
* the launch plan (``task_plan``) and the C signatures the wrapper binds.
"""

import functools
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_chain_route as chain_route  # noqa: E402

from repro_torch.core import (  # noqa: E402
    benchmark_bid_policies,
    generate_chain_jobs,
)
from repro_torch.core.simulate import _WORK_EPS  # noqa: E402
from repro_torch.engine import make_scenarios  # noqa: E402
from repro_torch.engine.scenarios import MarketListBatch  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import policy_cost as pc  # noqa: E402

SLOT = 1.0 / 12.0
CU = pathlib.Path(pc.__file__).parent / "csrc" / "policy_cost.cu"
# The levels of the tree the .cu keeps at most (kTreeDepth).
TREE_DEPTH = int(re.search(r"constexpr int kTreeDepth = (\d+);",
                           CU.read_text()).group(1))
TABLE6_TASKS = dict(S=2, T=490000, n_slots=33021)   # PERF.md row 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- the emulation ---------------------------------------------------------------

def _levels(n1: int, depth: int = TREE_DEPTH) -> int:
    """The tree's levels over n1 entries: at most ``depth``, and only
    levels whose every node the loop reaches with a non-empty interval
    (the smallest, always going right, is empty at level l unless
    n1 >= 2^(l+1) - 1): floor(log2(n1 + 1))."""
    return min(depth, (n1 + 1).bit_length() - 1)


@functools.cache
def _tree(n1: int, depth: int = TREE_DEPTH):
    """The kernel's tree over n1 entries, as its build walks each node from
    the root along the bits of j + 1 below the leading one (0 left, 1
    right): the probed index of each node above the leaves, breadth-first,
    and the [lo, hi) interval of each leaf."""
    levels = _levels(n1, depth)
    nodes = (1 << levels) - 1
    mids = np.zeros(nodes, np.int64)
    leaves = np.zeros((nodes + 1, 2), np.int64)
    for j in range(2 * nodes + 1):
        path, lo, hi = j + 1, 0, n1
        for b in range(path.bit_length() - 2, -1, -1):
            mid = lo + ((hi - lo) >> 1)
            lo, hi = (mid + 1, hi) if (path >> b) & 1 else (lo, mid)
        if j < nodes:
            assert lo < hi                  # every node above is reached
            mids[j] = lo + ((hi - lo) >> 1)
        else:
            leaves[j - nodes] = lo, hi
    return levels, mids, leaves


def _probe_h(mid: np.ndarray, a_mid: np.ndarray, slot: float) -> np.ndarray:
    """H at the probed index, as the kernel computes it: the index to
    float32, times the float32 slot, minus A, one float32 rounding each."""
    return mid.astype(np.float32) * np.float32(slot) - a_mid


def _tree_search(a: np.ndarray, v: np.ndarray, *, h: bool, slot: float = SLOT,
                 depth: int = TREE_DEPTH, probes: list | None = None):
    """The kernel's search of float32 targets v (T,) in a (n1,) float32 A
    (over H = k*slot - A if ``h``): the tree's levels from the table of A
    (or H) at its nodes, then, from the leaf's interval, ATen's loop on A
    for the bit length of n1 >> levels steps, a closed search stepping in
    place. Appends each step's (open, probed index) to ``probes``."""
    n1 = a.shape[-1]
    levels, mids, leaves = _tree(n1, depth)
    table = _probe_h(mids, a[mids], slot) if h else a[mids]
    node = np.zeros(v.shape, np.int64)
    for _ in range(levels):
        if probes is not None:
            probes.append((np.ones(v.shape, bool), mids[node]))
        node = 2 * node + np.where(table[node] >= v, 1, 2)
    lo, hi = leaves[node - len(mids)].T
    for _ in range((n1 >> levels).bit_length()):
        open_ = lo < hi
        mid = np.minimum(lo + ((hi - lo) >> 1), n1 - 1)
        x = _probe_h(mid, a[mid], slot) if h else a[mid]
        below = ~(x >= v)
        if probes is not None:
            probes.append((open_, mid))
        lo = np.where(open_ & below, mid + 1, lo)
        hi = np.where(open_ & ~below, mid, hi)
    assert np.all(lo == hi)             # the loop has always ended
    return lo


def _searchsorted(x: np.ndarray, v: np.ndarray) -> np.ndarray:
    return torch.searchsorted(torch.from_numpy(x), torch.from_numpy(v),
                              side="left").numpy()


def _check_both_searches(a: np.ndarray, v: np.ndarray, slot: float = SLOT):
    """The emulated searches over A and over H equal torch.searchsorted
    over A and over h_cum(A), for targets v and for v moved into A's
    range."""
    h = pc.h_cum(torch.from_numpy(a), slot).numpy()
    np.testing.assert_array_equal(_tree_search(a, v, h=True, slot=slot),
                                  _searchsorted(h, v))
    va = (v - v.min() + a[0]).astype(np.float32)
    np.testing.assert_array_equal(_tree_search(a, va, h=False, slot=slot),
                                  _searchsorted(a, va))
    np.testing.assert_array_equal(_tree_search(a, v, h=False, slot=slot),
                                  _searchsorted(a, v))


def _targets(x: np.ndarray, rng, n: int = 3000) -> np.ndarray:
    """Targets at every kind of place: the entries themselves (ties), one
    float32 step either side of them, random ones over the range, and
    beyond both ends."""
    pick = x[rng.integers(0, x.shape[-1], n)]
    return np.concatenate([
        pick, np.nextafter(pick, np.float32(-np.inf)),
        np.nextafter(pick, np.float32(np.inf)),
        rng.uniform(float(x.min()) - 1.0, float(x.max()) + 1.0, n),
        [x.min() - 1.0, x.max() + 1.0, 0.0]]).astype(np.float32)


def _market(n1: int, seed: int) -> np.ndarray:
    """A float32 cumulative availability of n1 entries: slots 0-1 available,
    30 % of them not at all (flat runs, so the searches meet ties)."""
    rng = np.random.default_rng(seed)
    frac = rng.random(n1 - 1) * (rng.random(n1 - 1) < 0.7)
    return np.concatenate([[0.0], np.cumsum(frac / 12)]).astype(np.float32)


# -- the search -------------------------------------------------------------------

@pytest.fixture(scope="module")
def table6_markets():
    """The markets of ``table6.run(10000, ..., seed=0, scenarios=2)``, as
    ``test_torch_chain_route`` builds them."""
    jobs = generate_chain_jobs(10000, 2, seed=0)
    horizon = max(j.deadline for j in jobs) + 1.0
    return MarketListBatch(make_scenarios(horizon, 2, seed=1000), "cpu")


def test_tree_search_matches_searchsorted_on_table6_markets(table6_markets):
    """Every bid of the Even benchmark (the task kernel's grid) on both of
    Table 6's scenarios, at targets on, beside and between the entries and
    at every entry where H falls: the emulated searches return
    torch.searchsorted's index over A and over h_cum."""
    assert table6_markets.n_slots == TABLE6_TASKS["n_slots"]
    rng = np.random.default_rng(11)
    n_falls = 0
    for bid in sorted({p.bid for p in benchmark_bid_policies()}):
        A, _ = table6_markets.stacked(bid)
        for a in A.numpy():
            h = pc.h_cum(torch.from_numpy(a), table6_markets.slot).numpy()
            falls = np.flatnonzero(np.diff(h) < 0)
            n_falls += len(falls)
            v = np.concatenate([_targets(h, rng, 1500), h[falls],
                                h[falls + 1]]).astype(np.float32)
            _check_both_searches(a, v, table6_markets.slot)
    assert n_falls > 0                  # the knife edge is on these markets


@pytest.mark.parametrize("n1", [2, 3, 4, 5, (1 << TREE_DEPTH) - 1,
                                1 << TREE_DEPTH, (1 << TREE_DEPTH) + 1,
                                33022, 70001])
def test_tree_search_at_edge_sizes(n1):
    """Arrays shorter than the tree (fewer levels, the loop ends early or
    at once), at its node count and one entry either side (all levels just
    full, then intervals of one entry and of two), Table 6's 33022 entries
    and 70001."""
    a = _market(n1, seed=n1)
    rng = np.random.default_rng(n1)
    h = pc.h_cum(torch.from_numpy(a), SLOT).numpy()
    _check_both_searches(a, np.concatenate([_targets(a, rng),
                                            _targets(h, rng)]))


def test_tree_search_where_h_falls_by_an_ulp():
    """A fully available market (A grows by one slot per slot), where H =
    k*slot - A is zero but for float32 rounding, so it falls by an ulp all
    over: the emulation, which keeps lower_bound's probes, still returns
    torch.searchsorted's index at every value H takes and beside it."""
    n1 = 33022
    a = np.cumsum(np.full(n1, np.float32(SLOT), np.float32)) - np.float32(SLOT)
    a = a.astype(np.float32)
    h = pc.h_cum(torch.from_numpy(a), SLOT).numpy()
    falls = np.flatnonzero(np.diff(h) < 0)
    assert len(falls) > 100
    vals = np.unique(h)
    v = np.concatenate([vals, np.nextafter(vals, np.float32(-np.inf)),
                        np.nextafter(vals, np.float32(np.inf))])
    _check_both_searches(a, v.astype(np.float32))


class _Recorder:
    """numpy, but recording the indices ``take_along_axis`` probes."""

    def __init__(self):
        self.mids = []

    def __getattr__(self, name):
        return getattr(np, name)

    def take_along_axis(self, x, idx, axis):
        self.mids.append(idx.copy())
        return np.take_along_axis(x, idx, axis)


@pytest.mark.parametrize("n1", [2, 5, (1 << TREE_DEPTH) - 1, 33022])
def test_tree_nodes_are_the_loops_probes(n1, monkeypatch):
    """Walking the tree visits, level by level, the indices the chain
    kernel's loop (``test_torch_chain_route._lower_bound``: ATen's) probes
    for the same targets, and the steps after it probe the rest of that
    loop's sequence."""
    a = _market(n1, seed=3)
    v = _targets(a, np.random.default_rng(4), 500)
    rec = _Recorder()
    monkeypatch.setattr(chain_route, "np", rec)
    want = chain_route._lower_bound(a[None], v[None])[0]
    monkeypatch.undo()
    probes = []
    got = _tree_search(a, v, h=False, probes=probes)
    np.testing.assert_array_equal(got, want)
    steps = [(o, m) for o, m in probes if o.any()]
    assert len(steps) == len(rec.mids)
    for (open_, mid), loop_mid in zip(steps, rec.mids):
        np.testing.assert_array_equal(mid[open_], loop_mid[0][open_])
    levels, mids, leaves = _tree(n1)
    assert len(mids) == (1 << levels) - 1 and len(leaves) == 1 << levels
    assert mids[0] == n1 >> 1 and np.all((0 <= mids) & (mids < n1))
    # The leaves' intervals and the nodes' probes partition [0, n1).
    assert (leaves[:, 1] - leaves[:, 0]).sum() + len(mids) == n1


@pytest.mark.parametrize("n1, levels", [(2, 1), (3, 2), (6, 2), (7, 3),
                                        ((1 << TREE_DEPTH) - 2,
                                         TREE_DEPTH - 1),
                                        ((1 << TREE_DEPTH) - 1, TREE_DEPTH),
                                        (33022, TREE_DEPTH)])
def test_tree_levels(n1, levels):
    """A level is kept only where each of its nodes has a probe: n1 >=
    2^(l+1) - 1 for the l-th."""
    assert _levels(n1) == levels


# -- the closed form over the emulated search ----------------------------------

def _task_inputs(A, C, per_scenario: bool, seed: int, T: int = 2000):
    """T planned-start tasks over the market's horizon and a little past
    it, 40 % without work, d_eff 1-3; (T,) plans or (S, T)."""
    rng = np.random.default_rng(seed)
    S, n1 = A.shape
    start = rng.random(T) * (n1 - 1) * SLOT * 1.1
    end = start + rng.exponential(2.0, T)
    Sp = S if per_scenario else 1
    z = rng.random((Sp, T)) * 3.0 * (rng.random((Sp, T)) < 0.6)
    d = rng.integers(1, 4, (Sp, T)).astype(np.float64)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    if not per_scenario:
        z, d = z[0], d[0]
    return A, C, f32(start), f32(end), f32(z), f32(d)


@pytest.mark.parametrize("per_scenario", [False, True])
@pytest.mark.parametrize("market", ["table6", "short"])
def test_closed_form_over_the_tree_search_is_bit_equal(per_scenario, market,
                                                       table6_markets,
                                                       monkeypatch):
    """policy_cost_plain with both searches replaced by the emulated
    kernel search (H from A, per probe) against policy_cost_plain as it
    is, every output bit for bit: on Table 6's A (33022 entries) and on a
    60-unit market of 720 slots (a tree of 9 levels, a loop of one
    step)."""
    if market == "table6":
        A, C = table6_markets.stacked(0.45)
    else:
        batch = MarketListBatch(make_scenarios(60.0, 2, seed=5), "cpu")
        A, C = batch.stacked(0.3)
    args = _task_inputs(A, C, per_scenario, seed=7)
    want = pc.policy_cost_plain(*args, slot=SLOT, p_od=1.0)

    of_h = {}
    h_cum = pc.h_cum

    def h_cum_noted(A_, slot):
        H = h_cum(A_, slot)
        of_h[id(H)] = A_
        return H

    def kernel_search(seq, values, *, side="left"):
        assert side == "left"
        is_h = id(seq) in of_h
        a = (of_h[id(seq)] if is_h else seq).numpy()
        v = values.numpy()
        out = np.stack([_tree_search(a[s], v[s], h=is_h)
                        for s in range(v.shape[0])])
        return torch.from_numpy(out)

    monkeypatch.setattr(pc, "h_cum", h_cum_noted)
    monkeypatch.setattr(torch, "searchsorted", kernel_search)
    got = pc.policy_cost_plain(*args, slot=SLOT, p_od=1.0)
    monkeypatch.undo()
    assert len(of_h) == 1
    for key in pc.OUT_KEYS + ("finish",):
        assert torch.equal(got[key], want[key]), key
    assert float(want["spot_cost"].sum()) > 0
    assert 0.3 < float((args[4] > _WORK_EPS).float().mean()) < 0.8


# -- the launch plan and the binding -----------------------------------------------

@pytest.mark.parametrize("blocks_per_sm, per_scenario", [(1, 66), (2, 132)])
def test_table6_task_plan_fills_the_card_once(blocks_per_sm, per_scenario):
    """Table 6's task launches (2 scenarios x 490000 tasks): the grid is
    every block the card's 132 SMs hold at once, split over the two
    scenarios; each thread then strides over several tasks."""
    t = TABLE6_TASKS
    blocks = pc.task_plan(t["S"], t["T"], 1024, blocks_per_sm)
    assert blocks == per_scenario
    assert blocks * t["S"] == pc.H100_SMS * blocks_per_sm
    assert blocks * 1024 < t["T"]


@pytest.mark.parametrize("S, T, threads, per_sm, sms, blocks", [
    (2, 1, 1024, 1, 132, 1),          # one task: one block
    (2, 0, 1024, 1, 132, 1),          # no task (the launch returns early)
    (1, 5000, 1024, 1, 132, 5),       # fewer tasks than the grid: trimmed
    (2, 5120, 512, 2, 132, 10),
    (200, 490000, 1024, 1, 132, 1),   # more scenarios than SMs: one each
    (2, 490000, 1024, 1, 8, 4),       # a smaller card
    (3, 10 ** 7, 256, 4, 132, 176),
])
def test_task_plan_edges(S, T, threads, per_sm, sms, blocks):
    assert pc.task_plan(S, T, threads, per_sm, sms) == blocks


def test_task_plan_rejects_bad_arguments():
    for args in ((0, 10, 1024, 1), (2, -1, 1024, 1), (2, 10, 0, 1),
                 (2, 10, 1024, 0)):
        with pytest.raises(ValueError):
            pc.task_plan(*args)


def _c_params(src: str) -> dict:
    """{C entry point: [parameter types]} of the extern "C" functions."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[name] = [" ".join(p.split()[:-1]) for p in params.split(",")]
    return out


def test_c_signatures_match_the_source():
    """Each C entry point the wrapper binds takes the parameters its
    ctypes signature passes, type for type, and the task launch takes no H
    (the kernel computes it per probe)."""
    src = CU.read_text()
    params = _c_params(src)
    assert set(params) == set(pc._SIGNATURES)
    kind = {"const float*": pc._P, "float*": pc._P, "cudaStream_t": pc._P,
            "int*": pc._I, "int": pc._I, "float": pc._F}
    for name, types in params.items():
        want = [kind[t] for t in types]
        got = pc._SIGNATURES[name]
        assert len(got) == len(want), name
        for t, w, g in zip(types, want, got):
            if t == "int*":
                assert g is not pc._I and g._type_ is pc._I, name
            else:
                assert g is w, (name, t)
    assert "const float* H" not in src[src.index(
        'extern "C" int policy_cost_launch('):]


def test_policy_cost_launches_or_raises_off_the_cpu(monkeypatch):
    """Only CPU tensors take the plain version; a tensor on a device with
    no kernel raises before anything runs, and no launch is counted."""
    LAUNCHES.clear()
    monkeypatch.setattr(pc, "policy_cost_plain", None)
    A = torch.zeros((2, 101), device="meta")
    t = torch.zeros((40,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pc.policy_cost(A, A, t, t, t, t)
    with pytest.raises(ValueError, match="inconsistent"):
        pc.policy_cost(A, A[:1], t, t, t, t)
    assert not LAUNCHES
