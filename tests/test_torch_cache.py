"""The port's cross-call reuse layer (``repro_torch.engine.cache``) against
``repro.engine.cache``, at ``tests/test_cache.py``'s bars or tighter, on the
CPU:

* cold, warm (every group from the cache) and cache-off runs bit for bit,
  on host plans for the reference's four configurations and on device
  plans for its three dedicated ones; an all-hit call builds nothing;
* the 1e-13 bid collision is one entry, eviction under a small bound
  rebuilds the same bits, ``resize`` counts evictions, availability
  queries are never cached and leave no ``delta_state``; no cached entry
  is written by a later call;
* ``evaluate_grid_delta`` bit for bit with the port's full re-evaluation
  on both plan backends (also chained), within 1e-5 of the reference's
  ``evaluate_grid_delta(backend="numpy")`` with its rescored count, its
  edge cases and its validation messages;
* the fingerprints; the view cache (one hit per (chunk, bid) on a second
  call, adaptive chunks and host/device synthesis kept apart, the device
  in both keys); no unbounded ``functools`` cache in the port.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import generate_chain_jobs, selfowned_policies  # noqa: E402
from repro.engine import evaluate_grid as ref_evaluate_grid  # noqa: E402
from repro.engine import evaluate_grid_delta as ref_delta  # noqa: E402
from repro.engine import make_scenarios as ref_make_scenarios  # noqa: E402

import repro_torch.core.scheduler as sched_mod  # noqa: E402
import repro_torch.engine.plan as plan_mod  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.tola import run_tola_scenarios  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ScenarioSpec,
    ScenarioStream,
    SynthBatch,
    evaluate_grid,
    evaluate_grid_delta,
)
from repro_torch.engine import cache  # noqa: E402

TOL = 1e-5
FIELDS = ("unit_cost", "spot_cost", "ondemand_cost", "spot_work",
          "ondemand_work", "selfowned_work", "selfowned_reserved")


@pytest.fixture(autouse=True)
def fresh_caches():
    """Every test counts cache events from zero and leaves the port's
    caches as it found them (other test modules share them)."""
    prev = cache._ENABLED_OVERRIDE
    cache.clear_caches()
    cache.configure(enabled=True, plan_maxsize=1024, view_maxsize=128)
    yield
    cache.clear_caches()
    cache._ENABLED_OVERRIDE = prev
    cache.configure(plan_maxsize=1024, view_maxsize=128)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _ref_setup(n=16, jt=1, seed=3, scenarios=2):
    jobs = generate_chain_jobs(n, job_type=jt, seed=seed)
    horizon = max(j.deadline for j in jobs) + 1.0
    return jobs, ref_make_scenarios(horizon, scenarios, seed=seed + 100)


def _port(jobs, markets, policies):
    """The same jobs, markets and policies as the port's objects."""
    jobs_t = interop.chain_jobs_from_arrays(
        *interop.chain_jobs_to_arrays(jobs))
    markets_t = interop.markets_from_prices(
        np.stack([m.price for m in markets]), markets[0].slot)
    return jobs_t, markets_t, _port_pols(policies)


def _port_pols(policies):
    return interop.policies_from_tuples(
        [(p.beta, p.bid, p.beta0) for p in policies])


def _setup(n=16, jt=1, seed=3, scenarios=2, grid=10):
    jobs, markets = _ref_setup(n, jt, seed, scenarios)
    return _port(jobs, markets, selfowned_policies()[:grid])


def _assert_bitwise(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _perturbed(grid, every=4):
    """The reference's re-bid: every ``every``-th policy's bid moved
    (``benchmarks/bench_pipeline.py``)."""
    out = list(grid)
    idx = list(range(0, len(grid), every))
    for k, i in enumerate(idx):
        out[i] = dataclasses.replace(grid[i],
                                     bid=grid[i].bid * 1.01 + 1e-4 * (k + 1))
    return out, len(idx)


# tests/test_cache.py's configurations: dedicated/shared pool, dealloc/even
# windows, chain and planned-start editions, r = 0 and r > 0.
CONFIGS = {
    "r0": dict(r_total=0),
    "r600": dict(r_total=600),
    "shared-even": dict(r_total=600, windows="even", selfowned="naive",
                        pool="shared"),
    "planned": dict(r_total=600, early_start=False),
}
CASES = [("host", c) for c in CONFIGS] + \
    [("device", c) for c in CONFIGS if CONFIGS[c].get("pool") != "shared"]


@pytest.mark.parametrize("plan_backend,cfg", CASES,
                         ids=[f"{b}-{c}" for b, c in CASES])
def test_cache_on_off_parity_bitwise(plan_backend, cfg):
    """Cold, warm and cache-off runs of one grid are bit for bit the same:
    the cache hands back exactly what a build would produce."""
    kw = dict(CONFIGS[cfg], plan_backend=plan_backend, device="cpu")
    jobs, markets, grid = _setup(
        jt=2 if kw.get("early_start") is False else 1)
    cold = evaluate_grid(jobs, grid, markets, **kw)
    assert cold.timings["plan_cached"] == 0
    warm = evaluate_grid(jobs, grid, markets, **kw)
    assert 0 < warm.timings["plan_cached"] == len(cache.PLAN_CACHE)
    with cache.disabled():
        off = evaluate_grid(jobs, grid, markets, **kw)
    assert off.timings["plan_cached"] == 0
    assert cache.PLAN_CACHE.cache_info().hits == warm.timings["plan_cached"]
    _assert_bitwise(cold, warm)
    _assert_bitwise(cold, off)


@pytest.mark.parametrize("plan_backend", ["host", "device"])
def test_all_hit_call_builds_nothing(plan_backend, monkeypatch):
    """A fully cached grid builds no window plan, allocation or cell: the
    plan-building functions are stubbed to fail on the warm call."""
    jobs, markets, grid = _setup()
    kw = dict(plan_backend=plan_backend, device="cpu")
    cold = evaluate_grid(jobs, grid, markets, 600, **kw)

    def boom(*a, **k):
        raise AssertionError("a plan was built on an all-hit call")

    for name in ("build_plans_batch", "_group_alloc", "_cloud_residuals",
                 "_device_plans", "_device_cells"):
        monkeypatch.setattr(plan_mod, name, boom)
    monkeypatch.setattr(sched_mod, "window_sizes_batch", boom)
    warm = evaluate_grid(jobs, grid, markets, 600, **kw)
    assert warm.timings["plan_cached"] == len(cache.PLAN_CACHE) > 0
    _assert_bitwise(cold, warm)


@pytest.mark.parametrize("plan_backend", ["host", "device"])
def test_partial_hits_build_only_the_misses(plan_backend):
    """A grid whose first window plan's groups were built by an earlier
    call, at other policy columns, builds only the other window plans (not
    a prefix of the grid's) and is bit for bit a cache-off build."""
    jobs, markets, _ = _setup()
    grid = _port_pols(selfowned_policies()[::3])
    kw = dict(plan_backend=plan_backend, device="cpu")
    first = plan_mod._window_key(grid[0], 600, "dealloc")
    early = [p for p in grid
             if plan_mod._window_key(p, 600, "dealloc") == first][::-1]
    s = plan_mod._grid_structure(grid, 600, "dealloc")
    assert len(early) < len(grid) and len(s.key_param) > 2
    evaluate_grid(jobs, early, markets, 600, **kw)
    n_early = len(cache.PLAN_CACHE)
    got = evaluate_grid(jobs, grid, markets, 600, **kw)
    assert got.timings["plan_cached"] == n_early
    assert len(cache.PLAN_CACHE) == len(s.g_bid) > n_early
    with cache.disabled():
        want = evaluate_grid(jobs, grid, markets, 600, **kw)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("plan_backend", ["host", "device"])
def test_bid_collision_cross_call_bitwise(plan_backend):
    """Two bids differing in the 13th decimal hit the SAME entry across
    calls and score bit for bit the same."""
    jobs, markets, grid = _setup(grid=1)
    kw = dict(plan_backend=plan_backend, device="cpu")
    p = grid[0]
    base = evaluate_grid(jobs, [p], markets, 600, **kw)
    h0 = cache.PLAN_CACHE.cache_info().hits
    q = dataclasses.replace(p, bid=p.bid + 1e-13)
    assert q.bid != p.bid
    res = evaluate_grid(jobs, [q], markets, 600, **kw)
    assert cache.PLAN_CACHE.cache_info().hits == h0 + 1
    assert res.timings["plan_cached"] == 1 and len(cache.PLAN_CACHE) == 1
    _assert_bitwise(base, res)


@pytest.mark.parametrize("plan_backend", ["host", "device"])
def test_eviction_under_bound_rebuilds_identical(plan_backend):
    """A plan cache too small for the grid keeps evicting; evicted groups
    rebuild to the same bits."""
    jobs, markets, grid = _setup()
    kw = dict(plan_backend=plan_backend, device="cpu")
    ref = evaluate_grid(jobs, grid, markets, 600, **kw)
    n_groups = len(cache.PLAN_CACHE)
    cache.clear_caches()
    cache.configure(plan_maxsize=max(n_groups // 2, 1))
    a = evaluate_grid(jobs, grid, markets, 600, **kw)
    b = evaluate_grid(jobs, grid, markets, 600, **kw)
    info = cache.PLAN_CACHE.cache_info()
    assert cache.PLAN_CACHE.evictions > 0
    assert info.currsize <= info.maxsize
    _assert_bitwise(ref, a)
    _assert_bitwise(ref, b)


def test_resize_evicts_and_counts():
    lru = cache._LRU(4)
    for i in range(4):
        lru.put(i, i)
    assert lru.get(0) == 0              # 0 becomes the most recent
    lru.resize(2)
    assert len(lru) == 2 and lru.evictions == 2
    assert 0 in lru and 3 in lru and 1 not in lru
    assert lru.cache_info() == (1, 0, 2, 2)
    lru.clear()
    assert lru.cache_info() == (0, 0, 2, 0) and lru.evictions == 0
    off = cache._LRU(0)
    off.put("k", 1)
    assert len(off) == 0


@pytest.mark.parametrize("plan_backend", ["host", "device"])
@pytest.mark.parametrize("per_scenario", [False, True])
def test_availability_queries_not_cached(plan_backend, per_scenario):
    """Availability-query plans (TOLA's pool refinement) never read or
    write the cache, and their results carry no delta_state."""
    jobs, markets, grid = _setup(grid=4)
    kw = dict(plan_backend=plan_backend, device="cpu")
    q = lambda s0, e0: np.maximum(40.0 - s0, 0.0)  # noqa: E731
    avail = [q] * len(markets) if per_scenario else q
    scen = markets if per_scenario else markets[0]
    res = evaluate_grid(jobs, grid, scen, 600, availability=avail, **kw)
    assert res.timings["plan_cached"] == 0
    assert len(cache.PLAN_CACHE) == 0 and res.delta_state is None
    # Warm: a query call still builds everything.
    evaluate_grid(jobs, grid, scen, 600, **kw)
    before = cache.PLAN_CACHE.cache_info()
    again = evaluate_grid(jobs, grid, scen, 600, availability=avail, **kw)
    assert again.timings["plan_cached"] == 0
    assert cache.PLAN_CACHE.cache_info() == before
    _assert_bitwise(res, again)


def _snapshot(lru):
    """Copies of every array and tensor held by a cache's entries."""
    def arrays(v):
        if isinstance(v, (list, tuple)):
            return [a for x in v for a in arrays(x)]
        if dataclasses.is_dataclass(v):
            return [a for f in dataclasses.fields(v)
                    for a in arrays(getattr(v, f.name))]
        if isinstance(v, torch.Tensor):
            return [v.clone()]
        if isinstance(v, np.ndarray):
            return [v.copy()]
        return []
    return {k: arrays(v) for k, v in lru._data.items()}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k], b[k]):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y)
            else:
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("plan_backend", ["host", "device"])
def test_cached_entries_are_never_written(plan_backend):
    """Every consumer of a cached group or view (the backend, the kernel
    wrappers, TOLA's rounds and realized replay) leaves it as built."""
    jobs, markets, grid = _setup(grid=12)
    kw = dict(plan_backend=plan_backend, device="cpu")
    spec = ScenarioSpec("fresh", max(j.deadline for j in jobs) + 1.0, 4,
                        seed=7)
    evaluate_grid(jobs, grid, markets, 600, **kw)
    evaluate_grid(jobs, grid, spec, 600, scenario_chunk=2, **kw)
    plans, views = _snapshot(cache.PLAN_CACHE), _snapshot(cache.VIEW_CACHE)
    assert plans and views
    evaluate_grid(jobs, grid, markets, 600, **kw)
    evaluate_grid(jobs, grid, markets, 600, early_start=False, **kw)
    evaluate_grid(jobs, grid, spec, 600, scenario_chunk=2, **kw)
    run_tola_scenarios(jobs, grid, markets, r_total=600, seed=0,
                       plan_backend=plan_backend, device="cpu")
    assert cache.PLAN_CACHE.cache_info().hits > 0
    _same(plans, {k: v for k, v in _snapshot(cache.PLAN_CACHE).items()
                  if k in plans})
    _same(views, _snapshot(cache.VIEW_CACHE))


# ---------------------------------------------------------------------------
# Delta evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan_backend", ["host", "device"])
def test_delta_matches_full(plan_backend):
    """evaluate_grid_delta re-scores only the changed groups and is bit for
    bit the port's full re-evaluation, also when chained."""
    jobs, markets, grid = _setup(grid=12)
    kw = dict(plan_backend=plan_backend, device="cpu")
    prev = evaluate_grid(jobs, grid, markets, 600, **kw)
    assert prev.delta_state is not None
    assert prev.delta_state["config"]["plan_backend"] == plan_backend
    grid2, n_changed = _perturbed(grid)
    delta = evaluate_grid_delta(prev, jobs, grid2, markets, 600)
    with cache.disabled():
        full = evaluate_grid(jobs, grid2, markets, 600, **kw)
    rescored = delta.timings["delta_groups_rescored"]
    assert 0 < rescored <= n_changed < delta.timings["delta_groups_total"]
    _assert_bitwise(delta, full)
    assert delta.device == "cpu"
    grid3, _ = _perturbed(grid2, every=6)
    again = evaluate_grid_delta(delta, jobs, grid3, markets, 600)
    with cache.disabled():
        full3 = evaluate_grid(jobs, grid3, markets, 600, **kw)
    assert again.timings["delta_groups_rescored"] > 0
    _assert_bitwise(again, full3)


@pytest.mark.parametrize("plan_backend", ["host", "device"])
def test_delta_against_reference(plan_backend):
    """The port's delta within 1e-5 of repro's evaluate_grid_delta on the
    numpy oracle, re-scoring as many groups."""
    jobs, markets = _ref_setup()
    grid = selfowned_policies()[:12]
    grid2, _ = _perturbed(grid)
    jobs_t, markets_t, grid_t = _port(jobs, markets, grid)
    prev = evaluate_grid(jobs_t, grid_t, markets_t, 600,
                         plan_backend=plan_backend, device="cpu")
    got = evaluate_grid_delta(prev, jobs_t, _port_pols(grid2), markets_t, 600)
    ref_prev = ref_evaluate_grid(jobs, grid, markets, 600, backend="numpy")
    want = ref_delta(ref_prev, jobs, grid2, markets, 600, backend="numpy")
    assert got.timings["delta_groups_rescored"] == \
        want.timings["delta_groups_rescored"]
    assert got.timings["delta_groups_total"] == \
        want.timings["delta_groups_total"]
    # The port's float32 cost kernels against the float64 oracle: unit
    # costs at 1e-5, the self-owned stats at tests/test_plan_batch.py's
    # bars (the repo's bars for float32 against float64; raw per-cell
    # costs meet turning-point knife edges, ROADMAP queue C).
    np.testing.assert_allclose(got.unit_cost, want.unit_cost, atol=TOL,
                               rtol=TOL)
    for f in ("selfowned_work", "selfowned_reserved"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=1e-2, rtol=1e-4, err_msg=f)


def test_delta_no_change_rescoring_zero():
    jobs, markets, grid = _setup(grid=6)
    prev = evaluate_grid(jobs, grid, markets, 600, device="cpu")
    same = evaluate_grid_delta(prev, jobs, grid, markets, 600)
    assert same.timings["delta_groups_rescored"] == 0
    assert same.timings["plan_cached"] == 0
    _assert_bitwise(prev, same)


def test_delta_over_a_spec_matches_full():
    """A ScenarioSpec is its own fingerprint: delta evaluation over a
    streamed spec is bit for bit a full chunked re-evaluation."""
    jobs, _, grid = _setup(grid=12)
    spec = ScenarioSpec("regime", max(j.deadline for j in jobs) + 1.0, 4,
                        seed=5)
    prev = evaluate_grid(jobs, grid, spec, 600, scenario_chunk=2,
                         device="cpu")
    assert prev.delta_state["scenario_fp"] == spec
    grid2, _ = _perturbed(grid)
    delta = evaluate_grid_delta(prev, jobs, grid2, spec, 600,
                                scenario_chunk=2)
    with cache.disabled():
        full = evaluate_grid(jobs, grid2, spec, 600, scenario_chunk=2,
                             device="cpu")
    _assert_bitwise(delta, full)


def test_delta_validation_names_the_mismatch():
    jobs, markets, grid = _setup(grid=4)
    prev = evaluate_grid(jobs, grid, markets, 600, device="cpu")
    other_jobs, other_markets, _ = _setup(seed=9)
    with pytest.raises(ValueError, match="jobs"):
        evaluate_grid_delta(prev, other_jobs, grid, markets, 600)
    with pytest.raises(ValueError, match="scenario"):
        evaluate_grid_delta(prev, jobs, grid, other_markets, 600)
    with pytest.raises(ValueError, match="r_total|config"):
        evaluate_grid_delta(prev, jobs, grid, markets, 300)
    with pytest.raises(ValueError, match="pool"):
        evaluate_grid_delta(prev, jobs, grid, markets, 600, pool="shared")
    mean = evaluate_grid(jobs, grid, markets, 600, device="cpu",
                         reduce="mean")
    assert mean.delta_state is None
    with pytest.raises(ValueError, match="delta_state"):
        evaluate_grid_delta(mean, jobs, grid, markets, 600)
    spec = ScenarioSpec("adaptive", max(j.deadline for j in jobs) + 1.0, 4)
    streamed = evaluate_grid(jobs, grid, ScenarioStream(spec), 600,
                             scenario_chunk=2, device="cpu")
    assert streamed.delta_state is None


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------

def test_jobs_fingerprint_invalidates():
    jobs, markets, grid = _setup(grid=4)
    evaluate_grid(jobs, grid, markets, 600, device="cpu")
    h0 = cache.PLAN_CACHE.cache_info()
    jobs2, _, _ = _setup(seed=11)
    res2 = evaluate_grid(jobs2, grid, markets, 600, device="cpu")
    assert res2.timings["plan_cached"] == 0
    assert cache.PLAN_CACHE.cache_info().hits == h0.hits
    fp = cache.jobs_fingerprint(jobs)
    assert fp == cache.jobs_fingerprint(list(jobs))
    assert fp != cache.jobs_fingerprint(jobs2)
    # One deadline moved: only the deadlines carry it into the hash.
    last = jobs[-1]
    moved = jobs[:-1] + [dataclasses.replace(last,
                                             deadline=last.deadline + 1.0)]
    assert fp != cache.jobs_fingerprint(moved)
    task = last.tasks[0]
    bigger = jobs[:-1] + [dataclasses.replace(
        last, tasks=(dataclasses.replace(task, z=task.z * 2),)
        + last.tasks[1:])]
    assert fp != cache.jobs_fingerprint(bigger)


def test_scenario_fingerprint_kinds():
    _, markets, _ = _setup()
    fp = cache.scenario_fingerprint(markets)
    assert fp is not None and fp == cache.scenario_fingerprint(list(markets))
    single = markets[0]
    assert cache.scenario_fingerprint(single) is not None
    assert cache.scenario_fingerprint(single) != fp
    _, other, _ = _setup(seed=9)
    assert cache.scenario_fingerprint(other) != fp
    spec = ScenarioSpec("fresh", 100.0, 4, seed=1)
    assert cache.scenario_fingerprint(spec) == spec
    assert cache.scenario_fingerprint(
        ScenarioSpec("fresh", 100.0, 4, seed=2)) != spec
    assert cache.scenario_fingerprint(ScenarioStream(spec)) is None
    assert cache.scenario_fingerprint([]) is None


# ---------------------------------------------------------------------------
# The view cache and the device in the keys
# ---------------------------------------------------------------------------

def test_view_cache_hits_once_per_chunk_and_bid():
    jobs, _, grid = _setup(grid=12)
    spec = ScenarioSpec("adversarial", max(j.deadline for j in jobs) + 1.0,
                        5, seed=3)
    a = evaluate_grid(jobs, grid, spec, 600, scenario_chunk=2, device="cpu")
    n_bids = len({round(p.bid, 12) for p in grid})
    n_chunks = 3
    assert cache.VIEW_CACHE.cache_info() == (0, n_chunks * n_bids, 128,
                                             n_chunks * n_bids)
    b = evaluate_grid(jobs, grid, spec, 600, scenario_chunk=2, device="cpu")
    info = cache.VIEW_CACHE.cache_info()
    assert info.hits == n_chunks * n_bids
    assert info.misses == n_chunks * n_bids
    _assert_bitwise(a, b)
    with cache.disabled():
        off = evaluate_grid(jobs, grid, spec, 600, scenario_chunk=2,
                            device="cpu")
    assert cache.VIEW_CACHE.cache_info() == info
    _assert_bitwise(a, off)


def test_adaptive_chunks_bypass_the_view_cache():
    jobs, _, grid = _setup(grid=6)
    spec = ScenarioSpec("adaptive", max(j.deadline for j in jobs) + 1.0, 4,
                        seed=3)
    evaluate_grid(jobs, grid, ScenarioStream(spec), 600, scenario_chunk=2,
                  device="cpu")
    assert cache.VIEW_CACHE.cache_info() == (0, 0, 128, 0)
    periods = spec.period_menu()[:2]
    batch = SynthBatch(spec, 0, 2, "cpu", periods=periods)
    assert batch._view_key(grid[0].bid) is None
    batch.stacked(grid[0].bid)
    assert len(cache.VIEW_CACHE) == 0


def test_host_and_device_synthesis_never_share_a_view():
    """host=True views are the float64 oracle's rows uploaded as float32:
    other bits than the device synthesis's, so other entries."""
    spec = ScenarioSpec("fresh", 30.0, 3, seed=2)
    bid = selfowned_policies()[0].bid
    dev_a, _ = SynthBatch(spec, 0, 3, "cpu").stacked(bid)
    host_a, _ = SynthBatch(spec, 0, 3, "cpu", host=True).stacked(bid)
    assert len(cache.VIEW_CACHE) == 2
    assert cache.VIEW_CACHE.cache_info().hits == 0
    again, _ = SynthBatch(spec, 0, 3, "cpu", host=True).stacked(bid)
    assert again is host_a and cache.VIEW_CACHE.cache_info().hits == 1
    dev_b, _ = SynthBatch(spec, 0, 3, "cpu").stacked(bid + 1e-13)
    assert dev_b is dev_a


@pytest.mark.parametrize("plan_backend", ["host", "device"])
def test_device_is_part_of_both_keys(plan_backend, monkeypatch):
    """Device plans and spec views are keyed by the normalized device: a
    call on another device never receives these tensors. Host plans are
    host numpy whatever device evaluates them, so they do."""
    jobs, _, grid = _setup(grid=6)
    spec = ScenarioSpec("fresh", max(j.deadline for j in jobs) + 1.0, 2,
                        seed=4)
    kw = dict(plan_backend=plan_backend, device="cpu")
    evaluate_grid(jobs, grid, spec, 600, **kw)
    assert cache.device_key("cpu") == "cpu"
    assert all(k[3] == "cpu" for k in cache.VIEW_CACHE._data)
    if plan_backend == "device":
        assert all(base[-1] == "cpu" for base, _ in cache.PLAN_CACHE._data)
    else:
        assert all(base[-1] == "host" for base, _ in cache.PLAN_CACHE._data)
    # The same call as if it ran on another card: the views miss, and so
    # do device plans.
    monkeypatch.setattr(cache, "device_key", lambda dev: "cuda:1")
    res = evaluate_grid(jobs, grid, spec, 600, **kw)
    assert cache.VIEW_CACHE.cache_info().hits == 0
    if plan_backend == "device":
        assert res.timings["plan_cached"] == 0
    else:
        assert res.timings["plan_cached"] == len(cache.PLAN_CACHE) > 0


def test_env_switch_turns_both_caches_off(monkeypatch):
    """REPRO_ENGINE_CACHE=0, the reference's switch, turns the port's
    caches off too when nothing overrides it."""
    cache._ENABLED_OVERRIDE = None
    monkeypatch.setenv("REPRO_ENGINE_CACHE", "0")
    assert not cache.enabled()
    jobs, _, grid = _setup(grid=4)
    spec = ScenarioSpec("fresh", max(j.deadline for j in jobs) + 1.0, 2)
    evaluate_grid(jobs, grid, spec, 600, device="cpu")
    evaluate_grid(jobs, grid, spec, 600, device="cpu")
    assert len(cache.PLAN_CACHE) == len(cache.VIEW_CACHE) == 0
    monkeypatch.setenv("REPRO_ENGINE_CACHE", "1")
    assert cache.enabled()
    cache.configure(enabled=False)
    assert not cache.enabled()


# ---------------------------------------------------------------------------
# Bounded factory caches (the reference's rule RPR002)
# ---------------------------------------------------------------------------

def _unbounded_caches(tree: ast.AST) -> list[int]:
    """Lines of ``functools.cache`` (as an attribute or imported from
    functools) and of ``lru_cache`` calls with ``maxsize=None``."""
    alias = {a.asname or a.name: a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.module == "functools"
             for a in node.names}

    def functools_name(fn):
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
                and fn.value.id == "functools":
            return fn.attr
        if isinstance(fn, ast.Name) and isinstance(fn.ctx, ast.Load):
            return alias.get(fn.id)
        return None

    bad = []
    for node in ast.walk(tree):
        if functools_name(node) == "cache":
            bad.append(node.lineno)
        elif isinstance(node, ast.Call) \
                and functools_name(node.func) == "lru_cache":
            size = node.args[0] if node.args else next(
                (k.value for k in node.keywords if k.arg == "maxsize"), None)
            if isinstance(size, ast.Constant) and size.value is None:
                bad.append(node.lineno)
    return sorted(bad)


def test_scan_finds_the_unbounded_forms():
    src = ("import functools\nfrom functools import cache as memo, lru_cache\n"
           "@functools.cache\ndef a(): pass\n"
           "@memo\ndef b(): pass\n"
           "@functools.lru_cache(maxsize=None)\ndef c(): pass\n"
           "@lru_cache(None)\ndef d(): pass\n"
           "@functools.lru_cache(maxsize=8)\ndef e(): pass\n"
           "cache = {}\ndef f(cache=cache): return cache\n")
    assert _unbounded_caches(ast.parse(src)) == [3, 5, 7, 9]


def test_port_has_no_unbounded_cache():
    root = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    found = {}
    for path in sorted(root.rglob("*.py")):
        lines = _unbounded_caches(ast.parse(path.read_text()))
        if lines:
            found[str(path.relative_to(root))] = lines
    assert not found, f"unbounded functools caches: {found}"
