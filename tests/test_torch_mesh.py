"""The port's scenario x policy-group mesh (``repro_torch.engine.mesh``,
DESIGN.md §9) against the reference's unsharded paths, case by case after
``tests/test_shard.py`` and ``tests/test_shard_properties.py``, on the CPU.

The reference's own sharded programs do not trace under this jax (ROADMAP
queue C, "scan-vma"), so the meshed port is held against the UNSHARDED
reference and the unsharded port:

* the mesh object: the padding helpers and the port's splice as hypothesis
  properties (padded lanes never leak), ``create``'s defaults and its
  once-per-shape clamp warning, ``as_scenario_mesh``'s normalisation and
  refusals (a ``DeviceMesh`` on a one-rank gloo group), hashability, the
  NCCL one-card refusal;
* a 1x1 mesh bit for bit against the unsharded port and within 1e-5 of the
  reference's ``backend="jax"`` and ``backend="numpy"``: spec kinds fresh,
  adversarial and adaptive, a market list, the task path, per-scenario
  availability, chunked uneven ``reduce="mean"``;
* the plan cache shared by meshed and unmeshed calls, meshed batches
  bypassing the view cache; ``run_tola_scenarios``, ``sweep_policies`` and
  ``evaluate_grid_delta`` with ``mesh=``;
* the sharded fold within 1e-4 of the host fold, the adaptive round trip,
  and ``collective_counts`` per program key;
* 2x2, 4x1 and 1x4 meshes of gloo rank processes (``tests/torch_mesh_ranks``;
  13 jobs x 7 policies, S = 13, both start modes, a chunked spec, TOLA
  refinement rounds and the fold): every rank's tensors bit for bit the
  unsharded port's and within 1e-5 of the reference's numpy oracle, the
  fold within 1e-4 of the host fold, one all-gather per evaluated chunk,
  one all-reduce per folded chunk, no collective in the eval programs, and
  no ``jax`` or ``repro`` import in a rank.
"""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.engine as ref_engine  # noqa: E402
from repro.core import generate_chain_jobs, selfowned_policies  # noqa: E402
from repro.learn import replay_stream as ref_replay_stream  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro_torch.core import run_tola_scenarios, sweep_policies  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    GridMesh,
    ScenarioMesh,
    ScenarioSpec,
    as_scenario_mesh,
    build_grid_plan,
    cache,
    evaluate_grid,
    evaluate_grid_delta,
    make_scenarios,
)
from repro_torch.engine import backend, mesh as mesh_mod  # noqa: E402
from repro_torch.kernels.policy_cost import OUT_KEYS  # noqa: E402
from repro_torch.learn import replay_stream  # noqa: E402
from repro_torch.obs import compiled  # noqa: E402

TOL = 1e-5            # the reference's cost bar (tests/test_engine.py)
FOLD_TOL = 1e-4       # the reference's fold bar (tests/test_shard.py)
GRID = selfowned_policies()[:12]
EVAL_KEYS = ("engine.eval.chain:sharded", "engine.eval.task:sharded",
             "engine.eval.chain_ps:sharded", "engine.eval.task_ps:sharded")
SPAWN_TIMEOUT = 180.0   # seconds, per spawn of four ranks


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _setup(n=20, jt=2, seed=0):
    jobs = generate_chain_jobs(n, jt, seed=seed)
    return jobs, max(j.deadline for j in jobs) + 1.0


def _one():
    return GridMesh.create(1)


def _same(a, b, fields=("unit_cost", "spot_cost", "ondemand_cost",
                        "spot_work", "ondemand_work")):
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields)


class LayoutMesh(GridMesh):
    """A mesh's partition without ranks: rank r at (r // model, r % model),
    the layout ``GridMesh.create`` builds. For the host-only splice."""

    def coords(self, rank):
        return divmod(rank, self.model_shards)


# --------------------------------------------------------------------------
# Padding helpers and the splice (tests/test_shard_properties.py)
# --------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.integers(0, 200), st.integers(1, 16))
def test_pad_to_properties(k, n):
    kp = mesh_mod.pad_to(k, n)
    assert kp % n == 0
    assert kp >= k
    assert kp - k < n              # minimal padding
    assert mesh_mod.pad_to(kp, n) == kp


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 12), st.integers(0, 10), st.integers(1, 4))
def test_edge_repeat_properties(k, extra, cols):
    a = np.arange(float(k * cols)).reshape(k, cols)
    p = mesh_mod.edge_repeat(a, k + extra)
    assert p.shape == (k + extra, cols)
    assert np.array_equal(p[:k], a)              # real rows untouched
    assert np.array_equal(p[k:], np.repeat(a[-1:], extra, axis=0))
    # the torch twin pads a tensor on its device the same way
    t = mesh_mod.scen_rows(torch.from_numpy(a), k + extra)
    assert torch.equal(t, torch.from_numpy(p))
    with pytest.raises(ValueError):
        mesh_mod.edge_repeat(a, k - 1)
    with pytest.raises(ValueError):
        mesh_mod.scen_rows(torch.from_numpy(a), k - 1)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 23), st.integers(1, 8), st.lists(
    st.integers(1, 11), min_size=1, max_size=3), st.integers(1, 5),
    st.integers(1, 4), st.booleans(), st.data())
def test_padding_splice_never_leaks(S, d, G_bids, m, J, early, data):
    """Every rank's block built as the ranks build it (its slab of the
    edge-repeated scenario rows x its block of the edge-repeated groups),
    scored elementwise, packed and spliced by ``backend.splice``: the
    result is the direct unsharded scoring, so no padded lane leaks."""
    L = 3
    mesh = LayoutMesh(mesh=None, data_shards=d, model_shards=m)
    X = [np.asarray(data.draw(st.lists(
        st.floats(-1e3, 1e3, allow_nan=False, width=32),
        min_size=S * G * J * L, max_size=S * G * J * L)),
        np.float64).reshape(S, G, J, L) for G in G_bids]
    groups_per_bid, col = [], 0
    for G in G_bids:
        groups_per_bid.append([type("G", (), {"policy_idx": np.asarray(
            [col + g])})() for g in range(G)])
        col += G

    def score(x, k):               # the cost kernel stand-in, per lane
        return (k + 2.0) * x + 1.0

    n_loc = [mesh.pad_groups(G) // m for G in G_bids]
    packed = []
    for r in range(mesh.n_shards):
        dr, mr = mesh.coords(r)
        pos = mesh.slab(S, dr)
        parts = []
        for bi, G in enumerate(G_bids):
            gp = [min(g, G - 1) for g in mesh.group_block(G, mr)]
            blk = np.stack([score(X[bi][pos][:, gp], k)
                            for k in range(len(OUT_KEYS))])
            parts.append(blk)                  # (4, Sl, n, J, L)
        if early:
            R_max = max(n_loc) * J
            buf = np.zeros((len(OUT_KEYS), len(G_bids), len(pos), R_max))
            for bi, blk in enumerate(parts):
                buf[:, bi, :, :n_loc[bi] * J] = blk[..., 0].reshape(
                    len(OUT_KEYS), len(pos), -1)
            packed.append(buf.ravel())
        else:
            packed.append(np.concatenate([b.ravel() for b in parts]))
    out = {k: np.full((S, J, col), np.nan) for k in OUT_KEYS}
    backend.splice(np.stack(packed), mesh, S, J, L, groups_per_bid, early,
                   out)
    for ki, key in enumerate(OUT_KEYS):
        c = 0
        for bi, G in enumerate(G_bids):
            direct = score(X[bi], ki)
            direct = direct[..., 0] if early else direct.sum(axis=3)
            assert np.array_equal(out[key][:, :, c:c + G],
                                  direct.transpose(0, 2, 1))
            c += G


# --------------------------------------------------------------------------
# Mesh construction and argument normalisation
# --------------------------------------------------------------------------

def _clear_clamp_dedupe():
    mesh_mod._CLAMP_WARNED.clear()


def test_mesh_create_defaults_and_padding():
    mesh = GridMesh.create()
    assert (mesh.n_shards, mesh.data_shards, mesh.model_shards) == (1, 1, 1)
    assert mesh.dims == ("data",)
    assert mesh.mesh is None                 # a 1x1 mesh needs no group
    assert mesh.pad(7) == 7 and mesh.pad_groups(5) == 5
    assert (mesh.data_rank, mesh.model_rank) == (0, 0)
    assert list(mesh.slab(3)) == [0, 1, 2]
    assert list(mesh.group_block(4)) == [0, 1, 2, 3]
    assert ScenarioMesh is GridMesh
    two = LayoutMesh(mesh=None, data_shards=2, model_shards=2)
    assert two.dims == ("data", "model")
    assert two.pad(13) == 14 and two.pad_groups(5) == 6
    assert list(two.slab(13, 1)) == [7, 8, 9, 10, 11, 12, 12]
    assert list(two.slab_valid(13, 1)) == [True] * 6 + [False]
    assert list(two.group_block(5, 1)) == [3, 4, 5]
    assert two.rank_coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    a = np.arange(13.0)[:, None]
    t = LayoutMesh(mesh=None, data_shards=2).put_rows(a, "cpu")
    assert t.device.type == "cpu"
    assert np.array_equal(two.pad_rows(a)[:, 0], np.r_[np.arange(13.0), 12])


def test_mesh_create_clamps_with_warning():
    _clear_clamp_dedupe()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mesh = ScenarioMesh.create(8)
    assert mesh.n_shards == 1
    msgs = [str(x.message) for x in w]
    assert any("clamping" in s for s in msgs)
    assert any("torch.distributed" in s for s in msgs)
    # the message names both the requested and the available rank counts
    assert any("8" in s and "only 1" in s for s in msgs)
    with pytest.warns(UserWarning, match="clamping"):
        assert GridMesh.create(2, 3).model_shards == 1


def test_mesh_clamp_warning_dedupes_per_process():
    _clear_clamp_dedupe()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ScenarioMesh.create(8)
        ScenarioMesh.create(8)
        ScenarioMesh.create(8)
    assert len([x for x in w if "clamping" in str(x.message)]) == 1
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ScenarioMesh.create(10)
    assert len([x for x in w if "clamping" in str(x.message)]) == 1


def test_as_scenario_mesh_normalization():
    assert as_scenario_mesh(None) is None
    mesh = ScenarioMesh.create(1)
    assert as_scenario_mesh(mesh) is mesh
    assert as_scenario_mesh(1).n_shards == 1
    assert as_scenario_mesh(np.int64(1)).n_shards == 1
    with pytest.raises(ValueError):
        as_scenario_mesh(True)
    with pytest.raises(ValueError):
        as_scenario_mesh(0)
    with pytest.raises(ValueError):
        as_scenario_mesh("data")
    with pytest.raises(ValueError, match="model device"):
        GridMesh.create(1, 0)


def test_mesh_is_hashable_cache_key():
    m1 = ScenarioMesh.create(1)
    m2 = ScenarioMesh.create(1)
    assert hash(m1) == hash(m2)
    assert m1 == m2
    assert len({m1, m2}) == 1


def test_nccl_ranks_sharing_a_card_raise(monkeypatch):
    class FakeDist:
        @staticmethod
        def get_backend():
            return "nccl"

        @staticmethod
        def get_world_size():
            return 4

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        mesh_mod._check_backend(FakeDist)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh_mod._check_backend(FakeDist)          # one card per rank: fine


def test_one_rank_gloo_group(tmp_path):
    """A process group of one gloo rank: ``create`` and a ``DeviceMesh``
    with a "data" dim give a 1x1 mesh whose collectives go through the
    group, bit for bit the unsharded port; a mesh without "data" is
    refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = GridMesh.create()
        assert mesh.mesh is not None and mesh.n_shards == 1
        assert GridMesh.create() is mesh          # one DeviceMesh per shape
        raw = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        assert as_scenario_mesh(raw).n_shards == 1
        with pytest.raises(ValueError, match="data"):
            as_scenario_mesh(init_device_mesh("cpu", (1,),
                                              mesh_dim_names=("model",)))
        jobs, horizon = _setup(n=10)
        spec = ScenarioSpec("fresh", horizon, 3, seed=7)
        compiled.reset_collectives()
        got = evaluate_grid(jobs, GRID, spec, 300, device="cpu", mesh=1)
        ref = evaluate_grid(jobs, GRID, spec, 300, device="cpu")
        assert _same(ref, got)
        assert compiled.collective_counts(
            "engine.gather:sharded")["all-gather"] == 1
        t = torch.arange(4.0)
        with compiled.program("test.collectives"):
            assert torch.equal(mesh_mod.all_gather(mesh, t), t[None])
            assert torch.equal(mesh_mod.all_reduce(mesh, t.clone()), t)
        assert compiled.collective_counts("test.collectives")["total"] == 2
    finally:
        dist.destroy_process_group()
    assert GridMesh.create().mesh is None


def test_collectives_belong_to_a_program():
    with pytest.raises(RuntimeError, match="program"):
        mesh_mod.all_gather(_one(), torch.zeros(2))
    with pytest.raises(ValueError, match="kind"):
        with compiled.program("x"):
            compiled.note_collective("broadcast")


# --------------------------------------------------------------------------
# Guard rails at the API boundary
# --------------------------------------------------------------------------

def _per_scenario_avails(S):
    """Per-scenario availability queries (one per scenario, distinct
    results) shaped like TOLA's realized-residual queries."""
    def make(s):
        return lambda starts, ends: np.full_like(
            np.asarray(starts, np.float64), float(s % 3))
    return [make(s) for s in range(S)]


def test_mesh_shards_per_scenario_availability():
    jobs, horizon = _setup()
    markets = make_scenarios(horizon, 3, seed=1)
    ref_markets = ref_engine.make_scenarios(horizon, 3, seed=1)
    avail = _per_scenario_avails(3)
    oracle = ref_engine.evaluate_grid(jobs, GRID, ref_markets, 300,
                                      backend="numpy",
                                      availability=avail).unit_cost
    ref = evaluate_grid(jobs, GRID, markets, 300, availability=avail,
                        device="cpu")
    compiled.reset_collectives()
    got = evaluate_grid(jobs, GRID, markets, 300, availability=avail,
                        device="cpu", mesh=_one())
    assert _same(ref, got, ("unit_cost", "spot_cost", "selfowned_work"))
    assert np.abs(got.unit_cost - oracle).max() < TOL
    assert compiled.program_runs("engine.eval.chain_ps:sharded") == 1


def test_overlap_rejects_reactive_stream_under_a_mesh():
    jobs, horizon = _setup()
    spec = ScenarioSpec("adaptive", horizon, 8, seed=3)
    with pytest.raises(ValueError, match="reactive|adaptive"):
        evaluate_grid(jobs, GRID, spec, 300, scenario_chunk=4, overlap=True,
                      device="cpu", mesh=_one())


def test_replay_stream_mesh_rejects_numpy_replay():
    jobs, horizon = _setup()
    spec = ScenarioSpec("fresh", horizon, 4, seed=3)
    with pytest.raises(ValueError, match="mesh"):
        replay_stream(jobs, GRID, spec, 300, backend="numpy", device="cpu",
                      mesh=_one())


# --------------------------------------------------------------------------
# 1x1 mesh: bit for bit the unsharded port, within 1e-5 of the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fresh", "adversarial", "adaptive"])
def test_one_rank_mesh_bitwise_spec(kind):
    jobs, horizon = _setup()
    spec = ScenarioSpec(kind, horizon, 5, seed=7)
    ref = evaluate_grid(jobs, GRID, spec, 300, device="cpu")
    got = evaluate_grid(jobs, GRID, spec, 300, device="cpu", mesh=_one())
    assert _same(ref, got)
    ref_spec = ref_engine.ScenarioSpec(kind, horizon, 5, seed=7)
    for be in ("jax", "numpy"):
        want = ref_engine.evaluate_grid(jobs, GRID, ref_spec, 300,
                                        backend=be).unit_cost
        assert np.abs(got.unit_cost - want).max() < TOL, be


def test_one_rank_mesh_bitwise_market_list():
    jobs, horizon = _setup()
    markets = make_scenarios(horizon, 3, seed=1)
    ref = evaluate_grid(jobs, GRID, markets, 300, device="cpu")
    got = evaluate_grid(jobs, GRID, markets, 300, device="cpu", mesh=_one())
    assert _same(ref, got)
    ref_markets = ref_engine.make_scenarios(horizon, 3, seed=1)
    for be in ("jax", "numpy"):
        want = ref_engine.evaluate_grid(jobs, GRID, ref_markets, 300,
                                        backend=be).unit_cost
        assert np.abs(got.unit_cost - want).max() < TOL, be


def test_one_rank_mesh_bitwise_task_path():
    jobs, horizon = _setup()
    spec = ScenarioSpec("fresh", horizon, 4, seed=7)
    ref = evaluate_grid(jobs, GRID, spec, 300, device="cpu",
                        early_start=False)
    got = evaluate_grid(jobs, GRID, spec, 300, device="cpu",
                        early_start=False, mesh=_one())
    assert _same(ref, got)
    ref_spec = ref_engine.ScenarioSpec("fresh", horizon, 4, seed=7)
    for be in ("jax", "numpy"):
        want = ref_engine.evaluate_grid(jobs, GRID, ref_spec, 300,
                                        backend=be,
                                        early_start=False).unit_cost
        assert np.abs(got.unit_cost - want).max() < TOL, be


def test_mesh_chunked_uneven_mean_matches_oracle():
    # S=7 with chunk=3: a final short chunk under reduce="mean".
    jobs, horizon = _setup()
    spec = ScenarioSpec("fresh", horizon, 7, seed=7)
    oracle = ref_engine.evaluate_grid(
        jobs, GRID, ref_engine.ScenarioSpec("fresh", horizon, 7, seed=7),
        300, backend="numpy", reduce="mean").unit_cost
    sharded = evaluate_grid(jobs, GRID, spec, 300, scenario_chunk=3,
                            reduce="mean", device="cpu", mesh=_one())
    assert np.abs(sharded.unit_cost - oracle).max() < TOL
    assert sharded.n_scenarios_total == 7
    full = evaluate_grid(jobs, GRID, spec, 300, scenario_chunk=3,
                         device="cpu", mesh=_one()).unit_cost
    assert full.shape[0] == 7
    mono = evaluate_grid(jobs, GRID, spec, 300, device="cpu").unit_cost
    assert np.array_equal(full, mono)


# --------------------------------------------------------------------------
# Caches under a mesh
# --------------------------------------------------------------------------

@pytest.fixture
def fresh_caches():
    prev = cache._ENABLED_OVERRIDE
    cache.clear_caches()
    cache.configure(enabled=True)
    yield
    cache.clear_caches()
    cache._ENABLED_OVERRIDE = prev


@pytest.mark.parametrize("plan_backend", ["host", "device"])
def test_plan_cache_partition_never_crosses(fresh_caches, plan_backend):
    """Every rank builds the full, unsharded plan and slices its block at
    launch, so a mesh is no part of the cache key: a meshed call is served
    the unmeshed call's groups, and its result is bit for bit a cold
    build's."""
    jobs, horizon = _setup(n=10)
    markets = make_scenarios(horizon, 3, seed=2)
    kw = dict(plan_backend=plan_backend, device="cpu")
    with cache.disabled():
        cold = evaluate_grid(jobs, GRID, markets, 300, **kw)
    assert cold.timings["plan_cached"] == 0
    n_groups = len(build_grid_plan(jobs, GRID, 300, **kw).groups)
    warm = evaluate_grid(jobs, GRID, markets, 300, mesh=_one(), **kw)
    assert warm.timings["plan_cached"] == n_groups
    assert _same(cold, warm)


def test_meshed_batches_bypass_the_view_cache(fresh_caches):
    jobs, horizon = _setup(n=10)
    spec = ScenarioSpec("fresh", horizon, 4, seed=7)
    evaluate_grid(jobs, GRID, spec, 300, scenario_chunk=2, device="cpu",
                  mesh=_one())
    assert cache.VIEW_CACHE.cache_info().currsize == 0
    assert cache.VIEW_CACHE.cache_info().hits == 0
    evaluate_grid(jobs, GRID, spec, 300, scenario_chunk=2, device="cpu")
    assert cache.VIEW_CACHE.cache_info().currsize > 0
    before = cache.VIEW_CACHE.cache_info()
    evaluate_grid(jobs, GRID, spec, 300, scenario_chunk=2, device="cpu",
                  mesh=_one())
    assert cache.VIEW_CACHE.cache_info().hits == before.hits


# --------------------------------------------------------------------------
# The other entry points
# --------------------------------------------------------------------------

def test_run_tola_scenarios_accepts_mesh():
    jobs, horizon = _setup(n=12)
    markets = make_scenarios(horizon, 2, seed=1)
    ref = run_tola_scenarios(jobs, GRID, markets, r_total=300, seed=0,
                             pool_iters=2, device="cpu")
    compiled.reset_collectives()
    got = run_tola_scenarios(jobs, GRID, markets, r_total=300, seed=0,
                             pool_iters=2, device="cpu", mesh=_one())
    for a, b in zip(ref, got):
        assert np.array_equal(a.cost_matrix, b.cost_matrix)
        assert np.array_equal(a.chosen, b.chosen)
    # the mesh rides every round: round 0 and both refinement rounds
    assert compiled.program_runs("engine.eval.chain:sharded") == 1
    assert compiled.program_runs("engine.eval.chain_ps:sharded") == 2


def test_sweep_policies_accepts_mesh():
    jobs, horizon = _setup(n=12)
    spec = ScenarioSpec("fresh", horizon, 4, seed=2)
    _, a_ref, _, r_ref = sweep_policies(jobs, GRID, spec, 300, device="cpu")
    _, a_mesh, _, r_mesh = sweep_policies(jobs, GRID, spec, 300,
                                          device="cpu", mesh=_one())
    assert a_ref == a_mesh
    assert _same(r_ref, r_mesh)


def test_evaluate_grid_delta_accepts_mesh(fresh_caches):
    import dataclasses

    jobs, horizon = _setup(n=12)
    spec = ScenarioSpec("fresh", horizon, 3, seed=2)
    # one policy moved to a self-owned share of its own: one new group
    grid2 = [dataclasses.replace(GRID[0], beta0=0.5)] + GRID[1:]
    prev = evaluate_grid(jobs, GRID, spec, 300, device="cpu")
    full = evaluate_grid(jobs, grid2, spec, 300, device="cpu")
    compiled.reset_collectives()
    got = evaluate_grid_delta(prev, jobs, grid2, spec, 300, mesh=_one())
    assert got.timings["delta_groups_rescored"] == 1
    assert _same(full, got)
    assert compiled.program_runs("engine.gather:sharded") == 1


def test_drivers_take_mesh():
    from repro_torch.experiments import common, table6

    _clear_clamp_dedupe()
    with pytest.warns(UserWarning, match="clamping"):
        setup = common.make_setup(8, 1, scenarios=2, device="cpu", mesh=4)
    assert setup.mesh == _one()
    got = common.sweep_min(setup, GRID[:4])
    want = common.sweep_min(common.make_setup(8, 1, scenarios=2,
                                              device="cpu"), GRID[:4])
    assert got[:2] == want[:2]
    args = ["--jobs", "6", "--r", "0", "--device", "cpu", "--mesh", "1"]
    res = table6.main(args)
    assert np.isfinite(res[0]["alpha_tola"])


# --------------------------------------------------------------------------
# The sharded fold and the collective counts
# --------------------------------------------------------------------------

def test_replay_stream_sharded_fold_matches_host_fold():
    jobs, horizon = _setup()
    spec = ScenarioSpec("fresh", horizon, 7, seed=5)
    learners = ["hedge", "exp3", "egreedy"]
    ref = replay_stream(jobs, GRID, spec, 300, learners=learners, seed=11,
                        scenario_chunk=3, device="cpu")
    compiled.reset_collectives()
    sh = replay_stream(jobs, GRID, spec, 300, learners=learners, seed=11,
                       scenario_chunk=3, device="cpu", mesh=_one())
    assert sh.n_scenarios == ref.n_scenarios == 7
    assert sh.n_chunks == ref.n_chunks == 3
    # device float32 fold vs host float64 fold: the reference's 1e-4
    assert np.abs(ref.regret_per_job() - sh.regret_per_job()).max() \
        < FOLD_TOL
    assert np.abs(ref.realized_unit() - sh.realized_unit()).max() < FOLD_TOL
    assert abs(ref.best_fixed() - sh.best_fixed()) < FOLD_TOL
    m0, lo0, hi0 = ref.confidence_bands()
    m1, lo1, hi1 = sh.confidence_bands()
    assert np.abs(m0 - m1).max() < FOLD_TOL
    assert np.abs(hi0 - hi1).max() < FOLD_TOL
    assert np.abs(ref.weights() - sh.weights()).max() < FOLD_TOL
    for a, b in zip(ref.summary(), sh.summary()):
        assert a["learner"] == b["learner"]
        assert abs(a["top_weight"] - b["top_weight"]) < FOLD_TOL
        assert abs(a["expected_regret"] - b["expected_regret"]) < FOLD_TOL
    # ... and within 1e-4 of the reference's unsharded (host) fold
    want = ref_replay_stream(jobs, GRID,
                             ref_engine.ScenarioSpec("fresh", horizon, 7,
                                                     seed=5),
                             300, learners=learners, seed=11,
                             scenario_chunk=3, backend="jax",
                             engine_backend="jax")
    assert np.abs(want.regret_per_job() - sh.regret_per_job()).max() \
        < FOLD_TOL
    # one all-reduce per chunk, one all-gather per evaluated chunk, none in
    # the eval programs
    fold = compiled.collective_counts("learn.fold:sharded")
    assert fold["all-reduce"] == fold["total"] == 3
    assert compiled.program_runs("learn.fold:sharded") == 3
    gather = compiled.collective_counts("engine.gather:sharded")
    assert gather["all-gather"] == gather["total"] == 3
    for key in EVAL_KEYS:
        assert compiled.collective_counts(key)["total"] == 0
    assert compiled.program_runs("engine.eval.chain:sharded") == 3


def test_replay_stream_sharded_adaptive_round_trip():
    jobs, horizon = _setup()
    spec = ScenarioSpec("adaptive", horizon, 8, seed=5)
    from repro_torch.engine import ScenarioStream

    s_ref, s_sh = ScenarioStream(spec), ScenarioStream(spec)
    ref = replay_stream(jobs, GRID, s_ref, 300, learners=["hedge"], seed=3,
                        scenario_chunk=4, device="cpu")
    sh = replay_stream(jobs, GRID, s_sh, 300, learners=["hedge"], seed=3,
                       scenario_chunk=4, device="cpu", mesh=_one())
    # the adversary consumed the same feedback signal chunk by chunk
    assert np.abs(ref.regret_per_job() - sh.regret_per_job()).max() \
        < FOLD_TOL
    assert s_sh.stage == s_ref.stage
    for a, b in zip(s_ref.chunk_periods + s_ref.chunk_offsets,
                    s_sh.chunk_periods + s_sh.chunk_offsets):
        assert np.array_equal(a, b)


def test_collective_counts_layout():
    compiled.reset_collectives()
    counts = compiled.collective_counts("never.ran")
    assert set(counts) == {"all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all", "collective-permute", "total"}
    assert counts["total"] == 0 and compiled.program_runs("never.ran") == 0
    with compiled.program("k"):
        compiled.note_collective("all-reduce")
        compiled.note_collective("all-gather")
    with compiled.program("k"):
        compiled.note_collective("all-reduce")
    assert compiled.collective_counts("k") == {
        "all-reduce": 2, "all-gather": 1, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0, "total": 3}
    assert compiled.program_runs("k") == 2


# --------------------------------------------------------------------------
# Multi-rank meshes: gloo rank processes, one spawn per mesh shape
# --------------------------------------------------------------------------

SHAPES = [(2, 2), (4, 1), (1, 4)]


@pytest.fixture(scope="module")
def reference_runs():
    """The unsharded port and the reference's numpy oracle on the inputs
    of the multi-rank cases."""
    x = ranks.grid_inputs()
    port = ranks.grid_calls(x)
    horizon = max(j.deadline for j in x["jobs"]) + 1.0
    ref_markets = ref_engine.make_scenarios(horizon, ranks.S_MARKETS, seed=1)
    oracle = {}
    for name, early in (("early", True), ("task", False)):
        oracle[name] = ref_engine.evaluate_grid(
            x["jobs"], x["grid"], ref_markets, 300, backend="numpy",
            early_start=early).unit_cost
    oracle["spec"] = ref_engine.evaluate_grid(
        x["jobs"], x["grid"],
        ref_engine.ScenarioSpec("fresh", horizon, ranks.S_MARKETS, seed=7),
        300, backend="numpy").unit_cost
    return port, oracle


@pytest.fixture(scope="module", params=SHAPES,
                ids=[f"{d}x{m}" for d, m in SHAPES])
def rank_runs(request, tmp_path_factory):
    shape = request.param
    out = tmp_path_factory.mktemp(f"ranks{shape[0]}x{shape[1]}")
    ranks.spawn_ranks(ranks.grid_rank, shape[0] * shape[1],
                      out / "store", args=(shape, str(out)),
                      timeout=SPAWN_TIMEOUT)
    runs = []
    for r in range(shape[0] * shape[1]):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        runs.append((arrays, json.loads((out / f"rank{r}.json").read_text())))
    return shape, runs


def test_ranks_take_their_positions(rank_runs):
    shape, runs = rank_runs
    assert [tuple(meta["coords"]) for _, meta in runs] == [
        divmod(r, shape[1]) for r in range(len(runs))]
    assert all(meta["shards"] == list(shape) for _, meta in runs)


def test_ranks_equal_the_unsharded_port_bit_for_bit(rank_runs,
                                                    reference_runs):
    _, runs = rank_runs
    port, _ = reference_runs
    for r, (arrays, _) in enumerate(runs):
        for k, want in port.items():
            if not k.startswith("fold."):
                assert np.array_equal(arrays[k], want), (r, k)


def test_ranks_match_the_reference_oracle(rank_runs, reference_runs):
    _, runs = rank_runs
    _, oracle = reference_runs
    for arrays, _ in runs:
        for name, want in oracle.items():
            assert np.abs(arrays[f"{name}.unit_cost"] - want).max() < TOL


def test_ranks_fold_matches_the_host_fold(rank_runs, reference_runs):
    _, runs = rank_runs
    port, _ = reference_runs
    for arrays, _ in runs:
        assert np.array_equal(arrays["fold.n"], port["fold.n"])
        for k, want in port.items():
            if k.startswith("fold."):
                assert np.abs(arrays[k] - want).max() < FOLD_TOL, k


def test_ranks_collective_counts(rank_runs):
    _, runs = rank_runs
    for _, meta in runs:
        counts, run = meta["counts"], meta["runs"]
        for key in EVAL_KEYS:
            assert counts[key]["total"] == 0, key
        evaluated = sum(run[k] for k in EVAL_KEYS)
        # early + task + 3 spec chunks + 3 TOLA rounds + 3 fold chunks
        assert evaluated == 11
        assert run["engine.eval.chain_ps:sharded"] == 2
        gather = counts["engine.gather:sharded"]
        assert gather["all-gather"] == gather["total"] == evaluated
        fold = counts["learn.fold:sharded"]
        assert fold["all-reduce"] == fold["total"] == 3
        assert run["learn.fold:sharded"] == 3


def test_ranks_import_no_reference(rank_runs):
    _, runs = rank_runs
    for _, meta in runs:
        assert "repro_torch" in meta["modules"]
        assert not {"jax", "jaxlib", "repro"} & set(meta["modules"])
