"""The port's observability layer (``repro_torch.obs``) against
``repro.obs`` and ``repro``, on the CPU:

* the tracer and the metrics registry: ``tests/test_obs.py``'s cases, each
  run on both packages as cases of one parametrised test (the export cases
  on a traced grid of each package: ``repro`` on ``backend="numpy"``, the
  port on ``device="cpu"``);
* on one small grid (16 chain jobs of type 2, a fresh ``ScenarioSpec``,
  S = 6, chunks of 2) the port and ``repro(backend="numpy")`` give the same
  span names (the port adds its ``views`` spans, one per bid, and
  ``synth.dispatch``, its synthesis being a torch device path on the CPU),
  the same chunk count, the same plan- and view-cache counts over a cold,
  warm and cache-off sequence, the same ``engine.delta_groups_rescored``
  for one re-bid, the same adaptive-adversary counts on an adaptive stream
  and the learners' weight entropy and top weight within 1e-5;
* the port's timings equal its span totals bit for bit (the totals fold
  left to right in completion order; ``sum()`` is never used: it is
  compensated on Python 3.12), also per chunk of ``evaluate_grid_chunks``
  and through ``replay_stream``;
* the disabled-span overhead at the reference's 2 % bar, no launch recorded
  under ``capture()`` on the CPU, ``CompileWatch`` counting nothing, the
  kernels' work formulas.
"""

import importlib
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.engine as ref_engine  # noqa: E402
import repro.engine.cache as ref_cache  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
from repro.core import generate_chain_jobs, selfowned_policies  # noqa: E402
from repro.learn import replay_stream as ref_replay_stream  # noqa: E402

import repro_torch.engine as port_engine  # noqa: E402
import repro_torch.engine.cache as port_cache  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
from repro_torch.engine.api import evaluate_grid_chunks  # noqa: E402
from repro_torch.kernels import policy_cost as pc  # noqa: E402
from repro_torch.kernels import learner_replay as lk  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels import weight_update as wu  # noqa: E402
from repro_torch.learn import replay_stream  # noqa: E402

# The module (the package attribute of its name is the function).
fa = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = 1e-5
GRID = selfowned_policies()[:6]
S, CHUNK, R = 6, 2, 20
PACKAGES = ["repro", "repro_torch"]
OBS = {"repro": ref_obs, "repro_torch": port_obs}
# The port's span names beyond the reference numpy path's: one "views"
# span per bid in each chunk, and "synth.dispatch" (the port synthesizes
# with torch ops on the evaluation device, the CPU here; the reference
# opens it on its device path only).
PORT_ONLY_SPANS = {"views", "synth.dispatch"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def fresh_caches():
    """Both packages' cross-call caches empty, on and at their default
    bounds before and after each test (other modules share them)."""
    for c in (ref_cache, port_cache):
        c.clear_caches()
        c.configure(enabled=True, plan_maxsize=1024, view_maxsize=128)
    prev = (ref_cache._ENABLED_OVERRIDE, port_cache._ENABLED_OVERRIDE)
    yield
    for c, p in zip((ref_cache, port_cache), prev):
        c.clear_caches()
        c._ENABLED_OVERRIDE = p
        c.configure(plan_maxsize=1024, view_maxsize=128)


def _setup(n=16):
    jobs = generate_chain_jobs(n, 2, seed=0)
    return jobs, max(j.deadline for j in jobs) + 1.0


def _spec(pkg, kind="fresh", n=S, seed=1, **kw):
    mod = ref_engine if pkg == "repro" else port_engine
    _, horizon = _setup()
    return mod.ScenarioSpec(kind, horizon, n, seed=seed, **kw)


def _grid_run(pkg, spec=None, policies=GRID, ref_backend="numpy", **kw):
    """One small grid through each package's ``evaluate_grid``."""
    jobs, _ = _setup()
    spec = _spec(pkg) if spec is None else spec
    if pkg == "repro":
        return ref_engine.evaluate_grid(jobs, policies, spec, R,
                                        backend=ref_backend, **kw)
    return port_engine.evaluate_grid(jobs, policies, spec, R, device="cpu",
                                     **kw)


def _traced_run(pkg, chunk=CHUNK):
    with OBS[pkg].tracing() as tr:
        res = _grid_run(pkg, scenario_chunk=chunk)
    return tr, res


def _fold(xs):
    total = 0.0
    for x in xs:
        total += x
    return total


# --------------------------------------------------------------------------
# Span tracer core (tests/test_obs.py), on both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_span_measures_without_tracer(pkg):
    obs = OBS[pkg]
    assert obs.current_tracer() is None
    with obs.span("work", tag="x") as sp:
        time.sleep(0.001)
    assert sp.seconds > 0.0
    assert sp.attrs == {"tag": "x"}
    assert obs.current_tracer() is None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_span_nesting_and_parents(pkg):
    obs = OBS[pkg]
    with obs.tracing() as tr:
        with obs.span("outer") as outer:
            with obs.span("inner_a"):
                pass
            with obs.span("inner_b"):
                with obs.span("leaf"):
                    pass
    by_name = {r.name: r for r in tr.spans}
    assert by_name["inner_a"].parent == outer.id
    assert by_name["inner_b"].parent == outer.id
    assert by_name["leaf"].parent == by_name["inner_b"].id
    assert by_name["outer"].parent is None
    assert tr.spans[-1].name == "outer"
    assert {r.name for r in tr.children(outer.id)} == {"inner_a", "inner_b"}
    assert [r.name for r in tr.roots()] == ["outer"]
    assert by_name["outer"].seconds >= (
        by_name["inner_a"].seconds + by_name["inner_b"].seconds)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_span_set_attrs_and_totals(pkg):
    obs = OBS[pkg]
    with obs.tracing() as tr:
        with obs.span("phase") as sp:
            sp.set(backend="numpy", n=3)
        with obs.span("phase"):
            pass
    assert tr.named("phase")[0].attrs == {"backend": "numpy", "n": 3}
    assert tr.totals()["phase"] == (tr.spans[0].seconds
                                    + tr.spans[1].seconds)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_nested_tracers_restore(pkg):
    obs = OBS[pkg]
    with obs.tracing() as outer_tr:
        with obs.span("a"):
            pass
        with obs.tracing() as inner_tr:
            with obs.span("b"):
                pass
        assert obs.current_tracer() is outer_tr
        with obs.span("c"):
            pass
    assert [r.name for r in outer_tr.spans] == ["a", "c"]
    assert [r.name for r in inner_tr.spans] == ["b"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_spans_not_recorded_when_disabled(pkg):
    obs = OBS[pkg]
    with obs.span("ghost"):
        pass
    with obs.tracing() as tr:
        pass
    assert len(tr) == 0


# --------------------------------------------------------------------------
# Trace export: Chrome/Perfetto JSON + JSONL, on both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_chrome_trace_schema(pkg, tmp_path):
    tr, _ = _traced_run(pkg)
    path = tmp_path / "trace.json"
    tr.save(path)
    doc = json.load(open(path))
    assert "traceEvents" in doc and doc["traceEvents"]
    for ev in doc["traceEvents"]:
        assert ev["ph"] == "X"
        assert isinstance(ev["name"], str)
        for field in ("ts", "dur"):
            assert isinstance(ev[field], (int, float))
        for field in ("pid", "tid"):
            assert isinstance(ev[field], int)
        assert isinstance(ev["args"], dict)
    names = {ev["name"] for ev in doc["traceEvents"]}
    assert {"evaluate_grid", "plan", "synth", "eval", "chunk"} <= names


@pytest.mark.parametrize("pkg", PACKAGES)
def test_jsonl_export_line_parseable(pkg, tmp_path):
    tr, _ = _traced_run(pkg)
    path = tmp_path / "trace.jsonl"
    tr.save_jsonl(path)
    lines = open(path).read().splitlines()
    assert len(lines) == len(tr)
    for line in lines:
        rec = json.loads(line)
        assert {"id", "parent", "name", "ts", "dur", "pid", "tid",
                "attrs"} <= set(rec)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_attr_coercion_json_safe(pkg):
    obs = OBS[pkg]
    with obs.tracing() as tr:
        with obs.span("np_attrs", f=np.float64(1.5), i=np.int32(2),
                      arr=(np.int64(1), np.int64(2)), obj=object(),
                      t=torch.tensor(2.5), ti=torch.tensor(7),
                      big=torch.ones(3)):
            pass
    doc = tr.to_chrome()
    args = doc["traceEvents"][0]["args"]
    json.dumps(doc)
    assert args["f"] == 1.5 and args["i"] == 2
    assert args["arr"] == [1, 2]
    assert isinstance(args["obj"], str)
    # 0-d torch tensors become Python numbers; others their text.
    assert args["t"] == 2.5 and args["ti"] == 7
    assert isinstance(args["big"], str)


# --------------------------------------------------------------------------
# Metrics registry (tests/test_obs.py), on both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_metrics_disabled_records_nothing(pkg):
    reg = OBS[pkg].MetricsRegistry()
    reg.counter("c").inc()
    reg.gauge("g").set(2.0)
    reg.histogram("h").observe(1.0)
    assert reg.snapshot() == {}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_metrics_counter_gauge_histogram_labels(pkg):
    reg = OBS[pkg].MetricsRegistry()
    with reg.collecting():
        reg.counter("c").inc(stage="a")
        reg.counter("c").inc(2.0, stage="a")
        reg.counter("c").inc(stage="b")
        reg.gauge("g").set(1.5, backend="jax")
        for v in (0.01, 0.02, 5.0):
            reg.histogram("h").observe(v, phase="eval")
    assert not reg.enabled
    snap = reg.snapshot()
    c = {tuple(s["labels"].items()): s["value"] for s in snap["c"]["series"]}
    assert c[(("stage", "a"),)] == 3.0 and c[(("stage", "b"),)] == 1.0
    assert snap["g"]["series"][0]["value"] == 1.5
    h = snap["h"]["series"][0]
    assert h["count"] == 3 and h["min"] == 0.01 and h["max"] == 5.0
    assert h["sum"] == pytest.approx(5.03)
    assert sum(b["count"] for b in h["buckets"]) == 3
    json.dumps(snap)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_metrics_kind_mismatch_raises(pkg):
    reg = OBS[pkg].MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


def test_buckets_and_public_names_are_the_reference_s():
    assert port_obs.metrics._BUCKETS == ref_obs.metrics._BUCKETS
    for name in ("Span", "SpanRecord", "Tracer", "current_tracer", "span",
                 "trace", "tracing_enabled"):
        assert hasattr(port_obs.trace, name), name


# --------------------------------------------------------------------------
# The small grid, port against reference
# --------------------------------------------------------------------------

def test_span_names_and_chunks_match_reference():
    ref_tr, ref_res = _traced_run("repro")
    tr, res = _traced_run("repro_torch")
    ref_names = {r.name for r in ref_tr.spans}
    names = {r.name for r in tr.spans}
    assert names == ref_names | PORT_ONLY_SPANS
    assert len(tr.named("chunk")) == len(ref_tr.named("chunk")) == S // CHUNK
    assert len(res.timings["chunks"]) == len(ref_res.timings["chunks"])
    np.testing.assert_allclose(res.unit_cost, ref_res.unit_cost, atol=TOL,
                               rtol=TOL)
    # The port's tree: evaluate_grid -> {prepare_stream -> {plan, pool},
    # chunk -> {synth, views x bids, eval}}.
    (root,) = tr.roots()
    assert root.name == "evaluate_grid"
    assert root.attrs["scenarios"] == S and root.attrs["backend"] == "cpu"
    n_bids = len({round(p.bid, 12) for p in GRID})
    for c in tr.named("chunk"):
        kids = [r.name for r in tr.children(c.id)]
        assert sorted(kids) == sorted(["synth", "eval"] + ["views"] * n_bids)
        assert kids[-1] == "eval"
    (prep,) = tr.named("prepare_stream")
    assert sorted(r.name for r in tr.children(prep.id)) == ["plan", "pool"]


def _cache_events(pkg, snap):
    out = {}
    for metric in ("engine.plan_cache", "engine.view_cache"):
        for s in snap.get(metric, {}).get("series", []):
            out[(metric, s["labels"]["event"])] = s["value"]
    return out


@pytest.mark.parametrize("bounds", [(1024, 128), (3, 2)],
                         ids=["default", "evicting"])
def test_cache_counters_match_reference(bounds):
    """Cold, warm and cache-off runs: the same plan- and view-cache hit,
    miss and evict counts in both packages (the reference emits the view
    cache's evictions only), equal to the caches' own counts. The
    reference's numpy oracle simulates on the host markets and never
    builds views, so the reference runs its jax backend, whose views go
    through the view cache as the port's do."""
    got = {}
    for pkg, obs, cache in (("repro", ref_obs, ref_cache),
                            ("repro_torch", port_obs, port_cache)):
        cache.configure(plan_maxsize=bounds[0], view_maxsize=bounds[1])
        spec = _spec(pkg)
        steps = []
        for leg in ("cold", "warm", "off"):
            if leg == "off":
                cache.configure(enabled=False)
            with obs.METRICS.collecting(reset=True):
                res = _grid_run(pkg, spec, scenario_chunk=CHUNK,
                                ref_backend="jax")
            steps.append(_cache_events(pkg, res.obs["metrics"]))
        got[pkg] = steps
        info = cache.PLAN_CACHE.cache_info()
        assert sum(s.get(("engine.plan_cache", "hit"), 0) for s in steps) \
            == info.hits
        assert sum(s.get(("engine.plan_cache", "miss"), 0) for s in steps) \
            == info.misses
        for c, metric in ((cache.PLAN_CACHE, "engine.plan_cache"),
                          (cache.VIEW_CACHE, "engine.view_cache")):
            assert sum(s.get((metric, "evict"), 0) for s in steps) \
                == c.evictions
    assert got["repro_torch"] == got["repro"]
    cold, warm, off = got["repro_torch"]
    assert cold[("engine.plan_cache", "miss")] > 0
    assert ("engine.plan_cache", "miss") not in warm or bounds[0] < 1024
    assert off == {}
    if bounds == (3, 2):
        assert cold[("engine.view_cache", "evict")] > 0


def _rebid(grid, every=2):
    import dataclasses
    out = list(grid)
    for k, i in enumerate(range(0, len(grid), every)):
        out[i] = dataclasses.replace(grid[i],
                                     bid=grid[i].bid * 1.01 + 1e-4 * (k + 1))
    return out


def test_delta_groups_rescored_matches_reference():
    grid2 = _rebid(GRID)
    jobs, _ = _setup()
    counts = {}
    for pkg, obs, mod in (("repro", ref_obs, ref_engine),
                          ("repro_torch", port_obs, port_engine)):
        spec = _spec(pkg)
        prev = _grid_run(pkg, spec)
        kw = {"backend": "numpy"} if pkg == "repro" else {}
        with obs.METRICS.collecting(reset=True):
            got = mod.evaluate_grid_delta(prev, jobs, grid2, spec, R, **kw)
        series = got.obs["metrics"]["engine.delta_groups_rescored"]["series"]
        assert [s["labels"] for s in series] == [{}]
        assert series[0]["value"] == got.timings["delta_groups_rescored"]
        counts[pkg] = series[0]["value"]
    assert counts["repro_torch"] == counts["repro"] > 0


def _series(snap, name, label):
    return {s["labels"][label]: s for s in snap[name]["series"]}


def test_adaptive_and_learner_metrics_match_reference():
    jobs, _ = _setup()
    snaps = {}
    for pkg, obs in (("repro", ref_obs), ("repro_torch", port_obs)):
        spec = _spec(pkg, "adaptive", n=12, seed=7, n_periods=2, n_phases=2)
        with obs.METRICS.collecting(reset=True):
            if pkg == "repro":
                out = ref_replay_stream(jobs, GRID, spec, scenario_chunk=4,
                                        learners=("hedge", "exp3"),
                                        backend="numpy",
                                        engine_backend="numpy")
            else:
                out = replay_stream(jobs, GRID, spec, scenario_chunk=4,
                                    learners=("hedge", "exp3"),
                                    backend="numpy", device="cpu")
        snaps[pkg] = out.obs["metrics"]
    ref, got = snaps["repro"], snaps["repro_torch"]
    for name, label in (("scenarios.adaptive_chunks", "stage"),
                        ("scenarios.adaptive_escalations", "to")):
        want = {k: s["value"] for k, s in _series(ref, name, label).items()}
        have = {k: s["value"] for k, s in _series(got, name, label).items()}
        assert have == want, name
    assert sum(s["value"] for s in
               got["scenarios.adaptive_chunks"]["series"]) == 3
    ent_r = _series(ref, "learn.weight_entropy", "learner")
    ent = _series(got, "learn.weight_entropy", "learner")
    assert set(ent) == set(ent_r) == {"0:hedge", "1:exp3"}
    for k in ent:
        assert ent[k]["count"] == ent_r[k]["count"] == 3
        for f in ("sum", "min", "max"):
            assert abs(ent[k][f] - ent_r[k][f]) <= TOL, (k, f)
    top_r = _series(ref, "learn.top_weight", "learner")
    top = _series(got, "learn.top_weight", "learner")
    for k in top:
        assert abs(top[k]["value"] - top_r[k]["value"]) <= TOL, k


def test_engine_metrics_snapshot_on_result():
    with port_obs.METRICS.collecting(reset=True):
        res = _grid_run("repro_torch", scenario_chunk=CHUNK)
    m = res.obs["metrics"]
    by_phase = _series(m, "engine.chunk_seconds", "phase")
    assert set(by_phase) == {"synth", "views", "eval"}
    assert all(s["count"] == S // CHUNK and s["labels"]["backend"] == "cpu"
               for s in by_phase.values())
    assert by_phase["eval"]["sum"] == _fold(
        c["eval"] for c in res.timings["chunks"])
    assert "engine.scenarios_per_sec" in m
    assert _grid_run("repro_torch").obs is None


# --------------------------------------------------------------------------
# Timings as a span-derived view, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [False, True])
def test_timings_match_span_totals_bitforbit(overlap):
    jobs, _ = _setup()
    with port_obs.tracing() as tr:
        res = port_engine.evaluate_grid(jobs, GRID, _spec("repro_torch"), R,
                                        scenario_chunk=CHUNK, device="cpu",
                                        overlap=overlap)
    tot = tr.totals()
    for k in ("plan", "pool", "synth", "views", "eval"):
        assert res.timings[k] == tot[k], k
        assert res.timings[k] == _fold(r.seconds for r in tr.named(k)), k
    chunks = res.timings["chunks"]
    assert len(chunks) == len(tr.named("chunk")) == S // CHUNK
    for entry, c in zip(chunks, tr.named("chunk")):
        kids = tr.children(c.id)
        (ss_,) = [r for r in kids if r.name == "synth"]
        (es,) = [r for r in kids if r.name == "eval"]
        assert entry["synth"] == ss_.seconds and entry["eval"] == es.seconds
        assert entry["views"] == _fold(r.seconds for r in kids
                                       if r.name == "views")
    for k in ("synth", "eval"):
        assert _fold(c[k] for c in chunks) == res.timings[k]


def test_grid_chunks_and_replay_stream_timings_are_spans():
    jobs, _ = _setup()
    with port_obs.tracing() as tr:
        chunks = list(evaluate_grid_chunks(jobs, GRID, _spec("repro_torch"),
                                           R, scenario_chunk=3,
                                           device="cpu"))
    assert len(chunks) == len(tr.named("chunk")) == 2
    for ch, ss_, es in zip(chunks, tr.named("synth"), tr.named("eval")):
        assert ch.timings["synth"] == ss_.seconds
        assert ch.timings["eval"] == es.seconds
    assert [r.name for r in tr.roots()][0] == "prepare_stream"
    with port_obs.tracing() as tr:
        out = replay_stream(jobs, GRID, _spec("repro_torch"), R,
                            scenario_chunk=CHUNK, backend="numpy",
                            device="cpu")
    # replay_stream -> {chunk, fold} per chunk: the generator evaluates a
    # chunk when the fold loop asks for it, outside the previous fold.
    (root,) = [r for r in tr.roots() if r.name == "replay_stream"]
    kids = [r.name for r in tr.children(root.id)]
    assert kids == ["chunk", "fold"] * out.n_chunks
    for f in tr.named("fold"):
        assert [r.name for r in tr.children(f.id)] == ["replay"]
    assert len(tr.named("chunk")) == out.n_chunks == S // CHUNK
    assert out.obs is None


def test_tola_and_table6_timings_are_span_seconds():
    from repro_torch.experiments import table6

    with port_obs.tracing() as tr:
        res = table6.run(12, [0, 60], scenarios=1, learners=["hedge", "ftl"],
                         device="cpu")
    assert res["timings"]["setup"] == tr.named("setup")[0].seconds
    walls = tr.named("wall")
    for r, w in zip((0, 60), walls):
        assert res[r]["timings"]["wall"] == w.seconds
        assert w.attrs["r"] == r
    cr = tr.named("compare_replay")
    assert [res[r]["timings"]["compare_replay"] for r in (0, 60)] == \
        [c.seconds for c in cr]
    # Each TOLA round realizes its sampled policies under a "realize" span.
    assert len(tr.named("realize")) >= 2
    t = res[60]["timings"]["proposed"]
    assert t["realize"] > 0.0 and t["replay"] > 0.0


# --------------------------------------------------------------------------
# Overhead, capture and builds
# --------------------------------------------------------------------------

def test_disabled_overhead_under_two_percent():
    jobs, _ = _setup(8)
    args = (jobs, GRID, _spec("repro_torch", n=8, seed=2))
    kw = dict(scenario_chunk=2, device="cpu")
    port_engine.evaluate_grid(*args, **kw)  # warm caches
    with port_obs.span("wall") as sp:
        port_engine.evaluate_grid(*args, **kw)
    wall = sp.seconds
    with port_obs.tracing() as tr:
        port_engine.evaluate_grid(*args, **kw)
    n_spans = len(tr)
    reps = 20000
    with port_obs.span("reps") as sp:
        for _ in range(reps):
            with port_obs.span("x", a=1, b=2):
                pass
    per_span = sp.seconds / reps
    assert n_spans * per_span < 0.02 * wall, (
        f"{n_spans} spans x {per_span * 1e6:.2f}us = "
        f"{n_spans * per_span * 1e3:.3f}ms vs 2% of {wall * 1e3:.1f}ms")


def test_cpu_run_under_capture_records_no_launch():
    with port_obs.observe(programs=True) as o:
        res = _grid_run("repro_torch", scenario_chunk=CHUNK)
        assert port_obs.compiled.capturing()
        assert port_obs.compiled.current_registry() is o.compiled
    assert not port_obs.compiled.capturing()
    snap = res.obs["compiled"]
    assert snap["kernels"] == {}
    fc = snap["factory_caches"]
    assert set(fc) == {name for name, _, _ in
                       port_obs.compiled._FACTORIES}
    assert fc["engine.plan_cache"]["misses"] > 0
    json.dumps(res.obs)


def test_record_launch_outside_capture_is_a_shared_noop():
    a = port_obs.record_launch("x", None)
    b = port_obs.record_launch(("x", "y"), None, lambda: 1 / 0)
    assert a is b
    with a:
        pass


def test_capture_refuses_a_launch_without_a_stream():
    with port_obs.capture():
        with pytest.raises(ValueError, match="stream"):
            with port_obs.record_launch("x", None):
                pass


def test_registry_record_counts_keys_and_keeps_work_errors():
    class Ev:
        def __init__(self, t):
            self.t = t

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.t - self.t

    reg = port_obs.CompiledRegistry()
    work = {"bytes": 100, "ops": {"f32": torch.tensor(6), "bf16": 4}}
    reg.record(("a", "b"), Ev(1.0), Ev(3.5), work)
    reg.record(("a",), Ev(0.0), Ev(1.0), {"bytes": 1})
    snap = reg.snapshot()["kernels"]
    assert snap["a"]["launches"] == 2 and snap["b"]["launches"] == 1
    assert snap["a"]["device_ms"] == 3.5 and snap["b"]["device_ms"] == 2.5
    assert snap["b"]["ops"] == {"f32": 6.0, "bf16": 4.0}
    assert snap["b"]["bound_ms"] == port_obs.compiled.work_bound(
        {"bytes": 100, "ops": {"f32": 6.0, "bf16": 4.0}})[0]
    assert "error" in snap["a"] and "bound_ms" not in snap["a"]
    assert "a" in reg and reg["b"]["bytes"] == 100.0
    assert "b" in reg.table()


def test_compile_watch_counts_nothing_on_the_cpu():
    watch = port_obs.compiled.CompileWatch()
    assert watch.supported
    with watch:
        _grid_run("repro_torch", scenario_chunk=CHUNK)
    assert watch.compiles == 0
    outer = port_obs.compiled.CompileWatch()
    with outer:
        with port_obs.compiled.CompileWatch() as inner:
            port_obs.compiled.CompileWatch.note_build()
    assert inner.compiles == outer.compiles == 1


# --------------------------------------------------------------------------
# The kernels' work formulas (the bounds chip_smoke.py prints)
# --------------------------------------------------------------------------

def _visible_pairs(Sq, Sk, causal, window, prefix):
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= ((qp - kp) < window) | (kp < prefix)
    return int(ok.sum())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window,prefix", [(0, 0), (1, 0), (16, 0), (16, 4),
                                           (100, 30), (3, 70)])
def test_attn_pairs_counts_the_visible_pairs(causal, window, prefix):
    for Sq, Sk in ((1, 1), (17, 5), (64, 64), (37, 90)):
        assert fa.attn_pairs(Sq, Sk, causal, window, prefix) == \
            _visible_pairs(Sq, Sk, causal, window, prefix)


def test_work_formulas():
    g = torch.Generator().manual_seed(0)
    B, S_, Sp, R_, L, n = 2, 3, 1, 5, 4, 40
    z = torch.rand((B, Sp, R_, L), generator=g) * (torch.rand(
        (B, Sp, R_, L), generator=g) < 0.5)
    pins = (torch.rand((B, Sp, R_, L), generator=g) < 0.2).float()
    w = pc.chain_work(B, S_, Sp, R_, L, n, z, pins)
    active = int(((z > 0) | (pins > 0.5)).sum()) * S_
    assert int(w["ops"]["f32"]) == active * pc.task_ops(n)
    assert w["bytes"] == 4 * (2 * B * S_ * (n + 1) + B * R_ + B * R_ * L
                              + 3 * B * Sp * R_ * L + 4 * B * S_ * R_)
    zt = torch.tensor([[0.0, 1.0, 2.0, 0.0]])
    w = pc.task_work(3, 1, 4, n, zt)
    assert int(w["ops"]["f32"]) == 2 * 3 * pc.task_ops(n)
    assert pc.task_ops(33021) == 2 * 16 + 60
    assert wu.hedge_work(2, 3, 5, 7)["ops"] == {"f32": 12 * 2 * 3 * 5 * 7}
    kinds = ["exp3", "ftl"]
    assert lk.learner_work(kinds, 2, 5, 7)["ops"] == {
        "f32": 2 * 5 * 7 * (14 + 7)}
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    w = fa.flash_work(q, k, k, q, True, 0, 0)
    assert w["ops"] == {"bf16": 4 * 64 * 36 * 4}
    assert w["bytes"] == 2 * (2 * q.numel() + 2 * k.numel())
    x = torch.zeros((1, 256, 4, 16))
    dt = torch.zeros((1, 256, 4))
    Bm = torch.zeros((1, 256, 1, 8))
    st = torch.zeros((1, 4, 16, 8))
    w = ss.ssd_work(x, dt, torch.zeros(4), Bm, Bm, x, st, 128)
    x_ops, other_ops = ss.ssd_ops(1, 256, 4, 16, 1, 8, 128)
    assert w["ops"] == {"tf32": 3 * (x_ops + other_ops)}
    row = ss.ssd_bounds(w["bytes"], x_ops, other_ops, False)["row"]
    got = port_obs.compiled.work_bound(w)
    assert got[1] == row[1] and got[0] == pytest.approx(row[0], rel=1e-12)
