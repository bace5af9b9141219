"""The per-rank step analysis (``launch/op_analysis.py``, the counterpart of
the reference's ``launch/hlo_analysis.py``).

Against the reference: on one CPU device, the reference's single-device
smoke programs (``jax.jit(...).lower(...).compile().as_text()`` through its
``analyze``) and the port's ``analyze`` of the same steps count the same
products exactly where both count them (projections, FFN, experts, head):
the reference's FLOPs less its attention and SSD scan (its dense scores and
values for every (query, key) pair, its chunked scan's four products, by
formula from the shapes the port's kernel calls saw) equal the port's less
its kernel calls' work. Prefill (float32) and decode (bfloat16: the
reference's float32 decode refuses its bfloat16 cache, ROADMAP queue C)
of one family of each kind leave nothing over; the train programs of
tinyllama and mamba2 leave what ROADMAP queue C records, exactly.

The mechanics: a meta trace and a CPU trace of a step count the same FLOPs
and kernel calls; a kernel call counts by its work function and nothing
inside it; views are free and an in-place operand counts once; peak live
bytes follow storages; a stand-in mesh's collectives count their operand
bytes and not their staging; ``dryrun.collective_bytes`` is the
analysis's collectives.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.distributed.sharding import ShardingRules as RefRules  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.hlo_analysis import analyze as ref_analyze  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.engine.mesh import (  # noqa: E402
    StandInMesh, all_gather, all_reduce)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.op_analysis import analyze  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.obs.compiled import program  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

# The module (the package attribute of its name is the function).
fa = importlib.import_module("repro_torch.kernels.flash_attention")
B, S = 2, 32
FAMILIES = ("tinyllama_1_1b", "olmoe_1b_7b", "phi_3_vision_4_2b",
            "mamba2_2_7b", "hymba_1_5b", "seamless_m4t_medium")
# (arch, program) -> the reference's FLOPs less its attention and scan by
# formula, minus the port's less its kernel work: ROADMAP queue C.
LEFTOVER = {("tinyllama_1_1b", "train"): -65536,
            ("mamba2_2_7b", "train"): 0}


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.cache
def _ref_params(arch: str):
    return jax.jit(ref_build(ref_smoke_config(arch)).init)(
        jax.random.PRNGKey(0))


def _models(arch: str, dtype: str):
    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    model = build(cfg, "cpu")
    model.load_state_dict(interop.params_from_reference(
        cfg, jax.tree.map(np.asarray, _ref_params(arch))))
    return rcfg, ref_build(rcfg), cfg, model


def _inputs(cfg, train: bool = False):
    """Seeded tokens (and zero frontend embeddings): (reference, port)."""
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.kind == "encdec":
        batch["frames"] = np.zeros((B, S // 4, cfg.d_model), np.float32)
    if cfg.kind == "vlm":
        batch["vision"] = np.zeros((B, cfg.frontend_len, cfg.d_model),
                                   np.float32)
    if train:
        batch["labels"] = tokens
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _ref_kernel_flops(cfg, ana: dict) -> int:
    """The reference's products in the port's kernel calls, by formula from
    the calls' input shapes: attention's dense scores and values for every
    (query, key) pair (its path at these lengths), the chunked scan's C
    B^T, diagonal block, chunk states and entering state, per head, over
    the padded chunks; each backward twice its forward."""
    total = 0
    for name, k in ana["kernels"].items():
        per = 2 if name.endswith("_backward") else 1
        for shapes in k["shapes"]:
            if name.startswith("flash"):
                (b, sq, h, dh), (_, sk, _, _) = shapes[0], shapes[1]
                total += per * 4 * b * h * sq * sk * dh
            else:
                (b, s, h, p), (_, _, _, n) = shapes[0], shapes[3]
                q = cfg.ssm_chunk
                nc = -(-s // q)
                total += per * 2 * b * nc * h * (q * q * n + q * q * p
                                                  + 2 * q * n * p)
    return total


def _leftover(ref_flops, ana, cfg) -> int:
    kernels = sum(k["flops"] for k in ana["kernels"].values())
    return int(ref_flops - _ref_kernel_flops(cfg, ana)) \
        - (ana["flops"] - kernels)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_flops_match_the_reference_analyze(arch):
    rules = RefRules.create(None)
    M = smoke_config(arch).n_meta_tokens or 0
    # prefill in float32
    rcfg, ref, cfg, model = _models(arch, "float32")
    rb, pb = _inputs(cfg)
    params = _ref_params(arch)
    prefill = ref_steps.make_prefill_step(ref, rules, max_len=S + 4 + M)
    got = ref_analyze(jax.jit(prefill).lower(params, rb).compile().as_text())
    ana = analyze(steps.make_prefill_step(model, S + 4 + M), pb)
    assert not got["warnings"]
    assert _leftover(got["flops"], ana, cfg) == 0
    # decode in bfloat16
    rcfg, ref, cfg, model = _models(arch, "bfloat16")
    prefill = ref_steps.make_prefill_step(ref, rules, max_len=S + 4 + M)
    _, cache = jax.jit(prefill)(params, rb)
    decode = ref_steps.make_decode_step(ref, rules)
    got = ref_analyze(jax.jit(decode).lower(
        params, cache, jnp.zeros((B, 1), jnp.int32),
        jnp.int32(S + M)).compile().as_text())
    tok, pc = steps.make_prefill_step(model, S + 4 + M)(pb)
    ana = analyze(steps.make_decode_step(model), pc, tok, S + M)
    assert not ana["kernels"]          # decode attention is plain torch
    assert got["flops"] == ana["flops"] > 0


@pytest.mark.parametrize("arch", sorted({a for a, _ in LEFTOVER}))
def test_train_flops_against_the_reference_analyze(arch):
    rcfg, ref, cfg, model = _models(arch, "float32")
    rb, pb = _inputs(cfg, train=True)
    params = _ref_params(arch)
    opt = RefAdamW(lr=1e-3)
    step = ref_steps.make_train_step(ref, opt, RefRules.create(None), 1)
    got = ref_analyze(jax.jit(step).lower(params, opt.init(params), rb)
                      .compile().as_text())
    popt = AdamW(lr=1e-3)
    ana = analyze(steps.make_train_step(model, popt, 1),
                  popt.init(dict(model.named_parameters())), pb)
    calls = {k: v["calls"] for k, v in ana["kernels"].items()}
    kernel = "flash_attention" if cfg.kind != "ssm" else "ssd_scan"
    # forward and remat's recompute per layer, one backward per layer
    assert calls == {kernel: 2 * cfg.n_layers,
                     f"{kernel}_backward": cfg.n_layers}
    assert _leftover(got["flops"], ana, cfg) == LEFTOVER[(arch, "train")]


# --------------------------------------------------------------------------
# the mechanics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("tinyllama_1_1b", "mamba2_2_7b",
                                  "hymba_1_5b"))
def test_a_meta_trace_counts_what_a_cpu_trace_counts(arch):
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    got = {}
    for dev in ("cpu", "meta"):
        model = build(cfg, dev)
        if dev == "cpu":
            model.init_weights(torch.Generator().manual_seed(0))
        opt = AdamW(lr=1e-3)
        _, pb = _inputs(cfg, train=True)
        pb = {k: v.to(dev) for k, v in pb.items()}
        got[dev] = analyze(steps.make_train_step(model, opt, 2),
                           opt.init(dict(model.named_parameters())), pb)
        assert got[dev]["flops"] > 0 and got[dev]["peak_bytes"] > 0
    assert got["cpu"]["flops"] == got["meta"]["flops"]
    assert got["cpu"]["peak_bytes"] == got["meta"]["peak_bytes"]
    assert {k: v["calls"] for k, v in got["cpu"]["kernels"].items()} \
        == {k: v["calls"] for k, v in got["meta"]["kernels"].items()}


def test_a_kernel_call_counts_by_its_work_function_alone():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 40, 4, 16, generator=g)
    k = torch.randn(2, 40, 2, 16, generator=g)
    kw = dict(causal=True, window=8, prefix=3)
    ana = analyze(ops.flash_attention, q, k, k, **kw)
    work = fa.call_work(q, k, k, True, 8, 3)
    assert ana["flops"] == work["flops"] == 4 * 16 * fa.attn_pairs(
        40, 40, True, 8, 3) * 2 * 4
    assert ana["bytes"] == work["bytes"]
    assert ana["kernels"]["flash_attention"]["calls"] == 1
    assert torch.equal(ana["result"], ops.flash_attention(q, k, k, **kw))
    # on meta the call returns its shapes without running the plain version
    m = analyze(ops.flash_attention, q.to("meta"), k.to("meta"),
                k.to("meta"), **kw)
    assert m["flops"] == ana["flops"] and m["result"].shape == q.shape


def test_views_are_free_and_an_in_place_operand_counts_once():
    x = torch.zeros(8, 16)
    y = torch.ones(8, 16)
    assert analyze(lambda: x.view(16, 8).t()[:, 2])["bytes"] == 0
    assert analyze(lambda: x.add_(y))["bytes"] == 2 * x.numel() * 4
    assert analyze(lambda: x + y)["bytes"] == 3 * x.numel() * 4
    a = torch.ones(4, 8)
    b = torch.ones(8, 3)
    ana = analyze(torch.mm, a, b)
    assert ana["flops"] == 2 * 4 * 8 * 3
    # under inference mode an einsum reaches the mode whole: its products
    with torch.inference_mode():
        assert analyze(torch.einsum, "ik,kj->ij", a, b)["flops"] \
            == ana["flops"]


def test_peak_live_bytes_follow_the_storages_the_step_allocates():
    def step():
        a = torch.ones(1000)            # 4000 B
        b = torch.ones(2000)            # 8000 B: 12000 live
        del a
        c = b * 2                       # 8000 B: 16000 live
        return c[:10]                   # a view keeps c alive

    ana = analyze(step)
    assert ana["peak_bytes"] == 16000
    held = torch.ones(10000)            # alive before: not the step's
    assert analyze(lambda: held + 1)["peak_bytes"] == 40000


def test_stand_in_collectives_count_their_operands_not_their_staging():
    mesh = StandInMesh(("data", "model"), (2, 4), 5)
    assert mesh.position() == {"data": 1, "model": 1}
    assert (mesh.data_rank, mesh.model_rank) == (1, 1)
    t = torch.ones(3, 5)
    with program("test.stand_in"):
        ana = analyze(lambda: (all_reduce(mesh, t, "model"),
                               all_gather(mesh, t, "model"),
                               all_gather(mesh, t)))
    r, g, w = ana["result"]
    assert r is t and g.shape == (4, 3, 5) and w.shape == (8, 3, 5)
    assert torch.equal(g[1], t) and float(g.sum()) == t.numel()
    assert torch.equal(w[5], t) and float(w.sum()) == t.numel()
    assert ana["bytes"] == 0
    assert ana["collectives"] == {
        "all-reduce": 60, "all-gather": 120, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0, "total": 180}
    with program("test.stand_in"):
        assert dryrun.collective_bytes(all_reduce, mesh, t, "model") \
            == dict(ana["collectives"], **{"all-gather": 0, "total": 60})
    assert op_analysis.__all__ == ["analyze"]
