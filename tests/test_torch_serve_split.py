"""The split serve (``launch.steps.ShardedServeStep``, the reference's
meshed ``make_prefill_step``/``make_decode_step``) and the per-rank step
analysis (``launch.op_analysis``) over the meshed steps.

One spawn of four gloo ranks (``tests/torch_train_ranks.py::spawn_serve``):
every family's float32 smoke config, from the reference's init, served
split on a 2x2 mesh and, regrouped, on 1x2 (a prefill and four greedy
decodes of each rank's ``"data"`` rows), each rank's cache kept, its
logits gathered for the check, each step's collective bytes and one split
train step's recorded. Held to:

* the one-device port: tokens equal, each rank's cache within 1e-5 of its
  slice of the one-device cache (its rows, the kv heads its q heads read,
  its SSD heads and conv channels; one bfloat16 ulp for the entries
  stored in bfloat16), the prefill's logits within 1e-5 of their
  largest, each decode step's (which read the bfloat16 cache) within
  1e-4;
* the reference's single-device ``make_prefill_step``/``make_decode_step``
  (``ShardingRules.create(None)``), one family of each kind: tokens equal
  in float32 (the reference's meshed programs do not trace under jax
  0.9.0; ROADMAP queue C);
* a ``"model"`` of 1: the one-device steps bit for bit.

The MoE routes each ``"data"`` rank's rows as its own dispatch groups (the
one-device step routes the whole batch: capacity, and so the drops, depend
on the group's tokens), so on 2x2 its rows are held to the one-device step
on those rows (ROADMAP queue C).

Collective bytes: on 1x2 and 2x2 ``StandInMesh`` positions on meta, each
family's split train, prefill and decode step analysed has per-kind bytes
equal to what the real ranks' helpers recorded, and to a formula from the
layer counts and widths. Per-rank FLOPs: summed over a 1x2 mesh's ranks,
the split prefill's and decode's product FLOPs equal the one-device
step's plus what each rank computes whole or twice (the router, Mamba's
B and C columns, products whose axis does not divide), exactly.
"""

import dataclasses
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_train_ranks as ranks  # noqa: E402
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.distributed.sharding import ShardingRules as RefRules  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import build as ref_build  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.engine.mesh import GridMesh, StandInMesh  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.flash_attention import attn_pairs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.op_analysis import analyze  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

SPAWN_TIMEOUT = 300.0
MESHES = {"2x2": (2, 2), "1x2": (1, 2)}
TOL = 1e-5
# A decode step reads keys and values rounded to bfloat16 in the cache,
# where a split's float32 value on the other side of a rounding edge from
# the one-device value lands one ulp (2^-8) away: its logits are held to
# 1e-4 of their largest (7.4e-5 at most here, qwen2.5's), the prefill's to
# TOL.
DECODE_TOL = 1e-4
# One family of each kind, held to the reference's steps.
REF_ARCHS = ("tinyllama_1_1b", "olmoe_1b_7b", "phi_3_vision_4_2b",
             "mamba2_2_7b", "hymba_1_5b", "seamless_m4t_medium")
ARCHS = ranks.SERVE_ARCHS
# The cache entries stored in bfloat16 (``tests/test_torch_serve_families``'
# one-ulp bar for values rounded there); the others are float32.
BF16_CACHE = ("k", "v", "cross_k", "cross_v", "conv")


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.cache
def _ref_params(arch: str):
    return jax.tree.map(np.asarray, jax.jit(ref_build(
        ref_smoke_config(arch)).init)(jax.random.PRNGKey(0)))


@functools.cache
def _whole(arch: str) -> dict:
    """The reference's init as the port's state dict (numpy)."""
    return {k: v.numpy() for k, v in interop.params_from_reference(
        ranks.arch_config(arch), _ref_params(arch)).items()}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The one spawn: (out dir, each rank's record)."""
    out = tmp_path_factory.mktemp("serve")
    for arch in ARCHS:
        np.savez(out / f"serve_init_{arch}.npz", **_whole(arch))
    ranks.spawn_serve(out, SPAWN_TIMEOUT)
    return out, [json.loads((out / f"serve{r}.json").read_text())
                 for r in range(4)]


def _ranks(metas, tag, arch):
    """(rank, its record of ``arch`` on ``tag``'s mesh, its (data, model)
    position)."""
    return [(r, m[tag][arch], m["coords"][tag])
            for r, m in enumerate(metas) if tag in m]


def _model(arch: str):
    model = build(ranks.arch_config(arch), "cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _whole(arch).items()})
    return model


def _batch(cfg, rows) -> dict:
    return {k: torch.from_numpy(v[rows])
            for k, v in ranks.serve_inputs(cfg).items()}


@functools.cache
def _one_device(arch: str, lo: int, hi: int):
    """The one-device steps on rows lo:hi: (tokens, cache, logits of each
    step teacher-forced on those tokens)."""
    model = _model(arch)
    cfg = model.cfg
    batch = _batch(cfg, slice(lo, hi))
    pos0 = ranks.SERVE_S + (cfg.n_meta_tokens or 0)
    tok, cache = steps.make_prefill_step(model, ranks.serve_max_len(cfg))(
        batch)
    toks = [tok]
    decode = steps.make_decode_step(model)
    for t in range(ranks.SERVE_NEW - 1):
        tok, cache = decode(cache, tok, pos0 + t)
        toks.append(tok)
    tokens = torch.cat(toks, 1)
    lg, c2 = model.prefill(batch, max_len=ranks.serve_max_len(cfg))
    logits = [lg[:, -1]]
    for t in range(ranks.SERVE_NEW - 1):
        lg, c2 = model.decode(c2, tokens[:, t:t + 1], pos0 + t)
        logits.append(lg[:, -1])
    return tokens.numpy(), {k: v.float().numpy() for k, v in cache.items()}, \
        torch.stack(logits, 1).numpy()


def _rows(cfg, d: int, data: int):
    """The one-device witness's rows for ``"data"`` rank ``d``: its own
    for the MoE across ``"data"`` ranks (data-local dispatch groups), all
    rows otherwise (then cut to the rank's)."""
    per = ranks.SERVE_B // data
    if cfg.kind == "moe" and data > 1:
        return (d * per, (d + 1) * per), slice(0, per)
    return (0, ranks.SERVE_B), slice(d * per, (d + 1) * per)


def _plan(cfg, d: int, m: int, rank: int):
    return steps.ShardedServeStep(build(cfg, "meta"), StandInMesh(
        ("data", "model"), (d, m), rank)).plan


def _cache_slice(cfg, key: str, t: np.ndarray, plan) -> np.ndarray:
    """A rank's part of the one-device cache entry ``t`` (rows already
    cut): the kv heads its q heads read, its SSD heads, its conv
    channels (its x channels, then the whole B and C)."""
    sp = plan.splits
    enc = cfg.kind == "encdec"
    if key in ("k", "v", "cross_k", "cross_v"):
        name = ("dec_layers.0." if enc else "layers.0.") + (
            "cross" if key.startswith("cross") else "attn")
        s = sp.get(name)
        if s is None:
            return t
        g = cfg.n_heads // cfg.n_kv_heads
        return t[..., s.lo // g:(s.hi - 1) // g + 1, :]
    mixer = sp.get("layers.0.ssm" if cfg.kind == "hybrid" else "layers.0")
    if mixer is None or key not in ("ssd", "conv"):
        return t
    if key == "ssd":
        return t[:, :, mixer.lo:mixer.hi]
    P, di, N = cfg.ssm_head_dim, cfg.d_inner_ssm, cfg.d_state
    return np.concatenate([t[..., mixer.lo * P:mixer.hi * P],
                           t[..., di:di + 2 * N]], axis=-1)


# --------------------------------------------------------------------------
# the split serve against the one-device port and the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_split_serve_matches_the_one_device_port(served, arch, tag):
    out, metas = served
    cfg = ranks.arch_config(arch)
    d_n, m_n = MESHES[tag]
    got_ranks = _ranks(metas, tag, arch)
    assert len(got_ranks) == d_n * m_n
    for r, rec, (d, mr) in got_ranks:
        (lo, hi), cut = _rows(cfg, d, d_n)
        tokens, cache, logits = _one_device(arch, lo, hi)
        np.testing.assert_array_equal(np.array(rec["tokens"]), tokens[cut])
        got = np.load(out / f"{tag}_serve_{arch}_logits{r}.npy")
        want = logits[cut]
        assert got.shape == want.shape
        dev = np.abs(got - want).max(axis=(0, 2)) / np.abs(want).max()
        assert dev[0] <= TOL and (dev[1:] <= DECODE_TOL).all(), dev
        plan = _plan(cfg, d_n, m_n, r)
        with np.load(out / f"{tag}_serve_{arch}_cache{r}.npz") as z:
            assert set(z.files) == set(cache)
            for k in z.files:
                want = cache[k] if k == "slot_pos" else cache[k][:, cut]
                want = _cache_slice(cfg, k, want, plan)
                assert z[k].shape == want.shape, k
                # keys and values are stored in bfloat16: one ulp there
                np.testing.assert_allclose(
                    z[k], want, atol=TOL, err_msg=k,
                    rtol=2.0 ** -7 if k in BF16_CACHE else TOL)
        # the rank holds its slices, less than the whole model
        whole = 4 * sum(v.size for v in _whole(arch).values())
        assert rec["param_bytes"] < whole
    # every rank of one "data" row served the same tokens; a rank imports
    # nothing of the reference
    assert all("repro_torch" in m["modules"] and not {
        "jax", "jaxlib", "repro"} & set(m["modules"]) for m in metas)
    by_row = {}
    for _, rec, (d, _) in got_ranks:
        by_row.setdefault(d, []).append(rec["tokens"])
    assert all(all(t == ts[0] for t in ts) for ts in by_row.values())


@functools.cache
def _ref_steps(arch: str):
    """The reference's jitted single-device prefill and decode steps."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    model = ref_build(rcfg)
    rules = RefRules.create(None)
    return (jax.jit(ref_steps.make_prefill_step(
        model, rules, max_len=ranks.serve_max_len(ranks.arch_config(arch)))),
        jax.jit(ref_steps.make_decode_step(model, rules)))


@functools.cache
def _ref_tokens(arch: str, lo: int, hi: int) -> np.ndarray:
    """The reference's single-device greedy steps on rows lo:hi, float32:
    ``make_prefill_step`` then ``make_decode_step``; a decoder's float32
    decode refuses its bfloat16 cache (ROADMAP queue C), so each decode
    reads the cache cast to float32 and its new entries are rounded back
    to bfloat16, as the port's cache stores them."""
    cfg = ranks.arch_config(arch)
    params = _ref_params(arch)
    batch = {k: jnp.asarray(v[lo:hi])
             for k, v in ranks.serve_inputs(cfg).items()}
    prefill, decode = _ref_steps(arch)
    tok, cache = prefill(params, batch)
    dtypes = jax.tree.map(lambda a: a.dtype, cache)
    toks = [np.asarray(tok)]
    pos0 = ranks.SERVE_S + (cfg.n_meta_tokens or 0)
    for t in range(ranks.SERVE_NEW - 1):
        f32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                           if a.dtype == jnp.bfloat16 else a, cache)
        tok, cache = decode(params, f32, tok, jnp.int32(pos0 + t))
        cache = jax.tree.map(lambda a, dt: a.astype(dt), cache, dtypes)
        toks.append(np.asarray(tok))
    return np.concatenate(toks, 1)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_split_serve_tokens_equal_the_reference(served, arch):
    _, metas = served
    cfg = ranks.arch_config(arch)
    for tag, (d_n, _) in MESHES.items():
        for _, rec, (d, _) in _ranks(metas, tag, arch):
            (lo, hi), cut = _rows(cfg, d, d_n)
            np.testing.assert_array_equal(np.array(rec["tokens"]),
                                          _ref_tokens(arch, lo, hi)[cut])


@pytest.mark.parametrize("arch", ("tinyllama_1_1b", "olmoe_1b_7b",
                                  "mamba2_2_7b", "hymba_1_5b",
                                  "seamless_m4t_medium"))
def test_a_model_of_one_is_the_one_device_step_bit_for_bit(arch):
    cfg = ranks.arch_config(arch)
    batch = _batch(cfg, slice(0, ranks.SERVE_B))
    pos0 = ranks.SERVE_S + (cfg.n_meta_tokens or 0)
    want = _one_device(arch, 0, ranks.SERVE_B)
    for mesh in (GridMesh.create(), StandInMesh(("data", "model"), (1, 1)),
                 StandInMesh(("data", "model"), (2, 1))):
        step = steps.ShardedServeStep(build(cfg, "meta"), mesh,
                                      ranks.serve_max_len(cfg))
        assert step.plan.splits == {}
        step.load({k: torch.from_numpy(v) for k, v in _whole(arch).items()},
                  "cpu")
        tok, cache = step.prefill(batch)
        toks = [tok]
        for t in range(ranks.SERVE_NEW - 1):
            tok, cache = step.decode(cache, tok, pos0 + t)
            toks.append(tok)
        assert np.array_equal(torch.cat(toks, 1).numpy(), want[0])
        for k, v in cache.items():
            assert np.array_equal(v.float().numpy(), want[1][k]), k


def test_greedy_over_split_logits_breaks_ties_as_argmax():
    """``_greedy`` on a 1x1 stand-in's ``"model"`` of one against
    ``argmax`` with repeated maxima; the split form on a stand-in of two
    (its reductions leave the rank's own) picks the rank's first maximum
    at its offset, the vocab's size where it holds none."""
    from repro_torch.distributed.tensor_parallel import Split
    from repro_torch.obs.compiled import program

    x = torch.tensor([[[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]],
                      [[5.0, 5.0, 1.0, 1.0, 0.0, 5.0]]])
    assert steps._greedy(x).flatten().tolist() \
        == x[:, -1].argmax(-1).tolist() == [1, 0]
    mesh = StandInMesh(("data", "model"), (1, 2), 1)
    with program("test.greedy"):
        got = steps._greedy(x[..., 3:], Split(mesh, 2, 3, 6))
    # row 0: the rank's own maximum 3 at its column 1; row 1: its maximum
    # 5 at its column 2 (a stand-in reduces to the rank's own values)
    assert got.flatten().tolist() == [4, 5]
    assert got.dtype == torch.int32


# --------------------------------------------------------------------------
# collective bytes: the meta stand-in against the ranks and a formula
# --------------------------------------------------------------------------

def _meta(t: np.ndarray | torch.Tensor, dtype=None):
    return torch.empty(tuple(t.shape), dtype=dtype or torch.from_numpy(
        np.asarray(t[:0])).dtype if isinstance(t, np.ndarray) else t.dtype,
        device="meta")


@functools.cache
def _meta_steps(arch: str, d_n: int, m_n: int, rank: int) -> dict:
    """The analyses of rank ``rank``'s split prefill, one decode and one
    train step on a (d_n, m_n) stand-in, on meta tensors."""
    cfg = ranks.arch_config(arch)
    mesh = StandInMesh(("data", "model"), (d_n, m_n), rank)
    whole = {k: torch.empty(v.shape, device="meta")
             for k, v in _whole(arch).items()}
    step = steps.ShardedServeStep(build(cfg, "meta"), mesh,
                                  ranks.serve_max_len(cfg))
    step.load(whole, "meta")
    per = ranks.SERVE_B // d_n
    batch = {k: torch.empty((per,) + v.shape[1:],
                            dtype=torch.from_numpy(v).dtype, device="meta")
             for k, v in ranks.serve_inputs(cfg).items()}
    pre = analyze(step.prefill, batch)
    tok, cache = pre["result"]
    pos0 = ranks.SERVE_S + (cfg.n_meta_tokens or 0)
    dec = analyze(step.decode, cache, tok, pos0)
    model = build(cfg, "meta")
    opt = AdamW(lr=ranks.LR)
    train = steps.ShardedTrainStep(model, opt, mesh, 2)
    shards = train.shard(whole)
    train.release()
    b = ranks.batches(cfg)[0]
    b = {k: torch.empty((v.shape[0] // d_n,) + v.shape[1:],
                        dtype=torch.from_numpy(v).dtype, device="meta")
         for k, v in b.items()}
    tr = analyze(train, shards, opt.init(shards), b)
    return {"prefill": pre, "decode": dec, "train": tr,
            "shards": sum(math.prod(s) for s in train.shard_shapes.values()),
            "grad_size": train.grad_size, "micro": train.n}


def _divides(cfg, m: int) -> dict:
    """Which split regions a ``"model"`` of ``m`` splits (the fitted specs'
    divisibility, as ``tensor_parallel.plan`` reads it)."""
    di, hs, n = cfg.d_inner_ssm, cfg.n_ssm_heads, cfg.d_state
    return {
        "attn": cfg.n_heads > 0 and cfg.n_heads % m == 0,
        "ffn": bool(cfg.d_ff) and cfg.d_ff % m == 0,
        "experts": cfg.n_experts > 0 and cfg.n_experts % m == 0,
        "shared": cfg.n_shared_experts * cfg.d_expert % m == 0,
        "mixer": bool(hs and cfg.d_state) and all(
            w % m == 0 for w in (hs, di, 2 * di + 2 * n + hs, di + 2 * n)),
        "vocab": cfg.vocab % m == 0}


def _expected_bytes(arch: str, d_n: int, m_n: int, mode: str) -> dict:
    """Per-kind collective operand bytes of one rank's split step, from the
    layer counts and widths (float32 activations, the smoke configs')."""
    cfg = ranks.arch_config(arch)
    kinds = dict.fromkeys(("all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all", "collective-permute"), 0)
    if m_n == 1 and mode != "train":
        kinds["total"] = 0
        return kinds
    dv = _divides(cfg, m_n)
    D, f4 = cfg.d_model, 4
    red = []                       # all-reduced tensors' element counts
    M = (cfg.n_meta_tokens or 0) if mode != "decode" else 0
    if mode == "train":            # the trainer's vlm tokens leave room for
        n = max(1, 2 // d_n)       # its patches within the sequence
        b = ranks.B // d_n // n
        F = max(ranks.S // 4, 1)
        P = cfg.frontend_len if cfg.kind == "vlm" else 0
        S = ranks.S - P
    else:
        b = ranks.SERVE_B // d_n
        S = ranks.SERVE_S if mode == "prefill" else 1
        F = ranks.SERVE_S // 4
        P = cfg.frontend_len if cfg.kind == "vlm" and mode == "prefill" else 0
    T = b * (S + P + M)            # the residual's rows
    head = b * (S + P)             # the head's rows (after the meta tokens)
    if m_n > 1:
        fwd, bwd = [], []          # per block: (elements) forward, backward

        def region(name, rows, extra_fwd=(), extra_bwd=()):
            if dv[name]:
                fwd.append([rows * D, *extra_fwd])
                bwd.append([rows * D, *extra_bwd])

        blocks = []
        if cfg.kind == "encdec":
            blocks += [[("attn", b * F), ("ffn", b * F)]] * (
                cfg.n_enc_layers if mode != "decode" else 0)
            blocks += [[("attn", T), ("cross", T), ("ffn", T)]] \
                * cfg.n_layers
        elif cfg.kind == "ssm":
            blocks += [[("mixer", T)]] * cfg.n_layers
        elif cfg.kind == "hybrid":
            blocks += [[("attn", T), ("mixer", T), ("ffn", T)]] * cfg.n_layers
        elif cfg.kind == "moe":
            blocks += [[("attn", T), ("moe", T)]] * cfg.n_layers
        else:
            blocks += [[("attn", T), ("ffn", T)]] * cfg.n_layers
        per_block = []
        for blk in blocks:
            f, g = [], []
            for name, rows in blk:
                if name in ("attn", "cross") and dv["attn"]:
                    f.append(rows * D)
                    g.append(rows * D)
                    if name == "cross" and mode == "train":
                        g.append(b * F * D)
                elif name == "ffn" and dv["ffn"]:
                    f.append(rows * D)
                    g.append(rows * D)
                elif name == "mixer" and dv["mixer"]:
                    f += [rows, rows * D]
                    g += [rows * D, rows]
                elif name == "moe" and dv["experts"]:
                    f.append(rows * D)
                    g += [rows * D, rows * cfg.top_k]
                elif name == "moe" and dv["shared"] and cfg.n_shared_experts:
                    f.append(rows * D)
                    g.append(rows * D)
            per_block.append((f, g))
        if mode == "train":
            for _ in range(n):
                if dv["vocab"]:
                    red += [b * S * D, b * S, 2 * b * S]   # lookup, max, sums
                    red.append(head * D)    # the head's input gradient
                for f, g in per_block:
                    red += f * (2 if cfg.remat else 1) + g
        else:
            if dv["vocab"]:
                red.append(b * S * D)       # the lookup
            for f, _ in per_block:
                red += f
    kinds["all-reduce"] = f4 * sum(red)
    if mode == "train":
        step = _meta_steps(arch, d_n, m_n, 0)
        kinds["all-gather"] = f4 * step["shards"]
        kinds["all-reduce"] += f4 * step["grad_size"]
    elif m_n > 1 and dv["vocab"]:
        kinds["all-reduce"] += b * (4 + 8)  # greedy's max and first index
    kinds["total"] = sum(kinds.values())
    return kinds


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_collective_bytes_meta_equal_the_ranks_and_the_formula(served, arch,
                                                               tag):
    _, metas = served
    d_n, m_n = MESHES[tag]
    for r, rec, _ in _ranks(metas, tag, arch):
        meta = _meta_steps(arch, d_n, m_n, r)
        got = rec["bytes"]
        assert meta["prefill"]["collectives"] == got["prefill"]
        for step_bytes in got["decode"]:
            assert meta["decode"]["collectives"] == step_bytes
        assert meta["train"]["collectives"] == got["train"]
        for mode in ("prefill", "decode", "train"):
            assert meta[mode]["collectives"] \
                == _expected_bytes(arch, d_n, m_n, mode), mode


# --------------------------------------------------------------------------
# per-rank FLOPs: summed over the ranks, the whole step's plus duplicates
# --------------------------------------------------------------------------

_TOKEN_ROWS = {"prefill": None, "decode": 1}


def _duplicated_flops(cfg, mode: str, m: int) -> int:
    """The product FLOPs a 1 x m mesh's ranks compute beyond the whole
    step's: each weight's slices over the ranks less the whole (``plan``'s
    runs: identical ones m times, partial ones where they overlap) times
    2 x the rows it multiplies, plus the products no weight carries in a
    region that does not split (attention's scores and values in full on
    every rank), plus the SSD scan's C B^T per group, which every rank of
    a split mixer computes."""
    b = ranks.SERVE_B
    S = ranks.SERVE_S if mode == "prefill" else 1
    M = cfg.n_meta_tokens or 0
    P = cfg.frontend_len if cfg.kind == "vlm" and mode == "prefill" else 0
    F = ranks.SERVE_S // 4
    T = b * (S + P + (M if mode == "prefill" else 0))
    model = build(cfg, "meta")
    plans = [_plan(cfg, 1, m, r) for r in range(m)]
    extra = 0
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        rows = {"embed": 0, "meta": 0, "vision_proj": b * P,
                "frame_proj": b * F if mode == "prefill" else 0,
                "lm_head": b}.get(leaf, T)
        if ".experts." in name or leaf in ("conv_w", "conv_b", "A_log",
                                           "D_skip", "dt_bias", "out_norm",
                                           "bq", "bk", "bv") \
                or leaf.startswith("ln") or leaf.endswith("norm") \
                or leaf.startswith("norm"):
            if not (leaf == "conv_w" and mode == "decode"):
                continue
            rows = b
        if cfg.kind == "encdec" and name.startswith("enc_layers."):
            rows = b * F if mode == "prefill" else 0
        if cfg.kind == "encdec" and ".cross.w" in name and leaf in ("wk",
                                                                     "wv"):
            rows = b * F if mode == "prefill" else 0
        numel = sum(math.prod(pl.shape(name)) for pl in plans) - p.numel()
        extra += 2 * rows * numel
    dv = _divides(cfg, m)
    if cfg.n_heads and not dv["attn"]:
        for _ in range(cfg.n_layers):
            if mode == "prefill":
                pairs = attn_pairs(S + M + P, S + M + P, True, cfg.window,
                                   M)
                extra += (m - 1) * 4 * cfg.dh * pairs * b * cfg.n_heads
            else:
                Sc = ranks.serve_max_len(cfg) + P
                extra += (m - 1) * 4 * b * cfg.n_heads * Sc * cfg.dh
    if dv["mixer"] and mode == "prefill":
        G = 1
        _, other = ss.ssd_ops(b, S + M, 0, cfg.ssm_head_dim, G, cfg.d_state,
                              min(cfg.ssm_chunk, S + M))
        extra += (m - 1) * other * cfg.n_layers
    return extra


@pytest.mark.parametrize("mode", ("prefill", "decode"))
@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_flops_sum_to_the_whole_step_and_its_duplicates(arch, mode):
    cfg = ranks.arch_config(arch)
    whole = _meta_steps(arch, 1, 1, 0)[mode]["flops"]
    for m in (2,):
        got = sum(_meta_steps(arch, 1, m, r)[mode]["flops"]
                  for r in range(m))
        assert got == whole + _duplicated_flops(cfg, mode, m), (
            got - whole, _duplicated_flops(cfg, mode, m))
