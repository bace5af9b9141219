"""The port's meshed trainer (``launch.steps.ShardedTrainStep``,
``launch.train``'s mesh path) with its tensor-parallel split over
``"model"``, int8 compression and the GPipe pipeline on four gloo ranks,
against the one-card port and the reference.

One spawn of four ranks (``tests/torch_train_ranks.py``) runs everything:
three smoke architectures (a dense decoder whose ``n_kv_heads=2`` leaves
``wk``/``wv`` whole under a split ``wq`` on a ``"model"`` of 4, an MoE for
the ``"experts"`` axis, mamba2) for three steps on 2x2, 1x4 and 4x1 meshes,
``compressed_psum_tree`` and ``pipeline_apply`` over the four ranks, a
``train_loop`` preempted on the 2x2 mesh; then the group shrinks to two
ranks, which resume that loop on a 1x2 mesh and run the three
architectures there, and one step of each other family.

Bars: on a ``"model"`` of 1 (4x1) the meshed steps equal the one-card
port's steps with the same microbatches bit for bit (the gradient sum is
a left fold in rank order). On a split ``"model"`` (2x2, 1x2, 1x4) each
step is held to the one-card step from the same state (the meshed run's
own state before it, gathered by rank 0): loss and grad norm within 1e-5
relative, every parameter within 1e-5 with the sign knife edges of Adam's
update counted and excluded as the reference's bar does, both moments
within 1e-5 of their largest entry; the three steps' losses also stay
within 1e-5 of the one-card run's. The first 2x2 step against the
reference's ``make_train_step`` at ``tests/test_torch_train_loop.py``'s
bars (1e-5, sign knife edges counted); the compressed mean bit for bit
against a single-process emulation built from the reference's
``quantize_ef``/``dequantize``, and within the reference's 2 % of the
exact mean; the pipeline within the reference's 1e-5 of the sequential
stages."""

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_train_ranks as ranks  # noqa: E402
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.distributed.compression import dequantize as ref_dequantize  # noqa: E402
from repro.distributed.compression import quantize_ef as ref_quantize  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.distributed import ShardingRules, bubble_fraction  # noqa: E402
from repro_torch.distributed.sharding import logical_to_spec  # noqa: E402
from repro_torch.launch import steps as step_lib  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamW, OptState  # noqa: E402

SPAWN_TIMEOUT = 300.0   # seconds, the one spawn of four ranks
CLI_TIMEOUT = 240.0     # seconds, the CLI's two ranks under torchrun
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
MESHES = {"2x2": (2, 2), "1x2": (1, 2), "1x4": (1, 4), "4x1": (4, 1)}
SPLIT = ("2x2", "1x2", "1x4")      # a "model" dim wider than one rank
MICRO = {"2x2": 2, "1x2": 2, "1x4": 2, "4x1": 4}   # global microbatches
COORDS = {"2x2": "coords", "1x2": "small_coords", "1x4": "1x4_coords",
          "4x1": "4x1_coords"}    # each rank's record of its position
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.cache
def _ref_params(arch: str):
    return jax.jit(ref_build(ref_smoke_config(arch)).init)(
        jax.random.PRNGKey(0))


@functools.cache
def _init(arch: str) -> dict:
    """The initial state dict (numpy): the reference's init for the three
    ``ARCHS`` (their first step is held to the reference's), the port's
    seeded one for the other families."""
    cfg = ranks.arch_config(arch)
    if arch not in ranks.ARCHS:
        model = build(cfg, "cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        return {k: v.detach().numpy() for k, v in model.named_parameters()}
    return {k: v.numpy() for k, v in interop.params_from_reference(
        cfg, jax.tree.map(np.asarray, _ref_params(arch))).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one spawn: (out dir, each rank's record)."""
    out = tmp_path_factory.mktemp("substrate")
    for arch in ranks.ARCHS + ranks.OTHERS:
        np.savez(out / f"init_{arch}.npz", **_init(arch))
    ranks.spawn(out, SPAWN_TIMEOUT)
    return out, [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(4)]


def _tensors(d: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@functools.cache
def _one_card(arch: str, n_micro: int = 2):
    """The one-card port's STEPS steps with ``n_micro`` microbatches from
    the same init on the whole global batches: per step (loss, grad norm),
    and the parameters and moments after each step."""
    cfg = ranks.arch_config(arch)
    model = build(cfg, "cpu")
    model.load_state_dict(_tensors(_init(arch)))
    opt = AdamW(lr=ranks.LR)
    params = dict(model.named_parameters())
    state = opt.init(params)
    step = step_lib.make_train_step(model, opt, n_micro)
    metrics, after = [], {}
    for s, b in enumerate(ranks.batches(cfg)):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        after[s + 1] = _state_arrays(params, state)
    return metrics, after


def _state_arrays(params: dict, state) -> dict:
    return {**{f"p.{n}": p.detach().numpy().copy()
               for n, p in params.items()},
            **{f"m.{n}": t.numpy().copy() for n, t in state.m.items()},
            **{f"v.{n}": t.numpy().copy() for n, t in state.v.items()}}


def _saved(out, tag: str, arch: str, s: int) -> dict:
    """Rank 0's gathered state after meshed step ``s`` (1-based)."""
    with np.load(out / f"{tag}_{arch}_step{s}.npz") as z:
        return {k: z[k] for k in z.files}


def _step_from(arch: str, s: int, before: dict | None, n_micro: int = 2):
    """One one-card step on global batch ``s`` (0-based) from the whole
    state ``before`` (``_saved``'s keys; None: the init with zero
    moments): ((loss, grad norm), the state after it)."""
    cfg = ranks.arch_config(arch)
    model = build(cfg, "cpu")
    init = _init(arch)
    model.load_state_dict(_tensors(
        init if before is None else {n: before[f"p.{n}"] for n in init}))
    params = dict(model.named_parameters())
    opt = AdamW(lr=ranks.LR)
    if before is None:
        state = opt.init(params)
    else:
        state = OptState(step=torch.tensor(s, dtype=torch.int32),
                         m=_tensors({n: before[f"m.{n}"] for n in init}),
                         v=_tensors({n: before[f"v.{n}"] for n in init}))
    b = ranks.batches(cfg)[s]
    state, m = step_lib.make_train_step(model, opt, n_micro)(
        state, {k: torch.as_tensor(v) for k, v in b.items()})
    return (m["loss"].item(), m["grad_norm"].item()), \
        _state_arrays(params, state)


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= TOL * abs(want)


def _assert_state_close(got: dict, want: dict, what: str) -> int:
    """Every parameter within TOL but the sign knife edges of Adam's update
    (entries whose first moment is below 1e-3 of the tensor's largest, as
    the reference's bar counts them), both moments within TOL of their
    largest entry. Returns the knife edges counted."""
    assert set(got) == set(want)
    n_edge = 0
    for k in want:
        if not k.startswith("p."):
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=TOL * scale, err_msg=f"{what} {k}")
            continue
        g = np.abs(want["m." + k[2:]])
        edge = (g < 1e-3 * g.max()) & (g > 0)
        n_edge += int(edge.sum())
        gap = float(np.where(edge, 0.0, np.abs(got[k] - want[k])).max())
        assert gap <= TOL, f"{what} {k}: {gap} ({n_edge} knife edges so far)"
    return n_edge


def _split_counts(cfg, m: int) -> tuple[int, int, int]:
    """All-reduces over ``"model"`` of one microbatch on a ``"model"`` of
    ``m``: (outside the blocks, a block's forward, a block's backward)
    summed over the blocks, from the layer counts and which axes divide."""
    if m == 1:
        return 0, 0, 0
    top = 4 if cfg.vocab % m == 0 else 0    # lookup, max, sums; head's grad
    heads = cfg.n_heads > 0 and cfg.n_heads % m == 0
    attn, cross = (1, 1) if heads else (0, 0), (1, 2) if heads else (0, 0)
    ffn = (1, 1) if cfg.d_ff and cfg.d_ff % m == 0 else (0, 0)
    if cfg.kind == "moe":
        ffn = (1, 2) if cfg.n_experts % m == 0 else (
            (1, 1) if cfg.n_shared_experts * cfg.d_expert % m == 0
            else (0, 0))
    di, hs, n = cfg.d_inner_ssm, cfg.n_ssm_heads, cfg.d_state
    mixer = (2, 2) if hs and all(
        w % m == 0 for w in (hs, di, 2 * di + 2 * n + hs, di + 2 * n)) \
        else (0, 0)
    per = {"decoder": (attn, ffn), "vlm": (attn, ffn), "moe": (attn, ffn),
           "ssm": (mixer,), "hybrid": (attn, mixer, ffn)}
    if cfg.kind == "encdec":
        blocks = [(attn, ffn)] * cfg.n_enc_layers \
            + [(attn, cross, ffn)] * cfg.n_layers
    else:
        blocks = [per[cfg.kind]] * cfg.n_layers
    fwd = sum(r[0] for b in blocks for r in b)
    bwd = sum(r[1] for b in blocks for r in b)
    return top, fwd, bwd


def _expected_numel(cfg, m: int, r: int) -> int:
    """Elements of the parameters ``"model"`` rank ``r`` of ``m`` computes
    with: the rank's share of each axis that divides (q heads, the kv
    heads its q heads read, ``d_ff``, experts, SSD heads with the whole B
    and C, vocab), the rest whole."""
    model = build(cfg, "meta")
    H, K, V = cfg.n_heads, cfg.n_kv_heads, cfg.vocab
    di, hs, n = cfg.d_inner_ssm, cfg.n_ssm_heads, cfg.d_state
    mixer = hs and all(w % m == 0 for w in
                       (hs, di, 2 * di + 2 * n + hs, di + 2 * n))
    if H and H % m == 0:
        g, hl = H // K, H // m
        kv = K // m if K % m == 0 else \
            (r * hl + hl - 1) // g - (r * hl) // g + 1
    total = 0
    for name, p in model.named_parameters():
        shape, leaf = list(p.shape), name.rsplit(".", 1)[-1]
        if m == 1:
            pass
        elif leaf in ("wq", "wo", "bq") and H % m == 0:
            shape[1 if leaf == "wq" else 0] //= m
        elif leaf in ("wk", "wv", "bk", "bv") and H % m == 0:
            shape[1 if leaf in ("wk", "wv") else 0] = kv
        elif leaf in ("w_gate", "w_up", "w_down") and p.dim() == 3:
            if cfg.n_experts % m == 0:
                shape[0] //= m
        elif leaf in ("w_gate", "w_up", "w_down"):
            d = 0 if leaf == "w_down" else 1
            if shape[d] % m == 0:
                shape[d] //= m
        elif leaf == "in_proj" and mixer:
            shape[1] = 2 * di // m + 2 * n + hs // m
        elif leaf in ("conv_w", "conv_b") and mixer:
            shape[-1] = di // m + 2 * n
        elif leaf in ("A_log", "D_skip", "dt_bias") and mixer:
            shape[0] //= m
        elif leaf in ("out_norm", "out_proj") and mixer:
            shape[0] //= m
        elif name == "embed" and V % m == 0:
            shape[0] //= m
        elif name == "lm_head" and V % m == 0:
            shape[1] //= m
        total += int(np.prod(shape))
    return total


def test_ranks_take_their_positions(runs):
    _, metas = runs
    assert [m["coords"] for m in metas] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert [m["1x4_coords"] for m in metas] == [[0, r] for r in range(4)]
    assert [m["4x1_coords"] for m in metas] == [[r, 0] for r in range(4)]
    assert [m.get("small_coords") for m in metas] == [[0, 0], [0, 1], None,
                                                      None]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_each_rank_holds_exactly_its_fitted_shards(runs, arch, mesh):
    _, metas = runs
    d, m = MESHES[mesh]
    cfg = ranks.arch_config(arch)
    model = build(cfg, "meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    stand_in = AbstractMesh(("data", "model"), (d, m))
    spec = logical_to_spec(ShardingRules.create(stand_in), model.axes())
    want = {n: list(s.shard_shape(shapes[n])) for n, s in
            step_lib.fitted(stand_in, {n: spec[n] for n in shapes},
                            shapes).items()}
    total = sum(int(np.prod(s)) for s in shapes.values())
    for meta in metas[:d * m]:
        rec = meta[mesh][arch]
        assert rec["shard_shapes"] == want
        assert rec["m_shapes"] == want and rec["v_shapes"] == want
        held = sum(int(np.prod(s)) for s in want.values())
        assert held < total             # the state is split, not replicated
        assert rec["shard_bytes"] == 4 * held
        assert rec["held_bytes"] == 3 * rec["shard_bytes"]
        # whole parameters exist only inside a step
        assert rec["param_numel_between"] == rec["param_numel_after"] == 0


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_each_rank_computes_with_only_its_slices(runs, arch, mesh):
    """During the step a rank's parameters are the slices it computes
    with: on a split ``"model"`` fewer elements than the whole model, as
    many as the split of each dividing axis leaves; on 4x1 the whole."""
    _, metas = runs
    d, m = MESHES[mesh]
    cfg = ranks.arch_config(arch)
    whole = _expected_numel(cfg, 1, 0)
    for meta in metas[:d * m]:
        rec = meta[mesh][arch]
        want = _expected_numel(cfg, m, meta[COORDS[mesh]][1])
        assert rec["held_numel"] and set(rec["held_numel"]) == {want}
        assert rec["compute_bytes"] == 4 * want
        assert (want < whole) == (mesh in SPLIT)
        assert set(rec["modes"].values()) <= {"disjoint", "partial",
                                              "identical"}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_meshed_steps_equal_the_one_card_steps_bit_for_bit(runs, arch, mesh):
    """On 4x1 the meshed run is the one-card run with four microbatches,
    bit for bit. On a split ``"model"`` the split reorders partial sums:
    each step is held to the one-card step from the meshed run's own state
    before it at the stated bars, and the losses to the one-card run's."""
    out, metas = runs
    d, m = MESHES[mesh]
    metrics, after = _one_card(arch, MICRO[mesh])
    if mesh not in SPLIT:
        for meta in metas[:d * m]:
            rec = meta[mesh][arch]
            assert list(zip(rec["losses"], rec["gnorms"])) == metrics
        for s, want in after.items():
            got = _saved(out, mesh, arch, s)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        return
    before = None
    for s in range(ranks.STEPS):
        want_m, want = _step_from(arch, s, before, MICRO[mesh])
        got = _saved(out, mesh, arch, s + 1)
        for meta in metas[:d * m]:
            rec = meta[mesh][arch]
            assert _close(rec["losses"][s], want_m[0]), (s, rec["losses"])
            assert _close(rec["gnorms"][s], want_m[1]), (s, rec["gnorms"])
            assert _close(rec["losses"][s], metrics[s][0])
        _assert_state_close(got, want, f"{mesh} step {s + 1}")
        before = got


@pytest.mark.parametrize("arch", ranks.ARCHS + ranks.OTHERS)
def test_every_family_splits_its_step_on_1x2(runs, arch):
    """One split step of every family's smoke config on 1x2 against the
    one-card step from the same init: the bars, the collectives and the
    parameters each rank computes with."""
    out, metas = runs
    cfg = ranks.arch_config(arch)
    want_m, want = _step_from(arch, 0, None)
    top, fwd, bwd = _split_counts(cfg, 2)
    per_mb = top + (2 if cfg.remat else 1) * fwd + bwd
    for meta in metas[:2]:
        rec = meta["1x2"][arch]
        assert _close(rec["losses"][0], want_m[0])
        assert _close(rec["gnorms"][0], want_m[1])
        assert rec["counts"][0]["all-reduce"] == 1 + 2 * per_mb
        assert per_mb > 0               # the step does split
        held = _expected_numel(cfg, 2, meta["small_coords"][1])
        assert set(rec["held_numel"]) == {held}
        assert held < _expected_numel(cfg, 1, 0)
    _assert_state_close(_saved(out, "1x2", arch, 1), want, f"{arch} 1x2")


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_split_forward_logits_match_the_one_card_forward(runs, arch):
    """``ShardedTrainStep.logits`` on 2x2 (vocab-split heads, gathered over
    ``"model"``) against the one-card forward on the same rows."""
    out, metas = runs
    cfg = ranks.arch_config(arch)
    model = build(cfg, "cpu")
    model.load_state_dict(_tensors(_init(arch)))
    b = ranks.batches(cfg)[0]
    rows = ranks.B // 2
    for r, meta in enumerate(metas):
        d = meta["coords"][0]
        with torch.no_grad():     # the rank's rows alone (an MoE routes them)
            want = model({k: torch.as_tensor(v[d * rows:(d + 1) * rows])
                          for k, v in b.items()})[0].numpy()
        got = np.load(out / f"2x2_{arch}_logits{r}.npy")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_first_meshed_step_matches_the_reference(runs, arch):
    out, metas = runs
    cfg = ranks.arch_config(arch)
    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    opt = RefAdamW(lr=ranks.LR)
    params = _ref_params(arch)
    step = jax.jit(ref_steps.make_train_step(ref_build(rcfg), opt, None,
                                             n_microbatches=2))
    new_p, new_s, metrics = jax.tree.map(np.asarray, step(
        params, opt.init(params),
        {k: jnp.asarray(v) for k, v in ranks.batches(cfg)[0].items()}))
    rec = metas[0]["2x2"][arch]
    for got, k in ((rec["losses"][0], "loss"), (rec["gnorms"][0],
                                                 "grad_norm")):
        assert abs(got - float(metrics[k])) <= 1e-5 * abs(float(metrics[k]))
    want_p = interop.params_from_reference(cfg, new_p)
    ref_m = interop.params_from_reference(cfg, new_s.m)
    n_edge = 0
    with np.load(out / f"2x2_{arch}_step1.npz") as z:
        for name, want in want_p.items():
            g = np.abs(ref_m[name].numpy())
            # the sign knife edges of the first Adam step are counted
            edge = (g < 1e-3 * g.max()) & (g > 0)
            n_edge += int(edge.sum())
            gap = np.abs(z[f"p.{name}"] - want.numpy())
            assert float(np.where(edge, 0.0, gap).max()) <= 1e-5, \
                f"{name} ({n_edge} knife-edge entries so far)"
            np.testing.assert_allclose(
                z[f"m.{name}"], ref_m[name].numpy(), rtol=0,
                atol=1e-4 * max(float(g.max()), 1e-30), err_msg=name)


@pytest.mark.parametrize("mesh", MESHES)
def test_a_step_issues_one_all_gather_and_one_all_reduce(runs, mesh):
    """A step's own collectives are one all-gather and one all-reduce; a
    split ``"model"`` adds its layers' all-reduces, exactly as many as the
    layer counts give (each rematerialised block's forward twice)."""
    _, metas = runs
    d, m = MESHES[mesh]
    for meta in metas[:d * m]:
        for arch in ranks.ARCHS:
            cfg = ranks.arch_config(arch)
            top, fwd, bwd = _split_counts(cfg, m)
            n_local = max(1, MICRO[mesh] // d)
            split = n_local * (top + (2 if cfg.remat else 1) * fwd + bwd)
            assert (split > 0) == (mesh in SPLIT)
            for counts in meta[mesh][arch]["counts"]:
                assert counts == {"all-reduce": 1 + split, "all-gather": 1,
                                  "reduce-scatter": 0, "all-to-all": 0,
                                  "collective-permute": 0,
                                  "total": 2 + split}


@pytest.mark.parametrize("mesh", MESHES)
def test_a_checkpoint_gathers_a_tensor_at_a_time_to_rank_0(runs, mesh):
    """Each all-gather of ``gather_state`` moves one shard of one tensor
    (masters, then m, then v), so a save adds about one whole tensor to a
    rank's memory, not the whole state; only rank 0 keeps the result."""
    _, metas = runs
    d, m = MESHES[mesh]
    for r, meta in enumerate(metas[:d * m]):
        for arch in ranks.ARCHS:
            rec = meta[mesh][arch]
            shard_sizes = [int(np.prod(s))
                           for s in rec["shard_shapes"].values()]
            assert rec["ckpt_gathered"] == shard_sizes * 3
            assert rec["ckpt_counts"]["all-gather"] == 3 * len(shard_sizes)
            assert rec["ckpt_counts"]["total"] == 3 * len(shard_sizes)
            assert rec["ckpt_kept"] == (r == 0)


def test_preempted_on_2x2_resumes_on_1x2_and_on_one_process(runs, tmp_path):
    out, metas = runs
    cfg = ranks.arch_config("tinyllama_1_1b")
    whole = train_loop(cfg, ranks.LOOP_STEPS, str(tmp_path / "whole"),
                       device="cpu", **ranks.LOOP)["losses"]
    single = train_loop(cfg, ranks.LOOP_STEPS, str(out / "ckpt_single"),
                        device="cpu", resume=True, **ranks.LOOP)
    assert single["status"] == "done"
    # the 2x2 and 1x2 meshes split "model": within TOL of the whole run
    near = lambda got, want: len(got) == len(want) and all(  # noqa: E731
        _close(a, b) for a, b in zip(got, want))
    for meta in metas:
        assert meta["preempted"]["status"] == "preempted"
        assert near(meta["preempted"]["losses"], whole[:ranks.PREEMPT])
    for meta in metas[:2]:
        assert meta["resumed"]["status"] == "done"
        assert near(meta["resumed"]["losses"], whole[ranks.PREEMPT:])
    assert near(single["losses"], whole[ranks.PREEMPT:])


def _emulated_mean(parts: list[dict]) -> dict:
    """``compressed_psum_tree``'s mean from the reference's own
    ``quantize_ef``/``dequantize`` in one process: each rank quantizes
    from a zero residual, the levels re-quantized to the largest scale,
    summed as int32, rescaled over the rank count."""
    out = {}
    for k in parts[0]:
        qs = [ref_quantize(jnp.asarray(p[k]), jnp.zeros(p[k].shape))
              for p in parts]
        smax = jnp.max(jnp.stack([s for _, s, _ in qs]))
        total = sum(jnp.clip(jnp.round(ref_dequantize(q, s) / smax), -127,
                             127).astype(jnp.int32) for q, s, _ in qs)
        out[k] = np.asarray((total.astype(jnp.float32) * smax
                             / jnp.float32(len(parts))))
    return out


def test_compressed_psum_tree_over_four_ranks(runs):
    out, metas = runs
    parts = [ranks.comp_inputs(r) for r in range(4)]
    want = _emulated_mean(parts)
    for r, meta in enumerate(metas):
        assert meta["compress_counts"]["all-reduce"] == 2
        assert meta["compress_counts"]["total"] == 2
        with np.load(out / f"compress{r}.npz") as z:
            for k in want:
                np.testing.assert_array_equal(z[f"mean.{k}"], want[k])
                _, _, err = ref_quantize(jnp.asarray(parts[r][k]),
                                         jnp.zeros(parts[r][k].shape))
                np.testing.assert_array_equal(z[f"err.{k}"], np.asarray(err))
    exact = np.mean([p["w"] for p in parts], axis=0)
    scale = max(float(np.abs(p["w"]).max()) for p in parts)
    with np.load(out / "compress0.npz") as z:
        assert float(np.abs(z["mean.w"] - exact).max()) / scale < 0.02


def test_pipeline_apply_over_four_ranks(runs):
    out, metas = runs
    w, x = ranks.pipe_inputs()
    ref = torch.from_numpy(x)
    for s in range(ranks.PIPE[0]):
        ref = ranks.stage_fn(torch.from_numpy(w[s]), ref)
    n_stages, n_micro = ranks.PIPE[:2]
    for r, meta in enumerate(metas):
        y = np.load(out / f"pipe{r}.npy")
        assert float(np.abs(y - ref.numpy()).max()) < 1e-5
        assert meta["pipeline_counts"]["collective-permute"] \
            == n_micro + n_stages - 1
        assert meta["pipeline_counts"]["all-reduce"] == 1
    assert abs(bubble_fraction(8, 4) - 3 / 11) < 1e-12


def test_ranks_import_no_reference(runs):
    _, metas = runs
    for meta in metas:
        assert "repro_torch" in meta["modules"]
        assert not {"jax", "jaxlib", "repro"} & set(meta["modules"])


def test_cli_elastic_demo_under_torchrun(tmp_path):
    """The documented CLI: two gloo ranks under ``torchrun`` preempt half
    way (at the trainer's checkpoint of step 20), shrink the group to one
    rank (a ``tcp://`` group of its own, not the launcher's store) and
    resume there from that checkpoint to the end."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "tinyllama_1_1b", "--smoke", "--steps", "40", "--batch",
         "4", "--seq", "32", "--elastic-demo", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT)
    assert run.returncode == 0, run.stderr[-4000:]
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith("[train]") and not ln.startswith("[train] step")]
    assert lines == [
        "[train] PREEMPTED at step 20 (spot reclaim simulated)",
        "[train] elastic restart after 20 on 1 rank(s)",
        "[train] restored step 20 onto a 1x1 mesh (elastic re-shard)",
        "[train] finished: done at step 40"], run.stdout
