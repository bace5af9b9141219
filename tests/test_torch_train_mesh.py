"""The port's meshed trainer (``launch.steps.ShardedTrainStep``,
``launch.train``'s mesh path), int8 compression and the GPipe pipeline on
four gloo ranks, against the one-card port and the reference.

One spawn of four ranks (``tests/torch_train_ranks.py``) runs everything:
three smoke architectures (a dense decoder, an MoE for the ``"experts"``
axis, mamba2) for three steps on a 2x2 mesh, ``compressed_psum_tree``
and ``pipeline_apply`` over the four ranks, a ``train_loop`` preempted on
the 2x2 mesh; then the group shrinks to two ranks, which resume that loop
on a 1x2 mesh and run the three architectures there.

Bars: the meshed steps equal the one-card port's steps with the same two
microbatches bit for bit (``data`` 2 and 1: no sum of more than two
terms); the first step against the reference's ``make_train_step`` at
``tests/test_torch_train_loop.py``'s bars (1e-5, sign knife edges
counted); the compressed mean bit for bit against a single-process
emulation built from the reference's ``quantize_ef``/``dequantize``, and
within the reference's 2 % of the exact mean; the pipeline within the
reference's 1e-5 of the sequential stages."""

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
from repro_torch.optim import AdamW  # noqa: E402

SPAWN_TIMEOUT = 240.0   # seconds, the one spawn of four ranks
CLI_TIMEOUT = 240.0     # seconds, the CLI's two ranks under torchrun
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
MESHES = {"2x2": (2, 2), "1x2": (1, 2)}


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


def _init(arch: str) -> dict:
    """The reference's init as the port's state dict (numpy)."""
    cfg = ranks.arch_config(arch)
    return {k: v.numpy() for k, v in interop.params_from_reference(
        cfg, jax.tree.map(np.asarray, _ref_params(arch))).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one spawn: (out dir, each rank's record)."""
    out = tmp_path_factory.mktemp("substrate")
    for arch in ranks.ARCHS:
        np.savez(out / f"init_{arch}.npz", **_init(arch))
    ranks.spawn(out, SPAWN_TIMEOUT)
    return out, [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(4)]


@functools.cache
def _one_card(arch: str):
    """The one-card port's STEPS steps with two microbatches from the same
    init on the whole global batches: per step (loss, grad norm), and the
    parameters and moments after the first and the last step."""
    cfg = ranks.arch_config(arch)
    model = build(cfg, "cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _init(arch).items()})
    opt = AdamW(lr=ranks.LR)
    params = dict(model.named_parameters())
    state = opt.init(params)
    step = step_lib.make_train_step(model, opt, 2)
    metrics, after = [], {}
    for s, b in enumerate(ranks.batches(cfg)):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        if s in (0, ranks.STEPS - 1):
            after[s + 1] = {
                **{f"p.{n}": p.detach().numpy().copy()
                   for n, p in params.items()},
                **{f"m.{n}": t.numpy().copy() for n, t in state.m.items()},
                **{f"v.{n}": t.numpy().copy() for n, t in state.v.items()}}
    return metrics, after


def test_ranks_take_their_positions(runs):
    _, metas = runs
    assert [m["coords"] for m in metas] == [[0, 0], [0, 1], [1, 0], [1, 1]]
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
def test_meshed_steps_equal_the_one_card_steps_bit_for_bit(runs, arch, mesh):
    out, metas = runs
    metrics, after = _one_card(arch)
    d, m = MESHES[mesh]
    for meta in metas[:d * m]:
        rec = meta[mesh][arch]
        assert list(zip(rec["losses"], rec["gnorms"])) == metrics
    for s, want in after.items():
        with np.load(out / f"{mesh}_{arch}_step{s}.npz") as z:
            assert set(z.files) == set(want)
            for k in want:
                np.testing.assert_array_equal(z[k], want[k], err_msg=k)


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
    _, metas = runs
    d, m = MESHES[mesh]
    for meta in metas[:d * m]:
        for arch in ranks.ARCHS:
            for counts in meta[mesh][arch]["counts"]:
                assert counts == {"all-reduce": 1, "all-gather": 1,
                                  "reduce-scatter": 0, "all-to-all": 0,
                                  "collective-permute": 0, "total": 2}


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
    for meta in metas:
        assert meta["preempted"]["status"] == "preempted"
        assert meta["preempted"]["losses"] == whole[:ranks.PREEMPT]
    for meta in metas[:2]:
        assert meta["resumed"]["status"] == "done"
        assert meta["resumed"]["losses"] == whole[ranks.PREEMPT:]
    assert single["losses"] == whole[ranks.PREEMPT:]


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
