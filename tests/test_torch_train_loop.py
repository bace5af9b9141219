"""The port's trainer against the reference's: the train step (one step,
and gradient accumulation over microbatches) against the reference's
``make_train_step`` from one set of weights and one optimizer state
(``interop.params_from_reference``, ``interop.opt_state_from_reference``);
the bfloat16 smoke losses; the data pipeline bit for bit; the checkpoints
(``tests/test_substrate.py::TestCheckpoint`` on the port); and the train
loop: its loss falls, a preempted and resumed run is bit for bit the run
that was not stopped, the CLI runs, and nothing runs on the CPU unless
asked to.

Bars: the step's metrics and new parameters at 1e-5, except the entries
where the first Adam step is a sign (``lr * g / (|g| + eps)``) and the
reference's gradient is under 1e-3 of its leaf's largest magnitude, which
are counted, not held; microbatches against one batch at the reference's
own bars (5e-3, 2e-1 for MoE) and against the reference's microbatched
loss at 1e-5; bfloat16 losses at 2e-2 relative (ROADMAP queue C)."""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.data import SyntheticTokens as RefTokens  # noqa: E402
from repro.data import make_batches as ref_make_batches  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCH_NAMES, smoke_config  # noqa: E402
from repro_torch.data import SyntheticTokens, make_batches  # noqa: E402
from repro_torch.launch import steps as step_lib  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

B, S = 4, 32
LR = 1e-2          # large enough that the step's change shows at 1e-5


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


def _batch(cfg) -> dict:
    extras = {}
    if cfg.kind == "encdec":
        extras["frames"] = (max(S // 4, 1), cfg.d_model)
    if cfg.kind == "vlm":
        extras["vision"] = (cfg.frontend_len, cfg.d_model)
    return RefTokens(cfg.vocab, B, S, seed=5, host_rank=0, host_count=1,
                     extras=extras).batch(2)


def _port(arch: str, dtype: str = "float32"):
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    model = build(cfg, "cpu")
    model.load_state_dict(interop.params_from_reference(
        cfg, jax.tree.map(np.asarray, _ref_params(arch))))
    return cfg, model


@functools.cache
def _ref_step(arch: str, n_microbatches: int):
    """The reference's train step from its init and a fresh AdamW state:
    (params, state, metrics), numpy trees."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    model = ref_build(rcfg)
    opt = RefAdamW(lr=LR)
    params = _ref_params(arch)
    step = jax.jit(ref_steps.make_train_step(model, opt, None,
                                             n_microbatches=n_microbatches))
    new_p, new_s, metrics = step(
        params, opt.init(params),
        {k: jnp.asarray(v) for k, v in _batch(rcfg).items()})
    return jax.tree.map(np.asarray, (new_p, new_s, metrics))


def _port_step(arch: str, n_microbatches: int):
    cfg, model = _port(arch)
    opt = AdamW(lr=LR)
    state = interop.opt_state_from_reference(
        cfg, jax.tree.map(np.asarray,
                          RefAdamW(lr=LR).init(_ref_params(arch))))
    step = step_lib.make_train_step(model, opt, n_microbatches)
    state, metrics = step(state, {k: torch.as_tensor(v)
                                  for k, v in _batch(cfg).items()})
    return cfg, model, state, metrics


STEP_ARCHS = ("tinyllama_1_1b", "olmoe_1b_7b", "hymba_1_5b")


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_the_reference(arch):
    new_p, new_s, metrics = _ref_step(arch, 1)
    cfg, model, state, got = _port_step(arch, 1)
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(metrics[k])) \
            <= 1e-5 * abs(float(metrics[k])), k
    assert int(got["step"]) == int(metrics["step"]) == 1
    # the reference's gradient, from its first moment: m = 0.1 * clip * g
    ref_m = interop.params_from_reference(cfg, new_s.m)
    want = interop.params_from_reference(cfg, new_p)
    # Not held, counted in the message: the sign knife edges of the first
    # Adam step, non-zero reference gradients under 1e-3 of their leaf's
    # largest (exact zeros, such as unused embedding rows, are held).
    edges = {}
    for name, p in model.named_parameters():
        g = np.abs(ref_m[name].numpy())
        edges[name] = (g < 1e-3 * g.max()) & (g > 0)
    n_edge = sum(int(e.sum()) for e in edges.values())
    n = sum(p.numel() for p in model.parameters())
    for name, p in model.named_parameters():
        gap = np.abs(p.detach().numpy() - want[name].numpy())
        worst = float(np.where(edges[name], 0.0, gap).max())
        assert worst <= 1e-5, \
            f"{name}: {worst} ({n_edge} knife-edge entries of {n} excluded)"
        # m is the clipped gradient times 0.1: held at the gradients' bar
        np.testing.assert_allclose(state.m[name].numpy(), ref_m[name].numpy(),
                                   atol=1e-4 * max(float(np.abs(
                                       ref_m[name].numpy()).max()), 1e-30),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_microbatches_match_one_batch_and_the_reference(arch):
    *_, m2_ref = _ref_step(arch, 2)
    cfg, _, state1, m1 = _port_step(arch, 1)
    _, _, state2, m2 = _port_step(arch, 2)
    tol = 2e-1 if cfg.kind == "moe" else 5e-3
    assert abs(float(m1["loss"]) - float(m2["loss"])) < tol
    assert abs(float(m2["loss"]) - float(m2_ref["loss"])) \
        <= 1e-5 * abs(float(m2_ref["loss"]))
    assert abs(float(m2["grad_norm"]) - float(m2_ref["grad_norm"])) \
        <= 1e-5 * abs(float(m2_ref["grad_norm"]))
    assert int(state2.step) == 1


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_bfloat16_loss_matches_the_reference(arch):
    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype="bfloat16")
    batch = _batch(rcfg)
    want = float(jax.jit(ref_build(rcfg).loss)(
        _ref_params(arch), {k: jnp.asarray(v) for k, v in batch.items()}))
    _, model = _port(arch, "bfloat16")
    got = model.loss({k: torch.as_tensor(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.requires_grad
    assert abs(float(got) - want) <= 2e-2 * abs(want), (float(got), want)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extras", [{}, {"frames": (8, 16)},
                                    {"vision": (6, 16)}],
                         ids=["tokens", "frames", "vision"])
def test_synthetic_tokens_are_the_reference_s(extras):
    for rank, count in ((0, 1), (0, 2), (1, 2)):
        ref = RefTokens(1000, 8, 32, seed=4, host_rank=rank,
                        host_count=count, extras=extras)
        port = SyntheticTokens(1000, 8, 32, seed=4, host_rank=rank,
                               host_count=count, extras=extras)
        for step in (0, 1, 7, 123456):
            a, b = ref.batch(step), port.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])


class TestData:
    """``tests/test_substrate.py::TestData`` on the port."""

    def test_deterministic_across_restarts(self):
        ds = SyntheticTokens(1000, 8, 32, seed=1)
        np.testing.assert_array_equal(ds.batch(7)["tokens"],
                                      ds.batch(7)["tokens"])

    def test_host_shards_partition_global_batch(self):
        full = SyntheticTokens(1000, 8, 32, seed=1, host_rank=0, host_count=1)
        h0 = SyntheticTokens(1000, 8, 32, seed=1, host_rank=0, host_count=2)
        h1 = SyntheticTokens(1000, 8, 32, seed=1, host_rank=1, host_count=2)
        got = np.concatenate([h0.batch(3)["tokens"], h1.batch(3)["tokens"]])
        np.testing.assert_array_equal(got, full.batch(3)["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = SyntheticTokens(1000, 4, 16, seed=2).batch(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_prefetch_iterator_order(self):
        ds = SyntheticTokens(100, 2, 8, seed=0)
        got = list(make_batches(ds, 5, 4))
        assert [s for s, _ in got] == [5, 6, 7, 8]
        ref = list(ref_make_batches(RefTokens(100, 2, 8, seed=0, host_rank=0,
                                              host_count=1), 5, 4))
        for (s, a), (t, b) in zip(got, ref):
            assert s == t
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class TestCheckpoint:
    """``tests/test_substrate.py::TestCheckpoint`` on the port."""

    def test_roundtrip_and_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        tree = {"a": torch.arange(6.0).reshape(2, 3), "b.c": torch.ones(4),
                "opt.step": torch.tensor(9, dtype=torch.int32)}
        for s in (1, 2, 3):
            mgr.save(s, tree, blocking=s != 3)
        mgr.wait()
        assert mgr.latest_step() == 3
        got, step = mgr.restore(tree)
        assert step == 3
        for k, t in tree.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
        assert not os.path.exists(str(tmp_path / "step_000001"))
        assert os.path.exists(str(tmp_path / "step_000002" / "COMMITTED"))

    def test_uncommitted_checkpoint_ignored(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = {"x": torch.ones(3)}
        mgr.save(5, tree, blocking=True)
        # a preemption mid-write of step 9: no COMMITTED marker
        os.makedirs(tmp_path / "step_000009")
        np.save(tmp_path / "step_000009" / "x.npy", np.zeros(3))
        assert mgr.latest_step() == 5
        assert float(mgr.restore(tree)[0]["x"].sum()) == 3.0

    def test_shape_mismatch_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.ones(3)}, blocking=True)
        with pytest.raises(ValueError):
            mgr.restore({"x": torch.ones(4)})

    def test_nothing_committed_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path)).restore({"x": torch.ones(1)})


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------

def _loop(tmp_path, name, steps, **kw):
    return train.train_loop(smoke_config("tinyllama_1_1b"), steps,
                            str(tmp_path / name), global_batch=4, seq_len=32,
                            device="cpu", log_every=100, **kw)


def test_train_loss_decreases(tmp_path):
    r = _loop(tmp_path, "run", 30, ckpt_every=100)
    assert r["status"] == "done" and len(r["losses"]) == 30
    assert np.mean(r["losses"][-5:]) < np.mean(r["losses"][:5])


def test_preempt_and_resume_is_bit_for_bit(tmp_path):
    whole = _loop(tmp_path, "whole", 8, ckpt_every=3)
    r1 = _loop(tmp_path, "cut", 8, preempt_at=6, ckpt_every=3)
    assert r1["status"] == "preempted" and r1["step"] == 6
    assert CheckpointManager(str(tmp_path / "cut")).latest_step() == 6
    r2 = _loop(tmp_path, "cut", 8, resume=True, ckpt_every=3)
    assert r2["status"] == "done" and len(r2["losses"]) == 2
    assert r1["losses"] + r2["losses"] == whole["losses"]
    # and the final states of both runs, saved at step 8
    a = CheckpointManager(str(tmp_path / "whole"))
    b = CheckpointManager(str(tmp_path / "cut"))
    assert a.latest_step() == b.latest_step() == 8
    names = os.listdir(tmp_path / "whole" / "step_000008")
    for f in names:
        if f.endswith(".npy"):
            np.testing.assert_array_equal(
                np.load(tmp_path / "whole" / "step_000008" / f),
                np.load(tmp_path / "cut" / "step_000008" / f))
    assert "opt.step.npy" in names and "opt.m.embed.npy" in names


def test_microbatched_loop_runs(tmp_path):
    r = _loop(tmp_path, "mb", 3, ckpt_every=100, microbatches=2)
    assert r["status"] == "done" and np.all(np.isfinite(r["losses"]))


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    # preempted at 22, resumed from the checkpoint of step 20 (every 20)
    r = train.main(["--smoke", "--device", "cpu", "--steps", "44", "--batch",
                    "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "cli"),
                    "--elastic-demo"])
    assert r["status"] == "done" and r["step"] == 44
    assert len(r["losses"]) == 24
    out = capsys.readouterr().out
    assert "PREEMPTED at step 22" in out and "restored step 20" in out


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("tinyllama_1_1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        step_lib.make_train_step(build(cfg), AdamW())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_loop(cfg, 2, str(tmp_path / "gpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "2", "--ckpt-dir",
                    str(tmp_path / "gpu")])
