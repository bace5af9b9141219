"""The tensor-parallel split over ``"model"``
(``repro_torch.distributed.tensor_parallel``): the autograd collectives in
value and gradient and the vocab-parallel cross entropy against the
reference's ``cross_entropy`` (1e-6, as ``tests/test_torch_train.py``
holds the unsplit one) on two gloo ranks of a 1x2 mesh, with one meshed
step of a config whose q heads map unevenly onto the kv heads a rank
reads; and the slicing rule (``plan``) of every family on stand-in meshes
of a ``"model"`` of 2 and 4: every parameter's slices tile it as its
gradient rule says."""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_train_ranks as ranks  # noqa: E402
from repro.distributed.xent import cross_entropy as ref_xent  # noqa: E402

from repro_torch.configs import ARCH_NAMES, smoke_config  # noqa: E402
from repro_torch.distributed import ShardingRules  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import logical_to_spec  # noqa: E402
from repro_torch.engine import GridMesh  # noqa: E402
from repro_torch.launch import steps as step_lib  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.obs import compiled  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

SPAWN_TIMEOUT = 120.0   # seconds, the two ranks


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The spawn: per rank (arrays, record)."""
    out = tmp_path_factory.mktemp("tensor_parallel")
    ranks.spawn_tp(out, SPAWN_TIMEOUT)
    got = []
    for r in range(2):
        with np.load(out / f"tp{r}.npz") as z:
            got.append(({k: z[k] for k in z.files},
                        json.loads((out / f"tp{r}.json").read_text())))
    return got


def _one_reduce(counts: dict) -> bool:
    return counts["all-reduce"] == 1 and counts["total"] == 1


def test_copy_to_model_sums_the_gradient(tp_runs):
    a = ranks.tp_inputs()
    for arrays, meta in tp_runs:
        np.testing.assert_array_equal(arrays["copy.y"], a["x"])
        np.testing.assert_allclose(arrays["copy.grad"], a["w"].sum(0),
                                   rtol=1e-6)
        assert _one_reduce(meta["counts"]["copy"])


def test_reduce_from_model_sums_forward_only(tp_runs):
    a = ranks.tp_inputs()
    for arrays, meta in tp_runs:
        np.testing.assert_allclose(arrays["reduce.y"], a["parts"].sum(0),
                                   rtol=1e-6)
        np.testing.assert_array_equal(arrays["reduce.grad"], a["u"])
        assert _one_reduce(meta["counts"]["reduce"])


def test_sum_over_model_reduces_both_ways(tp_runs):
    a = ranks.tp_inputs()
    for arrays, meta in tp_runs:
        np.testing.assert_allclose(arrays["sum.y"], a["parts"].sum(0),
                                   rtol=1e-6)
        np.testing.assert_allclose(arrays["sum.grad"], a["w"].sum(0),
                                   rtol=1e-6)
        c = meta["counts"]["sum"]
        assert c["all-reduce"] == 2 and c["total"] == 2


def test_max_over_model_has_no_gradient(tp_runs):
    a = ranks.tp_inputs()
    for arrays, meta in tp_runs:
        np.testing.assert_array_equal(arrays["max.y"], a["parts"].max(0))
        assert not bool(arrays["max.requires_grad"])
        assert _one_reduce(meta["counts"]["max"])


def test_gather_from_model_keeps_the_ranks_slice_of_the_gradient(tp_runs):
    a = ranks.tp_inputs()
    whole = np.concatenate(list(a["narrow"]), axis=1)
    for r, (arrays, meta) in enumerate(tp_runs):
        np.testing.assert_array_equal(arrays["gather.y"], whole)
        np.testing.assert_array_equal(arrays["gather.grad"],
                                      a["u"][:, 2 * r:2 * r + 2])
        c = meta["counts"]["gather"]
        assert c["all-gather"] == 1 and c["total"] == 1


@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_cross_entropy_matches_the_reference(tp_runs, masked):
    """Each rank's loss from its half of the vocab equals the reference's
    loss over the whole vocab; its gradient is the rank's columns of the
    reference's gradient; one max and one sum all-reduce."""
    a = ranks.tp_inputs()
    mask = jnp.asarray(a["mask"]) if masked else None
    want = float(ref_xent(jnp.asarray(a["logits"]), jnp.asarray(a["labels"]),
                          mask=mask))
    g_ref = np.asarray(jax.grad(lambda z: ref_xent(
        z, jnp.asarray(a["labels"]), mask=mask))(jnp.asarray(a["logits"])))
    half = ranks.XENT_SHAPE[-1] // 2
    for r, (arrays, meta) in enumerate(tp_runs):
        got = float(arrays[f"xent{int(masked)}.loss"])
        assert abs(got - want) <= 1e-6 * abs(want)
        np.testing.assert_allclose(arrays[f"xent{int(masked)}.grad"],
                                   g_ref[..., r * half:(r + 1) * half],
                                   atol=1e-6)
        c = meta["counts"][f"xent{int(masked)}"]
        assert c["all-reduce"] == 2 and c["total"] == 2


def test_uneven_gqa_split_step_matches_the_one_card_step(tp_runs):
    """q heads 0-2 and 3-5 over kv heads 0-2: each rank reads two kv heads
    through its own head map, and the kv weights' gradients are partial."""
    cfg = ranks.uneven_gqa_config()
    model = build(cfg, "cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    opt = AdamW(lr=ranks.LR)
    params = dict(model.named_parameters())
    state = opt.init(params)
    b = ranks.batches(cfg)[0]
    state, m = step_lib.make_train_step(model, opt, 2)(
        state, {k: torch.as_tensor(v) for k, v in b.items()})
    for r, (arrays, meta) in enumerate(tp_runs):
        assert meta["kv_index"] == [[0, 0, 1], [0, 1, 1]][r]
        assert meta["modes"]["layers.0.attn.wk"] == "partial"
        assert abs(meta["loss"] - m["loss"].item()) <= 1e-5 * m["loss"].item()
        assert abs(meta["gnorm"] - m["grad_norm"].item()) \
            <= 1e-5 * m["grad_norm"].item()
        for n, p in params.items():
            g = np.abs(state.m[n].numpy())
            edge = (g < 1e-3 * g.max()) & (g > 0)
            gap = np.abs(arrays[f"p.{n}"] - p.detach().numpy())
            assert float(np.where(edge, 0.0, gap).max()) <= 1e-5, n


def test_off_a_split_each_collective_is_the_identity():
    """No process group (a 1x1 ``GridMesh``) or no mesh: every form
    returns its input and issues no collective."""
    x = torch.arange(6.0).reshape(2, 3)
    for mesh in (None, GridMesh.create(1, 1)):
        compiled.reset_collectives()
        with compiled.program("tp.identity"):
            outs = [tp.copy_to_model(x, mesh), tp.reduce_from_model(x, mesh),
                    tp.sum_over_model(x, mesh), tp.max_over_model(x, mesh),
                    tp.gather_from_model(x, mesh, 1)]
        assert all(torch.equal(o, x) for o in outs)
        assert compiled.collective_counts("tp.identity")["total"] == 0


@functools.cache
def _plans(arch: str, m: int):
    """Every ``"model"`` rank's plan of ``arch``'s smoke config on a 1 x m
    stand-in mesh."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    model = build(cfg, "meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mesh = AbstractMesh(("data", "model"), (1, m))
    spec = logical_to_spec(ShardingRules.create(mesh), model.axes())
    specs = {n: s.spec for n, s in step_lib.fitted(
        mesh, {n: spec[n] for n in shapes}, shapes).items()}
    return shapes, [tp.plan(model, specs, mesh, rank=r) for r in range(m)]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_parameters_slices_tile_it_as_its_rule_says(arch, m):
    """Over the ranks, a ``disjoint`` parameter's slices cover each entry
    once, a ``partial`` one's each entry at least once and some entry more
    than once, an ``identical`` one is whole on every rank; each rank's
    modes agree, and something splits."""
    shapes, plans = _plans(arch, m)
    assert all(p.modes == plans[0].modes for p in plans)
    assert any(mode != "identical" for mode in plans[0].modes.values())
    for n, shape in shapes.items():
        cover = np.zeros(shape, dtype=np.int64)
        for p in plans:
            for combo in np.ndindex(*(len(d) for d in p.runs[n])):
                cover[tuple(slice(*p.runs[n][i][j])
                            for i, j in enumerate(combo))] += 1
        mode = plans[0].modes[n]
        if mode == "disjoint":
            assert (cover == 1).all(), n
        elif mode == "partial":
            assert (cover >= 1).all() and (cover > 1).any(), n
        else:
            assert (cover == m).all(), n
        assert all(p.shape(n) == tuple(
            sum(b - a for a, b in d) for d in p.runs[n]) for p in plans)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_a_model_dim_of_one_splits_nothing(arch):
    shapes, (p,) = _plans(arch, 1)
    assert not p.splits
    assert set(p.modes.values()) == {"identical"}
    assert all(p.shape(n) == s for n, s in shapes.items())
