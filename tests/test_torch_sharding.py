"""The port's sharding rules, shardings, compression arithmetic, registry
and variants against the reference's, on the CPU, without devices.

Specs: every architecture at full width (shapes from ``jax.eval_shape``
on the reference's side, ``meta`` tensors on the port's), on 2x2, 16x16
and 2x16x16 stand-in meshes (an object with ``axis_names`` and ``shape``,
which the reference's ``ShardingRules.create`` and ``_fit_spec`` accept
too): each parameter's fitted spec is the reference's with its stack's
``"layers"`` entry dropped; the cache's and each mode's batch's are the
reference's. ``tests/test_substrate.py``'s ``TestShardingRules`` and
``TestCompression`` on the port; ``quantize_ef``/``dequantize`` bit for
bit; ``input_specs``, ``supports`` and ``model_flops`` over all 40 cells;
``VARIANTS`` and what each variant gives every cell."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch import variants as ref_variants  # noqa: E402
from repro.models import build as ref_build  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    DEFAULT_RULES, ShardingRules, logical_to_spec, param_specs)
from repro_torch.distributed.compression import dequantize, quantize_ef  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import steps as step_lib  # noqa: E402
from repro_torch.launch.dryrun import model_flops  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh  # noqa: E402
from repro_torch.launch.variants import VARIANTS  # noqa: E402
from repro_torch.models import build  # noqa: E402

MESHES = {"2x2": AbstractMesh(("data", "model"), (2, 2)),
          "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
STACKS = ("layers", "enc_layers", "dec_layers")
DECODE = (8, 4096)        # a decode cache's batch and length
ENC_LEN = 4096


@functools.cache
def _ref_shapes(arch: str):
    model = ref_build(ref_configs.get_config(arch))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.cache
def _port_model(arch: str):
    return build(configs.get_config(arch), "meta")


def _leaves(tree, path=()):
    """(path, leaf) of nested dicts, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _ref_fitted(mesh, specs, shapes) -> dict:
    """The reference's fitted spec of each leaf, as tuples, by path."""
    spec_by = dict(_leaves(specs))
    return {p: tuple(ref_steps._fit_spec(spec_by[p], s.shape, mesh))
            for p, s in _leaves(shapes)}


def _port_fitted(mesh, specs, shapes) -> dict:
    return {n: tuple(s.spec) for n, s in
            step_lib.fitted(mesh, specs, shapes).items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_are_the_reference_s_without_layers(arch, mesh):
    m = MESHES[mesh]
    ref_model, ref_shapes = _ref_shapes(arch)
    ref = _ref_fitted(m, ref_sharding.param_specs(
        ref_model.axes(), ref_sharding.ShardingRules.create(m)), ref_shapes)
    model = _port_model(arch)
    shapes = {n: p for n, p in model.named_parameters()}
    axes = model.axes()
    assert set(axes) == set(shapes)
    specs = param_specs(axes, ShardingRules.create(m))
    port = _port_fitted(m, {n: specs[n] for n in shapes}, shapes)
    want = {}
    for path, spec in ref.items():
        if path[0] in STACKS:
            assert spec[0] is None, path     # the stack is never split
            for i in range(ref_shapes_dim(ref_shapes, path)):
                want[".".join((path[0], str(i)) + path[1:])] = spec[1:]
        else:
            want[".".join(path)] = spec
    assert port == want
    # a full-width model on a real mesh is split somewhere
    assert any(any(e is not None for e in s) for s in port.values())


def ref_shapes_dim(shapes, path) -> int:
    node = shapes
    for k in path:
        node = node[k]
    return node.shape[0]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_cache_and_batch_specs_are_the_reference_s(arch, mesh):
    m = MESHES[mesh]
    ref_model, _ = _ref_shapes(arch)
    model = _port_model(arch)
    rrules, rules = ref_sharding.ShardingRules.create(m), \
        ShardingRules.create(m)
    kw = {"enc_len": ENC_LEN} if model.cfg.kind == "encdec" else {}
    ref_cache = jax.eval_shape(lambda: ref_model.init_cache(*DECODE, **kw))
    cache = model.init_cache(*DECODE, *kw.values())
    assert {k: tuple(v.shape) for k, v in cache.items()} \
        == {k: tuple(v.shape) for k, v in ref_cache.items()}
    ref = _ref_fitted(m, ref_sharding.logical_to_spec(
        rrules, ref_model.cache_axes()), ref_cache)
    port = _port_fitted(m, logical_to_spec(rules, model.cache_axes()), cache)
    assert port == {p[0]: s for p, s in ref.items()}
    for shape in configs.SHAPES.values():
        mode = shape.mode
        ref_b = ref_configs.input_specs(ref_model.cfg, shape)
        ref = _ref_fitted(m, ref_sharding.logical_to_spec(
            rrules, ref_steps.batch_axes_tree(ref_model, mode)), ref_b)
        port = _port_fitted(m, logical_to_spec(
            rules, step_lib.batch_axes_tree(model, mode)),
            configs.input_specs(model.cfg, shape))
        assert port == {p[0]: s for p, s in ref.items()}, mode


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "olmoe_1b_7b",
                                  "hymba_1_5b"])
def test_shard_shapes_tile_each_parameter(arch):
    """Every position's block has the shard shape, and the blocks of the
    positions that differ on the spec's axes tile the parameter."""
    m = MESHES["2x2"]
    model = _port_model(arch)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = param_specs(model.axes(), ShardingRules.create(m))
    for n, s in step_lib.fitted(m, {k: specs[k] for k in shapes},
                                shapes).items():
        cover = np.zeros(shapes[n], dtype=np.int64) if \
            np.prod(shapes[n]) < 2e6 else None
        seen = set()
        for d in range(2):
            for mm in range(2):
                blk = s.block(shapes[n], {"data": d, "model": mm})
                assert tuple(b.stop - b.start for b in blk) \
                    == s.shard_shape(shapes[n])
                key = tuple((b.start, b.stop) for b in blk)
                if cover is not None and key not in seen:
                    cover[blk] += 1
                seen.add(key)
        if cover is not None:
            assert (cover == 1).all(), n


class TestShardingRules:
    """``tests/test_substrate.py::TestShardingRules`` on the port."""

    def test_duplicate_mesh_axes_dropped(self):
        r = ShardingRules.create(None)
        # no mesh: everything replicated
        assert r.spec("batch", "seq") == P(None, None)

    def test_fit_spec_divisibility(self):
        mesh = AbstractMesh(("data", "model"), (1, 1))
        # with axis sizes 1 everything divides
        s = step_lib._fit_spec(P("data", "model"), (4, 4), mesh)
        assert s == P("data", "model")

    def test_rules_cover_all_logical_axes(self):
        for k in ("batch", "heads", "kv_heads", "d_ff", "vocab", "experts",
                  "fsdp", "cache_seq", "cache_batch"):
            assert k in DEFAULT_RULES


def test_default_rules_are_the_reference_s():
    assert DEFAULT_RULES == ref_sharding.DEFAULT_RULES


@pytest.mark.parametrize("overrides", [None, {"fsdp": ("pod", "data",
                                                       "model")},
                                       {"seq": "model"}])
def test_rule_specs_are_the_reference_s(overrides):
    logical = [("batch", "seq", "heads"), ("fsdp", "vocab"),
               ("decode_batch", None), ("fsdp", "heads", "vocab"),
               ("cache_batch", "cache_seq", None, None), (None,),
               ("experts", "fsdp", None), ("unknown", "batch")]
    for m in (None, *MESHES.values()):
        ref = ref_sharding.ShardingRules.create(m, overrides)
        port = ShardingRules.create(m, overrides)
        for axes in logical:
            assert tuple(port.spec(*axes)) == tuple(ref.spec(*axes)), axes


def test_fit_spec_is_the_reference_s():
    m = MESHES["2x16x16"]
    for spec in (P(("pod", "data"), "model"), P("model", None),
                 P(("pod", "data", "model"),), P(None, ("data", "model"))):
        for shape in ((32, 64), (4, 16), (2, 3), (512, 8), (6, 48)):
            assert tuple(step_lib._fit_spec(spec, shape, m)) == tuple(
                ref_steps._fit_spec(spec, shape, m)), (spec, shape)


def test_constrain_returns_its_input():
    from repro_torch.distributed import constrain
    x = torch.ones(2, 3)
    rules = ShardingRules.create(MESHES["2x2"])
    assert constrain(x, rules, "batch", None) is x
    assert constrain(x, None, "batch", None) is x


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_quantize_ef_is_the_reference_s_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    shape = [(256,), (17, 33), (4, 8, 16), (1,)][seed]
    scale = [1.0, 1e-4, 30.0, 1e-20][seed]
    g = (rng.normal(size=shape) * scale).astype(np.float32)
    err = (rng.normal(size=shape) * scale * 0.01).astype(np.float32)
    for _ in range(3):        # the residual carries over
        q, s, e = quantize_ef(torch.from_numpy(g), torch.from_numpy(err))
        rq, rs, re = ref_comp.quantize_ef(jnp.asarray(g), jnp.asarray(err))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(e.numpy(), np.asarray(re))
        np.testing.assert_array_equal(
            dequantize(q, s).numpy(), np.asarray(ref_comp.dequantize(rq, rs)))
        err = e.numpy()


class TestCompression:
    """``tests/test_substrate.py::TestCompression`` on the port."""

    def test_error_feedback_is_unbiased_over_steps(self):
        rng = np.random.default_rng(0)
        g = torch.as_tensor(rng.normal(size=(256,)), dtype=torch.float32)
        err = torch.zeros_like(g)
        total_q = torch.zeros_like(g)
        n = 50
        for _ in range(n):
            q, scale, err = quantize_ef(g, err)
            total_q += dequantize(q, scale)
        # time-averaged dequantized signal converges to g (EF property)
        np.testing.assert_allclose((total_q / n).numpy(), g.numpy(),
                                   atol=1e-2)

    def test_quantization_error_bounded(self):
        g = torch.as_tensor(np.linspace(-5, 5, 100), dtype=torch.float32)
        q, scale, err = quantize_ef(g, torch.zeros_like(g))
        assert float(err.abs().max()) <= float(scale) / 2 + 1e-6


def test_compressed_psum_tree_off_a_mesh_is_the_rounded_mean():
    """Without a process group the dim is this process: the mean of one
    participant is its own dequantized levels."""
    from repro_torch.distributed import compressed_psum_tree
    from repro_torch.obs import compiled

    rng = np.random.default_rng(3)
    g = {"a": torch.as_tensor(rng.normal(size=(5, 7)), dtype=torch.float32)}
    e = {"a": torch.zeros(5, 7)}
    compiled.reset_collectives()
    with compiled.program("compress.test"):
        mean, new_e = compressed_psum_tree(g, e, None, "data")
    q, s, err = quantize_ef(g["a"], e["a"])
    assert torch.equal(mean["a"], dequantize(q, s))
    assert torch.equal(new_e["a"], err)
    assert compiled.collective_counts("compress.test")["all-reduce"] == 2


# ---------------------------------------------------------------------------
# registry and variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", configs.SHAPES)
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_cells_are_the_reference_s(arch, shape):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert configs.SHAPES[shape] .__dict__ \
        == ref_configs.SHAPES[shape].__dict__
    assert configs.supports(cfg, shape) == ref_configs.supports(rcfg, shape)
    got = configs.input_specs(cfg, shape)
    want = ref_configs.input_specs(rcfg, shape)
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
    from repro.launch.dryrun import model_flops as ref_model_flops
    assert model_flops(cfg, configs.SHAPES[shape]) \
        == ref_model_flops(rcfg, ref_configs.SHAPES[shape])


def test_configs_names_are_the_reference_s():
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    assert set(configs.PORTED) == set(configs.ARCH_NAMES)


@pytest.mark.parametrize("variant", sorted(ref_variants.VARIANTS))
def test_variants_are_the_reference_s(variant):
    assert list(VARIANTS) == list(ref_variants.VARIANTS)
    for arch in configs.ARCH_NAMES:
        for shape in configs.SHAPES:
            ov, cfg = VARIANTS[variant](configs.get_config(arch),
                                        configs.SHAPES[shape])
            rov, rcfg = ref_variants.VARIANTS[variant](
                ref_configs.get_config(arch), ref_configs.SHAPES[shape])
            assert ov == rov
            assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
