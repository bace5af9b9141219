"""The port's meta-device dry-run (``launch/dryrun.py``) on a few cells:
llama3-8b ``train_4k`` and ``decode_32k``, mamba2 ``long_500k``,
tinyllama's ``long_500k`` skipped with the reference's reason, and an MoE
prefill. Each traced cell has finite FLOPs within a stated factor of
``model_flops`` and per-card bytes equal to the reference's fitted shards
summed (its specs, on the same stand-in production mesh). Its roofline,
from rank 0's split step on the production mesh's stand-in, has finite
per-device FLOPs, bytes and collective bytes, each term their quotient
by the card's rate, the bottleneck their argmax, and ``fits_hbm`` from
what the rank holds plus its peak live bytes; the multi-pod decode cell
moves bytes over ``"model"``. The kernel wrappers take their plain
versions on meta tensors, where nothing launches; the CLI writes under
``build/archive/`` only."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import build as ref_build  # noqa: E402

from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import HW, make_production_mesh  # noqa: E402

# Traced FLOPs over model_flops: the plain attention counts every score
# (train and prefill), a decode step reads its whole cache (an O(S) term
# that 2 N per token leaves out), and remat runs each block's forward
# twice. The bars hold each cell to a factor of three either way.
FLOP_FACTOR = 3.0
CELLS = [("llama3_8b", "train_4k", False), ("llama3_8b", "decode_32k", True),
         ("mamba2_2_7b", "long_500k", False),
         ("olmoe_1b_7b", "prefill_32k", False)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _ref_param_bytes(arch: str, multi_pod: bool) -> int:
    """Bytes a card holds of the float32 masters under the reference's
    fitted specs."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    model = ref_build(ref_configs.get_config(arch))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    specs = ref_sharding.param_specs(model.axes(),
                                     ref_sharding.ShardingRules.create(mesh))
    sizes = mesh.shape
    total = 0
    for spec, s in zip(_leaves(specs), _leaves(shapes)):
        fit = ref_steps._fit_spec(spec, s.shape, mesh)
        n = 1
        for d, e in zip(s.shape, tuple(fit) + (None,) * len(s.shape)):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            n *= d // int(np.prod([sizes[a] for a in axes]))
        total += 4 * n
    return total


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_cells_trace_on_meta(arch, shape, multi_pod):
    LAUNCHES.clear()
    rec = dryrun.lower_cell(arch, shape, multi_pod=multi_pod)
    assert not LAUNCHES            # the plain versions, no kernel
    assert rec["status"] == "ok"
    assert rec["chips"] == (512 if multi_pod else 256)
    flops, mf = rec["traced_flops"], rec["model_flops"]
    assert np.isfinite(flops) and flops > 0
    assert mf / FLOP_FACTOR <= flops <= mf * FLOP_FACTOR, flops / mf
    assert rec["useful_flops_ratio"] == mf / flops
    assert rec["traced_flops_per_device"] == flops / rec["chips"]
    b = rec["bytes_per_device"]
    assert b["params"] == _ref_param_bytes(arch, multi_pod)
    if shape == "train_4k":
        assert rec["n_microbatches"] == 4
        assert b["opt_state"] == 2 * b["params"] + 4
    assert b["total"] == sum(v for k, v in b.items() if k != "total")
    assert rec["fits_hbm"] == (b["total"] < HW.HBM_BYTES)
    assert rec["trace_s"] > 0
    # the roofline of rank 0's split step
    coll = rec["collective_bytes"]
    assert set(coll) == {"all-reduce", "all-gather", "reduce-scatter",
                         "all-to-all", "collective-permute", "total"}
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    for key in ("flops", "bytes", "compute_s", "memory_s", "collective_s",
                *coll.values()):
        v = rec[key] if isinstance(key, str) else key
        assert np.isfinite(v) and v >= 0, key
    assert rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["compute_s"] == rec["flops"] / HW.PEAK_FLOPS_BF16
    assert rec["memory_s"] == rec["bytes"] / HW.HBM_BW
    assert rec["collective_s"] == coll["total"] / HW.NVLINK_BW
    terms = {k: rec[k] for k in ("compute_s", "memory_s", "collective_s")}
    assert rec["bottleneck"] == max(terms, key=terms.get)
    rb = rec["rank_bytes"]
    assert rb["held"] > 0 and rb["peak"] > 0
    assert rb["total"] == rb["held"] + rb["peak"]
    assert rec["fits_hbm"] == (rb["total"] < HW.HBM_BYTES)
    assert "NVLink" in rec["collective_domain"]
    assert ("crosses 2 domains" in rec["collective_domain"]) \
        == (make_production_mesh(multi_pod=multi_pod).shape["model"] > 8)
    if shape == "decode_32k" and multi_pod:
        assert rec["collective_s"] > 0


def test_full_attention_long_500k_is_skipped_with_the_reference_s_reason():
    rec = dryrun.lower_cell("tinyllama_1_1b", "long_500k")
    ok, why = ref_configs.supports(ref_configs.get_config("tinyllama_1_1b"),
                                   "long_500k")
    assert not ok
    assert rec["status"] == "skipped" and rec["reason"] == why


def test_wrappers_take_the_plain_versions_on_meta():
    q = torch.empty(1, 8, 2, 16, device="meta")
    assert ops.flash_attention(q, q, q).device.type == "meta"
    x = torch.empty(1, 8, 2, 4, device="meta")
    dt = torch.empty(1, 8, 2, device="meta")
    B = torch.empty(1, 8, 1, 3, device="meta")
    y, state = ops.ssd(x, dt, torch.empty(2, device="meta"), B, B, chunk=4)
    assert y.shape == x.shape and state.shape == (1, 2, 4, 3)


def test_cli_writes_under_the_archive_only(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARCHIVE", tmp_path / "archive")
    dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "long_500k",
                 "--both-meshes", "--out", "cells.jsonl"])
    lines = (tmp_path / "archive" / "cells.jsonl").read_text().splitlines()
    assert [json.loads(x)["multi_pod"] for x in lines] == [False, True]
    assert capsys.readouterr().out == ""
    for bad in ("../benchmarks/roofline_cache.json", "/tmp/x.jsonl"):
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "long_500k",
                         "--out", bad])
    dryrun.main(["--arch", "mamba2_2_7b", "--shape", "decode_32k"])
    rec = json.loads(capsys.readouterr().out.splitlines()[0])
    assert rec["status"] == "ok" and rec["chips"] == 256
