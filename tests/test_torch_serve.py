"""The port's serving slice against the reference's LM substrate: the smoke
configs of every ported architecture (the dense, MoE and vision decoders,
the SSD stack, the Hymba hybrid, the encoder-decoder), the reference's
weights carried across by ``interop.params_from_reference``,
inputs made with numpy from a seed. Bars: 1e-4 in float32, and the
reference's own 2e-2 in bfloat16 (``tests/test_arch_smoke.py``); the port's
prefill attention scores are float32 where the reference's dense path keeps
them in bfloat16, which the bfloat16 bar allows."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.launch.serve import serve_requests as ref_serve  # noqa: E402
from repro.models import build as ref_build  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCH_NAMES, PORTED, get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@functools.cache
def _ref_params(arch: str):
    """The reference's init of the smoke config (float32 masters, the same
    for every activation dtype)."""
    return jax.jit(ref_build(ref_smoke_config(arch)).init)(
        jax.random.PRNGKey(0))


def _models(arch: str, dtype: str):
    """(reference cfg, model, params; port cfg, state dict) with one set of
    weights: the reference's init, carried across."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    params = _ref_params(arch)
    state = interop.params_from_reference(cfg, jax.tree.map(np.asarray,
                                                            params))
    return rcfg, ref_build(rcfg), params, cfg, state


def _port(cfg, state):
    model = build(cfg, "cpu")
    model.load_state_dict(state)
    return model


def _close(got, ref, dtype, bf16_values=False):
    """float32: elementwise at 1e-4, or within one bfloat16 ulp for values
    that were rounded to bfloat16 (the decoder's cache: float32 keys 1e-6
    apart may round to neighbouring bfloat16 values). bfloat16: relative
    RMS error at 2e-2."""
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=TOL[dtype],
                                   rtol=2.0 ** -7 if bf16_values else TOL[dtype])
        return
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))  # noqa: E731
    assert rms(got - ref) <= TOL[dtype] * rms(ref)


def _batch(cfg, toks):
    """A prefill batch of numpy arrays: the tokens, and for the
    encoder-decoder seeded non-zero frames (the serve's stub frames are
    zeros, which would leave the encoder and cross attention unchecked),
    for the vlm seeded patch embeddings (``tests/test_arch_smoke.py``)."""
    batch = {"tokens": toks}
    if cfg.kind == "encdec":
        batch["frames"] = np.random.default_rng(5).normal(
            size=(toks.shape[0], 8, cfg.d_model)).astype(np.float32)
    if cfg.kind == "vlm":
        batch["vision"] = (np.random.default_rng(5).normal(
            size=(toks.shape[0], cfg.frontend_len, cfg.d_model))
            * 0.02).astype(np.float32)
    return batch


def _f32_cache(cfg) -> bool:
    """Whether the float32 model decodes from a float32-cast cache: the
    reference cannot write a float32 key into the decoders' and the
    encoder-decoder's bfloat16 caches (the hybrid casts the key itself)."""
    return cfg.kind in ("decoder", "moe", "vlm", "encdec") \
        and cfg.dtype == "float32"


def _patches(cfg) -> int:
    """The vlm's patch positions in front of the prompt."""
    return cfg.frontend_len if cfg.kind == "vlm" else 0


def _decode_pos(cfg, toks) -> int:
    """The first decode position: after the prompt, the hybrid's meta tokens
    and the vlm's patches."""
    return toks.shape[1] + cfg.n_meta_tokens + _patches(cfg)


def _run_ref(rcfg, params, toks, nxt):
    ref = ref_build(rcfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(rcfg, toks).items()}
    lg, cache = ref.prefill(params, batch, max_len=30 + _patches(rcfg))
    if _f32_cache(rcfg):
        cache = jax.tree.map(lambda a: a.astype(jnp.float32), cache)
    lg2, cache2 = ref.decode(params, cache, jnp.asarray(nxt),
                             _decode_pos(rcfg, toks))
    return lg, lg2, cache2


def _run_port(cfg, state, toks, nxt):
    model = _port(cfg, state)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, toks).items()}
    lg, cache = model.prefill(batch, max_len=30 + _patches(cfg))
    if _f32_cache(cfg):
        cache = {k: v.float() for k, v in cache.items()}
    lg2, cache2 = model.decode(cache, torch.from_numpy(nxt),
                               _decode_pos(cfg, toks))
    return lg, lg2, cache2


def _bf16_valued(cfg, key) -> bool:
    """Cache entries rounded to bfloat16 on both sides: keys, values and the
    hybrid's conv state (every family but the SSD stack)."""
    return cfg.kind != "ssm" and key in ("k", "v", "cross_k", "cross_v",
                                         "conv")


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits, one teacher-forced decode step and the caches after
    it. The reference cannot write a float32 key into its bfloat16 decoder
    and encoder-decoder caches, so those float32 models decode, on both
    sides, from their prefill cache cast to float32.

    In bfloat16 an elementwise 2e-2 bar does not hold between the two
    implementations: the reference's own bfloat16 logits leave its float32
    logits by up to 0.048 (44 of 1024 above 2e-2 at this input), and the
    port's attention scores are float32 where the reference's dense path
    rounds them to bfloat16. The bar there is 2e-2 of the RMS (measured
    1.0e-2)."""
    rcfg, _, params, cfg, state = _models(arch, dtype)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24),
                                             dtype=np.int32)
    nxt = toks[:, 5:6]
    want = _run_ref(rcfg, params, toks, nxt)
    got = _run_port(cfg, state, toks, nxt)
    assert got[0].shape == want[0].shape == (2, 1, cfg.vocab)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, dtype)
    assert sorted(got[2]) == sorted(want[2])
    for key in want[2]:
        _close(got[2][key], want[2][key], dtype,
               bf16_values=_bf16_valued(cfg, key))


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_reference(arch):
    rcfg, ref, params, cfg, state = _models(arch, "float32")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 20),
                                             dtype=np.int32)
    batch = _batch(cfg, toks)
    lg, aux = ref.forward(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    with torch.no_grad():
        lg_t, aux_t = _port(cfg, state)({k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    _close(lg_t, lg, "float32")
    # The MoE's summed load-balance value; zero for the other families.
    np.testing.assert_allclose(float(aux_t), float(aux), rtol=1e-5, atol=1e-5)
    assert (float(aux_t) > 0) == (cfg.kind == "moe")


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_matches_forward(arch):
    """The reference's own check (``tests/test_arch_smoke.py``), on the
    port in bfloat16 at its bar: prefill's last logits equal forward's."""
    cfg = smoke_config(arch)
    model = _port(cfg, _models(arch, "bfloat16")[4])
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 32),
                                             dtype=np.int32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, toks).items()}
    with torch.no_grad():
        logits_f, _ = model(batch)
    logits_p, _ = model.prefill(batch, max_len=40)
    np.testing.assert_allclose(logits_p[:, -1].float().numpy(),
                               logits_f[:, -1].float().numpy(), atol=2e-2,
                               rtol=2e-2)


def _prompts(cfg, n=5, S=16):
    return np.random.default_rng(2).integers(0, cfg.vocab, (n, S),
                                             dtype=np.int32)


def test_serve_ssm_float32_equals_reference():
    """Groups of 2 with a zero-padded last group, greedy tokens: equal."""
    rcfg, _, params, cfg, state = _models("mamba2_2_7b", "float32")
    prompts = _prompts(cfg)
    ref_out, ref_stats = ref_serve(rcfg, prompts, 2, 6, params=params)
    out, stats = serve.serve_requests(cfg, prompts, 2, 6, params=state,
                                      device="cpu")
    np.testing.assert_array_equal(out, ref_out)
    assert out.dtype == ref_out.dtype and sorted(stats) == sorted(ref_stats)
    assert stats["requests"] == 5 and stats["wall_s"] > 0


def test_serve_decoder_bfloat16_matches_reference_up_to_knife_edges():
    """The reference serves a decoder only in bfloat16 (its float32 decode
    refuses to write the bfloat16 cache). There the port's float32 scores
    may flip a greedy pick where the reference's two best logits lie within
    two bfloat16 ulps; each request's tokens must be equal up to its first
    such step, which is found by replaying the reference's own greedy
    loop."""
    rcfg, ref, params, cfg, state = _models("tinyllama_1_1b", "bfloat16")
    prompts = _prompts(cfg, n=3)
    n, S = prompts.shape
    batch, max_new = 2, 6
    ref_out, ref_stats = ref_serve(rcfg, prompts, batch, max_new,
                                   params=params)
    out, stats = serve.serve_requests(cfg, prompts, batch, max_new,
                                      params=state, device="cpu")
    assert out.shape == ref_out.shape and sorted(stats) == sorted(ref_stats)
    knife = np.full(n, max_new)
    decode = jax.jit(ref.decode)
    for g in range(0, n, batch):
        ids = list(range(g, min(g + batch, n)))
        toks = np.zeros((batch, S), np.int32)
        toks[:len(ids)] = prompts[ids]
        lg, cache = ref.prefill(params, {"tokens": jnp.asarray(toks)},
                                max_len=S + max_new)
        for t in range(max_new):
            logits = np.asarray(lg[:, -1], np.float32)[:len(ids)]
            top2 = np.sort(logits, axis=-1)[:, -2:]
            ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[:, 1]))) - 7)
            edge = top2[:, 1] - top2[:, 0] <= 2 * ulp
            knife[ids] = np.where(edge & (knife[ids] == max_new), t,
                                  knife[ids])
            np.testing.assert_array_equal(logits.argmax(-1), ref_out[ids, t])
            nxt = np.zeros((batch, 1), np.int32)
            nxt[:len(ids), 0] = ref_out[ids, t]
            lg, cache = decode(params, cache, jnp.asarray(nxt),
                               jnp.int32(S + t))
    for i in range(n):
        np.testing.assert_array_equal(out[i, :knife[i]], ref_out[i, :knife[i]])
    assert (knife > 0).all()


def test_serve_main_on_the_cpu(capsys):
    stats = serve.main(["--arch", "mamba2_2_7b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch", "2", "--prompt-len",
                        "8", "--max-new", "3"])
    assert stats["requests"] == 3
    assert "first completion" in capsys.readouterr().out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    return {path: tree}


def _stacks(cfg) -> dict:
    """The reference's per-layer stacks and their layer counts."""
    return {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
            "dec_layers": cfg.n_layers}


@pytest.mark.parametrize("arch", PORTED)
def test_full_width_parameters_match_reference(arch):
    """The published configs: the port's parameters (on the meta device, no
    memory) have the names and shapes of the reference's abstract init."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    shapes = jax.eval_shape(ref_build(rcfg).init, jax.random.PRNGKey(0))
    want = {}
    for path, leaf in _flat(shapes).items():
        if path[0] in _stacks(cfg):
            for i in range(_stacks(cfg)[path[0]]):
                want[".".join((path[0], str(i)) + path[1:])] = leaf.shape[1:]
        else:
            want[".".join(path)] = leaf.shape
    got = {k: tuple(v.shape) for k, v in build(cfg, "meta").state_dict().items()}
    assert got == want
    if arch == "tinyllama_1_1b":
        assert 1.09e9 < sum(int(np.prod(s)) for s in got.values()) < 1.11e9


def test_entry_points_default_to_the_gpu(no_gpu):
    cfg = smoke_config("mamba2_2_7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_requests(cfg, _prompts(cfg, 2, 4), 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "tinyllama_1_1b", "--smoke"])


def test_unported_architectures_and_features_raise():
    """Every architecture of the reference is ported; a windowed decoder
    and an unknown architecture still raise."""
    assert sorted(PORTED) == sorted(ARCH_NAMES)
    for arch in ARCH_NAMES:
        build(get_config(arch), "meta")
    with pytest.raises(ValueError, match="unknown arch"):
        smoke_config("gpt2")
    windowed = dataclasses.replace(smoke_config("tinyllama_1_1b"), window=8)
    with pytest.raises(NotImplementedError, match="A11"):
        build(windowed, "cpu")
    with pytest.raises(ValueError, match="layers"):
        interop.params_from_reference(smoke_config("mamba2_2_7b"),
                                      {"layers": {"ln": np.ones((3, 64))}})
