"""The port's Hymba hybrid and encoder-decoder against the reference, past
what ``tests/test_torch_serve.py``'s per-architecture parity covers: the
attention masks and the SSD mixer as modules, the hybrid's ring cache
decoded past its wrap, the encoder-decoder's cross attention on non-zero
frames of either length, the stacks ``params_from_reference`` carries, and
greedy serving. The reference's weights come across by
``interop.params_from_reference``, inputs from numpy seeds. Bars: 1e-4 in
float32, 2e-2 of the RMS in bfloat16 (``tests/test_torch_serve.py``)."""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.launch.serve import serve_requests as ref_serve  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import layers as ref_ll  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import layers as ll  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FAMILIES = ("hymba_1_5b", "seamless_m4t_medium")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.cache
def _ref_params(arch: str):
    return jax.tree.map(np.asarray, jax.jit(ref_build(
        ref_smoke_config(arch)).init)(jax.random.PRNGKey(0)))


def _models(arch: str, dtype: str):
    """(reference cfg, reference model, params; port model) with the
    reference's init carried across."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    params = _ref_params(arch)
    model = build(cfg, "cpu")
    model.load_state_dict(interop.params_from_reference(cfg, params))
    return rcfg, ref_build(rcfg), params, model


def _close(got, ref, dtype, bf16_values=False):
    """float32: elementwise at 1e-4 (one bfloat16 ulp for values rounded to
    bfloat16); bfloat16: relative RMS at 2e-2."""
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(
            got, ref, atol=TOL[dtype],
            rtol=2.0 ** -7 if bf16_values else TOL[dtype])
        return
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))  # noqa: E731
    assert rms(got - ref) <= TOL[dtype] * rms(ref)


# --------------------------------------------------------------------------
# layers: every attention mode the models use
# --------------------------------------------------------------------------

def _attn_weights(cfg, seed):
    rng = np.random.default_rng(seed)
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    shapes = {"wq": (D, H, dh), "wk": (D, K, dh), "wv": (D, K, dh),
              "wo": (H, dh, D)}
    w = {k: (rng.normal(size=sh) / np.sqrt(sh[0])).astype(np.float32)
         for k, sh in shapes.items()}
    port = types.SimpleNamespace(bq=None, bk=None, bv=None, **{
        k: torch.from_numpy(v) for k, v in w.items()})
    return {k: jnp.asarray(v) for k, v in w.items()}, port


ATTN_MODES = {
    "causal": dict(causal=True),
    "window_prefix": dict(causal=True, window=12, prefix_len=5),
    "non_causal": dict(causal=False),
    "cross_shorter": dict(kv_len=9),
    "cross_longer": dict(kv_len=53),
}


@pytest.mark.parametrize("mode", sorted(ATTN_MODES))
def test_attention_modes_match_reference(mode):
    """``layers.attention`` (the flash kernel's plain version here) against
    the reference's dense path, float32, with its (k, v)."""
    cfg = dataclasses.replace(smoke_config("hymba_1_5b"), dtype="float32")
    ref_p, p = _attn_weights(cfg, 7)
    kw = dict(ATTN_MODES[mode])
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 30, cfg.d_model)).astype(np.float32)
    if "kv_len" in kw:
        kw["kv_source"] = rng.normal(
            size=(2, kw.pop("kv_len"), cfg.d_model)).astype(np.float32)
    kw.setdefault("window", 0)
    want, (wk, wv) = ref_ll.attention(
        jnp.asarray(x), ref_p, cfg, None, return_kv=True,
        **{k: jnp.asarray(v) if k == "kv_source" else v
           for k, v in kw.items()})
    got, (gk, gv) = ll.attention(
        torch.from_numpy(x), p, cfg, return_kv=True,
        **{k: torch.from_numpy(v) if k == "kv_source" else v
           for k, v in kw.items()})
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w, "float32")


@pytest.mark.parametrize("mode", ["linear", "ring", "cross"])
def test_attention_decode_modes_match_reference(mode):
    """``layers.attention_decode``: a linear cache, a ring cache past its
    wrap (the slot and the mask passed in, as the hybrid passes its own,
    against the reference's windowed slot pos % S_max) and cross attention
    (no write, every key valid), float32 caches on both sides."""
    cfg = dataclasses.replace(smoke_config("hymba_1_5b"), dtype="float32")
    ref_p, p = _attn_weights(cfg, 9)
    rng = np.random.default_rng(10)
    S_max, pos = 16, (11 if mode == "linear" else 21)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.normal(size=(2, S_max, cfg.n_kv_heads, cfg.dh)).astype(
        np.float32) for _ in range(2))
    kw = dict(window=8 if mode == "ring" else 0, cross=mode == "cross")
    want, wk, wv = ref_ll.attention_decode(
        jnp.asarray(x), ref_p, jnp.asarray(ck), jnp.asarray(cv), pos, cfg,
        None, **kw)
    gk, gv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    if kw.pop("window"):
        kw.update(slot=pos % S_max, valid=torch.ones(S_max, dtype=torch.bool))
    got = ll.attention_decode(torch.from_numpy(x), p, gk, gv, pos, cfg, **kw)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w, "float32")
    if mode == "cross":
        assert torch.equal(gk, torch.from_numpy(ck))


# --------------------------------------------------------------------------
# ssm: the SSD mixer at the hybrid's dims
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(TOL))
def test_ssd_mixer_at_hybrid_dims_matches_reference(dtype):
    """``ssm._mix`` with the hybrid's config and its layer-0 SSM weights:
    a prefill with a ragged last chunk, then one step from its states."""
    rcfg, _, params, model = _models("hymba_1_5b", dtype)
    lp = model.layers[0].ssm
    ref_lp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                          params["layers"]["ssm"])
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 37, rcfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, rcfg.d_model)).astype(np.float32)
    dt = getattr(jnp, dtype)
    want = ref_ssm._mix(jnp.asarray(x, dt), ref_lp, rcfg, None)
    with torch.no_grad():
        got = ssm._mix(torch.from_numpy(x).to(getattr(torch, dtype)), lp,
                       model.cfg)
        step = ssm._mix(torch.from_numpy(x1).to(getattr(torch, dtype)), lp,
                        model.cfg, conv_state=got[1].to(torch.bfloat16),
                        ssd_state=got[2], step=True)
    want_step = ref_ssm._mix(jnp.asarray(x1, dt), ref_lp, rcfg, None,
                             conv_state=want[1].astype(jnp.bfloat16),
                             ssd_state=want[2], step=True)
    for g, w in zip(got + step, want + want_step):
        _close(g, w, dtype)


# --------------------------------------------------------------------------
# hybrid: the ring cache past its wrap
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(TOL))
def test_hybrid_decodes_past_ring_wrap(dtype):
    """hymba's smoke config (window 32, 8 meta tokens) on a 40-token prompt,
    the serve's cache (max_len prompt + new + meta), then 6 teacher-forced
    steps: the ring wraps in the prefill and again while decoding. Logits
    at every step, then slot_pos, k, v, conv and ssd."""
    rcfg, ref, params, model = _models("hymba_1_5b", dtype)
    M, steps = rcfg.n_meta_tokens, 6
    toks = np.random.default_rng(12).integers(0, rcfg.vocab, (2, 40),
                                              dtype=np.int32)
    max_len = toks.shape[1] + steps + M
    lg, cache = ref.prefill(params, {"tokens": jnp.asarray(toks)},
                            max_len=max_len)
    lg_t, cache_t = model.prefill({"tokens": torch.from_numpy(toks)},
                                  max_len=max_len)
    assert cache_t["k"].shape[2] == M + rcfg.window
    _close(lg_t, lg, dtype)
    decode = jax.jit(ref.decode)
    for t in range(steps):
        nxt = toks[:, t:t + 1]
        pos = toks.shape[1] + M + t
        lg, cache = decode(params, cache, jnp.asarray(nxt), pos)
        lg_t, cache_t = model.decode(cache_t, torch.from_numpy(nxt), pos)
        _close(lg_t, lg, dtype)
    assert sorted(cache_t) == sorted(cache)
    np.testing.assert_array_equal(cache_t["slot_pos"].numpy(),
                                  np.asarray(cache["slot_pos"]))
    assert (cache_t["slot_pos"][M:] >= toks.shape[1] + M + steps
            - rcfg.window).all()
    for key in ("k", "v", "conv", "ssd"):
        _close(cache_t[key], cache[key], dtype, bf16_values=key != "ssd")


# --------------------------------------------------------------------------
# encdec: cross attention on frames of either length
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_frames", [7, 45])
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_encdec_decodes_against_nonzero_frames(dtype, n_frames):
    """seamless's smoke config on a 24-token prompt with seeded frames
    shorter and longer than it: prefill logits, both caches, and 4
    teacher-forced steps. In float32 both sides decode from the prefill
    cache cast to float32 (the reference cannot write a float32 key into
    its bfloat16 cache)."""
    rcfg, ref, params, model = _models("seamless_m4t_medium", dtype)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, rcfg.vocab, (2, 24), dtype=np.int32)
    frames = rng.normal(size=(2, n_frames, rcfg.d_model)).astype(np.float32)
    lg, cache = ref.prefill(params, {"tokens": jnp.asarray(toks),
                                     "frames": jnp.asarray(frames)},
                            max_len=32)
    lg_t, cache_t = model.prefill({"tokens": torch.from_numpy(toks),
                                   "frames": torch.from_numpy(frames)},
                                  max_len=32)
    _close(lg_t, lg, dtype)
    assert cache_t["cross_k"].shape[2] == n_frames
    if dtype == "float32":
        cache = jax.tree.map(lambda a: a.astype(jnp.float32), cache)
        cache_t = {k: v.float() for k, v in cache_t.items()}
    for key in cache:
        _close(cache_t[key], cache[key], dtype, bf16_values=True)
    decode = jax.jit(ref.decode)
    for t in range(4):
        nxt = toks[:, t:t + 1]
        lg, cache = decode(params, cache, jnp.asarray(nxt), 24 + t)
        lg_t, cache_t = model.decode(cache_t, torch.from_numpy(nxt), 24 + t)
        _close(lg_t, lg, dtype)
    for key in cache:
        _close(cache_t[key], cache[key], dtype, bf16_values=True)


# --------------------------------------------------------------------------
# interop: the stacks and leaves the new families carry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_reference_carries_every_leaf(arch):
    """Every leaf of the reference's tree lands, row by row, on the port's
    parameter of that name; the hybrid's top-level ``meta`` and its ``ssm``
    subtrees, the encoder-decoder's ``enc_layers`` and ``dec_layers``."""
    cfg = smoke_config(arch)
    params = _ref_params(arch)
    state = interop.params_from_reference(cfg, params)
    assert sorted(state) == sorted(build(cfg, "meta").state_dict())
    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
              "dec_layers": cfg.n_layers}
    seen = 0

    def walk(node, path):
        nonlocal seen
        if isinstance(node, dict):
            for key, sub in node.items():
                walk(sub, path + (key,))
            return
        rows = range(stacks[path[0]]) if path[0] in stacks else [None]
        for i in rows:
            name = ".".join(path if i is None else (path[0], str(i))
                            + path[1:])
            want = node if i is None else node[i]
            np.testing.assert_array_equal(state[name].numpy(), want)
            seen += 1

    walk(params, ())
    assert seen == len(state)
    if arch == "hymba_1_5b":
        assert state["meta"].shape == (cfg.n_meta_tokens, cfg.d_model)
        assert "layers.1.ssm.A_log" in state
    else:
        assert "enc_layers.1.attn.wq" in state
        assert "dec_layers.1.cross.wo" in state
        short = {"enc_layers": {"ln1": np.ones((cfg.n_enc_layers + 1,
                                                cfg.d_model))}}
        with pytest.raises(ValueError, match="layers"):
            interop.params_from_reference(cfg, short)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _ref_greedy_f32_cache(rcfg, ref, params, prompts, batch, max_new):
    """The reference's greedy serve loop (zero frames) for a float32 model
    whose reference decode refuses its bfloat16 cache: each step decodes
    from the cache cast to float32 and rounds the new key and value back to
    bfloat16, as the port's bfloat16 cache stores them."""
    n, S = prompts.shape
    out = np.zeros((n, max_new), np.int32)
    decode = jax.jit(ref.decode)
    def cast(cache, dtype):
        return jax.tree.map(lambda a: a.astype(dtype), cache)

    for g in range(0, n, batch):
        ids = list(range(g, min(g + batch, n)))
        toks = np.zeros((batch, S), np.int32)
        toks[:len(ids)] = prompts[ids]
        lg, cache = ref.prefill(params, {
            "tokens": jnp.asarray(toks),
            "frames": jnp.zeros((batch, max(S // 4, 1), rcfg.d_model))},
            max_len=S + max_new)
        for t in range(max_new):
            token = np.asarray(jnp.argmax(lg[:, -1], -1), np.int32)[:, None]
            out[ids, t] = token[:len(ids), 0]
            if t + 1 < max_new:
                lg, cache = decode(params, cast(cache, jnp.float32),
                                   jnp.asarray(token), S + t)
                cache = cast(cache, jnp.bfloat16)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_float32_greedy_equals_reference(arch):
    """Groups of 2 with a zero-padded last group: the port's
    ``serve_requests`` tokens equal the reference's greedy tokens. hymba
    through the reference's ``serve_requests``; seamless through its
    greedy loop on a float32-cast cache (its ``serve_requests`` refuses a
    float32 model, ROADMAP queue C)."""
    rcfg, ref, params, model = _models(arch, "float32")
    cfg = model.cfg
    prompts = np.random.default_rng(14).integers(0, cfg.vocab, (5, 16),
                                                 dtype=np.int32)
    if cfg.kind == "hybrid":
        want, _ = ref_serve(rcfg, prompts, 2, 6, params=params)
    else:
        want = _ref_greedy_f32_cache(rcfg, ref, params, prompts, 2, 6)
    got, stats = serve.serve_requests(cfg, prompts, 2, 6,
                                      params=model.state_dict(),
                                      device="cpu")
    np.testing.assert_array_equal(got, want)
    assert stats["requests"] == 5 and stats["wall_s"] > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_main_on_the_cpu(arch, capsys):
    stats = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch", "2", "--prompt-len",
                        "12", "--max-new", "3"])
    assert stats["requests"] == 3
    assert "first completion" in capsys.readouterr().out


def test_serve_takes_the_callers_tensors(monkeypatch):
    """``serve_requests(params=...)`` serves from the caller's tensors
    without a copy (one set of weights on the device), and a state dict of
    the port's seeded init serves the tokens of ``seed``; a bfloat16 one
    becomes float32 masters."""
    cfg = smoke_config("hymba_1_5b")
    model = build(cfg, "cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    state = model.state_dict()
    built = []
    monkeypatch.setattr(serve, "build",
                        lambda *a: built.append(build(*a)) or built[-1])
    prompts = np.random.default_rng(15).integers(0, cfg.vocab, (2, 6),
                                                 dtype=np.int32)
    a, _ = serve.serve_requests(cfg, prompts, 2, 3, params=state,
                                device="cpu")
    assert all(t.data_ptr() == state[k].data_ptr()
               for k, t in built[0].state_dict().items())
    b, _ = serve.serve_requests(cfg, prompts, 2, 3, seed=0, device="cpu")
    np.testing.assert_array_equal(a, b)
    serve.serve_requests(cfg, prompts, 2, 3, device="cpu", params={
        k: v.bfloat16() for k, v in state.items()})
    assert all(t.dtype == torch.float32
               for t in built[-1].state_dict().values())
