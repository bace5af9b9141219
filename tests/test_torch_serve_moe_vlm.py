"""The port's MoE and vision decoders against the reference, past what
``tests/test_torch_serve.py``'s per-architecture parity covers: the routed
FFN as a module (capacity drops, dispatch groups, bfloat16), the vision
prefix on seeded and zero patches, decoding after the patches, the leaves
``params_from_reference`` carries, and greedy serving. The reference's
weights come across by ``interop.params_from_reference``, inputs from numpy
seeds. Bars: 1e-4 in float32 (the MoE's aux 1e-5), 2e-2 of the RMS in
bfloat16 (``tests/test_torch_serve.py``).

Top-k ties: ``lax.top_k`` puts the lower expert first; the port sorts the
probabilities with a stable descending sort, which does the same, so no
input here depends on how a tie would fall."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.launch.serve import serve_requests as ref_serve  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import layers as ref_ll  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import decoder  # noqa: E402
from repro_torch.models import layers as ll  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
AUX_TOL = 1e-5
MOE = ("deepseek_moe_16b", "olmoe_1b_7b")
VLM = "phi_3_vision_4_2b"


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


def _models(arch: str, dtype: str, **over):
    """(reference cfg, reference model, params; port model) with the
    reference's init carried across; ``over`` replaces config fields on
    both sides."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype=dtype, **over)
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype, **over)
    params = _ref_params(arch)
    model = build(cfg, "cpu")
    model.load_state_dict(interop.params_from_reference(cfg, params))
    return rcfg, ref_build(rcfg), params, model


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a))))


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
    assert _rms(got - ref) <= TOL[dtype] * _rms(ref)


# --------------------------------------------------------------------------
# moe_ffn
# --------------------------------------------------------------------------

def _moe_inputs(cfg, params, skewed: bool, seed: int = 1):
    """(2, 24, D) activations; ``skewed`` adds layer 0's router column of
    expert 0 to every other token, so expert 0 takes more entries than its
    capacity and drops the later ones."""
    x = np.random.default_rng(seed).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32)
    if skewed:
        x[:, ::2] += 3.0 * params["layers"]["ffn"]["router"][0][:, 0]
    return x


def _moe_ffn_both(arch, dtype, x, **over):
    """Layer 0's ``moe_ffn`` on ``x`` in the reference and in the port:
    ((y, aux) reference, (y, aux) port)."""
    rcfg, _, params, model = _models(arch, dtype, **over)
    ffn = jax.tree.map(lambda a: a[0], params["layers"]["ffn"])
    y_r, aux_r = ref_ll.moe_ffn(jnp.asarray(x, getattr(jnp, dtype)), ffn,
                                rcfg, None)
    with torch.no_grad():
        y_p, aux_p = ll.moe_ffn(torch.from_numpy(x).to(getattr(torch, dtype)),
                                model.layers[0].ffn, model.cfg)
    return (y_r, aux_r), (y_p, aux_p)


@pytest.mark.parametrize("skewed", [False, True], ids=["spread", "skewed"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, groups, skewed):
    """deepseek-smoke with its two shared experts, olmoe-smoke without; one
    dispatch group or two; spread inputs, and skewed ones where expert 0
    drops entries past its capacity."""
    x = _moe_inputs(smoke_config(arch), _ref_params(arch), skewed)
    (y_r, aux_r), (y_p, aux_p) = _moe_ffn_both(arch, "float32", x,
                                               moe_groups=groups)
    _close(y_p, y_r, "float32")
    np.testing.assert_allclose(float(aux_p), float(aux_r), rtol=AUX_TOL,
                               atol=AUX_TOL)
    assert float(aux_p) > 0


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_ffn_drops_the_reference_entries(groups, monkeypatch):
    """The kept (token, expert) entries, read off the output: each expert
    is replaced on both sides by one that writes the unit vector of its
    index, so a token's output is non-zero at dim e exactly when its entry
    for expert e was kept (olmoe-smoke: no shared experts). The skewed
    inputs drop entries; the same ones on both sides."""
    cfg = smoke_config("olmoe_1b_7b")
    E, D = cfg.n_experts, cfg.d_model

    def ref_unit(buf, p, rules, grouped=False):
        return jnp.broadcast_to(jnp.eye(E, D)[None, :, None, :],
                                buf.shape).astype(buf.dtype)

    def port_unit(buf, p):
        return torch.eye(E, D)[None, :, None, :].expand(buf.shape).to(
            buf.dtype)

    monkeypatch.setattr(ref_ll, "_expert_swiglu", ref_unit)
    monkeypatch.setattr(ll, "_expert_swiglu", port_unit)
    x = _moe_inputs(cfg, _ref_params("olmoe_1b_7b"), skewed=True)
    (y_r, _), (y_p, _) = _moe_ffn_both("olmoe_1b_7b", "float32", x,
                                       moe_groups=groups)
    kept_r = np.asarray(y_r)[..., :E] != 0
    kept_p = y_p.numpy()[..., :E] != 0
    np.testing.assert_array_equal(kept_p, kept_r)
    n_entries = x.shape[0] * x.shape[1] * cfg.top_k
    assert 0 < n_entries - kept_p.sum() < n_entries


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_bfloat16_matches_reference(arch):
    x = _moe_inputs(smoke_config(arch), _ref_params(arch), skewed=True)
    (y_r, aux_r), (y_p, aux_p) = _moe_ffn_both(arch, "bfloat16", x)
    _close(y_p, y_r, "bfloat16")
    np.testing.assert_allclose(float(aux_p), float(aux_r), rtol=AUX_TOL,
                               atol=AUX_TOL)


def test_moe_ffn_sums_each_token_in_one_order():
    """Two calls on the same bfloat16 inputs give the same bits (no
    scatter-add whose order could vary)."""
    cfg = smoke_config("deepseek_moe_16b")
    model = build(dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    x = torch.from_numpy(_moe_inputs(cfg, _ref_params("deepseek_moe_16b"),
                                     skewed=True)).bfloat16()
    with torch.no_grad():
        a, b = (ll.moe_ffn(x, model.layers[0].ffn, model.cfg)[0]
                for _ in range(2))
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the vision decoder
# --------------------------------------------------------------------------

def _vision(cfg, seeded: bool, B: int = 2):
    """Patch embeddings: seeded non-zero ones (``tests/test_arch_smoke.py``'s
    scale), or the serve's zero stub."""
    if not seeded:
        return np.zeros((B, cfg.frontend_len, cfg.d_model), np.float32)
    return (np.random.default_rng(6).normal(
        size=(B, cfg.frontend_len, cfg.d_model)) * 0.02).astype(np.float32)


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "zeros"])
def test_vlm_decoder_matches_reference(seeded):
    """Forward over patches and text, prefill (logits and the cache of both)
    and one decode step at ``S + frontend_len`` in float32. Both sides
    decode from the reference's prefill cache cast to float32: the
    reference refuses a float32 key in its bfloat16 cache, and the two
    caches, held to one bfloat16 ulp, may round keys 1e-6 apart to
    neighbouring bfloat16 values (ROADMAP queue C)."""
    rcfg, ref, params, model = _models(VLM, "float32")
    cfg = model.cfg
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 24),
                                             dtype=np.int32)
    batch = {"tokens": toks, "vision": _vision(cfg, seeded)}
    S, F = toks.shape[1], cfg.frontend_len
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    lg_r, aux_r = ref.forward(params, jb)
    with torch.no_grad():
        lg_p, aux_p = model(tb)
    assert lg_p.shape == (2, F + S, cfg.vocab)
    _close(lg_p, lg_r, "float32")
    assert float(aux_p) == float(aux_r) == 0.0

    plg_r, cache_r = ref.prefill(params, jb, max_len=F + S + 6)
    plg_p, cache_p = model.prefill(tb, max_len=F + S + 6)
    _close(plg_p, plg_r, "float32")
    for key in cache_r:
        assert cache_p[key].shape == cache_r[key].shape == (
            cfg.n_layers, 2, F + S + 6, cfg.n_kv_heads, cfg.dh)
        _close(cache_p[key], cache_r[key], "float32", bf16_values=True)

    nxt = toks[:, 2:3]
    cache32 = jax.tree.map(lambda a: np.asarray(a, np.float32), cache_r)
    dlg_r, _ = ref.decode(params, jax.tree.map(jnp.asarray, cache32),
                          jnp.asarray(nxt), S + F)
    dlg_p, cache2 = model.decode({k: torch.from_numpy(v.copy())
                                  for k, v in cache32.items()},
                                 torch.from_numpy(nxt), S + F)
    _close(dlg_p, dlg_r, "float32")
    assert cache2["k"][:, :, S + F].abs().max() > 0


def test_vlm_decode_after_the_patches_reproduces_forward():
    """A prompt of S tokens after F patches fills cache positions 0..F+S-1,
    so the next token belongs at position F + S: decoding it there gives
    forward's logits for that token, in the port and in the reference. At
    ``S``, where the reference's ``serve_requests`` and so the port's serve
    decode (ROADMAP queue C), the key overwrites text position S - F and
    the last F - 1 prompt positions are masked out: the logits leave
    forward's."""
    rcfg, ref, params, model = _models(VLM, "bfloat16")
    cfg = model.cfg
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 25),
                                             dtype=np.int32)
    S, F = 24, cfg.frontend_len
    vision = _vision(cfg, seeded=True)
    want_p = model({"tokens": torch.from_numpy(toks),
                    "vision": torch.from_numpy(vision)})[0][:, -1:].detach()
    want_r = ref.forward(params, {"tokens": jnp.asarray(toks),
                                  "vision": jnp.asarray(vision)})[0][:, -1:]
    _, cache_p = model.prefill({"tokens": torch.from_numpy(toks[:, :S]),
                                "vision": torch.from_numpy(vision)},
                               max_len=F + S + 4)
    _, cache_r = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :S]),
                                      "vision": jnp.asarray(vision)},
                             max_len=F + S + 4)
    nxt = toks[:, S:]

    def rel(got, want):
        got, want = (np.asarray(a.float() if isinstance(a, torch.Tensor)
                                else a, np.float32) for a in (got, want))
        return _rms(got - want) / _rms(want)

    at_end = model.decode({k: v.clone() for k, v in cache_p.items()},
                          torch.from_numpy(nxt), F + S)[0]
    assert rel(at_end, want_p) <= TOL["bfloat16"]
    ref_at_end = ref.decode(params, cache_r, jnp.asarray(nxt), F + S)[0]
    assert rel(ref_at_end, want_r) <= TOL["bfloat16"]
    at_serve = model.decode(cache_p, torch.from_numpy(nxt), S)[0]
    assert rel(at_serve, want_p) > 10 * TOL["bfloat16"]


# --------------------------------------------------------------------------
# interop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE + (VLM,))
def test_params_from_reference_carries_every_leaf(arch):
    """Every leaf of the reference's tree lands, row by row, on the port's
    parameter of that name: the router, the stacked experts and the shared
    experts under ``layers/ffn``, and the top-level ``vision_proj``."""
    cfg = smoke_config(arch)
    params = _ref_params(arch)
    state = interop.params_from_reference(cfg, params)
    assert sorted(state) == sorted(build(cfg, "meta").state_dict())
    seen = 0

    def walk(node, path):
        nonlocal seen
        if isinstance(node, dict):
            for key, sub in node.items():
                walk(sub, path + (key,))
            return
        rows = range(cfg.n_layers) if path[0] == "layers" else [None]
        for i in rows:
            name = ".".join(path if i is None else (path[0], str(i))
                            + path[1:])
            np.testing.assert_array_equal(state[name].numpy(),
                                          node if i is None else node[i])
            seen += 1

    walk(params, ())
    assert seen == len(state)
    if cfg.kind == "vlm":
        assert state["vision_proj"].shape == (cfg.d_model, cfg.d_model)
        return
    E, D, dE = cfg.n_experts, cfg.d_model, cfg.d_expert
    assert state["layers.1.ffn.router"].shape == (D, E)
    assert state["layers.1.ffn.experts.w_down"].shape == (E, dE, D)
    assert ("layers.1.ffn.shared.w_gate" in state) == (
        cfg.n_shared_experts > 0)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _ref_greedy_f32_cache(rcfg, ref, params, prompts, batch, max_new):
    """The reference's greedy serve loop, its stub frontend and its decode
    positions ``S + t`` included, for a float32 decoder whose reference
    decode refuses its bfloat16 cache: each step decodes from the cache
    cast to float32 and rounds the new key and value back to bfloat16, as
    the port's bfloat16 cache stores them."""
    n, S = prompts.shape
    out = np.zeros((n, max_new), np.int32)
    decode = jax.jit(ref.decode)

    def cast(cache, dtype):
        return jax.tree.map(lambda a: a.astype(dtype), cache)

    for g in range(0, n, batch):
        ids = list(range(g, min(g + batch, n)))
        toks = np.zeros((batch, S), np.int32)
        toks[:len(ids)] = prompts[ids]
        pbatch = {"tokens": jnp.asarray(toks)}
        if rcfg.kind == "vlm":
            pbatch["vision"] = jnp.zeros((batch, rcfg.frontend_len,
                                          rcfg.d_model), jnp.float32)
        lg, cache = ref.prefill(params, pbatch, max_len=S + max_new)
        for t in range(max_new):
            token = np.asarray(jnp.argmax(lg[:, -1], -1), np.int32)[:, None]
            out[ids, t] = token[:len(ids), 0]
            if t + 1 < max_new:
                lg, cache = decode(params, cast(cache, jnp.float32),
                                   jnp.asarray(token), S + t)
                cache = cast(cache, jnp.bfloat16)
    return out


@pytest.mark.parametrize("arch", MOE + (VLM,))
def test_serve_float32_greedy_equals_reference(arch):
    """Groups of 2 with a zero-padded last group: the port's
    ``serve_requests`` tokens equal the reference's greedy loop on a
    float32-cast cache (its ``serve_requests`` refuses a float32 decoder,
    ROADMAP queue C); phi3v-smoke from its zero patches, decoding from
    ``S`` as the reference's serve does. A decode step of batch 2 gives
    each expert a capacity of one entry."""
    rcfg, ref, params, model = _models(arch, "float32")
    cfg = model.cfg
    prompts = np.random.default_rng(14).integers(0, cfg.vocab, (5, 16),
                                                 dtype=np.int32)
    want = _ref_greedy_f32_cache(rcfg, ref, params, prompts, 2, 6)
    got, stats = serve.serve_requests(cfg, prompts, 2, 6,
                                      params=model.state_dict(),
                                      device="cpu")
    np.testing.assert_array_equal(got, want)
    assert stats["requests"] == 5 and stats["wall_s"] > 0


def test_serve_vlm_bfloat16_matches_reference_up_to_knife_edges():
    """Against the reference's own ``serve_requests`` (bfloat16, zero
    patches, decode from ``S``): each request's tokens are equal up to its
    first step whose two best reference logits lie within two bfloat16
    ulps, found by replaying the reference's greedy loop (the port's
    float32 prefill scores may flip such a pick)."""
    rcfg, ref, params, model = _models(VLM, "bfloat16")
    cfg = model.cfg
    prompts = np.random.default_rng(16).integers(0, cfg.vocab, (3, 16),
                                                 dtype=np.int32)
    n, S = prompts.shape
    batch, max_new = 2, 6
    ref_out, _ = ref_serve(rcfg, prompts, batch, max_new, params=params)
    out, _ = serve.serve_requests(cfg, prompts, batch, max_new,
                                  params=model.state_dict(), device="cpu")
    knife = np.full(n, max_new)
    decode = jax.jit(ref.decode)
    for g in range(0, n, batch):
        ids = list(range(g, min(g + batch, n)))
        toks = np.zeros((batch, S), np.int32)
        toks[:len(ids)] = prompts[ids]
        lg, cache = ref.prefill(params, {
            "tokens": jnp.asarray(toks),
            "vision": jnp.zeros((batch, cfg.frontend_len, cfg.d_model))},
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


@pytest.mark.parametrize("arch", MOE + (VLM,))
def test_serve_main_on_the_cpu(arch, capsys):
    stats = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch", "2", "--prompt-len",
                        "12", "--max-new", "3"])
    assert stats["requests"] == 3
    assert "first completion" in capsys.readouterr().out


def test_moe_block_and_vision_projection_are_built_by_kind():
    """The decoder builds a routed FFN for ``moe`` (shared experts only
    where the config has them) and ``vision_proj`` only for ``vlm``."""
    blocks = {arch: build(smoke_config(arch), "meta") for arch in MOE + (VLM,)}
    deep, olmoe, phi = (blocks[a] for a in MOE + (VLM,))
    assert isinstance(deep.layers[0].ffn, decoder.MoE)
    assert deep.layers[0].ffn.shared is not None
    assert olmoe.layers[0].ffn.shared is None
    assert isinstance(phi.layers[0].ffn, decoder.SwiGLU)
    assert phi.vision_proj is not None and deep.vision_proj is None
