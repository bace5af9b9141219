"""The port's training math against the reference's: the cross entropy,
AdamW and the schedules, the attention backward (``FlashAttention``, the
flash kernel's autograd Function) against ``jax.vjp`` of the reference's
``flash_attention_train``, the SSD backward (``SSDScan``) against
``jax.grad`` through the reference's ``layers.ssd``, and the loss and
gradients of every architecture's float32 smoke config against
``jax.value_and_grad`` of the reference's ``Model.loss``. Inputs are made
with numpy from seeds; the reference's weights come across through
``interop.params_from_reference``. On the CPU the Functions run the plain
forwards and the same backwards the card runs.

Bars: 1e-6 for the cross entropy and AdamW; 1e-5 for the attention
gradients and log-sum-exp; 1e-4 of each input's largest magnitude for the
SSD gradients (the port's decay cumsum is float64, the reference's
float32: ROADMAP queue C); the model losses at 1e-5 relative and each
gradient leaf at 1e-4 of its largest magnitude."""

import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.data import SyntheticTokens as RefTokens  # noqa: E402
from repro.distributed.xent import cross_entropy as ref_xent  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.optim import linear_warmup as ref_warmup  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCH_NAMES, smoke_config  # noqa: E402
from repro_torch.distributed import cross_entropy  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule, linear_warmup  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

class TestXent:
    """``tests/test_substrate.py::TestXent`` on the port."""

    def test_matches_log_softmax_gather(self):
        rng = np.random.default_rng(0)
        logits = torch.tensor(rng.normal(size=(2, 5, 11)), dtype=torch.float32)
        labels = torch.tensor(rng.integers(0, 11, (2, 5)))
        got = cross_entropy(logits, labels)
        want = -torch.log_softmax(logits, -1).gather(
            -1, labels[..., None]).mean()
        assert abs(float(got) - float(want)) < 1e-6

    def test_mask(self):
        logits = torch.zeros((1, 4, 7))
        labels = torch.zeros((1, 4), dtype=torch.int32)
        mask = torch.tensor([[1.0, 1.0, 0.0, 0.0]])
        got = cross_entropy(logits, labels, mask=mask)
        assert abs(float(got) - float(np.log(7))) < 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_the_reference(masked):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = float(ref_xent(jnp.asarray(logits), jnp.asarray(labels),
                          mask=None if mask is None else jnp.asarray(mask)))
    x = _t(logits).requires_grad_()
    got = cross_entropy(x, _t(labels), None if mask is None else _t(mask))
    assert abs(got.item() - want) <= 1e-6 * abs(want)
    # and its gradient, against the reference's
    g_ref = jax.grad(lambda z: ref_xent(
        z, jnp.asarray(labels),
        mask=None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(logits))
    got.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), atol=1e-6)


# ---------------------------------------------------------------------------
# AdamW and the schedules
# ---------------------------------------------------------------------------

class TestOptim:
    """``tests/test_substrate.py::TestOptim`` on the port."""

    def test_adamw_reduces_quadratic(self):
        opt = AdamW(lr=0.1, weight_decay=0.0)
        params = {"w": torch.tensor([3.0, -2.0])}
        state = opt.init(params)
        for _ in range(60):
            params, state, _ = opt.update({"w": 2 * params["w"]}, state,
                                          params)
        assert float(params["w"].abs().max()) < 0.5

    def test_clip_norm(self):
        opt = AdamW(lr=0.0, clip_norm=1.0)
        params = {"w": torch.zeros(3)}
        state = opt.init(params)
        _, _, gn = opt.update({"w": torch.full((3,), 100.0)}, state, params)
        assert float(gn) > 1.0  # reported pre-clip norm

    def test_cosine_schedule_endpoints(self):
        f = cosine_schedule(1.0, 10, 100, floor=0.1)
        assert float(f(torch.tensor(0))) == 0.0
        assert abs(float(f(torch.tensor(10))) - 1.0) < 1e-6
        assert abs(float(f(torch.tensor(100))) - 0.1) < 1e-3


def _opt_case(seed: int, grad_scale: float):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
    mk = lambda s, sc=1.0: {k: (rng.normal(size=v) * sc).astype(np.float32)  # noqa: E731
                            for k, v in shapes.items()}
    params, grads = mk(None), mk(None, grad_scale)
    m, v = mk(None, 0.01), {k: np.abs(a) for k, a in mk(None, 1e-3).items()}
    return params, grads, m, v


@pytest.mark.parametrize("grad_scale,lr", [
    (0.05, 1e-2),                       # norm under clip_norm
    (10.0, 1e-2),                       # clipped
    (10.0, "cosine"),                   # clipped, lr from a schedule
])
def test_adamw_update_matches_the_reference(grad_scale, lr):
    params, grads, m, v = _opt_case(3, grad_scale)
    step = 4
    if lr == "cosine":
        ref_opt = RefAdamW(lr=ref_cosine(3e-3, 3, 20))
        opt = AdamW(lr=cosine_schedule(3e-3, 3, 20))
    else:
        ref_opt, opt = RefAdamW(lr=lr), AdamW(lr=lr)
    ref_state = type(ref_opt.init(params))(
        step=jnp.asarray(step, jnp.int32),
        m={k: jnp.asarray(a) for k, a in m.items()},
        v={k: jnp.asarray(a) for k, a in v.items()})
    new_p, new_s, gn = ref_opt.update(
        {k: jnp.asarray(a) for k, a in grads.items()}, ref_state,
        {k: jnp.asarray(a) for k, a in params.items()})
    state = opt.init({k: _t(a) for k, a in params.items()})
    state.step.fill_(step)
    for k in m:
        state.m[k].copy_(_t(m[k]))
        state.v[k].copy_(_t(v[k]))
    p = {k: _t(a) for k, a in params.items()}
    p2, state2, gn2 = opt.update({k: _t(a) for k, a in grads.items()},
                                 state, p)
    assert p2 is p and state2 is state
    assert (float(gn) > 1.0) == (grad_scale > 1)
    assert abs(float(gn2) - float(gn)) <= 1e-6 * float(gn)
    assert int(state.step) == int(new_s.step) == step + 1
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(new_p[k]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(state.m[k].numpy(), np.asarray(new_s.m[k]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(state.v[k].numpy(), np.asarray(new_s.v[k]),
                                   atol=1e-6, rtol=0)


def test_schedules_match_the_reference():
    for ref_f, f in ((ref_warmup(2e-3, 7), linear_warmup(2e-3, 7)),
                     (ref_cosine(3e-4, 10, 50), cosine_schedule(3e-4, 10, 50)),
                     (ref_cosine(1.0, 0, 1, floor=0.2),
                      cosine_schedule(1.0, 0, 1, floor=0.2))):
        for s in range(0, 60):
            want = float(ref_f(jnp.asarray(s, jnp.int32)))
            got = float(f(torch.tensor(s, dtype=torch.int32)))
            assert abs(got - want) <= 1e-7 * max(abs(want), 1e-3), (s, got,
                                                                     want)


# ---------------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------------

# (causal, window, prefix, Sq, Sk); blocks of 16 queries and 32 keys
FLASH_CASES = {
    "causal": (True, 0, 0, 64, 64),
    "window_prefix": (True, 20, 6, 96, 96),
    "noncausal_sq_ne_sk": (False, 0, 0, 64, 96),
}
BQ, BK = 16, 32


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_the_reference_vjp(case, g):
    causal, window, prefix, Sq, Sk = FLASH_CASES[case]
    B, K, dh = 2, 2, 16
    H = K * g
    rng = np.random.default_rng(11)
    q = rng.normal(size=(B, Sq, K, g, dh)).astype(np.float32)
    k = rng.normal(size=(B, Sk, K, dh)).astype(np.float32)
    v = rng.normal(size=(B, Sk, K, dh)).astype(np.float32)
    do = rng.normal(size=(B, Sq, K, g, dh)).astype(np.float32)

    def ref(q, k, v):
        return ref_layers.flash_attention_train(q, k, v, causal, window,
                                                prefix, BQ, BK)

    out_ref, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
    dq_ref, dk_ref, dv_ref = vjp(jnp.asarray(do))
    _, lse_ref = ref_layers._flash_fwd_blocks(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window,
        prefix, BQ, BK)

    qt = _t(q).reshape(B, Sq, H, dh).requires_grad_()
    kt, vt = _t(k).requires_grad_(), _t(v).requires_grad_()
    out = fa.FlashAttention.apply(qt, kt, vt, causal, window, prefix, BQ, BK)
    out.backward(_t(do).reshape(B, Sq, H, dh))
    _, lse = fa.flash_forward_lse(qt.detach(), kt.detach(), vt.detach(),
                                  causal=causal, window=window,
                                  prefix=prefix)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(out_ref).reshape(B, Sq, H, dh),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_ref).reshape(B, H, Sq),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(qt.grad.numpy(),
                               np.asarray(dq_ref).reshape(B, Sq, H, dh),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(dk_ref),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(dv_ref),
                               atol=1e-5, rtol=0)


def test_flash_function_only_where_autograd_records():
    """``ops.flash_attention`` takes the Function when grad is enabled and
    an input requires grad, the plain forward otherwise; both agree."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(2)
    q = _t(rng.normal(size=(1, 24, 4, 8)).astype(np.float32))
    k = _t(rng.normal(size=(1, 24, 2, 8)).astype(np.float32))
    plain = ops.flash_attention(q, k, k)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    out = ops.flash_attention(qg, k, k)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert ops.flash_attention(qg, k, k).grad_fn is None


# ---------------------------------------------------------------------------
# the SSD backward
# ---------------------------------------------------------------------------

SSD_SHAPES = [                         # tests/test_kernels.py's four
    (2, 256, 4, 64, 1, 64, 64),
    (1, 200, 2, 32, 1, 16, 64),        # ragged
    (2, 128, 4, 64, 2, 32, 32),        # grouped B/C
    (1, 512, 8, 64, 1, 128, 128),      # mamba2-like dims
]


@pytest.mark.parametrize("Bb,S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_backward_matches_the_reference_grad(Bb, S, H, P, G, N, chunk):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(Bb, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(Bb, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    B = rng.normal(size=(Bb, S, G, N)).astype(np.float32)
    C = rng.normal(size=(Bb, S, G, N)).astype(np.float32)
    wy = rng.normal(size=(Bb, S, H, P)).astype(np.float32)
    ws = rng.normal(size=(Bb, H, P, N)).astype(np.float32)

    def ref_loss(x, dt, A, B, C):
        y, st = ref_layers.ssd(x, dt, A, B, C, chunk)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (x, dt, A, B, C)))
    ins = [_t(a).requires_grad_() for a in (x, dt, A, B, C)]
    y, st = ss.SSDScan.apply(*ins, chunk)
    ((y * _t(wy)).sum() + (st * _t(ws)).sum()).backward()
    for name, t, w in zip("x dt A B C".split(), ins, want):
        w = np.asarray(w)
        err = float(np.abs(t.grad.numpy() - w).max() / np.abs(w).max())
        assert err <= 1e-4, (name, err)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

B, S = 2, 32
LOW_THRESHOLD = 16      # the reference trains through flash_attention_train


@functools.cache
def _ref_params(arch: str):
    return jax.jit(ref_build(ref_smoke_config(arch)).init)(
        jax.random.PRNGKey(0))


def train_batch(cfg, seed: int = 3) -> dict:
    """The trainer's batch of the smoke config: B x S tokens, labels and the
    frontend stubs' inputs, from the reference's data pipeline."""
    extras = {}
    if cfg.kind == "encdec":
        extras["frames"] = (max(S // 4, 1), cfg.d_model)
    if cfg.kind == "vlm":
        extras["vision"] = (cfg.frontend_len, cfg.d_model)
    return RefTokens(cfg.vocab, B, S, seed=seed, host_rank=0, host_count=1,
                     extras=extras).batch(0)


@functools.cache
def ref_loss_and_grads(arch: str, dtype: str, threshold: int):
    """The reference's loss and grads on ``train_batch`` of the smoke
    config."""
    batch = train_batch(ref_smoke_config(arch))
    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype=dtype,
                               flash_threshold=threshold)
    model = ref_build(rcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, jb)))(_ref_params(arch))
    return float(loss), grads


def port_model(arch: str, dtype: str):
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    model = build(cfg, "cpu")
    model.load_state_dict(interop.params_from_reference(
        cfg, jax.tree.map(np.asarray, _ref_params(arch))))
    return cfg, model


def _port_loss_and_grads(arch: str, batch: dict):
    cfg, model = port_model(arch, "float32")
    loss = model.loss({k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    return cfg, float(loss), {n: p.grad for n, p in model.named_parameters()}


# The reference's flash_attention_train masks keys by the padded Sk: at a
# low threshold the encoder-decoder's non-causal encoder and cross
# attention let zero keys into the softmax (ROADMAP queue C), so it is held
# at the default threshold and its low threshold is the fault's witness.
WHOLE_CASES = [(a, t) for a in ARCH_NAMES for t in (8192, LOW_THRESHOLD)
               if not (a == "seamless_m4t_medium" and t == LOW_THRESHOLD)]


@pytest.mark.parametrize("arch,threshold", WHOLE_CASES)
def test_model_loss_and_grads_match_the_reference(arch, threshold):
    want, grads = ref_loss_and_grads(arch, "float32", threshold)
    cfg, got, port_grads = _port_loss_and_grads(
        arch, train_batch(ref_smoke_config(arch)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    ref_grads = interop.params_from_reference(
        cfg, jax.tree.map(np.asarray, grads))
    assert set(ref_grads) == set(port_grads)
    for name, g in port_grads.items():
        w = ref_grads[name].numpy()
        scale = float(np.abs(w).max())
        got_g = np.zeros_like(w) if g is None else g.numpy()
        assert float(np.abs(got_g - w).max()) <= 1e-4 * max(scale, 1e-30), \
            name


def test_reference_padded_keys_fault_on_encdec():
    """At a low threshold the reference's encoder-decoder loss leaves its
    own default-threshold loss (padded zero keys in the non-causal
    softmax); the port's, which masks by the real Sk, stays on it."""
    arch = "seamless_m4t_medium"
    dense, _ = ref_loss_and_grads(arch, "float32", 8192)
    padded, _ = ref_loss_and_grads(arch, "float32", LOW_THRESHOLD)
    _, got, _ = _port_loss_and_grads(arch, train_batch(ref_smoke_config(arch)))
    assert abs(got - dense) <= 1e-5 * abs(dense)
    assert abs(padded - dense) > 1e-3 * abs(dense), (padded, dense)
