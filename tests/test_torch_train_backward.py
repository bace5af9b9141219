"""The training backwards' plain versions and routing, on the CPU.

The backward kernels (``csrc/flash_backward.cu``, ``ssd_scan_bwd_launch``
in ``csrc/ssd_scan.cu``) run only on the card, where ``chip_smoke.py``
holds each against its plain version and an independent witness. Here the
plain SSD backward (``ssd_scan_backward_plain``: the equations written out,
not autograd) is held to ``jax.grad`` through the reference's
``layers.ssd`` and to autograd through ``ssd_scan_plain``, the Functions are
shown to take the plain versions on the CPU, and the flash backward's route
rule and the no-kernel paths are checked."""

import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")
BF16 = torch.bfloat16

SSD_SHAPES = [                         # tests/test_torch_train.py's four
    (2, 256, 4, 64, 1, 64, 64),
    (1, 200, 2, 32, 1, 16, 64),        # ragged
    (2, 128, 4, 64, 2, 32, 32),        # grouped B/C
    (1, 512, 8, 64, 1, 128, 128),      # mamba2-like dims
]
SSD_TOL = 1e-5           # relative to each gradient's max abs
SSD_BF16_TOL = 2e-2      # chip_smoke.LM_TOL["bfloat16"]["ssd"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _ssd_inputs(Bb, S, H, P, G, N, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bb, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(Bb, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    B = rng.normal(size=(Bb, S, G, N)).astype(np.float32)
    C = rng.normal(size=(Bb, S, G, N)).astype(np.float32)
    wy = rng.normal(size=(Bb, S, H, P)).astype(np.float32)
    ws = rng.normal(size=(Bb, H, P, N)).astype(np.float32)
    return (x, dt, A, B, C), wy, ws


def _reference_grads(ins, wy, ws, chunk):
    def loss(x, dt, A, B, C):
        y, st = ref_layers.ssd(x, dt, A, B, C, chunk)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    return [np.asarray(g) for g in jax.jit(jax.grad(
        loss, argnums=(0, 1, 2, 3, 4)))(*(jnp.asarray(a) for a in ins))]


def _rel(got, want) -> float:
    got = np.asarray(got.float() if torch.is_tensor(got) else got)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("Bb,S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_plain_backward_matches_the_reference_grad(Bb, S, H, P, G, N,
                                                       chunk):
    ins, wy, ws = _ssd_inputs(Bb, S, H, P, G, N)
    want = _reference_grads(ins, wy, ws, chunk)
    got = ss.ssd_scan_backward_plain(
        *(torch.from_numpy(a) for a in ins), torch.from_numpy(wy),
        torch.from_numpy(ws), chunk)
    assert got[0].dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip("x dt A B C".split(), got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= SSD_TOL, (name, _rel(g, w))


def test_ssd_plain_backward_bf16_x_at_the_bf16_bar():
    """A bfloat16 x (the models' activations): dx comes back in bfloat16,
    the rest in float32, all within the bf16 bar of the reference's float32
    gradients on the same (bf16-exact) x."""
    Bb, S, H, P, G, N, chunk = SSD_SHAPES[0]
    ins, wy, ws = _ssd_inputs(Bb, S, H, P, G, N, seed=3)
    x16 = torch.from_numpy(ins[0]).to(BF16)
    ins = (x16.float().numpy(),) + ins[1:]
    want = _reference_grads(ins, wy, ws, chunk)
    got = ss.ssd_scan_backward_plain(
        x16, *(torch.from_numpy(a) for a in ins[1:]),
        torch.from_numpy(wy).to(BF16), torch.from_numpy(ws), chunk)
    assert got[0].dtype == BF16
    for name, g, w in zip("x dt A B C".split(), got, want):
        assert _rel(g, w) <= SSD_BF16_TOL, (name, _rel(g, w))


def test_ssd_plain_backward_without_a_state_gradient():
    """dstate None is a zero state gradient, and the reference's gradients
    with no weight on the final state."""
    Bb, S, H, P, G, N, chunk = SSD_SHAPES[2]
    ins, wy, ws = _ssd_inputs(Bb, S, H, P, G, N, seed=5)
    t = [torch.from_numpy(a) for a in ins]
    none = ss.ssd_scan_backward_plain(*t, torch.from_numpy(wy), None, chunk)
    zero = ss.ssd_scan_backward_plain(*t, torch.from_numpy(wy),
                                      torch.zeros(ws.shape), chunk)
    assert all(torch.equal(a, b) for a, b in zip(none, zero))
    want = _reference_grads(ins, wy, np.zeros_like(ws), chunk)
    for name, g, w in zip("x dt A B C".split(), none, want):
        assert _rel(g, w) <= SSD_TOL, (name, _rel(g, w))


@pytest.mark.parametrize("Bb,S,H,P,G,N,chunk", [SSD_SHAPES[1],
                                                  (1, 77, 4, 20, 2, 18, 32)])
def test_ssd_function_takes_the_plain_backward_on_the_cpu(monkeypatch, Bb, S,
                                                          H, P, G, N, chunk):
    """``SSDScan.backward`` on CPU tensors calls ``ssd_scan_backward_plain``
    (once, with the saved inputs) and launches nothing; its gradients agree
    with autograd through ``ssd_scan_plain``, the route the port took
    before it had a backward of its own (kept here as a witness)."""
    ins, wy, ws = _ssd_inputs(Bb, S, H, P, G, N, seed=9)
    calls = []
    plain = ss.ssd_scan_backward_plain

    def counted(*args, **kw):
        calls.append(args)
        return plain(*args, **kw)

    monkeypatch.setattr(ss, "ssd_scan_backward_plain", counted)
    LAUNCHES.clear()
    leaf = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, st = ss.SSDScan.apply(*leaf, chunk)
    ((y * torch.from_numpy(wy)).sum()
     + (st * torch.from_numpy(ws)).sum()).backward()
    assert len(calls) == 1 and not LAUNCHES
    wit = [torch.from_numpy(a).requires_grad_() for a in ins]
    y2, st2 = ss.ssd_scan_plain(*wit, chunk)
    want = torch.autograd.grad((y2 * torch.from_numpy(wy)).sum()
                               + (st2 * torch.from_numpy(ws)).sum(), wit)
    for name, t, w in zip("x dt A B C".split(), leaf, want):
        assert _rel(t.grad, w.numpy()) <= SSD_TOL, name


def test_ssd_function_skips_gradients_not_asked_for():
    ins, wy, _ = _ssd_inputs(1, 64, 2, 16, 1, 8)
    x = torch.from_numpy(ins[0]).requires_grad_()
    rest = [torch.from_numpy(a) for a in ins[1:]]
    y, _ = ss.SSDScan.apply(x, *rest, 32)
    (y * torch.from_numpy(wy)).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert all(t.grad is None for t in rest)


# ---------------------------------------------------------------------------
# the flash backward's route rule
# ---------------------------------------------------------------------------

def _bwd_operands(dh, dtype=BF16, B=1, S=32, H=4, K=2):
    """q, k, v and dout as the route rule takes them."""
    q = torch.zeros((B, S, H, dh), dtype=dtype)
    k = torch.zeros((B, S, K, dh), dtype=dtype)
    return q, k, k.clone(), torch.zeros_like(q)


@pytest.mark.parametrize("dh", fa.TC_HEAD_DIMS)
def test_backward_route_takes_the_tensor_cores_in_bf16(dh):
    assert fa.backward_tensor_core_route(*_bwd_operands(dh))


@pytest.mark.parametrize("dh", [16, 32, 80])
def test_backward_route_other_head_dims_take_the_cuda_cores(dh):
    assert not fa.backward_tensor_core_route(*_bwd_operands(dh))


@pytest.mark.parametrize("dh", fa.TC_HEAD_DIMS)
def test_backward_route_float32_takes_the_cuda_cores(dh):
    assert not fa.backward_tensor_core_route(
        *_bwd_operands(dh, dtype=torch.float32))


@pytest.mark.parametrize("which", range(4))
def test_backward_route_odd_strides_take_the_cuda_cores(which):
    """One operand (q, k, v or dout) as a view whose sequence stride is not
    a multiple of 16 bytes (a row of 64 bf16 values and 4 more)."""
    ops = list(_bwd_operands(64))
    t = ops[which]
    wide = torch.zeros((*t.shape[:2], t.shape[2] * 64 + 4), dtype=BF16)
    ops[which] = wide[..., :t.shape[2] * 64].unflatten(-1, (t.shape[2], 64))
    assert ops[which].stride(1) * 2 % 16
    assert not fa.backward_tensor_core_route(*ops)


def test_backward_route_misaligned_dout_takes_the_cuda_cores():
    ops = list(_bwd_operands(64))
    flat = torch.zeros(ops[3].numel() + 1, dtype=BF16)
    ops[3] = flat[1:].view(ops[3].shape)
    assert ops[3].data_ptr() % 16
    assert not fa.backward_tensor_core_route(*ops)


@pytest.mark.parametrize("B", [1, 2])
def test_backward_route_reads_no_stride_of_a_size_one_dim(B):
    """A one-sequence batch's dout as autograd hands it over (batch stride
    1, which no index multiplies) takes the tensor cores; the same stride
    on a batch of two does not."""
    q, k, v, _ = _bwd_operands(64, B=B)
    dout = torch.zeros((B, 32, 4, 64), dtype=BF16).as_strided(
        (B, 32, 4, 64), (1, 256, 64, 1))
    assert fa.backward_tensor_core_route(q, k, v, dout) == (B == 1)


# ---------------------------------------------------------------------------
# no kernel: meta tensors
# ---------------------------------------------------------------------------

def _meta_flash():
    q = torch.zeros((1, 64, 8, 64), dtype=BF16, device="meta")
    k = torch.zeros((1, 64, 2, 64), dtype=BF16, device="meta")
    lse = torch.zeros((1, 8, 64), device="meta")
    return q, k, k.clone(), torch.empty_like(q), lse, torch.empty_like(q)


def _meta_ssd():
    Bb, S, H, P, G, N = 1, 96, 4, 16, 2, 8
    m = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    return (m(Bb, S, H, P), m(Bb, S, H), m(H), m(Bb, S, G, N),
            m(Bb, S, G, N), m(Bb, S, H, P), m(Bb, H, P, N))


def test_meta_backwards_return_gradients_of_the_shapes():
    """Meta tensors (the dry-run's shapes without data) take the plain
    versions and get gradients of the inputs' shapes and dtypes, launching
    nothing."""
    LAUNCHES.clear()
    q, k, v, out, lse, dout = _meta_flash()
    got = fa.flash_attention_backward(q, k, v, out, lse, dout)
    assert [(g.shape, g.dtype, g.device.type) for g in got] == \
        [(t.shape, t.dtype, "meta") for t in (q, k, v)]
    x, dt, A, B, C, dy, dstate = _meta_ssd()
    got = ss.ssd_scan_backward(x, dt, A, B, C, dy, dstate, 32)
    assert [g.shape for g in got] == [t.shape for t in (x, dt, A, B, C)]
    assert all(g.device.type == "meta" for g in got)
    assert not LAUNCHES


def test_backwards_launch_or_raise_off_the_cpu(monkeypatch):
    """A device that is not a plain one launches the backward kernels or
    raises (meta standing for a device without a kernel, once it is not a
    plain device); no plain backward runs and no launch is counted."""
    for mod in (fa, ss):
        monkeypatch.setattr(mod, "PLAIN_DEVICES", ("cpu",))
    for name, mod in (("flash_backward", fa),
                      ("ssd_scan_backward_plain", ss)):
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail(
            "a plain backward ran off the CPU"))
    LAUNCHES.clear()
    q, k, v, out, lse, dout = _meta_flash()
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_backward(q, k, v, out, lse, dout)
    with pytest.raises(ValueError, match="no kernel"):
        fa.FlashAttention.backward(types.SimpleNamespace(
            saved_tensors=(q, k, v, out, lse), args=(True, 0, 0, 512, 1024)),
            dout)
    with pytest.raises(ValueError, match="no kernel"):
        ss.ssd_scan_backward(*_meta_ssd(), 32)
    with pytest.raises(ValueError, match="inconsistent"):
        x, dt, A, B, C, dy, dstate = _meta_ssd()
        ss.ssd_scan_backward(x, dt, A, B, C, dy[:, :8], dstate, 32)
    assert not LAUNCHES


def test_backward_plan_scratch_matches_the_forward_plan():
    """The backward's scratch leads with the forward's four buffers and
    sizes its own from the same chunk padding."""
    plan = ss.ssd_bwd_plan(2, 4096, 80, 64, 1, 128, 256, torch.float32)
    fwd = ss.ssd_plan(2, 4096, 80, 64, 1, 128, 256, torch.float32)
    sc = fwd["scratch"]
    shapes = [s for s, _ in plan["bwd_scratch"]]
    assert shapes[:3] == [sc["cum"], sc["cb"], sc["states"]]
    assert shapes[3] == (2, 80, 64, 128)
    assert shapes[4] == sc["states"] and shapes[5] == sc["cb"]
    assert shapes[6] == shapes[7] == (2, 80, 16, 10, 64)
    assert shapes[8] == shapes[9] == (2, 80, 16, 256)
    assert shapes[10] == (2, 80, 16, 4) and shapes[11] == (2, 80, 16)
    assert len(plan["bwd_scratch"]) + 5 == 17
