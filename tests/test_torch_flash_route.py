"""The rule that sends a CUDA flash-attention call to the tensor-core kernel
or to the CUDA-core kernel, and the tensor maps the tensor-core kernel is
given, checked on the CPU. Both kernels run only on the card
(``chip_smoke.py`` launches them and holds each against the plain version);
here the rule and the layouts are held to what the models and the reference
kernel tests pass in."""

import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
# The module (the package attribute of its name is the function).
fa = importlib.import_module("repro_torch.kernels.flash_attention")
from repro_torch.models import layers  # noqa: E402

FLASH_SHAPES = [                 # tests/test_kernels.py:17-39
    (4, 2, 256, 256, 64, True, 0, 0),
    (2, 2, 384, 384, 128, True, 0, 0),
    (4, 1, 128, 512, 64, False, 0, 0),
    (2, 2, 512, 512, 64, True, 128, 16),
    (2, 1, 200, 300, 64, True, 0, 0),
    (1, 1, 640, 640, 64, True, 256, 0),
]
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class _Captured(Exception):
    pass


def test_tinyllama_serve_tensors_take_the_tensor_cores(monkeypatch):
    """q, k and v as the decoder's prefill hands them to the kernel at the
    serve shape (B 4, S 1024, 32 query heads on 4 kv heads, dh 64,
    bfloat16), with the output ``ops.flash_attention`` allocates."""
    cfg = get_config("tinyllama_1_1b")
    H, K, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.dh, 16
    rng = np.random.default_rng(0)
    w = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    p = types.SimpleNamespace(wq=w(D, H, dh), wk=w(D, K, dh), wv=w(D, K, dh),
                              wo=w(H, dh, D), bq=None)
    seen = {}

    def capture(q, k, v, **kw):
        seen.update(q=q, k=k, v=v, kw=kw)
        raise _Captured

    monkeypatch.setattr(ops, "flash_attention", capture)
    x = w(4, 1024, D).to(BF16)
    with pytest.raises(_Captured):
        layers.attention(x, p, cfg)
    q, k, v = seen["q"], seen["k"], seen["v"]
    assert (H, K, dh) == (32, 4, 64) and seen["kw"] == {
        "causal": True, "window": 0, "prefix": 0}
    assert q.shape == (4, 1024, 32, 64) and k.shape == v.shape == \
        (4, 1024, 4, 64) and q.dtype == BF16
    assert fa.tensor_core_route(q, k, v, torch.empty(q.shape, dtype=BF16))


def _bshd(B, S, n_heads, dh, dtype=BF16):
    return torch.empty((B, S, n_heads, dh), dtype=dtype)


def _misaligned(B, S, n_heads, dh):
    """A (B, S, heads, dh) view whose base pointer is 4 bytes past a
    16-byte boundary (strides still multiples of 16 bytes)."""
    flat = torch.empty(B * S * n_heads * dh + 2, dtype=BF16)
    return flat[2:].view(B, S, n_heads, dh)


def _odd_seq_stride(B, S, n_heads, dh):
    """Rows of heads*dh + 4 elements: a sequence stride of 8 mod 16 bytes."""
    rows = torch.empty((B, S, n_heads * dh + 4), dtype=BF16)
    return rows[..., :n_heads * dh].unflatten(-1, (n_heads, dh))


ROUTES = {  # name: (q, k, v, out) builder, expected tensor-core route
    "bf16_dh128": (lambda: (_bshd(2, 256, 16, 128), _bshd(2, 256, 8, 128),
                            _bshd(2, 256, 8, 128), _bshd(2, 256, 16, 128)),
                   True),
    "float32_dh64": (lambda: (_bshd(4, 128, 32, 64, torch.float32),
                              _bshd(4, 128, 4, 64, torch.float32),
                              _bshd(4, 128, 4, 64, torch.float32),
                              _bshd(4, 128, 32, 64, torch.float32)), False),
    "bf16_dh8": (lambda: (_bshd(2, 40, 4, 8), _bshd(2, 40, 2, 8),
                          _bshd(2, 40, 2, 8), _bshd(2, 40, 4, 8)), False),
    # phi-3-vision's head dim: dh 128's tile, 32 columns zero-filled
    "bf16_dh96": (lambda: (_bshd(2, 64, 4, 96), _bshd(2, 64, 2, 96),
                           _bshd(2, 64, 2, 96), _bshd(2, 64, 4, 96)), True),
    "float32_dh96": (lambda: (_bshd(2, 64, 4, 96, torch.float32),
                              _bshd(2, 64, 2, 96, torch.float32),
                              _bshd(2, 64, 2, 96, torch.float32),
                              _bshd(2, 64, 4, 96, torch.float32)), False),
    "bf16_dh80": (lambda: (_bshd(2, 64, 4, 80), _bshd(2, 64, 2, 80),
                           _bshd(2, 64, 2, 80), _bshd(2, 64, 4, 80)), False),
    "bf16_odd_seq_stride": (lambda: (_odd_seq_stride(2, 64, 4, 64),
                                     _bshd(2, 64, 2, 64), _bshd(2, 64, 2, 64),
                                     _bshd(2, 64, 4, 64)), False),
    "bf16_misaligned_base": (lambda: (_bshd(2, 64, 4, 64),
                                      _misaligned(2, 64, 2, 64),
                                      _bshd(2, 64, 2, 64),
                                      _bshd(2, 64, 4, 64)), False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_rule(name):
    build, tensor_cores = ROUTES[name]
    assert fa.tensor_core_route(*build()) is tensor_cores


@pytest.mark.parametrize("BH,BK,Sq,Sk,dh,causal,window,prefix", FLASH_SHAPES)
def test_reference_shapes_in_bfloat16_take_the_tensor_cores(
        BH, BK, Sq, Sk, dh, causal, window, prefix):
    """Each bfloat16 case of the reference's kernel test, as
    ``flash_attention_fwd`` passes it on (the B = 1 view)."""
    q, out = (torch.empty((BH, Sq, dh), dtype=BF16) for _ in range(2))
    k, v = (torch.empty((BK, Sk, dh), dtype=BF16) for _ in range(2))
    views = [fa.bshd_view(t) for t in (q, k, v, out)]
    assert views[0].shape == (1, Sq, BH, dh)
    assert fa.tensor_core_route(*views)
    assert not fa.tensor_core_route(*(t.float() for t in views))


def _byte_offset(layout, idx):
    """Byte offset of element (d, head, s, b) under a tensor map layout."""
    d, head, s, b = idx
    return 2 * d + sum(i * st for i, st in zip((head, s, b),
                                               layout["strides"]))


@pytest.mark.parametrize("make,dims,strides,box_cols", [
    # the models' (B, S, H, dh) layout at tinyllama's serve shape
    (lambda: _bshd(4, 1024, 32, 64), (64, 32, 1024, 4),
     (128, 4096, 4194304), (0,)),
    (lambda: _bshd(4, 1024, 4, 64), (64, 4, 1024, 4), (128, 512, 524288),
     (0,)),
    # the B = 1 view of flash_attention_fwd's (B*H, S, dh): heads are the
    # outer rows, so their stride exceeds the sequence stride
    (lambda: fa.bshd_view(torch.empty((4, 256, 64), dtype=BF16)),
     (64, 4, 256, 1), (32768, 128, 131072), (0,)),
    # dh 128: a tile is two 64-column boxes
    (lambda: fa.bshd_view(torch.empty((2, 384, 128), dtype=BF16)),
     (128, 2, 384, 1), (98304, 256, 196608), (0, 64)),
    (lambda: _bshd(2, 1024, 32, 128), (128, 32, 1024, 2),
     (256, 8192, 8388608), (0, 64)),
    # dh 96 (phi-3-vision's serve: 576 patches + 1024 tokens): two boxes, the
    # second's columns 96-127 outside the tensor
    (lambda: _bshd(4, 1600, 32, 96), (96, 32, 1600, 4),
     (192, 6144, 9830400), (0, 64)),
    (lambda: fa.bshd_view(torch.empty((8, 200, 96), dtype=BF16)),
     (96, 8, 200, 1), (38400, 192, 307200), (0, 64)),
])
def test_tensor_map_layouts(make, dims, strides, box_cols):
    t = make()
    lay = fa.tma_layout(t)
    assert lay["dims"] == dims and lay["strides"] == strides
    assert lay["box"] == (64, 1, 64, 1) and lay["box_cols"] == box_cols
    assert all(s % 16 == 0 for s in lay["strides"])
    # The byte strides address the element torch addresses.
    rng = np.random.default_rng(len(dims) + dims[2])
    base = t.data_ptr()
    for _ in range(20):
        b, s, head, d = (int(rng.integers(n)) for n in t.shape)
        assert base + _byte_offset(lay, (d, head, s, b)) == \
            t[b, s, head, d:].data_ptr()


@pytest.mark.parametrize("dh,boxes", [(64, 1), (96, 2), (128, 2)])
def test_tma_values_count_boxes_per_tile(dh, boxes):
    """The twelfth value the kernel checks: 64-column boxes per tile, dh / 64
    rounded up; the box stays 64 columns wide at every dh."""
    t = _bshd(1, 64, 2, dh)
    vals = fa._tma_values(tuple(t.shape), t.stride(), t.element_size())
    assert len(vals) == 12 and vals[0] == dh
    assert vals[7:11] == (64, 1, 64, 1) and vals[11] == boxes
    assert len(fa.tma_layout(t)["box_cols"]) == boxes


def test_phi3_vision_serve_tensors_take_the_tensor_cores(monkeypatch):
    """phi-3-vision's prefill hands the kernel 576 patches and 1024 tokens
    at dh 96 (B 4, 32 heads, bfloat16): the tensor-core route."""
    cfg = get_config("phi_3_vision_4_2b")
    H, K, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.dh, 16
    rng = np.random.default_rng(1)
    w = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    p = types.SimpleNamespace(wq=w(D, H, dh), wk=w(D, K, dh), wv=w(D, K, dh),
                              wo=w(H, dh, D), bq=None)
    seen = {}

    def capture(q, k, v, **kw):
        seen.update(q=q, k=k, v=v, kw=kw)
        raise _Captured

    monkeypatch.setattr(ops, "flash_attention", capture)
    with pytest.raises(_Captured):
        layers.attention(w(4, cfg.frontend_len + 1024, D).to(BF16), p, cfg)
    q, k, v = seen["q"], seen["k"], seen["v"]
    assert (H, K, dh, cfg.frontend_len) == (32, 32, 96, 576)
    assert q.shape == k.shape == v.shape == (4, 1600, 32, 96)
    assert seen["kw"] == {"causal": True, "window": 0, "prefix": 0}
    assert fa.tensor_core_route(q, k, v, torch.empty(q.shape, dtype=BF16))


def test_tensor_core_route_launches_or_raises_off_the_cpu(monkeypatch):
    """A call that the rule sends to the tensor cores, on a device with no
    kernel, raises through every entry point, and no launch is counted.
    Meta tensors stand for such a device: the launchers raise for them, and
    so do the wrappers once meta is not a plain device; as a plain device
    (the dry-run's shapes without data) meta takes the plain version."""
    LAUNCHES.clear()
    q = torch.zeros((1, 64, 8, 64), dtype=BF16, device="meta")
    k = torch.zeros((1, 64, 2, 64), dtype=BF16, device="meta")
    assert fa.tensor_core_route(q, k, k, q)
    for call in (fa.flash_attention_strided, fa.launch_cuda_core):
        with pytest.raises(ValueError, match="no kernel"):
            call(q, k, k, torch.empty_like(q))
    rows = q[0].transpose(0, 1), k[0].transpose(0, 1), k[0].transpose(0, 1)
    assert ops.flash_attention(q, k, k).shape == q.shape
    assert fa.flash_attention_fwd(*rows).shape == rows[0].shape
    for mod in (ops, fa):
        monkeypatch.setattr(mod, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_fwd(*rows)
    assert not LAUNCHES
