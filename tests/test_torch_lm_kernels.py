"""The LM kernels' plain versions against the reference's Pallas kernels
(interpret mode) and oracles, at the reference's own bars
(``tests/test_kernels.py``): flash attention 2e-5 in float32 and 2e-2 in
bfloat16, the SSD scan 1e-4. Inputs are made with numpy from a seed. The
CUDA kernels themselves run only on the card (``chip_smoke.py``)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd as ref_flash  # noqa: E402
from repro.kernels.ref import attention_ref, ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan  # noqa: E402

from repro_torch import device as port_device  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402

FLASH_SHAPES = [                 # tests/test_kernels.py:17-39
    (4, 2, 256, 256, 64, True, 0, 0),      # GQA causal
    (2, 2, 384, 384, 128, True, 0, 0),     # MHA, dh=128
    (4, 1, 128, 512, 64, False, 0, 0),     # cross attention (enc-dec)
    (2, 2, 512, 512, 64, True, 128, 16),   # sliding window + meta prefix
    (2, 1, 200, 300, 64, True, 0, 0),      # ragged (padding path)
    (1, 1, 640, 640, 64, True, 256, 0),    # window without prefix
]
SSD_SHAPES = [                   # tests/test_kernels.py:42-62
    (2, 256, 4, 64, 1, 64, 64),
    (1, 200, 2, 32, 1, 16, 64),    # ragged
    (2, 128, 4, 64, 2, 32, 32),    # grouped B/C
    (1, 512, 8, 64, 1, 128, 128),  # mamba2-like dims
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _pair(a: np.ndarray, jdt, tdt):
    """The same values as a jax array and a torch tensor of one dtype."""
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("BH,BK,Sq,Sk,dh,causal,window,prefix", FLASH_SHAPES)
def test_flash_plain_matches_reference(BH, BK, Sq, Sk, dh, causal, window,
                                       prefix, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(BH * 1000 + Sq + Sk + dh + window)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=shape), jdt, tdt)
        for shape in ((BH, Sq, dh), (BK, Sk, dh), (BK, Sk, dh)))
    kw = dict(causal=causal, window=window, prefix=prefix)
    got = flash_attention_fwd(qt, kt, vt, **kw)
    assert got.dtype == tdt and got.shape == (BH, Sq, dh)
    for ref in (ref_flash(qj, kj, vj, interpret=True, **kw),
                attention_ref(qj, kj, vj, **kw)):
        np.testing.assert_allclose(got.float().numpy(), _f32(ref), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("B,S,H,K,dh,window,prefix", [
    (2, 96, 4, 2, 32, 0, 0),
    (1, 160, 4, 1, 64, 48, 8),
])
def test_flash_bshd_layout_matches_reference_ops(B, S, H, K, dh, window,
                                                 prefix):
    """ops.flash_attention on the models' (B, S, H, dh) layout: query head
    h of batch b reads kv head h // (H / K) of batch b."""
    rng = np.random.default_rng(S + dh)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=shape), jnp.float32, torch.float32)
        for shape in ((B, S, H, dh), (B, S, K, dh), (B, S, K, dh)))
    got = ops.flash_attention(qt, kt, vt, window=window, prefix=prefix)
    ref = ref_ops.flash_attention(qj, kj, vj, window=window, prefix=prefix,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), _f32(ref), atol=2e-5, rtol=2e-5)


def _ssd_inputs(rng, Bb, S, H, P, G, N):
    return (rng.normal(size=(Bb, S, H, P)),
            rng.uniform(0.01, 0.2, size=(Bb, S, H)),
            -rng.uniform(0.5, 2.0, size=(H,)),
            rng.normal(size=(Bb, S, G, N)),
            rng.normal(size=(Bb, S, G, N)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("Bb,S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_plain_matches_reference(Bb, S, H, P, G, N, chunk, dtype):
    """y and the final state against the Pallas kernel (interpret) and the
    token-by-token oracle: 1e-4 with float32 x; with bfloat16 x (y rounded
    to bfloat16) the reference's bfloat16 kernel bar, 2e-2."""
    jdt, tdt, _ = DTYPES[dtype]
    tol = 1e-4 if dtype == "float32" else 2e-2
    arrs = _ssd_inputs(np.random.default_rng(S + N + chunk), Bb, S, H, P, G, N)
    (xj, xt), *rest = [_pair(a, jdt if i == 0 else jnp.float32,
                             tdt if i == 0 else torch.float32)
                       for i, a in enumerate(arrs)]
    dtj, Aj, Bj, Cj = (j for j, _ in rest)
    y, st = ssd_scan(xt, *(t for _, t in rest), chunk=chunk)
    assert y.dtype == tdt and st.shape == (Bb, H, P, N)
    for yr, sr in (ref_ssd_scan(xj, dtj, Aj, Bj, Cj, chunk=chunk,
                                interpret=True),
                   ssd_ref(xj, dtj, Aj, Bj, Cj)):
        np.testing.assert_allclose(y.float().numpy(), _f32(yr), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(st.numpy(), _f32(sr), atol=1e-4,
                                   rtol=1e-4)


def test_ssd_init_state_on_the_cpu_matches_oracle():
    """ops.ssd carries an initial state on the CPU (the kernel has none)."""
    arrs = _ssd_inputs(np.random.default_rng(5), 2, 96, 4, 32, 1, 16)
    init = np.random.default_rng(6).normal(size=(2, 4, 32, 16))
    j = [jnp.asarray(a, jnp.float32) for a in (*arrs, init)]
    t = [torch.from_numpy(np.array(a, np.float32)) for a in (*arrs, init)]
    y, st = ops.ssd(*t[:5], chunk=32, init_state=t[5])
    yr, sr = ssd_ref(*j[:5], init_state=j[5])
    np.testing.assert_allclose(y.numpy(), _f32(yr), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), _f32(sr), atol=1e-4, rtol=1e-4)


def test_wrappers_launch_or_raise_off_the_cpu(monkeypatch):
    """Only CPU and meta tensors take the plain versions; any other device
    launches the kernel or raises (here: meta tensors standing for a device
    with no kernel at all, once meta is not a plain device). No plain
    version runs there and no launch is counted."""
    LAUNCHES.clear()
    q = torch.zeros((2, 8, 16), device="meta")
    x4 = torch.zeros((1, 8, 2, 16), device="meta")
    x = torch.zeros((1, 8, 2, 4), device="meta")
    dt = torch.zeros((1, 8, 2), device="meta")
    A = torch.zeros((2,), device="meta")
    Bm = torch.zeros((1, 8, 1, 4), device="meta")
    assert flash_attention_fwd(q, q[:1], q[:1]).device.type == "meta"
    assert ssd_scan(x, dt, A, Bm, Bm)[0].shape == x.shape
    for mod in ("ops", "flash_attention", "ssd_scan"):
        # the modules (the package attributes of two names are functions)
        monkeypatch.setattr(importlib.import_module(
            f"repro_torch.kernels.{mod}"), "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_fwd(q, q[:1], q[:1])
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(x4, x4[:, :, :1], x4[:, :, :1])
    with pytest.raises(ValueError, match="no kernel"):
        ssd_scan(x, dt, A, Bm, Bm)
    with pytest.raises(NotImplementedError, match="zero state"):
        ops.ssd(x, dt, A, Bm, Bm, init_state=torch.zeros((1, 2, 4, 4)))
    with pytest.raises(ValueError, match="inconsistent"):
        flash_attention_fwd(torch.zeros((3, 8, 16)), torch.zeros((2, 8, 16)),
                            torch.zeros((2, 8, 16)))
    assert not LAUNCHES


def test_kernels_are_built_from_source_or_not_at_all(tmp_path, monkeypatch):
    """Without nvcc a kernel library cannot be built: the build raises and
    leaves nothing behind, rather than falling back to a plain version."""
    monkeypatch.setattr(port_device, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    for name in ("flash_attention", "ssd_scan"):
        assert name in port_device.KERNEL_SOURCES
        with pytest.raises(RuntimeError, match="nvcc not found"):
            port_device.build_kernels((name,))
    assert not list((tmp_path / "build").glob("*.so"))
