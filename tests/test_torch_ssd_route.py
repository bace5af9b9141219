"""The SSD scan kernel's launch plan and its precision scheme, checked on the
CPU. The kernel (``csrc/ssd_scan.cu``) runs only on the card, where
``chip_smoke.py`` launches it and holds it against the plain version; here
the plan (grids, scratch) is held to the shapes the model and the reference
kernel tests pass in (the kernel sizes its own shared memory, which
``chip_smoke.py`` checks on the card), and an emulation of the kernel's four
passes with TF32 rounding (kept in this file, not in the package) shows that
split TF32 products (3xTF32) hold ``ssd_scan_plain`` within
``chip_smoke.py``'s bars where a single TF32 pass does not."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402

SSD_SHAPES = [                   # tests/test_kernels.py:42-62
    (2, 256, 4, 64, 1, 64, 64),
    (1, 200, 2, 32, 1, 16, 64),    # ragged
    (2, 128, 4, 64, 2, 32, 32),    # grouped B/C
    (1, 512, 8, 64, 1, 128, 128),  # mamba2-like dims
]
REDUCED_MAMBA2 = (1, 1024, 4, 64, 1, 128, 256)   # mamba2's widths, 4 heads
EIGHT_CHUNKS = (1, 2048, 2, 64, 1, 128, 256)
Y_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # chip_smoke.LM_TOL
STATE_TOL = 1e-4                                      # chip_smoke.STATE_TOL


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- the launch plan -----------------------------------------------------------

class _Captured(Exception):
    pass


def test_mamba2_serve_plan_spreads_chunks_and_shares_cb(monkeypatch):
    """The tensors mamba2-2.7b's prefill hands the scan at the serve shape
    (batch 4 x 1024 tokens, on the meta device): x is a strided bfloat16
    view that the kernel reads through its strides by 16-byte copies, and
    the plan spreads 1280 (batch, head, chunk) tiles over at least 1280
    blocks, with C Bᵀ computed once per (batch, chunk, group)."""
    cfg = get_config("mamba2_2_7b")
    seen = {}

    def capture(*a, **k):
        seen["args"] = a
        raise _Captured

    monkeypatch.setattr(layers, "ssd", capture)
    x_in = torch.empty((4, 1024, cfg.d_model), dtype=torch.bfloat16,
                       device="meta")
    with pytest.raises(_Captured):
        ssm._mix(x_in, ssm.Block(cfg, "meta"), cfg)
    x, dt, A, B, C, chunk = seen["args"]
    Bb, S, H, P = x.shape
    G, N = B.shape[2:]
    assert (Bb, S, H, P, G, N, chunk) == (4, 1024, 80, 64, 1, 128, 256)
    assert x.dtype == torch.bfloat16 and not x.is_contiguous()
    assert x.stride() == (1024 * 5376, 5376, 64, 1)
    # The same strides on the CPU: 16-byte rows, so no copy and cp.async.
    xs = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype)
    assert ss.vector_ok(xs, P)
    assert all(t.dtype == torch.float32 and t.is_contiguous()
               for t in (dt, A, B, C))
    assert ss.vector_ok(torch.empty(B.shape), N)

    plan = ss.ssd_plan(Bb, S, H, P, G, N, chunk, x.dtype)
    assert (plan["Q"], plan["QP"], plan["nc"], plan["PS"], plan["PW"]) == \
        (256, 256, 4, 64, 64)
    assert Bb * H * plan["nc"] == 1280           # (batch, head, chunk) tiles
    g = plan["grids"]
    assert g["chunk_state"] == (1280, 2, 1)       # 2560 blocks
    assert g["chunk_scan"] == (1280, 4, 1)        # 5120 blocks
    assert g["state_pass"] == (320, 4, 1)
    # C Bᵀ: 10 causal 64 x 64 tiles per (batch, chunk, group), not per head.
    assert g["cb"] == (4 * 4 * 1 * 10, 1, 1)
    blocks = {k: int(np.prod(v)) for k, v in g.items()}
    assert min(blocks["chunk_state"], blocks["chunk_scan"]) >= 1280
    nbytes = {k: int(np.prod(v)) * (8 if k == "cum" else 4)
              for k, v in plan["scratch"].items()}
    assert nbytes == {"cum": 4 * 80 * 4 * 256 * 8,
                      "cb": 4 * 4 * 10 * 64 * 64 * 4,         # 2.6 MB
                      "states": 4 * 80 * 4 * 128 * 64 * 4}    # 42 MB


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bb,S,H,P,G,N,chunk",
                         SSD_SHAPES + [EIGHT_CHUNKS,
                                       (1, 8192, 80, 64, 1, 128, 256),
                                       (1, 77, 2, 20, 2, 18, 32),
                                       (2, 700, 4, 128, 2, 200, 256),
                                       (1, 40000, 2, 32, 1, 16, 40000)])
def test_plan_at_reference_shapes(Bb, S, H, P, G, N, chunk, dtype):
    """The plan at the reference's shapes and chip_smoke.py's sweep shapes,
    a 40000-row chunk included: grids and scratch follow the chunk count
    and the causal 64-row tiles."""
    plan = ss.ssd_plan(Bb, S, H, P, G, N, chunk, dtype)
    Q, nc = min(chunk, S), plan["nc"]
    assert plan["Q"] == Q and nc == -(-S // Q)
    assert plan["QP"] % 64 == 0 and Q <= plan["QP"] < Q + 64
    assert plan["PS"] % 4 == 0 and P <= plan["PS"] <= plan["PW"]
    t64 = plan["QP"] // 64
    assert plan["grids"]["cb"] == (Bb * nc * G * t64 * (t64 + 1) // 2, 1, 1)
    assert plan["grids"]["chunk_scan"] == (Bb * H * nc, t64, 1)
    assert plan["grids"]["chunk_state"] == (Bb * H * nc, -(-N // 64), 1)
    assert plan["scratch"]["states"] == (Bb, H, nc, N, plan["PS"])
    assert plan["scratch"]["cb"] == (Bb, nc, G, t64 * (t64 + 1) // 2, 64, 64)
    assert plan["scratch"]["cum"] == (Bb, H, nc, plan["QP"])
    assert plan["grids"]["state_pass"] == (Bb * H, -(-N // 32), 1)


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 64, 2, 129, 1, 16, 64), torch.float32, "128 columns"),
    ((1, 64, 2, 32, 1, 16, 64), torch.float16, "no kernel"),
    ((1, 64, 3, 32, 2, 16, 64), torch.float32, "inconsistent"),
    ((1, 2 ** 31, 1, 32, 1, 16, 1), torch.float32, "grid limits"),
    ((1, 64, 2, 32, 1, 64 * 70000, 64), torch.bfloat16, "grid limits"),
])
def test_plan_refuses_what_the_kernel_does_not_take(shape, dtype, match):
    with pytest.raises(ValueError, match=match):
        ss.ssd_plan(*shape, dtype)


def test_vector_ok_needs_16_byte_rows():
    x = torch.empty((2, 8, 4, 64), dtype=torch.bfloat16)
    assert ss.vector_ok(x, 64)
    assert not ss.vector_ok(x[..., :60], 60)             # 120-byte rows
    flat = torch.empty(2 * 8 * 4 * 64 + 2, dtype=torch.bfloat16)
    assert not ss.vector_ok(flat[2:].view(2, 8, 4, 64), 64)   # 4 bytes off
    assert ss.vector_ok(torch.empty((1, 8, 1, 16)), 16)
    assert not ss.vector_ok(torch.empty((1, 8, 1, 18)), 18)


def test_non_cuda_tensors_raise_and_count_nothing(monkeypatch):
    """Meta tensors stand for a device with no kernel once meta is not a
    plain device (as one, they take the plain version)."""
    LAUNCHES.clear()
    x = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    dt = torch.zeros((1, 8, 2), device="meta")
    Bm = torch.zeros((1, 8, 1, 16), device="meta")
    y, _ = ss.ssd_scan(x, dt, torch.zeros((2,), device="meta"), Bm, Bm)
    assert y.device.type == "meta" and y.shape == x.shape
    monkeypatch.setattr(ss, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="no kernel"):
        ss.ssd_scan(x, dt, torch.zeros((2,), device="meta"), Bm, Bm)
    with pytest.raises(ValueError, match="inconsistent"):
        ss.ssd_scan(x, dt, torch.zeros((3,), device="meta"), Bm, Bm)
    assert not LAUNCHES


# -- the precision scheme --------------------------------------------------------

def _tf32(a):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the dropped ulp to the
    bit pattern, then mask."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b as the kernel takes it: a_lo b_hi + a_hi b_lo + a_hi b_hi, each
    part TF32, products of TF32 values exact in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    """A single TF32 pass."""
    return _tf32(a) @ _tf32(b)


def emulate(x, dt, A, B, C, chunk, mm):
    """The kernel's four passes in plain torch, every product through
    ``mm``: the chunk states with dt and the decay folded into B, C Bᵀ per
    group, the state passing, and the chunk scan with dt and L folded into
    C Bᵀ and exp(cum) applied after C S. cum and its differences are
    float64, as in the kernel."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2:]
    rep = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)

    def chunks(t):            # (Bb, S, k, ...) -> (Bb, nc, k, Q, ...)
        t = torch.cat([t, t.new_zeros((Bb, nc * Q - S, *t.shape[2:]))], 1)
        return t.reshape(Bb, nc, Q, *t.shape[2:]).transpose(2, 3)

    xr = chunks(x.float())                                  # (Bb,nc,H,Q,P)
    dtr = chunks(dt.float()[..., None])[..., 0]             # (Bb,nc,H,Q)
    Br, Cr = chunks(B.float()), chunks(C.float())           # (Bb,nc,G,Q,N)
    cum = torch.cumsum((A.float()[:, None] * dtr).double(), -1)
    ce = cum[..., -1]                                       # (Bb,nc,H)
    # 1. chunk states (N, P) per (b, h, c)
    wdec = (ce[..., None] - cum).float().exp() * dtr
    Bd = Br.repeat_interleave(rep, 2) * wdec[..., None]
    states = mm(Bd.transpose(-1, -2), xr)
    # 2. C Bᵀ once per group
    CB = mm(Cr, Br.transpose(-1, -2))                       # (Bb,nc,G,Q,Q)
    # 3. state passing
    s = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * ce[:, c].float().exp()[..., None, None] + states[:, c]
    prev = torch.stack(prev, 1)
    # 4. chunk scan
    seg = (cum[..., :, None] - cum[..., None, :]).float()
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    M = torch.where(tri, CB.repeat_interleave(rep, 2) * seg.exp()
                    * dtr[..., None, :], 0.0)
    y = mm(Cr.repeat_interleave(rep, 2), prev) * cum.float().exp()[..., None] \
        + mm(M, xr)
    y = y.transpose(2, 3).reshape(Bb, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), s.transpose(-1, -2)


def _inputs(shape, dtype, seed):
    """chip_smoke.py's sweep distribution: randn x, B and C, dt in
    [0.01, 0.2], A in [-2, -0.5]."""
    Bb, S, H, P, G, N, _ = shape
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = f(rng.normal(size=(Bb, S, H, P))).to(dtype)
    dt = f(rng.uniform(0.01, 0.2, size=(Bb, S, H)))
    A = f(-rng.uniform(0.5, 2.0, size=(H,)))
    B = f(rng.normal(size=(Bb, S, G, N)))
    C = f(rng.normal(size=(Bb, S, G, N)))
    return x, dt, A, B, C


def _errors(shape, dtype, mm, seed=0):
    x, dt, A, B, C = _inputs(shape, dtype, seed)
    chunk = shape[-1]
    y, st = emulate(x, dt, A, B, C, chunk, mm)
    yr, sr = ss.ssd_scan_plain(x, dt, A, B, C, chunk)

    def within(got, ref, tol):
        d = (got.float() - ref.float()).abs()
        return float(d.max()), bool((d <= tol + tol * ref.float().abs()).all())

    return within(y, yr, Y_TOL[dtype]), within(st, sr, STATE_TOL)


@pytest.mark.parametrize("shape,dtype", [
    *((s, torch.float32) for s in SSD_SHAPES),
    (SSD_SHAPES[1], torch.bfloat16),
    (REDUCED_MAMBA2, torch.float32),
    (REDUCED_MAMBA2, torch.bfloat16),
    (EIGHT_CHUNKS, torch.float32),
])
def test_split_tf32_passes_hold_the_plain_version(shape, dtype):
    (e_y, ok_y), (e_s, ok_s) = _errors(shape, dtype, _mm3)
    assert ok_y, f"y off the plain version by {e_y:.3e}"
    assert ok_s, f"state off the plain version by {e_s:.3e}"


def test_emulated_passes_without_rounding_equal_the_plain_version():
    """The pass structure itself (dt folded into the other operand, C Bᵀ per
    group, state passing, exp(cum) after C S) is the plain version's
    function: with float32 products it leaves it only by rounding."""
    (e_y, _), (e_s, _) = _errors(REDUCED_MAMBA2, torch.float32,
                                 torch.matmul)
    assert e_y < 1e-5 and e_s < 1e-5


@pytest.mark.parametrize("shape", [REDUCED_MAMBA2, EIGHT_CHUNKS])
def test_single_pass_tf32_misses_the_bars(shape):
    (e_y, ok_y), (e_s, ok_s) = _errors(shape, torch.float32, _mm1)
    assert not (ok_y and ok_s), (e_y, e_s)
    assert e_y > 10 * Y_TOL[torch.float32]


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                     # exactly one TF32 ulp above 1
    a = torch.tensor([1.0, one, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0e-3], dtype=torch.float32)
    r = _tf32(a)
    assert r[:5].tolist() == [1.0, one, one, 1.0, -one]
    assert abs(float(r[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    hi = _tf32(a)
    lo = _tf32(a - hi)
    assert torch.equal(hi + lo, a)             # two parts hold these exactly
