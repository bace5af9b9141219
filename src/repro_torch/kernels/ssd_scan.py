"""Mamba-2 SSD chunked scan: the kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``. The TPU
kernel carried the (N, P) inter-chunk state in VMEM across a sequential
chunk grid dimension; the CUDA kernel (``csrc/ssd_scan.cu``) splits the scan
into four chunk-parallel passes: the chunk states (with the cumsum of
A * dt), C Bᵀ once per group, the state passing over the chunks, and the
chunk scan. Its products run on the tensor cores in TF32, split into high
and low parts for float32 accuracy (3xTF32). ``ssd_plan`` is its launch
plan: grids and the scratch the wrapper allocates (the kernels allocate
nothing); the kernel sizes its own shared memory (``smem_bytes`` asks it).
The chunk is Q = min(chunk, S); the sequence is padded to a multiple of Q
with dt = 0, which is exact (identity decay, zero update). Both versions
take the cumsum of A * dt within a chunk, and its differences, in float64:
at mamba2's decay rates it reaches a few thousand, where a float32 cumsum
(the TPU kernel's) loses 1e-4 absolute.

``LAUNCHES["ssd_scan"]`` counts calls of the wrapper that reached the card
(one per prefill layer), not the four device launches of each.

The plain version runs the same chunked math with torch ops, all (batch,
head) pairs at once and the chunks in a Python loop.

Training (``SSDScan``, the autograd Function that ``ops.ssd`` takes
whenever grad is enabled): the forward is the kernel on the card and the
plain version on the CPU; the backward recomputes the chunked scan in
torch ops from the saved inputs (``ssd_scan_plain`` under ``enable_grad``)
and differentiates it with ``torch.autograd.grad``. This is the
counterpart of the reference's backward, which XLA derives from the jnp
``layers.ssd``; the reference has no backward kernel. That recompute is the
one place where the plain scan's math runs on the card, and it is the
backward, not a stand-in for the forward kernel. Its decay cumsum is
float64, as the forward's (ROADMAP queue C).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import PLAIN_DEVICES, kernel_library
from repro_torch.kernels import LAUNCHES
from repro_torch.obs.compiled import (
    HBM_BYTES_PER_S,
    PEAK_OPS_PER_S,
    kernel_call,
    record_launch,
)

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_plan", "smem_bytes",
           "vector_ok", "ssd_ops", "ssd_bounds", "ssd_work",
           "ssd_backward_work", "SSDScan", "call_work", "empty_outputs"]

GRID_X_LIMIT = 2 ** 31 - 1   # largest x grid dimension
GRID_LIMIT = 65535           # largest y and z grid dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/ssd_scan.cu: 64-row tiles (output rows, state rows, C Bᵀ tiles), 32
# state rows per state-pass block.
BM, PASS_ROWS = 64, 32


def _pad_rows(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the sequence axis (dim 1) by ``pad`` rows."""
    if not pad:
        return a
    return torch.cat([a, a.new_zeros((a.shape[0], pad, *a.shape[2:]))], 1)


def ssd_scan_plain(x, dt, A, B, C, chunk: int = 128, init_state=None):
    """Plain PyTorch version of :func:`ssd_scan`, the chunk body of the TPU
    kernel in float32 with, as the kernel, the cumsum of A * dt and its
    differences in float64. ``init_state`` (Bb, H, P, N) is the state
    entering the first chunk (zero when None; the kernel has none)."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q
    xr = _pad_rows(x.float(), pad).reshape(Bb, nc, Q, H, P)
    dtr = _pad_rows(dt.float(), pad).reshape(Bb, nc, Q, H)
    Br = _pad_rows(B.float(), pad).reshape(Bb, nc, Q, G, N)
    Cr = _pad_rows(C.float(), pad).reshape(Bb, nc, Q, G, N)
    A = A.float()
    if init_state is None:
        state = x.new_zeros((Bb, H, N, P), dtype=torch.float32)
    else:
        state = init_state.float().transpose(-1, -2)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):
        xdt = xr[:, c] * dtr[:, c, :, :, None]                 # (Bb, Q, H, P)
        cum = torch.cumsum((A * dtr[:, c]).double(), dim=1)   # (Bb, Q, H)
        seg = (cum[:, :, None, :] - cum[:, None, :, :]).float()  # (Bb, l, s, H)
        # Masked before the exp: above the diagonal seg is positive and its
        # exp may overflow, which a where after the exp would turn into a
        # NaN gradient (0 * inf).
        L = seg.masked_fill(~tri[None, :, :, None], float("-inf")).exp()
        CB = torch.einsum("blgn,bsgn->blsg", Cr[:, c], Br[:, c])
        Yd = torch.einsum("blsh,bshp->blhp",
                          CB.repeat_interleave(rep, dim=3) * L, xdt)
        Ch = Cr[:, c].repeat_interleave(rep, dim=2)            # (Bb, Q, H, N)
        Yoff = torch.einsum("blhn,bhnp->blhp",
                            Ch * cum.float().exp()[..., None], state)
        ys.append(Yd + Yoff)
        decay = (cum[:, -1:] - cum).float().exp()              # (Bb, Q, H)
        Bh = Br[:, c].repeat_interleave(rep, dim=2)
        upd = torch.einsum("bshn,bshp->bhnp", Bh * decay[..., None], xdt)
        state = state * cum[:, -1].float().exp()[:, :, None, None] + upd
    y = torch.cat(ys, dim=1)[:, :S].to(x.dtype)
    return y, state.transpose(-1, -2)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def ssd_plan(Bb: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
             dtype=torch.bfloat16) -> dict:
    """The kernel's launch plan for x of ``dtype``: the chunk Q, its padding
    QP (a multiple of 64), the chunk count nc, the state's padded width PS,
    the P tile width PW, each pass's grid, and the scratch shapes (cum
    float64, scaled by log2(e); cb, the causal 64 x 64 tiles of C Bᵀ, and
    states float32). Raises ValueError for a shape the kernel does not take."""
    if dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: no kernel for x of {dtype}")
    if min(Bb, S, H, P, G, N, chunk) < 1 or H % G:
        raise ValueError("ssd_scan: inconsistent shapes")
    if P > 128:
        raise ValueError(f"ssd_scan: P={P} exceeds the kernel's 128 columns")
    Q = min(chunk, S)
    QP, nc, PS = _up(Q, BM), -(-S // Q), _up(P, 4)
    PW = 64 if P <= 64 else 128
    t64 = QP // BM
    ntiles = t64 * (t64 + 1) // 2       # causal 64 x 64 tiles of C Bᵀ
    grids = {
        "chunk_state": (Bb * H * nc, -(-N // BM), 1),
        "cb": (Bb * nc * G * ntiles, 1, 1),
        "state_pass": (Bb * H, -(-N // PASS_ROWS), 1),
        "chunk_scan": (Bb * H * nc, t64, 1),
    }
    if max(g[0] for g in grids.values()) > GRID_X_LIMIT \
            or max(g[1] for g in grids.values()) > GRID_LIMIT:
        raise ValueError(f"ssd_scan: Bb*H*nc={Bb * H * nc}, N={N} or chunk "
                         f"{Q} exceeds the grid limits")
    return {"Q": Q, "QP": QP, "nc": nc, "PS": PS, "PW": PW,
            "grids": grids,
            "scratch": {"cum": (Bb, H, nc, QP),
                        "cb": (Bb, nc, G, ntiles, BM, BM),
                        "states": (Bb, H, nc, N, PS)}}


def vector_ok(t: torch.Tensor, width: int) -> bool:
    """Whether the kernel may read rows of ``width`` elements of ``t`` by
    16-byte copies: base pointer, the strides of every dimension but the
    last, and the width all multiples of 16 bytes."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and width * es % 16 == 0 and \
        all(s * es % 16 == 0 for s in t.stride()[:-1])


@functools.lru_cache(maxsize=1)  # the one C entry point
def _entry():
    """The kernel's C entry point, its ctypes signature set once."""
    fn = kernel_library("ssd_scan").ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    return fn


def smem_bytes(dtype, P: int) -> dict:
    """Dynamic shared memory per block of each pass for x of ``dtype`` and
    ``P`` columns, as the kernel sizes it (none depends on the chunk, N or
    the batch)."""
    out = (ctypes.c_int * 4)()
    rc = kernel_library("ssd_scan").ssd_scan_smem(_DTYPES[dtype], P, out)
    if rc:
        raise ValueError(f"ssd_scan_smem: error {rc} for {dtype}, P={P}")
    return dict(zip(("chunk_state", "cb", "state_pass", "chunk_scan"), out))


@functools.lru_cache(maxsize=64)
def _plan_args(Bb, S, H, P, G, N, chunk, dtype, x_stride):
    """The plan and its ctypes arrays, cached: a serve calls with the same
    shapes again and again."""
    plan = ssd_plan(Bb, S, H, P, G, N, chunk, dtype)
    ints = (ctypes.c_int * 4)(plan["Q"], plan["QP"], plan["nc"], plan["PS"])
    return plan, ints, (ctypes.c_longlong * 3)(*x_stride[:3])


def ssd_ops(Bb: int, S: int, H: int, P: int, G: int, N: int,
            Q: int) -> tuple[int, int]:
    """Operations of the chunked SSD scan on these inputs, two per
    multiply-add, split by operand: (the products with x: the causal
    (C B^T .* L .* dt) x and the state update; the others: C B^T on the
    causal half once per group and C times the entering state, none for the
    first chunk, whose state is zero)."""
    x_ops = other_ops = 0
    for c, t0 in enumerate(range(0, S, Q)):
        q = min(Q, S - t0)
        pairs = q * (q + 1) // 2
        x_ops += 2 * Bb * H * (pairs * P + q * N * P)
        other_ops += 2 * Bb * (G * pairs * N + (H * q * N * P if c else 0))
    return x_ops, other_ops


def ssd_bounds(n_bytes: float, x_ops: int, other_ops: int,
               x_bf16: bool) -> dict:
    """Bounds of the SSD scan, (ms, by), under four rates for its products:
    "row", the least time at f32 accuracy on the tensor cores, where a
    product with a bfloat16 x (exact in bf16) splits its f32 operand into
    three bf16 parts (three products at the dense bf16 rate) and every
    other product takes three TF32 products; "kernel", the kernel's own
    scheme (two TF32 products with a bfloat16 x, three elsewhere);
    "tf32_3", three TF32 products each; "f32", the CUDA cores in f32."""
    tf32, bf16 = PEAK_OPS_PER_S["tf32"], PEAK_OPS_PER_S["bf16"]
    x3 = x_ops * 3 / tf32
    rest = other_ops * 3 / tf32
    t_ops = {
        "row": (x_ops * 3 / bf16 if x_bf16 else x3) + rest,
        "kernel": (x_ops * 2 / tf32 if x_bf16 else x3) + rest,
        "tf32_3": x3 + rest,
        "f32": (x_ops + other_ops) / PEAK_OPS_PER_S["f32"]}
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return {k: (t_bytes * 1e3, "bytes") if t_bytes >= t else
            (t * 1e3, "operations") for k, t in t_ops.items()}


def ssd_work(x, dt, A, B, C, y, state, chunk: int) -> dict:
    """Work of one scan call (its four passes): x, dt, A, B, C read once, y
    and the final state written once, and the products of ``ssd_ops`` as
    the "row" bound of ``ssd_bounds`` counts them: three products per
    f32-accurate product, at the bfloat16 rate for those with a bfloat16
    x, at the TF32 rate for the others."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    x_ops, other_ops = ssd_ops(Bb, S, H, P, G, N, min(chunk, S))
    x_class = "bf16" if x.dtype == torch.bfloat16 else "tf32"
    ops = {"tf32": 3 * other_ops}
    ops[x_class] = ops.get(x_class, 0) + 3 * x_ops
    return {"bytes": sum(t.numel() * t.element_size()
                         for t in (x, dt, A, B, C, y, state)),
            "ops": ops}


def ssd_backward_work(x, dt, A, B, C, chunk: int) -> dict:
    """Work of one scan backward (``SSDScan.backward``'s function): x, dt,
    A, B, C, the gradients of y and of the final state read once, the
    gradients of x, dt, A, B, C written once, and each product of
    ``ssd_ops`` twice (a product's two operand gradients), at the rates
    ``ssd_work`` counts them."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    x_ops, other_ops = ssd_ops(Bb, S, H, P, G, N, min(chunk, S))
    x_class = "bf16" if x.dtype == torch.bfloat16 else "tf32"
    ops = {"tf32": 6 * other_ops}
    ops[x_class] = ops.get(x_class, 0) + 6 * x_ops
    ins = sum(t.numel() * t.element_size() for t in (x, dt, A, B, C))
    return {"bytes": 2 * ins + x.numel() * x.element_size()
            + Bb * H * P * N * 4, "ops": ops}


def call_work(x, dt, A, B, C, chunk: int, backward: bool = False) -> dict:
    """``{"flops", "bytes"}`` of one scan call (or its backward), for the
    op analysis (``obs.compiled.kernel_call``): the bytes of ``ssd_work``
    (``ssd_backward_work``) and the products of ``ssd_ops`` once (twice),
    each counted once and not as the three tensor-core products that
    carry it to f32 accuracy."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    flops = sum(ssd_ops(Bb, S, H, P, G, N, min(chunk, S)))
    if backward:
        return {"flops": 2 * flops,
                "bytes": ssd_backward_work(x, dt, A, B, C, chunk)["bytes"]}
    ins = sum(t.numel() * t.element_size() for t in (x, dt, A, B, C))
    return {"flops": flops, "bytes": ins + x.numel() * x.element_size()
            + Bb * H * P * N * 4}


def empty_outputs(x, B):
    """Empty (y, final state) of a scan of x and B: what a call under a
    meta trace returns (``kernel_call``'s ``shapes_only``)."""
    Bb, _, H, P = x.shape
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty((Bb, H, P, B.shape[3]), dtype=torch.float32,
                        device=x.device))


def ssd_scan(x, dt, A, B, C, chunk: int = 128):
    """x: (Bb, S, H, P) float32 or bfloat16; dt: (Bb, S, H); A: (H,);
    B/C: (Bb, S, G, N), float32. Returns (y, final_state): y (Bb, S, H, P)
    in x.dtype, state (Bb, H, P, N) float32. CPU and meta tensors take the
    plain version; CUDA tensors launch the kernel, which reads x through its
    strides (a copy only when its last dim is not contiguous)."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if dt.shape != (Bb, S, H) or A.shape != (H,) \
            or B.shape != (Bb, S, G, N) or C.shape != B.shape or H % G:
        raise ValueError("ssd_scan: inconsistent shapes")
    if x.device.type in PLAIN_DEVICES:
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan has no kernel for {x.device}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    dt, A, B, C = (t.contiguous() for t in (dt, A, B, C))
    plan, ints, x_strides = _plan_args(Bb, S, H, P, G, N, chunk, x.dtype,
                                       x.stride())
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    sc = plan["scratch"]
    cum = torch.empty(sc["cum"], dtype=torch.float64, device=x.device)
    cb = torch.empty(sc["cb"], dtype=torch.float32, device=x.device)
    states = torch.empty(sc["states"], dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    with record_launch("ssd_scan", stream, lambda: ssd_work(
            x, dt, A, B, C, y, state, chunk)):
        rc = _entry()(x.data_ptr(), x_strides,
                      *(t.data_ptr() for t in (dt, A, B, C, y, state, cum,
                                               cb, states)),
                      _DTYPES[x.dtype], Bb, S, H, P, G, N, ints,
                      int(vector_ok(x, P)),
                      int(vector_ok(B, N) and vector_ok(C, N)),
                      stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_launch: CUDA error {rc} at launch")
    LAUNCHES["ssd_scan"] += 1
    return y, state


class SSDScan(torch.autograd.Function):
    """The SSD scan with the kernel's forward (the plain version on the CPU)
    and a backward that differentiates the plain version recomputed from
    the inputs: ``SSDScan.apply(x, dt, A, B, C, chunk) -> (y, state)``,
    shapes as in :func:`ssd_scan`, from a zero state."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        with kernel_call("ssd_scan", lambda: call_work(x, dt, A, B, C, chunk),
                         x, dt, A, B, C) as call:
            if call.shapes_only:
                return empty_outputs(x, B)
            return ssd_scan(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        with kernel_call("ssd_scan_backward", lambda: call_work(
                *saved, ctx.chunk, backward=True), *saved) as call:
            if call.shapes_only:
                return (*(torch.empty_like(t) if n else None
                          for t, n in zip(saved, needs)), None)
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(n)
                       for t, n in zip(saved, needs)]
                y, state = ssd_scan_plain(*ins, ctx.chunk)
                wrt = [t for t in ins if t.requires_grad]
                got = iter(torch.autograd.grad((y, state), wrt, (dy, dstate),
                                               allow_unused=True))
            return (*(next(got) if n else None for n in needs), None)
