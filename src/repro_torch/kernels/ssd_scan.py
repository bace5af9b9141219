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
plain version on the CPU. The backward (``ssd_scan_backward``) is the
gradient of (y, final state) with respect to x, dt, A, B and C: on the
card one C entry (``ssd_scan_bwd_launch``) that recomputes the forward's
cum, C Bᵀ and entering states (passes 1-3), runs the chunk states of the
gradient and a reverse state pass, then the chunk-parallel gradient passes
and fixed-order reductions (no atomics); on CPU and meta tensors the plain
version, ``ssd_scan_backward_plain``, the same equations in torch ops with
the chunks in a Python loop. ``LAUNCHES["ssd_scan_backward"]`` counts
calls that reached the card. The reference has no backward kernel: XLA
derives its backward from the jnp ``layers.ssd``. The decay cumsum and its
reverse cumsum are float64 (ROADMAP queue C).
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
           "ssd_backward_work", "SSDScan", "call_work", "empty_outputs",
           "ssd_scan_backward_plain", "ssd_scan_backward", "ssd_bwd_plan"]

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


def ssd_scan_backward_plain(x, dt, A, B, C, dy, dstate=None,
                            chunk: int = 128):
    """The gradients (dx, ddt, dA, dB, dC) of (y, final state) of
    :func:`ssd_scan` from a zero state, given dy (Bb, S, H, P) and dstate
    (Bb, H, P, N; None for zeros): dx in x's dtype, the others float32.
    Written out, not autograd: per chunk c (Q rows, padded with dt = 0),
    head h and its group, with a = A dt, cum its float64 cumsum in the
    chunk, u = dt x, E_c the (N, P) state entering chunk c and
    D_{c+1} the gradient of the state leaving it,

    * D_c = sum_l e^{cum_l} C_l dy_l^T + e^{cum_Q} D_{c+1}, D_nc = dstate;
    * V_ls = (dy_l . u_s) e^{cum_l - cum_s} (s <= l) and dCB = sum over the
      group's heads of V; T = V * C Bᵀ;
    * du_s = sum_{l>=s} (C_l . B_s) e^{cum_l - cum_s} dy_l + W_s,
      W_s = e^{cum_Q - cum_s} D_{c+1}^T B_s; dx = dt du, ddt = x . du + A da;
    * dC_l = sum_s dCB_ls B_s + sum_h e^{cum_l} E_c dy_l and
      dB_s = sum_l dCB_ls C_l + sum_h e^{cum_Q - cum_s} D_{c+1} u_s;
    * dcum_l = sum_s T_ls - sum_l' T_l'l + dy_l . Yoff_l - u_l . W_l, the
      chunk's last row also z_c + sum_s u_s . W_s, with Yoff_l =
      e^{cum_l} E_c^T C_l and z_c = e^{cum_Q} <D_{c+1}, E_c>; da is its
      reverse cumsum (float64), dA = sum dt da.

    The kernel's passes compute the same terms in this order."""
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
    dyr = _pad_rows(dy.float(), pad).reshape(Bb, nc, Q, H, P)
    A = A.float()
    heads = lambda t: t.repeat_interleave(rep, dim=2)  # noqa: E731
    groups = lambda t: t.reshape(*t.shape[:2], G, rep, N).sum(3)  # noqa: E731
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    cum = torch.cumsum((A * dtr).double(), dim=2)            # (Bb, nc, Q, H)
    u = xr * dtr[..., None]
    # 1. the states entering each chunk, E_c (N, P)
    E = [x.new_zeros((Bb, H, N, P), dtype=torch.float32)]
    for c in range(nc - 1):
        decay = (cum[:, c, -1:] - cum[:, c]).float().exp()
        upd = torch.einsum("bshn,bshp->bhnp", heads(Br[:, c])
                           * decay[..., None], u[:, c])
        E.append(E[-1] * cum[:, c, -1].float().exp()[:, :, None, None]
                 + upd)
    # 2. the reverse state pass: D[c] is D_{c+1}
    D = [None] * nc
    carry = x.new_zeros((Bb, H, N, P), dtype=torch.float32) \
        if dstate is None else dstate.float().transpose(-1, -2)
    for c in reversed(range(nc)):
        D[c] = carry
        if c:
            g_c = torch.einsum("blhn,blhp->bhnp", heads(Cr[:, c])
                               * cum[:, c].float().exp()[..., None],
                               dyr[:, c])
            carry = g_c + cum[:, c, -1].float().exp()[:, :, None, None] \
                * carry
    # 3. the chunk-parallel gradients
    dx, ddt, dBs, dCs = [], [], [], []
    dA = 0.0
    for c in range(nc):
        cc = cum[:, c]
        seg = cc[:, :, None, :] - cc[:, None, :, :]          # (Bb, l, s, H)
        L = seg.masked_fill(~tri[None, :, :, None], float("-inf")) \
            .float().exp()
        CBh = torch.einsum("blgn,bsgn->blsg", Cr[:, c], Br[:, c]) \
            .repeat_interleave(rep, dim=3)
        V = torch.einsum("blhp,bshp->blsh", dyr[:, c], xr[:, c]) \
            * dtr[:, c][:, None] * L
        T = V * CBh
        dCB = V.reshape(Bb, Q, Q, G, rep).sum(-1)            # (Bb, l, s, G)
        ecum = cc.float().exp()                               # (Bb, Q, H)
        decay = (cc[:, -1:] - cc).float().exp()
        W = torch.einsum("bshn,bhnp->bshp", heads(Br[:, c]), D[c]) \
            * decay[..., None]
        du = torch.einsum("blsh,blhp->bshp", CBh * L, dyr[:, c]) + W
        Yoff = torch.einsum("blhn,bhnp->blhp", heads(Cr[:, c]), E[c]) \
            * ecum[..., None]
        w = (u[:, c] * W).sum(-1)                             # (Bb, Q, H)
        r = (dyr[:, c] * Yoff).sum(-1)
        dcum = T.double().sum(2) - T.double().sum(1) + (r - w).double()
        dcum[:, -1] += cc[:, -1].exp() * (D[c] * E[c]).sum((-1, -2)) \
            + w.sum(1)
        da = dcum.flip(1).cumsum(1).flip(1)                  # float64
        dx.append(du * dtr[:, c][..., None])
        ddt.append(((xr[:, c] * du).sum(-1) + A * da).float())
        dA = dA + (dtr[:, c] * da).sum((0, 1))
        dCs.append(torch.einsum("blsg,bsgn->blgn", dCB, Br[:, c])
                   + groups(torch.einsum("blhp,bhnp->blhn", dyr[:, c]
                                         * ecum[..., None], E[c])))
        dBs.append(torch.einsum("blsg,blgn->bsgn", dCB, Cr[:, c])
                   + groups(torch.einsum("bshp,bhnp->bshn", u[:, c]
                                         * decay[..., None], D[c])))
    cat = lambda ts: torch.cat(ts, dim=1)[:, :S]  # noqa: E731
    return (cat(dx).to(x.dtype), cat(ddt), dA.float(), cat(dBs), cat(dCs))


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


# The C entry points and their ctypes signatures.
_SIGNATURES = {
    "ssd_scan_launch": (
        [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2
        + [ctypes.c_void_p]),
    "ssd_scan_bwd_launch": (
        [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_void_p)]
        + [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=len(_SIGNATURES))  # one per C entry point
def _entry(name: str = "ssd_scan_launch"):
    """A C entry point of the kernel, its ctypes signature set once."""
    fn = getattr(kernel_library("ssd_scan"), name)
    fn.restype, fn.argtypes = ctypes.c_int, _SIGNATURES[name]
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


def ssd_bwd_plan(Bb: int, S: int, H: int, P: int, G: int, N: int,
                 chunk: int, dtype=torch.bfloat16) -> dict:
    """The backward's launch plan: ``ssd_plan``'s, and the scratch of the
    backward's own passes in the order its C entry takes them after the
    forward's four (the gradient states, dCB, the tile row and column sums
    of the cum gradient (float64), its r and w terms, the z slices, the dA
    partials (float64)), each (shape, dtype)."""
    plan = ssd_plan(Bb, S, H, P, G, N, chunk, dtype)
    sc, nc, QP = plan["scratch"], plan["nc"], plan["QP"]
    t64 = QP // BM
    f32, f64 = torch.float32, torch.float64
    plan["bwd_scratch"] = [
        (sc["cum"], f64), (sc["cb"], f32), (sc["states"], f32),
        ((Bb, H, P, N), f32), (sc["states"], f32), (sc["cb"], f32),
        ((Bb, H, nc, t64 * (t64 + 1) // 2, BM), f64),
        ((Bb, H, nc, t64 * (t64 + 1) // 2, BM), f64),
        ((Bb, H, nc, QP), f32), ((Bb, H, nc, QP), f32),
        ((Bb, H, nc, -(-N // PASS_ROWS)), f32), ((Bb, H, nc), f64)]
    return plan


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


def ssd_scan_backward(x, dt, A, B, C, dy, dstate=None, chunk: int = 128):
    """The gradients (dx, ddt, dA, dB, dC) of :func:`ssd_scan`'s (y, final
    state) given dy and dstate (None for zeros): dx in x's dtype, the
    others float32. CPU and meta tensors take the plain version
    (``ssd_scan_backward_plain``); CUDA tensors launch the kernel, which
    reads x through its strides, or raise."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if dt.shape != (Bb, S, H) or A.shape != (H,) or dy.shape != x.shape \
            or B.shape != (Bb, S, G, N) or C.shape != B.shape or H % G \
            or (dstate is not None and dstate.shape != (Bb, H, P, N)):
        raise ValueError("ssd_scan backward: inconsistent shapes")
    if x.device.type in PLAIN_DEVICES:
        return ssd_scan_backward_plain(x, dt, A, B, C, dy, dstate, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan backward has no kernel for {x.device}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)) + (
            (("dstate", dstate),) if dstate is not None else ()):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    dt, A, B, C = (t.contiguous() for t in (dt, A, B, C))
    dy = dy.to(device=x.device, dtype=x.dtype).contiguous()
    if dstate is not None:
        dstate = dstate.contiguous()
    plan = ssd_bwd_plan(Bb, S, H, P, G, N, chunk, x.dtype)
    ints = (ctypes.c_int * 4)(plan["Q"], plan["QP"], plan["nc"], plan["PS"])
    dev = x.device
    scratch = [torch.empty(shape, dtype=dtype, device=dev)
               for shape, dtype in plan["bwd_scratch"]]
    grads = [torch.empty(x.shape, dtype=x.dtype, device=dev),
             torch.empty((Bb, S, H), dtype=torch.float32, device=dev),
             torch.empty((H,), dtype=torch.float32, device=dev),
             torch.empty(B.shape, dtype=torch.float32, device=dev),
             torch.empty(C.shape, dtype=torch.float32, device=dev)]
    bufs = (ctypes.c_void_p * 17)(*(t.data_ptr() for t in scratch + grads))
    stream = torch.cuda.current_stream(dev)
    with record_launch("ssd_scan_backward", stream,
                       lambda: ssd_backward_work(x, dt, A, B, C, chunk)):
        rc = _entry("ssd_scan_bwd_launch")(
            x.data_ptr(), (ctypes.c_longlong * 3)(*x.stride()[:3]),
            *(t.data_ptr() for t in (dy, dt, A, B, C)),
            None if dstate is None else dstate.data_ptr(), bufs,
            _DTYPES[x.dtype], Bb, S, H, P, G, N, ints,
            vector_ok(x, P), vector_ok(dy, P),
            vector_ok(B, N) and vector_ok(C, N), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd_launch: CUDA error {rc} at launch")
    LAUNCHES["ssd_scan_backward"] += 1
    return tuple(grads)


class SSDScan(torch.autograd.Function):
    """The SSD scan with the kernel's forward and backward
    (``ssd_scan_backward``; the plain versions on the CPU):
    ``SSDScan.apply(x, dt, A, B, C, chunk) -> (y, state)``, shapes as in
    :func:`ssd_scan`, from a zero state."""

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
            grads = ssd_scan_backward(*saved, dy, dstate, ctx.chunk)
            return (*(g if n else None for g, n in zip(grads, needs)), None)
