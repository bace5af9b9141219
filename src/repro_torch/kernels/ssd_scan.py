"""Mamba-2 SSD chunked scan: the kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``. The TPU
kernel carried the (N, P) inter-chunk state in VMEM across a sequential
chunk grid dimension; the CUDA kernel (``csrc/ssd_scan.cu``) gives each
(batch, head) one block that loops over the chunks with the state in shared
memory. The chunk is Q = min(chunk, S); the sequence is padded to a multiple
of Q with dt = 0, which is exact (identity decay, zero update). Both versions
take the cumsum of A * dt within a chunk, and its differences, in float64:
at mamba2's decay rates it reaches a few thousand, where a float32 cumsum
(the TPU kernel's) loses 1e-4 absolute.

The plain version runs the same chunked math with torch ops, all (batch,
head) pairs at once and the chunks in a Python loop.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import kernel_library
from repro_torch.kernels import LAUNCHES

__all__ = ["ssd_scan", "ssd_scan_plain"]

_SMEM_LIMIT = 232448         # bytes of shared memory one H100 block can use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
        L = torch.where(tri[None, :, :, None], seg.exp(), 0.0)
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


def _smem_bytes(Q: int, P: int, N: int) -> int:
    """Dynamic shared memory of one block of the kernel (csrc/ssd_scan.cu)."""
    up = lambda n: -(-n // 64) * 64  # noqa: E731
    NP, PP, QP = up(N), up(P), up(Q)
    return 4 * (NP * (PP + 4) + 2 * QP + 2 * NP * 68 + 64 * PP + 64 * 68)


def ssd_scan(x, dt, A, B, C, chunk: int = 128):
    """x: (Bb, S, H, P) float32 or bfloat16; dt: (Bb, S, H); A: (H,);
    B/C: (Bb, S, G, N), float32. Returns (y, final_state): y (Bb, S, H, P)
    in x.dtype, state (Bb, H, P, N) float32. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if dt.shape != (Bb, S, H) or A.shape != (H,) \
            or B.shape != (Bb, S, G, N) or C.shape != B.shape or H % G:
        raise ValueError("ssd_scan: inconsistent shapes")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan has no kernel for {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: no kernel for x of {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}")
    Q = min(chunk, S)
    if not 1 <= P <= 128 or Q < 1 or _smem_bytes(Q, P, N) > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan: P={P}, N={N}, chunk {Q} exceed the "
                         "kernel's shared memory")
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    fn = kernel_library("ssd_scan").ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    rc = fn(*(t.data_ptr() for t in (x, dt, A, B, C, y, state)),
            _DTYPES[x.dtype], Bb, S, H, P, G, N, Q,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_launch: CUDA error {rc} at launch")
    LAUNCHES["ssd_scan"] += 1
    return y, state
