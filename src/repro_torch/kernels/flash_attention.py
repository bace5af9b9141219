"""Flash attention forward: the kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_fwd``: online-softmax attention of (B*H, Sq, dh) queries
against (B*K, Sk, dh) keys and values, query row r reading kv row
r // (B*H / B*K) (GQA), with causal, sliding-window and meta-prefix masks
and ragged Sq/Sk. The kernel (``csrc/flash_attention.cu``) reads its
operands through element strides, so the (B, S, H, dh) layout of the
models (``kernels/ops.py::flash_attention``) needs no transpose copy; it
keeps the TPU kernel's mask semantics (a finite -1e30 fill, the running max
from -inf, l clamped at 1e-30) and its whole-tile skips.

The plain version is a naive masked softmax in float32, the counterpart of
the reference's ``kernels/ref.py::attention_ref``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.device import kernel_library
from repro_torch.kernels import LAUNCHES

__all__ = ["flash_attention_fwd", "flash_attention_strided",
           "attention_plain", "NEG_INF"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix: int = 0):
    """q: (BH, Sq, dh), k/v: (BK, Sk, dh); naive masked softmax attention in
    float32, returned in ``q.dtype``."""
    BH, Sq, dh = q.shape
    BK, Sk, _ = k.shape
    g = BH // BK
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), kf) / math.sqrt(dh)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    bad = torch.zeros((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        bad |= k_pos > q_pos
    if window > 0:
        oow = (q_pos - k_pos) >= window
        if prefix > 0:
            oow &= k_pos >= prefix
        bad |= oow
    s = torch.where(bad[None], NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vf).to(q.dtype)


def flash_attention_strided(q, k, v, out, *, causal: bool = True,
                            window: int = 0, prefix: int = 0) -> None:
    """Launch the kernel on CUDA tensors q/out (B, Sq, H, dh) and k/v
    (B, Sk, K, dh) of any strides with a contiguous head dim; writes
    ``out``. Query head h reads kv head h // (H / K)."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    if k.shape != (B, Sk, K, dh) or v.shape != k.shape \
            or out.shape != q.shape or H % K:
        raise ValueError("flash_attention: inconsistent shapes")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: no kernel for {q.dtype}")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v, out)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if not 1 <= dh <= 128 or B * H > 65535 or min(Sq, Sk) < 1:
        raise ValueError("flash_attention: need 1 <= dh <= 128, "
                         "B*H <= 65535 and Sq, Sk >= 1")
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = kernel_library("flash_attention").flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, K, Sq, Sk, dh, strides, int(causal),
            window, prefix, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_launch: CUDA error {rc} at launch")
    LAUNCHES["flash_attention"] += 1


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        prefix: int = 0):
    """q: (BH, Sq, dh) — batch*q_heads flattened; k/v: (BK, Sk, dh) with
    BH % BK == 0 (GQA group = BH // BK). Returns (BH, Sq, dh) in q.dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    BH, Sq, dh = q.shape
    BK, Sk, _ = k.shape
    if BH % BK or k.shape != (BK, Sk, dh) or v.shape != k.shape:
        raise ValueError("flash_attention_fwd: inconsistent shapes")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               prefix=prefix)
    out = torch.empty((BH, Sq, dh), dtype=q.dtype, device=q.device)
    as_bshd = lambda t: t.unsqueeze(0).transpose(1, 2)  # noqa: E731
    flash_attention_strided(as_bshd(q), as_bshd(k), as_bshd(v), as_bshd(out),
                            causal=causal, window=window, prefix=prefix)
    return out
