"""The kernels as the models call them (the reference's ``kernels/ops.py``).

``flash_attention`` takes the models' (B, S, H, dh) layout; ``ssd`` the
chunked SSD scan. CPU and meta tensors take the plain versions; CUDA
tensors launch the kernels or raise. Where autograd records (grad enabled
and an input that requires grad) both go through their autograd Functions
(``flash_attention.FlashAttention``, ``ssd_scan.SSDScan``), whose forwards
are the same kernels (the flash kernel then also writing its log-sum-exp);
serving under ``inference_mode`` launches as before. Each call, forward or
backward, is one ``obs.compiled.kernel_call``: an op analysis counts it by
its work function, and on meta tensors under one it returns empty outputs
of its shapes.
"""

from __future__ import annotations

import torch

from repro_torch.device import PLAIN_DEVICES
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.obs.compiled import kernel_call

__all__ = ["flash_attention", "ssd"]


def _records(*ts) -> bool:
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix: int = 0):
    """q: (B, Sq, H, dh); k/v: (B, Sk, K, dh) -> (B, Sq, H, dh) in q.dtype."""
    if _records(q, k, v):
        return fa.FlashAttention.apply(q, k, v, causal, window, prefix)
    with kernel_call("flash_attention", lambda: fa.call_work(
            q, k, v, causal, window, prefix), q, k, v) as call:
        if q.device.type in PLAIN_DEVICES and not call.shapes_only:
            return fa.attention_plain_bshd(q, k, v, causal=causal,
                                           window=window, prefix=prefix)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        if not call.shapes_only:
            fa.flash_attention_strided(q, k, v, out, causal=causal,
                                       window=window, prefix=prefix)
        return out


def ssd(x, dt, A, B, C, *, chunk: int = 128, init_state=None):
    """Chunked SSD scan. Shapes as in ``kernels/ssd_scan.py``. The kernel
    starts from a zero state: a CUDA call with ``init_state`` raises."""
    if init_state is None and _records(x, dt, A, B, C):
        return ss.SSDScan.apply(x, dt, A, B, C, chunk)
    with kernel_call("ssd_scan", lambda: ss.call_work(x, dt, A, B, C, chunk),
                     x, dt, A, B, C) as call:
        if call.shapes_only:
            return ss.empty_outputs(x, B)
        if x.device.type in PLAIN_DEVICES:
            return ss.ssd_scan_plain(x, dt, A, B, C, chunk, init_state)
        if init_state is not None:
            raise NotImplementedError(
                "the ssd_scan kernel starts from a zero state; init_state "
                "is only taken on the CPU")
        return ss.ssd_scan(x, dt, A, B, C, chunk)
