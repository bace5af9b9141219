"""The kernels as the models call them (the reference's ``kernels/ops.py``).

``flash_attention`` takes the models' (B, S, H, dh) layout; ``ssd`` the
chunked SSD scan. CPU tensors take the plain versions; CUDA tensors launch
the kernels or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss

__all__ = ["flash_attention", "ssd"]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix: int = 0):
    """q: (B, Sq, H, dh); k/v: (B, Sk, K, dh) -> (B, Sq, H, dh) in q.dtype."""
    B, Sq, H, dh = q.shape
    if q.device.type == "cpu":
        rows = lambda t: t.transpose(1, 2).reshape(-1, t.shape[1], dh)  # noqa: E731
        out = fa.attention_plain(rows(q), rows(k), rows(v), causal=causal,
                                 window=window, prefix=prefix)
        return out.reshape(B, H, Sq, dh).transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fa.flash_attention_strided(q, k, v, out, causal=causal, window=window,
                               prefix=prefix)
    return out


def ssd(x, dt, A, B, C, *, chunk: int = 128, init_state=None):
    """Chunked SSD scan. Shapes as in ``kernels/ssd_scan.py``. The kernel
    starts from a zero state: a CUDA call with ``init_state`` raises."""
    if x.device.type == "cpu":
        return ss.ssd_scan_plain(x, dt, A, B, C, chunk, init_state)
    if init_state is not None:
        raise NotImplementedError(
            "the ssd_scan kernel starts from a zero state; init_state is "
            "only taken on the CPU")
    return ss.ssd_scan(x, dt, A, B, C, chunk)
