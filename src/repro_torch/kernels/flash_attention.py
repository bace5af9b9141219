"""Flash attention forward: the kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_fwd``: online-softmax attention of (B*H, Sq, dh) queries
against (B*K, Sk, dh) keys and values, query row r reading kv row
r // (B*H / B*K) (GQA), with causal, sliding-window and meta-prefix masks
and ragged Sq/Sk. The kernels (``csrc/flash_attention.cu``) read their
operands through strides, so the (B, S, H, dh) layout of the models
(``kernels/ops.py::flash_attention``) needs no transpose copy; they keep
the TPU kernel's mask semantics (a finite -1e30 fill, the running max from
-inf, l clamped at 1e-30) and its whole-tile skips.

Two kernels, one rule (``tensor_core_route``): a bfloat16 call with dh 64,
96 or 128 whose base pointers are 16-byte aligned and whose batch, sequence
and head strides are multiples of 16 bytes (TMA's conditions) takes the
tensor-core kernel (``flash_attention_tc_launch``: wgmma products over a
TMA-fed K/V ring; dh 96 runs dh 128's tile, its last 32 columns
zero-filled by TMA); every other CUDA call takes the CUDA-core kernel
(``flash_attention_launch``: float32 math, any dh up to 128, float32 or
bfloat16). The rule reads only dtype, shape, pointers and strides; a launch
that fails raises and never reruns on the other kernel. ``LAUNCHES``
counts every launch under ``flash_attention`` and the tensor-core ones
under ``flash_attention_tc`` as well.

The plain version is a naive masked softmax in float32, the counterpart of
the reference's ``kernels/ref.py::attention_ref``.

Training (``FlashAttention``, the autograd Function that
``ops.flash_attention`` takes whenever grad is enabled): the forward is the
kernel on the card, which then also writes each query row's log-sum-exp
(float32, (B, H, Sq)); on the CPU the plain version and its logsumexp. The
backward, ``flash_backward``, is the reference's ``_flash_train_bwd``
(``repro/models/layers.py``) in torch ops: per query block of ``bq`` rows
and per key block of ``bk`` keys it can reach (``_reachable_kv``), it
recomputes the scores, takes ``p = exp(s - lse)`` and accumulates dv, dp,
ds, dq and dk in float32. The reference has no backward kernel; a CUDA one
is later work (ROADMAP "After the port"). Keys are masked by the real Sk:
the reference's ``_score_block`` masks by the padded Sk, which lets zero
keys into a non-causal softmax (ROADMAP queue C).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.device import PLAIN_DEVICES, kernel_library
from repro_torch.kernels import LAUNCHES
from repro_torch.obs.compiled import kernel_call, record_launch

__all__ = ["flash_attention_fwd", "flash_attention_strided",
           "launch_cuda_core", "tensor_core_route",
           "tma_layout", "bshd_view", "attention_plain", "attn_pairs",
           "flash_work", "NEG_INF", "FlashAttention", "flash_forward_lse",
           "flash_backward", "flash_backward_work", "BLOCK_Q", "BLOCK_K",
           "call_work", "backward_call_work"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_HEAD_DIMS = (64, 96, 128)
TMA_BOX_COLS = 64   # bf16 columns per TMA box: 128 bytes, the swizzle's span
TMA_BOX_ROWS = 64   # query rows of a block, keys of a tile
BLOCK_Q = 512       # the backward's query rows per block (the reference's)
BLOCK_K = 1024      # the backward's keys per block


def _bad(q_pos, k_pos, causal: bool, window: int, prefix: int):
    """The masked (query, key) pairs of position grids, as the kernels and
    the reference mask them (the key padding aside)."""
    diff = q_pos[:, None] - k_pos[None, :]
    bad = torch.zeros(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        bad |= diff < 0
    if window > 0:
        oow = diff >= window
        if prefix > 0:
            oow &= k_pos[None, :] >= prefix
        bad |= oow
    return bad


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix: int = 0, return_lse: bool = False):
    """q: (BH, Sq, dh), k/v: (BK, Sk, dh); naive masked softmax attention in
    float32, returned in ``q.dtype``; with ``return_lse`` also each row's
    float32 log-sum-exp (BH, Sq)."""
    BH, Sq, dh = q.shape
    BK, Sk, _ = k.shape
    g = BH // BK
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), kf) / math.sqrt(dh)
    bad = _bad(torch.arange(Sq, device=q.device),
               torch.arange(Sk, device=q.device), causal, window, prefix)
    s = torch.where(bad[None], NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("hqk,hkd->hqd", p, vf).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def attention_plain_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         prefix: int = 0, return_lse: bool = False):
    """``attention_plain`` on the model's layout: q (B, Sq, H, dh), k/v
    (B, Sk, K, dh) -> out (B, Sq, H, dh), and with ``return_lse`` also the
    log-sum-exp (B, H, Sq)."""
    B, Sq, H, dh = q.shape
    rows = lambda t: t.transpose(1, 2).reshape(-1, t.shape[1], dh)  # noqa: E731
    res = attention_plain(rows(q), rows(k), rows(v), causal=causal,
                          window=window, prefix=prefix, return_lse=return_lse)
    out, lse = res if return_lse else (res, None)
    out = out.reshape(B, H, Sq, dh).transpose(1, 2)
    return (out, lse.reshape(B, H, Sq)) if return_lse else out


def tensor_core_route(q, k, v, out) -> bool:
    """Whether a CUDA call on q/out (B, Sq, H, dh) and k/v (B, Sk, K, dh)
    takes the tensor-core kernel: bfloat16, dh 64, 96 or 128, every base
    pointer 16-byte aligned and every batch, sequence and head stride a
    multiple of 16 bytes. Every other call takes the CUDA-core kernel."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in TC_HEAD_DIMS:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])
               for t in (q, k, v, out))


def tma_layout(t) -> dict:
    """The tensor map of a (B, S, heads, dh) operand of the tensor-core
    kernel: dims innermost first (dh, heads, S, B), the byte strides of
    heads, S and B, the box (64 columns, 1 head, 64 rows, 1 batch) and the
    first column of each box of a tile (two boxes at dh 96 and 128; at 96
    the second box's last 32 columns lie outside the tensor)."""
    v = _tma_values(tuple(t.shape), t.stride(), t.element_size())
    return {"dims": v[0:4], "strides": v[4:7], "box": v[7:11],
            "box_cols": tuple(range(0, v[0], TMA_BOX_COLS))}


def _tma_values(shape, stride, es) -> tuple:
    """``tma_layout`` as the kernel takes it: dims, byte strides, box and
    the number of boxes per tile (dh / 64 rounded up), 12 integers."""
    B, S, n_heads, dh = shape
    return (dh, n_heads, S, B, stride[2] * es, stride[1] * es,
            stride[0] * es, TMA_BOX_COLS, 1, TMA_BOX_ROWS, 1,
            -(-dh // TMA_BOX_COLS))


@functools.lru_cache(maxsize=64)
def _tc_arrays(q, k, v, out):
    """The tensor maps of q, k and v (3 x 12 integers) and the element
    strides of out, as ctypes arrays, from each operand's (shape, stride);
    bfloat16 operands. Cached: a serve calls with the same layouts again
    and again."""
    maps = (ctypes.c_longlong * 36)(
        *(x for shape, stride in (q, k, v)
          for x in _tma_values(shape, stride, 2)))
    return maps, (ctypes.c_longlong * 3)(*out[1][:3])


_SIGNATURES = {
    "flash_attention_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p]),
    "flash_attention_tc_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=len(_SIGNATURES))  # one per C entry point
def _entry(name: str):
    """A C entry point of the library, its ctypes signature set once."""
    fn = getattr(kernel_library("flash_attention"), name)
    fn.restype, fn.argtypes = ctypes.c_int, _SIGNATURES[name]
    return fn


def _check(q, k, v, out, lse=None) -> None:
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
    if lse is not None and (
            lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("flash_attention: lse must be contiguous float32 "
                         f"(B, H, Sq) = {(B, H, Sq)} on {q.device}")


def attn_pairs(Sq: int, Sk: int, causal: bool, window: int,
               prefix: int) -> int:
    """(query, key) pairs the masks leave visible: the products the
    attention of these inputs needs. Per query row i: keys up to i (all
    without ``causal``), of those the band i - window < key (with a
    window) and the prefix key < prefix."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    if window <= 0:
        return int(np.maximum(hi + 1, 0).sum())
    lo = np.maximum(i - window + 1, 0)
    band = np.maximum(hi - lo + 1, 0)
    pre = np.maximum(np.minimum(np.minimum(prefix, hi + 1), lo), 0)
    return int((band + pre).sum())


def flash_work(q, k, v, out, causal: bool, window: int, prefix: int,
               lse=None) -> dict:
    """Work of one attention launch on (B, S, heads, dh) operands: q, k, v
    read once and out (and the lse, when asked for) written once, and 4 dh
    operations (two products' multiply-adds) per visible (query, key) pair
    and query head, at the bfloat16 rate for bfloat16 operands."""
    B, Sq, H, dh = q.shape
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    if lse is not None:
        n_bytes += lse.numel() * lse.element_size()
    n_ops = 4 * dh * attn_pairs(Sq, k.shape[1], causal, window, prefix) \
        * B * H
    return {"bytes": n_bytes,
            "ops": {"bf16" if q.dtype == torch.bfloat16 else "f32": n_ops}}


def flash_backward_work(q, k, v, causal: bool, window: int,
                        prefix: int) -> dict:
    """Work of one attention backward (``flash_backward``'s function) on
    (B, S, heads, dh) operands: q, k, v, the output, its gradient and the
    log-sum-exp read once, dq, dk, dv written once, and 10 dh operations
    (five products' multiply-adds: the scores again, dP, dV, dQ, dK) per
    visible (query, key) pair and query head, at the bfloat16 rate for
    bfloat16 operands (a backward on the tensor cores; the port's runs in
    float32 torch ops)."""
    B, Sq, H, dh = q.shape
    io = 2 * q.numel() * q.element_size() + B * H * Sq * 4
    n_bytes = io + 2 * sum(t.numel() * t.element_size() for t in (q, k, v))
    n_ops = 10 * dh * attn_pairs(Sq, k.shape[1], causal, window, prefix) \
        * B * H
    return {"bytes": n_bytes,
            "ops": {"bf16" if q.dtype == torch.bfloat16 else "f32": n_ops}}


def call_work(q, k, v, causal: bool, window: int, prefix: int,
              lse: bool = False) -> dict:
    """``{"flops", "bytes"}`` of one attention call, for the op analysis
    (``obs.compiled.kernel_call``): ``flash_work``'s operations and bytes
    (the output shaped as q, the log-sum-exp when the call writes it)."""
    w = flash_work(q, k, v, q, causal, window, prefix)
    B, Sq, H, _ = q.shape
    return {"flops": sum(w["ops"].values()),
            "bytes": w["bytes"] + (B * H * Sq * 4 if lse else 0)}


def backward_call_work(q, k, v, causal: bool, window: int,
                       prefix: int) -> dict:
    """``{"flops", "bytes"}`` of one attention backward:
    ``flash_backward_work``'s."""
    w = flash_backward_work(q, k, v, causal, window, prefix)
    return {"flops": sum(w["ops"].values()), "bytes": w["bytes"]}


def _launch_cuda_core(q, k, v, out, causal, window, prefix,
                      lse=None) -> None:
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device)
    with record_launch("flash_attention", stream, lambda: flash_work(
            q, k, v, out, causal, window, prefix, lse)):
        rc = _entry("flash_attention_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], B, H, K, Sq, Sk, dh, strides, int(causal),
            window, prefix, 1.0 / math.sqrt(dh), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_launch: CUDA error {rc} at launch")
    LAUNCHES["flash_attention"] += 1


def _launch_tensor_core(q, k, v, out, causal, window, prefix,
                        lse=None) -> None:
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    layouts, o_strides = _tc_arrays(
        *((tuple(t.shape), t.stride()) for t in (q, k, v, out)))
    stream = torch.cuda.current_stream(q.device)
    with record_launch(("flash_attention", "flash_attention_tc"), stream,
                       lambda: flash_work(q, k, v, out, causal, window,
                                          prefix, lse)):
        rc = _entry("flash_attention_tc_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H,
            K, Sq, Sk, dh, layouts, o_strides, int(causal), window, prefix,
            1.0 / math.sqrt(dh), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_tc_launch: error {rc} at launch (-1: no "
            "cuTensorMapEncodeTiled in the driver, -2: a tensor map refused, "
            "else a CUDA error)")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES["flash_attention_tc"] += 1


def launch_cuda_core(q, k, v, out, *, causal: bool = True, window: int = 0,
                     prefix: int = 0) -> None:
    """The CUDA-core kernel (float32 math) on CUDA tensors q/out
    (B, Sq, H, dh) and k/v (B, Sk, K, dh) of any strides with a contiguous
    head dim; writes ``out``. Query head h reads kv head h // (H / K)."""
    _check(q, k, v, out)
    _launch_cuda_core(q, k, v, out, causal, window, prefix)


def flash_attention_strided(q, k, v, out, *, causal: bool = True,
                            window: int = 0, prefix: int = 0,
                            lse=None) -> None:
    """Launch a kernel on CUDA tensors q/out (B, Sq, H, dh) and k/v
    (B, Sk, K, dh) of any strides with a contiguous head dim; writes
    ``out``, and each row's log-sum-exp into ``lse`` (contiguous float32
    (B, H, Sq)) when given. ``tensor_core_route`` picks the kernel."""
    _check(q, k, v, out, lse)
    launch = _launch_tensor_core if tensor_core_route(q, k, v, out) \
        else _launch_cuda_core
    launch(q, k, v, out, causal, window, prefix, lse)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        prefix: int = 0):
    """q: (BH, Sq, dh) — batch*q_heads flattened; k/v: (BK, Sk, dh) with
    BH % BK == 0 (GQA group = BH // BK). Returns (BH, Sq, dh) in q.dtype.
    CPU and meta tensors take the plain version; CUDA tensors launch the
    kernel."""
    BH, Sq, dh = q.shape
    BK, Sk, _ = k.shape
    if BH % BK or k.shape != (BK, Sk, dh) or v.shape != k.shape:
        raise ValueError("flash_attention_fwd: inconsistent shapes")
    if q.device.type in PLAIN_DEVICES:
        return attention_plain(q, k, v, causal=causal, window=window,
                               prefix=prefix)
    out = torch.empty((BH, Sq, dh), dtype=q.dtype, device=q.device)
    flash_attention_strided(bshd_view(q), bshd_view(k), bshd_view(v),
                            bshd_view(out), causal=causal, window=window,
                            prefix=prefix)
    return out


def bshd_view(t):
    """The (B*H, S, dh) layout of the TPU kernel as the (B, S, H, dh) layout
    of the kernels, with B = 1 (a view, no copy)."""
    return t.unsqueeze(0).transpose(1, 2)


# --------------------------------------------------------------------------
# training: the forward with its log-sum-exp, the blockwise backward
# --------------------------------------------------------------------------

def flash_forward_lse(q, k, v, *, causal: bool = True, window: int = 0,
                      prefix: int = 0):
    """q: (B, Sq, H, dh), k/v: (B, Sk, K, dh) -> (out (B, Sq, H, dh) in
    q.dtype, lse (B, H, Sq) float32). CPU and meta tensors take the plain
    version and its logsumexp; CUDA tensors launch the kernel, which writes
    both."""
    B, Sq, H, dh = q.shape
    if q.device.type in PLAIN_DEVICES:
        return attention_plain_bshd(q, k, v, causal=causal, window=window,
                                    prefix=prefix, return_lse=True)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    flash_attention_strided(q, k, v, out, causal=causal, window=window,
                            prefix=prefix, lse=lse)
    return out, lse


def _reachable_kv(qi: int, bq: int, bk: int, Sk: int, causal: bool,
                  window: int, prefix: int) -> list[int]:
    """The key blocks query block ``qi`` can attend to (the reference's
    ``_reachable_kv``)."""
    q_lo, q_hi = qi * bq, qi * bq + bq - 1
    ids = []
    for ki in range(-(-Sk // bk)):
        k_lo, k_hi = ki * bk, ki * bk + bk - 1
        if causal and k_lo > q_hi:
            continue
        if window > 0 and k_hi < q_lo - window + 1 - bq \
                and not (prefix > 0 and k_lo < prefix):
            continue
        ids.append(ki)
    return ids


def flash_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                   window: int = 0, prefix: int = 0, bq: int = BLOCK_Q,
                   bk: int = BLOCK_K):
    """The gradients (dq, dk, dv) of attention, in the inputs' dtypes, from
    the forward's inputs, output and log-sum-exp: the reference's
    ``_flash_train_bwd`` in torch ops, float32 throughout. q/out/dout
    (B, Sq, H, dh), k/v (B, Sk, K, dh), lse (B, H, Sq). Blocks of ``bq``
    queries and ``bk`` keys (the last of each may be short); GQA's group
    is summed into dk and dv."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    g = H // K
    scale = 1.0 / math.sqrt(dh)
    grouped = lambda t: t.reshape(B, Sq, K, g, dh).float()  # noqa: E731
    qg, dog = grouped(q), grouped(dout)
    delta = torch.einsum("bqkgh,bqkgh->bkgq", dog, grouped(out))
    lse = lse.reshape(B, K, g, Sq)
    dq = torch.zeros((B, Sq, K, g, dh), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sk, K, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    pos = torch.arange(max(Sq, Sk), device=q.device)
    for qi in range(-(-Sq // bq)):
        qs = slice(qi * bq, min(Sq, qi * bq + bq))
        q_blk = qg[:, qs]
        do_t = dog[:, qs].permute(0, 2, 3, 1, 4)          # (B, K, g, bq, dh)
        lse_blk = lse[..., qs, None]
        dl_blk = delta[..., qs, None]
        dq_blk = torch.zeros_like(q_blk)
        for ki in _reachable_kv(qi, bq, bk, Sk, causal, window, prefix):
            ks = slice(ki * bk, min(Sk, ki * bk + bk))
            k_blk, v_blk = k[:, ks].float(), v[:, ks].float()
            s = torch.einsum("bqkgh,btkh->bkgqt", q_blk, k_blk) * scale
            s = torch.where(_bad(pos[qs], pos[ks], causal, window, prefix),
                            NEG_INF, s)
            p = torch.exp(s - lse_blk)                    # (B, K, g, bq, bk)
            dv[:, ks] += torch.einsum("bkgqt,bkgqh->btkh", p, do_t)
            dp = torch.einsum("bkgqh,btkh->bkgqt", do_t, v_blk)
            ds = p * (dp - dl_blk) * scale
            dq_blk += torch.einsum("bkgqt,btkh->bqkgh", ds, k_blk)
            dk[:, ks] += torch.einsum("bkgqt,bqkgh->btkh", ds, q_blk)
        dq[:, qs] += dq_blk
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Attention with the flash kernel's forward and ``flash_backward``:
    ``FlashAttention.apply(q, k, v, causal, window, prefix, bq, bk)`` on
    q (B, Sq, H, dh) and k/v (B, Sk, K, dh). It keeps q, k, v, the output
    and the log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix, bq=BLOCK_Q,
                bk=BLOCK_K):
        with kernel_call("flash_attention", lambda: call_work(
                q, k, v, causal, window, prefix, lse=True), q, k, v) as call:
            if call.shapes_only:
                B, Sq, H, _ = q.shape
                out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
                lse = torch.empty((B, H, Sq), dtype=torch.float32,
                                  device=q.device)
            else:
                out, lse = flash_forward_lse(q, k, v, causal=causal,
                                             window=window, prefix=prefix)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, prefix, bq, bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, prefix, bq, bk = ctx.args
        with kernel_call("flash_attention_backward",
                         lambda: backward_call_work(q, k, v, causal, window,
                                                    prefix), q, k, v) as call:
            if call.shapes_only:
                dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            else:
                dq, dk, dv = flash_backward(q, k, v, out, lse, dout,
                                            causal=causal, window=window,
                                            prefix=prefix, bq=bq, bk=bk)
        return dq, dk, dv, None, None, None, None, None
