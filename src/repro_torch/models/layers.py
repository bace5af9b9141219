"""Building blocks of the port's model zoo: the part of the reference's
``models/layers.py`` that the decoders (dense, MoE and vision), the Mamba-2
stack, the Hymba hybrid and the encoder-decoder use.

Conventions, as the reference: weights are float32 masters cast to the
activation dtype at each use; norms and rotary angles are computed in
float32 and cast back. The parameter holders are ``nn.Module``s; these
functions read their weights as attributes (``p.wq``).

Prefill self-attention goes through ``kernels/ops.flash_attention`` at
every sequence length: the flash kernel on the card, its plain version
(float32 scores) on the CPU. The reference computes short sequences with a
dense softmax whose scores are in the activation dtype and long ones
blockwise; the kernel replaces both paths. Decode attention, ``ssd_step``,
the convolutions and the MoE's routing and expert products stay plain
torch, as the reference leaves them to XLA.

In the meshed train, prefill and decode steps a module may carry a
``Split`` (``distributed/tensor_parallel.py``): attention then computes
the rank's q heads (and the kv heads they read, which are all its cache
holds), the SwiGLU its ``d_ff`` columns, the MoE its experts and the SSD
mixer its heads, each entering through ``copy_to_model`` and leaving
through one ``reduce_from_model``. Without one (one card, a product whose
axis does not divide) each computes whole, as before.

Decode updates the KV cache in place (the reference returns a new one), and
writes the new key and value in the cache's dtype: the decoder's and the
encoder-decoder's caches are bfloat16 even for a float32 model, where the
reference refuses the write.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

__all__ = [
    "dense_init_", "rms_norm", "rotary", "apply_rope",
    "attention", "attention_decode", "kv_heads", "swiglu", "moe_ffn",
    "ssd", "ssd_step", "causal_conv1d", "conv1d_step",
]

NEG_INF = -1e30


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                in_axis=0) -> torch.Tensor:
    """Fill ``w`` in place with the reference's truncated-normal fan-in
    init: std 1/sqrt(fan_in), cut at two standard deviations."""
    axes = (in_axis,) if isinstance(in_axis, int) else in_axis
    fan_in = math.prod(w.shape[a] for a in axes)
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


# --------------------------------------------------------------------------
# norms / rotary
# --------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6, split=None):
    """RMS norm over the last dim; with a ``split`` that dim is the rank's
    slice of one ``split.size`` times as wide, whose sum of squares is
    all-reduced over ``"model"``."""
    dt = x.dtype
    x = x.float()
    if split is None:
        var = x.square().mean(dim=-1, keepdim=True)
    else:
        var = tp.sum_over_model(x.square().sum(dim=-1, keepdim=True),
                                split.mesh) / (x.shape[-1] * split.size)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def rotary(positions, dh: int, theta: float):
    """(..., S) int positions -> cos/sin of shape (..., S, dh//2)."""
    idx = torch.arange(0, dh, 2, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / dh))
    ang = positions.float()[..., None] * freqs
    return ang.cos(), ang.sin()


def apply_rope(x, cos, sin):
    """x: (B, S, H, dh); cos/sin: (B, S, dh//2) or (S, dh//2)."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _qkv(x, p, src=None):
    """q from ``x``, k and v from ``src`` (default ``x``), plus their biases
    where the layer has them."""
    src = x if src is None else src
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", src, p.wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", src, p.wv.to(x.dtype))
    if p.bq is not None:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    return q, k, v


def attention(x, p, cfg: ModelConfig, causal: bool = True,
              window: int | None = None, kv_source=None,
              return_kv: bool = False, prefix_len: int = 0):
    """Multi-head attention prefill with GQA + rotary over positions
    0..S-1, the sequence indices the flash kernel masks by. x: (B, S, D).

    ``window`` (default ``cfg.window``) keeps keys less than ``window``
    behind the query, and ``prefix_len`` keys stay visible outside it
    (Hymba's meta tokens). ``kv_source``: cross-attention memory (B, Sk, D):
    no rotary, not causal, no window. ``return_kv`` also returns the (k, v)
    tensors for the cache (the kv heads the rank's q heads read, under a
    split)."""
    win = cfg.window if window is None else window
    split = tp.split_of(p)
    if split is not None:
        x = tp.copy_to_model(x, split.mesh)
        if kv_source is not None:
            kv_source = tp.copy_to_model(kv_source, split.mesh)
    q, k, v = _qkv(x, p, kv_source)
    if kv_source is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        cos, sin = rotary(positions, cfg.dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    else:
        causal, win = False, 0
    kv = (k, v)
    if split is not None and split.kv_index is not None:
        at = torch.tensor(split.kv_index, device=k.device)
        k, v = k.index_select(2, at), v.index_select(2, at)
    out = ops.flash_attention(q, k, v, causal=causal, window=win,
                              prefix=prefix_len)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo.to(x.dtype))
    if split is not None:
        y = tp.reduce_from_model(y, split.mesh)
    if return_kv:
        return y, kv
    return y


def kv_heads(p, cfg: ModelConfig) -> int:
    """The kv heads an attention layer's cache holds: all of them, or
    under a split those the rank's q heads read."""
    split = tp.split_of(p)
    if split is None:
        return cfg.n_kv_heads
    g = cfg.n_heads // cfg.n_kv_heads
    return (split.hi - 1) // g - split.lo // g + 1


def attention_decode(x, p, cache_k, cache_v, pos: int, cfg: ModelConfig,
                     cross: bool = False, slot: int | None = None,
                     valid=None):
    """One-token decode against a cache, updated in place.

    x: (B, 1, D); cache_k/v: (B, S_max, K, dh); pos: the current index.
    The new key and value go into ``slot`` (default ``pos``) and the query
    sees the ``valid`` slots (default 0..pos): the hybrid passes its
    ``[meta | ring]`` slot and mask. ``cross=True``: the cache holds the
    encoder's keys and values, is not written, and every key is valid.
    Under a split the rank computes its q heads against the kv heads its
    cache holds (``kv_heads``; through ``kv_index`` where the GQA ratio is
    not uniform on the rank) and its output is all-reduced over
    ``"model"``. Returns y (B, 1, D)."""
    B = x.shape[0]
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    split = tp.split_of(p)
    if split is not None:
        x = tp.copy_to_model(x, split.mesh)
        H, K = split.hi - split.lo, kv_heads(p, cfg)
    S_max = cache_k.shape[1]
    if cross:
        q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
        if p.bq is not None:
            q = q + p.bq.to(x.dtype)
        valid = torch.ones(S_max, dtype=torch.bool, device=x.device)
    else:
        q, k_new, v_new = _qkv(x, p)
        cos, sin = rotary(torch.full((B, 1), pos, device=x.device), dh,
                          cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
        slot = pos if slot is None else slot
        cache_k[:, slot] = k_new[:, 0]
        cache_v[:, slot] = v_new[:, 0]
        if valid is None:
            valid = torch.arange(S_max, device=x.device) <= pos

    if split is not None and split.kv_index is not None:
        at = torch.tensor(split.kv_index, device=x.device)
        cache_k, cache_v = cache_k.index_select(2, at), \
            cache_v.index_select(2, at)
        K = H
    g = H // K
    ct = torch.promote_types(x.dtype, cache_k.dtype)
    qg = q.reshape(B, 1, K, g, dh).to(ct)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, cache_k.to(ct)) \
        / math.sqrt(dh)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    ct = torch.promote_types(probs.dtype, cache_v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(ct), cache_v.to(ct))
    y = torch.einsum("bshk,hkd->bsd", out.reshape(B, 1, H, dh),
                     p.wo.to(out.dtype))
    if split is not None:
        y = tp.reduce_from_model(y, split.mesh)
    return y


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def swiglu(x, p):
    """SwiGLU; under a split, the rank's ``d_ff`` columns and one
    all-reduce of the output."""
    split = tp.split_of(p)
    if split is None:
        return _swiglu(x, p)
    return tp.reduce_from_model(
        _swiglu(tp.copy_to_model(x, split.mesh), p), split.mesh)


def _swiglu(x, p):
    h = torch.einsum("bsd,df->bsf", x, p.w_gate.to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p.w_up.to(x.dtype))
    return torch.einsum("bsf,fd->bsd", F.silu(h) * u, p.w_down.to(x.dtype))


def _expert_swiglu(buf, p):
    """buf: (G, E, C, D) routed-token buffers; each expert's SwiGLU over its
    C rows, as batched products."""
    h = torch.einsum("gecd,edf->gecf", buf, p.w_gate.to(buf.dtype))
    u = torch.einsum("gecd,edf->gecf", buf, p.w_up.to(buf.dtype))
    return torch.einsum("gecf,efd->gecd", F.silu(h) * u,
                        p.w_down.to(buf.dtype))


def moe_ffn(x, p, cfg: ModelConfig):
    """Fine-grained routed MoE with capacity dropping, as the reference's
    ``moe_ffn`` computes it without shardings; returns (y, aux).

    The tokens are split into ``G = max(1, min(moe_groups, B*S))`` groups,
    each dispatched on its own. Router logits and softmax in float32; each
    token's top ``k`` experts (ties to the lower index, as ``lax.top_k``)
    with their renormalised gates. An entry's slot is its rank among the
    group's entries of the same expert in token-major order, which is its
    place in the reference's stable sort by expert; entries at slot
    ``cap = ceil(Tg k / E capacity_factor)`` or later are dropped. Kept
    entries are copied into a (G, E, cap, D) buffer (each slot is written
    once), the experts run on it, and each token sums its k gated outputs
    in ascending expert order, the order of the reference's scatter-add,
    with no atomics: the same bits on every run. Shared experts are a dense
    SwiGLU beside them; ``aux`` is the Switch-style load-balance value.

    With the experts split over ``"model"`` the routing, slots and drops
    are computed whole on every rank; each rank fills and runs only its
    experts' (G, E/m, cap, D) buffers, with its tokens and gates entering
    through ``copy_to_model``, and the combine (with the shared experts'
    columns, when they split too) is summed by one all-reduce."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = max(1, min(cfg.moe_groups, T))
    Tg = T // G
    xt = x.reshape(G, Tg, D)

    logits = torch.einsum("gtd,de->gte", xt.float(), p.router.float())
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :k], eidx[..., :k]                 # (G, Tg, k)
    gate = (gate / gate.sum(-1, keepdim=True)).to(x.dtype)

    cap = math.ceil(Tg * k / E * cfg.capacity_factor)
    flat_e = eidx.reshape(G, 1, Tg * k)
    # (G, E, Tg*k), entries innermost: the running count is a scan along
    # the contiguous dim (along an outer dim the card scans each expert's
    # column in one thread).
    chose = (flat_e == torch.arange(E, device=x.device)[None, :, None]).int()
    slot = (chose.cumsum(-1).gather(1, flat_e) - 1).reshape(G, Tg, k)
    keep = slot < cap
    groups = torch.arange(G, device=x.device)[:, None, None]
    split = tp.split_of(p.experts)
    shared = tp.split_of(p.shared) if cfg.n_shared_experts > 0 else None
    if split is None:
        El = E
        base = (groups * E + eidx) * cap
    else:               # this rank's experts; the others' entries drop here
        El = split.hi - split.lo
        xt = tp.copy_to_model(xt, split.mesh)
        gate = tp.copy_to_model(gate, split.mesh)
        keep = keep & (eidx >= split.lo) & (eidx < split.hi)
        base = (groups * El + (eidx - split.lo).clamp(0, El - 1)) * cap
    # Dropped entries go to a spare last row that the experts never read.
    buf = x.new_zeros(G * El * cap + 1, D)
    buf[torch.where(keep, base + slot, G * El * cap)] = xt[:, :, None, :]
    out = _expert_swiglu(buf[:-1].view(G, El, cap, D), p.experts) \
        .reshape(G * El * cap, D)

    asc = eidx.argsort(dim=-1)                  # each token's experts, ascending
    rows = (base + slot.clamp(max=cap - 1)).gather(-1, asc)
    w = (gate * keep).gather(-1, asc)[..., None]
    yt = out[rows[..., 0]] * w[..., 0, :]
    for j in range(1, k):
        yt = yt + out[rows[..., j]] * w[..., j, :]
    y = yt.reshape(B, S, D)
    if split is not None and shared is not None:   # one region, one reduce
        y = y + _swiglu(xt.reshape(B, S, D), p.shared)
    if split is not None:
        y = tp.reduce_from_model(y, split.mesh)
    if cfg.n_shared_experts > 0 and (split is None or shared is None):
        y = y + swiglu(x, p.shared)
    me = chose.sum(dim=(0, 2)).float() / T                    # tokens/expert
    pe = probs.mean(dim=(0, 1))
    aux = E * (me / k * pe).sum()
    return y, aux


# --------------------------------------------------------------------------
# Mamba-2 SSD
# --------------------------------------------------------------------------

def ssd(x, dt, A, B_, C_, chunk: int, init_state=None):
    """Chunked state-space-duality scan: the ssd_scan kernel on the card,
    its plain version on the CPU.

    x: (B, S, H, P); dt: (B, S, H); A: (H,); B_/C_: (B, S, G, N).
    Returns (y, final_state) with y (B, S, H, P), state (B, H, P, N)."""
    return ops.ssd(x, dt, A, B_, C_, chunk=chunk, init_state=init_state)


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """Single-token SSD recurrence for decode.

    state: (B, H, P, N); x_t: (B, H, P); dt_t: (B, H); B_t/C_t: (B, G, N).
    """
    rep = x_t.shape[1] // B_t.shape[1]
    B_h = B_t.repeat_interleave(rep, dim=1)            # (B, H, N)
    C_h = C_t.repeat_interleave(rep, dim=1)
    decay = torch.exp(A[None, :] * dt_t)               # (B, H)
    upd = torch.einsum("bhp,bhn->bhpn", x_t * dt_t[..., None], B_h)
    new_state = state * decay[:, :, None, None].to(state.dtype) + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, C_h)
    return y, new_state


def causal_conv1d(x, w, b):
    """x: (B, S, C), w: (K, C) depthwise, left-padded causal."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :]


def conv1d_step(conv_state, x_t, w, b):
    """conv_state: (B, K-1, C) last inputs; x_t: (B, C)."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, K, C)
    y = torch.einsum("bkc,kc->bc", full, w) + b[None, :]
    return y, full[:, 1:, :]
