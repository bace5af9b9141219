"""Mamba-2 (SSD) attention-free stack — mamba2-2.7b (the reference's
``models/ssm.py``).

Per layer: in_proj -> (z | xBC | dt); causal depthwise conv over xBC; the
SSD chunked scan (the ssd_scan kernel on the card); gated output norm;
out_proj. Decode carries (ssd_state, conv_state), O(1) per token. The conv
state is the tail of the pre-conv xBC, stored in ``cfg.dtype``; the SSD
state is float32. Parameter names follow the reference's tree
(``layers.<l>.in_proj`` is its ``layers/in_proj[l]``). The mixer,
``_mix``, is a function of the config and the layer's parameters, as the
reference's: the hybrid (``models/hybrid.py``) calls it with its own dims.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as ll
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import _param
from repro_torch.models.lm import LM, layer_axes, remat

__all__ = ["Mamba", "Mixer", "MIXER_AXES", "STATE_CACHE_AXES"]

G = 1  # SSD groups (mamba2 default ngroups=1)

# The reference's per-layer logical axes of the mixer, without "layers".
MIXER_AXES = {
    "in_proj": ("fsdp", "d_ff"),     # wide dim TP-sharded
    "conv_w": (None, "d_ff"),
    "conv_b": ("d_ff",),
    "A_log": (None,),
    "D_skip": (None,),
    "dt_bias": (None,),
    "out_norm": ("d_ff",),
    "out_proj": ("d_ff", "fsdp"),
}
# The (L, B, H, P, N) SSD and (L, B, K - 1, C) conv states.
STATE_CACHE_AXES = {
    "ssd": ("layers", "cache_batch", None, "ssm_p", None),
    "conv": ("layers", "cache_batch", None, "conv_ch"),
}


def _dims(cfg: ModelConfig, lp=None):
    """(d_inner, heads, d_state, head dim, conv channels) of the mixer, or
    of the rank's part of the mixer ``lp`` under a split: its heads, its x
    channels with the whole B and C."""
    di = cfg.d_inner_ssm
    H = cfg.n_ssm_heads
    N = cfg.d_state
    P = cfg.ssm_head_dim
    split = None if lp is None else tp.split_of(lp)
    if split is not None:
        di, H = di // split.size, H // split.size
    conv_ch = di + 2 * G * N
    return di, H, N, P, conv_ch


class Mixer(nn.Module):
    """The SSD mixer's parameters: the reference's per-layer tree of
    mamba2 (under ``layers``) and of the hybrid (under ``layers/ssm``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D = cfg.d_model
        di, H, N, P, conv_ch = _dims(cfg)
        self.in_proj = _param(D, 2 * di + 2 * G * N + H, device=device)
        self.conv_w = _param(cfg.ssm_conv, conv_ch, device=device)
        self.conv_b = _param(conv_ch, device=device, fill=0.0)
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, H, dtype=torch.float32, device=device)))
        self.D_skip = _param(H, device=device, fill=1.0)
        self.dt_bias = _param(H, device=device, fill=0.0)
        self.out_norm = _param(di, device=device, fill=1.0)
        self.out_proj = _param(di, D, device=device)

    def init_weights(self, gen):
        ll.dense_init_(self.in_proj.data, gen)
        self.conv_w.data.normal_(0.0, 0.1, generator=gen)
        ll.dense_init_(self.out_proj.data, gen)


class Block(Mixer):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.ln = _param(cfg.d_model, device=device, fill=1.0)


def _mix(x, lp, cfg: ModelConfig, conv_state=None, ssd_state=None,
         step=False):
    """The SSD mixer of ``cfg``'s dims with the parameters ``lp``. Prefill
    (step=False) takes (B, S, D); decode takes (B, 1, D) plus the carried
    states. Returns (out, conv, ssd).

    Under a split (the meshed train step) ``lp`` holds the rank's heads:
    its z, x and dt columns of ``in_proj`` with the whole B and C, the
    conv's x channels with B and C, its heads' ``A_log``, ``D_skip`` and
    ``dt_bias``, its rows of ``out_norm`` and ``out_proj``; the gated
    norm's sum of squares and the output are all-reduced over
    ``"model"``."""
    di, H, N, P, _ = _dims(cfg, lp)
    split = tp.split_of(lp)
    if split is not None:
        x = tp.copy_to_model(x, split.mesh)
    zxbcdt = torch.einsum("bsd,de->bse", x, lp.in_proj.to(x.dtype))
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * G * N]
    dt_raw = zxbcdt[..., -H:]
    A = -torch.exp(lp.A_log.float())
    dt = F.softplus(dt_raw.float() + lp.dt_bias.float())

    if not step:
        xbc_conv = F.silu(ll.causal_conv1d(
            xbc, lp.conv_w.to(x.dtype), lp.conv_b.to(x.dtype)))
        Bt, S = x.shape[0], x.shape[1]
        xh = xbc_conv[..., :di].reshape(Bt, S, H, P)
        B_ = xbc_conv[..., di:di + G * N].reshape(Bt, S, G, N)
        C_ = xbc_conv[..., di + G * N:].reshape(Bt, S, G, N)
        y, final = ll.ssd(xh, dt, A, B_.float(), C_.float(), cfg.ssm_chunk)
        y = y.to(x.dtype) + lp.D_skip.to(x.dtype)[None, None, :, None] * xh
        y = y.reshape(Bt, S, di)
        new_conv = xbc[:, -(cfg.ssm_conv - 1):, :]
    else:
        xbc_t, new_conv = ll.conv1d_step(
            conv_state, xbc[:, 0, :].to(conv_state.dtype),
            lp.conv_w.to(conv_state.dtype), lp.conv_b.to(conv_state.dtype))
        xbc_t = F.silu(xbc_t.to(x.dtype))
        xh = xbc_t[..., :di].reshape(-1, H, P)
        B_ = xbc_t[..., di:di + G * N].reshape(-1, G, N)
        C_ = xbc_t[..., di + G * N:].reshape(-1, G, N)
        yt, final = ll.ssd_step(ssd_state, xh.float(), dt[:, 0], A,
                                B_.float(), C_.float())
        y = yt.to(x.dtype) + lp.D_skip.to(x.dtype)[None, :, None] * xh
        y = y.reshape(-1, 1, di)

    y = ll.rms_norm(y * F.silu(z), lp.out_norm, split=split)
    out = torch.einsum("bse,ed->bsd", y, lp.out_proj.to(x.dtype))
    if split is not None:
        out = tp.reduce_from_model(out, split.mesh)
    return out, new_conv, final


class Mamba(LM):
    """The Mamba-2 stack of ``cfg`` with uninitialised projection weights on
    ``device`` (``init_weights`` fills them; ``load_state_dict`` loads
    them)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.kind != "ssm":
            raise ValueError(f"Mamba needs kind 'ssm', got {cfg.kind!r}")
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = _param(V, D, device=device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(D, device=device, fill=1.0)
        self.lm_head = _param(D, V, device=device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        ll.dense_init_(self.embed.data, gen, in_axis=1)
        for blk in self.layers:
            blk.init_weights(gen)
        ll.dense_init_(self.lm_head.data, gen)

    def axes(self) -> dict:
        """Logical axes of every parameter, keyed by state-dict name (the
        reference's ``axes`` with the stack's ``"layers"`` entry dropped)."""
        return {"embed": ("vocab", "fsdp"),
                **layer_axes("layers", self.cfg.n_layers,
                             {"ln": (None,), **MIXER_AXES}),
                "final_norm": (None,),
                "lm_head": ("fsdp", "vocab")}

    def cache_axes(self) -> dict:
        return dict(STATE_CACHE_AXES)

    def _embed(self, tokens):
        return self._lookup(tokens).to(getattr(torch, self.cfg.dtype))

    def _logits(self, x):
        return self._head(ll.rms_norm(x, self.final_norm), self.lm_head)

    def _block(self, x, blk):
        return x + _mix(ll.rms_norm(x, blk.ln), blk, self.cfg)[0]

    def forward(self, batch: dict):
        """Training/prefill forward -> (logits (B, S, V), aux_loss). Each
        block is recomputed in the backward under ``cfg.remat``."""
        x = self._embed(batch["tokens"])
        for blk in self.layers:
            x = remat(self.cfg, self._block, x, blk)
        return self._logits(x), torch.zeros((), device=x.device)

    def init_cache(self, batch: int, max_len: int):
        """The (ssd, conv) states (the rank's heads under a split); their
        size does not grow with max_len."""
        di, H, N, P, conv_ch = _dims(self.cfg, self.layers[0])
        L, dev = self.cfg.n_layers, self.embed.device
        return {
            "ssd": torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                               device=dev),
            "conv": torch.zeros((L, batch, self.cfg.ssm_conv - 1, conv_ch),
                                dtype=getattr(torch, self.cfg.dtype),
                                device=dev),
        }

    @torch.inference_mode()
    def prefill(self, batch: dict, max_len: int | None = None):
        """Run the prompt; returns last-position logits (B, 1, V) and the
        (ssd, conv) states."""
        x = self._embed(batch["tokens"])
        cache = self.init_cache(x.shape[0], x.shape[1])
        for i, blk in enumerate(self.layers):
            y, conv_st, ssd_st = _mix(ll.rms_norm(x, blk.ln), blk, self.cfg)
            cache["conv"][i] = conv_st
            cache["ssd"][i] = ssd_st
            x = x + y
        return self._logits(x[:, -1:, :]), cache

    @torch.inference_mode()
    def decode(self, cache: dict, token, pos: int):
        """One decode step. token: (B, 1) int; the states update in place."""
        x = self._embed(token)
        for i, blk in enumerate(self.layers):
            y, new_conv, new_ssd = _mix(
                ll.rms_norm(x, blk.ln), blk, self.cfg,
                conv_state=cache["conv"][i],
                ssd_state=cache["ssd"][i], step=True)
            cache["conv"][i] = new_conv
            cache["ssd"][i] = new_ssd
            x = x + y
        return self._logits(x), cache
