"""Hymba-style hybrid stack — hymba-1.5b (the reference's
``models/hybrid.py``).

Each layer runs a sliding-window GQA attention branch and a Mamba-2 SSD
branch on the same normed input; each branch's output is RMS-normed, the
two are averaged and added to the residual, then the SwiGLU. The
``n_meta_tokens`` learned meta tokens are prepended to the sequence and stay
visible to every window (the flash kernel's prefix mask). Attention is
windowed in ALL layers: the reference's documented deviation from the Hymba
paper (its DESIGN.md §Arch-applicability), copied as it is.

The cache is ``[meta | ring window]`` keys and values per layer (bfloat16)
with one ``slot_pos`` row, the position each slot holds (-1: none), the SSD
state (float32) and the conv state (bfloat16), as the reference's; decode
writes the new key into ring slot ``M + (pos - M) % W`` in place. Prefill
attention goes through the flash kernel and the SSD branch through the
ssd_scan kernel; decode stays plain torch. Parameter names follow the
reference's tree (``layers.<l>.ssm.in_proj`` is its ``layers/ssm/in_proj[l]``,
``meta`` its top-level ``meta``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as ll
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import (
    ATTN_AXES, FFN_AXES, Attention, SwiGLU, _param)
from repro_torch.models.lm import LM, layer_axes, remat
from repro_torch.models.ssm import (
    MIXER_AXES, STATE_CACHE_AXES, Mixer, _dims, _mix)

__all__ = ["Hybrid"]


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D = cfg.d_model
        for name in ("ln1", "ln2", "norm_attn", "norm_ssm"):
            setattr(self, name, _param(D, device=device, fill=1.0))
        self.attn = Attention(cfg, device)
        self.ssm = Mixer(cfg, device)
        self.ffn = SwiGLU(D, cfg.d_ff, device)

    def init_weights(self, gen):
        self.attn.init_weights(gen)
        self.ssm.init_weights(gen)
        self.ffn.init_weights(gen)


class Hybrid(LM):
    """The hybrid stack of ``cfg`` with uninitialised weights on ``device``
    (``init_weights`` fills them; ``load_state_dict`` loads them)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.kind != "hybrid":
            raise ValueError(f"Hybrid needs kind 'hybrid', got {cfg.kind!r}")
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = _param(V, D, device=device)
        self.meta = _param(cfg.n_meta_tokens, D, device=device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(D, device=device, fill=1.0)
        self.lm_head = _param(D, V, device=device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        ll.dense_init_(self.embed.data, gen, in_axis=1)
        self.meta.data.normal_(0.0, 0.02, generator=gen)
        for blk in self.layers:
            blk.init_weights(gen)
        ll.dense_init_(self.lm_head.data, gen)

    def axes(self) -> dict:
        """Logical axes of every parameter, keyed by state-dict name (the
        reference's ``axes`` with the stack's ``"layers"`` entry dropped)."""
        norms = dict.fromkeys(("ln1", "ln2", "norm_attn", "norm_ssm"),
                              (None,))
        return {"embed": ("vocab", "fsdp"),
                "meta": (None, None),
                **layer_axes("layers", self.cfg.n_layers, {
                    **norms, "attn": ATTN_AXES, "ssm": MIXER_AXES,
                    "ffn": FFN_AXES}),
                "final_norm": (None,),
                "lm_head": ("fsdp", "vocab")}

    def cache_axes(self) -> dict:
        """The window cache is small: its sequence is not split."""
        window = ("layers", "cache_batch", None, None, None)
        return {"k": window, "v": window, "slot_pos": (None,),
                **STATE_CACHE_AXES}

    def _embed(self, tokens):
        return self._lookup(tokens).to(getattr(torch, self.cfg.dtype))

    def _with_meta(self, tokens):
        x = self._embed(tokens)
        meta = self.meta.to(x.dtype)[None].expand(x.shape[0], -1, -1)
        return torch.cat([meta, x], dim=1)

    def _logits(self, x):
        return self._head(ll.rms_norm(x, self.final_norm), self.lm_head)

    @staticmethod
    def _fuse(x, a, s, blk):
        """The branches' fusion and the residual, then the SwiGLU."""
        x = x + 0.5 * (ll.rms_norm(a, blk.norm_attn) +
                       ll.rms_norm(s, blk.norm_ssm))
        return x + ll.swiglu(ll.rms_norm(x, blk.ln2), blk.ffn)

    def _block(self, x, blk):
        """One prefill layer over (B, S, D) -> (x, (k, v), conv, ssd)."""
        h = ll.rms_norm(x, blk.ln1)
        a, kv = ll.attention(h, blk.attn, self.cfg, window=self.cfg.window,
                             prefix_len=self.cfg.n_meta_tokens,
                             return_kv=True)
        s, conv, ssd = _mix(h, blk.ssm, self.cfg)
        return self._fuse(x, a, s, blk), kv, conv, ssd

    def forward(self, batch: dict):
        """Training/prefill forward -> (logits (B, S, V) of the tokens after
        the meta prefix, aux_loss). Each block is recomputed in the
        backward under ``cfg.remat``."""
        x = self._with_meta(batch["tokens"])
        for blk in self.layers:
            x = remat(self.cfg, lambda x, blk: self._block(x, blk)[0], x, blk)
        logits = self._logits(x[:, self.cfg.n_meta_tokens:, :])
        return logits, torch.zeros((), device=x.device)

    def init_cache(self, batch: int, max_len: int):
        """Meta block + ring window (attention) + SSD/conv states (the
        rank's kv and SSD heads under a split)."""
        cfg, dev = self.cfg, self.embed.device
        L, K, dh = cfg.n_layers, ll.kv_heads(self.layers[0].attn, cfg), cfg.dh
        di, H, N, P, conv_ch = _dims(cfg, self.layers[0].ssm)
        Sc = cfg.n_meta_tokens + min(cfg.window, max_len)
        kv = (L, batch, Sc, K, dh)
        return {
            "k": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
            "slot_pos": torch.full((Sc,), -1, dtype=torch.int32, device=dev),
            "ssd": torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                               device=dev),
            "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=torch.bfloat16, device=dev),
        }

    @torch.inference_mode()
    def prefill(self, batch: dict, max_len: int | None = None):
        """Run the meta tokens and the prompt; returns last-position logits
        (B, 1, V) and the cache: the meta slots and the prompt's last W
        positions in their ring slots."""
        tokens = batch["tokens"]
        x = self._with_meta(tokens)
        S, M = x.shape[1], self.cfg.n_meta_tokens
        cache = self.init_cache(x.shape[0], max_len or tokens.shape[1])
        W = cache["k"].shape[2] - M
        tail = min(W, S - M)
        tail_pos = torch.arange(S - tail, S, device=x.device)
        ring = M + (tail_pos - M) % W
        cache["slot_pos"][:M] = torch.arange(M, device=x.device)
        cache["slot_pos"][ring] = tail_pos.to(torch.int32)
        for i, blk in enumerate(self.layers):
            x, (k, v), conv, ssd = self._block(x, blk)
            for key, t in (("k", k), ("v", v)):
                t = t.to(torch.bfloat16)
                cache[key][i, :, :M] = t[:, :M]
                cache[key][i, :, ring] = t[:, tail_pos]
            cache["conv"][i] = conv
            cache["ssd"][i] = ssd
        return self._logits(x[:, -1:, :]), cache

    @torch.inference_mode()
    def decode(self, cache: dict, token, pos: int):
        """One decode step; ``pos`` counts the meta prefix (the first new
        token is at ``n_meta_tokens + prompt_len``). The cache updates in
        place."""
        cfg = self.cfg
        x = self._embed(token)
        M, Sc = cfg.n_meta_tokens, cache["k"].shape[2]
        slot = M + (pos - M) % (Sc - M)
        slot_pos = cache["slot_pos"]
        slot_pos[slot] = pos
        # Keys valid if written, and meta or within the window.
        valid = (slot_pos >= 0) & (
            (torch.arange(Sc, device=x.device) < M)
            | (slot_pos > pos - cfg.window))
        for i, blk in enumerate(self.layers):
            h = ll.rms_norm(x, blk.ln1)
            a = ll.attention_decode(h, blk.attn, cache["k"][i],
                                    cache["v"][i], pos, cfg, slot=slot,
                                    valid=valid)
            s, conv, ssd = _mix(h, blk.ssm, cfg, conv_state=cache["conv"][i],
                                ssd_state=cache["ssd"][i], step=True)
            cache["conv"][i] = conv
            cache["ssd"][i] = ssd
            x = self._fuse(x, a, s, blk)
        return self._logits(x), cache
