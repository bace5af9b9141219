"""Encoder-decoder backbone — seamless-m4t-medium (the reference's
``models/encdec.py``).

The audio frontend is a stub, as the reference's: ``batch["frames"]``
carries precomputed frame embeddings (B, F, d_model) and the only learned
frontend piece is a projection. The encoder is bidirectional; the decoder
is causal with per-layer cross attention over the encoder's output. Decode
runs the decoder against both caches: its own keys and values (written in
place) and the encoder's, which prefill computes once per layer. Every
prefill attention goes through the flash kernel (non-causal, causal, and
cross with Sq != Sk); decode stays plain torch. Parameter names follow the
reference's tree (``enc_layers.<l>.attn.wq`` is its
``enc_layers/attn/wq[l]``, likewise ``dec_layers``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as ll
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import (
    ATTN_AXES, FFN_AXES, KV_CACHE_AXES, Attention, SwiGLU, _param)
from repro_torch.models.lm import LM, layer_axes, remat

__all__ = ["EncDec"]


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = _param(cfg.d_model, device=device, fill=1.0)
        self.ln2 = _param(cfg.d_model, device=device, fill=1.0)
        self.attn = Attention(cfg, device)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, device)

    def init_weights(self, gen):
        self.attn.init_weights(gen)
        self.ffn.init_weights(gen)


class DecBlock(EncBlock):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.ln_cross = _param(cfg.d_model, device=device, fill=1.0)
        self.cross = Attention(cfg, device)

    def init_weights(self, gen):
        self.attn.init_weights(gen)
        self.cross.init_weights(gen)
        self.ffn.init_weights(gen)


class EncDec(LM):
    """The encoder-decoder of ``cfg`` with uninitialised weights on
    ``device`` (``init_weights`` fills them; ``load_state_dict`` loads
    them)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.kind != "encdec":
            raise ValueError(f"EncDec needs kind 'encdec', got {cfg.kind!r}")
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.frame_proj = _param(D, D, device=device)
        self.embed = _param(V, D, device=device)
        self.enc_layers = nn.ModuleList(EncBlock(cfg, device)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_norm = _param(D, device=device, fill=1.0)
        self.dec_layers = nn.ModuleList(DecBlock(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.final_norm = _param(D, device=device, fill=1.0)
        self.lm_head = _param(D, V, device=device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        ll.dense_init_(self.frame_proj.data, gen)
        ll.dense_init_(self.embed.data, gen, in_axis=1)
        for blk in (*self.enc_layers, *self.dec_layers):
            blk.init_weights(gen)
        ll.dense_init_(self.lm_head.data, gen)

    def axes(self) -> dict:
        """Logical axes of every parameter, keyed by state-dict name (the
        reference's ``axes`` with the stacks' ``"layers"`` entry dropped)."""
        cfg, norm = self.cfg, (None,)
        return {"frame_proj": ("fsdp", None),
                "embed": ("vocab", "fsdp"),
                **layer_axes("enc_layers", cfg.n_enc_layers, {
                    "ln1": norm, "ln2": norm, "attn": ATTN_AXES,
                    "ffn": FFN_AXES}),
                "enc_norm": norm,
                **layer_axes("dec_layers", cfg.n_layers, {
                    "ln1": norm, "ln2": norm, "attn": ATTN_AXES,
                    "ffn": FFN_AXES, "ln_cross": norm, "cross": ATTN_AXES}),
                "final_norm": norm,
                "lm_head": ("fsdp", "vocab")}

    def cache_axes(self) -> dict:
        return dict.fromkeys(("k", "v", "cross_k", "cross_v"), KV_CACHE_AXES)

    def _dtype(self):
        return getattr(torch, self.cfg.dtype)

    def _logits(self, x):
        return self._head(ll.rms_norm(x, self.final_norm), self.lm_head)

    def encode(self, frames):
        """(B, F, D) frame embeddings -> the encoder's output (B, F, D)."""
        dt = self._dtype()
        x = torch.einsum("bfd,de->bfe", frames.to(dt), self.frame_proj.to(dt))
        for blk in self.enc_layers:
            x = remat(self.cfg, self._enc_block, x, blk)
        return ll.rms_norm(x, self.enc_norm)

    def _enc_block(self, x, blk):
        x = x + ll.attention(ll.rms_norm(x, blk.ln1), blk.attn, self.cfg,
                             causal=False)
        return x + ll.swiglu(ll.rms_norm(x, blk.ln2), blk.ffn)

    def _dec_block(self, x, blk, enc_out):
        """One decoder layer -> (x, (k, v), (cross k, cross v))."""
        y, kv = ll.attention(ll.rms_norm(x, blk.ln1), blk.attn, self.cfg,
                             return_kv=True)
        x = x + y
        y, ckv = ll.attention(ll.rms_norm(x, blk.ln_cross), blk.cross,
                              self.cfg, kv_source=enc_out, return_kv=True)
        x = x + y
        return x + ll.swiglu(ll.rms_norm(x, blk.ln2), blk.ffn), kv, ckv

    def forward(self, batch: dict):
        """Training/prefill forward -> (logits (B, S, V), aux_loss). Each
        encoder and decoder block is recomputed in the backward under
        ``cfg.remat``."""
        enc_out = self.encode(batch["frames"])
        x = self._lookup(batch["tokens"]).to(self._dtype())
        for blk in self.dec_layers:
            x = remat(self.cfg,
                      lambda x, blk, e: self._dec_block(x, blk, e)[0],
                      x, blk, enc_out)
        return self._logits(x), torch.zeros((), device=x.device)

    def init_cache(self, batch: int, max_len: int, enc_len: int):
        """Zero self and cross caches: every kv head, or under a split the
        rank's (``layers.kv_heads``)."""
        L, dh = self.cfg.n_layers, self.cfg.dh
        dev, blk = self.embed.device, self.dec_layers[0]
        zeros = lambda S, p: torch.zeros(  # noqa: E731
            (L, batch, S, ll.kv_heads(p, self.cfg), dh),
            dtype=torch.bfloat16, device=dev)
        return {"k": zeros(max_len, blk.attn), "v": zeros(max_len, blk.attn),
                "cross_k": zeros(enc_len, blk.cross),
                "cross_v": zeros(enc_len, blk.cross)}

    @torch.inference_mode()
    def prefill(self, batch: dict, max_len: int | None = None):
        """Encode the frames, run the decoder prompt, build both caches;
        returns last-position logits (B, 1, V) and the cache."""
        enc_out = self.encode(batch["frames"])
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._lookup(tokens).to(self._dtype())
        cache = self.init_cache(B, max(max_len or S, S), enc_out.shape[1])
        for i, blk in enumerate(self.dec_layers):
            x, (k, v), (ck, cv) = self._dec_block(x, blk, enc_out)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            cache["cross_k"][i] = ck
            cache["cross_v"][i] = cv
        return self._logits(x[:, -1:, :]), cache

    @torch.inference_mode()
    def decode(self, cache: dict, token, pos: int):
        """One decode step of the decoder. token: (B, 1) int; pos: position
        index. The self-attention cache updates in place."""
        x = self._lookup(token).to(self._dtype())
        for i, blk in enumerate(self.dec_layers):
            x = x + ll.attention_decode(
                ll.rms_norm(x, blk.ln1), blk.attn, cache["k"][i],
                cache["v"][i], pos, self.cfg)
            x = x + ll.attention_decode(
                ll.rms_norm(x, blk.ln_cross), blk.cross, cache["cross_k"][i],
                cache["cross_v"][i], pos, self.cfg, cross=True)
            x = x + ll.swiglu(ll.rms_norm(x, blk.ln2), blk.ffn)
        return self._logits(x), cache
