"""Dense decoder-only LM (GQA + rotary + SwiGLU): the ``kind == "decoder"``
part of the reference's ``models/decoder.py``.

Parameters are ``nn.Module`` attributes named after the reference's tree
(``layers.<l>.attn.wq`` is the reference's ``layers/attn/wq[l]``), so
``interop.params_from_reference`` carries a reference model across. The
KV cache is one bfloat16 (L, B, S, K, dh) tensor each for keys and values,
written in place by prefill and decode.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as ll
from repro_torch.models.config import ModelConfig

__all__ = ["Decoder"]


def _param(*shape, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
        self.wq = _param(D, H, dh, device=device)
        self.wk = _param(D, K, dh, device=device)
        self.wv = _param(D, K, dh, device=device)
        self.wo = _param(H, dh, D, device=device)
        for name, heads in (("bq", H), ("bk", K), ("bv", K)):
            self.register_parameter(
                name, _param(heads, dh, device=device, fill=0.0)
                if cfg.qkv_bias else None)

    def init_weights(self, gen):
        for w in (self.wq, self.wk, self.wv):
            ll.dense_init_(w.data, gen)
        ll.dense_init_(self.wo.data, gen, in_axis=(0, 1))


class SwiGLU(nn.Module):
    def __init__(self, D: int, F: int, device):
        super().__init__()
        self.w_gate = _param(D, F, device=device)
        self.w_up = _param(D, F, device=device)
        self.w_down = _param(F, D, device=device)

    def init_weights(self, gen):
        for w in (self.w_gate, self.w_up, self.w_down):
            ll.dense_init_(w.data, gen)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = _param(cfg.d_model, device=device, fill=1.0)
        self.ln2 = _param(cfg.d_model, device=device, fill=1.0)
        self.attn = Attention(cfg, device)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, device)


class Decoder(nn.Module):
    """The dense decoder of ``cfg`` with uninitialised weights on ``device``
    (``init_weights`` fills them; ``load_state_dict`` loads them)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.kind != "decoder" or cfg.window > 0:
            raise NotImplementedError(
                "the port's decoder is the dense full-attention one; "
                f"kind={cfg.kind!r}, window={cfg.window} wait (ROADMAP A11)")
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = _param(V, D, device=device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(D, device=device, fill=1.0)
        self.lm_head = None if cfg.tie_embeddings else _param(D, V,
                                                              device=device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        ll.dense_init_(self.embed.data, gen, in_axis=1)
        for blk in self.layers:
            blk.attn.init_weights(gen)
            blk.ffn.init_weights(gen)
        if self.lm_head is not None:
            ll.dense_init_(self.lm_head.data, gen)

    def _embed(self, tokens):
        return self.embed[tokens].to(getattr(torch, self.cfg.dtype))

    def _logits(self, x):
        x = ll.rms_norm(x, self.final_norm)
        head = self.embed.T if self.lm_head is None else self.lm_head
        return torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))

    def _ffn(self, x, blk):
        return x + ll.swiglu(ll.rms_norm(x, blk.ln2), blk.ffn)

    def forward(self, batch: dict):
        """Training/prefill forward -> (logits (B, S, V), aux_loss)."""
        x = self._embed(batch["tokens"])
        for blk in self.layers:
            x = x + ll.attention(ll.rms_norm(x, blk.ln1), blk.attn, self.cfg)
            x = self._ffn(x, blk)
        return self._logits(x), torch.zeros((), device=x.device)

    def init_cache(self, batch: int, max_len: int):
        shape = (self.cfg.n_layers, batch, max_len, self.cfg.n_kv_heads,
                 self.cfg.dh)
        dev = self.embed.device
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}

    @torch.inference_mode()
    def prefill(self, batch: dict, max_len: int | None = None):
        """Run the prompt; returns last-position logits (B, 1, V) and a
        filled bfloat16 cache."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = self._embed(tokens)
        cache = self.init_cache(tokens.shape[0], max(max_len or S, S))
        for i, blk in enumerate(self.layers):
            y, (k, v) = ll.attention(ll.rms_norm(x, blk.ln1), blk.attn,
                                     self.cfg, return_kv=True)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            x = self._ffn(x + y, blk)
        return self._logits(x[:, -1:, :]), cache

    @torch.inference_mode()
    def decode(self, cache: dict, token, pos: int):
        """One decode step. token: (B, 1) int; pos: position index."""
        x = self._embed(token)
        for i, blk in enumerate(self.layers):
            y = ll.attention_decode(ll.rms_norm(x, blk.ln1), blk.attn,
                                    cache["k"][i], cache["v"][i], pos,
                                    self.cfg)
            x = self._ffn(x + y, blk)
        return self._logits(x), cache
