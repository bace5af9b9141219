"""Decoder-only LM (GQA + rotary + SwiGLU): the reference's
``models/decoder.py`` for its three kinds, the dense ``decoder``, ``moe``
(a routed-expert FFN with optional shared experts, ``layers.moe_ffn``) and
``vlm`` (a projection of stub patch embeddings prepended to the text).

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
from repro_torch.models.lm import LM, layer_axes, remat

__all__ = ["Decoder", "ATTN_AXES", "FFN_AXES", "KV_CACHE_AXES"]

# The reference's per-layer logical axes without its "layers" entry.
ATTN_AXES = {
    "wq": ("fsdp", "heads", None),
    "wk": ("fsdp", "kv_heads", None),
    "wv": ("fsdp", "kv_heads", None),
    "wo": ("heads", None, "fsdp"),
}
FFN_AXES = {
    "w_gate": ("fsdp", "d_ff"),
    "w_up": ("fsdp", "d_ff"),
    "w_down": ("d_ff", "fsdp"),
}
# The (L, B, S, K, dh) key and value caches, stacked as the reference's.
KV_CACHE_AXES = ("layers", "cache_batch", "cache_seq", None, None)


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


class Experts(nn.Module):
    """E experts' SwiGLU weights, stacked: (E, D, dE), (E, D, dE),
    (E, dE, D)."""

    def __init__(self, E: int, D: int, dE: int, device):
        super().__init__()
        self.w_gate = _param(E, D, dE, device=device)
        self.w_up = _param(E, D, dE, device=device)
        self.w_down = _param(E, dE, D, device=device)

    def init_weights(self, gen):
        for w in (self.w_gate, self.w_up, self.w_down):
            ll.dense_init_(w.data, gen, in_axis=1)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, E, dE = cfg.d_model, cfg.n_experts, cfg.d_expert
        self.router = _param(D, E, device=device)
        self.experts = Experts(E, D, dE, device)
        self.shared = SwiGLU(D, cfg.n_shared_experts * dE, device) \
            if cfg.n_shared_experts else None

    def init_weights(self, gen):
        ll.dense_init_(self.router.data, gen)
        self.experts.init_weights(gen)
        if self.shared is not None:
            self.shared.init_weights(gen)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = _param(cfg.d_model, device=device, fill=1.0)
        self.ln2 = _param(cfg.d_model, device=device, fill=1.0)
        self.attn = Attention(cfg, device)
        self.ffn = MoE(cfg, device) if cfg.kind == "moe" \
            else SwiGLU(cfg.d_model, cfg.d_ff, device)


class Decoder(LM):
    """The decoder of ``cfg`` (dense, moe or vlm) with uninitialised weights
    on ``device`` (``init_weights`` fills them; ``load_state_dict`` loads
    them)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.window > 0:
            raise NotImplementedError(
                "the port's decoder attends to every earlier position; "
                f"window={cfg.window} waits (ROADMAP A11)")
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = _param(V, D, device=device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(D, device=device, fill=1.0)
        self.lm_head = None if cfg.tie_embeddings else _param(D, V,
                                                              device=device)
        # The stub vision frontend: a projection of precomputed patch
        # embeddings (the reference leaves the CLIP tower out).
        self.vision_proj = _param(D, D, device=device) \
            if cfg.kind == "vlm" else None

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        ll.dense_init_(self.embed.data, gen, in_axis=1)
        for blk in self.layers:
            blk.attn.init_weights(gen)
            blk.ffn.init_weights(gen)
        if self.lm_head is not None:
            ll.dense_init_(self.lm_head.data, gen)
        if self.vision_proj is not None:
            ll.dense_init_(self.vision_proj.data, gen)

    def axes(self) -> dict:
        """Logical axes of every parameter, keyed by state-dict name (the
        reference's ``axes`` with the stacks' ``"layers"`` entry dropped)."""
        cfg = self.cfg
        attn = dict(ATTN_AXES)
        if cfg.qkv_bias:
            attn.update(bq=("heads", None), bk=("kv_heads", None),
                        bv=("kv_heads", None))
        if cfg.kind == "moe":
            ffn = {"router": (None, "experts"),
                   "experts": {"w_gate": ("experts", "fsdp", None),
                               "w_up": ("experts", "fsdp", None),
                               "w_down": ("experts", None, "fsdp")}}
            if cfg.n_shared_experts:
                ffn["shared"] = FFN_AXES
        else:
            ffn = FFN_AXES
        a = {"embed": ("vocab", "fsdp"),
             **layer_axes("layers", cfg.n_layers, {
                 "ln1": (None,), "ln2": (None,), "attn": attn, "ffn": ffn}),
             "final_norm": (None,)}
        if not cfg.tie_embeddings:
            a["lm_head"] = ("fsdp", "vocab")
        if cfg.kind == "vlm":
            a["vision_proj"] = ("fsdp", None)
        return a

    def cache_axes(self) -> dict:
        return {"k": KV_CACHE_AXES, "v": KV_CACHE_AXES}

    def _embed(self, tokens, vision=None):
        """Token embeddings; a vlm prepends the projected patches."""
        dt = getattr(torch, self.cfg.dtype)
        x = self._lookup(tokens).to(dt)
        if self.vision_proj is not None and vision is not None:
            v = torch.einsum("bpd,de->bpe", vision.to(dt),
                             self.vision_proj.to(dt))
            x = torch.cat([v, x], dim=1)
        return x

    def _logits(self, x):
        head = self.embed.T if self.lm_head is None else self.lm_head
        return self._head(ll.rms_norm(x, self.final_norm), head)

    def _ffn(self, x, blk):
        """The block's FFN on the residual: (x + f, the MoE's aux or 0)."""
        h = ll.rms_norm(x, blk.ln2)
        if self.cfg.kind == "moe":
            f, aux = ll.moe_ffn(h, blk.ffn, self.cfg)
            return x + f, aux
        return x + ll.swiglu(h, blk.ffn), 0.0

    def _block(self, x, blk):
        x = x + ll.attention(ll.rms_norm(x, blk.ln1), blk.attn, self.cfg)
        return self._ffn(x, blk)

    def forward(self, batch: dict):
        """Training/prefill forward -> (logits (B, S, V), aux_loss): a vlm's
        logits cover the patch positions too. Each block is recomputed in
        the backward under ``cfg.remat``."""
        x = self._embed(batch["tokens"], batch.get("vision"))
        aux = torch.zeros((), device=x.device)
        for blk in self.layers:
            x, a = remat(self.cfg, self._block, x, blk)
            aux = aux + a
        return self._logits(x), aux

    def init_cache(self, batch: int, max_len: int):
        """Zero key and value caches: every kv head, or under a split the
        rank's (``layers.kv_heads``)."""
        shape = (self.cfg.n_layers, batch, max_len,
                 ll.kv_heads(self.layers[0].attn, self.cfg), self.cfg.dh)
        dev = self.embed.device
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}

    @torch.inference_mode()
    def prefill(self, batch: dict, max_len: int | None = None):
        """Run the prompt; returns last-position logits (B, 1, V) and a
        filled bfloat16 cache, which covers a vlm's patches and text."""
        tokens = batch["tokens"]
        x = self._embed(tokens, batch.get("vision"))
        S = x.shape[1]
        cache = self.init_cache(tokens.shape[0], max(max_len or S, S))
        for i, blk in enumerate(self.layers):
            y, (k, v) = ll.attention(ll.rms_norm(x, blk.ln1), blk.attn,
                                     self.cfg, return_kv=True)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            x = self._ffn(x + y, blk)[0]
        return self._logits(x[:, -1:, :]), cache

    @torch.inference_mode()
    def decode(self, cache: dict, token, pos: int):
        """One decode step. token: (B, 1) int; pos: position index."""
        x = self._embed(token)
        for i, blk in enumerate(self.layers):
            y = ll.attention_decode(ll.rms_norm(x, blk.ln1), blk.attn,
                                    cache["k"][i], cache["v"][i], pos,
                                    self.cfg)
            x = self._ffn(x + y, blk)[0]
        return self._logits(x), cache
