"""Batched greedy serving loop (the reference's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \\
        --smoke --device cpu

Requests are served in groups of ``batch`` (the last group zero-padded): one
prefill of the group's prompts, then ``max_new - 1`` lockstep greedy decode
steps from position ``S + n_meta``. The encoder-decoder's audio frontend is
the reference's stub: zero frames (batch, max(S // 4, 1), d_model) for each
group; the vlm's vision frontend is its stub too, zero patch embeddings
(batch, frontend_len, d_model). The vlm decodes from ``S`` as the
reference does, although its cache holds the patches before the text
(ROADMAP queue C). The generated tokens stay on the device until the group
ends.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as step_lib
from repro_torch.models import build
from repro_torch.obs import span

__all__ = ["serve_requests", "main"]


def serve_requests(cfg, prompts: np.ndarray, batch: int, max_new: int,
                   params=None, seed: int = 0, device="cuda"):
    """prompts: (n_requests, prompt_len) int32. ``params``: a state dict of
    the model (``interop.params_from_reference``), whose float32 tensors
    on ``device`` the model takes as they are (no copy; any other is cast
    to a float32 master), else weights from the port's own init with a
    ``torch.Generator`` seeded by ``seed`` on the device. Returns
    ((n, max_new) int32 tokens, stats)."""
    dev = resolve_device(device)
    if params is None:
        model = build(cfg, dev)
        model.init_weights(torch.Generator(dev).manual_seed(seed))
    else:
        model = build(cfg, "meta")
        model.load_state_dict(
            {k: v.to(dev, torch.float32) for k, v in params.items()},
            assign=True)
    n, S = prompts.shape
    max_len = S + max_new + (cfg.n_meta_tokens or 0)
    prefill_fn = step_lib.make_prefill_step(model, max_len)
    decode_fn = step_lib.make_decode_step(model)

    out = np.zeros((n, max_new), np.int32)
    queue = list(range(n))
    with span("serve.requests", n=n, batch=batch, max_new=max_new) as sp:
        while queue:
            ids = queue[:batch]
            queue = queue[len(ids):]
            toks = np.concatenate(
                [prompts[ids], np.zeros((batch - len(ids), S), np.int32)],
                axis=0)
            pbatch = {"tokens": torch.as_tensor(toks, device=dev)}
            if cfg.kind == "encdec":  # stub audio frontend
                pbatch["frames"] = torch.zeros(
                    (batch, max(S // 4, 1), cfg.d_model), dtype=torch.float32,
                    device=dev)
            if cfg.kind == "vlm":     # stub vision frontend
                pbatch["vision"] = torch.zeros(
                    (batch, cfg.frontend_len, cfg.d_model),
                    dtype=torch.float32, device=dev)
            token, cache = prefill_fn(pbatch)
            pos0 = S + (cfg.n_meta_tokens or 0)
            tokens = [token]
            for t in range(max_new - 1):
                token, cache = decode_fn(cache, token, pos0 + t)
                tokens.append(token)
            out[ids] = torch.cat(tokens, 1)[:len(ids), :max_new].cpu().numpy()
    wall = sp.seconds
    return out, {"requests": n, "tokens_per_s": n * max_new / max(wall, 1e-9),
                 "wall_s": wall}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="tinyllama_1_1b", choices=ARCH_NAMES)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len),
                           dtype=np.int32)
    out, stats = serve_requests(cfg, prompts, args.batch, args.max_new,
                                device=args.device)
    print(f"[serve] {stats['requests']} requests, "
          f"{stats['tokens_per_s']:.1f} tok/s, wall {stats['wall_s']:.1f}s")
    print("[serve] first completion:", out[0][:12].tolist())
    return stats


if __name__ == "__main__":
    main()
