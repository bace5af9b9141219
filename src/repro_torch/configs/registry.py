"""Architecture registry + input-shape cells (the reference's
``configs/registry.py``).

Every architecture is a selectable config (``--arch <id>``); each (arch x
shape) cell yields input specs for the dry-run: ``meta``-device tensors of
the reference's shapes and dtypes (no allocation), where the reference
returns ``ShapeDtypeStruct``s.

Shape semantics (assignment):
  train_4k     seq 4096,  global_batch 256  -> train_step
  prefill_32k  seq 32768, global_batch 32   -> prefill (serve) lowering
  decode_32k   seq 32768 KV, global_batch 128 -> one-token serve_step
  long_500k    seq 524288 KV, global_batch 1  -> one-token serve_step;
               ONLY for sub-quadratic archs (ssm/hybrid) — full-attention
               archs skip it (see DESIGN.md §Arch-applicability).

``PORTED`` names the architectures the port serves and trains (every one).
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_NAMES", "PORTED", "SHAPES", "ShapeSpec", "get_config",
           "input_specs", "smoke_config", "supports"]

ARCH_NAMES = (
    "seamless_m4t_medium",
    "granite_3_8b",
    "tinyllama_1_1b",
    "qwen2_5_32b",
    "llama3_8b",
    "phi_3_vision_4_2b",
    "deepseek_moe_16b",
    "olmoe_1b_7b",
    "hymba_1_5b",
    "mamba2_2_7b",
)
PORTED = ("tinyllama_1_1b", "mamba2_2_7b", "llama3_8b", "granite_3_8b",
          "qwen2_5_32b", "hymba_1_5b", "seamless_m4t_medium",
          "deepseek_moe_16b", "olmoe_1b_7b", "phi_3_vision_4_2b")


def _module(name: str):
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_NAMES:
        raise ValueError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    """The published full-width configuration of ``name``."""
    return _module(name).config()


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).smoke()


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def supports(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether this (arch x shape) cell runs, and why not if it doesn't."""
    if shape == "long_500k" and cfg.kind not in ("ssm", "hybrid"):
        return False, ("full quadratic attention: a 512k KV pass is O(S^2) "
                       "compute and O(S) KV memory per layer — out of scope "
                       "per assignment; served by ssm/hybrid archs")
    return True, ""


def _i32(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _f32(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec | str) -> dict:
    """``meta`` stand-ins for the step function's ``batch`` arg.

    Frontend stubs: ``frames`` (audio, seq/4 frames) and ``vision``
    (patch embeddings) arrive as precomputed d_model embeddings.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len

    if shape.mode in ("train", "prefill"):
        spec = {"tokens": _i32(B, S)}
        if cfg.kind == "encdec":
            spec["frames"] = _f32(B, max(S // 4, 1), cfg.d_model)
        if cfg.kind == "vlm":
            P = cfg.frontend_len
            spec = {"tokens": _i32(B, S - P),
                    "vision": _f32(B, P, cfg.d_model)}
        if shape.mode == "train":
            spec["labels"] = _i32(B, spec["tokens"].shape[1])
        return spec
    # decode: one new token against a seq_len-deep cache
    return {"token": _i32(B, 1)}
