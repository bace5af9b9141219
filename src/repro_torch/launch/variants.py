"""Sharding/config variants for the §Perf hillclimb (the reference's
``launch/variants.py``, unchanged: the port reads it in its dry-run).

Each variant maps (cfg, shape) -> (rule_overrides, cfg'). ``base`` is the
paper-faithful baseline configuration; the others are the hypothesis-driven
changes logged in EXPERIMENTS.md §Perf.
"""

from __future__ import annotations

__all__ = ["VARIANTS"]


def _base(cfg, shape):
    return {}, cfg


def _seq_parallel_prefill(cfg, shape):
    """Shard the sequence over the model axis for long prefill (context
    parallelism): activations (B, S, D) carry S/16 per chip instead of
    replicating 32k-deep activations."""
    return {"seq": "model"}, cfg


def _no_remat(cfg, shape):
    """Disable activation recomputation (memory for compute trade)."""
    import dataclasses
    return {}, dataclasses.replace(cfg, remat=False)


def _fsdp_model_too(cfg, shape):
    """Also shard fsdp params over the model axis (ZeRO-3 across ALL chips,
    not just the data axis) — cuts per-chip param+opt bytes 16x, adds
    all-gathers."""
    return {"fsdp": ("pod", "data", "model")}, cfg


def _batch_over_model_too(cfg, shape):
    """Decode variant: spread the batch over every axis (model included) —
    trades weight replication for batch locality."""
    return {"cache_batch": ("pod", "data", "model")}, cfg


def _flash_train(cfg, shape):
    """Blockwise (flash-style) attention for training sequences too —
    kills the O(S^2) f32 score traffic the memory term is dominated by."""
    import dataclasses
    return {}, dataclasses.replace(cfg, flash_threshold=2048)


def _moe_grouped(cfg, shape):
    """Data-local MoE dispatch: routing gathers/scatters never cross the
    data shards; only expert buffers travel (all-to-all)."""
    import dataclasses
    return {}, dataclasses.replace(cfg, moe_groups=64)


def _flash_and_grouped(cfg, shape):
    import dataclasses
    return {}, dataclasses.replace(cfg, flash_threshold=2048, moe_groups=64)


def _accum8(cfg, shape):
    """8 microbatches instead of 4: halves transient activation peak."""
    return {"_microbatches": 8}, cfg


def _flash_accum8(cfg, shape):
    import dataclasses
    return {"_microbatches": 8}, dataclasses.replace(cfg, flash_threshold=2048)


def _flash_accum16(cfg, shape):
    import dataclasses
    return {"_microbatches": 16}, dataclasses.replace(cfg,
                                                      flash_threshold=2048)


VARIANTS = {
    "base": _base,
    "accum8": _accum8,
    "flash_accum8": _flash_accum8,
    "flash_accum16": _flash_accum16,
    "seqpar": _seq_parallel_prefill,
    "no_remat": _no_remat,
    "fsdp_all": _fsdp_model_too,
    "decode_ball": _batch_over_model_too,
    "flash_train": _flash_train,
    "moe_grouped": _moe_grouped,
    "flash_grouped": _flash_and_grouped,
}
