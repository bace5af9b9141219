"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

* ``policy_cost.policy_cost_chain`` — early-start chain costs over a
  (bid x scenario x row) sweep (``csrc/policy_cost.cu``: A in shared
  memory where it fits, ``chain_plan``'s rule, else a global-memory
  kernel);
* ``policy_cost.policy_cost`` — planned-start task costs, scenarios as a
  grid dimension (``csrc/policy_cost.cu``);
* ``weight_update.hedge_replay`` — the Hedge weight-update replay
  (``csrc/hedge_replay.cu``);
* ``learner_replay.learner_replay`` — the exp3, ucb1, egreedy and ftl
  replay, one warp per (scenario, instance) walking the event stream
  (``csrc/learner_replay.cu``);
* ``flash_attention.flash_attention_fwd`` — online-softmax attention
  forward with GQA, causal, window and prefix masks
  (``csrc/flash_attention.cu``: a tensor-core kernel for bfloat16 at dh 64
  or 128, a CUDA-core kernel for every other call;
  ``ops.flash_attention`` for the models' (B, S, H, dh) layout);
* ``ssd_scan.ssd_scan`` — the Mamba-2 SSD chunked scan
  (``csrc/ssd_scan.cu``: four chunk-parallel passes with split-TF32
  tensor-core products; ``ops.ssd``).

A wrapper given CPU tensors computes its plain version; given CUDA tensors
it launches its kernel or raises. ``LAUNCHES`` counts kernel launches by
wrapper name (plain-version calls do not count), so a run can show which
kernels its path went through; ``policy_cost_chain`` counts both chain
kernels and ``policy_cost_chain_smem`` the shared-memory ones among them;
``flash_attention`` counts both attention kernels and
``flash_attention_tc`` the tensor-core ones among them;
``ssd_scan`` counts calls, each of which launches the scan's four passes.
"""

from __future__ import annotations

import collections

__all__ = ["LAUNCHES"]

LAUNCHES: collections.Counter = collections.Counter()
