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
  replay, one block per (scenario, instance): an update warp carrying the
  state through the updates, sample warps drawing from its shared-memory
  snapshots (``csrc/learner_replay.cu``);
* ``flash_attention.flash_attention_fwd`` — online-softmax attention
  forward with GQA, causal, window and prefix masks
  (``csrc/flash_attention.cu``: a tensor-core kernel for bfloat16 at dh 64
  or 128, a CUDA-core kernel for every other call;
  ``ops.flash_attention`` for the models' (B, S, H, dh) layout);
* ``ssd_scan.ssd_scan`` — the Mamba-2 SSD chunked scan
  (``csrc/ssd_scan.cu``: four chunk-parallel passes with split-TF32
  tensor-core products; ``ops.ssd``).

* ``flash_attention.flash_attention_backward`` — the attention backward,
  FlashAttention-2's (``csrc/flash_backward.cu``: mma.sync tensor-core
  kernels for bfloat16 at dh 64, 96 or 128, CUDA-core kernels for every
  other call);
* ``ssd_scan.ssd_scan_backward`` — the SSD scan's gradients
  (``csrc/ssd_scan.cu``'s ``ssd_scan_bwd_launch``: the forward's first
  three passes again, then the gradient passes).

A wrapper given CPU tensors computes its plain version; given CUDA tensors
it launches its kernel or raises. Training reaches the two LM kernels
through autograd Functions (``flash_attention.FlashAttention``,
``ssd_scan.SSDScan``) whose forwards are the same kernels and whose
backwards are the two backward kernels. ``flash_attention`` and ``ssd`` are the
kernels as the models call them (``ops.py``, the reference's public names).
``LAUNCHES`` counts kernel launches by
wrapper name (plain-version calls do not count), so a run can show which
kernels its path went through; ``policy_cost_chain`` counts both chain
kernels and ``policy_cost_chain_smem`` the shared-memory ones among them;
``flash_attention`` counts both attention kernels and
``flash_attention_tc`` the tensor-core ones among them;
``ssd_scan`` counts calls, each of which launches the scan's four passes;
``flash_attention_backward`` counts backward calls and
``flash_attention_backward_tc`` the tensor-core ones among them;
``ssd_scan_backward`` counts backward calls.
Under ``repro_torch.obs.capture()`` each of those launches also records a
CUDA event pair and its work under the same name.

The package attribute ``flash_attention`` is the function (as in the
reference), which shadows the submodule of that name: import the module
as ``from repro_torch.kernels.flash_attention import ...`` or through
``importlib.import_module``.
"""

from __future__ import annotations

import collections

__all__ = ["LAUNCHES", "flash_attention", "ssd"]

LAUNCHES: collections.Counter = collections.Counter()

from repro_torch.kernels.ops import flash_attention, ssd  # noqa: E402
