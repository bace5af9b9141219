"""PyTorch/CUDA port of ``repro`` (the paper's cost-optimal DAG scheduling
with TOLA online learning), running on an NVIDIA H100.

Same layout as ``repro`` (``core/``, ``engine/``, ``learn/``, ``kernels/``):
host code is float64 numpy copied from the reference, the cost tensor and
the Hedge replay run on the card through hand-written CUDA kernels
(``kernels/csrc/``). Entry points take ``device=`` and default to
``"cuda"``; ``device="cpu"`` runs the kernels' plain PyTorch versions.

    from repro_torch.core import generate_chain_jobs, run_tola_scenarios
    from repro_torch.experiments import table6
    table6.run(n_jobs=10000, rs=[0, 1200], scenarios=2)
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
