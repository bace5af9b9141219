"""Straggler mitigation: heartbeat-quantile detection + speculative
re-execution.

At pod scale the slowest worker sets the step time; a pod whose heartbeat
latency exceeds q75 + k * IQR for ``patience`` consecutive beats is marked a
straggler and its stage is speculatively relaunched on spare capacity — the
first copy to finish wins (classic MapReduce-style speculation, applied at
the pod/stage granularity the paper's tasks have).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StragglerDetector"]


@dataclasses.dataclass
class StragglerDetector:
    k_iqr: float = 3.0
    patience: int = 3

    def __post_init__(self):
        self._strikes: dict[int, int] = {}

    def update(self, heartbeat_s: np.ndarray) -> list[int]:
        """heartbeat_s: (n_pods,) latest per-pod step/heartbeat latencies.
        Returns pod ids to speculatively re-launch."""
        hb = np.asarray(heartbeat_s, dtype=np.float64)
        q25, q75 = np.percentile(hb, [25, 75])
        thresh = q75 + self.k_iqr * max(q75 - q25, 1e-9)
        out = []
        for pod, lat in enumerate(hb):
            if lat > thresh:
                self._strikes[pod] = self._strikes.get(pod, 0) + 1
                if self._strikes[pod] >= self.patience:
                    out.append(pod)
                    self._strikes[pod] = 0
            else:
                self._strikes[pod] = 0
        return out

    def should_speculate(self, progress: np.ndarray,
                         threshold: float = 0.7) -> list[int]:
        """Stage-level speculation: relaunch copies of stages whose progress
        lags the median by more than (1 - threshold)."""
        med = np.median(progress)
        return [i for i, p in enumerate(progress) if p < threshold * med]
