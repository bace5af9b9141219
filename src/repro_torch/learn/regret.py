"""Regret accounting for replayed learners (mirrors ``engine/result.py``).

Everything here is float64 numpy on the backends' OUTPUTS (sampled traces,
final weights) plus the original float64 cost tensor — so the regret curves
of a kernel replay are computed with exactly the same arithmetic as the
numpy oracle's, and backend parity reduces to the sampled trace and
weights.

Conventions: all per-job costs are per-unit-workload (the engine's
``unit_cost``); aggregates weight jobs by Z_j, matching the paper's stream
metric ``alpha = sum_j c_j / sum_j Z_j`` and ``TolaResult``'s
``regret_per_job``. "Best fixed" is best-in-hindsight over the FULL
horizon, so a regret curve can dip negative early when the eventual winner
starts poorly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LearnResult", "prop_b1_bound"]


@dataclasses.dataclass
class LearnResult:
    """Batched (scenario x learner) replay output.

    Axes: S scenarios x K learner instances (specs order) x J jobs x P
    policies. ``expected_unit`` is the prob-weighted per-job cost at sample
    time (sampling-noise-free — what the Prop. B.1 bound controls);
    ``p_chosen`` the sampled policy's probability (the bandit learners'
    importance weights).
    """

    specs: list
    chosen: np.ndarray         # (S, K, J) sampled policy index
    p_chosen: np.ndarray       # (S, K, J)
    expected_unit: np.ndarray  # (S, K, J)
    weights: np.ndarray        # (S, K, P) final sampling distribution
    unit_cost: np.ndarray      # (S, J, P) the replayed cost tensor (f64)
    arrivals: np.ndarray       # (J,)
    workload: np.ndarray       # (J,) Z_j
    feedback_delay: float      # d — max relative deadline
    backend: str = "numpy"     # "numpy" (host f64 loop) | "torch"

    @property
    def n_scenarios(self) -> int:
        return self.unit_cost.shape[0]

    @property
    def labels(self) -> list[str]:
        return [sp.label for sp in self.specs]

    def realized_unit(self) -> np.ndarray:
        """(S, K) realized counterfactual stream cost of the sampled trace."""
        c = np.take_along_axis(
            self.unit_cost[:, None], self.chosen[..., None], axis=3)[..., 0]
        return (c * self.workload).sum(axis=2) / self.workload.sum()

    def fixed_unit_costs(self) -> np.ndarray:
        """(S, P) stream cost of every fixed policy."""
        return ((self.unit_cost * self.workload[None, :, None]).sum(axis=1)
                / self.workload.sum())

    def best_fixed(self) -> np.ndarray:
        """(S,) best-fixed-policy-in-hindsight stream cost."""
        return self.fixed_unit_costs().min(axis=1)

    def regret_per_job(self, expected: bool = False) -> np.ndarray:
        """(S, K) average excess unit cost vs the best fixed policy."""
        if expected:
            real = ((self.expected_unit * self.workload).sum(axis=2)
                    / self.workload.sum())
        else:
            real = self.realized_unit()
        return real - self.best_fixed()[:, None]

    def regret_curve(self, expected: bool = False) -> np.ndarray:
        """(S, K, J) running realized regret per unit workload.

        ``curve[s, k, t] = (cum cost of the sampled trace - cum cost of the
        hindsight-best fixed policy) / cum workload`` after t+1 jobs.
        """
        Z = self.workload
        if expected:
            per_job = self.expected_unit
        else:
            per_job = np.take_along_axis(
                self.unit_cost[:, None], self.chosen[..., None],
                axis=3)[..., 0]
        cum_real = np.cumsum(per_job * Z, axis=2)
        fixed = (self.unit_cost * Z[None, :, None]).cumsum(axis=1)  # (S,J,P)
        p_star = fixed[:, -1].argmin(axis=1)                        # (S,)
        cum_best = np.take_along_axis(
            fixed, p_star[:, None, None], axis=2)[..., 0]           # (S, J)
        return (cum_real - cum_best[:, None]) / np.cumsum(Z)

    def confidence_bands(self, z: float = 1.96, expected: bool = False):
        """Per-learner regret-curve bands across scenarios.

        Returns ``(mean, lo, hi)``, each (K, J): scenario mean +- z standard
        errors (the S market scenarios are the independent replicates).
        """
        curves = self.regret_curve(expected=expected)
        mean = curves.mean(axis=0)
        se = curves.std(axis=0) / np.sqrt(max(self.n_scenarios, 1))
        return mean, mean - z * se, mean + z * se

    def summary(self) -> list[dict]:
        """Scenario-mean headline numbers per learner (bench/table rows)."""
        realized = self.realized_unit().mean(axis=0)
        regret = self.regret_per_job().mean(axis=0)
        exp_regret = self.regret_per_job(expected=True).mean(axis=0)
        top_w = self.weights.max(axis=2).mean(axis=0)
        return [
            {"learner": sp.label, "realized_unit": float(realized[k]),
             "regret": float(regret[k]),
             "expected_regret": float(exp_regret[k]),
             "top_weight": float(top_w[k])}
            for k, sp in enumerate(self.specs)
        ]


def prop_b1_bound(arrivals, d: float, m: int, c_max: float = 1.0) -> float:
    """Prop. B.1-style regret bound for delayed-feedback Hedge.

    With losses in [0, c_max] and feedback delayed until ``a_j + d``, at
    most ``D = max_j #{k != j : a_k in [a_j, a_j + d)}`` other samples are
    drawn between a job's sample and its update, and exponentiated weights
    suffer regret at most ``c_max * (sqrt(2 (D + 1) n log m) + (D + 1))``
    over n jobs (the ``+ (D + 1)`` absorbs the un-updated prefix). The
    constant is not tight.
    """
    a = np.asarray(arrivals, dtype=np.float64)
    n = len(a)
    # a is arrival-ordered: jobs in [a_j, a_j + d) form a contiguous run.
    hi = np.searchsorted(a, a + d, side="left")
    D = int((hi - np.arange(n) - 1).max()) if n else 0
    return float(c_max * (np.sqrt(2.0 * (D + 1) * n * np.log(m)) + D + 1))
