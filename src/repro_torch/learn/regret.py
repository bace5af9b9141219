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

__all__ = ["LearnResult", "StreamLearnResult", "prop_b1_bound"]


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


@dataclasses.dataclass
class StreamLearnResult:
    """Streaming regret accumulator — ``LearnResult`` folded chunk by chunk.

    Built by ``replay_stream``: every scenario chunk's ``LearnResult`` is
    folded into per-learner sums and sums-of-squares over the SCENARIO
    axis, so regret means, curves and confidence bands over many scenarios
    come out without ever holding the (S, J, P) cost tensor (or any other
    S-sized array — peak memory is (K, J), independent of S).
    Scenario-mean statistics match the materialized ``LearnResult``'s to
    float-summation tolerance (the per-scenario terms are identical; only
    the summation grouping differs).
    """

    specs: list
    feedback_delay: float
    backend: str = "numpy"
    n_scenarios: int = 0
    n_chunks: int = 0
    realized_sum: np.ndarray | None = None     # (K,) realized stream cost
    expected_sum: np.ndarray | None = None     # (K,) expected stream cost
    regret_sum: np.ndarray | None = None       # (K,)
    regret_sq: np.ndarray | None = None        # (K,)
    best_fixed_sum: float = 0.0
    curve_sum: np.ndarray | None = None        # (K, J) realized regret curve
    curve_sq: np.ndarray | None = None         # (K, J)
    weights_sum: np.ndarray | None = None      # (K, P) final distributions
    top_weight_sum: np.ndarray | None = None   # (K,)
    # ``repro_torch.obs`` snapshot ({"metrics": ..., "compiled": ...})
    # taken by replay_stream when an observability context was active;
    # None otherwise.
    obs: dict | None = None

    @property
    def labels(self) -> list[str]:
        return [sp.label for sp in self.specs]

    def fold(self, lr: LearnResult) -> np.ndarray:
        """Fold one chunk's ``LearnResult``; returns the chunk's
        per-scenario realized regret of learner 0 (the adaptive
        adversary's feedback signal)."""
        if self.n_scenarios == 0:
            K, J = len(lr.specs), lr.unit_cost.shape[1]
            P = lr.weights.shape[-1]
            self.realized_sum = np.zeros(K)
            self.expected_sum = np.zeros(K)
            self.regret_sum = np.zeros(K)
            self.regret_sq = np.zeros(K)
            self.curve_sum = np.zeros((K, J))
            self.curve_sq = np.zeros((K, J))
            self.weights_sum = np.zeros((K, P))
            self.top_weight_sum = np.zeros(K)
        realized = lr.realized_unit()                    # (S_c, K)
        regret = lr.regret_per_job()                     # (S_c, K)
        curves = lr.regret_curve()                       # (S_c, K, J)
        self.realized_sum += realized.sum(axis=0)
        self.expected_sum += ((lr.expected_unit * lr.workload).sum(axis=2)
                              / lr.workload.sum()).sum(axis=0)
        self.regret_sum += regret.sum(axis=0)
        self.regret_sq += (regret ** 2).sum(axis=0)
        self.best_fixed_sum += float(lr.best_fixed().sum())
        self.curve_sum += curves.sum(axis=0)
        self.curve_sq += (curves ** 2).sum(axis=0)
        self.weights_sum += lr.weights.sum(axis=0)
        self.top_weight_sum += lr.weights.max(axis=2).sum(axis=0)
        self.n_scenarios += lr.n_scenarios
        self.n_chunks += 1
        return regret[:, 0]

    def fold_sums(self, n: int, realized, expected, regret, regret_sq,
                  best_fixed: float, curve, curve_sq, weights,
                  top_weight) -> None:
        """Fold one chunk's PRE-REDUCED sums (specs order, already summed
        over the chunk's scenario axis, as a sharded fold hands them back).
        Same accumulator state as ``fold``, without ever holding the
        chunk's per-scenario arrays on the host."""
        if self.n_scenarios == 0:
            K, J = np.shape(curve)
            P = np.shape(weights)[-1]
            self.realized_sum = np.zeros(K)
            self.expected_sum = np.zeros(K)
            self.regret_sum = np.zeros(K)
            self.regret_sq = np.zeros(K)
            self.curve_sum = np.zeros((K, J))
            self.curve_sq = np.zeros((K, J))
            self.weights_sum = np.zeros((K, P))
            self.top_weight_sum = np.zeros(K)
        self.realized_sum += realized
        self.expected_sum += expected
        self.regret_sum += regret
        self.regret_sq += regret_sq
        self.best_fixed_sum += float(best_fixed)
        self.curve_sum += curve
        self.curve_sq += curve_sq
        self.weights_sum += weights
        self.top_weight_sum += top_weight
        self.n_scenarios += int(n)
        self.n_chunks += 1

    # -- scenario-mean statistics (match LearnResult's .mean(axis=0)) ------
    def realized_unit(self) -> np.ndarray:
        return self.realized_sum / self.n_scenarios

    def best_fixed(self) -> float:
        return self.best_fixed_sum / self.n_scenarios

    def regret_per_job(self, expected: bool = False) -> np.ndarray:
        if expected:
            return (self.expected_sum / self.n_scenarios) - self.best_fixed()
        return self.regret_sum / self.n_scenarios

    def regret_std(self) -> np.ndarray:
        """(K,) across-scenario std of the per-scenario realized regret."""
        mean = self.regret_sum / self.n_scenarios
        var = self.regret_sq / self.n_scenarios - mean ** 2
        return np.sqrt(np.maximum(var, 0.0))

    def weights(self) -> np.ndarray:
        """(K, P) scenario-mean final sampling distributions."""
        return self.weights_sum / self.n_scenarios

    def confidence_bands(self, z: float = 1.96):
        """(mean, lo, hi) regret-curve bands, each (K, J), across the S
        streamed scenarios (same contract as LearnResult.confidence_bands)."""
        S = self.n_scenarios
        mean = self.curve_sum / S
        var = np.maximum(self.curve_sq / S - mean ** 2, 0.0)
        se = np.sqrt(var) / np.sqrt(max(S, 1))
        return mean, mean - z * se, mean + z * se

    def summary(self) -> list[dict]:
        """Scenario-mean headline numbers per learner (bench/table rows)."""
        realized = self.realized_unit()
        regret = self.regret_per_job()
        exp_regret = self.regret_per_job(expected=True)
        top_w = self.top_weight_sum / self.n_scenarios
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
