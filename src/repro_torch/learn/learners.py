"""Learner definitions for the online-learning subsystem.

One learner = a *state layout* shared by every algorithm (``logw`` for the
exponentiated-weights family, ``sums``/``counts`` for the index policies)
plus two pure functions:

* ``sample_probs(kind, state, gamma)`` — the distribution a policy is
  drawn from when a job arrives;
* ``update_state(kind, state, c_row, chosen_oh, p_chosen, eta)`` — the
  reweighting applied once the job's window has elapsed and its
  (counterfactual) costs are observable.

Both are float64 numpy: they run the sequential host replay (the exact
oracle, and the loop TOLA's rounds use). The Hedge kernel
``repro_torch.kernels.weight_update`` computes the same Hedge recurrence on
the card. Feedback model per kind:

* ``hedge``   — the paper's Alg. 4: full information (the whole cost row
  enters the update), exponentiated weights, log-space renormalization
  every step so long horizons cannot flush the weights to zero.
* ``exp3``    — bandit feedback: only the sampled policy's cost is observed;
  the importance-weighted estimate ``c/p`` drives the same exponential
  update, and sampling mixes in ``gamma`` uniform exploration.
* ``ucb1``    — bandit feedback, deterministic index policy on the
  lower-confidence bound (costs, so LCB not UCB).
* ``egreedy`` — bandit feedback, greedy on the empirical mean with
  ``gamma``-uniform exploration.
* ``ftl``     — follow-the-leader: full information, plays the policy with
  the smallest cumulative cost so far (no regularization — the unstable
  baseline the regret curves are plotted against).

Schedules (``eta`` for learning rates, ``explore`` for gamma/epsilon) are
evaluated up front into per-job arrays — "pluggable" means swapping a (J,)
vector, which is what makes a schedule grid one batched kernel launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "LEARNER_KINDS",
    "Schedule",
    "LearnerSpec",
    "as_spec",
    "init_state",
    "sample_probs",
    "update_state",
]

LEARNER_KINDS = ("hedge", "exp3", "ucb1", "egreedy", "ftl")

_NEG = 3.0e38  # "minus infinity" that stays finite in float32


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A per-job scalar schedule (learning rate or exploration rate).

    ``alg4``    — the paper's Alg. 4 line 16: at the update event of job j
                  (time ``t = a_j + d``), ``eta = sqrt(2 log m / (d *
                  max(t - d, d)))``; reproduced operation-for-operation so
                  the numpy replay stays bit-compatible with the pre-learn
                  ``run_tola`` loop.
    ``const``   — a constant ``c`` (the eta-grid axis of the sweeps).
    ``invsqrt`` — ``c / sqrt(j + 1)`` over the job index.
    """

    kind: str = "alg4"
    c: float = 0.1

    def values(self, arrivals: np.ndarray, d: float, m: int) -> np.ndarray:
        n = len(arrivals)
        if self.kind == "alg4":
            # t - d recomputed from t = a_j + d (NOT simplified to a_j):
            # (a + d) - d can differ from a in float64, and bit-compat with
            # the legacy event loop is part of the numpy oracle's contract.
            t = arrivals + d
            return np.sqrt(2.0 * np.log(m) / (d * np.maximum(t - d, d)))
        if self.kind == "const":
            return np.full(n, float(self.c))
        if self.kind == "invsqrt":
            return self.c / np.sqrt(1.0 + np.arange(n))
        raise ValueError(f"unknown schedule kind {self.kind!r}")

    @property
    def label(self) -> str:
        return "alg4" if self.kind == "alg4" else f"{self.kind}:{self.c:g}"


@dataclasses.dataclass(frozen=True)
class LearnerSpec:
    """One learner instance of a replay sweep: algorithm + schedules."""

    kind: str
    eta: Schedule = Schedule()
    explore: Schedule = Schedule("const", 0.1)

    def __post_init__(self):
        if self.kind not in LEARNER_KINDS:
            raise ValueError(
                f"unknown learner {self.kind!r}; pick from {LEARNER_KINDS}")

    @property
    def label(self) -> str:
        parts = [self.kind]
        if self.kind in ("hedge", "exp3") and self.eta != Schedule():
            parts.append(f"eta={self.eta.label}")
        if self.kind in ("exp3", "egreedy") and \
                self.explore != Schedule("const", 0.1):
            parts.append(f"g={self.explore.label}")
        return "[" + ",".join(parts) + "]" if len(parts) > 1 else self.kind


def as_spec(learner) -> LearnerSpec:
    return learner if isinstance(learner, LearnerSpec) else LearnerSpec(learner)


def init_state(m: int) -> dict:
    """Common state layout (every kind carries all fields)."""
    return {
        "logw": np.full(m, -float(np.log(m))),
        "sums": np.zeros(m),
        "counts": np.zeros(m),
    }


def _softmax(logw):
    w = np.exp(logw - logw.max())
    return w / w.sum()


def _onehot(idx, m):
    return np.where(np.arange(m) == idx, 1.0, 0.0)


def sample_probs(kind: str, state: dict, gamma):
    """Sampling distribution over the m policies at a job's arrival."""
    m = state["logw"].shape[0]
    if kind == "hedge":
        return _softmax(state["logw"])
    if kind == "exp3":
        return (1.0 - gamma) * _softmax(state["logw"]) + gamma / m
    counts, sums = state["counts"], state["sums"]
    cnt_safe = np.maximum(counts, 1.0)
    mean = sums / cnt_safe
    untried = counts < 0.5
    if kind == "ftl":
        return _onehot(np.argmin(sums), m)
    if kind == "ucb1":
        t = np.maximum(counts.sum(), 1.0)
        lcb = mean - np.sqrt(2.0 * np.log(t) / cnt_safe)
        # Untried arms score -inf -> argmin visits them first (ties break
        # toward the lowest index).
        return _onehot(np.argmin(np.where(untried, -_NEG, lcb)), m)
    if kind == "egreedy":
        greedy = _onehot(np.argmin(np.where(untried, -_NEG, mean)), m)
        return (1.0 - gamma) * greedy + gamma / m
    raise ValueError(f"unknown learner kind {kind!r}")


def update_state(kind: str, state: dict, c_row, chosen_oh, p_chosen,
                 eta) -> dict:
    """Observe job j's cost row (full info) or sampled entry (bandit).

    ``chosen_oh`` is the one-hot of the policy sampled for this job and
    ``p_chosen`` its probability at sample time (the importance weight).
    The exponentiated-weights updates renormalize in LOG SPACE every step
    (``logw -= logw.max()``) — the max weight is pinned at exp(0) = 1, so no
    horizon length can flush the whole vector to zero (float32 exp
    underflows at logw < -88; a 5k-job stream drifts far past that without
    the rescale).
    """
    logw, sums, counts = state["logw"], state["sums"], state["counts"]
    if kind == "hedge":
        logw = logw - eta * c_row
        logw = logw - logw.max()
    elif kind == "exp3":
        c_hat = chosen_oh * ((c_row * chosen_oh).sum() / p_chosen)
        logw = logw - eta * c_hat
        logw = logw - logw.max()
    elif kind == "ftl":
        sums = sums + c_row
    elif kind in ("ucb1", "egreedy"):
        sums = sums + chosen_oh * (c_row * chosen_oh).sum()
        counts = counts + chosen_oh
    else:
        raise ValueError(f"unknown learner kind {kind!r}")
    return {"logw": logw, "sums": sums, "counts": counts}
