"""Online-learning replay of the port: learners, the float64 host loop and
the learner kernels on the card (Hedge; exp3, ucb1, egreedy and ftl), and
regret accounting."""

from repro_torch.learn.learners import (
    FULL_INFO_KINDS,
    LEARNER_KINDS,
    LearnerSpec,
    Schedule,
    as_spec,
)
from repro_torch.learn.regret import LearnResult, prop_b1_bound
from repro_torch.learn.replay import build_events, replay

__all__ = ["LEARNER_KINDS", "FULL_INFO_KINDS", "LearnerSpec", "Schedule",
           "as_spec", "LearnResult", "prop_b1_bound", "build_events",
           "replay"]
