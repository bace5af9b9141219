"""Online-learning replay of the port: learners, the float64 host loop and
the Hedge kernel on the card, and regret accounting."""

from repro_torch.learn.learners import (
    LEARNER_KINDS,
    LearnerSpec,
    Schedule,
    as_spec,
)
from repro_torch.learn.regret import LearnResult
from repro_torch.learn.replay import build_events, replay

__all__ = ["LEARNER_KINDS", "LearnerSpec", "Schedule",
           "as_spec", "LearnResult", "build_events", "replay"]
