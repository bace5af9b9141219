"""Online-learning replay of the port: learners, the float64 host loop and
the learner kernels on the card (Hedge; exp3, ucb1, egreedy and ftl), and
regret accounting, monolithic or streamed by scenario chunks."""

from repro_torch.learn.learners import (
    FULL_INFO_KINDS,
    LEARNER_KINDS,
    LearnerSpec,
    Schedule,
    as_spec,
)
from repro_torch.learn.regret import (
    LearnResult,
    StreamLearnResult,
    prop_b1_bound,
)
from repro_torch.learn.replay import build_events, replay, replay_stream

__all__ = ["LEARNER_KINDS", "FULL_INFO_KINDS", "LearnerSpec", "Schedule",
           "as_spec", "LearnResult", "StreamLearnResult", "prop_b1_bound",
           "build_events", "replay", "replay_stream"]
