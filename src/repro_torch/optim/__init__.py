"""AdamW and the learning-rate schedules of the port's trainer (the
reference's ``repro.optim``)."""

from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = ["AdamW", "OptState", "cosine_schedule", "linear_warmup"]
