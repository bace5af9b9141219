"""The port's loss of the distribution substrate: the cross entropy (the
reference's ``distributed/xent.py``). Its sharding rules, compression and
pipeline wait for the port's ``distributed/`` slice (ROADMAP A11.8)."""

from repro_torch.distributed.xent import cross_entropy

__all__ = ["cross_entropy"]
