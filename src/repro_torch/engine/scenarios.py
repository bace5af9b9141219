"""Market scenarios of the port: materialized lists on one slot grid.

A scenario is one realized spot-price path (a ``SpotMarket``). The engine
evaluates the whole (policy x job) grid against S scenarios in one pass;
``MarketListBatch.stacked(bid)`` hands the backend each bid's stacked
(S, n_slots+1) cumulative arrays as float32 device tensors, built once per
bid from the float64 host views. Declarative ``ScenarioSpec`` families and
device synthesis are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.market import SpotMarket

__all__ = ["MarketListBatch", "make_scenarios", "check_scenarios",
           "stack_views"]


def _bid_key(bid: float) -> float:
    # Same rounding rule as the GridPlan dedup (plan.py::_bid_key).
    return round(float(bid), 12)


def check_scenarios(markets: Sequence[SpotMarket]) -> None:
    """Scenarios of one batch must share the slot grid and horizon."""
    if len(markets) == 0:
        raise ValueError(
            "scenario batch is empty: 'markets' needs at least one "
            "SpotMarket")
    m0 = markets[0]
    for m in markets[1:]:
        if m.n_slots != m0.n_slots or m.slots_per_unit != m0.slots_per_unit:
            raise ValueError(
                "scenario markets must share slot grid and horizon "
                f"(got n_slots {m.n_slots} vs {m0.n_slots})")
        if abs(m.p_ondemand - m0.p_ondemand) > 1e-12:
            raise ValueError("scenario markets must share p_ondemand")


def stack_views(markets: Sequence[SpotMarket], bid: float):
    """(S, n_slots+1) stacked float64 A/C cumulative arrays for one bid."""
    views = [m.view(bid) for m in markets]
    return (np.stack([v.A_cum for v in views]),
            np.stack([v.C_cum for v in views]))


class MarketListBatch:
    """A list of scenario markets presented as stacked per-bid views on a
    device (float32, cached per ``round(bid, 12)``)."""

    def __init__(self, markets: Sequence[SpotMarket], device: torch.device):
        self.markets = list(markets)
        check_scenarios(self.markets)
        m0 = self.markets[0]
        self.slot = m0.slot
        self.slots_per_unit = m0.slots_per_unit
        self.p_ondemand = m0.p_ondemand
        self.n_slots = m0.n_slots
        self.n_scenarios = len(self.markets)
        self.device = device
        self._stacked: dict[float, tuple] = {}

    def stacked(self, bid: float):
        """(A, C) float32 tensors of shape (S, n_slots+1) on the device."""
        key = _bid_key(bid)
        if key not in self._stacked:
            self._stacked[key] = tuple(
                torch.from_numpy(a.astype(np.float32)).to(self.device)
                for a in stack_views(self.markets, bid))
        return self._stacked[key]


def make_scenarios(horizon_units: float, n_scenarios: int,
                   seed: int = 0) -> list[SpotMarket]:
    """S materialized markets over a common horizon: the paper's price law
    under seeds seed..seed+S-1 (the reference's ``kind="fresh"``)."""
    if n_scenarios < 1:
        raise ValueError("need at least one scenario")
    return [SpotMarket(horizon_units, seed=seed + s)
            for s in range(n_scenarios)]
