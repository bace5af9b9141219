"""Market scenarios of the port: materialized lists on one slot grid.

A scenario is one realized spot-price path (a ``SpotMarket``). The engine
evaluates the whole (policy x job) grid against S scenarios in one pass;
``MarketListBatch.stacked(bid)`` hands the backend each bid's stacked
(S, n_slots+1) cumulative arrays as float32 device tensors, built once per
bid from the float64 host views. ``make_scenarios`` builds the
reference's materialized families (fresh, regime, adversarial) with the
same numpy ``Generator`` streams, so their prices are the reference's bit
for bit. Declarative ``ScenarioSpec`` families, device synthesis,
streaming and the adaptive adversary are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.market import (
    PRICE_HI,
    PRICE_LO,
    PRICE_MEAN,
    SLOTS_PER_UNIT,
    SpotMarket,
)

__all__ = ["MarketListBatch", "make_scenarios", "adversarial_scenarios",
           "check_scenarios", "stack_views"]


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


def make_scenarios(
    horizon_units: float,
    n_scenarios: int,
    seed: int = 0,
    kind: str = "fresh",
    price_model: str = "shifted",
    mean_range: tuple[float, float] = (0.125, 0.22),
    spike_range: tuple[float, float] = (0.5, 4.0),
    spike_frac: float = 0.5,
) -> list[SpotMarket]:
    """S materialized markets over a common horizon (the reference's
    ``make_scenarios``).

    ``kind="fresh"``: same price law, seeds seed..seed+S-1.
    ``kind="regime"``: price mean swept linearly over ``mean_range`` (one
    regime per scenario, fresh seed each) — with ``price_model="truncate"``
    this is the truncated-exp regime sweep; the default "shifted" model keeps
    the paper's reading of the price law.
    ``kind="adversarial"``: lure/spike square waves
    (:func:`adversarial_scenarios`).
    ``kind="adaptive"`` needs a stream's chunk-boundary feedback and has no
    materialized form.
    """
    if n_scenarios < 1:
        raise ValueError("need at least one scenario")
    if kind == "fresh":
        return [SpotMarket(horizon_units, seed=seed + s,
                           price_model=price_model)
                for s in range(n_scenarios)]
    if kind == "regime":
        means = np.linspace(*mean_range, n_scenarios)
        return [SpotMarket(horizon_units, seed=seed + s,
                           price_mean=float(means[s]),
                           price_model=price_model)
                for s in range(n_scenarios)]
    if kind == "adversarial":
        return adversarial_scenarios(horizon_units, n_scenarios, seed=seed,
                                     spike_range=spike_range,
                                     spike_frac=spike_frac)
    if kind == "adaptive":
        raise ValueError(
            "kind='adaptive' needs chunk-boundary feedback — build a "
            "ScenarioSpec(kind='adaptive', ...) and stream it (e.g. "
            "repro.learn.replay_stream) instead of materializing a list")
    raise ValueError(f"unknown scenario kind {kind!r}")


def adversarial_scenarios(
    horizon_units: float,
    n_scenarios: int,
    seed: int = 0,
    slots_per_unit: int | None = None,
    spike_range: tuple[float, float] = (0.5, 4.0),
    spike_frac: float = 0.5,
) -> list[SpotMarket]:
    """Worst-case-regret price paths (the reference's
    ``adversarial_scenarios``).

    Scenario s is a square wave with period ``P_s`` (geometric sweep over
    ``spike_range`` time units): a cheap *lure* phase whose prices are drawn
    from the paper's law with half the usual mean (so every bid in B
    clears), then a *spike* phase of ``spike_frac * P_s`` pinned at
    ``PRICE_HI`` — above every bid, so any task whose Dealloc window
    straddles the spike exhausts its flexibility against zero availability
    and pays the on-demand backstop for the remainder. Phase offsets are
    randomized per scenario so job arrivals cannot be systematically in
    phase with the lure.
    """
    if n_scenarios < 1:
        raise ValueError("need at least one scenario")
    spu = slots_per_unit or SLOTS_PER_UNIT
    n_slots = int(np.ceil(horizon_units * spu)) + 1
    if n_scenarios == 1:
        periods = [float(np.sqrt(spike_range[0] * spike_range[1]))]
    else:
        periods = np.geomspace(*spike_range, n_scenarios)
    markets = []
    for s in range(n_scenarios):
        rng = np.random.default_rng(seed + s)
        lure = np.minimum(PRICE_LO + rng.exponential(0.5 * PRICE_MEAN,
                                                     n_slots), PRICE_HI)
        period_slots = max(int(round(periods[s] * spu)), 2)
        spike_slots = max(int(round(spike_frac * period_slots)), 1)
        phase = (np.arange(n_slots) + rng.integers(period_slots)) \
            % period_slots
        price = np.where(phase < spike_slots, PRICE_HI, lure)
        markets.append(SpotMarket.from_prices(price, slots_per_unit=spu))
    return markets
