"""Spot-market model (paper Sections 3.1 and 6.1), host numpy.

Each unit of time is divided into ``SLOTS_PER_UNIT`` equal slots; the spot
price is re-drawn per slot from a *bounded (truncated) exponential*
distribution with mean 0.13 on [0.12, 1] (Section 6.1, following [31]).
On-demand instances cost ``p_od`` (normalized to 1) per instance-unit-time and
are billed continuously — a user pays for exactly the period consumed.

A user bidding ``b`` holds spot instances during a slot iff ``price <= b``
(paper: the request succeeds only when the bid exceeds the spot price); while
holding them it pays the *spot price*. From the user's perspective the spot
service is therefore a piecewise-constant availability process ``a(t)`` with
a piecewise-constant payment rate ``price(t) * a(t)``.

The whole simulation is closed-form on top of three cumulative integrals per
bid (DESIGN.md Section 5):

    A(t) = integral of a           (cumulative available time)
    H(t) = t - A(t)                (cumulative UNavailable time)
    C(t) = integral of price * a   (cumulative spot payment per instance)

All three are monotone piecewise-linear with slopes in {0, 1} (or price), so
"first time A reaches x" / "first time H reaches x" are exact
searchsorted-plus-interpolation queries, vectorized over tasks.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = [
    "SLOTS_PER_UNIT",
    "SpotMarket",
    "BidView",
    "stacked_view_arrays",
    "truncated_exp_rate",
    "sample_truncated_exp",
]

SLOTS_PER_UNIT = 12  # paper Section 6.1

# Spot price distribution parameters (paper Section 6.1).
PRICE_MEAN = 0.13
PRICE_LO = 0.12
PRICE_HI = 1.0
P_ONDEMAND = 1.0


@functools.lru_cache(maxsize=1024)  # bounded: (mean, lo, hi) triples
def truncated_exp_rate(mean: float, lo: float, hi: float) -> float:
    """Rate lambda of an exponential truncated to [lo, hi] with given mean.

    Solved by bisection on the monotone map lambda -> truncated mean.
    """
    if not lo < mean < hi:
        raise ValueError(f"mean {mean} outside ({lo}, {hi})")
    span = hi - lo

    def trunc_mean(lam: float) -> float:
        # E[X] = lo + 1/lam - span * q / (1 - q), q = exp(-lam * span)
        q = np.exp(-lam * span)
        return lo + 1.0 / lam - span * q / (1.0 - q)

    lo_l, hi_l = 1e-9, 1e6
    for _ in range(200):
        mid = 0.5 * (lo_l + hi_l)
        if trunc_mean(mid) > mean:
            lo_l = mid  # mean too high -> need larger rate
        else:
            hi_l = mid
    return 0.5 * (lo_l + hi_l)


def sample_truncated_exp(
    rng: np.random.Generator, n: int, mean: float, lo: float, hi: float
) -> np.ndarray:
    """Exact inverse-CDF sampling of the truncated exponential."""
    lam = truncated_exp_rate(mean, lo, hi)
    u = rng.random(n)
    # F(x) on [lo, hi]: (1 - exp(-lam (x - lo))) / (1 - exp(-lam (hi - lo)))
    tail = 1.0 - np.exp(-lam * (hi - lo))
    return lo - np.log1p(-u * tail) / lam


@dataclasses.dataclass(frozen=True)
class BidView:
    """Cumulative integrals of the availability process for one bid price."""

    slot: float           # slot length in time units (1 / SLOTS_PER_UNIT)
    avail: np.ndarray     # (n_slots,) bool — instance held during slot k
    boundaries: np.ndarray  # (n_slots + 1,) slot boundary times
    A_cum: np.ndarray     # (n_slots + 1,) cumulative available time
    C_cum: np.ndarray     # (n_slots + 1,) cumulative spot payment (1 instance)

    @property
    def horizon(self) -> float:
        return float(self.boundaries[-1])

    @property
    def H_cum(self) -> np.ndarray:
        return self.boundaries - self.A_cum

    # -- point evaluations (vectorized over t) ---------------------------------
    def _locate(self, t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        t = np.clip(np.asarray(t, dtype=np.float64), 0.0, self.horizon)
        k = np.clip((t / self.slot).astype(np.int64), 0, len(self.avail) - 1)
        frac = t - self.boundaries[k]
        return k, frac

    def A(self, t: np.ndarray) -> np.ndarray:
        """Cumulative available time at t (piecewise linear, slope = avail)."""
        k, frac = self._locate(t)
        return self.A_cum[k] + self.avail[k] * frac

    def H(self, t: np.ndarray) -> np.ndarray:
        return np.asarray(t, dtype=np.float64) - self.A(t)

    def C(self, t: np.ndarray) -> np.ndarray:
        """Cumulative spot payment for one continuously-requested instance."""
        k, frac = self._locate(t)
        rate = np.where(self.avail[k], self._price[k], 0.0)
        return self.C_cum[k] + rate * frac

    # set post-init by SpotMarket (price array shared across bids)
    @property
    def _price(self) -> np.ndarray:
        return self.__dict__["price"]

    # -- inverse queries (vectorized over targets) -----------------------------
    def t_for_A(self, target: np.ndarray) -> np.ndarray:
        """Earliest t with A(t) >= target; +inf if never within horizon."""
        return _invert_monotone(self.boundaries, self.A_cum, target)

    def t_for_H(self, target: np.ndarray) -> np.ndarray:
        """Earliest t with H(t) >= target; +inf if never within horizon."""
        return _invert_monotone(self.boundaries, self.H_cum, target)


def stacked_view_arrays(prices, avail, slot: float):
    """(A_cum, C_cum) cumulative view arrays from per-slot prices + availability.

    ``prices``/``avail`` may carry leading batch axes (``(..., n_slots)`` ->
    ``(..., n_slots + 1)``). On a 1-D f64 row this is the per-bid view
    construction of ``SpotMarket.view``.
    """
    step_a = np.where(avail, slot, 0.0)
    step_c = np.where(avail, prices * slot, 0.0)
    pad = np.zeros(step_a.shape[:-1] + (1,), dtype=step_a.dtype)
    A_cum = np.concatenate([pad, np.cumsum(step_a, axis=-1)], axis=-1)
    C_cum = np.concatenate([pad, np.cumsum(step_c, axis=-1)], axis=-1)
    return A_cum, C_cum


def _invert_monotone(
    boundaries: np.ndarray, cum: np.ndarray, target: np.ndarray
) -> np.ndarray:
    """Invert a nondecreasing piecewise-linear f with slopes in {0, 1}.

    ``cum[k] = f(boundaries[k])``. Returns the earliest t with f(t) >= target
    (exactly: f(t) == target at the returned t unless target <= f(0)).
    """
    target = np.asarray(target, dtype=np.float64)
    k = np.searchsorted(cum, target, side="left")
    out = np.full(target.shape, np.inf)
    ok = k <= len(cum) - 1
    # k == 0 -> target <= f(0): crossing at t = 0.
    kz = ok & (k == 0)
    out[kz] = boundaries[0]
    ki = ok & (k > 0)
    kk = k[ki]
    # Crossing inside slot kk-1 where the slope must be 1.
    out[ki] = boundaries[kk - 1] + (target[ki] - cum[kk - 1])
    return out


class SpotMarket:
    """A realized spot-price path plus per-bid cumulative views.

    The price path is drawn once per (seed, horizon); ``view(bid)`` builds and
    caches the cumulative integrals for a bid. All downstream cost math is
    exact (no per-slot loops) given these arrays.
    """

    def __init__(
        self,
        horizon_units: float,
        seed: int = 0,
        slots_per_unit: int = SLOTS_PER_UNIT,
        price_mean: float = PRICE_MEAN,
        price_lo: float = PRICE_LO,
        price_hi: float = PRICE_HI,
        p_ondemand: float = P_ONDEMAND,
        price_model: str = "shifted",
    ) -> None:
        self.slots_per_unit = slots_per_unit
        self.slot = 1.0 / slots_per_unit
        self.n_slots = int(np.ceil(horizon_units * slots_per_unit)) + 1
        self.p_ondemand = float(p_ondemand)
        rng = np.random.default_rng(seed)
        if price_model == "shifted":
            # "Bounded exponential, mean 0.13, bounds [0.12, 1]" read as
            # price = lo + Exp(mean 0.13), clipped above at 1 — the reading
            # whose realized per-bid availabilities bracket the paper's
            # beta grid (the reference's DESIGN.md Section 4).
            self.price = np.minimum(
                price_lo + rng.exponential(price_mean, self.n_slots), price_hi
            )
        elif price_model == "clip":
            # Exponential with mean 0.13 clipped to the bounds (availability
            # 0.75-0.90 across B) — kept as an ablation.
            self.price = np.clip(
                rng.exponential(price_mean, self.n_slots), price_lo, price_hi
            )
        elif price_model == "truncate":
            self.price = sample_truncated_exp(
                rng, self.n_slots, price_mean, price_lo, price_hi
            )
        else:
            raise ValueError(f"unknown price_model {price_model!r}")
        self.boundaries = np.arange(self.n_slots + 1, dtype=np.float64) * self.slot
        self._views: dict[float, BidView] = {}

    @classmethod
    def from_prices(
        cls,
        prices: np.ndarray,
        slots_per_unit: int = SLOTS_PER_UNIT,
        p_ondemand: float = P_ONDEMAND,
    ) -> "SpotMarket":
        """Replay adapter: wrap a realized per-slot price trace.

        The engine's scenario layer uses this to evaluate policy grids
        against recorded (or adversarial) spot-price paths instead of the
        synthetic price law — all downstream cumulative-array machinery is
        identical.
        """
        prices = np.asarray(prices, dtype=np.float64)
        if prices.ndim != 1 or len(prices) == 0:
            raise ValueError("prices must be a non-empty 1-D per-slot trace")
        m = cls.__new__(cls)
        m.slots_per_unit = slots_per_unit
        m.slot = 1.0 / slots_per_unit
        m.n_slots = len(prices)
        m.p_ondemand = float(p_ondemand)
        m.price = prices.copy()
        m.boundaries = np.arange(m.n_slots + 1, dtype=np.float64) * m.slot
        m._views = {}
        return m

    @property
    def horizon(self) -> float:
        return float(self.boundaries[-1])

    def availability(self, bid: float) -> np.ndarray:
        return self.price <= bid + 1e-12

    def view(self, bid: float) -> BidView:
        key = round(float(bid), 12)
        if key not in self._views:
            avail = self.availability(bid)
            A_cum, C_cum = stacked_view_arrays(self.price, avail, self.slot)
            view = BidView(
                slot=self.slot,
                avail=avail,
                boundaries=self.boundaries,
                A_cum=A_cum,
                C_cum=C_cum,
            )
            view.__dict__["price"] = self.price
            self._views[key] = view
        return self._views[key]

    def beta_realized(self, bid: float) -> float:
        """Realized average availability for a bid — the market's true beta."""
        return float(np.mean(self.availability(bid)))
