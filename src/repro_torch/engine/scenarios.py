"""Market scenarios of the port: declarative specs, synthesis on the card,
chunked scenario streams and the materialized lists.

A scenario is one realized spot-price path; the engine evaluates the whole
(policy x job) grid against S scenarios in one pass. Five families
(``SCENARIO_KINDS``): ``fresh`` (i.i.d. redraws of the paper's price law),
``regime`` (the law's mean swept across scenarios), ``replay`` (recorded
per-slot traces), ``adversarial`` (lure/spike square waves built to drive
TOLA's worst-case regret) and ``adaptive`` (the adversarial family with the
spike period and phase chosen by watching the learner: each chunk's
realized regret comes back through ``ScenarioStream.observe`` and the next
chunk's spikes concentrate on what hurt most).

Two representations, as in the reference:

* ``list[SpotMarket]`` — the materialized path (``make_scenarios``,
  ``adversarial_scenarios``, ``replay_scenarios``): one host object per
  scenario, exact float64, with the reference's numpy ``Generator``
  streams.
* ``ScenarioSpec`` — a hashable description of a family whose randomness
  is a stateless counter hash of (seed, scenario index, slot), so any chunk
  of scenarios can be synthesized alone: on the host in float64
  (``prices``, ``materialize``: the oracle) or on the batch's device by
  plain torch ops (``SynthBatch``: levels, float32 prices and the spike
  mask, then each bid's stacked A/C views). Availability on the device is
  the exact integer comparison ``level <= threshold``, so it selects the
  host's slots exactly.

Both are consumed through ``ScenarioSource.chunks``: ``(s0, s1, batch)``
triples whose ``ScenarioBatch`` builds each bid's stacked (S_chunk,
n_slots+1) float32 A/C tensors on the device once (keyed on
``round(bid, 12)`` like the GridPlan dedup). A spec's chunk without
adaptive periods or offsets also keeps them across calls, in
``cache.VIEW_CACHE``.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.market import (
    P_ONDEMAND,
    PRICE_HI,
    PRICE_LO,
    PRICE_MEAN,
    SLOTS_PER_UNIT,
    SpotMarket,
    stacked_view_tensors,
)
from repro_torch.engine import cache as _cache
from repro_torch.obs import METRICS, span

__all__ = ["ScenarioSpec", "ScenarioStream", "ScenarioSource",
           "ScenarioBatch", "MarketListBatch", "SynthBatch", "as_source",
           "make_scenarios", "adversarial_scenarios", "replay_scenarios",
           "check_scenarios", "stack_views", "SCENARIO_KINDS"]

SCENARIO_KINDS = ("fresh", "regime", "replay", "adversarial", "adaptive")

_M32 = 0xFFFFFFFF
_GOLD = np.uint32(0x9E3779B9)   # odd golden-ratio constants decorrelate the
_COL = np.uint32(0x85EBCA6B)    # row/column/stream counters before mixing
_MIX1 = np.uint32(0x7FEB352D)
_MIX2 = np.uint32(0x846CA68B)


# --------------------------------------------------------------------------
# Counter-based randomness: 24-bit levels from a stateless uint32 hash.
# --------------------------------------------------------------------------

def _mix(x):
    """lowbias32 finalizer, elementwise on numpy uint32 arrays (wraparound
    multiplies)."""
    x = x ^ (x >> 16)
    x = x * _MIX1
    x = x ^ (x >> 15)
    x = x * _MIX2
    x = x ^ (x >> 16)
    return x


def _mix_int(x: int) -> int:
    """Python-int twin of ``_mix`` (numpy SCALAR uint32 overflow warns)."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


def _levels(seed: int, stream: int, idx, n_cols: int) -> np.ndarray:
    """(len(idx), n_cols) uint32 levels in [0, 2^24), on the host.

    ``idx`` holds GLOBAL scenario indices, so any chunk reproduces exactly
    the rows a monolithic synthesis would produce. 24 bits because
    ``level * 2^-24`` is exact in both float32 and float64: the host and the
    device start from identical uniforms.
    """
    base = np.uint32(_mix_int((seed & _M32) ^ ((stream * 0x9E3779B9) & _M32)))
    row = _mix(np.asarray(idx).astype(np.uint32) * _GOLD ^ base)
    col = np.arange(n_cols, dtype=np.uint32) * _COL
    return _mix(row[:, None] ^ col[None, :]) >> np.uint32(8)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): c is split into 16-bit
    halves so that no product passes 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix_t(x: torch.Tensor) -> torch.Tensor:
    """``_mix`` on int64 tensors holding uint32 values (torch has no uint32
    shift or remainder on the CPU)."""
    x = x ^ (x >> 16)
    x = _mul32(x, int(_MIX1))
    x = x ^ (x >> 15)
    x = _mul32(x, int(_MIX2))
    x = x ^ (x >> 16)
    return x


def _levels_t(seed: int, stream: int, idx: torch.Tensor,
              n_cols: int) -> torch.Tensor:
    """``_levels`` as int64 torch tensors on ``idx``'s device, bit for bit
    the host's values."""
    base = _mix_int((seed & _M32) ^ ((stream * 0x9E3779B9) & _M32))
    row = _mix_t(_mul32(idx.to(torch.int64) & _M32, int(_GOLD)) ^ base)
    col = _mul32(torch.arange(n_cols, dtype=torch.int64, device=idx.device),
                 int(_COL))
    return _mix_t(row[:, None] ^ col[None, :]) >> 8


def _exp_prices(u, mean, lo, hi):
    """Inverse-CDF shifted-exponential price law, clipped at the ceiling."""
    return np.minimum(lo + mean * (-np.log1p(-u)), hi)


def _exp_prices_t(u: torch.Tensor, mean, lo: float, hi: float):
    """``_exp_prices`` in ``u``'s dtype on its device."""
    return torch.clamp_max(lo + mean * (-torch.log1p(-u)), hi)


@functools.lru_cache(maxsize=4096)  # bounded: distinct bid levels
def _avail_threshold(mean: float, lo: float, hi: float, bid: float) -> int:
    """Largest 24-bit level whose f64 price clears ``bid``.

    Replicates ``price <= bid + 1e-12`` (the SpotMarket availability rule)
    EXACTLY: the analytic inverse-CDF estimate is corrected by walking the
    actual f64 price formula across the boundary, so the device path's
    integer comparison ``level <= threshold`` selects precisely the slots
    the host f64 comparison would — no f32 knife edge can flip a slot.
    """
    b = float(bid) + 1e-12

    def price(h: int) -> float:
        return min(lo + mean * (-np.log1p(-(h * 2.0 ** -24))), hi)

    top = (1 << 24) - 1
    if price(0) > b:
        return -1
    if price(top) <= b:
        return top
    t = int((1.0 - np.exp(-(b - lo) / mean)) * 2.0 ** 24)
    t = max(0, min(t, top - 1))
    while t + 1 <= top and price(t + 1) <= b:
        t += 1
    while t >= 0 and price(t) > b:
        t -= 1
    return t


# --------------------------------------------------------------------------
# ScenarioSpec — the declarative family description.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Declarative, hashable description of a scenario family.

    A spec fully determines every price path of the family (see the module
    docstring for the counter-hash randomness), so it can synthesize any
    chunk of its scenarios on demand — host f64 (``prices`` /
    ``materialize``, the bit-exact oracle) or on a device (``SynthBatch``).
    ``traces`` is only used by ``kind="replay"`` (one tuple per scenario,
    right-padded to the longest — see :func:`replay_scenarios` for the
    padding contract).
    """

    kind: str
    horizon_units: float
    n_scenarios: int
    seed: int = 0
    slots_per_unit: int = SLOTS_PER_UNIT
    p_ondemand: float = P_ONDEMAND
    price_mean: float = PRICE_MEAN
    price_lo: float = PRICE_LO
    price_hi: float = PRICE_HI
    mean_range: tuple = (0.125, 0.22)
    spike_range: tuple = (0.5, 4.0)
    spike_frac: float = 0.5
    n_periods: int = 8              # adaptive: size of the spike-period menu
    n_phases: int = 6               # adaptive: candidate phase offsets
    traces: tuple = ()

    def __post_init__(self):
        if self.kind not in SCENARIO_KINDS:
            raise ValueError(f"unknown scenario kind {self.kind!r}; pick "
                             f"from {SCENARIO_KINDS}")
        if self.n_scenarios < 1:
            raise ValueError("need at least one scenario "
                             f"(n_scenarios={self.n_scenarios})")
        if self.kind == "replay":
            if not self.traces:
                raise ValueError("kind='replay' needs at least one trace")
            object.__setattr__(self, "traces", tuple(
                tuple(float(x) for x in t) for t in self.traces))
            if len(self.traces) != self.n_scenarios:
                raise ValueError(
                    f"replay spec carries {len(self.traces)} traces for "
                    f"{self.n_scenarios} scenarios")
        elif self.traces:
            raise ValueError(f"traces are only valid with kind='replay' "
                             f"(got kind={self.kind!r})")
        object.__setattr__(self, "mean_range", tuple(self.mean_range))
        object.__setattr__(self, "spike_range", tuple(self.spike_range))

    @classmethod
    def from_traces(cls, traces, slots_per_unit: int = SLOTS_PER_UNIT,
                    p_ondemand: float = P_ONDEMAND) -> "ScenarioSpec":
        traces = tuple(tuple(float(x) for x in t) for t in traces)
        if not traces:
            raise ValueError("need at least one trace")
        n = max(len(t) for t in traces)
        return cls(kind="replay", horizon_units=n / slots_per_unit,
                   n_scenarios=len(traces), slots_per_unit=slots_per_unit,
                   p_ondemand=p_ondemand, traces=traces)

    # -- slot-grid geometry (shared with SpotMarket) -----------------------
    @property
    def slot(self) -> float:
        return 1.0 / self.slots_per_unit

    @property
    def n_slots(self) -> int:
        if self.kind == "replay":
            return max(len(t) for t in self.traces)
        return int(np.ceil(self.horizon_units * self.slots_per_unit)) + 1

    @property
    def generative(self) -> bool:
        """Whether price paths come from the counter hash (device-synthesizable)."""
        return self.kind != "replay"

    # -- family parameters over GLOBAL scenario indices --------------------
    def regime_means(self) -> np.ndarray:
        """(S,) price-law mean per scenario of the regime sweep."""
        return np.linspace(*self.mean_range, self.n_scenarios)

    def period_menu(self) -> np.ndarray:
        """Adaptive spike-period menu (time units, geometric over the range)."""
        return np.geomspace(*self.spike_range, self.n_periods)

    def default_periods(self, idx: np.ndarray) -> np.ndarray:
        """Feedback-free spike periods (time units) for global indices.

        ``adversarial`` sweeps the range geometrically across the WHOLE
        batch (mirroring :func:`adversarial_scenarios`); ``adaptive`` with
        no feedback yet cycles its period menu round-robin.
        """
        if self.kind == "adaptive":
            return self.period_menu()[np.asarray(idx) % self.n_periods]
        if self.n_scenarios == 1:
            sweep = np.array([np.sqrt(self.spike_range[0]
                                      * self.spike_range[1])])
        else:
            sweep = np.geomspace(*self.spike_range, self.n_scenarios)
        return sweep[np.asarray(idx)]

    def wave_slots(self, periods: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(period_slots, spike_slots) int arrays from periods in time units."""
        pslots = np.maximum(np.round(np.asarray(periods, np.float64)
                                     * self.slots_per_unit), 2).astype(np.int64)
        sslots = np.maximum(np.round(self.spike_frac * pslots), 1) \
            .astype(np.int64)
        return pslots, sslots

    # -- host synthesis (f64 oracle) ---------------------------------------
    def prices(self, start: int = 0, stop: int | None = None,
               periods: np.ndarray | None = None,
               offsets: np.ndarray | None = None) -> np.ndarray:
        """(stop-start, n_slots) f64 per-slot prices for global scenarios
        ``start..stop-1`` — the bit-exact oracle every other path is tested
        against. ``periods`` overrides the spike periods (time units) of the
        adversarial/adaptive wave for these rows, and ``offsets`` the phase
        offsets in slots (entries < 0 keep the hash-random phase) — the
        ScenarioStream's feedback hooks; other kinds ignore both.
        """
        stop = self.n_scenarios if stop is None else stop
        if not 0 <= start < stop <= self.n_scenarios:
            raise ValueError(f"bad scenario slice [{start}, {stop}) of "
                             f"{self.n_scenarios}")
        idx = np.arange(start, stop)
        n = self.n_slots
        if self.kind == "replay":
            # Padded once per spec (cached): chunked streaming must not
            # re-pad the whole trace set per chunk (O(S^2)) or re-fire the
            # padding warning.
            return _padded_spec_traces(self)[start:stop]
        h = _levels(self.seed, 0, idx, n)
        u = h * 2.0 ** -24
        if self.kind == "fresh":
            return _exp_prices(u, self.price_mean, self.price_lo,
                               self.price_hi)
        if self.kind == "regime":
            means = self.regime_means()[idx][:, None]
            return _exp_prices(u, means, self.price_lo, self.price_hi)
        # adversarial / adaptive: lure from a halved-mean law + spike wave.
        lure = _exp_prices(u, 0.5 * self.price_mean, self.price_lo,
                           self.price_hi)
        return np.where(self.spike_mask(start, stop, periods, offsets),
                        self.price_hi, lure)

    def spike_mask(self, start: int = 0, stop: int | None = None,
                   periods: np.ndarray | None = None,
                   offsets: np.ndarray | None = None) -> np.ndarray:
        """(stop-start, n_slots) bool spike phases of the adversarial
        families' square wave (``prices``' override arguments); the lure
        itself may reach ``price_hi``, so a price alone does not tell."""
        stop = self.n_scenarios if stop is None else stop
        idx = np.arange(start, stop)
        if periods is None:
            periods = self.default_periods(idx)
        pslots, sslots = self.wave_slots(periods)
        rand = (_levels(self.seed, 1, idx, 1)[:, 0].astype(np.int64)
                % pslots)
        if offsets is None:
            offs = rand
        else:
            offsets = np.asarray(offsets, np.int64)
            offs = np.where(offsets >= 0, offsets % pslots, rand)
        phase = (np.arange(self.n_slots)[None, :] + offs[:, None]) \
            % pslots[:, None]
        return phase < sslots[:, None]

    def materialize(self, start: int = 0,
                    stop: int | None = None) -> list[SpotMarket]:
        """The spec's scenarios as concrete ``SpotMarket`` objects (the
        ``from_prices`` path) — the host oracle the streamed and device paths
        are held against, and the adapter for host-only consumers (the
        Greedy baseline, the realized shared-pool replay)."""
        return [SpotMarket.from_prices(row, slots_per_unit=self.slots_per_unit,
                                       p_ondemand=self.p_ondemand)
                for row in self.prices(start, stop)]

    def lure_mean(self) -> float:
        return 0.5 * self.price_mean

    def thresholds(self, bid: float, idx: np.ndarray) -> np.ndarray:
        """(len(idx),) int32 availability thresholds for one bid.

        The exact-integer edition of ``price <= bid + 1e-12`` per scenario
        (regime sweeps get a per-row mean; the spike phases of the
        adversarial families are excluded separately by the wave mask).
        """
        if self.kind == "regime":
            means = self.regime_means()[np.asarray(idx)]
            return np.array([_avail_threshold(float(m), self.price_lo,
                                              self.price_hi, float(bid))
                             for m in means], np.int32)
        mean = self.lure_mean() if self.kind in ("adversarial", "adaptive") \
            else self.price_mean
        t = _avail_threshold(float(mean), self.price_lo, self.price_hi,
                             float(bid))
        return np.full(len(idx), t, np.int32)


# --------------------------------------------------------------------------
# Device synthesis: spec -> (levels, prices, spike mask) -> per-bid views,
# plain torch ops on the batch's device.
# --------------------------------------------------------------------------

def _device_synth(spec: ScenarioSpec, idx: torch.Tensor, pslots: torch.Tensor,
                  sslots: torch.Tensor, offsets: torch.Tensor):
    """Global indices (+ wave parameters, int64) -> chunk tensors on their
    device: ``(levels int32 (K, n), prices f32 (K, n), spike bool (K, n))``.

    Levels are bit for bit the host hash's; prices are the float32
    evaluation of the same transform (availability never reads them, see
    ``_device_views``). ``pslots``/``sslots``/``offsets`` are read by the
    adversarial families only.
    """
    n = spec.n_slots
    lo, hi = spec.price_lo, spec.price_hi
    h = _levels_t(spec.seed, 0, idx, n)
    u = h.to(torch.float32) * 2.0 ** -24
    if spec.kind == "fresh":
        price = _exp_prices_t(u, spec.price_mean, lo, hi)
        spike = torch.zeros(price.shape, dtype=torch.bool, device=idx.device)
    elif spec.kind == "regime":
        a, b = spec.mean_range
        f32 = functools.partial(torch.tensor, dtype=torch.float32,
                                device=idx.device)
        # Divided by a tensor: CUDA turns division by a Python scalar into
        # a multiply by its rounded reciprocal.
        frac = idx.to(torch.float32) / f32(float(max(spec.n_scenarios - 1,
                                                      1)))
        means = (f32(a) + f32(b - a) * frac)[:, None]
        price = _exp_prices_t(u, means, lo, hi)
        spike = torch.zeros(price.shape, dtype=torch.bool, device=idx.device)
    else:                                               # adversarial*
        lure = _exp_prices_t(u, spec.lure_mean(), lo, hi)
        rand = _levels_t(spec.seed, 1, idx, 1)[:, 0] % pslots
        offs = torch.where(offsets >= 0, offsets % pslots, rand)
        phase = (torch.arange(n, dtype=torch.int64, device=idx.device)[None, :]
                 + offs[:, None]) % pslots[:, None]
        spike = phase < sslots[:, None]
        price = torch.where(spike, torch.full((), hi, dtype=torch.float32,
                                              device=idx.device), lure)
    return h.to(torch.int32), price, spike


def _device_views(h: torch.Tensor, price: torch.Tensor, spike: torch.Tensor,
                  thresh: torch.Tensor, spike_clears: bool, slot: float):
    """(levels, prices, spike, thresholds) -> stacked float32 (A, C) views.

    Availability is the EXACT integer comparison ``level <= threshold`` —
    the slot set the f64 oracle selects (``_avail_threshold``). A is the
    exact available-slot count times the slot, one float32 rounding (the
    array the cost kernels' searches are knife-edge sensitive to); C comes
    from ``stacked_view_tensors``, a float64 running sum rounded once.
    """
    avail = h <= thresh[:, None]
    if not spike_clears:
        avail = avail & ~spike
    counts = torch.cumsum(avail, -1, dtype=torch.int32)
    pad = torch.zeros(h.shape[:-1] + (1,), dtype=torch.float32,
                      device=h.device)
    A = torch.cat([pad, counts.to(torch.float32) * slot], -1)
    _, C = stacked_view_tensors(price, avail, slot)
    return A, C


# --------------------------------------------------------------------------
# Batches — what the backend consumes (stacked views, built once per bid).
# --------------------------------------------------------------------------

def _bid_key(bid: float) -> float:
    # Same rounding rule as the GridPlan dedup (plan.py::_bid_key).
    return round(float(bid), 12)


def stack_views(markets: Sequence[SpotMarket], bid: float):
    """(S, n_slots+1) stacked float64 A/C cumulative arrays for one bid
    (one ``view`` call per market)."""
    views = [m.view(bid) for m in markets]
    return (np.stack([v.A_cum for v in views]),
            np.stack([v.C_cum for v in views]))


def _upload(arrays, device) -> tuple:
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in arrays)


_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    """The stream chunk synthesis is enqueued on, one per card."""
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device=key)
    return _SIDE_STREAMS[key]


class ScenarioBatch:
    """One chunk of scenarios presented as stacked per-bid view tensors on
    a device.

    ``stacked(bid)`` returns the (S_chunk, n_slots+1) float32 A/C
    cumulative tensors, built once per bid (keyed on ``round(bid, 12)``);
    ``markets`` adapts the chunk to host-only consumers.

    With a ``GridMesh`` the chunk is padded to ``n_rows`` (a multiple of
    ``data_shards``; the last scenario repeated) and ``stacked`` holds
    only this rank's slab of those rows (``mesh.slab``): the rank builds
    no view of another rank's scenarios. Meshed batches bypass the view
    cache (DESIGN.md §9 padding contract).
    """

    slot: float
    slots_per_unit: int
    p_ondemand: float
    n_slots: int
    n_scenarios: int

    def __init__(self, device, mesh=None):
        self.device = torch.device(device)
        self.mesh = mesh
        self._stacked: dict[float, tuple] = {}

    @property
    def n_rows(self) -> int:
        """Row count of the chunk after mesh padding."""
        if self.mesh is None:
            return self.n_scenarios
        return self.mesh.pad(self.n_scenarios)

    def _local(self, items):
        """``items`` (one per chunk scenario, an array or a list) restricted
        to this rank's padded rows; all of them without a mesh."""
        if self.mesh is None:
            return items
        pos = self.mesh.slab(self.n_scenarios)
        if isinstance(items, np.ndarray):
            return items[pos]
        return [items[i] for i in pos]

    def dispatch(self) -> "ScenarioBatch":
        """Enqueue (but do not await) the chunk's synthesis — the
        double-buffering hook: a no-op wherever synthesis is host work."""
        return self

    def prepare(self) -> "ScenarioBatch":
        """Synthesize/realize the chunk's price paths (timed by the API)."""
        return self

    def build_views(self, bids) -> list[float]:
        """Build (or fetch from the view cache) the chunk's views at every
        bid, one ``views`` span per bid; returns the spans' seconds in bid
        order (the engine's per-chunk "views" phase)."""
        seconds = []
        for bid in bids:
            with span("views", bid=bid, scenarios=self.n_scenarios) as sp:
                self.stacked(bid)
            seconds.append(sp.seconds)
        return seconds

    def stacked(self, bid: float):
        """(A, C) float32 tensors of shape (S_chunk, n_slots+1) on the
        device (this rank's slab of ``n_rows`` under a mesh)."""
        key = _bid_key(bid)
        if key not in self._stacked:
            # Cross-call reuse: batches whose views are a pure function of
            # (spec, chunk range, device, bid) publish a cache key and
            # survive the batch; the others keep the per-batch memo only.
            ck = self._view_key(bid) if _cache.enabled() else None
            views = _cache.VIEW_CACHE.get(ck) if ck is not None else None
            if views is None:
                views = self._build_views(bid)
                if ck is not None:
                    _cache.VIEW_CACHE.put(ck, views)
            self._stacked[key] = views
        return self._stacked[key]

    def _view_key(self, bid: float):
        """Cross-call identity of this chunk's per-bid views, or None when
        they have none (materialized market lists would need a content
        hash per call; feedback-driven synthesis depends on state outside
        any key)."""
        return None

    def _build_views(self, bid: float):
        raise NotImplementedError

    @property
    def markets(self) -> list[SpotMarket]:
        raise NotImplementedError


class MarketListBatch(ScenarioBatch):
    """Materialized scenarios: a list of ``SpotMarket`` objects whose
    float64 host views go to the device as float32."""

    def __init__(self, markets: Sequence[SpotMarket], device, *,
                 checked: bool = False, mesh=None):
        super().__init__(device, mesh)
        self._markets = list(markets)
        if not checked:
            check_scenarios(self._markets)
        m0 = self._markets[0]
        self.slot = m0.slot
        self.slots_per_unit = m0.slots_per_unit
        self.p_ondemand = m0.p_ondemand
        self.n_slots = m0.n_slots
        self.n_scenarios = len(self._markets)

    @property
    def markets(self) -> list[SpotMarket]:
        return self._markets

    def _build_views(self, bid: float):
        # Under a mesh: the host views of this rank's (padded) rows only.
        return _upload(stack_views(self._local(self._markets), bid),
                       self.device)


class SynthBatch(ScenarioBatch):
    """A chunk of a ``ScenarioSpec``, synthesized on demand.

    By default the chunk is synthesized on ``device`` by torch ops
    (``_device_synth``, then ``_device_views`` per bid): no per-scenario
    Python objects. ``host=True`` takes the float64 oracle rows instead
    (``markets`` wraps them in ``SpotMarket.from_prices``) and uploads
    their views as float32 — the replay family's only path.

    On a CUDA device ``dispatch`` enqueues the synthesis on a side stream
    and records an event; ``prepare`` waits for it on the host (the
    residual wait the API times) and makes the current stream wait on it.

    Under a mesh only this rank's slab is synthesized, from the global
    indices of its rows (the counter hash makes each row the one the
    whole chunk would give; padding rows repeat the last real scenario,
    with its wave parameters).
    """

    def __init__(self, spec: ScenarioSpec, start: int, stop: int, device,
                 periods: np.ndarray | None = None,
                 offsets: np.ndarray | None = None, host: bool = False,
                 mesh=None):
        super().__init__(device, mesh)
        if not host and not spec.generative:
            raise ValueError("replay traces are host data; device synthesis "
                             "supports the generative families only")
        self.spec = spec
        self.start, self.stop = start, stop
        self.host = host
        self.slot = spec.slot
        self.slots_per_unit = spec.slots_per_unit
        self.p_ondemand = spec.p_ondemand
        self.n_slots = spec.n_slots
        self.n_scenarios = stop - start
        self._idx = np.arange(start, stop)
        self._periods = periods
        self._offsets = offsets
        self._parts = None
        self._event = None
        self._markets: list[SpotMarket] | None = None

    def _wave(self):
        """(pslots, sslots, offsets) int64 rows of the synthesized rows'
        square wave (placeholders for the families without one)."""
        idx = self._local(self._idx)
        n = len(idx)
        if self.spec.kind in ("adversarial", "adaptive"):
            periods = self._local(self._periods) \
                if self._periods is not None \
                else self.spec.default_periods(idx)
            pslots, sslots = self.spec.wave_slots(periods)
        else:
            pslots = np.full(n, 2, np.int64)
            sslots = np.ones(n, np.int64)
        offsets = np.full(n, -1, np.int64) if self._offsets is None \
            else self._local(np.asarray(self._offsets, np.int64))
        return pslots, sslots, offsets

    def _synth(self):
        args = [torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.device) for a in (self._local(self._idx), *self._wave())]
        return _device_synth(self.spec, *args)

    def dispatch(self) -> "SynthBatch":
        if self.host or self._parts is not None:
            return self
        with span("synth.dispatch", s0=self.start, s1=self.stop,
                  kind=self.spec.kind):
            if self.device.type != "cuda":
                self._parts = self._synth()
                return self
            side = _side_stream(self.device)
            with torch.cuda.stream(side):
                self._parts = self._synth()
                self._event = torch.cuda.Event()
                self._event.record(side)
        return self

    def prepare(self) -> "SynthBatch":
        if self.host:
            self.markets  # noqa: B018 — realize the oracle rows (timed)
            return self
        if self._parts is None:
            self.dispatch()
        if self._event is not None:
            # Under overlap the dispatch ran during the previous chunk's
            # eval, so this span measures only the residual wait.
            with span("synth.wait", s0=self.start, s1=self.stop):
                self._event.synchronize()
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(self._event)
            # Made on the side stream, read on this one: the allocator must
            # not hand the memory back to the side stream before then.
            for t in self._parts:
                t.record_stream(cur)
            self._event = None
        return self

    @property
    def markets(self) -> list[SpotMarket]:
        # Oracle rows wrapped in from_prices — bit-exact with the spec's
        # materialized path by construction (same f64 price arrays).
        if self._markets is None:
            self._markets = [
                SpotMarket.from_prices(row,
                                       slots_per_unit=self.slots_per_unit,
                                       p_ondemand=self.p_ondemand)
                for row in self.spec.prices(self.start, self.stop,
                                            periods=self._periods,
                                            offsets=self._offsets)]
        return self._markets

    def _view_key(self, bid: float):
        if self.mesh is not None or self._periods is not None \
                or self._offsets is not None:
            # Explicit periods/offsets mean an adaptive adversary planned
            # this chunk from feedback: no cross-call identity. Meshed
            # views are one rank's slab of one partition.
            return None
        # host=True views are the float64 oracle's rows uploaded as
        # float32: other bits than the device synthesis's.
        return (self.spec, self.start, self.stop,
                _cache.device_key(self.device), self.host, _bid_key(bid))

    def _build_views(self, bid: float):
        if self.host:
            return _upload(stack_views(self._local(self.markets), bid),
                           self.device)
        self.prepare()
        h, price, spike = self._parts
        thresh = torch.from_numpy(self.spec.thresholds(
            bid, self._local(self._idx))).to(self.device)
        return _device_views(h, price, spike, thresh,
                             self.spec.price_hi <= bid + 1e-12, self.slot)


# --------------------------------------------------------------------------
# Sources — the chunk streams the engine iterates.
# --------------------------------------------------------------------------

class ScenarioSource:
    """Common protocol: slot-grid metadata + ``chunks(K, device)``."""

    n_scenarios: int
    slots_per_unit: int
    p_ondemand: float
    n_slots: int

    @property
    def slot(self) -> float:
        return 1.0 / self.slots_per_unit

    @property
    def reactive(self) -> bool:
        """True when chunk k+1's CONTENT depends on feedback about chunk k
        (the adaptive adversary) — such a stream cannot be prefetched, so
        the engine's double-buffering is disabled for it."""
        return False

    def chunks(self, chunk: int, device, mesh=None):
        """Yield ``(s0, s1, batch)`` per chunk of ``chunk`` scenarios, the
        batches on ``device`` and, with a ``GridMesh``, each holding this
        rank's slab."""
        raise NotImplementedError

    def observe(self, values: np.ndarray) -> None:
        """Adaptive feedback hook — a no-op for every other source."""

    @property
    def markets(self) -> list[SpotMarket]:
        raise NotImplementedError


class _ListSource(ScenarioSource):
    """Materialized markets, chunked by slicing. The whole-list batch is
    kept per device, so repeated full-batch evaluations over one source
    (policy sweeps) reuse its stacked per-bid views."""

    def __init__(self, markets: Sequence[SpotMarket]):
        self._markets = list(markets)
        check_scenarios(self._markets)
        m0 = self._markets[0]
        self.n_scenarios = len(self._markets)
        self.slots_per_unit = m0.slots_per_unit
        self.p_ondemand = m0.p_ondemand
        self.n_slots = m0.n_slots
        self._whole: dict[str, MarketListBatch] = {}

    @property
    def markets(self) -> list[SpotMarket]:
        return self._markets

    def chunks(self, chunk: int, device, mesh=None):
        S = self.n_scenarios
        if chunk >= S and mesh is None:
            key = str(torch.device(device))
            if key not in self._whole:
                self._whole[key] = MarketListBatch(self._markets, device,
                                                   checked=True)
            yield 0, S, self._whole[key]
            return
        # A meshed batch is always fresh: the kept whole-list batch holds
        # unsharded views, and one memo must not mix the two layouts.
        for s0 in range(0, S, chunk):
            s1 = min(s0 + chunk, S)
            yield s0, s1, MarketListBatch(self._markets[s0:s1], device,
                                          checked=True, mesh=mesh)


class ScenarioStream(ScenarioSource):
    """Chunk stream over a ``ScenarioSpec`` — stateful only for ``adaptive``.

    The adaptive adversary watches the learner through
    ``observe(regret_per_scenario)`` at every chunk boundary and escalates
    in three stages:

    1. **period sweep** — the spec's geometric period menu round-robin
       (random phases), until every period has been observed at least once;
    2. **phase sweep** — all spikes at the period with the highest mean
       observed regret, cycling ``n_phases`` evenly spaced phase offsets —
       the lever no FIXED square-wave family has (their phases are
       randomized);
    3. **locked** — every remaining scenario plays the (period, phase)
       cell with the highest mean observed regret, still accumulating
       statistics.

    The round trip happens strictly at chunk boundaries, so every chunk is
    a pure function of (spec, indices, periods, offsets); the issued
    periods and offsets are kept as an audit trail.
    """

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.n_scenarios = spec.n_scenarios
        self.slots_per_unit = spec.slots_per_unit
        self.p_ondemand = spec.p_ondemand
        self.n_slots = spec.n_slots
        self._menu = spec.period_menu() if spec.kind == "adaptive" else None
        self._p_harm = np.zeros(spec.n_periods)
        self._p_count = np.zeros(spec.n_periods, np.int64)
        self._f_harm = np.zeros(spec.n_phases)
        self._f_count = np.zeros(spec.n_phases, np.int64)
        self._locked_period: int | None = None
        self._pending: tuple[str, np.ndarray] | None = None
        self._last_stage: str | None = None
        self.chunk_periods: list[np.ndarray] = []  # audit trail (time units)
        self.chunk_offsets: list[np.ndarray] = []  # audit trail (slots)
        self._materialized: list[SpotMarket] | None = None

    @property
    def markets(self) -> list[SpotMarket]:
        """Full materialization with DEFAULT (feedback-free) periods —
        host-only consumers; the streamed chunks are the real path."""
        if self._materialized is None:
            self._materialized = self.spec.materialize()
        return self._materialized

    @property
    def stage(self) -> str:
        if self.spec.kind != "adaptive":
            return "stateless"
        if np.any(self._p_count == 0):
            return "periods"
        if np.any(self._f_count == 0):
            return "phases"
        return "locked"

    def _phase_candidates(self, period_idx: int) -> np.ndarray:
        pslots = int(self.spec.wave_slots(self._menu[[period_idx]])[0][0])
        return (np.arange(self.spec.n_phases) * pslots
                // self.spec.n_phases).astype(np.int64)

    def _best_period(self) -> int:
        mean = np.where(self._p_count > 0,
                        self._p_harm / np.maximum(self._p_count, 1), -np.inf)
        return int(np.argmax(mean))

    def _plan_chunk(self, idx: np.ndarray):
        if self.spec.kind != "adaptive":
            return None, None
        stage = self.stage
        if METRICS.enabled:
            METRICS.counter("scenarios.adaptive_chunks").inc(stage=stage)
            if self._last_stage is not None and stage != self._last_stage:
                METRICS.counter("scenarios.adaptive_escalations").inc(
                    to=stage)
        self._last_stage = stage
        if stage == "periods":
            menu_idx = idx % self.spec.n_periods
            periods = self._menu[menu_idx]
            offsets = np.full(len(idx), -1, np.int64)   # hash-random phases
            self._pending = ("periods", menu_idx)
        else:
            p = self._best_period()
            if self._locked_period != p:
                # (Re)target the phase stats at the current worst period —
                # offsets are period-relative, stale stats would lie.
                self._locked_period = p
                self._f_harm[:] = 0.0
                self._f_count[:] = 0
            cand = self._phase_candidates(p)
            if np.any(self._f_count == 0):              # phase sweep
                phase_idx = idx % self.spec.n_phases
            else:                                       # locked
                mean = np.where(self._f_count > 0, self._f_harm
                                / np.maximum(self._f_count, 1), -np.inf)
                phase_idx = np.full(len(idx), int(np.argmax(mean)))
            periods = self._menu[np.full(len(idx), p)]
            offsets = cand[phase_idx]
            self._pending = ("phases", phase_idx)
        self.chunk_periods.append(periods)
        self.chunk_offsets.append(offsets)
        return periods, offsets

    def observe(self, values: np.ndarray) -> None:
        """Feed back per-scenario learner regret for the LAST issued chunk."""
        if self.spec.kind != "adaptive" or self._pending is None:
            return
        kind, cells = self._pending
        values = np.asarray(values, np.float64)
        if len(values) != len(cells):
            raise ValueError(
                f"observe got {len(values)} values for a chunk of "
                f"{len(cells)} scenarios")
        if kind == "periods":
            np.add.at(self._p_harm, cells, values)
            np.add.at(self._p_count, cells, 1)
        else:
            np.add.at(self._f_harm, cells, values)
            np.add.at(self._f_count, cells, 1)
            # Phase-stage scenarios also refine the period estimate.
            self._p_harm[self._locked_period] += values.sum()
            self._p_count[self._locked_period] += len(values)
        self._pending = None

    @property
    def reactive(self) -> bool:
        return self.spec.kind == "adaptive"

    def chunks(self, chunk: int, device, mesh=None):
        S = self.n_scenarios
        for s0 in range(0, S, chunk):
            s1 = min(s0 + chunk, S)
            periods, offsets = self._plan_chunk(np.arange(s0, s1))
            yield s0, s1, SynthBatch(self.spec, s0, s1, device,
                                     periods=periods, offsets=offsets,
                                     host=not self.spec.generative,
                                     mesh=mesh)


def as_source(scenarios) -> ScenarioSource:
    """Normalize any accepted scenario argument into a ``ScenarioSource``.

    Accepts a ``ScenarioSource`` (passed through — this is how a stateful
    adaptive stream survives across engine calls), a ``ScenarioSpec``, a
    single ``SpotMarket``, or a sequence of them.
    """
    if isinstance(scenarios, ScenarioSource):
        return scenarios
    if isinstance(scenarios, ScenarioSpec):
        return ScenarioStream(scenarios)
    if isinstance(scenarios, SpotMarket):
        return _ListSource([scenarios])
    return _ListSource(list(scenarios))


def check_scenarios(markets: Sequence[SpotMarket]) -> None:
    """Scenarios of one batch must share the slot grid and horizon."""
    if len(markets) == 0:
        raise ValueError(
            "scenario batch is empty: 'markets' needs at least one "
            "SpotMarket (or pass a ScenarioSpec)")
    m0 = markets[0]
    for m in markets[1:]:
        if m.n_slots != m0.n_slots or m.slots_per_unit != m0.slots_per_unit:
            raise ValueError(
                "scenario markets must share slot grid and horizon "
                f"(got n_slots {m.n_slots} vs {m0.n_slots})")
        if abs(m.p_ondemand - m0.p_ondemand) > 1e-12:
            raise ValueError("scenario markets must share p_ondemand")


# --------------------------------------------------------------------------
# Materialized-list constructors.
# --------------------------------------------------------------------------

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
            "repro_torch.learn.replay_stream) instead of materializing a "
            "list")
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


@functools.lru_cache(maxsize=8)   # bounded — replay specs can carry big traces
def _padded_spec_traces(spec: ScenarioSpec) -> np.ndarray:
    """(S, n_slots) padded trace rows of a replay spec, built once."""
    return _pad_traces(list(spec.traces), spec.n_slots,
                       max(spec.price_hi, spec.p_ondemand))


def _pad_traces(traces: list, n: int, pad_price: float) -> np.ndarray:
    """(len(traces), n) f64 rows, right-padded; warns naming the padding."""
    out = np.empty((len(traces), n))
    short = 0
    padded_slots = 0
    for i, t in enumerate(traces):
        t = np.asarray(t, dtype=np.float64)
        if len(t) < n:
            short += 1
            padded_slots += n - len(t)
            t = np.concatenate([t, np.full(n - len(t), pad_price)])
        out[i] = t
    if short:
        warnings.warn(
            f"replay traces right-padded to the longest ({n} slots): "
            f"{short} trace(s) padded with {padded_slots} total slots at "
            f"price {pad_price} (spot never clears there — padded tail "
            f"work pays the on-demand backstop)", stacklevel=3)
    return out


def replay_scenarios(
    traces: Sequence[np.ndarray],
    slots_per_unit: int = 12,
    p_ondemand: float = 1.0,
) -> list[SpotMarket]:
    """Replay-trace adapter: one scenario per recorded per-slot price trace.

    Padding contract: all scenarios of a batch must share one slot grid, so
    traces shorter than the longest are right-padded with
    ``max(PRICE_HI, p_ondemand)`` — a price above every bid, i.e. spot is
    never available in the padded tail and any work scheduled there pays
    the on-demand backstop. A ``UserWarning`` names how many traces/slots
    were padded; pre-trim or pre-extend traces to silence it.
    """
    if not traces:
        raise ValueError("need at least one trace")
    n = max(len(t) for t in traces)
    padded = _pad_traces(list(traces), n, max(PRICE_HI, p_ondemand))
    return [SpotMarket.from_prices(row, slots_per_unit=slots_per_unit,
                                   p_ondemand=p_ondemand)
            for row in padded]
