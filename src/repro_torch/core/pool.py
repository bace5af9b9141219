"""Self-owned instance pool — N(t) and N(t1, t2) tracking (paper Section 4.2).

``N(t)`` is the number of self-owned instances idle at time t and
``N(t1, t2) = min_{t in [t1, t2]} N(t)`` is what policy (12) consumes.
Reservations are half-open intervals [t1, t2) at integer instance counts,
tracked on the market's slot grid: a reservation occupies every slot it
overlaps (conservative — a partially covered slot counts as fully used
when answering availability queries, so a feasible answer is always truly
feasible). ``available``/``reserve`` answer and commit one window;
``scheduler._allocate_pool`` fills the occupancy array in bulk and
``RangeMax`` answers range queries over it for TOLA's refinement rounds.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SelfOwnedPool", "LazySegmentTree", "RangeMax"]


class SelfOwnedPool:
    def __init__(self, total: int, horizon_units: float, slots_per_unit: int = 12):
        self.total = int(total)
        self.slot = 1.0 / slots_per_unit
        self.n_slots = int(np.ceil(horizon_units * slots_per_unit)) + 1
        self.used = np.zeros(self.n_slots, dtype=np.int64)
        # Exact continuous accounting for utilization metrics.
        self.reserved_instance_time = 0.0
        self.worked_instance_time = 0.0

    def _span(self, t1: float, t2: float) -> tuple[int, int]:
        """Slots overlapping [t1, t2) — conservative full-slot coverage."""
        k1 = max(int(np.floor(t1 / self.slot + 1e-9)), 0)
        k2 = min(int(np.ceil(t2 / self.slot - 1e-9)), self.n_slots)
        return k1, max(k2, k1 + 1)

    def available(self, t1: float, t2: float) -> int:
        """N(t1, t2): instances free throughout the window."""
        if self.total == 0:
            return 0
        k1, k2 = self._span(t1, t2)
        return int(self.total - int(self.used[k1:k2].max(initial=0)))

    def reserve(self, t1: float, t2: float, count: int, worked: float | None = None):
        """Commit ``count`` instances over [t1, t2).

        ``worked`` is the instance-time actually used for task workload
        (min(count * window, z)); defaults to the full reservation.
        """
        count = int(count)
        if count <= 0:
            return
        k1, k2 = self._span(t1, t2)
        if int(self.used[k1:k2].max(initial=0)) + count > self.total:
            raise ValueError("over-reservation of self-owned pool")
        self.used[k1:k2] += count
        span = max(t2 - t1, 0.0)
        self.reserved_instance_time += count * span
        self.worked_instance_time += count * span if worked is None else worked

    def utilization(self, horizon: float) -> float:
        """Fraction of the pool's capacity that processed real workload."""
        cap = self.total * horizon
        return self.worked_instance_time / cap if cap > 0 else 0.0


class LazySegmentTree:
    """Range-add / range-max over integer occupancy, O(log n) per operation.

    The saturated-regime workhorse of ``scheduler._allocate_pool``: when the
    pool is deeply oversubscribed (r << demand) almost every optimistic chunk
    fails and allocation degenerates into a per-task scan whose
    ``used[k1:k2].max()`` rescans are O(span) each. This tree answers the
    same query and commits the same grant in O(log n) exact integer
    arithmetic, making the contended pass O(n log n) overall.

    Iterative (bottom-up) lazy propagation over a flat 2n array of Python
    ints — exactness matters more than numpy here: grants are integers, so
    tree answers are bit-identical to the sequential occupancy scan, and the
    per-op constant (~2 log n list reads) beats boxing numpy scalars.
    """

    def __init__(self, values: np.ndarray):
        vals = [int(v) for v in values]
        n = len(vals)
        if n == 0:
            raise ValueError("empty occupancy array")
        self.n = n
        self.h = n.bit_length()
        self.t = t = [0] * n + vals
        self.d = [0] * n
        for i in range(n - 1, 0, -1):
            l, r = 2 * i, 2 * i + 1
            t[i] = t[l] if t[l] >= t[r] else t[r]

    def _apply(self, x: int, v: int) -> None:
        self.t[x] += v
        if x < self.n:
            self.d[x] += v

    def _rebuild(self, p: int) -> None:
        t, d = self.t, self.d
        while p > 1:
            p >>= 1
            l, r = t[2 * p], t[2 * p + 1]
            t[p] = (l if l >= r else r) + d[p]

    def _push(self, p: int) -> None:
        d = self.d
        for s in range(self.h, 0, -1):
            i = p >> s
            if i >= 1 and d[i] != 0:
                v = d[i]
                self._apply(2 * i, v)
                self._apply(2 * i + 1, v)
                d[i] = 0

    def add(self, lo: int, hi: int, v: int) -> None:
        """Add ``v`` on slots [lo, hi)."""
        if lo >= hi or v == 0:
            return
        l = lo + self.n
        r = hi + self.n
        ll, rr = l, r - 1
        while l < r:
            if l & 1:
                self._apply(l, v)
                l += 1
            if r & 1:
                r -= 1
                self._apply(r, v)
            l >>= 1
            r >>= 1
        self._rebuild(ll)
        self._rebuild(rr)

    def max(self, lo: int, hi: int) -> int:
        """Max over slots [lo, hi); empty ranges give 0 (idle pool)."""
        if lo >= hi:
            return 0
        l = lo + self.n
        r = hi + self.n
        self._push(l)
        self._push(r - 1)
        res = None
        t = self.t
        while l < r:
            if l & 1:
                if res is None or t[l] > res:
                    res = t[l]
                l += 1
            if r & 1:
                r -= 1
                if res is None or t[r] > res:
                    res = t[r]
            l >>= 1
            r >>= 1
        return res


class RangeMax:
    """O(1) range-max over a fixed array via a sparse table (O(n log n) build).

    Used to answer "max pool occupancy over [t1, t2]" for every task of every
    candidate policy when TOLA re-scores policies against the *realized*
    occupancy trace (pool-aware counterfactuals)."""

    def __init__(self, values: np.ndarray):
        v = np.asarray(values, dtype=np.float64)
        n = len(v)
        levels = max(int(np.floor(np.log2(max(n, 1)))) + 1, 1)
        table = [v]
        for k in range(1, levels):
            half = 1 << (k - 1)
            prev = table[-1]
            if len(prev) <= half:
                break
            table.append(np.maximum(prev[:-half], prev[half:]))
        self.table = table
        self.n = n

    def query(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Vectorized max over [lo, hi) slot indices; empty ranges give 0."""
        lo = np.clip(np.asarray(lo, dtype=np.int64), 0, self.n)
        hi = np.clip(np.asarray(hi, dtype=np.int64), 0, self.n)
        length = hi - lo
        out = np.zeros(lo.shape)
        ok = length > 0
        if not np.any(ok):
            return out
        k = np.zeros(lo.shape, dtype=np.int64)
        k[ok] = np.floor(np.log2(length[ok])).astype(np.int64)
        k = np.minimum(k, len(self.table) - 1)
        for kk in np.unique(k[ok]):
            m = ok & (k == kk)
            t = self.table[kk]
            a = np.minimum(lo[m], len(t) - 1)
            b = np.clip(hi[m] - (1 << kk), 0, len(t) - 1)
            out[m] = np.maximum(t[a], t[b])
        return out
