"""Slot-stepping event oracle — an independent re-derivation of simulate.py.

Walks the market slot by slot, maintaining the remaining workload and testing
the flexibility condition (Definition 3.1) directly, with within-slot events
(task completion, turning point) solved by local linear algebra. Used only in
tests (hypothesis property: matches the closed-form simulator to 1e-9) and as
the execution engine for the *Greedy* baseline whose global state does not
decompose per task.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.market import SpotMarket

__all__ = ["oracle_task", "oracle_greedy_chain"]

_EPS = 1e-12


def oracle_task(
    market: SpotMarket,
    bid: float,
    start: float,
    end: float,
    z_t: float,
    d_eff: float,
) -> dict:
    """Sequentially simulate one task per Definition 3.2. Returns cost dict."""
    avail = market.availability(bid)
    price = market.price
    slot = market.slot
    p_od = market.p_ondemand

    rem = max(float(z_t), 0.0)
    out = {
        "spot_cost": 0.0,
        "ondemand_cost": 0.0,
        "spot_work": 0.0,
        "finish": start,
        "turning": np.inf,
    }
    if rem <= _EPS:
        return out
    if d_eff <= 0.0:
        raise ValueError("remaining work but no cloud instances")

    t = float(start)
    while t < end - _EPS:
        # Flexibility test at the current instant (Def. 3.1).
        if rem / d_eff >= (end - t) - _EPS:
            # Turning point: finish the remainder on on-demand instances.
            out["turning"] = t
            out["ondemand_cost"] += p_od * rem
            out["finish"] = end
            rem = 0.0
            return out
        k = min(int(t / slot + 1e-9), len(avail) - 1)
        slot_end = min((k + 1) * slot, end)
        span = slot_end - t
        if span <= _EPS:
            t = slot_end
            continue
        if avail[k]:
            # Spot available: work accrues at rate d_eff, margin constant.
            done = d_eff * span
            if done >= rem - _EPS:
                dt = rem / d_eff
                out["spot_cost"] += d_eff * price[k] * dt
                out["spot_work"] += rem
                out["finish"] = t + dt
                return out
            out["spot_cost"] += d_eff * price[k] * span
            out["spot_work"] += done
            rem -= done
            t = slot_end
        else:
            # Unavailable: no work; flexibility margin shrinks at rate 1.
            margin = (end - t) - rem / d_eff
            if margin <= span + _EPS:
                # Turning point inside this slot.
                t_star = t + margin
                out["turning"] = t_star
                out["ondemand_cost"] += p_od * rem
                out["finish"] = end
                return out
            t = slot_end
    # Window exhausted (only reachable through accumulated fp slack).
    if rem > _EPS:
        out["ondemand_cost"] += p_od * rem
        out["finish"] = end
    return out


def oracle_greedy_chain(
    market: SpotMarket,
    bid: float,
    arrival: float,
    deadline: float,
    z: np.ndarray,
    delta: np.ndarray,
) -> dict:
    """The paper's *Greedy* benchmark (Section 6.1) on a chain job.

    Bid delta_i spot instances for the head task until the critical path of
    the REMAINING workload reaches the remaining window; then finish every
    task with delta_i on-demand instances back-to-back (which exactly fills
    the window). Global state — simulated sequentially.
    """
    avail = market.availability(bid)
    price = market.price
    slot = market.slot
    p_od = market.p_ondemand

    rem = np.array(z, dtype=np.float64).copy()
    delta = np.asarray(delta, dtype=np.float64)
    head = 0
    l = len(rem)
    spot_cost = 0.0
    spot_work = 0.0
    t = float(arrival)

    def crit() -> float:
        return float(np.sum(rem[head:] / delta[head:]))

    while head < l and t < deadline - _EPS:
        # Greedy switch test: remaining critical path >= remaining window.
        slack = (deadline - t) - crit()
        if slack <= _EPS:
            break
        k = min(int(t / slot + 1e-9), len(avail) - 1)
        slot_end = min((k + 1) * slot, deadline)
        span = slot_end - t
        if span <= _EPS:
            t = slot_end
            continue
        if avail[k]:
            # Head task works at full parallelism; margin is constant while
            # available, so only completion events can occur inside the slot.
            while span > _EPS and head < l:
                d = delta[head]
                done = d * span
                if done >= rem[head] - _EPS:
                    dt = rem[head] / d
                    spot_cost += d * price[k] * dt
                    spot_work += rem[head]
                    rem[head] = 0.0
                    span -= dt
                    head += 1
                else:
                    spot_cost += d * price[k] * span
                    spot_work += done
                    rem[head] -= done
                    span = 0.0
            t = slot_end
        else:
            # Unavailable: slack shrinks at rate 1; switch may fire mid-slot.
            if slack <= span + _EPS:
                t = t + slack
                break
            t = slot_end

    od_work = float(np.sum(rem[head:])) if head < l else 0.0
    return {
        "spot_cost": spot_cost,
        "ondemand_cost": p_od * od_work,
        "spot_work": spot_work,
        "ondemand_work": od_work,
        "finish": deadline if od_work > _EPS else t,
    }
