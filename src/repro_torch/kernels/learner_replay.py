"""Bandit and follow-the-leader replay (exp3, ucb1, egreedy, ftl) over a
precomputed cost tensor: the kernel and its plain PyTorch version.

Counterpart of the reference's ``repro/learn/replay.py::_scan_one``: one
``jax.lax.scan`` per learner kind over the merged (sample, update) event
stream, vmapped over scenarios x instances (the reference has no Pallas
kernel for these learners). A bandit learner's draw feeds its own later
update, so the Hedge kernel's split into a trajectory pass and a sampling
pass does not carry over. But a sample changes no state, and a job samples
long before its update (~1350 updates before, at Table 6), so
``csrc/learner_replay.cu`` runs one block per (scenario, instance), every
kind in one launch: one update warp carries the state through the J
updates and copies it into a ring of shared-memory snapshots wherever a
sample reads it; sample warps take the draws from those snapshots and pass
each on to the update warp as a record. :func:`schedule` computes, on the
device, what the block needs of the event stream.

The kernel's layout, which the plain version follows operation for
operation so that the two agree bit for bit:

* policy q sits in lane q // nj, slot q % nj (``nj = lanes(P)`` contiguous
  values per lane); slots past P are padding (log-weight -inf, cost,
  probability and counts 0, score +inf);
* a sum is the in-lane serial sum followed by the xor butterfly over the
  32 lanes; the cdf is the in-lane serial prefix plus the exclusive
  Hillis-Steele scan of the lane totals, normalized by its value at policy
  P - 1 (the reference's ``cdf / cdf[-1]``); a max and an argmin are
  order-free (ties to the lowest index, -0 taken as +0);
* ``exp`` and ``log`` are evaluated in float64 and rounded to float32 (the
  one rounding two libraries agree on); sqrt and division are IEEE.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.device import kernel_library
from repro_torch.kernels import LAUNCHES
from repro_torch.obs.compiled import record_launch

__all__ = ["learner_replay", "learner_replay_plain", "learner_work",
           "OPS_PER_JOB", "lanes", "schedule", "margin_bound", "gap_bound", "KIND_CODES", "LANE_COUNTS",
           "F32_UNIT"]

KIND_CODES = {"exp3": 0, "ucb1": 1, "egreedy": 2, "ftl": 3}
# Values per lane the kernel is built for (kLaneCounts in the .cu); a launch
# takes the least that holds P.
LANE_COUNTS = (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32)
WARP = 32
_NEG = 3.0e38        # "minus infinity" of untried arms (learners.py)
F32_UNIT = 2.0 ** -24   # float32's unit roundoff


def lanes(P: int) -> int:
    """Values per lane at P policies (the kernel's and the plain version's
    layout)."""
    for n in LANE_COUNTS:
        if n * WARP >= P:
            return n
    raise ValueError(f"learner_replay: need 1 <= P <= 1024, got {P}")


def _codes(kinds, K: int) -> list[int]:
    kinds = [kinds] * K if isinstance(kinds, str) else list(kinds)
    if len(kinds) != K:
        raise ValueError(f"learner_replay: {len(kinds)} kinds for {K} "
                         "instances")
    bad = sorted({k for k in kinds if k not in KIND_CODES})
    if bad:
        raise ValueError(f"learner_replay has no kernel for {bad}; it "
                         f"replays {sorted(KIND_CODES)}")
    return [KIND_CODES[k] for k in kinds]


# Bounded: one entry per (learner kinds, card) in use.
@functools.lru_cache(maxsize=64)
def _device_codes(codes: tuple, dev: torch.device) -> torch.Tensor:
    """The kind codes on the card, copied once: a copy from pageable host
    memory at each launch would hold the host until the card caught up."""
    return torch.tensor(codes, dtype=torch.int32, device=dev)


def _lane_sum(x: torch.Tensor, nj: int) -> torch.Tensor:
    """(B, 32 * nj) -> (B, 1): the in-lane serial sum, then the xor
    butterfly over the lanes (every lane ends with lane 0's value)."""
    xv = x.view(x.shape[0], WARP, nj)
    acc = xv[..., 0]
    for i in range(1, nj):
        acc = acc + xv[..., i]
    lane = torch.arange(WARP, device=x.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    return acc[:, :1]


def _lane_cdf(p: torch.Tensor, nj: int) -> torch.Tensor:
    """(B, 32 * nj) -> (B, 32 * nj): the in-lane serial prefix plus the
    exclusive scan of the lane totals (Hillis-Steele; lanes below the
    offset add +0, which changes no non-negative value)."""
    B = p.shape[0]
    pv = p.view(B, WARP, nj)
    pre = [pv[..., 0]]
    for i in range(1, nj):
        pre.append(pre[-1] + pv[..., i])
    incl = pre[-1]
    for o in (1, 2, 4, 8, 16):
        incl = incl + torch.nn.functional.pad(incl[:, :-o], (o, 0))
    excl = torch.nn.functional.pad(incl[:, :-1], (1, 0))
    return (excl[..., None] + torch.stack(pre, -1)).view(B, WARP * nj)


# The schedule's arrays in the order the kernel reads them, back to back.
SCHEDULE_FIELDS = ("smp_j", "smp_snap", "upd_j", "upd_s", "has_snap",
                   "snap_last", "ok")


def schedule(ev_kind: torch.Tensor, ev_j: torch.Tensor) -> dict:
    """What the kernel's warps need of a (2J,) event stream (0 = sample,
    1 = update; job), computed with torch ops on the stream's device, so
    that a launch waits for no host sync. Every entry is an int64 tensor:

    * ``smp_j``, ``smp_state``, ``smp_snap`` (J,): per sample, in stream
      order, its job, the state it reads (the updates before it:
      ``build_events``'s ``n_done`` of that job) and the snapshot that
      holds that state (snapshots are numbered in stream order, one per
      distinct state that some sample reads);
    * ``upd_j``, ``upd_s`` (J,): per update, in stream order, its job and
      that job's sample index;
    * ``has_snap`` (J + 1,): 1 where some sample reads state t (t updates
      done), so that the update warp copies the state there;
    * ``snap_last`` (J,): per snapshot, the index of the last sample that
      reads it, -1 past the last snapshot;
    * ``ok`` (): 1 if the stream holds one sample and one later update of
      every job 0..J-1, the streams the kernel's handoff cannot deadlock
      on (otherwise the kernel traps, and the launch fails at the next
      synchronization).
    """
    J = ev_kind.shape[0] // 2
    dev = ev_kind.device
    upd = ev_kind.long() == 1
    jj = ev_j.long()
    ok = ((jj >= 0) & (jj < J)).all() & (upd.sum() == J)
    jj = jj.clamp(0, max(J - 1, 0))
    n_upd = torch.cumsum(upd.long(), 0) - upd.long()   # updates before
    # The samples, then the updates, each in stream order.
    order = torch.argsort(upd.long(), stable=True)
    smp_ev, upd_ev = order[:J], order[J:]
    smp_j, upd_j = jj[smp_ev], jj[upd_ev]
    smp_state = n_upd[smp_ev]
    ar = torch.arange(J, device=dev)

    def per_job(jobs, val):
        return torch.zeros(J, dtype=torch.long, device=dev).scatter_(
            0, jobs, val)
    ones = torch.ones_like(ar)
    for jobs in (smp_j, upd_j):     # each job sampled once, updated once
        seen = torch.zeros(J, dtype=torch.long, device=dev)
        ok = ok & (seen.index_add_(0, jobs, ones) == 1).all()
    # ... and sampled before its update.
    ok = ok & (per_job(smp_j, smp_state) <= per_job(upd_j, ar)).all()
    new = torch.ones(J, dtype=torch.long, device=dev)
    new[1:] = (smp_state[1:] != smp_state[:-1]).long()
    smp_snap = torch.cumsum(new, 0) - 1
    # smp_state and smp_snap are sorted: the samples at or below a state,
    # the last sample of a snapshot, by binary search.
    upto = torch.searchsorted(smp_state, torch.arange(J + 1, device=dev),
                              right=True)
    has_snap = torch.diff(upto, prepend=upto.new_zeros(1)).clamp_max(1)
    last = torch.searchsorted(smp_snap, ar, right=True) - 1
    if J:
        last = torch.where(ar <= smp_snap[-1], last, -1)
    return {"smp_j": smp_j, "smp_state": smp_state, "smp_snap": smp_snap,
            "upd_j": upd_j, "upd_s": per_job(smp_j, ar)[upd_j],
            "has_snap": has_snap, "snap_last": last, "ok": ok.long()}


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` evaluated in float64 and rounded to the dtype of ``x``."""
    return fn(x.double()).to(x.dtype)


def learner_replay_plain(kinds, C, etas, gammas, u, ev_kind, ev_j):
    """Plain PyTorch version of :func:`learner_replay`: a loop over the
    events, every instance at once, in the dtype of ``C`` (float32 like the
    kernel, or float64), with the kernel's order of operations."""
    S, J, P = C.shape
    K = etas.shape[0]
    dt, dev = C.dtype, C.device
    code_list = _codes(kinds, K)
    codes = torch.tensor(code_list, device=dev)
    nj = lanes(P)
    W, B = WARP * nj, S * K
    real = torch.arange(W, device=dev) < P                     # (W,)
    idx = torch.arange(W, device=dev)
    row_kind = codes.repeat(S)[:, None]                         # (B, 1)
    is_exp3, is_ucb1 = row_kind == 0, row_kind == 1
    is_egreedy, is_ftl = row_kind == 2, row_kind == 3
    has = {c: c in code_list for c in range(4)}
    srow = torch.arange(B, device=dev) // K
    Cp = torch.nn.functional.pad(C, (0, W - P))                 # (S, J, W)
    rows = lambda a: a.to(dt)[None].expand(S, K, J).reshape(B, J)  # noqa: E731
    eta_r, gam_r = rows(etas), rows(gammas)
    u_r = u.to(dt)[:, None].expand(S, K, J).reshape(B, J)
    logw = torch.where(real, torch.full((B, W), -math.log(P), dtype=dt,
                                        device=dev), -math.inf)
    sums = torch.zeros((B, W), dtype=dt, device=dev)
    counts = torch.zeros((B, W), dtype=dt, device=dev)
    new = lambda fill, d=dt: torch.full((B, J), fill, dtype=d,  # noqa: E731
                                        device=dev)
    chosen, p_chosen, expected = new(0, torch.long), new(0.0), new(0.0)
    inf = torch.tensor(math.inf, dtype=dt, device=dev)
    # g / P divides by a tensor: PyTorch on CUDA multiplies by the rounded
    # reciprocal of a Python scalar divisor, the kernel divides.
    P_t = torch.tensor(float(P), dtype=dt, device=dev)

    def probs(g):
        """The sampling distribution of every row at exploration g (B, 1)."""
        p = torch.zeros((B, W), dtype=dt, device=dev)
        if has[0]:
            z = logw - logw.amax(-1, keepdim=True)
            w = torch.exp(z) if dt == torch.float64 else _f64(torch.exp, z)
            p3 = (1.0 - g) * (w / _lane_sum(w, nj)) + g / P_t
            p = torch.where(is_exp3 & real, p3, p)
        if has[1] or has[2] or has[3]:
            cs = counts.clamp_min(1.0)
            score = sums / cs
            if has[1]:
                t = counts.sum(-1, keepdim=True).clamp_min(1.0)
                lt = torch.log(t) if dt == torch.float64 else \
                    _f64(torch.log, t)
                score = torch.where(is_ucb1, score
                                    - torch.sqrt(2.0 * lt / cs), score)
            score = torch.where(counts < 0.5, -_NEG, score)
            score = torch.where(is_ftl, sums, score)
            score = torch.where(real, score, inf)
            one = (idx == score.argmin(-1, keepdim=True)).to(dt)
            pe = (1.0 - g) * one + g / P_t
            p = torch.where(~is_exp3 & real,
                            torch.where(is_egreedy, pe, one), p)
        return p

    for e, j in zip(ev_kind.tolist(), ev_j.tolist()):
        cj = Cp[:, j].index_select(0, srow)                    # (B, W)
        if e == 0:
            p = probs(gam_r[:, j:j + 1])
            cdf = _lane_cdf(p, nj)
            x = cdf / cdf[:, P - 1:P]
            c = ((x <= u_r[:, j:j + 1]) & real).sum(
                -1, keepdim=True).clamp_max(P - 1)
            chosen[:, j] = c[:, 0]
            p_chosen[:, j] = p.gather(1, c)[:, 0]
            expected[:, j] = _lane_sum(p * cj, nj)[:, 0]
        else:
            c = chosen[:, j:j + 1]
            hit = idx == c                                      # (B, W)
            val = cj.gather(1, c)                               # (B, 1)
            if has[0]:
                lw = torch.where(hit, logw - eta_r[:, j:j + 1]
                                 * (val / p_chosen[:, j:j + 1]), logw)
                lw = lw - lw.amax(-1, keepdim=True)
                logw = torch.where(is_exp3, lw, logw)
            if has[1] or has[2]:
                bandit = (is_ucb1 | is_egreedy) & hit
                sums = torch.where(bandit, sums + val, sums)
                counts = torch.where(bandit, counts + 1.0, counts)
            if has[3]:
                sums = torch.where(is_ftl, sums + cj, sums)
    weights = probs(gam_r[:, J - 1:J] if J else
                    torch.zeros((B, 1), dtype=dt, device=dev))
    shape = lambda a: a.reshape(S, K, *a.shape[1:])  # noqa: E731
    return {"chosen": shape(chosen), "p_chosen": shape(p_chosen),
            "expected_cost": shape(expected),
            "weights": shape(weights[:, :P]), "logw": shape(logw[:, :P]),
            "sums": shape(sums[:, :P]), "counts": shape(counts[:, :P])}


def margin_bound(kind: str, scale, P: int, unit: float = F32_UNIT):
    """The draw margin min |cdf / total - u| under which a float32 replay
    may first part from the float64 loop: the roundings that the draw and
    the update before it add, for a state whose largest magnitude is
    ``scale`` (exp3 and Hedge: the largest |logw| over the policies).

    exp3 and Hedge: the update before the draw rounds a log-weight at most
    three times at magnitude <= scale (the product eta * c, the difference,
    the shift by the max); exp and the normalizing sum carry that error
    into the probabilities twice (each w_i and their total T), and
    cdf / total twice again: 12 unit scale. The cdf's own arithmetic adds
    at most 4 P + 16 roundings at magnitude <= 1: the probabilities'
    (P + 5 for exp's rounding, T's P - 1 additions, the quotient, 1 - g,
    g / P, the product and the sum, counted twice) and the cumulative sums'
    (P + 2 on either side of the comparison, the quotient and u's
    rounding). The error that earlier updates carry is not followed:
    exp3's importance weight c / p amplifies it without a useful bound
    (ROADMAP queue C), so this holds a trace to parting first at a knife
    edge of one update's rounding. egreedy's probabilities are exact up to
    the 4 P + 16 roundings; ftl and ucb1 draw from a one-hot distribution
    (cdf steps at exactly 0 and 1), where only u's rounding is left: 2
    units. A bound of 1 or more excuses every draw, and so is no bound.
    """
    if kind in ("exp3", "hedge"):
        return unit * (12 * scale + 4 * P + 16)
    if kind == "egreedy":
        return unit * (4 * P + 16)
    return unit * 2.0


def gap_bound(kind: str, n_done, scale, unit: float = F32_UNIT):
    """The largest gap between the two lowest scores at which an argmin
    kind (ucb1, egreedy, ftl) rounding with ``unit`` may pick another arm
    than exact arithmetic; ``scale`` is the largest score magnitude over
    tried arms. Each sum of an arm adds at most ``n_done`` costs, each
    rounded once and added with one rounding at magnitude <= its final
    value; the mean divides once, ucb1's bonus rounds four times (log, the
    quotient, sqrt, the difference): each score is off by at most
    (2 n_done + 5) unit scale, and the two lowest each so. A gap of 0 (two
    untried arms at -3e38, or an exact tie) is no knife edge: both
    versions take the lowest index."""
    if kind not in ("ucb1", "egreedy", "ftl"):
        raise ValueError(f"gap_bound: {kind} draws no argmin")
    return unit * 2 * (2 * n_done + 5) * scale


# Operations per (instance, job, policy) as the kernel does them: exp3 14
# (max, difference, exp, sum, quotient, product, sum of the distribution;
# the cdf's sums, quotients and comparisons; the expected cost's products
# and sums; the update's max and shift), ucb1 12, egreedy 10, ftl 7.
OPS_PER_JOB = {"exp3": 14, "ucb1": 12, "egreedy": 10, "ftl": 7}


def learner_work(kinds, S: int, J: int, P: int) -> dict:
    """Work of one ``learner_replay`` call: C, etas, gammas, u, the event
    stream and the kind codes read once, the traces (chosen, p_chosen,
    expected_cost) and the four (S, K, P) state arrays written once, and
    ``OPS_PER_JOB`` of each instance's kind per (scenario, job, policy)."""
    K = len(kinds)
    return {"bytes": 4 * (S * J * P + 2 * K * J + S * J + 4 * J + K
                          + 3 * S * K * J + 4 * S * K * P),
            "ops": {"f32": S * J * P * sum(OPS_PER_JOB[k] for k in kinds)}}


def learner_replay(kinds, C, etas, gammas, u, ev_kind, ev_j):
    """Replay exp3 / ucb1 / egreedy / ftl instances over a (S, J, P) cost
    tensor, one launch.

    ``kinds``: one kind name for every instance, or one per instance (K);
    ``C``: (S, J, P) unit costs; ``etas``, ``gammas``: (K, J) learning and
    exploration rates; ``u``: (S, J) uniform streams; ``ev_kind``,
    ``ev_j``: (2J,) int32 event stream (0 = sample, 1 = update; job).
    Returns ``chosen`` (S, K, J) int64, ``p_chosen`` and ``expected_cost``
    (S, K, J), the final sampling distribution ``weights`` at
    ``gammas[:, -1]`` and the final state ``logw``, ``sums`` and
    ``counts`` (S, K, P); float32 for the kernel. CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    S, J, P = C.shape
    K = etas.shape[0]
    if etas.shape != (K, J) or gammas.shape != (K, J) or u.shape != (S, J) \
            or ev_kind.shape != (2 * J,) or ev_j.shape != (2 * J,):
        raise ValueError("learner_replay: inconsistent shapes")
    codes = _codes(kinds, K)
    if C.device.type == "cpu":
        return learner_replay_plain(kinds, C, etas, gammas, u, ev_kind, ev_j)
    if C.device.type != "cuda":
        raise ValueError(f"learner_replay has no kernel for {C.device}")
    nj = lanes(P)
    for name, t, dt in (("C", C, torch.float32), ("etas", etas, torch.float32),
                        ("gammas", gammas, torch.float32),
                        ("u", u, torch.float32),
                        ("ev_kind", ev_kind, torch.int32),
                        ("ev_j", ev_j, torch.int32)):
        if t.device != C.device or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} on {C.device}")
    dev = C.device
    C, etas, gammas, u, ev_kind, ev_j = (
        t.contiguous() for t in (C, etas, gammas, u, ev_kind, ev_j))
    kinds_t = _device_codes(tuple(codes), dev)
    sched = schedule(ev_kind, ev_j)
    sched = torch.cat([sched[n].view(-1) for n in SCHEDULE_FIELDS]).int()
    chosen = torch.empty((S, K, J), dtype=torch.int32, device=dev)
    new = lambda *shape: torch.empty(  # noqa: E731
        shape, dtype=torch.float32, device=dev)
    p_chosen, expected, record = new(S, K, J), new(S, K, J), new(S, K, J)
    state = {n: new(S, K, P) for n in ("weights", "logw", "sums", "counts")}
    fn = kernel_library("learner_replay").learner_replay_launch
    fn.restype = ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(dev)
    with record_launch("learner_replay", stream,
                       lambda: learner_work(kinds, S, J, P)):
        rc = fn(*map(ptr, (C, etas, gammas, u, sched, kinds_t, chosen,
                           p_chosen, expected, record, state["weights"],
                           state["logw"], state["sums"], state["counts"])),
                *map(ctypes.c_int, (S, K, J, P, nj)),
                ctypes.c_float(-math.log(P)),
                ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"learner_replay_launch: CUDA error {rc} at launch")
    LAUNCHES["learner_replay"] += 1
    return {"chosen": chosen.long(), "p_chosen": p_chosen,
            "expected_cost": expected, **state}
