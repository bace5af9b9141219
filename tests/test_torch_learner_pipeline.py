"""The learner-replay kernel's pipeline (``csrc/learner_replay.cu``): one
update warp carries the state through the updates and publishes
shared-memory snapshots, sample warps draw from them. On the CPU:

* ``learner_replay.schedule`` against the reference's ``build_events`` on
  three streams (Table 6's shape at a small J, d = 0 where every update
  directly follows its own sample, and d past the arrival span where every
  sample comes first): the update order, each sample's state index, the
  snapshot points, the samples per snapshot, the largest lag; and the
  flag that rejects a stream the handoff could deadlock on;
* an emulation of the block's protocol (update warp, round-robin sample
  warps, a ring of R snapshots, the progress and published counters, the
  three waits), the warps interleaved at random, each job drawn from the
  snapshot of the plain state after ``n_done[j]`` updates: it must never
  block for good, never read a slot after it was overwritten, and give
  ``learner_replay_plain``'s outputs bit for bit, every kind, on the three
  streams.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import generate_chain_jobs  # noqa: E402
from repro.learn.replay import build_events as ref_build_events  # noqa: E402

from repro_torch.kernels import learner_replay as lk  # noqa: E402

# Table 6's stream (generate_chain_jobs(10000, 2, seed=0)): the feedback
# delay d over the arrival span, 338.06 / 2482.4, which makes a job sample
# ~13.6 % of the stream's updates before its own update.
TABLE6_D_OVER_SPAN = 338.06 / 2482.4
KINDS = ["exp3", "ucb1", "egreedy", "ftl"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _stream(name: str, J: int):
    """(arrivals, d) of a named stream over the arrivals of J type-2 jobs."""
    jobs = generate_chain_jobs(J, 2, seed=0)
    arrivals = np.array([j.arrival for j in jobs])
    span = arrivals[-1] - arrivals[0]
    d = {"table6": TABLE6_D_OVER_SPAN * span, "lag0": 0.0,
         "samples_first": 2.0 * span}[name]
    return arrivals, d


def _sched(ev_kind, ev_j):
    got = lk.schedule(torch.from_numpy(ev_kind), torch.from_numpy(ev_j))
    return {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("name", ["table6", "lag0", "samples_first"])
def test_schedule_against_build_events(name):
    J = 400
    arrivals, d = _stream(name, J)
    ev_kind, ev_j, n_done = ref_build_events(arrivals, d)
    sc = _sched(ev_kind, ev_j)
    assert int(sc["ok"]) == 1
    smp_j = ev_j[ev_kind == 0]
    np.testing.assert_array_equal(sc["upd_j"], ev_j[ev_kind == 1])
    np.testing.assert_array_equal(sc["smp_j"], smp_j)
    np.testing.assert_array_equal(sc["smp_state"], n_done[smp_j])
    sample_of = np.empty(J, int)
    sample_of[smp_j] = np.arange(J)
    np.testing.assert_array_equal(sc["upd_s"], sample_of[sc["upd_j"]])
    # Snapshots: one per distinct state a sample reads, in stream order.
    states, per = np.unique(n_done, return_counts=True)
    has = np.zeros(J + 1, int)
    has[states] = 1
    np.testing.assert_array_equal(sc["has_snap"], has)
    np.testing.assert_array_equal(sc["smp_snap"],
                                  np.searchsorted(states, sc["smp_state"]))
    np.testing.assert_array_equal(np.bincount(sc["smp_snap"]), per)
    last = np.full(J, -1)
    last[:len(per)] = np.cumsum(per) - 1
    np.testing.assert_array_equal(sc["snap_last"], last)
    # The lag: updates still owed when a job samples, by a walk of the
    # events.
    lag, done = np.zeros(J, int), 0
    for k, j in zip(ev_kind, ev_j):
        if k == 0:
            lag[j] = -done
        else:
            lag[j] += done
            done += 1
    lag_sched = np.arange(J) - sc["smp_state"][sc["upd_s"]]
    np.testing.assert_array_equal(lag_sched, lag[sc["upd_j"]])
    want_max = {"table6": None, "lag0": 0, "samples_first": J - 1}[name]
    if want_max is None:        # Table 6's shape: ~13.6 % of J, several runs
        assert 0.05 * J < lag.max() < 0.3 * J and len(states) > 20
    else:
        assert lag.max() == want_max


def test_schedule_rejects_streams_that_could_deadlock():
    arrivals, d = _stream("table6", 60)
    ev_kind, ev_j, _ = ref_build_events(arrivals, d)
    bad = []
    k, j = ev_kind.copy(), ev_j.copy()
    first_upd = int(np.argmax(k == 1))
    k[[0, first_upd]], j[[0, first_upd]] = k[[first_upd, 0]], j[[first_upd, 0]]
    bad.append((k, j))                               # an update first
    j = ev_j.copy()
    samples = np.nonzero(ev_kind == 0)[0]
    j[samples[1]] = j[samples[0]]
    bad.append((ev_kind, j))                         # a job sampled twice
    j = ev_j.copy()
    j[0] = len(arrivals)
    bad.append((ev_kind, j))                         # a job out of range
    k = ev_kind.copy()
    k[0] = 1
    bad.append((k, ev_j))                            # J + 1 updates
    for k, j in bad:
        assert int(_sched(k, j)["ok"]) == 0
    assert int(_sched(ev_kind, ev_j)["ok"]) == 1
    empty = np.zeros(0, np.int32)
    sc = _sched(empty, empty)
    assert int(sc["ok"]) == 1 and sc["has_snap"].tolist() == [0]


# -- the block's protocol, emulated ------------------------------------------

class _Instance:
    """One (scenario, instance)'s state and draws with the plain version's
    float32 operations (learner_replay_plain, one row)."""

    def __init__(self, kind, C, eta, gam, u, P):
        self.kind, self.P, self.nj = kind, P, lk.lanes(P)
        W = lk.WARP * self.nj
        self.C = torch.nn.functional.pad(C, (0, W - P))      # (J, W)
        self.eta, self.gam, self.u = eta, gam, u
        self.real = torch.arange(W) < P
        self.idx = torch.arange(W)
        self.P_t = torch.tensor(float(P))
        self.logw = torch.where(self.real, torch.full((1, W), -np.log(P),
                                                      dtype=torch.float32),
                                -np.inf)
        self.sums = torch.zeros((1, W))
        self.counts = torch.zeros((1, W))

    def state(self):
        return (self.logw.clone(), self.sums.clone(), self.counts.clone())

    def probs(self, st, g):
        logw, sums, counts = st
        if self.kind == "exp3":
            z = logw - logw.amax(-1, keepdim=True)
            w = lk._f64(torch.exp, z)
            p = (1.0 - g) * (w / lk._lane_sum(w, self.nj)) + g / self.P_t
            return torch.where(self.real, p, 0.0)
        cs = counts.clamp_min(1.0)
        score = sums / cs
        if self.kind == "ucb1":
            t = counts.sum(-1, keepdim=True).clamp_min(1.0)
            score = score - torch.sqrt(2.0 * lk._f64(torch.log, t) / cs)
        score = torch.where(counts < 0.5, -lk._NEG, score)
        if self.kind == "ftl":
            score = sums
        score = torch.where(self.real, score, torch.tensor(np.inf))
        one = (self.idx == score.argmin(-1, keepdim=True)).float()
        p = (1.0 - g) * one + g / self.P_t if self.kind == "egreedy" else one
        return torch.where(self.real, p, 0.0)

    def draw(self, st, j):
        """A sample of job j from state ``st``: (c, p, expected, record)."""
        p = self.probs(st, self.gam[j:j + 1][None])
        cdf = lk._lane_cdf(p, self.nj)
        x = cdf / cdf[:, self.P - 1:self.P]
        c = int(((x <= self.u[j]) & self.real).sum().clamp_max(self.P - 1))
        cj = self.C[j][None]
        val = cj[:, c:c + 1]
        y = self.eta[j:j + 1][None] * (val / p[:, c:c + 1])
        return (c, p[0, c], lk._lane_sum(p * cj, self.nj)[0, 0],
                y if self.kind == "exp3" else val)

    def update(self, j, c, v):
        hit = self.idx == c
        if self.kind == "exp3":
            lw = torch.where(hit, self.logw - v, self.logw)
            self.logw = lw - lw.amax(-1, keepdim=True)
        elif self.kind == "ftl":
            self.sums = self.sums + self.C[j][None]
        else:
            self.sums = torch.where(hit, self.sums + v, self.sums)
            self.counts = torch.where(hit, self.counts + 1.0, self.counts)


def _emulate(inst, sc, n_warps, R, rng):
    """The kernel's block for one instance, its warps interleaved at random
    (each runs to its next wait, or one step, at a time). Returns the
    draws by job and the final state."""
    J = len(sc["upd_j"])
    progress = list(range(n_warps))
    ring, published = [None] * R, [0]
    draws = {}

    def update_warp():
        t_pub = 0

        def publish():
            nonlocal t_pub
            if t_pub >= R:
                last = int(sc["snap_last"][t_pub - R])
                yield lambda: all(p > last for p in progress)
            ring[t_pub % R] = inst.state()
            t_pub += 1
            published[0] = t_pub
        if J and sc["has_snap"][0]:
            yield from publish()
        for n in range(J):
            j, s = int(sc["upd_j"][n]), int(sc["upd_s"][n])
            if inst.kind != "ftl":      # ftl's update needs no draw
                yield lambda s=s: progress[s % n_warps] > s
            c, _, _, v = draws[j] if inst.kind != "ftl" else (0, 0, 0, 0)
            inst.update(j, c, v)
            if sc["has_snap"][n + 1]:
                yield from publish()

    def sample_warp(w):
        for i in range(w, J, n_warps):
            j, m = int(sc["smp_j"][i]), int(sc["smp_snap"][i])
            yield lambda m=m: published[0] > m
            st = ring[m % R]
            draws[j] = inst.draw(st, j)
            yield lambda: True          # others may run while it draws
            assert ring[m % R] is st, "snapshot slot overwritten in use"
            progress[w] = i + n_warps

    warps = [update_warp()] + [sample_warp(w) for w in range(n_warps)]
    waiting = [lambda: True] * len(warps)
    while warps:
        ready = [k for k, cond in enumerate(waiting) if cond()]
        assert ready, "every warp waits: the handoff deadlocked"
        k = ready[rng.integers(len(ready))]
        try:
            waiting[k] = next(warps[k])
        except StopIteration:
            del warps[k], waiting[k]
    return draws


@pytest.mark.parametrize("name", ["table6", "lag0", "samples_first"])
def test_pipeline_emulation_equals_plain_bit_for_bit(name):
    """Every kind on one stream, at (warps, ring slots) that make the ring
    wrap often and the handoff wait both ways: each job's draw from the
    snapshot of the plain state after n_done[j] updates is the serial
    walk's draw."""
    J, P = 160, 40
    arrivals, d = _stream(name, J)
    ev_kind, ev_j, _ = ref_build_events(arrivals, d)
    sc = _sched(ev_kind, ev_j)
    rng = np.random.default_rng(7)
    C = torch.from_numpy(
        (rng.random((1, J, P)) * 0.6 + np.linspace(0, 0.4, P)).astype(
            np.float32))
    etas = torch.from_numpy(rng.uniform(0.05, 2.0, (4, J)).astype(np.float32))
    gammas = torch.from_numpy(rng.uniform(0.0, 0.3, (4, J)).astype(
        np.float32))
    u = torch.from_numpy(rng.random((1, J)).astype(np.float32))
    ref = lk.learner_replay_plain(KINDS, C, etas, gammas, u,
                                  torch.from_numpy(ev_kind),
                                  torch.from_numpy(ev_j))
    for kk, kind in enumerate(KINDS):
        for n_warps, R in ((1, 1), (3, 2), (7, 5)):
            inst = _Instance(kind, C[0], etas[kk], gammas[kk], u[0], P)
            draws = _emulate(inst, sc, n_warps, R,
                             np.random.default_rng(n_warps))
            got = {key: torch.stack([torch.as_tensor(draws[j][f])
                                     for j in range(J)]).reshape(-1)
                   for f, key in enumerate(("chosen", "p_chosen",
                                            "expected_cost"))}
            final = inst.probs(inst.state(), gammas[kk, J - 1:J][None])
            got.update(weights=final[0, :P], logw=inst.logw[0, :P],
                       sums=inst.sums[0, :P], counts=inst.counts[0, :P])
            for key, val in got.items():
                want = ref[key][0, kk]
                assert torch.equal(val.to(want.dtype), want), \
                    (kind, n_warps, R, key)


def test_kernel_source_declares_the_handoff():
    """The .cu's C entry takes the schedule as one int32 buffer in
    SCHEDULE_FIELDS's order, and its header argues deadlock freedom."""
    src = (pathlib.Path(lk.__file__).parent / "csrc"
           / "learner_replay.cu").read_text()
    assert "const int* sched" in src
    assert "deadlock" in src
    order = ("smp_j", "smp_snap", "upd_j", "upd_s", "has_snap", "snap_last",
             "ok")
    assert lk.SCHEDULE_FIELDS == order
    for field in order[:-1]:
        assert f"const int* {field};" in src
