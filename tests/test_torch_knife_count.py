"""The float32 turning-point knife edge counted on paper Table 2's proposed
sweeps (ROADMAP queue C): exp1's early-start Dealloc sweeps over the 25
spot/on-demand policies, r = 0, one market scenario, 300 jobs of each job
type 1-4. The port's plain path (``device="cpu"``, float32 like its
kernel) and the reference's ``backend="jax"`` (float32) are each held
against the reference's float64 ``backend="numpy"``: the (job, policy)
unit costs that leave it by more than 1e-5 are counted, and the largest
gap taken.

Both float32 paths meet knife edges, partly the same (job, policy) cells
and partly their own; where they meet the same one, the rest of the job's
cost rounds differently in each, by about 1e-6 in unit cost. So the port's
count must be no larger than the reference's, and its largest gap no
larger than the reference's by more than 1e-5, the resolution the count
itself uses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import generate_chain_jobs, spot_od_policies  # noqa: E402
from repro.engine import evaluate_grid as ref_evaluate_grid  # noqa: E402
from repro.engine import make_scenarios as ref_make_scenarios  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.engine import evaluate_grid  # noqa: E402

TOL = 1e-5
N_JOBS, SEED, MARKET_SEED = 300, 0, 1000
TYPES = (1, 2, 3, 4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch's intra-op pool to one thread while a port test runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _proposed_sweep(job_type):
    """Unit costs (S=1, J, 25) of one type's proposed sweep: the float64
    oracle, the reference's float32 jax backend and the port's plain path."""
    jobs = generate_chain_jobs(N_JOBS, job_type, seed=SEED)
    markets = ref_make_scenarios(max(j.deadline for j in jobs) + 1.0, 1,
                                 seed=MARKET_SEED)
    pols = spot_od_policies()
    kw = dict(r_total=0, windows="dealloc", early_start=True)
    oracle = ref_evaluate_grid(jobs, pols, markets, backend="numpy", **kw)
    ref32 = ref_evaluate_grid(jobs, pols, markets, backend="jax", **kw)
    jobs_t = interop.chain_jobs_from_arrays(
        *interop.chain_jobs_to_arrays(jobs))
    markets_t = interop.markets_from_prices(
        np.stack([m.price for m in markets]), markets[0].slot)
    pols_t = interop.policies_from_tuples(
        [(p.beta, p.bid, p.beta0) for p in pols])
    port = evaluate_grid(jobs_t, pols_t, markets_t, device="cpu", **kw)
    return oracle.unit_cost, ref32.unit_cost, port.unit_cost


def test_knife_edges_no_worse_than_reference_float32():
    gaps = {"port": [], "reference": []}
    for jt in TYPES:
        oracle, ref32, port = _proposed_sweep(jt)
        assert port.shape == oracle.shape == (1, N_JOBS, 25)
        gaps["port"].append(np.abs(port - oracle).ravel())
        gaps["reference"].append(np.abs(ref32 - oracle).ravel())
    count = {k: int((np.concatenate(v) > TOL).sum()) for k, v in gaps.items()}
    worst = {k: float(np.concatenate(v).max()) for k, v in gaps.items()}
    # Each path meets some knife edges (a few cells of 30000, 1e-4 to 3e-3
    # off); everywhere else both agree with the oracle within TOL.
    assert 0 < count["reference"] < 30 and 0 < count["port"] < 30
    assert count["port"] <= count["reference"], (count, worst)
    assert worst["port"] <= worst["reference"] + TOL, (count, worst)
