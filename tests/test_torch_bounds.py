"""The port's capacity bracket (bounds/bracket.py, host float64) against the
JAX package's, on tests/test_bounds.py's fixtures, and the budget clamp:
placements and messages are the same with bounds=True and bounds=False, on
the kernel route, the scan step and a sweep.

The JAX problems reach the port through problem_from_arrays, so these
compare the bracket and the engines, not the encoders.  Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest

from cluster_capacity_tpu import SchedulerProfile as JProfile
from cluster_capacity_tpu import bounds as jbounds
from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu_torch import bounds as tbounds
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.engine import fused as tfused
from cluster_capacity_tpu_torch.engine import simulator as tsim
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from helpers import build_test_node, build_test_pod
from test_torch_encode import port_problem_from


def _nodes(n, seed=0, pods_cap=8):
    """tests/test_bounds.py's _snapshot node list."""
    rng = np.random.RandomState(seed)
    return [build_test_node(
        f"n{i}", int(rng.choice([1000, 2000, 3000])),
        int(rng.choice([2, 4, 8])) * 1024 ** 3, pods_cap,
        labels={"zone": f"z{i % 3}"}) for i in range(n)]


def _probe(cpu=300, mem=256 * 1024 ** 2, spread=None, name="probe"):
    """tests/test_bounds.py's _probe."""
    pod = build_test_pod(name, cpu, mem, labels={"app": name})
    if spread is not None:
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": spread, "topologyKey": "zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": name}},
        }]
    return pod


def _both(node_list, probe, settings=None):
    """(JAX problem, port problem through problem_from_arrays)."""
    settings = settings or (lambda p: p)
    jpb = jenc.encode_problem(JSnap.from_objects(node_list),
                              j_default_pod(probe), settings(JProfile()))
    tpb = tenc.encode_problem(TSnap.from_objects(node_list),
                              t_default_pod(probe), settings(TProfile()))
    return jpb, port_problem_from(jpb, tpb)


def _assert_same_bracket(jpb, tpb):
    jb, tb = jbounds.bracket_host(jpb), tbounds.bracket_host(tpb)
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    assert tbounds.upper_bound_host(tpb) == jbounds.upper_bound_host(jpb)
    assert tbounds.exact_capacity(tpb) == jbounds.exact_capacity(jpb)
    assert tbounds.exhausted_fit_counts(tpb) == \
        jbounds.exhausted_fit_counts(jpb)
    return tb


def _same_solve(a, b):
    assert a.placements == b.placements
    assert (a.fail_type, a.fail_message, a.fail_counts) == \
        (b.fail_type, b.fail_message, b.fail_counts)


def _fuzz_trials(count=12):
    """tests/test_bounds.py's fuzz shapes, drawn in its order: (nodes,
    probe) per trial.  Its alive masks are left out: they fold in the
    resilience analyzer's failure overlay, which this package does not
    encode yet."""
    rng = np.random.RandomState(42)
    out = []
    for trial in range(count):
        n = int(rng.randint(3, 9))
        node_list = _nodes(n, seed=trial, pods_cap=int(rng.randint(3, 10)))
        spread = int(rng.choice([0, 0, 1, 2]))
        probe = _probe(cpu=int(rng.choice([200, 450, 700])),
                       mem=int(rng.choice([128, 512])) * 1024 ** 2,
                       spread=spread or None)
        if trial % 3 == 0 and n > 3:
            rng.randint(n)
        out.append((node_list, probe))
    return out


@pytest.mark.parametrize("trial", range(12))
def test_bracket_matches_jax_on_fuzz(trial):
    """The port's bracket equals the JAX package's field for field,
    brackets the port's solve, and the clamped solve equals the unclamped
    one."""
    jpb, tpb = _both(*_fuzz_trials()[trial])
    br = _assert_same_bracket(jpb, tpb)
    assert 0 <= br.lower <= br.upper
    unclamped = tsim.solve(tpb, bounds=False, device="cpu")
    assert br.lower <= unclamped.placed_count <= br.upper
    _same_solve(tsim.solve(tpb, bounds=True, device="cpu"), unclamped)


def test_bracket_tight_and_spread_match_jax():
    jpb, tpb = _both(_nodes(6, seed=3), _probe())
    br = _assert_same_bracket(jpb, tpb)
    assert br.exact and br.tight
    assert br.upper == tsim.solve(tpb, bounds=False,
                                  device="cpu").placed_count
    jpb, tpb = _both(_nodes(9, seed=5), _probe(spread=1))
    br = _assert_same_bracket(jpb, tpb)
    assert br.lower == 0 and not br.exact
    assert tsim.solve(tpb, bounds=False, device="cpu").placed_count \
        <= br.upper < tbounds.UNBOUNDED


def test_bracket_sentinels_match_jax():
    """Fit filter off -> no finite bound; a pod-level rejection -> [0, 0]."""
    def no_fit(p):
        p.filters = [f for f in p.filters if f != "NodeResourcesFit"]
        return p
    jpb, tpb = _both(_nodes(4), _probe(), settings=no_fit)
    br = _assert_same_bracket(jpb, tpb)
    assert (br.lower, br.upper, br.method) == (0, tbounds.UNBOUNDED,
                                               "no_fit")
    gated = _probe()
    gated["spec"]["schedulingGates"] = [{"name": "wait"}]
    jpb, tpb = _both(_nodes(4), gated)
    br = _assert_same_bracket(jpb, tpb)
    assert (br.lower, br.upper, br.method) == (0, 0, "pod_level")


def test_exhausted_fit_counts_matches_jax_and_solve():
    jpb, tpb = _both(_nodes(7, seed=9), _probe())
    _assert_same_bracket(jpb, tpb)
    counts = tbounds.exhausted_fit_counts(tpb)
    assert counts is not None
    res = tsim.solve(tpb, bounds=False, device="cpu")
    assert res.fail_message == tsim.format_fit_error(7, counts)


@pytest.mark.parametrize("mode", ["kernel", "parity", "random"])
def test_budget_clamp_keeps_results(mode):
    """bounds=True and bounds=False give the same placements and messages,
    unlimited and at a limit past capacity, on the kernel route (float32,
    deterministic) and on the scan step (parity, random tie-break)."""
    def settings(p):
        if mode == "parity":
            p.compute_dtype = "float64"
        if mode == "random":
            p.deterministic, p.seed = False, 5
        return p
    _jpb, tpb = _both(_nodes(9, seed=7), _probe(spread=2), settings)
    cfg = tsim.static_config(tpb)
    assert tfused.eligible(cfg, tpb) == (mode == "kernel")
    budget = tsim.step_budget(tpb)
    assert budget == tbounds.upper_bound_host(tpb) + 1 \
        < tsim.step_budget(tpb, bounds=False)
    for limit in (0, 500):
        a = tsim.solve(tpb, max_limit=limit, bounds=True, device="cpu")
        b = tsim.solve(tpb, max_limit=limit, bounds=False, device="cpu")
        _same_solve(a, b)
        assert a.fail_type == "Unschedulable"


@pytest.mark.parametrize("dtype64", [False, True], ids=["float32", "parity"])
def test_sweep_group_budget_clamp_keeps_results(dtype64):
    """A sweep group (the batched kernel in float32, the scan step per
    template under parity) with and without the group budget clamp."""
    node_list = _nodes(9, seed=7)
    pods = [t_default_pod(_probe(cpu=c, spread=s, name=f"t{c}"))
            for c, s in ((300, 2), (450, 1))]
    profile = TProfile.parity() if dtype64 else TProfile()
    pbs = [tenc.encode_problem(TSnap.from_objects(node_list), p, profile)
           for p in pods]
    assert tsweep._group_budget(pbs, 0, True) < \
        tsweep._group_budget(pbs, 0, False)
    runs = [tsweep.sweep(TSnap.from_objects(node_list), pods,
                         profile=profile, bounds=b, device="cpu")
            for b in (True, False)]
    for a, b in zip(*runs):
        _same_solve(a, b)
        assert a.rung == b.rung == "fused_batched"
