"""The port's capacity bracket (bounds/bracket.py: host float64 and the
batched float32 device shot) against the JAX package's, on
tests/test_bounds.py's fixtures, and the budget clamp: placements and
messages are the same with bounds=True and bounds=False, on the kernel
route, the scan step and a sweep.

The JAX problems reach the port through problem_from_arrays, so these
compare the bracket and the engines, not the encoders.  The device half is
held against the JAX package's unsharded bracket_group (its sharded one
fails its own parity test at uneven node counts).  Tolerance: exact.
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


def _both(node_list, probe, settings=None, alive=None):
    """(JAX problem, port problem through problem_from_arrays)."""
    settings = settings or (lambda p: p)
    jpb = jenc.encode_problem(JSnap.from_objects(node_list),
                              j_default_pod(probe), settings(JProfile()),
                              alive_mask=alive)
    tpb = tenc.encode_problem(TSnap.from_objects(node_list),
                              t_default_pod(probe), settings(TProfile()),
                              alive_mask=alive)
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
    probe, alive mask or None) per trial."""
    rng = np.random.RandomState(42)
    out = []
    for trial in range(count):
        n = int(rng.randint(3, 9))
        node_list = _nodes(n, seed=trial, pods_cap=int(rng.randint(3, 10)))
        spread = int(rng.choice([0, 0, 1, 2]))
        probe = _probe(cpu=int(rng.choice([200, 450, 700])),
                       mem=int(rng.choice([128, 512])) * 1024 ** 2,
                       spread=spread or None)
        alive = None
        if trial % 3 == 0 and n > 3:
            alive = np.ones(n, dtype=bool)
            alive[int(rng.randint(n))] = False
        out.append((node_list, probe, alive))
    return out


@pytest.mark.parametrize("trial", range(12))
def test_bracket_matches_jax_on_fuzz(trial):
    """The port's bracket equals the JAX package's field for field,
    brackets the port's solve, and the clamped solve equals the unclamped
    one."""
    node_list, probe, alive = _fuzz_trials()[trial]
    jpb, tpb = _both(node_list, probe, alive=alive)
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


# ---------------------------------------------------------------------------
# the device half: bracket_device / bracket_group
# ---------------------------------------------------------------------------

def _device_cases():
    """Groups of problems sharing their axes: the fuzz trials one at a
    time (alive masks included), each trial's probe over its nodes with
    every single-node failure (the resilience scenario family, a padded
    batch), spread problems, and the sentinel shapes."""
    cases = [("fuzz%d" % t, [(n, p, a)])
             for t, (n, p, a) in enumerate(_fuzz_trials(20))]
    for t in (1, 4, 7):
        node_list, probe, _ = _fuzz_trials(20)[t]
        group = []
        for d in range(len(node_list)):
            alive = np.ones(len(node_list), dtype=bool)
            alive[d] = False
            group.append((node_list, probe, alive))
        cases.append((f"scenarios{t}", group))
    cases.append(("spread-mix", [(_nodes(9, seed=5), _probe(spread=1), None),
                                 (_nodes(9, seed=5), _probe(), None),
                                 (_nodes(9, seed=5), _probe(spread=2,
                                                            cpu=700), None)]))
    gated = _probe()
    gated["spec"]["schedulingGates"] = [{"name": "wait"}]
    cases.append(("sentinels", [(_nodes(4), gated, None),
                                (_nodes(4), _probe(), None)]))
    return cases


@pytest.mark.parametrize("case", _device_cases(), ids=lambda c: c[0])
def test_bracket_device_matches_jax(case):
    """bracket_device's brackets equal the JAX package's bracket_device
    (lower, upper, exact, method: exact), and bracket_group is undegraded
    and equal to it in both packages.  `frac`, the reported LP value, is a
    float32 sum over the nodes whose order is XLA's reduction in the JAX
    package and torch's here: held to 4 float32 ulps of its size."""
    _name, members = case
    pairs = [_both(n, p, alive=a) for n, p, a in members]
    jpbs, tpbs = [j for j, _ in pairs], [t for _, t in pairs]

    def exact_fields(brs):
        return [(b.lower, b.upper, b.exact, b.method) for b in brs]

    def assert_frac(got, want):
        for g, w in zip(got, want):
            assert abs(g.frac - w.frac) <= 4 * np.spacing(np.float32(
                max(abs(w.frac), 1.0))), (g.frac, w.frac)

    want = jbounds.bracket_device(jpbs)
    got = tbounds.bracket_device(tpbs, device="cpu")
    assert exact_fields(got) == exact_fields(want)
    assert_frac(got, want)
    jgroup, jdeg = jbounds.bracket_group(jpbs)
    tgroup, tdeg = tbounds.bracket_group(tpbs, device="cpu")
    assert (tdeg, exact_fields(tgroup)) == (jdeg, exact_fields(jgroup))
    assert_frac(tgroup, jgroup)
    # A group mixing spread and spread-free problems pads the spread-free
    # rows with constraint rows that fold their upper bound to 0, so the
    # shot disagrees with the host and both packages serve the host
    # brackets, degraded (the JAX package's behaviour, kept).  Every group
    # of one probe — the resilience family — stays undegraded.
    assert tdeg == (_name == "spread-mix")
    for br, tpb in zip(tgroup, tpbs):
        host = tbounds.bracket_host(tpb)
        assert (br.lower, br.upper) == (host.lower, host.upper)


@pytest.mark.parametrize("kind", ["corrupt", "oom"])
def test_bracket_group_fault_degrades_to_host_like_jax(kind):
    """A fault at bounds.bracket serves the host brackets, stamped
    degraded, in both packages (tests/test_bounds.py's chaos drills)."""
    from cluster_capacity_tpu.runtime import faults as jfaults
    from cluster_capacity_tpu_torch.runtime import faults as tfaults
    jpb, tpb = _both(_nodes(6, seed=3), _probe())
    with jfaults.inject(f"bounds.bracket:{kind}"):
        jout = jbounds.bracket_group([jpb])
    with tfaults.inject(f"bounds.bracket:{kind}"):
        tout = tbounds.bracket_group([tpb], device="cpu")
    assert tout[1] is jout[1] is True
    assert [dataclasses.asdict(b) for b in tout[0]] == \
        [dataclasses.asdict(b) for b in jout[0]]


def test_bracket_mesh_refused_by_name():
    """bracket_group over a mesh is served: the sharded shot's lower,
    upper, exact and method equal the unsharded ones and the JAX
    package's, frac within float32 ulps (it adds the shards' float32 sums
    in shard order), undegraded.  The mix's bracket over a mesh is served
    too: the sharded auction's claims equal the unsharded ones, the JAX
    package's sharded ones and the float64 host auction's, and the joint
    bracket equals the JAX package's, undegraded."""
    from cluster_capacity_tpu.parallel import mesh as jmesh
    from cluster_capacity_tpu_torch.parallel import mesh as tmesh
    pairs = [_both(_nodes(7, seed=s), _probe(spread=1)) for s in range(3)]
    jpbs, tpbs = [p[0] for p in pairs], [p[1] for p in pairs]
    want, jdeg = jbounds.bracket_group(jpbs)
    plain, pdeg = tbounds.bracket_group(tpbs, device="cpu")
    got, tdeg = tbounds.bracket_group(
        tpbs, mesh=tmesh.make_mesh(2, 2, device="cpu"), device="cpu")
    assert not (jdeg or pdeg or tdeg)
    for w, p, g in zip(want, plain, got):
        assert (g.lower, g.upper, g.exact, g.method) == \
            (p.lower, p.upper, p.exact, p.method) == \
            (w.lower, w.upper, w.exact, w.method)
        assert np.isclose(np.float32(g.frac), np.float32(p.frac),
                          rtol=4 * np.finfo(np.float32).eps, atol=0)
    mix = [_both(_nodes(7, seed=5), _probe(cpu=c, name=f"p{c}"))
           for c in (300, 500, 700)]
    jmix, tmix = [p[0] for p in mix], [p[1] for p in mix]
    jjoint, jclaims, jdeg = jbounds.bracket_mix(
        jmix, mesh=jmesh.make_mesh(n_node_shards=2, n_batch_shards=2))
    for tm in (tmesh.make_mesh(2, 2, device="cpu"),
               tmesh.make_mesh(4, 1, device="cpu")):
        joint, claims, deg = tbounds.bracket_mix(tmix, mesh=tm, device="cpu")
        assert not (deg or jdeg)
        assert claims == jclaims == tbounds.auction_device(
            tmix, device="cpu") == tbounds.bracket._auction_host(tmix)
        assert dataclasses.asdict(joint) == dataclasses.asdict(jjoint)
