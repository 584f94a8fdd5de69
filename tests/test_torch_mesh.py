"""The port's device mesh (parallel/mesh.py: the node-sharded step, the
sharded group rung, the sharded bracket, --mesh) against the JAX package's
mesh on the CPU, in the same process.

tests/test_multichip.py's cases and tests/test_mesh_padding.py's
non-interleave cases run at meshes 1x1, 2x4, 4x2 and 8x1 — the JAX package
on the suite's 8 virtual CPU devices, the port on B×N logical shards of the
CPU — under SchedulerProfile.parity() and the float32 default, with the
deterministic and the random tie-break.  Each sharded answer must equal the
JAX package's sharded answer and the port's unsharded one: placements, fail
type, message, rung, `degraded`, `status.mesh`, report bytes.  Tolerance:
exact, but the bracket's LP value `frac` (a float32 sum over nodes, added
in shard order) within a few float32 ulps; its `lower`, `upper`, `exact`
and `method` exact.
"""

import dataclasses
import json

import numpy as np
import pytest

from cluster_capacity_tpu import bounds as jbounds
from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.parallel import mesh as jmesh
from cluster_capacity_tpu.parallel import sweep as jsweep
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch import bounds as tbounds
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.engine import simulator as tsim
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.parallel import mesh as tmesh
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from helpers import build_test_node, build_test_pod

MESHES = [(1, 1), (2, 4), (4, 2), (8, 1)]
MESH_IDS = [f"{b}x{n}" for b, n in MESHES]
PROFILES = ["parity", "float32"]
TIES = ["deterministic", "random"]


def _jmesh(b, n):
    return jmesh.make_mesh(n_node_shards=n, n_batch_shards=b)


def _tmesh(b, n):
    return tmesh.make_mesh(n_node_shards=n, n_batch_shards=b, device="cpu")


def _nodes(n_nodes, seed=0):
    """tests/test_multichip.py's _snapshot node list."""
    rng = np.random.RandomState(seed)
    return [build_test_node(
        f"n{i:03d}", int(rng.choice([2000, 4000, 8000])),
        int(rng.choice([8, 16])) * 1024 ** 3, 30,
        labels={"kubernetes.io/hostname": f"n{i:03d}",
                "topology.kubernetes.io/zone": f"z{i % 3}"})
        for i in range(n_nodes)]


def _probe(spread=False, name="probe"):
    """tests/test_multichip.py's _probe, as the raw pod."""
    pod = build_test_pod(name, 300, 512 * 1024 ** 2, labels={"app": name})
    if spread:
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 2, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": name}}}]
    return pod


def _profiles(kind="parity", tie="deterministic"):
    out = []
    for cls in (JProfile, TProfile):
        p = cls.parity() if kind == "parity" else cls()
        p.deterministic = tie == "deterministic"
        out.append(p)
    return out


def _problems(nodes, pod, masks, kind="parity", tie="deterministic"):
    """(JAX problems, port problems): one per alive mask."""
    jprof, tprof = _profiles(kind, tie)
    jsnap, tsnap = JSnap.from_objects(nodes), TSnap.from_objects(nodes)
    jpbs = [jenc.encode_problem(jsnap, j_default_pod(pod), jprof,
                                alive_mask=m) for m in masks]
    tpbs = [tenc.encode_problem(tsnap, t_default_pod(pod), tprof,
                                alive_mask=m) for m in masks]
    return jpbs, tpbs


def _random_masks(rng, n_nodes, count):
    masks = []
    for _ in range(count):
        m = np.ones(n_nodes, dtype=bool)
        dead = rng.choice(n_nodes, size=rng.randint(0, 4), replace=False)
        m[dead] = False
        masks.append(m)
    return masks


def _key(r):
    return (list(r.placements), r.placed_count, r.fail_type, r.fail_message)


def _assert_same(want, got, what):
    for i, (a, b) in enumerate(zip(want, got)):
        assert _key(a) == _key(b), (what, i)
    assert len(want) == len(got), what


# --- the sharded group: tests/test_multichip.py ----------------------------

@pytest.mark.parametrize("tie", TIES)
@pytest.mark.parametrize("kind", PROFILES)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("n_nodes,spread", [(21, False), (37, True)])
def test_sharded_masked_group_fuzz(n_nodes, spread, mesh, kind, tie):
    """Random alive masks, bounds on and off, node counts that do not
    divide the node shards and 3 problems that do not divide the batch
    shards: the port's sharded group == the JAX package's sharded group ==
    the port's unsharded group."""
    nodes, pod = _nodes(n_nodes, seed=n_nodes), _probe(spread=spread)
    masks = _random_masks(np.random.RandomState(7), n_nodes, count=3)
    bounds = spread            # one setting each, both covered
    jpbs, tpbs = _problems(nodes, pod, masks, kind, tie)
    want = jsweep.solve_group(jpbs, max_limit=24, mesh=_jmesh(*mesh),
                              bounds=bounds)
    got = tsweep.solve_group(tpbs, max_limit=24, mesh=_tmesh(*mesh),
                             bounds=bounds, device="cpu")
    _assert_same(want, got, "sharded")
    plain = tsweep.solve_group(tpbs, max_limit=24, bounds=bounds,
                               device="cpu")
    _assert_same(plain, got, "unsharded")


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_alive_mask_changes_on_a_fixed_mesh(mesh):
    """tests/test_multichip.py's zero-recompile case: solves on one mesh
    with the alive masks changing between them equal the JAX package's;
    the port's eager sharded step compiles nothing, so the compile counter
    stays flat (where the JAX package shows its sharded runner compiling
    once)."""
    from cluster_capacity_tpu_torch import obs as tobs
    from cluster_capacity_tpu_torch.obs import names as tnames
    from cluster_capacity_tpu_torch.utils.metrics import default_registry
    nodes, pod = _nodes(24, seed=3), _probe()
    rng = np.random.RandomState(11)
    jm, tm = _jmesh(*mesh), _tmesh(*mesh)
    tobs.install_recompile_hook()
    before = default_registry.counter_total(tnames.RECOMPILES)
    for _ in range(2):
        jpbs, tpbs = _problems(nodes, pod, _random_masks(rng, 24, 4))
        _assert_same(jsweep.solve_group(jpbs, max_limit=16, mesh=jm),
                     tsweep.solve_group(tpbs, max_limit=16, mesh=tm,
                                        device="cpu"), "mask change")
    assert default_registry.counter_total(tnames.RECOMPILES) == before


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_sharded_fault_degrades_to_batched(mesh):
    """parallel.sharded:oom falls back to the unsharded batched rung: the
    same answers, stamped fused_batched and degraded, in both packages."""
    from cluster_capacity_tpu.runtime import degrade as jdegrade
    from cluster_capacity_tpu.runtime import faults as jfaults
    from cluster_capacity_tpu_torch.runtime import degrade as tdegrade
    from cluster_capacity_tpu_torch.runtime import faults as tfaults
    nodes, pod = _nodes(16, seed=5), _probe()
    masks = [np.ones(16, dtype=bool) for _ in range(3)]
    for i, m in enumerate(masks):
        m[i] = False
    jpbs, tpbs = _problems(nodes, pod, masks)
    reference = tdegrade.solve_group_guarded(tpbs, max_limit=12,
                                             device="cpu")
    with jfaults.inject("parallel.sharded:oom"):
        want = jdegrade.solve_group_guarded(jpbs, max_limit=12,
                                            mesh=_jmesh(*mesh))
    with tfaults.inject("parallel.sharded:oom"):
        got = tdegrade.solve_group_guarded(tpbs, max_limit=12,
                                           mesh=_tmesh(*mesh), device="cpu")
    _assert_same(want, got, "jax")
    _assert_same(reference, got, "unsharded")
    for w, g in zip(want, got):
        assert (g.rung, g.degraded) == (w.rung, w.degraded) == \
            (tdegrade.RUNG_BATCHED, True)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_sharded_clean_run_stamps_sharded_rung(mesh):
    from cluster_capacity_tpu.runtime import degrade as jdegrade
    from cluster_capacity_tpu_torch.runtime import degrade as tdegrade
    nodes, pod = _nodes(16, seed=6), _probe()
    jpbs, tpbs = _problems(nodes, pod, [np.ones(16, dtype=bool)])
    want = jdegrade.solve_group_guarded(jpbs, max_limit=8,
                                        mesh=_jmesh(*mesh))
    got = tdegrade.solve_group_guarded(tpbs, max_limit=8,
                                       mesh=_tmesh(*mesh), device="cpu")
    _assert_same(want, got, "jax")
    assert (got[0].rung, got[0].degraded) == \
        (want[0].rung, want[0].degraded) == (tdegrade.RUNG_SHARDED, False)


def _ulps(a, b):
    fa, fb = np.float32(a), np.float32(b)
    return abs(int(fa.view(np.int32)) - int(fb.view(np.int32)))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_sharded_bracket_group_parity_uneven_nodes(mesh):
    """37 nodes on the node shards: the sharded shot's lower, upper, exact
    and method equal the port's unsharded shot, the JAX package's unsharded
    shot and its sharded one; frac (float32, summed in shard order) within
    8 float32 ulps of each.  The JAX package's own sharded-vs-unsharded
    test holds frac exactly and fails on it (460.0000305 vs 460.0)."""
    nodes, pod = _nodes(37, seed=9), _probe(spread=True)
    masks = _random_masks(np.random.RandomState(2), 37, 3)
    jpbs, tpbs = _problems(nodes, pod, masks)
    jplain, d0 = jbounds.bracket_group(jpbs)
    jshard, d1 = jbounds.bracket_group(jpbs, mesh=_jmesh(*mesh))
    plain, d2 = tbounds.bracket_group(tpbs, device="cpu")
    got, d3 = tbounds.bracket_group(tpbs, mesh=_tmesh(*mesh), device="cpu")
    assert not (d0 or d1 or d2 or d3)
    for g, p, jp, js in zip(got, plain, jplain, jshard):
        exact = lambda b: (b.lower, b.upper, b.exact, b.method)
        assert exact(g) == exact(p) == exact(jp) == exact(js)
        assert max(_ulps(g.frac, x.frac) for x in (p, jp, js)) <= 8


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_analyzer_report_and_spans_carry_mesh(mesh):
    """status.mesh rides the report (and its dict round trip), the rows
    equal the JAX package's sharded sweep, and the sharded guard spans
    carry the mesh shape and the per-shard batch."""
    from cluster_capacity_tpu.resilience import analyzer as janalyzer
    from cluster_capacity_tpu.resilience import scenarios as jscen
    from cluster_capacity_tpu_torch import obs as tobs
    from cluster_capacity_tpu_torch.resilience import analyzer as tanalyzer
    from cluster_capacity_tpu_torch.resilience import scenarios as tscen
    nodes, pod = _nodes(12, seed=1), _probe()
    jsnap, tsnap = JSnap.from_objects(nodes), TSnap.from_objects(nodes)
    want = janalyzer.analyze(jsnap, jscen.single_node_scenarios(jsnap),
                             j_default_pod(pod), max_limit=8,
                             mesh=_jmesh(*mesh), keep_placements=True)
    got = tanalyzer.analyze(tsnap, tscen.single_node_scenarios(tsnap),
                            t_default_pod(pod), max_limit=8,
                            mesh=_tmesh(*mesh), keep_placements=True,
                            device="cpu")
    shape = {"batch": mesh[0], "nodes": mesh[1]}
    assert got.mesh == want.mesh == shape
    assert tanalyzer.SurvivabilityReport.from_dict(
        got.to_dict()).mesh == shape
    assert got.to_dict() == want.to_dict()
    spans = [sp for sp in tobs.default_collector.spans()
             if sp.site == "parallel.sharded"
             and sp.attrs.get("mesh_shape")]
    assert spans, "no guard span recorded for the sharded rung"
    sp = spans[-1]
    assert sp.attrs["mesh_shape"] == shape
    assert sp.attrs["per_shard_batch"] == -(-int(sp.batch) // mesh[0])


@pytest.mark.parametrize("tie", TIES)
@pytest.mark.parametrize("kind", PROFILES)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_framework_single_pod_mesh_parity(mesh, kind, tie):
    """ClusterCapacity(mesh=...): the one-template sharded group equals
    the JAX package's and the port's unsharded estimate."""
    from cluster_capacity_tpu import ClusterCapacity as JCC
    from cluster_capacity_tpu_torch import ClusterCapacity as TCC
    nodes, pod = _nodes(16, seed=4), _probe(spread=True)
    jprof, tprof = _profiles(kind, tie)
    runs = []
    for cc in (JCC(j_default_pod(pod), max_limit=20, profile=jprof,
                   mesh=_jmesh(*mesh)),
               TCC(t_default_pod(pod), max_limit=20, profile=tprof,
                   mesh=_tmesh(*mesh), device="cpu"),
               TCC(t_default_pod(pod), max_limit=20, profile=tprof,
                   device="cpu")):
        cc.sync_with_objects(nodes)
        r = cc.run()
        runs.append((_key(r), r.rung, r.degraded))
    assert runs[0] == runs[1]
    assert runs[1][0] == runs[2][0]
    assert runs[1][1:] == ("sharded_batched", False)


# --- the sampling window on node shards -----------------------------------

# (nodes, percentageOfNodesToScore, adaptive sampling): 203 and 250 nodes do
# not divide 4 or 8 node shards (pads to 204/208 and 252/256).
SAMPLED = [(203, 30, False), (250, 50, False), (203, 100, True)]
SAMPLED_IDS = ["n203-pct30", "n250-pct50", "n203-adaptive"]


def _sampled_problems(n_nodes, pct, adaptive, tie, count):
    """`count` problems of the spread probe on `n_nodes` nodes, two dead
    nodes each (one sample size for the group), scoring `pct` percent of
    the nodes or sampling adaptively."""
    nodes, pod = _nodes(n_nodes, seed=n_nodes), _probe(spread=True)
    rng = np.random.RandomState(n_nodes + pct)
    masks = []
    for _ in range(count):
        m = np.ones(n_nodes, dtype=bool)
        m[rng.choice(n_nodes, size=2, replace=False)] = False
        masks.append(m)
    jprof, tprof = _profiles("float32", tie)
    for p in (jprof, tprof):
        p.percentage_of_nodes_to_score = pct
        p.adaptive_sampling = adaptive
    jsnap, tsnap = JSnap.from_objects(nodes), TSnap.from_objects(nodes)
    jpbs = [jenc.encode_problem(jsnap, j_default_pod(pod), jprof,
                                alive_mask=m) for m in masks]
    tpbs = [tenc.encode_problem(tsnap, t_default_pod(pod), tprof,
                                alive_mask=m) for m in masks]
    return nodes, pod, (jprof, tprof), jpbs, tpbs


@pytest.mark.parametrize("tie", TIES)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("n_nodes,pct,adaptive", SAMPLED, ids=SAMPLED_IDS)
def test_sharded_sampling_window(n_nodes, pct, adaptive, mesh, tie):
    """The rotating sample window on node shards (the K-th feasible node
    found from per-shard counts, the start index taken modulo the padded
    node count, as in the JAX package's sharded step): a group of three
    through the sharded rung, and one pod through ClusterCapacity(mesh=),
    equal the JAX package's sharded answers and the port's unsharded
    ones — placements, fail type, message, rung and `degraded`."""
    from cluster_capacity_tpu import ClusterCapacity as JCC
    from cluster_capacity_tpu.runtime import degrade as jdegrade
    from cluster_capacity_tpu_torch import ClusterCapacity as TCC
    from cluster_capacity_tpu_torch.runtime import degrade as tdegrade
    nodes, pod, (jprof, tprof), jpbs, tpbs = _sampled_problems(
        n_nodes, pct, adaptive, tie, count=3)
    k = tsim.static_config(tpbs[0]).sample_k
    assert 0 < k < n_nodes - 2, k          # the window truncates
    limit = 30                             # the window wraps many times
    want = jdegrade.solve_group_guarded(jpbs, max_limit=limit,
                                        mesh=_jmesh(*mesh))
    got = tdegrade.solve_group_guarded(tpbs, max_limit=limit,
                                       mesh=_tmesh(*mesh), device="cpu")
    _assert_same(want, got, "jax")
    _assert_same(tsweep.solve_group(tpbs, max_limit=limit, device="cpu"),
                 got, "unsharded")
    assert {(g.rung, g.degraded) for g in got} == \
        {(w.rung, w.degraded) for w in want} == {(tdegrade.RUNG_SHARDED,
                                                   False)}
    runs = []
    for cc in (JCC(j_default_pod(pod), max_limit=limit, profile=jprof,
                   mesh=_jmesh(*mesh)),
               TCC(t_default_pod(pod), max_limit=limit, profile=tprof,
                   mesh=_tmesh(*mesh), device="cpu"),
               TCC(t_default_pod(pod), max_limit=limit, profile=tprof,
                   device="cpu")):
        cc.sync_with_objects(nodes)
        r = cc.run()
        runs.append((_key(r), r.rung, r.degraded))
    assert runs[0] == runs[1]
    assert runs[1][0] == runs[2][0]


# --- padding: tests/test_mesh_padding.py -----------------------------------

def test_pad_rows_are_inert_by_construction():
    """The node pad rows carry the inert fills (domain maps -1, missing and
    ignored flags 1, ss_slots its row's slot 0, everything else 0) and
    equal the JAX package's padded group consts (its shardgate seam) key by
    key; pad items of a short mesh row are left out."""
    nodes = _nodes(13, seed=5)
    jprof, tprof = _profiles()
    jsnap, tsnap = JSnap.from_objects(nodes), TSnap.from_objects(nodes)
    pods = [_probe(spread=True, name=f"p{i}") for i in range(3)]
    jpbs = [jenc.encode_problem(jsnap, j_default_pod(p), jprof)
            for p in pods]
    tpbs = [tenc.encode_problem(tsnap, t_default_pod(p), tprof)
            for p in pods]
    seam = jsweep.solve_group(jpbs, max_limit=8, mesh=_jmesh(2, 4),
                              lower_only=True)
    assert (seam["meta"]["n_pad"], seam["meta"]["b_pad"]) == (16, 4)
    mesh = _tmesh(2, 4)
    assert tmesh.batch_rows(mesh, 3) == [[0, 1], [2]]
    for b, pb in enumerate(tpbs):
        host = {**tsim.host_consts(pb), **tsim._step_host_consts(pb)}
        carry = tsim._host_carry(pb, host)
        padded, pcarry = tmesh.pad_for_mesh(mesh, host, carry)
        assert pcarry.placed.shape[0] == 16
        for key, v in padded.items():
            ax = tmesh._NODE_AXIS_OF.get(key)
            if ax is None:
                assert v is host[key], key
                continue
            region = np.take(v, range(13, 16), axis=ax)
            if key == "ss_slots":
                d = host["ss_present0"].shape[1]
                want = np.arange(v.shape[0])[:, None] * d
                assert np.all(region == want), key
                continue
            fill = -1 if key in tmesh._PAD_NEG else \
                (1 if key in tmesh._PAD_ONE else 0)
            assert np.all(region == fill), key
            if key in seam["consts"]:
                jv = np.asarray(seam["consts"][key])[b]
                assert np.array_equal(jv.astype(v.dtype), v), key


@pytest.mark.parametrize("tie", TIES)
def test_more_batch_shards_than_problems(tie):
    """An 8-way batch mesh over 3 problems: 5 of 8 mesh rows get nothing."""
    nodes, pod = _nodes(13, seed=1), _probe()
    masks = _random_masks(np.random.RandomState(3), 13, count=3)
    jpbs, tpbs = _problems(nodes, pod, masks, tie=tie)
    want = jsweep.solve_group(jpbs, max_limit=16, mesh=_jmesh(8, 1))
    got = tsweep.solve_group(tpbs, max_limit=16, mesh=_tmesh(8, 1),
                             device="cpu")
    _assert_same(want, got, "jax")
    _assert_same(tsweep.solve_group(tpbs, max_limit=16, device="cpu"), got,
                 "unsharded")


@pytest.mark.parametrize("n_nodes", [8, 9])
def test_single_row_node_shards(n_nodes):
    """An 8-way node mesh whose shards hold one real row each (n=8) or
    mostly one row and pure pad (n=9 -> 16): the pad rows are invisible,
    with bounds off and on."""
    nodes, pod = _nodes(n_nodes, seed=n_nodes), _probe(spread=True)
    masks = _random_masks(np.random.RandomState(n_nodes), n_nodes, count=2)
    for bounds in (False, True):
        jpbs, tpbs = _problems(nodes, pod, masks)
        want = jsweep.solve_group(jpbs, max_limit=12, mesh=_jmesh(1, 8),
                                  bounds=bounds)
        got = tsweep.solve_group(tpbs, max_limit=12, mesh=_tmesh(1, 8),
                                 bounds=bounds, device="cpu")
        _assert_same(want, got, ("jax", bounds))
        _assert_same(tsweep.solve_group(tpbs, max_limit=12, bounds=bounds,
                                        device="cpu"), got,
                     ("unsharded", bounds))


# --- classification --------------------------------------------------------

def _consts_keys():
    """Every key build_consts makes, over problems that switch on every
    family (spread hard and soft, IPA, DRA-free), and the interleave
    engine's per-template gates."""
    keys = set()
    nodes = _nodes(9, seed=2)
    tsnap = TSnap.from_objects(nodes)
    pod = _probe(spread=True)
    pod["spec"]["affinity"] = {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "topologyKey": "kubernetes.io/hostname",
            "labelSelector": {"matchLabels": {"app": "probe"}}}]}}
    for p in (_probe(), pod):
        pb = tenc.encode_problem(tsnap, t_default_pod(p), TProfile())
        keys |= set(tsim.build_consts(pb, "cpu"))
    return keys | {"vol_self_gate", "rwop_gate", "dra_colo_gate"}


def test_every_consts_key_is_classified():
    """No consts key falls through to replication unseen: each has a
    sharding family, each node-axis family has its axis, and shard_consts
    refuses a key it does not know."""
    for key in sorted(_consts_keys()):
        fam = tmesh.classify_const(key)
        assert fam is not None, key
        assert (fam == "replicated") == (key not in tmesh._NODE_AXIS_OF), key
    pb = tenc.encode_problem(TSnap.from_objects(_nodes(8)),
                             t_default_pod(_probe()), TProfile())
    host = {**tsim.host_consts(pb), **tsim._step_host_consts(pb)}
    host["mystery_plane"] = np.zeros(8)
    with pytest.raises(ValueError, match="mystery_plane"):
        tmesh.shard_consts(_tmesh(1, 2), host, 0, 0)


def test_parse_mesh_and_device_checks():
    """parse_mesh's specs and messages are the JAX package's; on the CPU a
    spec takes B×N logical shards and 'auto' is unsharded; without enough
    cards a spec raises the JAX package's ValueError; a mesh serves only
    its own device type."""
    for text in ("", "none", "OFF"):
        assert tmesh.parse_mesh(text, device="cpu") is None
    assert tmesh.parse_mesh("auto", device="cpu") is None
    assert tmesh.mesh_shape(tmesh.parse_mesh("2x4", device="cpu")) == \
        jmesh.mesh_shape(jmesh.parse_mesh("2x4")) == {"batch": 2, "nodes": 4}
    for bad in ("2y4", "x4", "auto2"):
        with pytest.raises(ValueError) as jerr:
            jmesh.parse_mesh(bad)
        with pytest.raises(ValueError) as terr:
            tmesh.parse_mesh(bad, device="cpu")
        assert str(terr.value) == str(jerr.value)
    cards = tsim.torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"mesh 2x2 needs 4 devices, "
                                         f"have {cards}"):
        tmesh.parse_mesh("2x2", device="cuda")
    with pytest.raises(ValueError, match="mesh 3x3 needs 9 devices, have 8"):
        jmesh.parse_mesh("3x3")
    pb = tenc.encode_problem(TSnap.from_objects(_nodes(8)),
                             t_default_pod(_probe()), TProfile())
    with pytest.raises(ValueError, match="do not match"):
        tsim.solve(pb, device="cpu", mesh=tmesh.Mesh([["cuda:0"]]))


# --- the CLIs --------------------------------------------------------------

REPO = __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__)))
SNAPSHOT = f"{REPO}/examples/cluster-snapshot.yaml"
PODSPECS = [f"{REPO}/examples/pod.yaml", f"{REPO}/examples/pod-spec.yaml"]


def _cli(run, argv, capsys):
    rc = run(list(argv))
    cap = capsys.readouterr()
    return rc, cap.out


@pytest.mark.parametrize("argv", [
    ["cluster-capacity", "--podspec", PODSPECS[0], "--verbose"],
    ["cluster-capacity", "--podspec", PODSPECS[0], "-o", "json"],
    ["cluster-capacity", "--podspec", PODSPECS[0], "--podspec",
     PODSPECS[1], "--max-limit", "30", "-o", "yaml"],
    ["cluster-capacity", "--podspec", PODSPECS[0], "--podspec",
     PODSPECS[1], "--parity", "--verbose"],
    ["resilience", "--verbose"],
    ["resilience", "--nodes", "--no-dedup", "--no-bounds", "-o", "json"],
    ["serve", "--podspec", PODSPECS[0], "--podspec", PODSPECS[1],
     "--iterations", "2", "--verbose"],
], ids=["cc-verbose", "cc-json", "sweep-yaml", "sweep-parity", "res",
        "res-json", "serve"])
def test_cli_byte_equal_at_2x4(argv, capsys):
    """`--mesh 2x4 --device cpu` prints the JAX CLI's `--mesh 2x4` bytes
    (creation timestamps dropped) and exits as it does."""
    from cluster_capacity_tpu.cli import hypercc as jhypercc
    from cluster_capacity_tpu_torch.cli import hypercc as thypercc
    argv = argv + ["--snapshot", SNAPSHOT, "--mesh", "2x4"]
    want = _cli(jhypercc.run, argv, capsys)
    got = _cli(thypercc.run, argv + ["--device", "cpu"], capsys)
    drop = lambda out: [x for x in out.splitlines()
                        if "creationTimestamp" not in x]
    assert got[0] == want[0] == 0
    assert drop(got[1]) == drop(want[1])


def test_cli_mesh_refusals_and_errors(capsys):
    """A bad spec exits 1 with the JAX message; --interleave together with
    --mesh 2x4 runs the sharded race and prints the JAX CLI's -o json
    report (creation timestamps dropped)."""
    from cluster_capacity_tpu.cli import hypercc as jhypercc
    from cluster_capacity_tpu_torch.cli import hypercc as thypercc
    for sub in (["cluster-capacity", "--podspec", PODSPECS[0]],
                ["resilience"],
                ["serve", "--podspec", PODSPECS[0]]):
        argv = sub + ["--snapshot", SNAPSHOT, "--mesh", "2by4"]
        assert jhypercc.run(list(argv)) == 1
        jerr = capsys.readouterr().err
        assert thypercc.run(argv + ["--device", "cpu"]) == 1
        assert capsys.readouterr().err == jerr
    argv = ["cluster-capacity", "--podspec", PODSPECS[0], "--podspec",
            PODSPECS[1], "--snapshot", SNAPSHOT, "--interleave", "--mesh",
            "2x4", "-o", "json"]
    want = _cli(jhypercc.run, argv, capsys)
    got = _cli(thypercc.run, argv + ["--device", "cpu"], capsys)
    drop = lambda out: [x for x in out.splitlines()
                        if "creationTimestamp" not in x]
    assert got[0] == want[0] == 0
    assert drop(got[1]) == drop(want[1])
    assert len(json.loads(got[1])["status"]["pods"]) == 2
