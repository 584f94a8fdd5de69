"""The PyTorch port's problem encoder against the JAX package's.

Every array and scalar of the port's EncodedProblem must equal the JAX
encoder's (np.array_equal, exact), on the repo's fixtures.  encode_both and
port_problem_from are shared with the other test_torch_* files.
"""

import dataclasses
import os

import numpy as np
import pytest
import yaml

from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.ops import pod_topology_spread as jpts
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.ops import pod_topology_spread as tpts
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from helpers import build_test_node, build_test_pod
from test_torch_kernel import (HOST, ZONE, fused_families, nodes, pod,
                               profile_settings, spread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def encode_both(node_list, the_pod, existing=(), objs=None, settings=None):
    """(JAX EncodedProblem, port EncodedProblem) for one fixture."""
    objs = objs or {}
    settings = settings or profile_settings()
    jpb = jenc.encode_problem(
        JSnap.from_objects(node_list, list(existing), **objs),
        j_default_pod(the_pod), settings(JProfile()))
    tpb = tenc.encode_problem(
        TSnap.from_objects(node_list, list(existing), **objs),
        t_default_pod(the_pod), settings(TProfile()))
    return jpb, tpb


def fields_of(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def port_problem_from(jpb, tpb):
    """The JAX encoder's problem as the port's EncodedProblem, through
    problem_from_arrays (snapshot/pod/profile are the port's objects)."""
    d = {}
    for name, v in fields_of(jpb).items():
        if name in ("snapshot", "pod", "profile"):
            v = getattr(tpb, name)
        elif dataclasses.is_dataclass(v):
            v = fields_of(v)
        d[name] = v
    return tenc.problem_from_arrays(d)


def assert_same(a, b, path):
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        fa, fb = fields_of(a), fields_of(b)
        assert set(fa) == set(fb), path
        for k in fa:
            assert_same(fa[k], fb[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


def assert_problems_equal(jpb, tpb):
    jf, tf = fields_of(jpb), fields_of(tpb)
    assert set(jf) == set(tf)
    for name in jf:
        if name in ("snapshot", "profile"):
            continue
        assert_same(jf[name], tf[name], name)
    js, ts = jpb.snapshot, tpb.snapshot
    assert js.node_names == ts.node_names
    assert js.resource_names == ts.resource_names
    for arr in ("allocatable", "requested", "nonzero_requested"):
        assert np.array_equal(getattr(js, arr), getattr(ts, arr)), arr


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", fused_families(), ids=lambda c: c[0])
def test_encode_matches_jax_fused_families(monkeypatch, case):
    # the port carries upstream's system-default constraints (hostname
    # maxSkew 3, zone 5); the JAX package's are held to them here
    monkeypatch.setattr(jpts, "SYSTEM_DEFAULT_CONSTRAINTS",
                        tpts.SYSTEM_DEFAULT_CONSTRAINTS)
    _name, node_list, the_pod, existing, objs, settings = case
    jpb, tpb = encode_both(node_list, the_pod, existing, objs, settings)
    assert_problems_equal(jpb, tpb)


def _helpers_cluster():
    """tests/helpers.py builders: taints, node affinity, images, existing
    pods with hard-spread matches and preferred terms."""
    ns = []
    for i in range(9):
        labels = {HOST: f"h{i}", ZONE: f"z{i % 3}", "disk": "ssd" if i % 2
                  else "hdd"}
        taints = [{"key": "gpu", "value": "true", "effect": "NoSchedule"}] \
            if i == 4 else ([{"key": "spot", "effect": "PreferNoSchedule"}]
                            if i % 4 == 1 else None)
        node = build_test_node(f"h{i}", 4000, 8 * 1024 ** 3, 10,
                               labels=labels, taints=taints,
                               unschedulable=(i == 7))
        node["status"]["images"] = [{"names": ["app:v1"],
                                     "sizeBytes": 300 * 1024 ** 2 * (i % 3)}]
        ns.append(node)
    pods = [build_test_pod(f"e{i}", 500, 1024 ** 3, node_name=f"h{i % 5}",
                           labels={"app": "web"}) for i in range(6)]
    pods[0]["spec"]["affinity"] = {"podAntiAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution": [{
            "weight": 5, "podAffinityTerm": {
                "topologyKey": ZONE,
                "labelSelector": {"matchLabels": {"app": "web"}}}}]}}
    return ns, pods


def test_encode_matches_jax_helpers_cluster():
    ns, pods = _helpers_cluster()
    the_pod = pod(labels={"app": "web"}, cpu="250m", memory="256Mi",
                  topologySpreadConstraints=[
                      spread(ZONE, 1, "DoNotSchedule", "web"),
                      spread(HOST, 2, "ScheduleAnyway", "web")],
                  affinity={
                      "nodeAffinity": {
                          "requiredDuringSchedulingIgnoredDuringExecution": {
                              "nodeSelectorTerms": [{"matchExpressions": [{
                                  "key": "disk", "operator": "In",
                                  "values": ["ssd", "hdd"]}]}]},
                          "preferredDuringSchedulingIgnoredDuringExecution": [{
                              "weight": 20, "preference": {"matchExpressions": [{
                                  "key": "disk", "operator": "In",
                                  "values": ["ssd"]}]}}]},
                      "podAntiAffinity": {
                          "requiredDuringSchedulingIgnoredDuringExecution": [{
                              "topologyKey": HOST,
                              "labelSelector": {"matchLabels": {"app": "x"}}}]}})
    the_pod["spec"]["containers"][0]["image"] = "app:v1"
    the_pod["spec"]["tolerations"] = [{"key": "spot", "operator": "Exists",
                                       "effect": "NoSchedule"}]
    jpb, tpb = encode_both(ns, the_pod, pods)
    assert tpb.node_affinity_active and tpb.image_locality_score.any()
    assert tpb.spread_hard.num_constraints == 1
    assert tpb.spread_soft.num_constraints == 1
    assert (tpb.static_code != 0).any() and tpb.taint_raw.any()
    assert_problems_equal(jpb, tpb)


def test_encode_matches_jax_examples():
    with open(os.path.join(REPO, "examples", "cluster-snapshot.yaml")) as f:
        objs = yaml.safe_load(f)
    with open(os.path.join(REPO, "examples", "pod.yaml")) as f:
        the_pod = yaml.safe_load(f)
    objs = dict(objs)
    node_list, pods = objs.pop("nodes", []), objs.pop("pods", [])
    jpb, tpb = encode_both(node_list, the_pod, pods, objs)
    assert_problems_equal(jpb, tpb)


def test_problem_from_arrays_roundtrip():
    case = fused_families()[4]       # IPA colocate: nested encodings in use
    _name, node_list, the_pod, existing, objs, settings = case
    jpb, tpb = encode_both(node_list, the_pod, existing, objs, settings)
    back = port_problem_from(jpb, tpb)
    assert_problems_equal(tpb, back)
    # round trip through the port's own fields, too
    again = tenc.problem_from_arrays({
        k: (fields_of(v) if dataclasses.is_dataclass(v)
            and k not in ("snapshot", "profile") else v)
        for k, v in fields_of(tpb).items()})
    assert_problems_equal(tpb, again)


# ---------------------------------------------------------------------------
# the resilience failure overlay (alive_mask)
# ---------------------------------------------------------------------------

def _alive_nodes():
    """tests/test_resilience.py's alive-mask fixtures in one cluster: a
    PreferNoSchedule taint and preferred node affinity keep static raw
    scores non-zero, so zeroing them on dead nodes is visible."""
    return [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 8,
                            labels={"tier": "gold" if i % 2 else "x",
                                    ZONE: f"z{i % 3}"},
                            taints=[{"key": "k", "value": "v",
                                     "effect": "PreferNoSchedule"}]
                            if i in (1, 4) else None)
            for i in range(6)]


def _alive_pod():
    the_pod = build_test_pod("probe", 500, 0)
    the_pod["spec"]["affinity"] = {"nodeAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution": [{
            "weight": 3, "preference": {"matchExpressions": [
                {"key": "tier", "operator": "In", "values": ["gold"]}]}}]}}
    return the_pod


@pytest.mark.parametrize("alive", [
    [True, False, True, False, True, True],
    [False, True, True, True, False, True],
    [True] * 6,
], ids=["two-dead", "taint-dead", "all-alive"])
def test_encode_alive_mask_matches_jax(alive):
    """encode_problem(alive_mask=...) folds CODE_NODE_FAILED first, zeroes
    the dead nodes' static raws, drops them from the step hint and sets
    num_alive, field for field as the JAX encoder."""
    node_list, the_pod = _alive_nodes(), _alive_pod()
    mask = np.array(alive)
    jpb = jenc.encode_problem(JSnap.from_objects(node_list),
                              j_default_pod(the_pod), JProfile(),
                              alive_mask=mask)
    tpb = tenc.encode_problem(TSnap.from_objects(node_list),
                              t_default_pod(the_pod), TProfile(),
                              alive_mask=mask)
    assert_problems_equal(jpb, tpb)
    assert tpb.num_alive == int(mask.sum())
    dead = ~mask
    assert (tpb.static_code[dead] == tenc.CODE_NODE_FAILED).all()
    assert not tpb.static_mask[dead].any()
    assert not tpb.taint_raw[dead].any()
    assert not tpb.node_affinity_raw[dead].any()
    assert tenc.STATIC_REASONS[tenc.CODE_NODE_FAILED] == \
        jenc.STATIC_REASONS[jenc.CODE_NODE_FAILED]


def test_encode_alive_mask_shape_checked():
    snap = TSnap.from_objects(_alive_nodes())
    with pytest.raises(ValueError, match="alive_mask shape"):
        tenc.encode_problem(snap, t_default_pod(_alive_pod()), TProfile(),
                            alive_mask=np.ones(3, dtype=bool))


def test_encode_problems_shared_alive_memo_matches_jax():
    """The shared-encode memo keys masks by value, and an all-alive mask
    shares the unmasked entry, in both packages; the memoised problems
    equal the JAX package's."""
    node_list = _alive_nodes()
    tpls = [_alive_pod(), build_test_pod("other", 300, 0)]
    jsnap, tsnap = JSnap.from_objects(node_list), TSnap.from_objects(node_list)
    jt = [j_default_pod(t) for t in tpls]
    tt = [t_default_pod(t) for t in tpls]
    jprof, tprof = JProfile(), TProfile()
    dead = np.array([True, True, False, True, True, True])
    for mask in (None, np.ones(6, dtype=bool), dead, dead.copy()):
        jpbs = jenc.encode_problems_shared(jsnap, jt, jprof, alive_mask=mask)
        tpbs = tenc.encode_problems_shared(tsnap, tt, tprof, alive_mask=mask)
        for jpb, tpb in zip(jpbs, tpbs):
            assert_problems_equal(jpb, tpb)
    plain = tenc.encode_problems_shared(tsnap, tt, tprof)
    assert tenc.encode_problems_shared(
        tsnap, tt, tprof, alive_mask=np.ones(6, dtype=bool)) is plain
    masked = tenc.encode_problems_shared(tsnap, tt, tprof, alive_mask=dead)
    assert masked is not plain
    assert tenc.encode_problems_shared(tsnap, tt, tprof,
                                       alive_mask=dead.copy()) is masked
    store = tsnap.memo(("encode_problems_shared",), list)
    assert len(store) == len(jsnap.memo(("encode_problems_shared",),
                                        list)) == 2
