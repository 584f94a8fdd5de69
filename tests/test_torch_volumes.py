"""The port's volume plugins (ops/volumes.py) against the JAX package's, on
the scenarios of tests/test_volumes.py: encode_problem array-equal to the
JAX encode (volume mask, reasons, self-conflict flags, pod-level reason,
step hint), and each template solved end to end through ClusterCapacity on
the CPU with the same placements, messages, counts, rung stamps and JSON
report.  DRA resource claims stay refused by name.  Tolerance: exact.
"""

import pytest

from cluster_capacity_tpu.ops import volumes as jvol
from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.ops import volumes as tvol

from helpers import build_test_node, build_test_pod
from test_torch_encode import assert_problems_equal, encode_both
from test_torch_preemption import assert_same_run, run_pair
from test_volumes import (_pod_with_claim, _pv, _pvc, _wffc_sc, _zone_nodes)


def _missing_pvc():
    return ([build_test_node("n1", 1000, int(1e9), 10)],
            _pod_with_claim("p", "nope"), 0, {})


def _unbound_immediate():
    return ([build_test_node("n1", 1000, int(1e9), 10)],
            _pod_with_claim("p", "slow"), 0, {"pvcs": [_pvc("slow")]})


def _bound_pv_node_affinity():
    nodes = [build_test_node(f"n{i}", 1000, int(1e9), 10,
                             labels={"kubernetes.io/hostname": f"n{i}"})
             for i in (1, 2)]
    return (nodes, _pod_with_claim("p", "claim1"), 0,
            {"pvcs": [_pvc("claim1", volume="vol1")],
             "pvs": [_pv("vol1", node_affinity_hostnames=["n2"])]})


def _volume_zone_conflict():
    nodes = [build_test_node("na", 1000, int(1e9), 10,
                             labels={"topology.kubernetes.io/zone": "a"}),
             build_test_node("nb", 1000, int(1e9), 10,
                             labels={"topology.kubernetes.io/zone": "b"})]
    return (nodes, _pod_with_claim("p", "claim1"), 0,
            {"pvcs": [_pvc("claim1", volume="vol1")],
             "pvs": [_pv("vol1", zone="a")]})


def _wffc_static():
    nodes = [build_test_node(f"n{i}", 1000, int(1e9), 10,
                             labels={"kubernetes.io/hostname": f"n{i}"})
             for i in (1, 2)]
    scs = [{"metadata": {"name": "local"},
            "provisioner": "kubernetes.io/no-provisioner",
            "volumeBindingMode": "WaitForFirstConsumer"}]
    return (nodes, _pod_with_claim("p", "localclaim"), 1,
            {"pvcs": [_pvc("localclaim", sc="local")],
             "pvs": [_pv("localvol", sc="local",
                         node_affinity_hostnames=["n1"])],
             "storage_classes": scs})


def _rwop_single_clone():
    return ([build_test_node("n1", 10000, int(1e10), 100)],
            _pod_with_claim("p", "exclusive"), 0,
            {"pvcs": [_pvc("exclusive", volume="vol1",
                           modes=("ReadWriteOncePod",))],
             "pvs": [_pv("vol1")]})


def _rwop_in_use():
    occupant = _pod_with_claim("occupant", "exclusive")
    occupant["spec"]["nodeName"] = "n1"
    node_list, the_pod, limit, objs = _rwop_single_clone()
    return node_list, the_pod, limit, dict(objs, pods=[occupant])


def _inline_disk():
    the_pod = build_test_pod("p", 100, 0)
    the_pod["spec"]["volumes"] = [{"name": "d", "gcePersistentDisk":
                                   {"pdName": "disk-1"}}]
    return ([build_test_node("n1", 10000, int(1e10), 100),
             build_test_node("n2", 10000, int(1e10), 100)], the_pod, 0, {})


def _inline_disk_existing():
    node_list, the_pod, limit, objs = _inline_disk()
    user = build_test_pod("user", 100, 0, node_name="n2")
    user["spec"]["volumes"] = [{"name": "d", "gcePersistentDisk":
                                {"pdName": "disk-1"}}]
    return node_list, the_pod, limit, dict(objs, pods=[user])


def _csi_limits():
    csinodes = [{"metadata": {"name": "n1"},
                 "spec": {"drivers": [{"name": "ebs.csi.aws.com",
                                       "allocatable": {"count": 1}}]}}]
    pvs = [{"metadata": {"name": f"vol{i}"},
            "spec": {"capacity": {"storage": "10Gi"},
                     "accessModes": ["ReadWriteOnce"],
                     "storageClassName": "ebs",
                     "csi": {"driver": "ebs.csi.aws.com",
                             "volumeHandle": f"h{i}"}}} for i in (1, 2)]
    the_pod = build_test_pod("p", 100, 0)
    the_pod["spec"]["volumes"] = [
        {"name": "a", "persistentVolumeClaim": {"claimName": "c1"}},
        {"name": "b", "persistentVolumeClaim": {"claimName": "c2"}}]
    return ([build_test_node("n1", 10000, int(1e10), 100)], the_pod, 0,
            {"pvcs": [_pvc("c1", sc="ebs", volume="vol1"),
                      _pvc("c2", sc="ebs", volume="vol2")],
             "pvs": pvs, "csinodes": csinodes})


def _claim_pod():
    the_pod = build_test_pod("p", 100, 0)
    the_pod["spec"]["volumes"] = [{"name": "data",
                                   "persistentVolumeClaim": {"claimName": "c"}}]
    return the_pod


def _wffc_allowed_topologies():
    sc = _wffc_sc(allowed_topologies=[{"matchLabelExpressions": [{
        "key": "topology.kubernetes.io/zone", "values": ["z1"]}]}])
    return (_zone_nodes(), _claim_pod(), 0,
            {"storage_classes": [sc], "pvcs": [_pvc("c", sc="fast")]})


def _wffc_capacity(caps):
    def build():
        objs = {"storage_classes": [_wffc_sc()],
                "pvcs": [_pvc("c", sc="fast", storage="1Gi")]}
        if caps:
            objs["csistoragecapacities"] = caps
        return _zone_nodes(), _claim_pod(), 0, objs
    return build


def _scheduling_gates():
    the_pod = build_test_pod("gated", 100, 0)
    the_pod["spec"]["schedulingGates"] = [{"name": "wait"}]
    return [build_test_node("n1", 1000, int(1e9), 10)], the_pod, 0, {}


SCENARIOS = {
    "missing_pvc": _missing_pvc,
    "unbound_immediate": _unbound_immediate,
    "bound_pv_node_affinity": _bound_pv_node_affinity,
    "volume_zone_conflict": _volume_zone_conflict,
    "wffc_static_provisioning": _wffc_static,
    "rwop_single_clone": _rwop_single_clone,
    "rwop_in_use_by_existing_pod": _rwop_in_use,
    "inline_disk_conflict": _inline_disk,
    "inline_disk_in_use_by_existing_pod": _inline_disk_existing,
    "csi_volume_limits": _csi_limits,
    "wffc_allowed_topologies": _wffc_allowed_topologies,
    "wffc_capacity_per_zone": _wffc_capacity([
        {"storageClassName": "fast", "capacity": "100Gi",
         "nodeTopology": {"matchLabels": {
             "topology.kubernetes.io/zone": "z0"}}},
        {"storageClassName": "fast", "capacity": "512Mi",
         "nodeTopology": {"matchLabels": {
             "topology.kubernetes.io/zone": "z1"}}}]),
    "wffc_capacity_max_volume_size": _wffc_capacity([
        {"storageClassName": "fast", "capacity": "100Gi",
         "maximumVolumeSize": "512Mi"}]),
    "wffc_capacity_unpublished": _wffc_capacity(None),
    "scheduling_gates": _scheduling_gates,
}


def _split(objs):
    objs = dict(objs)
    return objs.pop("pods", []), objs


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_volume_encode_matches_jax(name):
    node_list, the_pod, _limit, objs = SCENARIOS[name]()
    existing, objs = _split(objs)
    jpb, tpb = encode_both(node_list, the_pod, existing, objs)
    assert_problems_equal(jpb, tpb)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_volume_template_solves_like_jax(name):
    node_list, the_pod, limit, objs = SCENARIOS[name]()
    existing, objs = _split(objs)
    assert_same_run(*run_pair(node_list, the_pod, existing, limit, objs))


def test_volume_verdict_matches_jax():
    """ops/volumes.evaluate field for field on a mixed-volume template."""
    node_list, _pod, _limit, objs = _csi_limits()
    the_pod = build_test_pod("p", 100, 0)
    the_pod["spec"]["volumes"] = [
        {"name": "a", "persistentVolumeClaim": {"claimName": "c1"}},
        {"name": "d", "awsElasticBlockStore": {"volumeID": "v-1"}}]
    from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
    from cluster_capacity_tpu.models.podspec import default_pod as jdp
    enabled = lambda name: True
    want = jvol.evaluate(JSnap.from_objects(node_list, [], **objs),
                         jdp(the_pod), enabled)
    got = tvol.evaluate(TSnap.from_objects(node_list, [], **objs),
                        t_default_pod(the_pod), enabled)
    assert got.pod_level_reason == want.pod_level_reason
    assert list(got.mask) == list(want.mask)
    assert got.reasons == want.reasons
    assert (got.self_disk_conflict, got.rwop_self_conflict) == \
        (want.self_disk_conflict, want.rwop_self_conflict)


def test_unbacked_dra_claim_fails_pod_level():
    """DRA claims are served now (tests/test_torch_dra.py): a claim no
    object backs fails pod-level, as in the JAX package."""
    the_pod = build_test_pod("p", 100, 0)
    the_pod["spec"]["resourceClaims"] = [{"name": "gpu",
                                          "resourceClaimName": "c"}]
    assert_same_run(*run_pair([build_test_node("n1", 1000, int(1e9), 10)],
                              the_pod))
