"""The port's live sync (framework.ClusterCapacity.sync_with_client and
_to_dict) against the JAX package's, on the CPU.

tests/test_live_sync.py's duck-typed fakes (FakeCore, FakePolicy and the
RBAC-denied facade) feed both packages' sync_with_client: equal snapshots
(arrays, names, pods per node, every auxiliary object kind), equal
warnings on stderr, equal results (placements, fail type, message, counts),
and the same snapshot as sync_with_objects over the same objects.
Tolerance: exact.
"""

import numpy as np
import pytest

from cluster_capacity_tpu import ClusterCapacity as JCC
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch import framework as tframework
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import OBJECT_FIELDS
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from test_live_sync import FakeCore, FakePolicy, _Items, _node

POD = {"metadata": {"name": "p"}, "spec": {"containers": [
    {"name": "c", "resources": {"requests": {"cpu": "500m"}}}]}}


class DeniedEverything(FakeCore):
    def list_namespace(self):
        raise RuntimeError("403")

    def list_service_for_all_namespaces(self):
        raise RuntimeError("403")


class WideCore(FakeCore):
    """Every kind the sync copies, on one facade, from a numpy seed."""

    def __init__(self, seed=0, n=12):
        rng = np.random.RandomState(seed)
        self.nodes = [_node(f"n{i:02d}", cpu=str(int(rng.choice([1, 2, 4]))))
                      for i in range(n)]
        self.pods = [{"metadata": {"name": f"e{i}", "namespace": "default",
                                   "labels": {"app": "x"}},
                      "spec": {"nodeName": f"n{int(rng.randint(n)):02d}",
                               "containers": [{"name": "c", "resources": {
                                   "requests": {"cpu": f"{int(rng.choice([100, 250, 500]))}m"}}}]},
                      "status": {"phase": "Running"}}
                     for i in range(int(rng.randint(3, 9)))]

    def list_node(self):
        return _Items(self.nodes)

    def list_pod_for_all_namespaces(self):
        return _Items(self.pods)

    def list_pod_disruption_budget_for_all_namespaces(self):
        return FakePolicy().list_pod_disruption_budget_for_all_namespaces()

    def list_priority_class(self):
        return _Items([{"metadata": {"name": "low"}, "value": 0}])

    def list_storage_class(self):
        return _Items([{"metadata": {"name": "standard"},
                        "provisioner": "x"}])


def _snapshot_view(snap):
    return {
        "node_names": list(snap.node_names),
        "resource_names": list(snap.resource_names),
        "allocatable": np.asarray(snap.allocatable).tolist(),
        "requested": np.asarray(snap.requested).tolist(),
        "nonzero": np.asarray(snap.nonzero_requested).tolist(),
        "pods_by_node": snap.pods_by_node,
        **{k: getattr(snap, k) for k in OBJECT_FIELDS},
    }


def _outcome(res):
    return (list(res.placements), res.placed_count, res.fail_type,
            res.fail_message, dict(res.fail_counts or {}), res.rung,
            res.degraded)


def _sync_both(capsys, *apis, pod=POD, profile="parity"):
    """(jcc, tcc, stderr of each) after both sync_with_client calls."""
    out = []
    for cc_cls, prof_cls, default_pod, kw in (
            (JCC, JProfile, j_default_pod, {}),
            (TCC, TProfile, t_default_pod, {"device": "cpu"})):
        prof = prof_cls.parity() if profile == "parity" else prof_cls()
        cc = cc_cls(default_pod(pod), profile=prof, **kw)
        cc.sync_with_client(*apis)
        out += [cc, capsys.readouterr().err]
    return out


def test_sync_with_client_all_kinds_and_fallback(capsys):
    jcc, jerr, tcc, terr = _sync_both(capsys, FakeCore(), FakePolicy())
    assert _snapshot_view(tcc.snapshot) == _snapshot_view(jcc.snapshot)
    assert terr == jerr == ""
    snap = tcc.snapshot
    assert snap.num_nodes == 2 and snap.namespaces and snap.services
    assert snap.pdbs and snap.pdbs[0]["metadata"]["name"] == "pdb"
    jres, tres = jcc.run(), tcc.run()
    assert _outcome(tres) == _outcome(jres)
    assert tres.placed_count == 7


def test_sync_with_client_degrades_with_warning(capsys):
    pod = {"metadata": {"name": "p"}, "spec": {"containers": [
        {"name": "c", "resources": {"requests": {"cpu": "100m"}}}]}}
    jcc, jerr, tcc, terr = _sync_both(capsys, DeniedEverything(), pod=pod)
    assert terr == jerr
    assert "skipping namespaces sync" in terr
    assert "skipping services sync" in terr
    assert _snapshot_view(tcc.snapshot) == _snapshot_view(jcc.snapshot)
    assert tcc.snapshot.num_nodes == 2
    jres, tres = jcc.run(), tcc.run()
    assert _outcome(tres) == _outcome(jres) and tres.placed_count > 0


@pytest.mark.parametrize("profile", ["parity", "float32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_live_sync_equals_objects(capsys, seed, profile):
    """Seeded clusters: both packages' sync_with_client agree, and equal the
    port's sync_with_objects over the same objects."""
    core = WideCore(seed)
    jcc, jerr, tcc, terr = _sync_both(capsys, core, profile=profile)
    assert terr == jerr
    assert _snapshot_view(tcc.snapshot) == _snapshot_view(jcc.snapshot)
    direct = TCC(t_default_pod(POD), device="cpu",
                 profile=TProfile.parity() if profile == "parity"
                 else TProfile())
    direct.sync_with_objects(
        core.nodes, core.pods, pdbs=tcc.snapshot.pdbs,
        priority_classes=tcc.snapshot.priority_classes,
        storage_classes=tcc.snapshot.storage_classes,
        namespaces=tcc.snapshot.namespaces,
        services=tcc.snapshot.services)
    assert _snapshot_view(direct.snapshot) == _snapshot_view(tcc.snapshot)
    jres, tres = jcc.run(), tcc.run()
    assert _outcome(tres) == _outcome(jres)
    assert _outcome(direct.run()) == _outcome(tres)


def test_to_dict():
    class Model:
        def to_dict(self):
            return {}

    assert tframework._to_dict({"a": 1}) == {"a": 1}
    with pytest.raises(TypeError, match="cannot convert"):
        tframework._to_dict(3)
    # a kubernetes-client model needs the client, absent here as in the
    # JAX package's environment
    with pytest.raises(ImportError):
        tframework._to_dict(Model())
