"""The port's checkpoints (utils/checkpoint.py) against the JAX package's,
on the CPU.

A bundle saved by either package loads in the other with equal arrays,
names, objects and digest; a flipped byte, a truncated file and a missing
member raise CheckpointCorruption in both; pre-checksum bundles load; the
ScenarioJournal written by one package reads, resumes and refuses in the
other; scenario_fingerprint is equal.  A run from a loaded bundle equals
the run from the objects.  Tolerance: exact.
"""

import os

import numpy as np
import pytest

from cluster_capacity_tpu import ClusterCapacity as JCC
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.runtime import errors as jerrors
from cluster_capacity_tpu.utils import checkpoint as jck
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import OBJECT_FIELDS
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.runtime import errors as terrors
from cluster_capacity_tpu_torch.utils import checkpoint as tck
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from helpers import build_test_node, build_test_pod

ZONE = "topology.kubernetes.io/zone"
PACKAGES = {"jax": (jck, JSnap, jerrors), "torch": (tck, TSnap, terrors)}


def _objects(seed, n=16):
    rng = np.random.RandomState(seed)
    nodes = [build_test_node(f"n{i:02d}", int(rng.choice([1000, 2000, 4000])),
                             int(rng.choice([2, 4])) * 1024 ** 3, 10,
                             labels={ZONE: f"z{i % 3}"},
                             extra_alloc={"example.com/gpu": "2"}
                             if i % 4 == 0 else None)
             for i in range(n)]
    pods = [build_test_pod(f"e{i}", int(rng.choice([100, 300])), 0,
                           node_name=f"n{int(rng.randint(n)):02d}",
                           labels={"app": "x"})
            for i in range(int(rng.randint(2, 8)))]
    extra = {"pdbs": [{"metadata": {"name": "pdb", "namespace": "default"},
                       "spec": {"selector": {"matchLabels": {"app": "x"}}},
                       "status": {"disruptionsAllowed": 1}}],
             "priority_classes": [{"metadata": {"name": "low"},
                                   "value": 0}]}
    return nodes, pods, extra


def _view(snap):
    return {"node_names": list(snap.node_names),
            "resource_names": list(snap.resource_names),
            "allocatable": (snap.allocatable.dtype.str,
                            snap.allocatable.tolist()),
            "requested": (snap.requested.dtype.str, snap.requested.tolist()),
            "nonzero": (snap.nonzero_requested.dtype.str,
                        snap.nonzero_requested.tolist()),
            "nodes": snap.nodes, "pods_by_node": snap.pods_by_node,
            **{k: getattr(snap, k) for k in OBJECT_FIELDS}}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_bundle_crosses_packages(tmp_path, seed, writer, reader):
    nodes, pods, extra = _objects(seed)
    w_ck, w_snap, _ = PACKAGES[writer]
    r_ck, r_snap, _ = PACKAGES[reader]
    snap = w_snap.from_objects(nodes, pods, **extra)
    path = str(tmp_path / "snap")          # ".npz" is appended
    w_ck.save(path, snap)
    assert os.path.exists(path + ".npz")
    loaded = r_ck.load(path)
    assert isinstance(loaded, r_snap)
    assert _view(loaded) == _view(snap)
    digests = {jck.snapshot_digest(loaded), tck.snapshot_digest(loaded),
               jck.snapshot_digest(snap), tck.snapshot_digest(snap)}
    assert len(digests) == 1
    with np.load(path + ".npz", allow_pickle=True) as z:
        assert str(z["checksum"]) == digests.pop()


def test_both_packages_write_the_same_members(tmp_path):
    nodes, pods, extra = _objects(3)
    members = []
    for name, (ck, snap_cls, _) in PACKAGES.items():
        p = str(tmp_path / f"{name}.npz")
        ck.save(p, snap_cls.from_objects(nodes, pods, **extra))
        with np.load(p, allow_pickle=True) as z:
            members.append({k: z[k].tolist() for k in z.files})
    assert members[0] == members[1]


def _corrupt_copies(tmp_path, src):
    raw = open(src, "rb").read()
    # a byte flipped inside the stored (uncompressed-size) payload region,
    # a truncated file, and a bundle with a member missing
    flipped = bytearray(raw)
    flipped[len(raw) // 2] ^= 0xFF
    out = {"flipped": bytes(flipped), "truncated": raw[:len(raw) // 3]}
    for name, data in out.items():
        (tmp_path / f"{name}.npz").write_bytes(data)
    with np.load(src, allow_pickle=True) as z:
        kept = {k: z[k] for k in z.files if k != "requested"}
    np.savez_compressed(str(tmp_path / "missing.npz"), **kept)
    return [str(tmp_path / f"{n}.npz") for n in
            ("flipped", "truncated", "missing")]


def test_corruption_raises_in_both(tmp_path):
    nodes, pods, extra = _objects(4)
    src = str(tmp_path / "good.npz")
    tck.save(src, TSnap.from_objects(nodes, pods, **extra))
    for path in _corrupt_copies(tmp_path, src):
        msgs = []
        for ck, _snap, errors in PACKAGES.values():
            with pytest.raises(errors.CheckpointCorruption) as ei:
                ck.load(path)
            assert ei.value.code == "CheckpointCorruption"
            msgs.append(str(ei.value).split(":")[0])
        assert msgs[0] == msgs[1], path


def test_checksum_mismatch_message(tmp_path):
    """A bundle whose arrays changed under an unchanged checksum member."""
    nodes, pods, extra = _objects(5)
    src = str(tmp_path / "good.npz")
    jck.save(src, JSnap.from_objects(nodes, pods, **extra))
    with np.load(src, allow_pickle=True) as z:
        members = {k: z[k] for k in z.files}
    members["requested"] = members["requested"] + 1.0
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, **members)
    msgs = []
    for ck, _snap, errors in PACKAGES.values():
        with pytest.raises(errors.CheckpointCorruption,
                           match="failed its checksum") as ei:
            ck.load(bad)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    # a pre-checksum bundle loads untouched in both
    del members["checksum"]
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **members)
    assert _view(tck.load(old)) == _view(jck.load(old))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_run_from_a_bundle(tmp_path, writer):
    """The run from a loaded bundle equals the run from the objects, in
    both packages, whichever package wrote the bundle."""
    nodes, pods, extra = _objects(6)
    w_ck, w_snap, _ = PACKAGES[writer]
    path = str(tmp_path / "b.npz")
    w_ck.save(path, w_snap.from_objects(nodes, pods, **extra))
    pod = build_test_pod("p", 250, 64 * 1024 ** 2)
    outs = []
    for cc_cls, prof_cls, default_pod, ck, kw in (
            (JCC, JProfile, j_default_pod, jck, {}),
            (TCC, TProfile, t_default_pod, tck, {"device": "cpu"})):
        a = cc_cls(default_pod(pod), profile=prof_cls.parity(), **kw)
        a.set_snapshot(ck.load(path))
        b = cc_cls(default_pod(pod), profile=prof_cls.parity(), **kw)
        b.sync_with_objects(nodes, pods, **extra)
        ra, rb = a.run(), b.run()
        outs.append((list(ra.placements), ra.fail_type, ra.fail_message))
        assert outs[-1] == (list(rb.placements), rb.fail_type,
                            rb.fail_message)
    assert outs[0] == outs[1]


def test_journal_crosses_packages(tmp_path):
    fp = {"probe": "x", "numNodes": 3}
    path = str(tmp_path / "j.jsonl")
    with tck.ScenarioJournal(path) as j:
        j.start(fp)
        j.append("zone-a", {"placed": 3})
        j.append("zone-b", {"placed": 5})
    assert jck.ScenarioJournal(path).read() == \
        tck.ScenarioJournal(path).read() == \
        (fp, {"zone-a": {"placed": 3}, "zone-b": {"placed": 5}})
    # a half-written tail (the crash resume recovers from) is dropped by
    # both; the JAX package reopens and appends, the port reads it back
    with open(path, "a") as f:
        f.write("deadbeef {\"kind\": \"sce")
    assert tck.ScenarioJournal(path).read() == \
        jck.ScenarioJournal(path).read()
    jj = jck.ScenarioJournal(path)
    jj.reopen()
    jj.append("zone-c", {"placed": 1})
    jj.close()
    fp_t, done_t = tck.ScenarioJournal(path).read()
    assert fp_t == fp and sorted(done_t) == ["zone-a", "zone-b", "zone-c"]
    # an edited record mid-file is corruption in both
    lines = open(path).read().splitlines(keepends=True)
    lines[1] = lines[1].replace("3", "4")
    open(path, "w").write("".join(lines))
    for ck, _snap, errors in PACKAGES.values():
        with pytest.raises(errors.CheckpointCorruption,
                           match="checksum mismatch at line 2"):
            ck.ScenarioJournal(path).read()


def test_scenario_fingerprint_matches():
    nodes, pods, extra = _objects(7)
    for profile_pair in ((JProfile(), TProfile()),
                         (JProfile.parity(), TProfile.parity())):
        fps = [ck.scenario_fingerprint(
            probe={"cpu": "1"}, num_nodes=16, max_limit=5,
            scenario_names=["a", "b"], baseline_headroom=9, profile=prof,
            snapshot=snap_cls.from_objects(nodes, pods, **extra))
            for (ck, snap_cls, _), prof in zip(PACKAGES.values(),
                                               profile_pair)]
        assert fps[0] == fps[1]
        assert set(fps[1]) == {"probe", "numNodes", "maxLimit", "scenarios",
                               "baselineHeadroom", "profile", "snapshot"}
