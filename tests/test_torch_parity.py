"""The port under the float64 parity profile against the JAX package, on
the CPU: ClusterCapacity.run of both packages on the cases of
tests/test_golden_reference.py, test_prediction.py and test_colocation.py,
every tests/golden/*.json scenario (the recorded outcome and the JAX
package), tests/test_preemption.py's scenarios and seeded priority/PDB
clusters; a two-template parity sweep; a random tie-break run.

Compared: placements, fail type, FitError and preemption messages,
per-reason counts, rung stamps, the -o json report, scheduled pods and
post_run_snapshot rosters.  Tolerance: exact.
"""

import dataclasses
import glob
import os

import pytest

from cluster_capacity_tpu import ClusterCapacity as JCC
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.parallel import sweep as jsweep
from cluster_capacity_tpu.utils import golden
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.engine import fused as tfused
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.utils import config as tconfig
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile
from cluster_capacity_tpu_torch.utils.snapshot_io import parse_snapshot_dict

from helpers import (build_test_node, build_test_pod, prediction_pod,
                     setup_prediction_nodes)
from test_torch_kernel import HOST, ZONE, spread
from test_torch_preemption import SCENARIOS, assert_same_run, priority_cluster

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden",
                                       "*.json")))


def parity(score_weights=None, seed=0, deterministic=True):
    """A profile builder for both packages: parity, optionally reduced to
    `score_weights`, optionally with the random tie-break."""
    def build(cls):
        p = cls.parity()
        if score_weights is not None:
            p.score_weights = dict(score_weights)
        p.deterministic = deterministic
        p.seed = seed
        return p
    return build


def run_both(node_list, the_pod, pods=(), max_limit=0, objs=None,
             profile=None, exclude=(), message=False):
    """(jcc, jres, tcc, tres) of both packages' ClusterCapacity.run."""
    profile = profile or parity()
    out = []
    for cc_cls, prof_cls, default_pod, extra in (
            (JCC, JProfile, j_default_pod, {}),
            (TCC, TProfile, t_default_pod, {"device": "cpu"})):
        prof = profile(prof_cls)
        prof.include_preemption_message = message
        cc = cc_cls(default_pod(the_pod), max_limit=max_limit, profile=prof,
                    exclude_nodes=list(exclude), **extra)
        cc.sync_with_objects(node_list, list(pods), **dict(objs or {}))
        out += [cc, cc.run()]
    assert_same_run(*out)
    return out[3]


# --- tests/test_golden_reference.py ------------------------------------------

def _colo_pod(name, app, key, cpu="100m", memory=None):
    req = {"cpu": cpu}
    if memory:
        req["memory"] = memory
    return {"metadata": {"name": name, "labels": {"app": app}},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": req}}],
                "affinity": {"podAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": [{
                        "topologyKey": key,
                        "labelSelector": {"matchLabels": {"app": app}}}]}}}}


def test_golden_reference_cases_match_jax():
    """Each case with the outcome test_golden_reference.py pins."""
    nodes = [build_test_node(f"kubemark-{i}", 2000, 4 * 1024 ** 3, 110)
             for i in range(4)]
    res = run_both(nodes, {"metadata": {"name": "small-pod"}, "spec": {
        "containers": [{"name": "c", "resources": {"requests": {
            "cpu": "150m", "memory": "100Mi"}}}]}})
    assert res.per_node_counts == {f"kubemark-{i}": 13 for i in range(4)}

    nodes = [build_test_node("test-node-1", 300, int(1e9), 3),
             build_test_node("test-node-2", 400, int(2e9), 3),
             build_test_node("test-node-3", 1200, int(1e9), 3)]
    pod = build_test_pod("simulated-pod", 100, int(5e6))
    assert run_both(nodes, pod, max_limit=6).fail_type == "LimitReached"
    assert run_both(nodes, pod).fail_message == \
        "0/3 nodes are available: 1 Insufficient cpu, 3 Too many pods."

    nodes = [build_test_node(f"node-{i}", 2000, 4 * 1024 ** 3, 20,
                             labels={HOST: f"node-{i}"}) for i in range(5)]
    res = run_both(nodes, _colo_pod("app", "colo", HOST, memory="50Mi"))
    assert len(res.per_node_counts) == 1
    znodes = [build_test_node(f"zn-{i}", 1000, 4 * 1024 ** 3, 20,
                              labels={HOST: f"zn-{i}", ZONE: f"zone-{i % 3}"})
              for i in range(9)]
    run_both(znodes, _colo_pod("zapp", "zcolo", ZONE))

    reduced = parity({"NodeResourcesFit": 1})
    nodes = [build_test_node("n0", 10000, int(1e12), 200),
             build_test_node("n1", 1000, int(1e12), 200)]
    res = run_both(nodes, build_test_pod("p", 100, -1), max_limit=12,
                   profile=reduced)
    assert res.placements == [0] * 11 + [1]

    nodes = [build_test_node("n0", 10000, int(1e12), 200,
                             labels={HOST: "n0", ZONE: "z0"}),
             build_test_node("n1", 1000, int(1e12), 2,
                             labels={HOST: "n1", ZONE: "z1"})]
    pod = {"metadata": {"name": "p", "labels": {"app": "s"},
                        "namespace": "default"},
           "spec": {"containers": [{"name": "c", "resources": {"requests": {
               "cpu": "500m"}}}],
               "topologySpreadConstraints": [
                   spread(ZONE, 1, "DoNotSchedule", "s")]}}
    assert run_both(nodes, pod, profile=reduced).placements == [0, 1, 0, 1, 0]

    nodes = [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 20,
                             labels={HOST: f"n{i}", ZONE: f"z{i % 3}"})
             for i in range(6)]
    pod = {"metadata": {"name": "p", "labels": {"app": "a"},
                        "namespace": "default"},
           "spec": {"containers": [{"name": "c", "resources": {"requests": {
               "cpu": "100m"}}}],
               "affinity": {"podAntiAffinity": {
                   "requiredDuringSchedulingIgnoredDuringExecution": [{
                       "topologyKey": ZONE,
                       "labelSelector": {"matchLabels": {"app": "a"}}}]}}}}
    assert run_both(nodes, pod, profile=reduced).placements == [0, 1, 2]

    nodes = [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 20)
             for i in range(3)]
    pod = build_test_pod("p", 100, 0)
    pod["spec"]["containers"][0]["resources"]["requests"][
        "example.com/fpga"] = "1"
    assert run_both(nodes, pod).fail_message == \
        "0/3 nodes are available: 3 Insufficient example.com/fpga."

    nodes = [build_test_node(f"n{i}", 4000, int(1e12), 2,
                             labels={HOST: f"n{i}"}) for i in range(3)]
    pod = {"metadata": {"name": "p", "labels": {"app": "rr"},
                        "namespace": "default"},
           "spec": {"containers": [{"name": "c", "resources": {"requests": {
               "cpu": "100m"}}}],
               "affinity": {"podAntiAffinity": {
                   "preferredDuringSchedulingIgnoredDuringExecution": [{
                       "weight": 10, "podAffinityTerm": {
                           "topologyKey": HOST,
                           "labelSelector": {
                               "matchLabels": {"app": "rr"}}}}]}}}}
    res = run_both(nodes, pod, profile=parity({"InterPodAffinity": 2}))
    assert res.placements == [0, 1, 2, 0, 1, 2]


# --- tests/golden/*.json -------------------------------------------------------

def _port_profile(data, is_parity):
    """golden.profile_from_dict for the port's SchedulerProfile."""
    data = dict(data or {})
    if isinstance(data.get("fit_strategy"), dict):
        fs = dict(data["fit_strategy"])
        if "resources" in fs:
            fs["resources"] = [tuple(r) for r in fs["resources"]]
        data["fit_strategy"] = tconfig.ScoringStrategy(**fs)
    if "balanced_resources" in data:
        data["balanced_resources"] = [tuple(r)
                                      for r in data["balanced_resources"]]
    known = {f.name for f in dataclasses.fields(TProfile)}
    assert set(data) <= known, sorted(set(data) - known)
    profile = TProfile(**data)
    if is_parity:
        profile.compute_dtype = "float64"
    return profile


@pytest.mark.parametrize("path", GOLDEN, ids=[os.path.basename(p)
                                              for p in GOLDEN])
def test_golden_scenario_matches_recording_and_jax(path):
    data = golden.load_scenario(path)
    jres = golden.run_scenario(data)
    profile = _port_profile(data.get("profile"), bool(data.get("parity")))
    cc = TCC(t_default_pod(data["pod"]),
             max_limit=int(data.get("max_limit") or 0), profile=profile,
             exclude_nodes=list(data.get("exclude_nodes") or []),
             device="cpu")
    objs = parse_snapshot_dict(data.get("snapshot") or {})
    cc.sync_with_objects(objs.pop("nodes", []), objs.pop("pods", []), **objs)
    tres = cc.run()
    assert not golden.compare_result(data, tres)
    assert tres.placements == jres.placements
    assert (tres.fail_type, tres.fail_message, tres.fail_counts,
            tres.rung, tres.degraded) == \
        (jres.fail_type, jres.fail_message, jres.fail_counts, jres.rung,
         jres.degraded)


# --- tests/test_prediction.py, tests/test_colocation.py ----------------------

def test_prediction_cases_match_jax():
    nodes = setup_prediction_nodes()
    assert run_both(nodes, prediction_pod(), max_limit=6).fail_message == \
        "Maximum number of pods simulated: 6"
    res = run_both(nodes, prediction_pod())
    assert (res.placed_count, res.fail_message) == (
        9, "0/3 nodes are available: 1 Insufficient cpu, 3 Too many pods.")
    res = run_both(nodes, prediction_pod(), exclude=["test-node-3"])
    assert set(res.per_node_counts) == {"test-node-1", "test-node-2"}
    nodes = [build_test_node(f"kube-node-{i}", 2000, 4 * 1024 ** 3, 110)
             for i in range(1, 5)]
    pod = {"metadata": {"name": "small-pod", "labels": {"app": "guestbook"}},
           "spec": {"containers": [{
               "name": "php-redis",
               "image": "gcr.io/google-samples/gb-frontend:v4",
               "resources": {"requests": {"cpu": "150m", "memory": "100Mi"},
                             "limits": {"cpu": "500m",
                                        "memory": "128Mi"}}}]}}
    assert run_both(nodes, pod).placed_count == 52
    existing = [build_test_pod("busy", 800, 0, node_name="n1"),
                build_test_pod("done", 900, 0, node_name="n1")]
    existing[1]["status"] = {"phase": "Succeeded"}
    assert run_both([build_test_node("n1", 1000, int(1e9), 10)],
                    build_test_pod("new", 100, 0),
                    pods=existing).placed_count == 2


def _affinity_pod(kind, key, labels, match):
    pod = build_test_pod("pod-affinity", 10, 10, labels=labels)
    pod["spec"]["affinity"] = {kind: {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "topologyKey": key, "labelSelector": {"matchLabels": match}}]}}
    return pod


def test_colocation_cases_match_jax():
    ns = {"namespaces": [{"metadata": {"name": "default"}}]}
    hosts = [build_test_node(f"node{i}", 1000, 1000, 30,
                             labels={HOST: f"node{i}"}) for i in (1, 2, 3)]
    kv = {"key": "value"}
    res = run_both(hosts, _affinity_pod("podAffinity", HOST, kv, kv),
                   max_limit=100, objs=ns)
    assert len(res.per_node_counts) == 1
    zone_key = "topology.domain/zone"
    zoned = [build_test_node(f"node{z}-{i}", 1000, 1000, 30,
                             labels={zone_key: f"zone{z}",
                                     HOST: f"node{z}-{i}"})
             for z in (1, 2, 3) for i in (1, 2, 3)]
    run_both(zoned, _affinity_pod("podAffinity", zone_key, kv, kv),
             max_limit=100, objs=ns)
    res = run_both(hosts, _affinity_pod("podAntiAffinity", HOST, kv, kv),
                   objs=ns)
    assert res.placed_count == 3
    blocker = _affinity_pod("podAntiAffinity", HOST, {"team": "a"},
                            {"app": "web"})
    blocker["metadata"]["name"] = "blocker"
    blocker["spec"]["nodeName"] = "node1"
    res = run_both(hosts[:2], build_test_pod("incoming", 10, 10,
                                             labels={"app": "web"}),
                   pods=[blocker], objs=ns)
    assert "node1" not in res.per_node_counts


# --- tests/test_preemption.py under parity -------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_preemption_scenarios_match_jax(name):
    node_list, the_pod, pods, limit, objs = SCENARIOS[name]()
    run_both(node_list, the_pod, pods, limit, objs, message=True)


@pytest.mark.parametrize("seed", range(4))
def test_priority_pdb_clusters_match_jax(seed):
    node_list, the_pod, pods, limit, objs = priority_cluster(
        seed, affinity=bool(seed % 2))
    run_both(node_list, the_pod, pods, limit, objs, message=bool(seed % 2))


# --- sweeps and the random tie-break -------------------------------------------

def test_parity_sweep_matches_jax():
    """Two spread templates under parity: one group the batched kernel does
    not take, so the port runs each template through the scan step under
    the group's budget; results, messages and rung stamps equal the JAX
    package's vmapped group, unlimited and at a limit."""
    node_list = [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 12,
                                 labels={HOST: f"n{i}", ZONE: f"z{i % 3}"})
                 for i in range(9)]
    templates = []
    for name, cpu, skew in (("a", 300, 1), ("b", 500, 2)):
        t = build_test_pod(name, cpu, 256 * 1024 ** 2, labels={"app": name})
        t["spec"]["topologySpreadConstraints"] = [
            spread(ZONE, skew, "DoNotSchedule", name)]
        templates.append(t)
    for max_limit in (0, 7):
        jres = jsweep.sweep(JSnap.from_objects(node_list),
                            [j_default_pod(t) for t in templates],
                            profile=JProfile.parity(), max_limit=max_limit)
        launches = tfused.LAUNCHES
        tres = tsweep.sweep(TSnap.from_objects(node_list),
                            [t_default_pod(t) for t in templates],
                            profile=TProfile.parity(), max_limit=max_limit,
                            device="cpu")
        assert tfused.LAUNCHES == launches
        for j, t in zip(jres, tres):
            assert t.placements == j.placements
            assert (t.fail_type, t.fail_message, t.fail_counts, t.rung) == \
                (j.fail_type, j.fail_message, j.fail_counts, j.rung)
            assert t.rung == "fused_batched"


@pytest.mark.parametrize("dtype64", [False, True], ids=["float32", "parity"])
def test_random_tie_break_matches_jax(dtype64):
    """deterministic=False with a seed: the threefry tie-break jitter of both
    packages picks the same nodes among equal scores."""
    node_list = [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 30,
                                 labels={HOST: f"n{i}", ZONE: f"z{i % 4}"})
                 for i in range(16)]
    pod = build_test_pod("r", 250, 128 * 1024 ** 2, labels={"app": "r"})
    pod["spec"]["topologySpreadConstraints"] = [
        spread(ZONE, 1, "ScheduleAnyway", "r")]

    def build(cls):
        p = cls.parity() if dtype64 else cls()
        p.deterministic, p.seed = False, 11
        return p
    res = run_both(node_list, pod, profile=build)
    # ties were broken off the lowest index: not every choice is the
    # deterministic argmax's
    det = run_both(node_list, pod,
                   profile=parity() if dtype64 else None)
    assert res.placed_count == det.placed_count
    assert res.placements != det.placements


# --- the random tie-break in sweeps and preemption ---------------------------

def _sweep_both(node_list, templates, profile, max_limit):
    """Both packages' sweep of `templates` under profile(cls); asserts the
    per-template placements, fail type, message, counts and rung equal."""
    jres = jsweep.sweep(JSnap.from_objects(node_list),
                        [j_default_pod(t) for t in templates],
                        profile=profile(JProfile), max_limit=max_limit)
    tres = tsweep.sweep(TSnap.from_objects(node_list),
                        [t_default_pod(t) for t in templates],
                        profile=profile(TProfile), max_limit=max_limit,
                        device="cpu")
    for j, t in zip(jres, tres):
        assert t.placements == j.placements
        assert (t.fail_type, t.fail_message, t.fail_counts, t.rung,
                t.degraded) == (j.fail_type, j.fail_message, j.fail_counts,
                                j.rung, j.degraded)
    return tres


def _three_templates(key, when, skews=(1, 2, 3)):
    out = []
    for name, cpu, skew in zip(("a", "b", "c"), (300, 500, 250), skews):
        t = build_test_pod(name, cpu, 256 * 1024 ** 2, labels={"app": name})
        t["spec"]["topologySpreadConstraints"] = [
            spread(key, skew, when, name)]
        out.append(t)
    return out


def _random(dtype64, seed=5):
    def build(cls):
        p = cls.parity() if dtype64 else cls()
        p.deterministic, p.seed = False, seed
        return p
    return build


@pytest.mark.parametrize("max_limit", [0, 7])
@pytest.mark.parametrize("dtype64", [False, True], ids=["float32", "parity"])
def test_random_three_template_sweeps_match_jax(dtype64, max_limit):
    """Three spread templates with the random tie-break (the threefry
    jitter of both packages), unlimited and at limit 7."""
    node_list = [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 12,
                                 labels={HOST: f"n{i}", ZONE: f"z{i % 3}"})
                 for i in range(9)]
    tres = _sweep_both(node_list, _three_templates(ZONE, "DoNotSchedule"),
                       _random(dtype64), max_limit)
    assert all(r.placed_count for r in tres)


@pytest.mark.parametrize("mode", ["deterministic", "random"])
def test_forty_zone_soft_sweep_matches_jax(mode):
    """A three-template sweep on a 40-zone soft (ScheduleAnyway) key: more
    domains than kernel 2 takes, so each template runs the scan step under
    the group's budget."""
    key = "example.com/rack"
    node_list = [build_test_node(f"n{i:02d}", 2000, 4 * 1024 ** 3, 6,
                                 labels={HOST: f"n{i:02d}",
                                         key: f"r{i % 40}"})
                 for i in range(48)]
    templates = _three_templates(key, "ScheduleAnyway")
    profile = _random(False) if mode == "random" else profile_default
    pbs = [tenc.encode_problem(TSnap.from_objects(node_list),
                               t_default_pod(t), profile(TProfile))
           for t in templates]
    padded, cfg = tsweep._pad_group(pbs)
    assert not all(tfused.eligible(cfg, pb) for pb in padded)
    for max_limit in (0, 7):
        _sweep_both(node_list, templates, profile, max_limit)


def profile_default(cls):
    return cls()


@pytest.mark.parametrize("dtype64", [False, True], ids=["float32", "parity"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_preemption_scenarios_random_match_jax(name, dtype64):
    """tests/test_preemption.py's six scenarios with the random
    tie-break."""
    node_list, the_pod, pods, limit, objs = SCENARIOS[name]()
    run_both(node_list, the_pod, pods, limit, objs,
             profile=_random(dtype64, seed=17), message=True)
