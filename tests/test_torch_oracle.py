"""The port's sequential oracle (engine/oracle.py) against the JAX
package's, on the seeds and scenarios of tests/test_oracle_parity.py, under
the default (float32) profile and SchedulerProfile.parity().

The oracle is host Python in both packages; the port's adds per-roster
caches of the cluster-wide filter counts.  Equality is exact: the same
placement lists and the same fail-reason histograms.
"""

import numpy as np
import pytest

from cluster_capacity_tpu.engine import oracle as joracle
from cluster_capacity_tpu.ops import pod_topology_spread as jpts
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch.engine import oracle as toracle
from cluster_capacity_tpu_torch.ops import pod_topology_spread as tpts
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from helpers import build_test_node, build_test_pod
from test_oracle_parity import random_cluster, random_pod

PROFILES = {"default": (JProfile, TProfile),
            "parity": (JProfile.parity, TProfile.parity)}
NS = [{"metadata": {"name": "default"}}]


def _profiles(kind, pct=None):
    jp, tp = (f() for f in PROFILES[kind])
    if pct is not None:
        jp.percentage_of_nodes_to_score = pct
        tp.percentage_of_nodes_to_score = pct
    return jp, tp


def simulate_both(node_list, pods, the_pod, kind, limit, pct=None, **objs):
    jp, tp = _profiles(kind, pct)
    want = joracle.simulate(JSnap.from_objects(node_list, pods, **objs),
                            j_default_pod(the_pod), jp, max_limit=limit)
    got = toracle.simulate(TSnap.from_objects(node_list, pods, **objs),
                           t_default_pod(the_pod), tp, max_limit=limit)
    return want, got


@pytest.mark.parametrize("kind", sorted(PROFILES))
@pytest.mark.parametrize("seed", range(8))
def test_oracle_matches_jax_random(seed, kind):
    rng = np.random.RandomState(seed)
    node_list, pods = random_cluster(rng, n_nodes=int(rng.choice([5, 9, 14])))
    the_pod = random_pod(rng)
    want, got = simulate_both(node_list, pods, the_pod, kind, 40,
                              namespaces=NS)
    assert got == want, f"seed={seed}"


@pytest.mark.parametrize("kind", sorted(PROFILES))
def test_oracle_matches_jax_sampling(kind):
    rng = np.random.RandomState(123)
    node_list = [build_test_node(f"n{i:03d}", int(rng.choice([1000, 2000])),
                                 int(rng.choice([2, 4])) * 1024 ** 3, 20)
                 for i in range(120)]
    the_pod = build_test_pod("target", 150, 128 * 1024 ** 2)
    want, got = simulate_both(node_list, [], the_pod, kind, 60, pct=40)
    assert got == want


@pytest.mark.parametrize("kind", sorted(PROFILES))
def test_oracle_matches_jax_sampling_fewer_feasible_than_k(kind):
    rng = np.random.RandomState(77)
    node_list = [build_test_node(
        f"n{i:03d}", int(rng.choice([1000, 2000, 4000])),
        int(rng.choice([2, 4])) * 1024 ** 3, 20,
        labels={"kubernetes.io/hostname": f"n{i:03d}",
                "topology.kubernetes.io/zone": f"z{i % 2}"})
        for i in range(120)]
    the_pod = build_test_pod("t", 200, 128 * 1024 ** 2, labels={"app": "s"})
    the_pod["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "s"}}}]
    want, got = simulate_both(node_list, [], the_pod, kind, 80, pct=85)
    assert got == want


@pytest.mark.parametrize("kind", sorted(PROFILES))
@pytest.mark.parametrize("seed", range(4))
def test_oracle_matches_jax_system_default_spread(monkeypatch, seed, kind):
    # the port carries upstream's system-default constraints (hostname
    # maxSkew 3, zone 5); the JAX package's are held to them here
    monkeypatch.setattr(jpts, "SYSTEM_DEFAULT_CONSTRAINTS",
                        tpts.SYSTEM_DEFAULT_CONSTRAINTS)
    rng = np.random.RandomState(2000 + seed)
    node_list, pods = random_cluster(rng, n_nodes=int(rng.choice([6, 10])))
    svc = {"metadata": {"name": "web", "namespace": "default"},
           "spec": {"selector": {"app": "web"}}}
    the_pod = build_test_pod("target", int(rng.choice([100, 200])),
                             int(rng.choice([128, 256])) * 1024 ** 2,
                             labels={"app": "web"})
    want, got = simulate_both(node_list, pods, the_pod, kind, 30,
                              services=[svc], namespaces=NS)
    assert got == want


def _priority_cluster(seed):
    rng = np.random.RandomState(1000 + seed)
    node_list = [build_test_node(f"n{i}", int(rng.choice([1000, 2000])),
                                 int(rng.choice([2, 4])) * 1024 ** 3, 12)
                 for i in range(5)]
    pods = []
    for i in range(5):
        for k in range(int(rng.randint(3))):
            p = build_test_pod(f"e{i}{k}", int(rng.choice([200, 500])), 0,
                               node_name=f"n{i}")
            p["spec"]["priority"] = int(rng.choice([-10, 0, 5]))
            pods.append(p)
    the_pod = build_test_pod("vip", 600, 0)
    the_pod["spec"]["priority"] = 10
    return node_list, pods, the_pod


@pytest.mark.parametrize("kind", sorted(PROFILES))
@pytest.mark.parametrize("seed", range(4))
def test_oracle_with_preemption_matches_jax(seed, kind):
    node_list, pods, the_pod = _priority_cluster(seed)
    jp, tp = _profiles(kind)
    want = joracle.simulate_with_preemption(
        JSnap.from_objects(node_list, pods), j_default_pod(the_pod), jp,
        max_limit=30)
    got = toracle.simulate_with_preemption(
        TSnap.from_objects(node_list, pods), t_default_pod(the_pod), tp,
        max_limit=30)
    assert got == want, f"seed {seed}"


def test_oracle_cache_follows_roster_changes():
    """The per-version caches: a filter answer read before a roster change
    is recomputed after it (set_pods, add_pod, pods_by_node = ...)."""
    node_list = [build_test_node(f"n{i}", 4000, 8 * 1024 ** 3, 20,
                                 labels={"topology.kubernetes.io/zone":
                                         f"z{i % 2}"}) for i in range(4)]
    the_pod = t_default_pod(build_test_pod("t", 100, 0, labels={"app": "s"}))
    the_pod["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "s"}}}]
    profile = TProfile()
    state = toracle.OracleState(TSnap.from_objects(node_list))
    assert toracle._filter_node(state, 0, the_pod, profile) is None
    twin = dict(the_pod, metadata=dict(the_pod["metadata"], name="t-0"))
    say_no = "node(s) didn't match pod topology spread constraints"
    state.add_pod(0, twin)             # z0 holds one match, z1 none
    assert toracle._filter_node(state, 2, the_pod, profile) == say_no
    assert toracle._filter_node(state, 1, the_pod, profile) is None
    state.add_pod(1, dict(twin))       # balanced again
    assert toracle._filter_node(state, 2, the_pod, profile) is None
    state.set_pods(1, [])
    assert toracle._filter_node(state, 2, the_pod, profile) == say_no
    state.pods_by_node = [[] for _ in node_list]
    assert toracle._filter_node(state, 2, the_pod, profile) is None


def test_oracle_explain_matches_jax():
    """explain_out is served: the attribution record equals the JAX
    oracle's (why-here rows, elimination steps and reasons)."""
    node_list = [build_test_node(f"n{i}", 1000 + 500 * i, 1024 ** 3, 4)
                 for i in range(3)]
    the_pod = build_test_pod("p", 300, 0)
    jout, tout = {}, {}
    want = joracle.simulate(JSnap.from_objects(node_list),
                            j_default_pod(the_pod), JProfile(),
                            explain_out=jout)
    got = toracle.simulate(TSnap.from_objects(node_list),
                           t_default_pod(the_pod), TProfile(),
                           explain_out=tout)
    assert got == want and tout == jout
    assert tout["why_here"] and max(tout["elim_step"]) > 0


@pytest.mark.parametrize("kind", sorted(PROFILES))
@pytest.mark.parametrize("seed", range(4))
def test_oracle_alive_mask_matches_jax(seed, kind):
    """The resilience failure overlay: dead nodes fail first with
    REASON_NODE_FAILED and never host a clone, as in the JAX oracle."""
    rng = np.random.RandomState(seed)
    node_list, pods = random_cluster(rng, n_nodes=int(rng.choice([5, 9])))
    the_pod = random_pod(rng)
    alive = np.ones(len(node_list), dtype=bool)
    alive[rng.choice(len(node_list), size=2, replace=False)] = False
    jp, tp = _profiles(kind)
    want = joracle.simulate(JSnap.from_objects(node_list, pods,
                                               namespaces=NS),
                            j_default_pod(the_pod), jp, max_limit=40,
                            alive_mask=alive)
    got = toracle.simulate(TSnap.from_objects(node_list, pods,
                                              namespaces=NS),
                           t_default_pod(the_pod), tp, max_limit=40,
                           alive_mask=alive)
    assert got == want, f"seed={seed}"
    dead = set(np.flatnonzero(~alive).tolist())
    assert not dead & set(got[0])
