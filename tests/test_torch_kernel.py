"""The CUDA kernel against its plain PyTorch version on the card, for every
problem family of the port's tests; and the problem builders those tests
share.

This file imports no jax and nothing of the JAX package, so a machine with
a card and without JAX runs it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py

(--noconftest: tests/conftest.py imports jax.)  Without a card the tests
skip.  Tolerance: exact (torch.equal).
"""

import numpy as np
import pytest
import torch

from cluster_capacity_tpu_torch.engine import fused as tfused
from cluster_capacity_tpu_torch.engine import simulator as tsim
from cluster_capacity_tpu_torch.engine.encode import encode_problem
from cluster_capacity_tpu_torch.models.podspec import default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

# ---------------------------------------------------------------------------
# shared builders (tests/test_fused.py families and its fuzz generator)
# ---------------------------------------------------------------------------

def nodes(n, seed=0, zones=4, taints=False):
    """tests/test_fused.py's node builder."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        node = {
            "metadata": {"name": f"node-{i:04d}",
                         "labels": {"kubernetes.io/hostname": f"node-{i:04d}",
                                    "topology.kubernetes.io/zone": f"z{i % zones}"}},
            "spec": {},
            "status": {"allocatable": {
                "cpu": f"{int(rng.choice([2000, 4000, 8000]))}m",
                "memory": str(int(rng.choice([4, 8, 16])) * 1024 ** 3),
                "pods": "32"}},
        }
        if taints and i % 3 == 0:
            node["spec"]["taints"] = [{"key": "dedicated", "value": "x",
                                       "effect": "PreferNoSchedule"}]
        out.append(node)
    return out


def pod(name="p", labels=None, cpu="100m", memory=None, **spec):
    req = {"cpu": cpu}
    if memory:
        req["memory"] = memory
    containers = [{"name": "c", "resources": {"requests": req}}]
    if spec.get("ports"):
        containers[0]["ports"] = spec.pop("ports")
    return {"metadata": {"name": name, "labels": dict(labels or {})},
            "spec": dict(containers=containers, **spec)}


def spread(key, skew, when, app, **kw):
    return dict({"maxSkew": skew, "topologyKey": key,
                 "whenUnsatisfiable": when,
                 "labelSelector": {"matchLabels": {"app": app}}}, **kw)


ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def profile_settings(pct=100, strategy=None, shape=None):
    def apply(p):
        p.percentage_of_nodes_to_score = pct
        if strategy:
            p.fit_strategy.type = strategy
        if shape:
            p.fit_strategy.shape_utilization = list(shape[0])
            p.fit_strategy.shape_score = list(shape[1])
        return p
    return apply


# (id, nodes, pod, existing pods, extra snapshot objects, profile settings)
def fused_families():
    existing_cache = [{"metadata": {"name": "seed", "labels": {"tier": "cache"},
                                    "namespace": "default"},
                       "spec": {"nodeName": "node-0002", "containers": [
                           {"name": "c", "resources": {
                               "requests": {"cpu": "100m"}}}]}}]
    return [
        ("fit_only", nodes(40), pod(cpu="700m", memory="1Gi"), [], {},
         profile_settings()),
        ("spread_hard", nodes(50, zones=5),
         pod(labels={"app": "web"}, cpu="500m", memory="1Gi",
             topologySpreadConstraints=[spread(ZONE, 2, "DoNotSchedule",
                                               "web")]), [], {},
         profile_settings()),
        ("hostname_and_zone", nodes(24, zones=3),
         pod(labels={"app": "db"}, cpu="300m",
             topologySpreadConstraints=[
                 spread(HOST, 1, "DoNotSchedule", "db"),
                 spread(ZONE, 1, "DoNotSchedule", "db")]), [], {},
         profile_settings()),
        ("taints_sampling", nodes(120, taints=True), pod(cpu="900m"), [], {},
         profile_settings(pct=40)),
        ("ipa_colocate", nodes(30, zones=3),
         pod(labels={"app": "a"}, cpu="400m", affinity={"podAffinity": {
             "requiredDuringSchedulingIgnoredDuringExecution": [{
                 "topologyKey": ZONE,
                 "labelSelector": {"matchLabels": {"app": "a"}}}]}}),
         [], {}, profile_settings()),
        ("anti_affinity", nodes(20, zones=4),
         pod(labels={"app": "b"}, cpu="100m", affinity={"podAntiAffinity": {
             "requiredDuringSchedulingIgnoredDuringExecution": [{
                 "topologyKey": ZONE,
                 "labelSelector": {"matchLabels": {"app": "b"}}}]}}),
         [], {}, profile_settings()),
        ("preferred_affinity", nodes(16, zones=4),
         pod(labels={"app": "c"}, cpu="600m", affinity={"podAffinity": {
             "preferredDuringSchedulingIgnoredDuringExecution": [{
                 "weight": 50, "podAffinityTerm": {
                     "topologyKey": ZONE,
                     "labelSelector": {"matchLabels": {"tier": "cache"}}}}]}}),
         existing_cache, {}, profile_settings()),
        ("max_limit_ports", nodes(12), pod(cpu="100m",
                                           ports=[{"hostPort": 8080}]),
         [], {}, profile_settings()),
        ("most_allocated", nodes(25), pod(cpu="500m", memory="512Mi"), [], {},
         profile_settings(strategy="MostAllocated")),
        ("soft_spread", nodes(24, zones=3),
         pod(labels={"app": "soft"}, cpu="400m",
             topologySpreadConstraints=[
                 spread(ZONE, 1, "ScheduleAnyway", "soft"),
                 spread(HOST, 2, "ScheduleAnyway", "soft")]), [], {},
         profile_settings()),
        ("system_default", nodes(20, zones=4),
         dict(pod(labels={"app": "svc"}, cpu="300m"),
              metadata={"name": "p", "labels": {"app": "svc"},
                        "namespace": "default"}), [],
         {"services": [{"metadata": {"name": "s", "namespace": "default"},
                        "spec": {"selector": {"app": "svc"}}}],
          "namespaces": [{"metadata": {"name": "default"}}]},
         profile_settings()),
        ("rtc", nodes(25), pod(cpu="400m", memory="512Mi"), [], {},
         profile_settings(strategy="RequestedToCapacityRatio",
                          shape=([0.0, 50.0, 100.0], [0.0, 10.0, 0.0]))),
    ]


FUZZ_SEEDS = range(7000, 7006)


def fuzz_case(seed):
    """tests/test_fused.py's kernel-eligible mixed-family generator: fit,
    taints, hard or soft spread, required pod (anti-)affinity, sampling."""
    rng = np.random.RandomState(seed)
    node_list = nodes(int(rng.choice([12, 24, 40])), seed=seed,
                      zones=int(rng.choice([3, 4])),
                      taints=bool(rng.rand() < 0.5))
    pct = int(rng.choice([40, 70])) if rng.rand() < 0.3 else 100
    app = str(rng.choice(["web", "db", "cache"]))
    the_pod = pod(labels={"app": app},
                  cpu=f"{int(rng.choice([100, 300, 700]))}m",
                  memory=str(int(rng.choice([128, 512])) * 1024 ** 2))
    spec = the_pod["spec"]
    if rng.rand() < 0.5:
        spec["topologySpreadConstraints"] = [spread(
            str(rng.choice([ZONE, HOST])), int(rng.choice([1, 2])),
            str(rng.choice(["DoNotSchedule", "ScheduleAnyway"])), app)]
    aff = {}
    if rng.rand() < 0.3:
        aff["podAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": [{
            "topologyKey": ZONE, "labelSelector": {"matchLabels": {
                "app": str(rng.choice(["web", "db"]))}}}]}
    if rng.rand() < 0.3:
        aff["podAntiAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "topologyKey": HOST, "labelSelector": {"matchLabels": {
                    "app": str(rng.choice(["web", "db"]))}}}]}
    if aff:
        spec["affinity"] = aff
    if rng.rand() < 0.3:
        spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
    return (node_list, the_pod, [],
            {"namespaces": [{"metadata": {"name": "default"}}]},
            profile_settings(pct=pct))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _port_problem(node_list, the_pod, existing, objs, settings):
    return encode_problem(
        ClusterSnapshot.from_objects(node_list, list(existing), **objs),
        default_pod(the_pod), settings(SchedulerProfile()))


def _cases():
    return [c[1:] for c in fused_families()] + [fuzz_case(s)
                                                for s in FUZZ_SEEDS]


def _ids():
    return [c[0] for c in fused_families()] + [f"fuzz{s}" for s in FUZZ_SEEDS]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _cases(), ids=_ids())
def test_kernel_matches_plain_version_on_card(case):
    """Two 64-step windows (initial carry, then the carry the kernel left)
    through the kernel and its plain version, on the card."""
    dev = _card()
    pb = _port_problem(*case)
    cfg = tsim.static_config(pb)
    tfused.check_eligible(cfg, pb)
    consts = tsim.build_consts(pb, dev)
    pk = tfused._pack_meta(cfg, pb)
    const = tfused._pack_consts(pk, consts)
    planes, scalars = tfused._pack_carry(pk, tsim._init_carry(pb, consts))
    table = tfused.kernel_table(pk, dev)
    for _window in range(2):
        launches = tfused.LAUNCHES
        kern = tfused.fused_steps(const, planes, scalars, table, 64)
        plain = tfused.fused_steps_reference(const, planes, scalars, table,
                                             64)
        torch.cuda.synchronize()
        assert tfused.LAUNCHES == launches + 1
        for a, b in zip(kern, plain):
            assert torch.equal(a, b)
        planes, scalars = kern[0], kern[1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _cases(), ids=_ids())
def test_solve_on_card_matches_cpu(case):
    """Whole solves (drive, kernel, diagnose) on the card against the same
    solve through the plain version on the CPU."""
    dev = _card()
    pb = _port_problem(*case)
    on_card = tsim.solve(pb, max_limit=200, device=dev)
    on_cpu = tsim.solve(pb, max_limit=200, device="cpu")
    assert on_card.placements == on_cpu.placements
    assert (on_card.fail_type, on_card.fail_message, on_card.fail_counts) == \
        (on_cpu.fail_type, on_cpu.fail_message, on_cpu.fail_counts)
