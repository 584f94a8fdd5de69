"""The benchmark's generators and plain reference, on the CPU."""

from __future__ import annotations

import ast
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

import portbench_tiny as pt
from portbench import harness
from portbench.reference import cluster as gen
from portbench.reference import roofline, sched

SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 40 + 3)
# scheduler_perf's pod-default.yaml: the unconstrained question
POD_DEFAULT = {"pod": {"name": "pod", "cpu": "100m", "memory": "500Mi"}}


@pytest.mark.parametrize("name", ["k8s-5000n", "gke-10000n"])
def test_generator_is_deterministic_by_seed(name):
    cfg = harness.load_json("configs", name)
    cfg["nodes"] = 300
    a = gen.make_cluster(cfg, 2 ** 31 + 5)
    b = gen.make_cluster(cfg, 2 ** 31 + 5)
    c = gen.make_cluster(cfg, 2 ** 31 + 6)
    assert a == b
    assert a != c


@pytest.mark.parametrize("name", ["k8s-5000n", "gke-10000n"])
@pytest.mark.parametrize("seed", SEEDS)
def test_generator_counts(name, seed):
    """Every seed: the stated nodes, pools, zones and residents, at full
    size."""
    cfg = harness.load_json("configs", name)
    nodes, pods = gen.make_cluster(cfg, seed)
    n = cfg["nodes"]
    assert len(nodes) == n
    assert len({x["metadata"]["name"] for x in nodes}) == n
    zones = [x["metadata"]["labels"][cfg["zone_key"]] for x in nodes]
    want = gen.split_even(n, len(cfg["zones"]))
    assert sorted((zones.count(z) for z in cfg["zones"]), reverse=True) == \
        sorted(want, reverse=True)
    cpus = [x["status"]["capacity"]["cpu"] for x in nodes]
    assert sorted(cpus.count(str(p["cpu"])) for p in cfg["pools"]) == \
        sorted(gen.split_even(n, len(cfg["pools"])))
    pools = {str(p["cpu"]): p for p in cfg["pools"]}
    for x in nodes:
        pool = pools[x["status"]["capacity"]["cpu"]]
        want_alloc = {"cpu": str(pool["cpu"]), "memory": pool["memory"],
                      "pods": str(pool["pods"])}
        want_alloc.update(pool.get("allocatable") or {})
        assert x["status"]["allocatable"] == want_alloc
    assert len(pods) == n * cfg["resident"]["per_node"]
    per_node = {}
    for p in pods:
        per_node[p["spec"]["nodeName"]] = per_node.get(
            p["spec"]["nodeName"], 0) + 1
    assert set(per_node.values()) == {cfg["resident"]["per_node"]}
    assert len(per_node) == n


def test_k8s_5000n_zone_counts():
    cfg = harness.load_json("configs", "k8s-5000n")
    assert gen.split_even(cfg["nodes"], 3) == [1667, 1667, 1666]


def test_templates_same_shapes_every_seed():
    cfg = harness.load_json("configs", "gke-10000n")
    mix = harness.load_json("traffic", "race")
    shapes = [gen.shape_classes(gen.make_templates(mix, cfg, s))
              for s in SEEDS]
    assert all(s == shapes[0] for s in shapes)
    assert sorted(shapes[0].values()) == [8, 8, 8, 8, 9, 9]
    a = gen.make_templates(mix, cfg, 1)
    assert a == gen.make_templates(mix, cfg, 1)
    assert a != gen.make_templates(mix, cfg, 2)


def _per_node_fit(cfg: dict, pod: dict) -> int:
    """Copies of pod that one node of the configuration holds next to its
    resident, by cpu, memory and pod slots."""
    pool = cfg["pools"][0]
    res = cfg["resident"]
    req = pod["spec"]["containers"][0]["resources"]["requests"]
    cpu = (gen.milli(pool["cpu"]) - gen.milli(res["cpu"])) // \
        gen.milli(req["cpu"])
    mem = (gen.units(pool["memory"]) - gen.units(res["memory"])) // \
        gen.units(req["memory"])
    return min(cpu, mem, int(pool["pods"]) - res["per_node"])


def _spread_total(zone_sizes, per_node: int, skew: int) -> int:
    """A zone spread of maxSkew `skew` over zones of equal nodes: the
    smallest zone fills, the others stop `skew` above it."""
    low = per_node * min(zone_sizes)
    return low + sum(min(per_node * z, low + skew)
                     for z in sorted(zone_sizes)[1:])


def test_full_answers_of_k8s_5000n():
    """The two answers the arithmetic fixes at full size."""
    cfg = harness.load_json("configs", "k8s-5000n")
    spread = gen.make_templates(harness.load_json("traffic", "spread"),
                                cfg, 0)[0]
    plain = gen.make_templates(POD_DEFAULT, cfg, 0)[0]
    assert _per_node_fit(cfg, spread) == _per_node_fit(cfg, plain) == 39
    zones = gen.split_even(cfg["nodes"], 3)
    assert 39 * cfg["nodes"] == 195_000
    assert _spread_total(zones, 39, 5) == 194_932


@pytest.mark.parametrize("n", [62, 64])
def test_reference_greedy_follows_the_formula(n):
    """A scaled k8s-5000n: the reference's own greedy run gives the
    formula's totals."""
    cfg = harness.load_json("configs", "k8s-5000n")
    cfg["nodes"] = n
    nodes, pods = gen.make_cluster(cfg, 3)
    cl = sched.Cluster(nodes, pods)
    for mix, total in ((harness.load_json("traffic", "spread"),
                        _spread_total(gen.split_even(n, 3), 39, 5)),
                       (POD_DEFAULT, 39 * n)):
        tpl = gen.make_templates(mix, cfg, 3)
        pb = sched.Problem(cl, [sched.encode_template(tpl[0])])
        got = sched.greedy(pb, 0)
        assert len(got) == total
        choices, st = sched.judge(pb, [0] * len(got), got)
        assert (choices[torch.float32] == np.asarray(got)).all()
        ok, ftype, msg = sched.expected_end(pb, st, 0, len(got), 0)
        assert ok and ftype == "Unschedulable"
        assert msg.startswith(f"0/{n} nodes are available: ")


def test_bfloat16_control_departs():
    """The reference in bfloat16 put in the program's place takes other
    nodes than the float32 reference on the same placements."""
    cfg = harness.load_json("configs", "k8s-5000n")
    cfg["nodes"] = 60
    nodes, pods = gen.make_cluster(cfg, 11)
    cl = sched.Cluster(nodes, pods)
    tpl = gen.make_templates(harness.load_json("traffic", "spread"), cfg, 11)
    pb = sched.Problem(cl, [sched.encode_template(tpl[0])])
    got = sched.greedy(pb, 0)
    choices, _ = sched.judge(pb, [0] * len(got), got,
                             dtypes=(torch.float32, torch.bfloat16))
    assert (choices[torch.float32] == np.asarray(got)).all()
    assert int((choices[torch.bfloat16] != choices[torch.float32]).sum()) > 0
    bf = sched.greedy(pb, 0, dtype=torch.bfloat16)
    assert bf != got


def test_reference_refuses_what_it_does_not_model():
    cfg = harness.load_json("configs", "k8s-5000n")
    cfg["nodes"] = 3
    nodes, pods = gen.make_cluster(cfg, 0)
    nodes[0]["spec"]["taints"] = [{"key": "k", "effect": "NoSchedule"}]
    with pytest.raises(NotImplementedError):
        sched.Cluster(nodes, pods)
    pod = gen.make_pod({"name": "p", "cpu": "1"})
    pod["spec"]["affinity"] = {"podAntiAffinity": {}}
    with pytest.raises(NotImplementedError):
        sched.encode_template(pod)


def _reserved(amount, tiers):
    """GKE's reservation: a share of each tier of the machine's amount."""
    out, left = Fraction(0), Fraction(amount)
    for size, share in tiers:
        take = min(left, size)
        out, left = out + take * Fraction(share), left - take
    return out


def test_gke_allocatable_follows_the_reservations():
    """Each pool's allocatable is its capacity less GKE's documented
    reservation (cpu by cores, memory by GiB rounded down to whole MiB,
    and the 100 MiB eviction threshold)."""
    cpu_tiers = [(1, "0.06"), (1, "0.01"), (2, "0.005"), (10 ** 6, "0.0025")]
    mem_tiers = [(4, "0.25"), (4, "0.2"), (8, "0.1"), (112, "0.06"),
                 (10 ** 6, "0.02")]
    for pool in harness.load_json("configs", "gke-10000n")["pools"]:
        cores = gen.units(pool["cpu"])
        gib = gen.units(pool["memory"]) // 2 ** 30
        cpu = gen.milli(pool["cpu"]) - _reserved(cores, cpu_tiers) * 1000
        mem_mi = gib * 1024 - int(_reserved(gib, mem_tiers) * 1024) - 100
        assert gen.milli(pool["allocatable"]["cpu"]) == cpu
        assert pool["allocatable"]["memory"] == f"{mem_mi}Mi"


def test_quantities():
    assert gen.milli("4") == 4000
    assert gen.milli("100m") == 100
    assert gen.units("32Gi") == 32 * 2 ** 30
    assert gen.units("500Mi") == 500 * 2 ** 20
    assert gen.units("1k") == 1000
    assert gen.milli("0.25") == 250


def test_roofline_count():
    """98 float ops a node a step for one hard spread over cpu, memory and
    pods; operations bound a step at 5,000 nodes."""
    assert roofline.step_ops(3, 1) == 98
    least = roofline.least_seconds(5000, 3, 1, steps=1000)
    assert least["bound"] == "operations"
    assert least["flops"] == 98 * 5000 * 1000
    assert least["seconds"] == pytest.approx(98 * 5000 * 1000 / 67e12)


def _imports(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(pt.BENCH_DIR, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".", 1)[0]
                    for m in _imports(os.path.join(ref, name))}
            assert not tops & {"jax", "jaxlib", "flax", "cluster_capacity_tpu",
                               "cluster_capacity_tpu_torch"}, name
