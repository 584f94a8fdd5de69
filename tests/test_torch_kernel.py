"""The CUDA kernels against their plain PyTorch versions on the card, for
every problem family and template group of the port's tests; the scan step
on the card (CUDA-graph replays) against the CPU, against eager steps on
the card and against kernel 1; whole solves and sweeps on the card against
the CPU; and the problem builders those tests share.

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
from cluster_capacity_tpu_torch.engine import fused_batched as tfb
from cluster_capacity_tpu_torch.engine import simulator as tsim
from cluster_capacity_tpu_torch.engine.encode import encode_problem
from cluster_capacity_tpu_torch.models.podspec import default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

from helpers import build_test_node, build_test_pod

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


def sweep_cluster(n=48, zones=4):
    """tests/test_sweep_batched.py's _cluster node list."""
    rng = np.random.RandomState(7)
    return [{"metadata": {"name": f"node-{i:03d}", "labels": {
                 "kubernetes.io/hostname": f"node-{i:03d}",
                 "topology.kubernetes.io/zone": f"z{i % zones}",
                 "disk": "ssd" if i % 2 else "hdd"}},
             "spec": {},
             "status": {"allocatable": {
                 "cpu": f"{int(rng.choice([4000, 8000]))}m",
                 "memory": str(int(rng.choice([8, 16])) * 1024 ** 3),
                 "pods": "24"}}}
            for i in range(n)]


def sampling_cluster():
    """tests/test_fused_batched.py's 120-node cluster (50% sampling)."""
    rng = np.random.RandomState(3)
    return [{"metadata": {"name": f"n-{i:03d}", "labels": {
                 "kubernetes.io/hostname": f"n-{i:03d}",
                 "topology.kubernetes.io/zone": f"z{i % 3}"}},
             "spec": {},
             "status": {"allocatable": {
                 "cpu": f"{int(rng.choice([2000, 4000]))}m",
                 "memory": str(int(rng.choice([4, 8])) * 1024 ** 3),
                 "pods": "16"}}}
            for i in range(120)]


def sweep_templates():
    """tests/test_sweep_batched.py's _templates mix: plain, 1- and 2-hard
    spread, soft spread, IPA affinity, IPA anti-affinity."""
    def tpl(name, cpu, memory=None, **spec):
        req = {"cpu": cpu}
        if memory:
            req["memory"] = memory
        return {"metadata": {"name": name, "labels": {"app": name}},
                "spec": dict(containers=[{"name": "c", "resources": {
                    "requests": req}}], **spec)}
    return [
        tpl("plain", "600m", "1Gi"),
        tpl("sp1", "500m", "1Gi", topologySpreadConstraints=[
            spread(ZONE, 2, "DoNotSchedule", "sp1")]),
        tpl("sp2", "400m", "2Gi", topologySpreadConstraints=[
            spread(ZONE, 1, "DoNotSchedule", "sp2"),
            spread(HOST, 3, "DoNotSchedule", "sp2")]),
        tpl("soft", "700m", topologySpreadConstraints=[
            spread(ZONE, 1, "ScheduleAnyway", "soft")]),
        tpl("aff", "300m", affinity={"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "topologyKey": ZONE,
                "labelSelector": {"matchLabels": {"app": "aff"}}}]}}),
        tpl("anti", "200m", affinity={"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "topologyKey": HOST,
                "labelSelector": {"matchLabels": {"app": "anti"}}}]}}),
    ]


def soft_pair():
    """Two soft-spread templates whose soft rows count different numbers of
    domains (zone: 4, rack: 2), so the group's per-row domain bounds
    differ from its maximum."""
    def tpl(name, key):
        return {"metadata": {"name": name, "labels": {"app": name}},
                "spec": {"containers": [{"name": "c", "resources": {
                    "requests": {"cpu": "300m"}}}],
                    "topologySpreadConstraints": [{
                        "maxSkew": 1, "topologyKey": key,
                        "whenUnsatisfiable": "ScheduleAnyway",
                        "labelSelector": {"matchLabels": {"app": name}}}]}}
    return [tpl("soft-zone", "topology.kubernetes.io/zone"),
            tpl("soft-rack", "rack")]


def rack_cluster(n=32):
    node_list = sweep_cluster(n)
    for i, node in enumerate(node_list):
        node["metadata"]["labels"]["rack"] = f"r{i % 2}"
    return node_list


def small_limit_mix(taints=True):
    """tests/test_sweep.py's config-5 template mix on 60 nodes: (nodes,
    templates).  taints=False drops the PreferNoSchedule taints, which
    makes the plain templates eligible for the unbounded closed form."""
    rng = np.random.RandomState(3)
    nodes = []
    for i in range(60):
        node = build_test_node(
            f"n{i:03d}", int(rng.choice([4000, 8000])), 16 * 1024 ** 3, 110,
            labels={"kubernetes.io/hostname": f"n{i:03d}",
                    "topology.kubernetes.io/zone": f"z{i % 4}"})
        if taints and i % 10 == 0:
            node["spec"]["taints"] = [{"key": "zp", "value": "h",
                                       "effect": "PreferNoSchedule"}]
        if i % 4 == 0:
            node["status"]["images"] = [
                {"names": ["app:v1"], "sizeBytes": 400 * 1024 * 1024}]
        nodes.append(node)
    templates = []
    for k in range(15):
        pod = build_test_pod(f"t{k}", 100 * (1 + k % 3), 256 * 1024 ** 2,
                             labels={"app": f"t{k}"})
        kind = k % 5
        if kind == 1:
            pod["spec"]["topologySpreadConstraints"] = [{
                "maxSkew": 2, "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": f"t{k}"}}}]
        elif kind == 2:
            pod["spec"]["affinity"] = {"podAntiAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 10, "podAffinityTerm": {
                        "topologyKey": "kubernetes.io/hostname",
                        "labelSelector": {"matchLabels": {"app": f"t{k}"}}}}]}}
        elif kind == 3:
            pod["spec"]["affinity"] = {"nodeAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 5, "preference": {"matchExpressions": [{
                        "key": "topology.kubernetes.io/zone",
                        "operator": "In", "values": [f"z{k % 4}"]}]}}]}}
        elif kind == 4:
            pod["spec"]["containers"][0]["image"] = "app:v1"
        templates.append(pod)
    return nodes, templates


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


CLUSTERS = (1, 2, 4, 8, 16)


def _cluster_or_skip(cluster):
    """Skip, by name, a cluster size this card cannot schedule."""
    if cluster > tfused.max_cluster():
        pytest.skip(f"{torch.cuda.get_device_name(0)} schedules no cluster "
                    f"of {cluster} CTAs")


def _packed(pb, dev):
    cfg = tsim.static_config(pb)
    tfused.check_eligible(cfg, pb)
    consts = tsim.build_consts(pb, dev)
    pk = tfused._pack_meta(cfg, pb)
    const = tfused._pack_consts(pk, consts)
    planes, scalars = tfused._pack_carry(pk, tsim._init_carry(pb, consts))
    return const, planes, scalars, tfused.kernel_table(pk, dev)


_PLAIN_WINDOWS = {}


def _plain_windows(case, dev, k=64, windows=2):
    """The packed problem and `windows` k-step windows of the plain version
    (each from the carry the last left), computed once per case."""
    key = (id(case), k, windows)
    if key not in _PLAIN_WINDOWS:
        const, planes, scalars, table = _packed(_port_problem(*case), dev)
        out = []
        for _window in range(windows):
            plain = tfused.fused_steps_reference(const, planes, scalars,
                                                 table, k)
            out.append(((planes, scalars), plain))
            planes, scalars = plain[0], plain[1]
        _PLAIN_WINDOWS[key] = (const, table, out)
    return _PLAIN_WINDOWS[key]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", _cases(), ids=_ids())
def test_kernel_matches_plain_version_on_card(case, cluster):
    """Two 64-step windows (initial carry, then the carry the first left)
    through the kernel on a cluster of `cluster` CTAs and through its plain
    version, on the card."""
    dev = _card()
    _cluster_or_skip(cluster)
    const, table, windows = _plain_windows(case, dev)
    for (planes, scalars), plain in windows:
        launches = tfused.LAUNCHES
        kern = tfused.fused_steps(const, planes, scalars, table, 64,
                                  cluster=cluster)
        torch.cuda.synchronize()
        assert tfused.LAUNCHES == launches + 1
        assert tfused.LAST_PLAN.cluster == cluster
        for a, b in zip(kern, plain):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_partial_residency_on_card():
    """65,536 nodes (MAX_NODES) with a soft zone and hostname spread: the
    plan keeps only part of the planes in shared memory, the rest in device
    memory; kernel == plain version over two 32-step windows."""
    dev = _card()
    case = (nodes(65_536, zones=8, taints=True),
            pod(labels={"app": "soft"}, cpu="400m", memory="256Mi",
                topologySpreadConstraints=[
                    spread(ZONE, 1, "ScheduleAnyway", "soft"),
                    spread(HOST, 2, "ScheduleAnyway", "soft")]),
            [], {}, profile_settings())
    const, table, windows = _plain_windows(case, dev, k=32)
    planes = windows[0][0][0]
    plan = tfused.card_plan(const.shape[1] * tfused.LANES, const.shape[0],
                            planes.shape[0])
    assert plan.resident < tfused.SCRATCH_PLANES + const.shape[0] \
        + planes.shape[0]
    for (planes, scalars), plain in windows:
        kern = tfused.fused_steps(const, planes, scalars, table, 32)
        torch.cuda.synchronize()
        assert tfused.LAST_PLAN == plan
        for a, b in zip(kern, plain):
            assert torch.equal(a, b)


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


# ---------------------------------------------------------------------------
# the scan step on the card
# ---------------------------------------------------------------------------

STEP_MODES = {"float32": (False, True), "parity": (True, True),
              "random": (False, False), "parity_random": (True, False)}


def _step_problem(case, mode):
    node_list, the_pod, existing, objs, settings = case
    dtype64, deterministic = STEP_MODES[mode]

    def apply(p):
        p = settings(p)
        if dtype64:
            p.compute_dtype = "float64"
        p.deterministic, p.seed = deterministic, 3
        return p
    return _port_problem(node_list, the_pod, existing, objs, apply)


def _step_cases():
    return [c for c in fused_families()
            if c[0] in ("hostname_and_zone", "taints_sampling",
                        "preferred_affinity", "soft_spread", "rtc")]


def _assert_same_carry(a, b, what):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert torch.equal(x.cpu(), y.cpu()), (what, name)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(STEP_MODES))
@pytest.mark.parametrize("case", _step_cases(), ids=lambda c: c[0])
def test_step_on_card_matches_cpu(case, mode):
    """100 scan steps (graphs of 64 + 36 steps) on the card against the
    same steps on the CPU: chosen and every carry field, the PRNG key
    included."""
    dev = _card()
    pb = _step_problem(case[1:], mode)
    cfg = tsim.static_config(pb)
    out = []
    for where in (dev, "cpu"):
        consts = tsim.build_consts(pb, where)
        out.append(tsim.run_chunk(cfg, consts, tsim._init_carry(pb, consts),
                                  100))
    (card_carry, card_chosen), (cpu_carry, cpu_chosen) = out
    assert torch.equal(card_chosen.cpu(), cpu_chosen)
    _assert_same_carry(card_carry, cpu_carry, mode)


@pytest.mark.cuda
def test_graph_replay_matches_eager_on_card():
    """The captured graphs against the same steps run eagerly on the card,
    over two chunks (the second replays the cached graphs from the carry
    the first left) and for a second problem of the same shapes (the
    graph's static consts are refilled)."""
    import dataclasses
    dev = _card()
    pb = _step_problem(_step_cases()[0][1:], "parity_random")
    heavier = dataclasses.replace(pb, req_vec=pb.req_vec * 2)
    for pb in (pb, heavier):
        cfg = tsim.static_config(pb)
        consts = tsim.build_consts(pb, dev)
        g_carry = e_carry = tsim._init_carry(pb, consts)
        for _chunk in range(2):
            g_carry, g_chosen = tsim.run_chunk(cfg, consts, g_carry, 70)
            e_carry, e_chosen = tsim._eager_steps(cfg, consts, e_carry, 70)
            assert torch.equal(g_chosen, e_chosen)
            _assert_same_carry(g_carry, e_carry, "graph vs eager")


@pytest.mark.cuda
@pytest.mark.parametrize("case", fused_families(), ids=lambda c: c[0])
def test_kernel_matches_float32_step_on_card(case):
    """Kernel 1 against the float32 scan step, both on the card, 64 steps
    from the initial carry: chosen and the carry unpacked from the kernel's
    planes."""
    dev = _card()
    pb = _port_problem(*case[1:])
    cfg = tsim.static_config(pb)
    consts = tsim.build_consts(pb, dev)
    carry = tsim._init_carry(pb, consts)
    pk = tfused._pack_meta(cfg, pb)
    planes, scalars = tfused._pack_carry(pk, carry)
    k_planes, k_scalars, k_chosen = tfused.fused_steps(
        tfused._pack_consts(pk, consts), planes, scalars,
        tfused.kernel_table(pk, dev), 64)
    s_carry, s_chosen = tsim.run_chunk(cfg, consts, carry, 64)
    assert torch.equal(s_chosen, k_chosen[:, 0])
    _assert_same_carry(s_carry, tfused._unpack_carry(pk, k_planes, k_scalars,
                                                     carry), "kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["parity", "random"])
def test_step_solve_on_card_matches_cpu(mode):
    """Whole solves routed to the scan step (kernel 1 not launched) on the
    card against the CPU."""
    dev = _card()
    pb = _step_problem(_step_cases()[0][1:], mode)
    launches = tfused.LAUNCHES
    on_card = tsim.solve(pb, max_limit=150, device=dev)
    assert tfused.LAUNCHES == launches
    on_cpu = tsim.solve(pb, max_limit=150, device="cpu")
    assert on_card.placements == on_cpu.placements
    assert (on_card.fail_type, on_card.fail_message, on_card.fail_counts) == \
        (on_cpu.fail_type, on_cpu.fail_message, on_cpu.fail_counts)


# ---------------------------------------------------------------------------
# the batched kernel and the sweep
# ---------------------------------------------------------------------------

BATCHED_GROUPS = {
    "sweep_templates_48": lambda: (sweep_cluster(), sweep_templates(), 100),
    "sampling_120_nodes_50pct": lambda: (
        sampling_cluster(), [t for t in sweep_templates()
                             if t["metadata"]["name"] in
                             ("plain", "sp1", "soft")], 50),
    "soft_domain_counts_differ": lambda: (rack_cluster(), soft_pair(), 100),
}


def port_groups(node_list, templates, pct):
    """Every batchable group of >= 2 templates, grouped as the sweep does."""
    profile = profile_settings(pct=pct)(SchedulerProfile())
    snap = ClusterSnapshot.from_objects(node_list)
    groups = {}
    for t in templates:
        pb = encode_problem(snap, default_pod(t), profile)
        if tsweep._batchable(pb):
            key = tsweep._group_key(pb, tsim.static_config(pb))
            groups.setdefault(key, []).append(pb)
    return [g for g in groups.values() if len(g) >= 2]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BATCHED_GROUPS))
def test_batched_kernel_matches_plain_version_on_card(case):
    """Two 64-step windows of every group through the batched kernel and
    its plain version, on the card."""
    dev = _card()
    groups = port_groups(*BATCHED_GROUPS[case]())
    assert groups
    for pbs in groups:
        padded, cfg = tsweep._pad_group(pbs)
        consts = tsweep._group_consts(padded)
        pks, const, tables = tfb.pack_group(cfg, padded, consts)
        planes, scalars = tfb._pack_carry_batched(
            pks, [tsim._init_carry(pb, c) for pb, c in zip(padded, consts)])
        const, planes, scalars = const.to(dev), planes.to(dev), \
            scalars.to(dev)
        tables = tables.to(dev)
        for _window in range(2):
            launches = tfb.LAUNCHES
            kern = tfb.fused_steps_batched(const, planes, scalars, tables, 64)
            plain = tfb.fused_steps_batched_reference(const, planes, scalars,
                                                      tables, 64)
            torch.cuda.synchronize()
            assert tfb.LAUNCHES == launches + 1
            for a, b in zip(kern, plain):
                assert torch.equal(a, b)
            planes, scalars = kern[0], kern[1]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", (2, 4, 16))
def test_batched_kernel_cluster_on_card(cluster):
    """The batched kernel with every template on a cluster of `cluster`
    CTAs (grid B x C) == its plain version, on the test suite's template
    mix grouped as the sweep groups it."""
    dev = _card()
    _cluster_or_skip(cluster)
    groups = port_groups(*BATCHED_GROUPS["sweep_templates_48"]())
    for pbs in groups:
        padded, cfg = tsweep._pad_group(pbs)
        consts = tsweep._group_consts(padded)
        pks, const, tables = tfb.pack_group(cfg, padded, consts)
        planes, scalars = tfb._pack_carry_batched(
            pks, [tsim._init_carry(pb, c) for pb, c in zip(padded, consts)])
        const, planes, scalars = const.to(dev), planes.to(dev), \
            scalars.to(dev)
        tables = tables.to(dev)
        kern = tfb.fused_steps_batched(const, planes, scalars, tables, 64,
                                       cluster=cluster)
        plain = tfb.fused_steps_batched_reference(const, planes, scalars,
                                                  tables, 64)
        torch.cuda.synchronize()
        assert tfb.LAST_PLAN.cluster == cluster
        for a, b in zip(kern, plain):
            assert torch.equal(a, b)


SWEEPS = {
    "template_mix_limit40": lambda: (sweep_cluster(), sweep_templates(), 40),
    "template_mix_unlimited": lambda: (sweep_cluster(24), sweep_templates(),
                                       0),
    "small_limit_mix_3": lambda: small_limit_mix() + (3,),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_sweep_on_card_matches_cpu(case):
    """Whole sweeps (fast path, batched kernel, kernel 1, diagnose) on the
    card against the same sweep on the CPU."""
    dev = _card()
    node_list, templates, max_limit = SWEEPS[case]()
    snap = ClusterSnapshot.from_objects(node_list)
    pods = [default_pod(t) for t in templates]
    launches = tfb.LAUNCHES
    on_card = tsweep.sweep(snap, pods, max_limit=max_limit, device=dev)
    assert tfb.LAUNCHES > launches
    on_cpu = tsweep.sweep(snap, pods, max_limit=max_limit, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.placements == b.placements
        assert (a.fail_type, a.fail_message, a.fail_counts, a.rung) == \
            (b.fail_type, b.fail_message, b.fail_counts, b.rung)


# ---------------------------------------------------------------------------
# the fault ladder and DefaultPreemption on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_real_cuda_oom_is_device_oom():
    """An allocation larger than the card, inside guard.run: PyTorch's
    OutOfMemoryError is classified DeviceOOM, and the card still serves."""
    from cluster_capacity_tpu_torch.runtime import faults, guard
    from cluster_capacity_tpu_torch.runtime.errors import DeviceOOM
    dev = _card()
    total = torch.cuda.get_device_properties(dev).total_memory
    with pytest.raises(DeviceOOM) as ei:
        guard.run(lambda: torch.empty(4 * total, dtype=torch.uint8,
                                      device=dev), site=faults.SITE_SOLVE)
    assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)
    assert int(torch.ones(4, device=dev).sum()) == 4


def _ladder_problem(spread_on):
    the_pod = pod(name="probe", labels={"app": "probe"}, cpu="500m",
                  memory="256Mi")
    if spread_on:
        the_pod["spec"]["topologySpreadConstraints"] = [
            spread(ZONE, 1, "DoNotSchedule", "probe")]
    return encode_problem(ClusterSnapshot.from_objects(nodes(64)),
                          default_pod(the_pod), SchedulerProfile())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["oom", "hang", "corrupt"])
def test_ladder_on_card_matches_cpu(kind):
    """engine.solve faults on the card descend as on the CPU: a fit-only
    problem to the closed form (fast_path), a spread problem to the oracle
    (after kernel 1 ran, for corrupt); same numbers as the healthy run."""
    from cluster_capacity_tpu_torch.runtime import degrade, faults
    dev = _card()
    for spread_on, rung in ((False, "fast_path"), (True, "oracle")):
        pb = _ladder_problem(spread_on)
        healthy = degrade.solve_one_guarded(pb, max_limit=100, device=dev)
        assert (healthy.rung, healthy.degraded) == ("fused", False)
        out = []
        for where in (dev, "cpu"):
            launches = tfused.LAUNCHES
            with faults.inject(f"engine.solve:{kind}"):
                out.append(degrade.solve_one_guarded(pb, max_limit=100,
                                                     device=where))
            if where == dev and spread_on and kind == "corrupt":
                assert tfused.LAUNCHES > launches
        for r in out:
            assert (r.rung, r.degraded) == (rung, True)
            assert r.placements == healthy.placements
            assert (r.fail_type, r.fail_message, r.fail_counts) == \
                (healthy.fail_type, healthy.fail_message,
                 healthy.fail_counts)


def preemption_case(n=48, zones=4):
    """A small priority/PDB cluster for DefaultPreemption: 4-core nodes in
    `zones` zones; low-priority fillers on four nodes (a PDB of
    disruptionsAllowed 1 over one node's); a high-priority template with a
    zone spread."""
    node_list = [{"metadata": {"name": f"p{i:03d}", "labels": {
                      HOST: f"p{i:03d}", ZONE: f"z{i % zones}"}},
                  "spec": {},
                  "status": {"allocatable": {"cpu": "4", "memory": "16Gi",
                                             "pods": "32"}}}
                 for i in range(n)]
    pods = []
    for i in (0, 1, 5, 9):
        for k in range(2):
            pods.append({
                "metadata": {"name": f"f{i}-{k}", "namespace": "default",
                             "labels": {"guarded": str(i == 0).lower()}},
                "spec": {"nodeName": f"p{i:03d}", "priorityClassName": "low",
                         "containers": [{"name": "c", "resources": {
                             "requests": {"cpu": "1", "memory": "1Gi"}}}]}})
    the_pod = pod(name="vip", labels={"app": "vip"}, cpu="1500m",
                  memory="1Gi", priorityClassName="high",
                  topologySpreadConstraints=[
                      spread(ZONE, 2, "DoNotSchedule", "vip")])
    objs = {"priority_classes": [{"metadata": {"name": "low"}, "value": 0},
                                 {"metadata": {"name": "high"},
                                  "value": 1000}],
            "pdbs": [{"metadata": {"name": "g", "namespace": "default"},
                      "spec": {"maxUnavailable": 1, "selector": {
                          "matchLabels": {"guarded": "true"}}},
                      "status": {"disruptionsAllowed": 1}}]}
    return node_list, pods, the_pod, objs


@pytest.mark.cuda
def test_preemption_on_card_matches_cpu():
    """ClusterCapacity.run with DefaultPreemption on the card (kernel 1 in
    every cycle) against device="cpu": placements, messages, rung stamps,
    evictions and post_run_snapshot rosters."""
    from cluster_capacity_tpu_torch import ClusterCapacity
    dev = _card()
    node_list, pods, the_pod, objs = preemption_case()
    runs = []
    for where in (dev, "cpu"):
        profile = SchedulerProfile()
        profile.include_preemption_message = True
        cc = ClusterCapacity(default_pod(the_pod), profile=profile,
                             device=where)
        cc.sync_with_objects(node_list, pods, **objs)
        launches = tfused.LAUNCHES
        runs.append((cc, cc.run(), tfused.LAUNCHES - launches))
    (card, r_card, n_card), (cpu, r_cpu, _n) = runs
    assert n_card >= len(card.cycle_seconds) > 1
    assert card.preemptions and card.preemptions == cpu.preemptions
    assert r_card.placements == r_cpu.placements
    assert (r_card.fail_type, r_card.fail_message, r_card.fail_counts,
            r_card.rung, r_card.degraded) == \
        (r_cpu.fail_type, r_cpu.fail_message, r_cpu.fail_counts,
         r_cpu.rung, r_cpu.degraded)
    roster = lambda cc: [[(p["metadata"]["name"], p["spec"]["nodeName"])
                          for p in plist]
                         for plist in cc.post_run_snapshot.pods_by_node]
    assert roster(card) == roster(cpu)


# ---------------------------------------------------------------------------
# DRA problems and the explain step on the card
# ---------------------------------------------------------------------------

GPU = "gpu.example.com"


def dra_case(n=256, devices=8, held_every=10, zones=4):
    """A DRA cluster: every node publishes `devices` devices of DeviceClass
    gpu.example.com (attributes model a100/h100 and memory 40/80Gi
    alternating); existing pods on every `held_every`-th node hold 2 devices
    each through a template claim (tests/test_dra.py's object shapes)."""
    node_list = nodes(n, zones=zones)
    slices = [{"metadata": {"name": f"slice-{nd['metadata']['name']}"},
               "spec": {"nodeName": nd["metadata"]["name"], "driver": GPU,
                        "devices": [{
                            "name": f"dev{j}", "deviceClassName": GPU,
                            "attributes": {f"{GPU}/model": {"string": (
                                "h100" if (i + j) % 2 else "a100")}},
                            "capacity": {f"{GPU}/memory": {"value": (
                                "80Gi" if j % 2 else "40Gi")}}}
                            for j in range(devices)]}}
              for i, nd in enumerate(node_list)]
    tmpls = [{"metadata": {"name": f"gpu-{c}", "namespace": "default"},
              "spec": {"spec": {"devices": {"requests": [
                  {"name": "r0", "deviceClassName": GPU, "count": c}]}}}}
             for c in (1, 2, 4)]
    held = []
    for i in range(0, n, held_every):
        p = pod(name=f"held-{i}", cpu="100m")
        p["metadata"]["namespace"] = "default"
        p["spec"]["nodeName"] = node_list[i]["metadata"]["name"]
        p["spec"]["resourceClaims"] = [{"name": "g",
                                        "resourceClaimTemplateName": "gpu-2"}]
        held.append(p)
    claim = {"metadata": {"name": "shared", "namespace": "default"},
             "spec": {"devices": {"requests": [
                 {"name": "r0", "deviceClassName": GPU, "count": 1}]}}}
    objs = {"resource_slices": slices, "resource_claim_templates": tmpls,
            "resource_claims": [claim]}
    return node_list, held, objs


def dra_pod(kind, name="d", cpu="100m"):
    """A template pod: 'template' (one device per clone), 'cel' (a CEL
    selector with a capacity comparison, the structured allocator's
    dra/__slots__ column) or 'shared' (an unallocated shared claim)."""
    p = pod(name=name, labels={"app": name}, cpu=cpu)
    if kind == "shared":
        p["spec"]["resourceClaims"] = [{"name": "s",
                                        "resourceClaimName": "shared"}]
    else:
        p["spec"]["resourceClaims"] = [{
            "name": "g", "resourceClaimTemplateName":
            "gpu-1" if kind == "template" else "gpu-cel"}]
    return p


def cel_template():
    return {"metadata": {"name": "gpu-cel", "namespace": "default"},
            "spec": {"spec": {"devices": {"requests": [{
                "name": "r0", "deviceClassName": GPU, "count": 1,
                "selectors": [{"cel": {"expression":
                    f'device.attributes["{GPU}"].model == "h100" && '
                    f'device.capacity["{GPU}"].memory >= '
                    f'quantity("80Gi")'}}]}]}}}}


def dra_problem(kind, n=256):
    node_list, held, objs = dra_case(n)
    objs["resource_claim_templates"].append(cel_template())
    return encode_problem(ClusterSnapshot.from_objects(node_list, held,
                                                       **objs),
                          default_pod(dra_pod(kind)), SchedulerProfile())


def test_dra_problems_take_kernel_1():
    """The DRA problems of the card tests run on kernel 1: a device column,
    the dra/__slots__ column, and the shared-claim colocation gate; the DRA
    sweep's templates form one group kernel 2 takes (CPU)."""
    for kind in ("template", "cel", "shared"):
        pb = dra_problem(kind, n=32)
        cfg = tsim.static_config(pb)
        assert tfused.eligible(cfg, pb), kind
        assert any(r.startswith("dra/") for r in pb.resource_names)
        assert cfg.dra_shared_colocate == (kind == "shared")
    assert "dra/__slots__" in dra_problem("cel", n=32).resource_names
    node_list, held, objs = dra_case(32)
    snap = ClusterSnapshot.from_objects(node_list, held, **objs)
    pbs = []
    for c in (1, 2, 4):
        name = f"g{c}"
        t = pod(name=name, labels={"app": name}, cpu="100m",
                topologySpreadConstraints=[
                    spread(ZONE, 4, "DoNotSchedule", name)])
        t["spec"]["resourceClaims"] = [{"name": "g",
                                        "resourceClaimTemplateName":
                                        f"gpu-{c}"}]
        pbs.append(encode_problem(snap, default_pod(t), SchedulerProfile()))
    assert all(tsweep._batchable(pb) for pb in pbs)
    padded, cfg = tsweep._pad_group(pbs)
    assert all(tfused.eligible(cfg, pb) for pb in padded)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["template", "cel", "shared"])
def test_dra_kernel_matches_plain_version_on_card(kind):
    """Kernel 1 on DRA problems (shared-claim colocation included) against
    its plain version, two 64-step windows, and the whole solve card ==
    CPU."""
    dev = _card()
    pb = dra_problem(kind)
    const, planes, scalars, table = _packed(pb, dev)
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
    on_card = tsim.solve(pb, device=dev)
    on_cpu = tsim.solve(pb, device="cpu")
    assert on_card.placements == on_cpu.placements
    assert (on_card.fail_message, on_card.fail_counts) == \
        (on_cpu.fail_message, on_cpu.fail_counts)


@pytest.mark.cuda
def test_dra_sweep_on_card_matches_cpu():
    """A sweep of DRA templates (1/2/4 devices x three cpu sizes), each
    with its own zone spread (which keeps it off the closed form): kernel 2
    with the device column, card == CPU per template."""
    dev = _card()
    node_list, held, objs = dra_case(128)
    templates = []
    for c in (1, 2, 4):
        for cpu in ("100m", "250m", "500m"):
            name = f"g{c}-{cpu}"
            t = pod(name=name, labels={"app": name}, cpu=cpu,
                    topologySpreadConstraints=[
                        spread(ZONE, 4, "DoNotSchedule", name)])
            t["spec"]["resourceClaims"] = [{
                "name": "g", "resourceClaimTemplateName": f"gpu-{c}"}]
            templates.append(default_pod(t))
    snap = ClusterSnapshot.from_objects(node_list, held, **objs)
    launches = tfb.LAUNCHES
    on_card = tsweep.sweep(snap, templates, max_limit=100, device=dev)
    assert tfb.LAUNCHES > launches
    on_cpu = tsweep.sweep(snap, templates, max_limit=100, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.placements == b.placements
        assert (a.fail_type, a.fail_message, a.fail_counts, a.rung) == \
            (b.fail_type, b.fail_message, b.fail_counts, b.rung)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float32", "parity", "random"])
def test_explain_step_on_card_matches_cpu(mode):
    """solve(explain=True) on the card (the explain step under CUDA-graph
    replay) against the CPU: placements and Explanation.to_dict(); its
    placements equal the explain-off solve's (kernel 1 in float32)."""
    dev = _card()
    case = fuzz_case(FUZZ_SEEDS[0])
    node_list, the_pod, existing, objs, _settings = case
    profile = SchedulerProfile.parity() if mode == "parity" \
        else SchedulerProfile()
    if mode == "random":
        profile.deterministic, profile.seed = False, 5
    pb = encode_problem(ClusterSnapshot.from_objects(node_list,
                                                     list(existing), **objs),
                        default_pod(the_pod), profile)
    on_card = tsim.solve(pb, max_limit=300, device=dev, explain=True)
    on_cpu = tsim.solve(pb, max_limit=300, device="cpu", explain=True)
    plain = tsim.solve(pb, max_limit=300, device=dev)
    assert on_card.placements == on_cpu.placements == plain.placements
    assert on_card.explain.to_dict() == on_cpu.explain.to_dict()
    assert on_card.explain.rung == "scan"
