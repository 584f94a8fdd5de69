#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the fused placement kernels (cluster_capacity_tpu_torch/csrc/
fused_steps.cu: the single-template entry and the batched entry) with nvcc
from this checkout, then:

1. prints the card's name and power limit and the kernel's build time;
2. holds the kernel against its plain PyTorch version on the card at 10,000
   nodes, K = 512 steps, for three encoded problems, from the initial carry
   and from the carry after 20,000 kernel steps: `chosen`, the carry planes
   and the scalars must be equal (tolerance: exact, torch.equal); then
   times the kernel at blocks of 128 to 1024 threads on the first problem;
3. runs the README oracle through ClusterCapacity on the card (52 pods, 13
   per node, "0/4 nodes are available: 4 Insufficient cpu.");
4. runs the bench `scan` cell through ClusterCapacity.run on the card —
   10,000 nodes in 16 zones, a 100m/256Mi pod with a zone DoNotSchedule
   spread of maxSkew 16, max_limit 100,000 — checks LimitReached, that the
   kernel was launched, and that the first 8,192 placements equal the plain
   version's run on the card;
5. (d) holds the batched kernel against its plain version at 10,000 nodes:
   on 8 templates of the bench sweep group and on the test-suite's
   plain / hard-spread / soft-spread kinds with 50% sampling, from the
   initial carry and after 2,048 steps (128 steps per launch), tolerance
   exact; then the batched kernel against kernel 1 for all 100 templates
   of the bench sweep group, and times one 128-step launch at B = 100
   against its plain version;
6. (e) runs the bench sweep cell through parallel.sweep.sweep on the card —
   10,000 nodes in 8 zones, 100 templates each with its own zone
   DoNotSchedule spread, max_limit 100 — checks that the batched kernel was
   launched, that every template is LimitReached at 100, and that the first
   8 equal their one-template kernel-1 solves;
7. (f) runs a limit-3 sweep of the test-suite's small-limit template mix at
   10,000 nodes on the card (closed-form fast path, its batched group, the
   batched kernel) and holds it equal to the same sweep on the CPU;
8. prints one JSON line describing both kernels, then the result line.

Every phase raises on failure, so any failure exits non-zero before the
result line.  Without a CUDA device, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_NODES = 10_000
N_ZONES = 16
K_CHECK = 512
ADVANCE_STEPS = 20_000
CHUNK = 4096
PREFIX = 2 * CHUNK           # placements held against the plain version
MAX_LIMIT = 100_000
SWEEP_TEMPLATES = 100
SWEEP_LIMIT = 100
K_BATCHED = 128              # steps per batched launch held and timed
ADVANCE_BATCHED = 2048
ZONE = "topology.kubernetes.io/zone"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
F32_FLOPS = 67e12            # H100 SXM float32 rate outside the tensor cores


def make_nodes(n=N_NODES, zones=N_ZONES, taint_every=0, seed=0,
               cpus=(16000, 32000, 64000), mems=(64, 128, 256)):
    """The bench clusters: seeded cores and GiB per node from cpus / mems,
    110 pod slots, round-robin over `zones` zones (defaults: the `scan`
    cell)."""
    rng = np.random.RandomState(seed)
    cpu = rng.choice(list(cpus), size=n)
    mem = rng.choice(list(mems), size=n)
    nodes = []
    for i in range(n):
        node = {"metadata": {"name": f"node-{i:06d}", "labels": {
                    "kubernetes.io/hostname": f"node-{i:06d}",
                    "topology.kubernetes.io/zone": f"zone-{i % zones}"}},
                "spec": {},
                "status": {"allocatable": {"cpu": f"{int(cpu[i])}m",
                                           "memory": str(int(mem[i]) * 1024 ** 3),
                                           "pods": "110"}}}
        if taint_every and i % taint_every == 0:
            node["spec"]["taints"] = [{"key": "dedicated", "value": "batch",
                                       "effect": "PreferNoSchedule"}]
        nodes.append(node)
    return nodes


def bench_pod():
    return {"metadata": {"name": "bench-pod", "labels": {"app": "bench"}},
            "spec": {"containers": [{
                "name": "c0", "image": "app:v1",
                "resources": {"requests": {"cpu": "100m",
                                           "memory": "256Mi"}}}]}}


def problems():
    """(name, nodes, pod, percentageOfNodesToScore) of the three checks."""
    sel = {"matchLabels": {"app": "bench"}}
    a = bench_pod()
    a["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": 16, "topologyKey": "topology.kubernetes.io/zone",
        "whenUnsatisfiable": "DoNotSchedule", "labelSelector": sel}]
    b = bench_pod()
    b["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
        "whenUnsatisfiable": "ScheduleAnyway", "labelSelector": sel}]
    b["spec"]["affinity"] = {"podAntiAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution": [{
            "weight": 10, "podAffinityTerm": {
                "topologyKey": "kubernetes.io/hostname",
                "labelSelector": sel}}]}}
    c = bench_pod()
    c["spec"]["affinity"] = {
        "podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
            "topologyKey": "topology.kubernetes.io/zone",
            "labelSelector": sel}]},
        "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
            "topologyKey": "kubernetes.io/hostname", "labelSelector": sel}]}}
    return [("a_scan_zone_spread", make_nodes(), a, 100),
            ("b_soft_spread_pref_anti_taints_sampled",
             make_nodes(taint_every=10), b, 50),
            ("c_zone_affinity_host_anti", make_nodes(), c, 100)]


def sweep_cell():
    """bench.py bench_sweep: 10,000 nodes in 8 zones (16/32 cores, 64/128
    GiB, seed 7) and 100 templates of 100/250/500m cpu and 256/512 MiB, each
    with a zone DoNotSchedule spread of maxSkew 4 or 8 on its own label."""
    rng = np.random.RandomState(7)
    nodes = make_nodes(zones=8, seed=7, cpus=(16000, 32000), mems=(64, 128))
    templates = []
    for k in range(SWEEP_TEMPLATES):
        templates.append({
            "metadata": {"name": f"t{k}", "labels": {"app": f"t{k}"}},
            "spec": {"containers": [{
                "name": "c", "resources": {"requests": {
                    "cpu": f"{int(rng.choice([100, 250, 500]))}m",
                    "memory": str(int(rng.choice([256, 512])) * 1024 ** 2)}}}],
                "topologySpreadConstraints": [{
                    "maxSkew": int(rng.choice([4, 8])),
                    "topologyKey": "topology.kubernetes.io/zone",
                    "whenUnsatisfiable": "DoNotSchedule",
                    "labelSelector": {"matchLabels": {"app": f"t{k}"}}}]}})
    return nodes, templates


def kinds_templates():
    """The test suite's plain, hard-spread and soft-spread template kinds
    (tests/test_sweep_batched.py _templates: plain, sp1, soft)."""
    def tpl(name, cpu, memory=None, spread=None):
        req = {"cpu": cpu}
        if memory:
            req["memory"] = memory
        spec = {"containers": [{"name": "c",
                                "resources": {"requests": req}}]}
        if spread:
            spec["topologySpreadConstraints"] = [{
                "maxSkew": spread[0], "topologyKey": ZONE,
                "whenUnsatisfiable": spread[1],
                "labelSelector": {"matchLabels": {"app": name}}}]
        return {"metadata": {"name": name, "labels": {"app": name}},
                "spec": spec}
    return [tpl("plain", "600m", "1Gi"),
            tpl("sp1", "500m", "1Gi", (2, "DoNotSchedule")),
            tpl("soft", "700m", None, (1, "ScheduleAnyway"))]


def small_limit_mix(n=N_NODES):
    """The test suite's small-limit template mix (tests/test_sweep.py: plain,
    hard spread, preferred anti-affinity, tolerations + preferred zone
    affinity, image locality) on n nodes of 4/8 cores with PreferNoSchedule
    taints on every tenth node and the image on every fourth."""
    rng = np.random.RandomState(3)
    nodes = []
    for i in range(n):
        node = {"metadata": {"name": f"n{i:05d}", "labels": {
                    "kubernetes.io/hostname": f"n{i:05d}", ZONE: f"z{i % 4}"}},
                "spec": {},
                "status": {"allocatable": {
                    "cpu": f"{int(rng.choice([4000, 8000]))}m",
                    "memory": str(16 * 1024 ** 3), "pods": "110"}}}
        if i % 10 == 0:
            node["spec"]["taints"] = [{"key": "zp", "value": "h",
                                       "effect": "PreferNoSchedule"}]
        if i % 4 == 0:
            node["status"]["images"] = [
                {"names": ["app:v1"], "sizeBytes": 400 * 1024 * 1024}]
        nodes.append(node)
    templates = []
    for k in range(15):
        sel = {"matchLabels": {"app": f"t{k}"}}
        spec = {"containers": [{"name": "c0", "image": "img", "resources": {
            "requests": {"cpu": f"{100 * (1 + k % 3)}m",
                         "memory": str(256 * 1024 ** 2)}}}]}
        kind = k % 5
        if kind == 1:
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 2, "topologyKey": ZONE,
                "whenUnsatisfiable": "DoNotSchedule", "labelSelector": sel}]
        elif kind == 2:
            spec["affinity"] = {"podAntiAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 10, "podAffinityTerm": {
                        "topologyKey": "kubernetes.io/hostname",
                        "labelSelector": sel}}]}}
        elif kind == 3:
            spec["affinity"] = {"nodeAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 5, "preference": {"matchExpressions": [{
                        "key": ZONE, "operator": "In",
                        "values": [f"z{k % 4}"]}]}}]}}
        elif kind == 4:
            spec["containers"][0]["image"] = "app:v1"
        templates.append({"metadata": {"name": f"t{k}", "namespace": "default",
                                       "labels": {"app": f"t{k}"}},
                          "spec": spec})
    return nodes, templates


def packed_group(nodes, templates, pct, dev):
    """Encode, pad and pack a template group the way parallel.sweep's
    _batched_solve does: (const, planes, scalars, tables) on dev."""
    from cluster_capacity_tpu_torch.engine import fused_batched
    from cluster_capacity_tpu_torch.engine import simulator as sim
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.parallel import sweep
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    profile = SchedulerProfile()
    profile.percentage_of_nodes_to_score = pct
    snap = ClusterSnapshot.from_objects(nodes)
    pbs = [encode_problem(snap, default_pod(t), profile) for t in templates]
    pbs, cfg = sweep._pad_group(pbs)
    consts = sweep._group_consts(pbs)
    pks, const, tables = fused_batched.pack_group(cfg, pbs, consts)
    planes, scalars = fused_batched._pack_carry_batched(
        pks, [sim._init_carry(pb, c) for pb, c in zip(pbs, consts)])
    return const.to(dev), planes.to(dev), scalars.to(dev), tables.to(dev)


def packed(nodes, pod, pct, dev):
    """Encode and pack one problem the way engine.simulator.solve does."""
    from cluster_capacity_tpu_torch.engine import fused
    from cluster_capacity_tpu_torch.engine import simulator as sim
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    profile = SchedulerProfile()
    profile.percentage_of_nodes_to_score = pct
    pb = encode_problem(ClusterSnapshot.from_objects(nodes),
                        default_pod(pod), profile)
    cfg = sim.static_config(pb)
    fused.check_eligible(cfg, pb)
    consts = sim.build_consts(pb, dev)
    pk = fused._pack_meta(cfg, pb)
    planes, scalars = fused._pack_carry(pk, sim._init_carry(pb, consts))
    return (fused._pack_consts(pk, consts), planes, scalars,
            fused.kernel_table(pk, dev))


def cuda_ms(fn, reps=1):
    """Mean milliseconds of fn() on the card, timed with CUDA events."""
    import torch
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(kern, plain):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(kern, plain))


def step_ops(table) -> int:
    """Float operations per node per step that this problem's table asks
    for (compares, selects, arithmetic; reductions counted once per node),
    tallied from the same switches the kernel reads."""
    from cluster_capacity_tpu_torch.engine.fused import IOFF
    t = table.i.cpu().tolist()
    v = lambda name, i=0: t[IOFF[name] + i]
    ops = 2                                     # static mask, write feasible
    if v("fit_filter_on"):
        ops += 3 + 3 * (v("r") - 1)
    ops += 6 * v("ch") + 2 + (5 if v("sample_k") else 0)
    if v("ipa_filter_on"):
        ops += 8 * v("g") + 4
    ops += 11 * v("n_fit") + 4 if v("w_fit") else 0
    ops += 14 * v("n_bal") + 8 if v("w_bal") else 0
    ops += 7 * bool(v("w_taint")) + 5 * bool(v("w_na")) + 3 * bool(v("w_il"))
    ops += (9 * v("cs") + 10) if v("w_spread") else 0
    ops += (3 * v("g") + 10) if v("w_ipa") else 0
    ops += 4 + 3 * v("ch") + 3 * v("cs") + 6 * v("g")   # argmax + commit
    return ops


def step_reductions(table) -> int:
    """Block-wide reductions the kernel runs in one unstopped step for this
    table (fused_steps.cu): hard-spread minima, any-feasible, the sampling
    search, the normalisers, the soft-spread min/max, the argmax."""
    from cluster_capacity_tpu_torch.engine.fused import IOFF
    t = table.i.cpu().tolist()
    v = lambda name: t[IOFF[name]]
    return (bool(v("ch")) + 1 + (v("bs_iters") if v("sample_k") else 0)
            + bool(v("w_taint") or v("w_na") or v("w_spread") or v("w_ipa"))
            + bool(v("w_spread")) + 1)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from cluster_capacity_tpu_torch import ClusterCapacity
        from cluster_capacity_tpu_torch.engine import fused
        from cluster_capacity_tpu_torch.models.podspec import default_pod
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card and build ----------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"card: {card}")
    t0 = time.perf_counter()
    lib = fused.build(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.3f} s ({lib})")

    # ---- 2. kernel vs plain version at 10,000 nodes ------------------------
    worst_err = 0.0
    timing = {}
    for name, nodes, pod, pct in problems():
        const, planes, scalars, table = packed(nodes, pod, pct, dev)
        step_bytes = 4 * (const.numel() + planes.numel())
        print(f"{name}: {const.shape[0]} const + {planes.shape[0]} carry "
              f"planes, {step_bytes} bytes read per step -> "
              f"{step_bytes / HBM_BYTES_PER_S * 1e6:.3f} us at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s; {step_reductions(table)} "
              f"block-wide reductions per step")
        starts = [("initial", planes, scalars)]
        adv_p, adv_s = planes, scalars
        for _ in range(ADVANCE_STEPS // 4000):
            adv_p, adv_s, _ch = fused.fused_steps(const, adv_p, adv_s, table,
                                                  4000)
        starts.append((f"after {ADVANCE_STEPS} steps", adv_p, adv_s))
        for label, p0, s0 in starts:
            kern = fused.fused_steps(const, p0, s0, table, K_CHECK)
            torch.cuda.synchronize()
            t_plain = time.perf_counter()
            plain = fused.fused_steps_reference(const, p0, s0, table, K_CHECK)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t_plain) * 1e3
            k_ms = cuda_ms(lambda: fused.fused_steps(const, p0, s0, table,
                                                     K_CHECK), reps=3)
            err = _assert_equal(kern, plain, f"{name} from {label}")
            worst_err = max(worst_err, err)
            placed = int((kern[2] >= 0).sum())
            print(f"check {name} from {label}: equal (max_abs_err {err}), "
                  f"{placed}/{K_CHECK} placed, kernel "
                  f"{k_ms / K_CHECK * 1e3:.2f} us/step, plain "
                  f"{plain_ms / K_CHECK * 1e3:.1f} us/step")
            timing[(name, label)] = (k_ms, plain_ms)

    # block-size sweep on problem (a): the kernel is written for any
    # multiple of 32 threads; the package launches fused.THREADS
    name, nodes, pod, pct = problems()[0]
    const, planes, scalars, table = packed(nodes, pod, pct, dev)
    default_threads = fused.THREADS
    ref = fused.fused_steps(const, planes, scalars, table, K_CHECK)
    try:
        for threads in (128, 256, 512, 1024):
            fused.THREADS = threads
            out = fused.fused_steps(const, planes, scalars, table, K_CHECK)
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError(f"{threads}-thread blocks disagree")
            ms = cuda_ms(lambda: fused.fused_steps(const, planes, scalars,
                                                   table, K_CHECK), reps=3)
            print(f"block of {threads} threads, {name}: "
                  f"{ms / K_CHECK * 1e3:.2f} us/step, equal")
    finally:
        fused.THREADS = default_threads

    # ---- 3. README oracle through ClusterCapacity on the card -----------
    demo_pod = default_pod({"metadata": {"name": "p"}, "spec": {"containers": [
        {"name": "c", "resources": {"requests": {"cpu": "150m",
                                                 "memory": "100Mi"}}}]}})
    demo_nodes = [{"metadata": {"name": f"n{i}"}, "spec": {},
                   "status": {"allocatable": {"cpu": "2", "memory": "4Gi",
                                              "pods": "110"}}}
                  for i in range(4)]
    cc = ClusterCapacity(demo_pod)
    cc.sync_with_objects(demo_nodes)
    r = cc.run()
    assert r.placed_count == 52, r.placed_count
    assert set(r.per_node_counts.values()) == {13}, r.per_node_counts
    assert r.fail_message == "0/4 nodes are available: 4 Insufficient cpu.", \
        r.fail_message
    print(f"README oracle on {cc.device}: {r.placed_count} pods, "
          f"{r.per_node_counts}, {r.fail_type}: {r.fail_message}")

    # ---- 4. the bench scan cell at full width ----------------------------
    name, nodes, pod, pct = problems()[0]
    cc = ClusterCapacity(default_pod(pod), max_limit=MAX_LIMIT)
    cc.sync_with_objects(nodes)
    fused.LAUNCHES = 0
    t0 = time.perf_counter()
    r = cc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused.LAUNCHES
    assert r.fail_type == "LimitReached", (r.fail_type, r.fail_message)
    assert r.placed_count == MAX_LIMIT, r.placed_count
    assert launches > 0, "the main path never launched the kernel"
    print(f"scan cell: {r.placed_count} placements in {wall:.3f} s "
          f"({r.placed_count / wall:.0f} placements/s, encode included), "
          f"{launches} kernel launches, {r.fail_type}: {r.fail_message}")

    const, planes, scalars, table = packed(nodes, pod, pct, dev)
    kern_chosen = []
    p, s = planes, scalars
    for _ in range(PREFIX // CHUNK):
        p, s, ch = fused.fused_steps(const, p, s, table, CHUNK)
        kern_chosen.append(ch)
    kern_chosen = torch.cat(kern_chosen).reshape(-1).cpu()
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    plain = fused.fused_steps_reference(const, planes, scalars, table, PREFIX)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_plain) * 1e3 / (PREFIX // CHUNK)
    plain_chosen = plain[2].reshape(-1).cpu()
    main_path = np.asarray(r.placements[:PREFIX])
    assert np.array_equal(main_path, plain_chosen.numpy()), \
        "main-path placements differ from the plain version's"
    assert torch.equal(kern_chosen, plain_chosen)
    worst_err = max(worst_err, float((kern_chosen - plain_chosen).abs().max()))
    k_ms = cuda_ms(lambda: fused.fused_steps(const, planes, scalars, table,
                                             CHUNK), reps=3)
    print(f"first {PREFIX} placements equal the plain version's; one "
          f"{CHUNK}-step launch: kernel {k_ms:.3f} ms, plain {plain_ms:.1f} ms")

    # bound of one CHUNK-step launch: every operand moved once, and the
    # per-node float work of every step at the float32 rate
    n_bytes = 4 * (const.numel() + 2 * planes.numel() + 2 * scalars.numel()
                   + table.i.numel() + table.f.numel() + CHUNK)
    n_ops = step_ops(table) * N_NODES * CHUNK
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOPS * 1e3
    print(f"bound of one launch: {n_bytes} bytes -> {bytes_ms:.6f} ms, "
          f"{n_ops} float ops -> {ops_ms:.6f} ms")
    kernels = [{
        "name": "fused_steps",
        "route": "cuda",
        "source": "cluster_capacity_tpu_torch/csrc/fused_steps.cu",
        "replaces": "cluster_capacity_tpu/engine/fused.py:464",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]
    kernels.append(batched_phases(dev))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _assert_equal(kern, plain, what):
    """torch.equal on (carry, scalars, chosen); returns max_abs_err."""
    import torch
    for name, a, b in zip(("carry", "scalars", "chosen"), kern, plain):
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: {name} differs at {bad}")
    return max_abs_err(kern, plain)


def batched_phases(dev) -> dict:
    """Phases (d)-(f): the batched kernel at 10,000 nodes, the bench sweep
    cell through sweep() on the card, and the small-limit sweep on the card
    against the CPU.  Returns the batched kernel's entry of the kernels
    line."""
    import torch
    from cluster_capacity_tpu_torch.engine import fused, fused_batched
    from cluster_capacity_tpu_torch.engine import simulator as sim
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.engine.fused import KernelTable
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.parallel import sweep as sweep_mod
    from cluster_capacity_tpu_torch.parallel.sweep import sweep
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    batched = fused_batched.fused_steps_batched
    plain_batched = fused_batched.fused_steps_batched_reference
    k = K_BATCHED

    # ---- (d) batched kernel vs plain version at 10,000 nodes --------------
    worst_err = 0.0
    sweep_nodes, sweep_tpls = sweep_cell()
    const, planes, scalars, tables = packed_group(sweep_nodes, sweep_tpls,
                                                  100, dev)
    sub = lambda t, b=8: t[:b].contiguous()
    kinds = packed_group(sweep_nodes, kinds_templates(), 50, dev)
    for name, group in (("bench sweep group, 8 of its templates",
                         (sub(const), sub(planes), sub(scalars),
                          KernelTable(sub(tables.i), sub(tables.f)))),
                        ("plain/hard/soft kinds, 50% sampling", kinds)):
        g_const, g_planes, g_scalars, g_tables = group
        starts = [("initial", g_planes, g_scalars)]
        adv_p, adv_s = g_planes, g_scalars
        for _ in range(ADVANCE_BATCHED // k):
            adv_p, adv_s, _ch = batched(g_const, adv_p, adv_s, g_tables, k)
        starts.append((f"after {ADVANCE_BATCHED} steps", adv_p, adv_s))
        for label, p0, s0 in starts:
            kern = batched(g_const, p0, s0, g_tables, k)
            plain = plain_batched(g_const, p0, s0, g_tables, k)
            torch.cuda.synchronize()
            err = _assert_equal(kern, plain, f"(d) {name} from {label}")
            worst_err = max(worst_err, err)
            print(f"(d) {name} from {label}: B={g_const.shape[0]}, {k} "
                  f"steps, kernel == plain version (max_abs_err {err}), "
                  f"{int((kern[2] >= 0).sum())} placed")

    b_all = const.shape[0]
    kern = batched(const, planes, scalars, tables, k)
    for b in range(b_all):
        one = fused.fused_steps(const[b], planes[b], scalars[b:b + 1],
                                KernelTable(tables.i[b], tables.f[b]), k)
        _assert_equal((kern[0][b], kern[1][b:b + 1], kern[2][b]), one,
                      f"(d) batched vs kernel 1, template {b}")
    torch.cuda.synchronize()
    print(f"(d) batched kernel == kernel 1 for all {b_all} templates of the "
          f"bench sweep group ({k} steps each)")

    # per-step time against group size: the slabs of B templates share the
    # 50 MB L2
    for b in (1, 8, 16, 32, 48, 64, 80):
        g = (sub(const, b), sub(planes, b), sub(scalars, b),
             KernelTable(sub(tables.i, b), sub(tables.f, b)))
        ms = cuda_ms(lambda: batched(*g, k), reps=3)
        mb = 4 * (g[0].numel() + g[1].numel()) / 1e6
        print(f"(d) batched launch at B={b}: {ms / k * 1e3:.2f} us/step, "
              f"{mb:.1f} MB of const + carry planes")
    b_ms = cuda_ms(lambda: batched(const, planes, scalars, tables, k),
                   reps=3)
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    plain = plain_batched(const, planes, scalars, tables, k)
    torch.cuda.synchronize()
    b_plain_ms = (time.perf_counter() - t_plain) * 1e3
    worst_err = max(worst_err, _assert_equal(kern, plain,
                                             "(d) timed B=100 launch"))
    step_bytes = 4 * (const.numel() + planes.numel()) // b_all
    n_bytes = 4 * (const.numel() + 2 * planes.numel() + 2 * scalars.numel()
                   + tables.i.numel() + tables.f.numel() + b_all * k)
    n_ops = sum(step_ops(KernelTable(tables.i[b], tables.f[b]))
                for b in range(b_all)) * N_NODES * k
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOPS * 1e3
    print(f"(d) one {k}-step batched launch at B={b_all}: kernel "
          f"{b_ms:.3f} ms ({b_ms / k * 1e3:.2f} us/step), plain "
          f"{b_plain_ms:.1f} ms; {const.shape[1]} const + {planes.shape[1]} "
          f"carry planes, {step_bytes} bytes per template-step, "
          f"{step_reductions(KernelTable(tables.i[0], tables.f[0]))} "
          f"block-wide reductions per template-step; bound {n_bytes} bytes "
          f"-> {bytes_ms:.6f} ms, {n_ops} float ops -> {ops_ms:.6f} ms")

    # ---- (e) the bench sweep cell through sweep() on the card -------------
    snapshot = ClusterSnapshot.from_objects(sweep_nodes)
    pods = [default_pod(t) for t in sweep_tpls]
    classes = len({sweep_mod._solve_signature(
        encode_problem(snapshot, p, SchedulerProfile()), {}) for p in pods})
    fused.LAUNCHES = 0
    fused_batched.LAUNCHES = 0
    t0 = time.perf_counter()
    results = sweep(snapshot, pods, max_limit=SWEEP_LIMIT, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_batched.LAUNCHES
    single = fused.LAUNCHES
    assert launches > 0, "the sweep never launched the batched kernel"
    placed = sum(r.placed_count for r in results)
    for r in results:
        assert (r.fail_type, r.placed_count, r.rung) == \
            ("LimitReached", SWEEP_LIMIT, "fused_batched"), \
            (r.fail_type, r.placed_count, r.rung, r.fail_message)
    for b in range(8):
        pb = encode_problem(snapshot, pods[b], SchedulerProfile())
        alone = sim.solve(pb, max_limit=SWEEP_LIMIT, device=dev)
        assert alone.placements == results[b].placements, b
    print(f"(e) sweep cell: {len(results)} templates x {SWEEP_LIMIT}, "
          f"{placed} placements in {wall:.3f} s ({placed / wall:.0f} "
          f"placements/s, encode included), {classes} behaviour classes "
          f"solved as one batched group, {launches} batched launches, "
          f"{single} kernel-1 launches; every template LimitReached at "
          f"{SWEEP_LIMIT}; the first 8 equal their kernel-1 solves")

    # ---- (f) small-limit sweep on the card == on the CPU ------------------
    mix_nodes, mix_tpls = small_limit_mix()
    snapshot = ClusterSnapshot.from_objects(mix_nodes)
    pods = [default_pod(t) for t in mix_tpls]
    before = fused_batched.LAUNCHES
    on_card = sweep(snapshot, pods, max_limit=3, device=dev)
    assert fused_batched.LAUNCHES > before
    on_cpu = sweep(snapshot, pods, max_limit=3, device="cpu")
    for b, (x, y) in enumerate(zip(on_card, on_cpu)):
        assert x.placements == y.placements, b
        assert (x.fail_type, x.fail_message, x.fail_counts, x.rung) == \
            (y.fail_type, y.fail_message, y.fail_counts, y.rung), b
    rungs = sorted({r.rung or "(fast path group)" for r in on_card})
    assert "(fast path group)" in rungs and "fused_batched" in rungs, rungs
    print(f"(f) small-limit sweep (limit 3) of {len(pods)} templates at "
          f"{len(mix_nodes)} nodes: card == CPU, rungs {rungs}")

    return {
        "name": "fused_steps_batched",
        "route": "cuda",
        "source": "cluster_capacity_tpu_torch/csrc/fused_steps.cu",
        "replaces": "cluster_capacity_tpu/engine/fused_batched.py:148",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": b_ms,
        "plain_ms": b_plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


if __name__ == "__main__":
    sys.exit(main())
