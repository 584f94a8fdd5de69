#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the fused placement kernel (cluster_capacity_tpu_torch/csrc/
fused_steps.cu) with nvcc from this checkout, then:

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
5. prints one JSON line describing the kernel, then the result line.

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
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
F32_FLOPS = 67e12            # H100 SXM float32 rate outside the tensor cores


def make_nodes(n=N_NODES, zones=N_ZONES, taint_every=0, seed=0):
    """The bench `scan` cluster: seeded 16/32/64-core, 64/128/256 GiB nodes
    with 110 pod slots, round-robin over `zones` zones."""
    rng = np.random.RandomState(seed)
    cpu = rng.choice([16000, 32000, 64000], size=n)
    mem = rng.choice([64, 128, 256], size=n)
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
            for what, a, b in zip(("carry", "scalars", "chosen"), kern, plain):
                if not torch.equal(a, b):
                    bad = (a != b).nonzero()[:5].tolist()
                    raise AssertionError(f"{name} from {label}: kernel and "
                                         f"plain {what} differ at {bad}")
            err = max_abs_err(kern, plain)
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
    line = {"kernels": [{
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
    }]}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
