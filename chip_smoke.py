#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the fused placement kernels (cluster_capacity_tpu_torch/csrc/
fused_steps.cu: the single-template entry and the batched entry) with nvcc
from this checkout, then:

1. prints the card's name and power limit, the kernel's build time, the
   ptxas lines of both entries (registers, shared memory, spills) and the
   largest thread-block cluster the card schedules;
2. holds the kernel against its plain PyTorch version on the card at 10,000
   nodes, K = 512 steps, for three encoded problems, from the initial carry
   and from the carry after 20,000 kernel steps, at the launch plan's
   cluster size and at every cluster size of 1, 2, 4, 8 and 16 CTAs the card
   schedules: `chosen`, the carry planes and the scalars must be equal
   (tolerance: exact, torch.equal); times the kernel at each cluster size
   on the first problem; and holds it equal at 65,536 nodes, where the plan
   keeps only part of the planes in shared memory;
3. runs the README oracle through ClusterCapacity on the card (52 pods, 13
   per node, "0/4 nodes are available: 4 Insufficient cpu.");
4. runs the bench `scan` cell through ClusterCapacity.run on the card —
   10,000 nodes in 16 zones, a 100m/256Mi pod with a zone DoNotSchedule
   spread of maxSkew 16, max_limit 100,000 — checks LimitReached, that the
   kernel was launched, and that the first 8,192 placements equal the plain
   version's run on the card; prints the launch plan it used, and the
   latency floor: the same table flags at 128 nodes, where the reductions
   and barriers are all a step does;
5. (d) holds the batched kernel against its plain version at 10,000 nodes:
   on 8 templates of the bench sweep group and on the test-suite's
   plain / hard-spread / soft-spread kinds with 50% sampling, from the
   initial carry and after 2,048 steps (128 steps per launch), tolerance
   exact; then the batched kernel against kernel 1 for all 100 templates
   of the bench sweep group; times 128-step launches from B = 1 to 100
   (with the plan's cluster size at each B) and the latency floor at
   B = 100, and the B = 100 launch against its plain version;
6. (e) runs the bench sweep cell through parallel.sweep.sweep on the card —
   10,000 nodes in 8 zones, 100 templates each with its own zone
   DoNotSchedule spread, max_limit 100 — checks that the batched kernel was
   launched, that every template is LimitReached at 100, and that the first
   8 equal their one-template kernel-1 solves;
7. (f) runs a limit-3 sweep of the test-suite's small-limit template mix at
   10,000 nodes on the card (closed-form fast path, its batched group, the
   batched kernel) and holds it equal to the same sweep on the CPU;
8. (g) runs DefaultPreemption through ClusterCapacity.run on the card at
   full width: the scan cell's 10,000 nodes with PriorityClasses low and
   high, low-priority fillers on 4 nodes of 16 cores (a PDB over one
   node's), a high-priority 4 cpu / 8 GiB template with the scan cell's
   zone spread, include_preemption_message on; checks that kernel 1 ran,
   that evictions happened and every victim has lower priority than the
   template, validate_result, rung "fused" and not degraded; prints the
   cycles, victims and PDB violations per eviction, the placements, the
   fail message and the host seconds of encode, solve, evaluate and commit
   summed over cycles; then holds the same scenario at 512 nodes on the
   card equal to device="cpu" (placements, messages, evictions,
   post_run_snapshot rosters);
9. (h) fault-ladder drills on the card: engine.solve:oom / :hang / :corrupt
   on a 10,000-node fit-only problem serve from rung fast_path, degraded,
   with the healthy placements; a real torch.cuda.OutOfMemoryError inside
   guard.run is DeviceOOM; engine.solve:corrupt on a 256-node spread
   problem (limit 200) runs kernel 1 and descends to the oracle, equal to
   the oracle run directly; both card rungs faulted on a fit-only problem
   leave the host oracle to serve, with the healthy numbers; the sweep
   cell's group under parallel.solve_group:oom:1:1 splits and keeps its
   placements; an `error` fault propagates raw;
10. (i) the scan step on the card — the engine of every problem kernel 1
   does not take: the README demo under SchedulerProfile.parity() through
   ClusterCapacity.run (52 pods, 13 per node); the scan cell under parity
   at full width, max_limit 10,000 (LimitReached, kernel 1 not launched,
   the first 2,048 placements equal to a device="cpu" run), with the
   step's us/step under CUDA-graph replay and eagerly, and placements/s;
   the float32 step's chunk runner against kernel 1 on the scan cell for
   4,096 steps (chosen and the unpacked carry equal), us/step of both; the
   random tie-break (seed 0) on the README demo and on the scan cell for
   2,048 placements, card == CPU; 70,000 nodes (beyond the kernel's
   65,536) with the scan pod, max_limit 2,048, the first 256 placements
   equal to the CPU's; phase (g)'s scenario under parity at 512 nodes,
   card == CPU; the bench sweep cell under parity, every template
   LimitReached at 100, card == CPU;
11. (j) DRA at full width: the scan cell's 10,000 nodes, each with a
   ResourceSlice of 8 devices of DeviceClass gpu.example.com (every tenth
   node's 2 held by an existing pod's template claim): (j).1 the scan pod
   with a one-device template claim, (j).2 with a CEL selector and a
   capacity comparison (the structured allocator's dra/__slots__ column),
   (j).3 with an unallocated shared claim (kernel 1's shared-claim
   colocation gate; kernel 1 == its plain version over the whole budget),
   all through ClusterCapacity.run on kernel 1, card == CPU on the whole
   run (the CPU runs of (j).1 and (j).2 take minutes, so a child process
   started with the script makes them while the card runs phases (a)-(i));
   (j).4 a sweep of
   24 DRA templates at limit 100 on kernel 2, card == CPU; from_objects
   through the native snapshot compiler and in Python on the scan cell,
   equal arrays, with both times;
12. (k) explain at full width: (k).1 the scan pod with explain, limit
   10,000 (the explain step under CUDA-graph replay, placements equal to
   the explain-off solve on kernel 1, Explanation.to_dict() card == CPU on
   the first 1,024), us/step of the explain step beside the scan step's;
   (k).2 the closed form's explain on a 10,000-node fit-only problem; (k).3
   the sweep cell with explain and solve_group(explain=True) on its
   12-class group (kernel 2's terminal carry), card == CPU; (k).4
   engine.solve:corrupt with explain at 256 nodes, served and attributed
   by the oracle, card == CPU;
13. (l) the front end at full width: (l).1 ClusterCapacity.sync_with_client
   over a duck-typed client serving the scan cell's 10,000 nodes, limit
   20,000, on kernel 1, placements equal to sync_with_objects'; (l).2 the
   snapshot saved and loaded as an .npz checkpoint (digest equal, the run
   after load equal, a flipped byte raises CheckpointCorruption); (l).3 the
   cluster-capacity CLI in-process with --watch --period 0.01
   --period-iterations 3 -o json on a JSON snapshot rewritten once: two
   loads, every iteration on kernel 1 and not degraded, with each
   iteration's seconds; (l).4 scheduler extenders: callable filter and
   prioritize extenders at limit 2,000 and a local HTTP extender
   (filter, prioritize, bind) at limit 200, card == CPU (the CPU runs are
   made by a second child process, `chip_smoke.py --frontend-cpu`, started
   with the script), with placements/s and the per-cycle split (device
   compute, host copy, chains);
14. (m) telemetry on the scan cell at limit 20,000: (m).1 the
   cluster-capacity CLI with --metrics-dump, --trace-out, --profile-out
   and --flight-dir (the Prometheus text parses, the trace holds
   degrade.solve_one > guard:engine.solve at rung fused, attribution.json
   and the torch.profiler trace exist and the trace holds kernel 1's
   launches, the attribution's engine.solve device seconds are at least
   kernel 1's CUDA-event time over the same launches); (m).2 the same
   with --inject-fault engine.solve:oom on the spread-free pod (the
   closed form serves it; the scan pod would descend to the host oracle):
   one flight bundle whose kernel.txt names kernel 1's plan, the repro
   line, degraded; (m).3 `hypercc profile solve` and `sweep` with
   calibration on the card; (m).4 placements/s with telemetry on and off
   (one warm-up run, then four rounds of off, on, on, off);
15. (n) resilience on the scan cell's 10,000 nodes with a resident pod
   (500m / 1 GiB, priority 0) on every 50th node, through `hypercc
   resilience` over every single-node failure (deduped) and every zone:
   (n).1 the zone-spread pod at --max-limit 2,000 (sequential scenarios on
   kernel 1, drains through ClusterCapacity), (n).2 the spread-free pod
   with bounds (every batched row proved by bracket_group's device shot,
   not degraded) and with --no-bounds (the same rows through kernel 2's
   scenario group; (n).2's pair reuses the drains (n).1 made on the same
   cluster, and the first kernel-2 launch at full width is held against
   its plain version over its first K_HELD steps); the same three sweeps
   at 2,000 nodes and --max-limit 200 card == CPU on the whole report
   JSON (a third child process, `chip_smoke.py --resilience-cpu`, started
   when (n) starts, makes the CPU runs).  (m) and (n) run after (i) and
   before (j), so the card works while (j)'s CPU child runs;
16. (o) interleaved shared-state sweeps of the bench's 50-template mix
   (zone DoNotSchedule spreads, 100/250/500m) on the sweep cell's 10,000
   nodes: (o).1 interleave.sweep_interleaved_auto at max_total 20,000 on
   the card — the interleave engine served (guard parallel.interleave ok
   at rung interleave, not degraded, no kernel launched: its step is torch
   ops under CUDA-graph replay), pops/s and us/pop; (o).2 the same with
   the bench's callable Filter+Prioritize extender; (o).3 bounds=True:
   bracket_mix's device auction == its float64 host mirror, not degraded,
   answers equal (o).1's; (o).4 `cluster-capacity --interleave` on three
   podspecs of the mix; (o).5 a tiered mix with victims, host ports and a
   PDB at 1,000 nodes; (o).1, (o).2 (at max_total 2,048), (o).4 and (o).5
   card == CPU, the CPU runs made by a fourth child, `chip_smoke.py
   --interleave-cpu`, started before (j);
17. (p) the capacity daemon at full width: serve.Supervisor over a
   SnapshotStore of the scan cell's 10,000 nodes, 20 iterations under a
   delta script holding every delta class and one malformed delta: the
   scan pod at limit 20,000 (kernel 1), the fit-only 4 cpu / 8 GiB pod
   (the closed form), 12 sweep templates coalesced into one solve_group
   (kernel 2); every answer == a fresh offline solve on its rung; serve's
   first kernel-1 and kernel-2 launches == their plain versions over 16
   steps; cc_recompiles_total flat once every delta class has been seen;
   queries/s and p50/p99 latency; a parallel.solve_group:oom burst opens
   the batched breaker (the group pinned per item on kernel 1, equal
   answers) and engine.solve:oom pins the fit-only pod to fast_path, both
   closed by their half-open probes; `hypercc serve --deltas ...
   --iterations 5 --strict` exits 0; the port's soak in smoke mode exits 0
   within 60 s;
18. (q) the device mesh on the card, a logical 2×2 mesh of the one card
   (four node shards taking turns in one process, two mesh rows): (q).1
   the scan cell through ClusterCapacity(mesh=...) at limit 2,000 and
   (q).2 at 65,536 nodes, limit 512, each == the unsharded run on kernel
   1 (placements, fail type, message), rung sharded_batched, no kernel
   launched on the mesh, with seconds and ms/step; (q).3 the sweep cell
   at limit 100 == kernel 2's group answers; (q).4 bracket_group over the
   resilience cell's zones and 48 single-node failures, lower/upper/
   exact/method == unsharded, frac within float32 ulps; (q).5
   cluster-capacity, resilience and serve --strict with --mesh 1x1 (rung
   sharded_batched, status.mesh), and --mesh 2x2 exiting 1 with the JAX
   package's message; (q).6 parallel.sharded:oom served by fused_batched,
   degraded, the healthy answer; (q).7 two processes on the card over
   gloo (`chip_smoke.py --mesh-worker`, a 1x2 mesh, each loading its own
   snapshot shard) == the single-process answer; (q).8 a sampled
   soft-spread problem at 2,000 nodes on the 2×2 mesh, card == CPU ==
   kernel 1;
19. prints one JSON line describing both kernels (with the launches of
   each path that ran them), then the result line.

Every phase raises on failure, so any failure exits non-zero before the
result line.  Without a CUDA device, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
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
K_PARTIAL = 128              # steps held at 65,536 nodes
FLOOR_NODES = 128            # one lane row: the latency floor's problem
K_FLOOR = 4096
K_FLOOR_BATCHED = 1024
ADVANCE_BATCHED = 2048
ZONE = "topology.kubernetes.io/zone"
FILLER_NODES = 4             # (g): nodes holding low-priority fillers
PREEMPT_CHECK_NODES = 512    # (g): width of the card == CPU check
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
GPU = "gpu.example.com"      # (j): the DeviceClass every node publishes
DEVICES_PER_NODE = 8         # (j): devices in each node's ResourceSlice
HELD_EVERY = 10              # (j): every tenth node holds 2 devices
DRA_CHECK = 1024             # (k): card == CPU prefix at full width
EXPLAIN_LIMIT = 10_000       # (k).1
FRONTEND_LIMIT = 20_000      # (l).1-(l).3
EXT_LIMIT = 2_000            # (l).4, callable extenders
HTTP_LIMIT = 200             # (l).4, the HTTP extender
EXT_DROP_EVERY = 7           # (l).4: the filters drop index % 7 == 0
TELEMETRY_LIMIT = 20_000     # (m)
RESIDENT_EVERY = 50          # (n): a resident pod on every 50th node
RESILIENCE_LIMIT = 2_000     # (n).1 and (n).2 at full width
RES_CHECK_NODES = 2_000      # (n): the width held card == CPU
RES_CHECK_LIMIT = 200        # (n): the depth held card == CPU
K_HELD = 16                  # (n): kernel-2 steps held against the plain
TELEMETRY_ROUNDS = 4         # (m).4: rounds of off, on, on, off
INTERLEAVE_TEMPLATES = 50    # (o): the bench's interleave mix
INTERLEAVE_LIMIT = 20_000    # (o).1 and (o).3: max_total on the card
INTERLEAVE_CHECK = 2_048     # (o): the depth held card == CPU
TIERED_NODES = 1_000         # (o).5
SERVE_LIMIT = 20_000         # (p): the scan pod's limit
SERVE_ITERATIONS = 20        # (p)
SERVE_COOLDOWN = 3.0         # (p): breaker cooldown, seconds
CLI_SERVE_LIMIT = 2_000      # (p): hypercc serve --max-limit
SOAK_BUDGET_S = 60.0         # (p): the soak's time limit
MESH_LIMIT = 2_000           # (q).1: the scan pod on the 2x2 mesh
MESH_BIG_LIMIT = 512         # (q).2: at 65,536 nodes
MESH_SWEEP_LIMIT = 100       # (q).3: the sweep cell
MESH_BRACKET_SCENARIOS = 48  # (q).4: single-node scenarios (and every zone)
MESH_CHECK_NODES = 2_000     # (q).5-(q).8: width
MESH_CHECK_LIMIT = 200       # (q).5-(q).8: depth
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


def preemption_cell(n=N_NODES, zones=N_ZONES, filler_nodes=FILLER_NODES):
    """Phase (g): the scan cell's cluster (make_nodes, seed 0) with
    PriorityClasses low (0) and high (1000); on `filler_nodes` nodes of 16
    cores in the two zones of least capacity for the template, two `low`
    pods of 2 cpu / 4 GiB each; a PDB (maxUnavailable 1) over the fillers
    of the first such node; the template 4 cpu / 8 GiB, priority class
    `high`, with the scan cell's zone DoNotSchedule spread (maxSkew 16).
    The zone of least capacity fills first and bounds the others through
    the spread, so evicting the fillers there lets every cycle place more.
    Returns (nodes, pods, template, objects)."""
    nodes = make_nodes(n, zones)
    gib = 1024 ** 3

    def clones(node):
        alloc = node["status"]["allocatable"]
        return min(int(alloc["cpu"][:-1]) // 4000,
                   int(alloc["memory"]) // (8 * gib), 110)
    cap = {}
    for node in nodes:
        z = node["metadata"]["labels"][ZONE]
        cap[z] = cap.get(z, 0) + clones(node)
    pods, hosts = [], []
    for z in sorted(cap, key=lambda z: (cap[z], z))[:2]:
        hosts += [node["metadata"]["name"] for node in nodes
                  if node["metadata"]["labels"][ZONE] == z
                  and node["status"]["allocatable"]["cpu"] == "16000m"
                  ][:filler_nodes // 2]
    for i, host in enumerate(hosts):
        for k in range(2):
            pods.append({
                "metadata": {"name": f"filler-{host}-{k}",
                             "namespace": "default",
                             "labels": {"app": "filler",
                                        "guarded": str(i == 0).lower()}},
                "spec": {"nodeName": host, "priorityClassName": "low",
                         "containers": [{"name": "c", "resources": {
                             "requests": {"cpu": "2",
                                          "memory": str(4 * gib)}}}]}})
    template = {"metadata": {"name": "vip", "labels": {"app": "vip"}},
                "spec": {"priorityClassName": "high",
                         "containers": [{"name": "c", "resources": {
                             "requests": {"cpu": "4",
                                          "memory": str(8 * gib)}}}],
                         "topologySpreadConstraints": [{
                             "maxSkew": 16, "topologyKey": ZONE,
                             "whenUnsatisfiable": "DoNotSchedule",
                             "labelSelector": {
                                 "matchLabels": {"app": "vip"}}}]}}
    objs = {"priority_classes": [{"metadata": {"name": "low"}, "value": 0},
                                 {"metadata": {"name": "high"},
                                  "value": 1000}],
            "pdbs": [{"metadata": {"name": "guarded", "namespace": "default"},
                      "spec": {"maxUnavailable": 1, "selector": {
                          "matchLabels": {"guarded": "true"}}},
                      "status": {"disruptionsAllowed": 1}}]}
    return nodes, pods, template, objs


def dra_objects(n=N_NODES, zones=N_ZONES):
    """Phase (j): the scan cell's nodes, each with a ResourceSlice of
    DEVICES_PER_NODE devices of DeviceClass gpu.example.com
    (tests/test_dra.py's object shapes) whose attributes split the fleet:
    model h100 on odd and a100 on even devices, memory 80Gi or 40Gi by the
    parity of (node + device // 2); ResourceClaimTemplates of 1, 2 and 4
    devices and a CEL one (model h100 with at least 64Gi: two devices a
    node, in every zone, so the zone spread does not starve a zone); a pod
    of 100m on every HELD_EVERY-th node holding 2 devices through a
    template claim; an unallocated shared ResourceClaim of one device.
    Returns (nodes, pods, objects)."""
    nodes = make_nodes(n, zones)
    slices = [{"metadata": {"name": f"slice-{nd['metadata']['name']}"},
               "spec": {"nodeName": nd["metadata"]["name"], "driver": GPU,
                        "devices": [{
                            "name": f"dev{j}", "deviceClassName": GPU,
                            "attributes": {f"{GPU}/model": {"string": (
                                "h100" if j % 2 else "a100")}},
                            "capacity": {f"{GPU}/memory": (
                                "80Gi" if (i + j // 2) % 2 else "40Gi")}}
                            for j in range(DEVICES_PER_NODE)]}}
              for i, nd in enumerate(nodes)]

    def template(name, count, expr=None):
        req = {"name": "r0", "deviceClassName": GPU, "count": count}
        if expr:
            req["selectors"] = [{"cel": {"expression": expr}}]
        return {"metadata": {"name": name, "namespace": "default"},
                "spec": {"spec": {"devices": {"requests": [req]}}}}
    tmpls = [template(f"gpu-{c}", c) for c in (1, 2, 4)]
    tmpls.append(template(
        "gpu-cel", 1, f'device.attributes["{GPU}"].model == "h100" && '
                      f'device.capacity["{GPU}"].memory >= 68719476736'))
    held = []
    for i in range(0, n, HELD_EVERY):
        name = nodes[i]["metadata"]["name"]
        held.append({"metadata": {"name": f"held-{name}",
                                  "namespace": "default"},
                     "spec": {"nodeName": name,
                              "resourceClaims": [{
                                  "name": "g",
                                  "resourceClaimTemplateName": "gpu-2"}],
                              "containers": [{"name": "c", "resources": {
                                  "requests": {"cpu": "100m"}}}]}})
    claim = {"metadata": {"name": "shared", "namespace": "default"},
             "spec": {"devices": {"requests": [
                 {"name": "r0", "deviceClassName": GPU, "count": 1}]}}}
    return nodes, held, {"resource_slices": slices,
                         "resource_claim_templates": tmpls,
                         "resource_claims": [claim]}


_CPU_RUNS = {}     # flag -> the child process of start_cpu_runs


def outcome(r) -> dict:
    """A result's placements, fail type, message and counts, rung and
    degraded flag, in the form JSON gives back."""
    return json.loads(json.dumps({
        "placements": list(r.placements), "fail_type": r.fail_type,
        "fail_message": r.fail_message, "fail_counts": r.fail_counts,
        "rung": r.rung, "degraded": r.degraded}))


def dra_cpu_runs() -> int:
    """The child process (`chip_smoke.py --dra-cpu`, no card): (j).1's and
    (j).2's whole runs through ClusterCapacity.run on the CPU at full
    width; prints {kind: outcome + "seconds"} as one JSON line."""
    import torch
    from cluster_capacity_tpu_torch import ClusterCapacity
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    torch.set_num_threads(2)
    nodes, held, objs = dra_objects()
    snap = ClusterSnapshot.from_objects(nodes, held, **objs)
    out = {}
    for kind in ("template", "cel"):
        t0 = time.perf_counter()
        cc = ClusterCapacity(default_pod(dra_pod(kind)), device="cpu")
        cc.set_snapshot(snap)
        out[kind] = dict(outcome(cc.run()),
                         seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


def start_cpu_runs(flag: str) -> None:
    """Start `chip_smoke.py <flag>` (--dra-cpu, --frontend-cpu) in a child
    process that sees no card."""
    _CPU_RUNS[flag] = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def cpu_results(flag: str, timeout=900) -> dict:
    """Wait for the child process of `flag` and return its results."""
    proc = _CPU_RUNS[flag]
    t0 = time.perf_counter()
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{flag} CPU runs failed ({proc.returncode}):"
                           f"\n{err[-4000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    res["waited"] = time.perf_counter() - t0
    return res


def dra_pod(kind, name="dra", cpu="100m", memory="256Mi", spread=True):
    """Phase (j)'s template: the scan cell's pod (its zone spread when
    `spread`) with one claim — 'template' (one device a clone), 'cel'
    (the CEL template: the dra/__slots__ column), 'shared' (the shared
    claim), or a ResourceClaimTemplate name."""
    pod = {"metadata": {"name": name, "labels": {"app": name}},
           "spec": {"containers": [{"name": "c", "resources": {
               "requests": {"cpu": cpu, "memory": memory}}}]}}
    if spread:
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 16, "topologyKey": ZONE,
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": name}}}]
    ref = ({"resourceClaimName": "shared"} if kind == "shared" else
           {"resourceClaimTemplateName": {"template": "gpu-1",
                                          "cel": "gpu-cel"}.get(kind, kind)})
    pod["spec"]["resourceClaims"] = [dict(name="g", **ref)]
    return pod


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


def cuda_ms(fn, reps=1, rounds=3):
    """Milliseconds of fn() on the card, timed with CUDA events: the median
    over `rounds` rounds of the mean over `reps` back-to-back calls (a host
    stall between calls idles the card inside a round; the median keeps one
    such round from setting the time)."""
    import torch
    times = []
    for _ in range(rounds):
        start, stop = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return sorted(times)[len(times) // 2]


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
    """Cluster-wide reductions the kernel runs in one unstopped step for
    this table (fused_steps.cu): hard-spread minima, the sampling search,
    the normalisers (any-feasible rides them, else it is one of its own),
    the soft-spread min/max, the argmax."""
    from cluster_capacity_tpu_torch.engine.fused import IOFF
    t = table.i.cpu().tolist()
    v = lambda name: t[IOFF[name]]
    return (bool(v("ch")) + (v("bs_iters") if v("sample_k") else 0) + 1
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
    start_cpu_runs("--dra-cpu")
    start_cpu_runs("--frontend-cpu")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card and build ----------------------------------------------
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    lib = fused.build()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s ({lib})")

    print("ptxas:")
    for line in fused.ptxas_report():
        print(f"  {line}")
    print(f"clusters the card holds at once (1024 threads, "
          f"{fused.SMEM_DYNAMIC} bytes of shared memory per CTA), by "
          f"cluster size: {fused.cluster_slots()}")

    # ---- 2. kernel vs plain version at 10,000 nodes ------------------------
    # at the plan's cluster (timed) and at every cluster size of the sweep
    sizes = [c for c in fused.CLUSTER_SIZES if c <= fused.max_cluster()]
    skipped = [c for c in fused.CLUSTER_SIZES if c > fused.max_cluster()]
    if skipped:
        print(f"cluster sizes {skipped}: not schedulable on this card")
    worst_err = 0.0
    for name, nodes, pod, pct in problems():
        const, planes, scalars, table = packed(nodes, pod, pct, dev)
        step_bytes = 4 * (const.numel() + planes.numel())
        plan = fused.card_plan(const.shape[1] * fused.LANES, const.shape[0],
                               planes.shape[0])
        print(f"{name}: {const.shape[0]} const + {planes.shape[0]} carry "
              f"planes, {step_bytes} bytes read per step -> "
              f"{step_bytes / HBM_BYTES_PER_S * 1e6:.3f} us at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s; {step_reductions(table)} "
              f"cluster-wide reductions per step; plan: {plan.describe()}")
        starts = [("initial", planes, scalars)]
        adv_p, adv_s = planes, scalars
        for _ in range(ADVANCE_STEPS // 4000):
            adv_p, adv_s, _ch = fused.fused_steps(const, adv_p, adv_s, table,
                                                  4000)
        starts.append((f"after {ADVANCE_STEPS} steps", adv_p, adv_s))
        for label, p0, s0 in starts:
            torch.cuda.synchronize()
            t_plain = time.perf_counter()
            plain = fused.fused_steps_reference(const, p0, s0, table, K_CHECK)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t_plain) * 1e3
            kern = fused.fused_steps(const, p0, s0, table, K_CHECK)
            err = _assert_equal(kern, plain, f"{name} from {label}")
            worst_err = max(worst_err, err)
            k_ms = cuda_ms(lambda: fused.fused_steps(const, p0, s0, table,
                                                     K_CHECK), reps=3)
            for c in sizes:
                out = fused.fused_steps(const, p0, s0, table, K_CHECK,
                                        cluster=c)
                worst_err = max(worst_err, _assert_equal(
                    out, plain, f"{name} from {label} at cluster {c}"))
            placed = int((kern[2] >= 0).sum())
            print(f"check {name} from {label}: equal (max_abs_err {err}) at "
                  f"the plan's cluster {plan.cluster} and at clusters "
                  f"{sizes}, {placed}/{K_CHECK} placed, kernel "
                  f"{k_ms / K_CHECK * 1e3:.2f} us/step, plain "
                  f"{plain_ms / K_CHECK * 1e3:.1f} us/step")

    # cluster-size sweep on problem (a)
    name, nodes, pod, pct = problems()[0]
    const, planes, scalars, table = packed(nodes, pod, pct, dev)
    ref = fused.fused_steps(const, planes, scalars, table, K_CHECK)
    sweep_us = {}
    for c in sizes:
        out = fused.fused_steps(const, planes, scalars, table, K_CHECK,
                                cluster=c)
        _assert_equal(out, ref, f"cluster {c} against the plan's")
        ms = cuda_ms(lambda: fused.fused_steps(const, planes, scalars, table,
                                               K_CHECK, cluster=c), reps=3)
        sweep_us[c] = ms / K_CHECK * 1e3
        print(f"cluster of {c} CTAs, {name}: {sweep_us[c]:.2f} us/step, "
              f"equal ({fused.LAST_PLAN.describe()})")

    # 65,536 nodes (MAX_NODES): the plan keeps part of the planes in device
    # memory
    name, _nodes, pod, pct = problems()[1]
    const, planes, scalars, table = packed(
        make_nodes(n=fused.MAX_NODES, taint_every=10), pod, pct, dev)
    plain = fused.fused_steps_reference(const, planes, scalars, table,
                                        K_PARTIAL)
    kern = fused.fused_steps(const, planes, scalars, table, K_PARTIAL)
    worst_err = max(worst_err, _assert_equal(kern, plain, "65,536 nodes"))
    plan = fused.LAST_PLAN
    total = fused.SCRATCH_PLANES + const.shape[0] + planes.shape[0]
    assert plan.resident < total, plan
    ms = cuda_ms(lambda: fused.fused_steps(const, planes, scalars, table,
                                           K_PARTIAL), reps=3)
    print(f"{name} at {fused.MAX_NODES} nodes: kernel == plain version over "
          f"{K_PARTIAL} steps, {plan.resident} of {total} planes resident "
          f"({plan.describe()}), {ms / K_PARTIAL * 1e3:.2f} us/step")

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
    main_plan = fused.LAST_PLAN
    print(f"scan cell: {r.placed_count} placements in {wall:.3f} s "
          f"({r.placed_count / wall:.0f} placements/s, encode included), "
          f"{launches} kernel launches, {r.fail_type}: {r.fail_message}")
    print(f"launch plan of the main path: {main_plan.describe()}")

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
          f"{CHUNK}-step launch: kernel {k_ms:.3f} ms "
          f"({k_ms / CHUNK * 1e3:.2f} us/step), plain {plain_ms:.1f} ms")

    # latency floor: the same table flags at one lane row, where node work
    # is nil and the reductions and barriers are all that is left
    floor = latency_floor(packed(make_nodes(n=FLOOR_NODES), pod, pct, dev),
                          fused.fused_steps, main_plan.cluster)

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
        "cluster": main_plan.cluster,
        "floor_us_per_step": floor,
    }]
    kernels.append(batched_phases(dev))
    preempt_launches = preemption_phase()
    ladder_phase(dev)
    step_phase(dev, k_ms / CHUNK * 1e3)
    # (m) and (n) run before (j), whose CPU child runs for minutes: the
    # card does their work meanwhile instead of (j) waiting for the child
    tele = telemetry_phase(dev)
    res = resilience_phase(dev)
    # (o)'s CPU runs take a child about a minute: it works while (j)-(l) run
    start_cpu_runs("--interleave-cpu")
    dra = dra_phase(dev)
    expl = explain_phase(dev, k_ms / CHUNK * 1e3)
    front = frontend_phase(dev)
    interleave_phase(dev)
    serve = serve_phase(dev)
    mesh = mesh_phase(dev, card)
    by_path = {"scan": launches, "preemption": preempt_launches,
               "dra": dra["kernel1"], "frontend": front["kernel1"],
               "telemetry": tele["kernel1"], "profile": tele["profile1"],
               "resilience": res["kernel1"], "serve": serve["kernel1"],
               **{path: n["kernel1"] for path, n in mesh.items()}}
    kernels[0]["launches"] = sum(by_path.values())
    kernels[0]["launches_by_path"] = by_path
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], serve["err"])
    by_path = {"sweep": kernels[1]["launches"], "dra_sweep": dra["kernel2"],
               "explain_group": expl["kernel2"],
               "profile": tele["profile2"], "resilience": res["kernel2"],
               "serve": serve["kernel2"],
               **{path: n["kernel2"] for path, n in mesh.items()}}
    kernels[1]["launches"] = sum(by_path.values())
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], res["err"],
                                    serve["err"])
    kernels[1]["launches_by_path"] = by_path
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def latency_floor(problem, launch, cluster, k=K_FLOOR) -> float:
    """us/step of k live steps of `launch` on a FLOOR_NODES-node problem at
    `cluster` CTAs and at one; returns the former."""
    import torch
    const, planes, scalars, tables = problem
    out = {}
    for c in sorted({1, cluster}):
        run = lambda: launch(const, planes, scalars, tables, k, cluster=c)
        chosen = run()[2]
        torch.cuda.synchronize()
        assert bool((chosen >= 0).all()), "the floor problem stopped early"
        out[c] = cuda_ms(run, reps=2) / k * 1e3
    print(f"latency floor ({FLOOR_NODES} nodes, same table flags, "
          f"{k} steps): " + ", ".join(
              f"{us:.3f} us/step at cluster {c}" for c, us in out.items()))
    return out[cluster]


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

    # per-step time against group size: the plan keeps B x C <= 132, and
    # the slabs of B templates share the 50 MB L2
    for b in (1, 8, 12, 16, 32, 48, 64, 80):
        g = (sub(const, b), sub(planes, b), sub(scalars, b),
             KernelTable(sub(tables.i, b), sub(tables.f, b)))
        batched(*g, k)
        ms = cuda_ms(lambda: batched(*g, k), reps=3)
        mb = 4 * (g[0].numel() + g[1].numel()) / 1e6
        print(f"(d) batched launch at B={b}: {ms / k * 1e3:.2f} us/step, "
              f"{mb:.1f} MB of const + carry planes; "
              f"{fused_batched.LAST_PLAN.describe()}")
    b_ms = cuda_ms(lambda: batched(const, planes, scalars, tables, k),
                   reps=3)
    b_plan = fused_batched.LAST_PLAN
    print(f"(d) batched launch at B={b_all}: {b_ms / k * 1e3:.2f} us/step; "
          f"{b_plan.describe()}")
    b_floor = latency_floor(packed_group(make_nodes(n=FLOOR_NODES, zones=8,
                                                    seed=7),
                                         sweep_tpls, 100, dev),
                            batched, b_plan.cluster, k=K_FLOOR_BATCHED)
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
    print(f"(e) launch plan of the sweep's batched group: "
          f"{fused_batched.LAST_PLAN.describe()}")
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
        "cluster": b_plan.cluster,
        "floor_us_per_step": b_floor,
    }


def preemption_phase() -> int:
    """Phase (g).  Returns kernel 1's launches in the full-width run."""
    import torch
    from cluster_capacity_tpu_torch import ClusterCapacity
    from cluster_capacity_tpu_torch.engine import fused
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.ops.priority_sort import resolve_priority
    from cluster_capacity_tpu_torch.runtime import guard
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    def run(n, device=None):
        nodes, pods, template, objs = preemption_cell(n=n)
        profile = SchedulerProfile()
        profile.include_preemption_message = True
        cc = ClusterCapacity(default_pod(template), profile=profile,
                             device=device)
        cc.sync_with_objects(nodes, pods, **objs)
        return cc, pods, template, objs

    cc, pods, template, objs = run(N_NODES)
    fused.LAUNCHES = 0
    t0 = time.perf_counter()
    r = cc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused.LAUNCHES
    assert launches > 0, "the preemption loop never launched kernel 1"
    assert cc.preemptions, "no eviction at full width"
    pcs = objs["priority_classes"]
    mine = resolve_priority(template, pcs)
    by_name = {p["metadata"]["name"]: p for p in pods}
    for ev in cc.preemptions:
        for v in ev["victims"]:
            assert resolve_priority(by_name[v], pcs) < mine, v
    guard.validate_result(r, N_NODES)
    assert (r.rung, r.degraded) == ("fused", False), (r.rung, r.degraded)
    assert r.fail_type == "Unschedulable", r.fail_type
    secs = {k: sum(c[k] for c in cc.cycle_seconds)
            for k in ("encode", "solve", "evaluate", "commit")}
    print(f"(g) preemption at {N_NODES} nodes on the card: "
          f"{len(cc.cycle_seconds)} solve cycles, {r.placed_count} "
          f"placements in {wall:.3f} s, {launches} kernel-1 launches, rung "
          f"{r.rung}, degraded {r.degraded}")
    for i, ev in enumerate(cc.preemptions, 1):
        print(f"(g) eviction {i}: node {ev['node']}, {len(ev['victims'])} "
              f"victims {ev['victims']}, {ev['pdb_violations']} PDB "
              f"violations")
    print(f"(g) {r.fail_type}: {r.fail_message}")
    print("(g) host seconds summed over cycles: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()) + "; per cycle: " + ", ".join(
        "/".join(f"{c[k]:.3f}" for k in ("encode", "solve", "evaluate",
                                         "commit"))
        for c in cc.cycle_seconds))

    # the same scenario at PREEMPT_CHECK_NODES nodes, card against CPU
    outs = []
    for device in (None, "cpu"):
        small, _p, _t, _o = run(PREEMPT_CHECK_NODES, device)
        outs.append((small, small.run()))
    (card, rc), (cpu, rh) = outs
    roster = lambda c: [[(p["metadata"]["name"], p["spec"]["nodeName"])
                         for p in plist]
                        for plist in c.post_run_snapshot.pods_by_node]
    assert rc.placements == rh.placements
    assert (rc.fail_type, rc.fail_message, rc.fail_counts, rc.rung,
            rc.degraded) == (rh.fail_type, rh.fail_message, rh.fail_counts,
                             rh.rung, rh.degraded)
    assert card.preemptions == cpu.preemptions and card.preemptions
    assert roster(card) == roster(cpu)
    print(f"(g) at {PREEMPT_CHECK_NODES} nodes: card == CPU ("
          f"{rc.placed_count} placements, {len(card.preemptions)} evictions, "
          f"{len(card.cycle_seconds)} cycles, equal messages and "
          f"post_run_snapshot rosters)")
    return launches


def ladder_phase(dev) -> None:
    """Phase (h): the fault ladder on the card."""
    import torch
    from cluster_capacity_tpu_torch.engine import fused, oracle
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.parallel.sweep import sweep
    from cluster_capacity_tpu_torch.runtime import degrade, faults, guard
    from cluster_capacity_tpu_torch.runtime.errors import DeviceOOM
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    def same(a, b, what):
        assert a.placements == b.placements, what
        assert (a.fail_type, a.fail_message, a.fail_counts) == \
            (b.fail_type, b.fail_message, b.fail_counts), what

    fit_only = encode_problem(ClusterSnapshot.from_objects(make_nodes()),
                              default_pod(bench_pod()), SchedulerProfile())
    healthy = degrade.solve_one_guarded(fit_only, max_limit=MAX_LIMIT,
                                        device=dev)
    assert (healthy.rung, healthy.degraded) == ("fused", False)
    for kind in ("oom", "hang", "corrupt"):
        with faults.inject(f"engine.solve:{kind}"):
            r = degrade.solve_one_guarded(fit_only, max_limit=MAX_LIMIT,
                                          device=dev)
        assert (r.rung, r.degraded) == ("fast_path", True), (kind, r.rung)
        same(r, healthy, kind)
    print(f"(h) engine.solve:oom / :hang / :corrupt at {N_NODES} nodes "
          f"(fit-only, limit {MAX_LIMIT}): rung fast_path, degraded, "
          f"{healthy.placed_count} placements equal to the healthy run")

    total = torch.cuda.get_device_properties(dev).total_memory
    try:
        guard.run(lambda: torch.empty(4 * total, dtype=torch.uint8,
                                      device=dev), site=faults.SITE_SOLVE)
        raise AssertionError("an allocation of 4x the card did not fail")
    except DeviceOOM as fault:
        assert isinstance(fault.__cause__, torch.OutOfMemoryError)
        print(f"(h) a real {type(fault.__cause__).__name__} of "
              f"{4 * total} bytes inside guard.run: {fault.code}")

    name, _nodes, pod, pct = problems()[0]
    spread_pb = encode_problem(
        ClusterSnapshot.from_objects(make_nodes(n=256)), default_pod(pod),
        SchedulerProfile())
    kernel = degrade.solve_one_guarded(spread_pb, max_limit=200, device=dev)
    before = fused.LAUNCHES
    with faults.inject("engine.solve:corrupt"):
        r = degrade.solve_one_guarded(spread_pb, max_limit=200, device=dev)
    assert fused.LAUNCHES > before, "the corrupt drill never ran kernel 1"
    assert (r.rung, r.degraded) == ("oracle", True), r.rung
    direct, _counts = oracle.simulate(spread_pb.snapshot, spread_pb.pod,
                                      spread_pb.profile, max_limit=200)
    assert r.placements == direct
    print(f"(h) engine.solve:corrupt on {name} at 256 nodes, limit 200: "
          f"kernel 1 ran, rung oracle, equal to the oracle run directly; "
          f"equal to kernel 1's healthy answer: "
          f"{r.placements == kernel.placements}")

    small = encode_problem(ClusterSnapshot.from_objects(make_nodes(n=256)),
                           default_pod(bench_pod()), SchedulerProfile())
    healthy = degrade.solve_one_guarded(small, max_limit=200, device=dev)
    with faults.inject("engine.solve:oom:1:0", "engine.fast_path:oom:1:0"):
        r = degrade.solve_one_guarded(small, max_limit=200, device=dev)
    assert (r.rung, r.degraded) == ("oracle", True), r.rung
    same(r, healthy, "both card rungs faulted")
    print("(h) both card rungs faulted (fit-only, 256 nodes, limit 200): "
          "the host oracle serves the healthy numbers")

    sweep_nodes, sweep_tpls = sweep_cell()
    snapshot = ClusterSnapshot.from_objects(sweep_nodes)
    pods = [default_pod(t) for t in sweep_tpls]
    healthy = sweep(snapshot, pods, max_limit=SWEEP_LIMIT, device=dev)
    with faults.inject("parallel.solve_group:oom:1:1"):
        split = sweep(snapshot, pods, max_limit=SWEEP_LIMIT, device=dev)
    for b, (x, y) in enumerate(zip(split, healthy)):
        same(x, y, f"template {b}")
        assert (x.rung, x.degraded) == ("fused_batched", True), x.rung
    print(f"(h) sweep cell under parallel.solve_group:oom:1:1: the group "
          f"split in halves on kernel 2, {len(split)} templates equal to "
          f"the healthy sweep, rung fused_batched, degraded")

    try:
        with faults.inject("engine.solve:error"):
            degrade.solve_one_guarded(fit_only, max_limit=MAX_LIMIT,
                                      device=dev)
        raise AssertionError("an `error` fault was absorbed by the ladder")
    except faults.SimulatedDeviceError as exc:
        print(f"(h) engine.solve:error propagated raw: {exc}")


def step_phase(dev, kernel_us_per_step: float) -> None:
    """Phase (i): the scan step on the card (engine/simulator.py run_chunk,
    CUDA-graph replays), on the problems kernel 1 does not take."""
    import torch
    from cluster_capacity_tpu_torch import ClusterCapacity
    from cluster_capacity_tpu_torch.engine import fused, fused_batched
    from cluster_capacity_tpu_torch.engine import simulator as sim
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.parallel.sweep import sweep
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    def profile(parity=False, seed=None):
        p = SchedulerProfile.parity() if parity else SchedulerProfile()
        if seed is not None:
            p.deterministic, p.seed = False, seed
        return p

    def run(nodes, pod, prof, max_limit=0, device=None, pods=(), objs=None):
        cc = ClusterCapacity(default_pod(pod), max_limit=max_limit,
                             profile=prof, device=device)
        cc.sync_with_objects(nodes, list(pods), **dict(objs or {}))
        return cc, cc.run()

    def same(a, b, what):
        assert a.placements == b.placements, what
        assert (a.fail_type, a.fail_message, a.fail_counts, a.rung,
                a.degraded) == (b.fail_type, b.fail_message, b.fail_counts,
                                b.rung, b.degraded), what

    t_phase = time.perf_counter()
    demo_pod = {"metadata": {"name": "p"}, "spec": {"containers": [
        {"name": "c", "resources": {"requests": {"cpu": "150m",
                                                 "memory": "100Mi"}}}]}}
    demo_nodes = [{"metadata": {"name": f"n{i}"}, "spec": {},
                   "status": {"allocatable": {"cpu": "2", "memory": "4Gi",
                                              "pods": "110"}}}
                  for i in range(4)]

    # ---- (i).1 README demo under parity --------------------------------
    _cc, r = run(demo_nodes, demo_pod, profile(parity=True))
    assert r.placed_count == 52, r.placed_count
    assert set(r.per_node_counts.values()) == {13}, r.per_node_counts
    assert r.fail_message == "0/4 nodes are available: 4 Insufficient cpu.", \
        r.fail_message
    print(f"(i) README demo under parity on the card: {r.placed_count} pods, "
          f"{r.per_node_counts}, {r.fail_type}: {r.fail_message}")

    # ---- (i).2 the scan cell under parity at full width -----------------
    name, nodes, pod, _pct = problems()[0]
    fused.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _cc, card = run(nodes, pod, profile(parity=True), max_limit=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert fused.LAUNCHES == 0, "the parity scan cell launched kernel 1"
    assert (card.fail_type, card.placed_count) == ("LimitReached", 10_000), \
        (card.fail_type, card.placed_count, card.fail_message)
    t0 = time.perf_counter()
    _cc, cpu = run(nodes, pod, profile(parity=True), max_limit=2048,
                   device="cpu")
    cpu_wall = time.perf_counter() - t0
    assert card.placements[:2048] == cpu.placements, \
        "parity scan cell: card differs from the CPU"
    pb = encode_problem(ClusterSnapshot.from_objects(nodes), default_pod(pod),
                        profile(parity=True))
    cfg = sim.static_config(pb)
    consts = sim.build_consts(pb, dev)
    carry = sim._init_carry(pb, consts)
    graph_ms = cuda_ms(lambda: sim.run_chunk(cfg, consts, carry, 1024))
    eager_ms = cuda_ms(lambda: sim._eager_steps(cfg, consts, carry, 64))
    print(f"(i) scan cell under parity ({name}, {N_NODES} nodes, float64): "
          f"{card.placed_count} placements in {wall:.3f} s "
          f"({card.placed_count / wall:.0f} placements/s, encode and graph "
          f"capture included), kernel-1 launches 0, {card.fail_type}; first "
          f"2048 equal the CPU's ({cpu_wall:.3f} s on the CPU); the step: "
          f"{graph_ms / 1024 * 1e3:.1f} us/step under CUDA-graph replay "
          f"(1024-step chunk), {eager_ms / 64 * 1e3:.1f} us/step eager")

    # ---- (i).3 the float32 step against kernel 1 on the scan cell -------
    pb32 = encode_problem(ClusterSnapshot.from_objects(nodes),
                          default_pod(pod), profile())
    cfg32 = sim.static_config(pb32)
    assert fused.eligible(cfg32, pb32)
    consts32 = sim.build_consts(pb32, dev)
    carry32 = sim._init_carry(pb32, consts32)
    pk = fused._pack_meta(cfg32, pb32)
    const, table = fused._pack_consts(pk, consts32), fused.kernel_table(pk,
                                                                       dev)
    planes, scalars = fused._pack_carry(pk, carry32)
    k_planes, k_scalars, k_chosen = fused.fused_steps(const, planes, scalars,
                                                      table, CHUNK)
    s_carry, s_chosen = sim.run_chunk(cfg32, consts32, carry32, CHUNK)
    assert torch.equal(s_chosen, k_chosen[:, 0]), \
        "float32 step and kernel 1 chose differently"
    unpacked = fused._unpack_carry(pk, k_planes, k_scalars, carry32)
    for field in s_carry._fields:
        assert torch.equal(getattr(s_carry, field),
                           getattr(unpacked, field)), field
    step32_ms = cuda_ms(lambda: sim.run_chunk(cfg32, consts32, carry32,
                                              1024))
    print(f"(i) float32 step == kernel 1 on the scan cell over {CHUNK} steps "
          f"(chosen and the unpacked carry); float32 step "
          f"{step32_ms / 1024 * 1e3:.1f} us/step, float64 step "
          f"{graph_ms / 1024 * 1e3:.1f} us/step, kernel 1 "
          f"{kernel_us_per_step:.2f} us/step")

    # ---- (i).4 the random tie-break, card == CPU ------------------------
    demo = [run(demo_nodes, demo_pod, profile(seed=0), device=d)[1]
            for d in (None, "cpu")]
    same(*demo, "README demo, random tie-break")
    fused.LAUNCHES = 0
    outs = [run(nodes, pod, profile(seed=0), max_limit=2048, device=d)[1]
            for d in (None, "cpu")]
    assert fused.LAUNCHES == 0
    same(*outs, "scan cell, random tie-break")
    pbr = encode_problem(ClusterSnapshot.from_objects(nodes),
                         default_pod(pod), profile(seed=0))
    cfgr = sim.static_config(pbr)
    constsr = sim.build_consts(pbr, dev)
    carryr = sim._init_carry(pbr, constsr)
    random_ms = cuda_ms(lambda: sim.run_chunk(cfgr, constsr, carryr, 1024))
    print(f"(i) random tie-break (seed 0), card == CPU: README demo "
          f"{demo[0].placed_count} pods over {demo[0].per_node_counts}; the "
          f"scan cell's {outs[0].placed_count} placements; float32 random "
          f"step {random_ms / 1024 * 1e3:.1f} us/step")

    # ---- (i).5 beyond the kernel's node cap -----------------------------
    big = make_nodes(n=70_000)
    fused.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _cc, card = run(big, pod, profile(), max_limit=2048)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert fused.LAUNCHES == 0 and card.placed_count == 2048
    _cc, cpu = run(big, pod, profile(), max_limit=256, device="cpu")
    assert card.placements[:256] == cpu.placements, "70,000 nodes: card != CPU"
    print(f"(i) 70,000 nodes (over MAX_NODES = {fused.MAX_NODES}), float32: "
          f"{card.placed_count} placements in {wall:.3f} s on the scan step, "
          f"{card.fail_type}; first 256 equal the CPU's")

    # ---- (i).6 phase (g)'s scenario under parity, card == CPU -----------
    outs = []
    for device in (None, "cpu"):
        pnodes, ppods, template, objs = preemption_cell(n=PREEMPT_CHECK_NODES)
        prof = profile(parity=True)
        prof.include_preemption_message = True
        outs.append(run(pnodes, template, prof, device=device, pods=ppods,
                        objs=objs))
    (c_card, r_card), (c_cpu, r_cpu) = outs
    same(r_card, r_cpu, "preemption under parity")
    roster = lambda c: [[(p["metadata"]["name"], p["spec"]["nodeName"])
                         for p in plist]
                        for plist in c.post_run_snapshot.pods_by_node]
    assert c_card.preemptions == c_cpu.preemptions and c_card.preemptions
    assert roster(c_card) == roster(c_cpu)
    print(f"(i) preemption under parity at {PREEMPT_CHECK_NODES} nodes: card "
          f"== CPU ({r_card.placed_count} placements, "
          f"{len(c_card.preemptions)} evictions, "
          f"{len(c_card.cycle_seconds)} cycles)")

    # ---- (i).7 the bench sweep cell under parity ------------------------
    sweep_nodes, sweep_tpls = sweep_cell()
    snapshot = ClusterSnapshot.from_objects(sweep_nodes)
    pods = [default_pod(t) for t in sweep_tpls]
    fused.LAUNCHES = fused_batched.LAUNCHES = 0
    t0 = time.perf_counter()
    on_card = sweep(snapshot, pods, profile=profile(parity=True),
                    max_limit=SWEEP_LIMIT, device=dev)
    wall = time.perf_counter() - t0
    assert fused.LAUNCHES == fused_batched.LAUNCHES == 0
    on_cpu = sweep(snapshot, pods, profile=profile(parity=True),
                   max_limit=SWEEP_LIMIT, device="cpu")
    for b, (x, y) in enumerate(zip(on_card, on_cpu)):
        assert (x.fail_type, x.placed_count) == ("LimitReached",
                                                 SWEEP_LIMIT), b
        same(x, y, f"parity sweep template {b}")
    print(f"(i) bench sweep cell under parity: {len(on_card)} templates "
          f"LimitReached at {SWEEP_LIMIT} in {wall:.3f} s on the card, rung "
          f"{on_card[0].rung}, no kernel launches, card == CPU")
    print(f"(i) phase time: {time.perf_counter() - t_phase:.1f} s")


def dra_phase(dev) -> dict:
    """Phase (j): DRA at full width (the scan cell's 10,000 nodes with
    per-node ResourceSlices).  Returns the launches of kernels 1 and 2 on
    the DRA paths: {"kernel1": n, "kernel2": n}."""
    import torch
    from cluster_capacity_tpu_torch import ClusterCapacity
    from cluster_capacity_tpu_torch.engine import fused, fused_batched
    from cluster_capacity_tpu_torch.engine import simulator as sim
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.parallel.sweep import sweep
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    def same(a, b, what):
        assert a.placements == b.placements, what
        assert (a.fail_type, a.fail_message, a.fail_counts, a.rung,
                a.degraded) == (b.fail_type, b.fail_message, b.fail_counts,
                                b.rung, b.degraded), what

    def run(snap, pod, max_limit=0, device=None, cycles=None):
        cc = ClusterCapacity(default_pod(pod), max_limit=max_limit,
                             device=device)
        cc.set_snapshot(snap)
        r = cc.run()
        if cycles is not None:
            cycles.extend(cc.cycle_seconds)
        return r

    def host_split(cycles):
        return ", ".join(f"{k} {sum(c[k] for c in cycles):.3f}"
                         for k in ("encode", "solve", "evaluate", "commit"))

    t_phase = time.perf_counter()
    nodes, held, objs = dra_objects()
    t0 = time.perf_counter()
    snap = ClusterSnapshot.from_objects(nodes, held, **objs)
    from_objects_s = time.perf_counter() - t0
    cpu_runs = cpu_results("--dra-cpu")
    launches = {"kernel1": 0, "kernel2": 0}

    for step, kind in (("(j).1", "template"), ("(j).2", "cel")):
        pod = dra_pod(kind)
        t0 = time.perf_counter()
        pb = encode_problem(snap, default_pod(pod), SchedulerProfile())
        encode_s = time.perf_counter() - t0
        cfg = sim.static_config(pb)
        assert fused.eligible(cfg, pb), step
        dra_cols = [r for r in pb.resource_names if r.startswith("dra/")]
        cycles = []
        fused.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run(snap, pod, cycles=cycles)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = fused.LAUNCHES
        assert n_launch > 0, f"{step} never launched kernel 1"
        launches["kernel1"] += n_launch
        assert r.fail_type == "Unschedulable" and r.rung == "fused", \
            (r.fail_type, r.rung, r.fail_message)
        if kind == "template":
            free = N_NODES * DEVICES_PER_NODE - 2 * (N_NODES // HELD_EVERY)
            assert 0 < r.placed_count <= free, r.placed_count
        else:
            assert "dra/__slots__" in dra_cols
            assert 0 < r.placed_count <= 2 * N_NODES
        consts = sim.build_consts(pb, dev)
        pk = fused._pack_meta(cfg, pb)
        const, table = fused._pack_consts(pk, consts), \
            fused.kernel_table(pk, dev)
        planes, scalars = fused._pack_carry(pk, sim._init_carry(pb, consts))
        k_ms = cuda_ms(lambda: fused.fused_steps(const, planes, scalars,
                                                 table, CHUNK), reps=3)
        cpu = dict(cpu_runs[kind])
        cpu_s = cpu.pop("seconds")
        assert outcome(r) == cpu, f"{step} card != CPU over the whole run"
        print(f"{step} DRA {kind} claim at {N_NODES} nodes (columns "
              f"{dra_cols}): {r.placed_count} placements in {wall:.3f} s "
              f"on kernel 1 ({n_launch} launches; one {CHUNK}-step launch "
              f"{k_ms:.3f} ms, {k_ms / CHUNK * 1e3:.2f} us/step), "
              f"{r.fail_type}: {r.fail_message}; card == CPU over the "
              f"whole run (placements, fail type, message, counts; the CPU "
              f"run {cpu_s:.1f} s in the child process, waited "
              f"{cpu_runs['waited']:.1f} s for it); host seconds: "
              f"from_objects {from_objects_s:.3f}"
              f", encode_problem {encode_s:.3f}; the run's "
              f"{len(cycles)} cycle(s) (DefaultPreemption's dry run after "
              f"an Unschedulable cycle): {host_split(cycles)}")

    # ---- (j).3 the shared claim: the colocation gate on kernel 1 ---------
    pod = dra_pod("shared")
    pb = encode_problem(snap, default_pod(pod), SchedulerProfile())
    cfg = sim.static_config(pb)
    assert cfg.dra_shared_colocate and fused.eligible(cfg, pb)
    fused.LAUNCHES = 0
    r = run(snap, pod)
    torch.cuda.synchronize()
    n_launch = fused.LAUNCHES
    assert n_launch > 0, "(j).3 never launched kernel 1"
    launches["kernel1"] += n_launch
    assert len(r.per_node_counts) == 1, r.per_node_counts
    same(r, run(snap, pod, 0, "cpu"), "(j).3 shared claim")
    budget = sim.step_budget(pb)
    consts = sim.build_consts(pb, dev)
    pk = fused._pack_meta(cfg, pb)
    const, table = fused._pack_consts(pk, consts), fused.kernel_table(pk, dev)
    planes, scalars = fused._pack_carry(pk, sim._init_carry(pb, consts))
    t0 = time.perf_counter()
    kern = fused.fused_steps(const, planes, scalars, table, budget)
    plain = fused.fused_steps_reference(const, planes, scalars, table, budget)
    err = _assert_equal(kern, plain, "(j).3 kernel 1 over the whole budget")
    check_s = time.perf_counter() - t0
    print(f"(j).3 unallocated shared claim at {N_NODES} nodes: "
          f"IT_DRA_SHARED_COLOCATE on kernel 1 ({n_launch} launches), "
          f"{r.placed_count} placements all on {list(r.per_node_counts)}, "
          f"{r.fail_type}: {r.fail_message}; card == CPU; kernel 1 == plain "
          f"version over the whole {budget}-step budget (max_abs_err {err}, "
          f"{check_s:.1f} s: stopped steps are skipped in both)")

    # ---- (j).4 a sweep of 24 DRA templates: kernel 2 with the device
    # column (each template carries its own zone spread, which keeps it off
    # the closed form and in one batched group)
    templates = []
    for c in (1, 2, 4):
        for cpu in ("100m", "250m", "500m", "1"):
            for mem in ("256Mi", "1Gi"):
                templates.append(default_pod(dra_pod(
                    f"gpu-{c}", name=f"g{c}-{cpu}-{mem}".lower(), cpu=cpu,
                    memory=mem)))
    fused.LAUNCHES = fused_batched.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = sweep(snap, templates, max_limit=SWEEP_LIMIT, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_batched = fused_batched.LAUNCHES
    assert n_batched > 0, "(j).4 never launched kernel 2"
    launches["kernel2"] += n_batched
    launches["kernel1"] += fused.LAUNCHES
    on_cpu = sweep(snap, templates, max_limit=SWEEP_LIMIT, device="cpu")
    for b, (x, y) in enumerate(zip(on_card, on_cpu)):
        same(x, y, f"(j).4 template {b}")
    rungs = sorted({x.rung for x in on_card})
    print(f"(j).4 sweep of {len(templates)} DRA templates (1/2/4 devices x "
          f"cpu 100m/250m/500m/1 x 256Mi/1Gi), limit {SWEEP_LIMIT}: "
          f"{sum(x.placed_count for x in on_card)} placements in "
          f"{wall:.3f} s, {n_batched} kernel-2 launches, rungs {rungs}; "
          f"card == CPU per template")

    # ---- native snapshot compiler vs Python on the scan cell's objects --
    from cluster_capacity_tpu_torch.models import native
    scan_nodes = make_nodes()
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = ClusterSnapshot.from_objects(scan_nodes, held, use_native=True)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = ClusterSnapshot.from_objects(scan_nodes, held, use_native=False)
    py_s = time.perf_counter() - t0
    assert nat.node_names == py.node_names
    assert nat.resource_names == py.resource_names
    for arr in ("allocatable", "requested", "nonzero_requested"):
        assert np.array_equal(getattr(nat, arr), getattr(py, arr)), arr
    print(f"(j) from_objects on the scan cell's {N_NODES} nodes and "
          f"{len(held)} pods: native {nat_s:.3f} s, Python {py_s:.3f} s, "
          f"equal arrays (libccsnap build {build_s:.3f} s)")
    print(f"(j) phase time: {time.perf_counter() - t_phase:.1f} s")
    return launches


def explain_phase(dev, kernel_us_per_step: float) -> dict:
    """Phase (k): explain at full width.  Returns kernel 2's launches on
    the group why-not path: {"kernel2": n}."""
    import torch
    from cluster_capacity_tpu_torch import ClusterCapacity
    from cluster_capacity_tpu_torch.engine import fused, fused_batched
    from cluster_capacity_tpu_torch.engine import simulator as sim
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.explain import attribution
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.parallel import sweep as sweep_mod
    from cluster_capacity_tpu_torch.runtime import degrade, faults
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    def same(a, b, what):
        assert a.placements == b.placements, what
        assert (a.fail_type, a.fail_message, a.fail_counts, a.rung,
                a.degraded) == (b.fail_type, b.fail_message, b.fail_counts,
                                b.rung, b.degraded), what
        assert (a.explain is None) == (b.explain is None), what
        if a.explain is not None:
            assert a.explain.to_dict() == b.explain.to_dict(), what

    def run(snap, pod, max_limit, explain, device=None):
        cc = ClusterCapacity(default_pod(pod), max_limit=max_limit,
                             explain=explain, device=device)
        cc.set_snapshot(snap)
        return cc.run()

    t_phase = time.perf_counter()
    # ---- (k).1 the scan cell's pod with explain -------------------------
    name, nodes, pod, _pct = problems()[0]
    snap = ClusterSnapshot.from_objects(nodes)
    fused.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    expl = run(snap, pod, EXPLAIN_LIMIT, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert fused.LAUNCHES == 0, "explain launched kernel 1"
    off = run(snap, pod, EXPLAIN_LIMIT, False)
    assert fused.LAUNCHES > 0, "the explain-off solve did not run kernel 1"
    assert expl.placements == off.placements, \
        "explain step and kernel 1 placed differently"
    e = expl.explain
    assert e.rung == "scan" and e.why_here.shape[0] == EXPLAIN_LIMIT
    same(run(snap, pod, DRA_CHECK, True),
         run(snap, pod, DRA_CHECK, True, "cpu"), "(k).1 card == CPU")
    pb = encode_problem(snap, default_pod(pod), SchedulerProfile())
    cfg = sim.static_config(pb)
    consts = sim.build_consts(pb, dev)
    carry = sim._init_carry(pb, consts)
    econsts = attribution.explain_consts(pb, consts)
    state = attribution.init_state(carry)
    explain_ms = cuda_ms(lambda: attribution.run_chunk(cfg, econsts, state,
                                                       1024))
    step_ms = cuda_ms(lambda: sim.run_chunk(cfg, consts, carry, 1024))
    print(f"(k).1 scan cell ({name}) with explain, limit {EXPLAIN_LIMIT}: "
          f"{expl.placed_count} placements in {wall:.3f} s on the explain "
          f"step (kernel-1 launches 0), equal to the explain-off solve on "
          f"kernel 1; why-here {e.why_here.shape}, "
          f"{int((e.elim_step >= 0).sum())} nodes eliminated; to_dict card "
          f"== CPU at limit {DRA_CHECK}; explain step "
          f"{explain_ms / 1024 * 1e3:.1f} us/step, scan step "
          f"{step_ms / 1024 * 1e3:.1f} us/step, kernel 1 "
          f"{kernel_us_per_step:.2f} us/step (CUDA-graph replay, 1024-step "
          f"chunks)")

    # ---- (k).2 the closed form's explain at 10,000 nodes ----------------
    big_pod = {"metadata": {"name": "big"}, "spec": {"containers": [{
        "name": "c", "resources": {"requests": {"cpu": "4",
                                                "memory": "8Gi"}}}]}}
    fit_pb = encode_problem(snap, default_pod(big_pod), SchedulerProfile())
    from cluster_capacity_tpu_torch.engine import fast_path
    outs = [fast_path.solve_fast(fit_pb, device=d, explain=True)
            for d in (dev, "cpu")]
    assert outs[0] is not None and outs[0].explain.rung == "fast_path"
    same(*outs, "(k).2 closed form")
    print(f"(k).2 fit-only 4 cpu / 8 GiB pod at {N_NODES} nodes with "
          f"explain: closed form, {outs[0].placed_count} placements, "
          f"{outs[0].fail_type}, why-here {outs[0].explain.why_here.shape}; "
          f"card == CPU (to_dict)")

    # ---- (k).3 the sweep cell with explain -------------------------------
    sweep_nodes, sweep_tpls = sweep_cell()
    ssnap = ClusterSnapshot.from_objects(sweep_nodes)
    pods = [default_pod(t) for t in sweep_tpls]
    t0 = time.perf_counter()
    on_card = sweep_mod.sweep(ssnap, pods, max_limit=SWEEP_LIMIT,
                              explain=True, device=dev)
    wall = time.perf_counter() - t0
    on_cpu = sweep_mod.sweep(ssnap, pods, max_limit=SWEEP_LIMIT,
                             explain=True, device="cpu")
    for b, (x, y) in enumerate(zip(on_card, on_cpu)):
        same(x, y, f"(k).3 sweep template {b}")
        assert x.explain is not None and x.placed_count == SWEEP_LIMIT
    reps, seen = [], set()
    for p in pods:
        pbt = encode_problem(ssnap, p, SchedulerProfile())
        sig = sweep_mod._solve_signature(pbt, {})
        if sig not in seen:
            seen.add(sig)
            reps.append(pbt)
    fused_batched.LAUNCHES = 0
    group = sweep_mod.solve_group(reps, max_limit=SWEEP_LIMIT, explain=True,
                                  device=dev)
    n_batched = fused_batched.LAUNCHES
    assert n_batched > 0, "(k).3 solve_group never launched kernel 2"
    for b, (x, y) in enumerate(zip(group, sweep_mod.solve_group(
            reps, max_limit=SWEEP_LIMIT, explain=True, device="cpu"))):
        same(x, y, f"(k).3 group template {b}")
        assert x.explain.rung == "fused_batched"
    print(f"(k).3 sweep cell with explain: {len(on_card)} templates through "
          f"the per-template ladder in {wall:.3f} s, card == CPU; "
          f"solve_group(explain=True) on its {len(reps)}-class group: "
          f"{n_batched} kernel-2 launches, why-not from the terminal "
          f"carry, card == CPU")

    # ---- (k).4 a corrupt fault descends to the oracle with explain ------
    spread_pb = encode_problem(
        ClusterSnapshot.from_objects(make_nodes(n=256)), default_pod(pod),
        SchedulerProfile())
    outs = []
    for d in (dev, "cpu"):
        with faults.inject("engine.solve:corrupt"):
            outs.append(degrade.solve_one_guarded(spread_pb, max_limit=200,
                                                  explain=True, device=d))
    r = outs[0]
    assert (r.rung, r.degraded, r.explain.rung) == ("oracle", True,
                                                    "oracle"), r.rung
    same(*outs, "(k).4 oracle with explain")
    print(f"(k).4 engine.solve:corrupt with explain at 256 nodes: rung "
          f"oracle, degraded, attribution from the oracle "
          f"({r.explain.why_here.shape[0]} why-here rows); card == CPU")
    print(f"(k) phase time: {time.perf_counter() - t_phase:.1f} s")
    return {"kernel2": n_batched}


class _Items:
    """A list response of the kubernetes client: `.items`."""

    def __init__(self, items):
        self.items = items


class ScanCellClient:
    """A duck-typed CoreV1Api that serves phase (l)'s cluster: list_node
    and list_pod_for_all_namespaces, plus namespaces and priority classes;
    every other kind the live sync asks for is absent."""

    def __init__(self, nodes):
        self.nodes = nodes

    def list_node(self):
        return _Items(self.nodes)

    def list_pod_for_all_namespaces(self):
        return _Items([])

    def list_namespace(self):
        return _Items([{"metadata": {"name": "default"}}])

    def list_priority_class(self):
        return _Items([])


def extender_verdicts(nodes):
    """Phase (l).4's extender verdicts by node name, from make_nodes'
    indices: (the names a filter keeps: index not divisible by
    EXT_DROP_EVERY, the prioritize score: the node's zone number, as
    make_nodes puts node i in zone i % N_ZONES)."""
    names = [n["metadata"]["name"] for n in nodes]
    keep = {n for i, n in enumerate(names) if i % EXT_DROP_EVERY}
    score = {n: i % N_ZONES for i, n in enumerate(names)}
    return keep, score


def zone_extenders(ext_mod, verdicts, calls=None):
    """Phase (l).4's callable extenders over extender_verdicts: a filter
    and a prioritize of weight 2.  `calls` counts the callbacks when
    given."""
    keep, score = verdicts

    def filt(pod, names):
        if calls is not None:
            calls["filter"] += 1
        return {"NodeNames": [n for n in names if n in keep]}

    def prio(pod, names):
        if calls is not None:
            calls["prioritize"] += 1
        return [{"Host": n, "Score": score[n]} for n in names]
    return [ext_mod.ExtenderConfig(filter_callable=filt),
            ext_mod.ExtenderConfig(prioritize_callable=prio, weight=2)]


def http_extender(verdicts):
    """A local HTTP extender (kube-scheduler extender/v1 payloads, the
    NodeNames protocol) over extender_verdicts: filter, prioritize, and a
    bind that accepts.  Returns (server, thread, url prefix, calls by
    verb)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    keep, score = verdicts
    calls = {"filter": 0, "prioritize": 0, "bind": 0}

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])).decode())
            verb = self.path.rsplit("/", 1)[-1]
            calls[verb] = calls.get(verb, 0) + 1
            if verb == "filter":
                out = {"NodeNames": [n for n in body["NodeNames"]
                                     if n in keep]}
            elif verb == "prioritize":
                out = [{"Host": n, "Score": score[n]}
                       for n in body["NodeNames"]]
            elif verb == "bind":
                out = {}
            else:
                out = {"Error": f"unknown verb {verb}"}
            payload = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread, f"http://127.0.0.1:{srv.server_port}/scheduler", \
        calls


def extender_runs(device) -> dict:
    """Phase (l).4's two extender runs through ClusterCapacity.run on
    `device` (None: the card): the scan pod with zone_extenders at
    EXT_LIMIT and with a local HTTP extender at HTTP_LIMIT.  Returns
    {"callable" | "http": outcome + "seconds" + "calls"}."""
    import torch
    from cluster_capacity_tpu_torch import ClusterCapacity
    from cluster_capacity_tpu_torch.engine import extenders as ext_mod
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    _name, nodes, pod, _pct = problems()[0]
    snap = ClusterSnapshot.from_objects(nodes)
    verdicts = extender_verdicts(nodes)

    def run(exts, limit):
        profile = SchedulerProfile()
        profile.extenders = exts
        cc = ClusterCapacity(default_pod(pod), max_limit=limit,
                             profile=profile, device=device)
        cc.set_snapshot(snap)
        t0 = time.perf_counter()
        r = cc.run()
        if device is None:
            torch.cuda.synchronize()
        return dict(outcome(r), seconds=time.perf_counter() - t0)

    out = {}
    calls = {"filter": 0, "prioritize": 0}
    out["callable"] = dict(run(zone_extenders(ext_mod, verdicts, calls),
                               EXT_LIMIT), calls=calls)
    srv, thread, url, hcalls = http_extender(verdicts)
    try:
        out["http"] = dict(run([ext_mod.ExtenderConfig(
            url_prefix=url, filter_verb="filter",
            prioritize_verb="prioritize", bind_verb="bind",
            node_cache_capable=True, weight=2)], HTTP_LIMIT),
            calls=dict(hcalls))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return out


def frontend_cpu_runs() -> int:
    """The child process (`chip_smoke.py --frontend-cpu`, no card): phase
    (l).4's extender runs on the CPU at full width; prints them as one
    JSON line."""
    import torch
    torch.set_num_threads(2)
    print(json.dumps(extender_runs("cpu")))
    return 0


def frontend_phase(dev) -> dict:
    """Phase (l): the front end as users run it, at the scan cell's 10,000
    nodes.  Returns kernel 1's launches on the (l).1-(l).3 runs:
    {"kernel1": n}."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch
    from cluster_capacity_tpu_torch import ClusterCapacity
    from cluster_capacity_tpu_torch.cli import cluster_capacity as cli
    from cluster_capacity_tpu_torch.engine import encode as enc
    from cluster_capacity_tpu_torch.engine import extenders as ext_mod
    from cluster_capacity_tpu_torch.engine import fused
    from cluster_capacity_tpu_torch.engine import simulator as sim
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.runtime.errors import \
        CheckpointCorruption
    from cluster_capacity_tpu_torch.utils import checkpoint
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_l_")
    try:
        name, nodes, pod, _pct = problems()[0]
        launches = 0

        def run_cc(snapshot=None, client=None, limit=FRONTEND_LIMIT):
            cc = ClusterCapacity(default_pod(pod), max_limit=limit)
            if client is not None:
                cc.sync_with_client(client)
            elif snapshot is not None:
                cc.set_snapshot(snapshot)
            else:
                cc.sync_with_objects(nodes)
            return cc, cc.run()

        # ---- (l).1 live sync through a duck-typed client ---------------
        fused.LAUNCHES = 0
        t0 = time.perf_counter()
        cc, live = run_cc(client=ScanCellClient(nodes))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_live = fused.LAUNCHES
        assert n_live > 0, "(l).1 the live-sync run never launched kernel 1"
        launches += n_live
        _cc2, direct = run_cc()
        assert live.placements == direct.placements, \
            "(l).1 sync_with_client and sync_with_objects placed differently"
        assert (live.fail_type, live.fail_message, live.rung,
                live.degraded) == (direct.fail_type, direct.fail_message,
                                   "fused", False), live.fail_message
        assert live.placed_count == FRONTEND_LIMIT
        print(f"(l).1 sync_with_client over a duck-typed client ({name}, "
              f"{N_NODES} nodes), limit {FRONTEND_LIMIT}: "
              f"{live.placed_count} placements in {wall:.3f} s with the "
              f"sync ({live.placed_count / wall:.0f} placements/s), "
              f"{n_live} kernel-1 launches, rung {live.rung}; placements "
              f"== sync_with_objects'")

        # ---- (l).2 checkpoint save / load ---------------------------------
        path = os.path.join(tmp, "scan.npz")
        t0 = time.perf_counter()
        checkpoint.save(path, cc.snapshot)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = checkpoint.load(path)
        t_load = time.perf_counter() - t0
        assert checkpoint.snapshot_digest(loaded) == \
            checkpoint.snapshot_digest(cc.snapshot)
        fused.LAUNCHES = 0
        t0 = time.perf_counter()
        _cc3, from_ckpt = run_cc(snapshot=loaded)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_ckpt = fused.LAUNCHES
        assert n_ckpt > 0, "(l).2 the checkpoint run never launched kernel 1"
        launches += n_ckpt
        assert from_ckpt.placements == live.placements, \
            "(l).2 the run after load placed differently"
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        bad = os.path.join(tmp, "corrupt.npz")
        with open(bad, "wb") as f:
            f.write(bytes(raw))
        try:
            checkpoint.load(bad)
        except CheckpointCorruption as exc:
            corrupt = str(exc).split(":")[0]
        else:
            raise AssertionError("(l).2 a corrupted bundle loaded")
        print(f"(l).2 checkpoint of the scan snapshot: save {t_save:.3f} s, "
              f"load {t_load:.3f} s ({os.path.getsize(path)} bytes), "
              f"digest equal; the run after load: {from_ckpt.placed_count} "
              f"placements in {wall:.3f} s, {n_ckpt} kernel-1 launches, "
              f"equal placements; a flipped byte raised {corrupt}")

        # ---- (l).3 the CLI in --watch mode on a JSON snapshot -------------
        snap_path = os.path.join(tmp, "snapshot.json")
        pod_path = os.path.join(tmp, "pod.json")
        with open(snap_path, "w") as f:
            json.dump({"nodes": nodes}, f)
        with open(pod_path, "w") as f:
            json.dump(pod, f)
        loads = []
        real_load = cli.load_snapshot_objects

        def counting_load(p):
            loads.append(p)
            return real_load(p)

        # each iteration's seconds run from its start to its sleep; the
        # rewrite of the file happens in between and is not counted
        starts, ends = [], []
        per_iter = []
        real_sleep = time.sleep

        def sleep_and_rewrite(seconds):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            per_iter.append(fused.LAUNCHES)
            fused.LAUNCHES = 0
            if len(ends) == 1:
                # the cluster loses a tenth of its nodes (1,000) between
                # the first and the second iteration
                with open(snap_path, "w") as f:
                    json.dump({"nodes": nodes[len(nodes) // 10:]}, f)
                st = os.stat(snap_path)
                os.utime(snap_path, ns=(st.st_atime_ns,
                                        st.st_mtime_ns + 10 ** 6))
            real_sleep(0)
            starts.append(time.perf_counter())

        out = io.StringIO()
        cli.load_snapshot_objects = counting_load
        time.sleep = sleep_and_rewrite
        fused.LAUNCHES = 0
        starts.append(time.perf_counter())
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.run(["--podspec", pod_path, "--snapshot", snap_path,
                              "--watch", "--period", "0.01",
                              "--period-iterations", "3", "-o", "json",
                              "--max-limit", str(FRONTEND_LIMIT)])
            torch.cuda.synchronize()
        finally:
            time.sleep = real_sleep
            cli.load_snapshot_objects = real_load
        ends.append(time.perf_counter())
        per_iter.append(fused.LAUNCHES)
        assert rc == 0, rc
        assert len(loads) == 2, f"(l).3 {len(loads)} snapshot loads, not 2"
        reviews = [json.loads(line) for line in out.getvalue().splitlines()]
        assert len(reviews) == 3 and len(per_iter) == 3, (len(reviews),
                                                          per_iter)
        for i, (review, n) in enumerate(zip(reviews, per_iter)):
            st = review["status"]
            assert n > 0, f"(l).3 iteration {i + 1} never launched kernel 1"
            assert (st["degraded"], st["rung"], st["replicas"]) == \
                (False, "fused", FRONTEND_LIMIT), (i, st["rung"])
        launches += sum(per_iter)
        counts = {r["nodeName"]: r["replicas"] for r in
                  reviews[0]["status"]["pods"][0]["replicasOnNodes"]}
        assert counts == live.per_node_counts, \
            "(l).3 the first iteration differs from (l).1"
        strip = [dict(r, status={k: v for k, v in r["status"].items()
                                 if k != "creationTimestamp"})
                 for r in reviews]
        assert strip[1] == strip[2], "(l).3 the reused snapshot answered " \
                                     "differently"
        assert strip[1] != strip[0]
        secs = [b - a for a, b in zip(starts, ends)]
        print(f"(l).3 cluster-capacity --watch --period 0.01 "
              f"--period-iterations 3 -o json --max-limit {FRONTEND_LIMIT} "
              f"on a JSON snapshot ({os.path.getsize(snap_path)} bytes), "
              f"rewritten after iteration 1: {len(loads)} loads; iteration "
              f"seconds {', '.join(f'{x:.3f}' for x in secs)} (1: load + "
              f"encode, 2: re-load, 3: the reused snapshot); kernel-1 "
              f"launches {per_iter}; rung fused, not degraded, in every "
              f"iteration; iteration 1 == (l).1")

        # ---- (l).4 extenders ----------------------------------------------
        fused.LAUNCHES = 0
        card = extender_runs(None)
        assert fused.LAUNCHES == 0, "the extender loop launched kernel 1"
        cpu = cpu_results("--frontend-cpu")
        for kind, limit in (("callable", EXT_LIMIT), ("http", HTTP_LIMIT)):
            c = card[kind]
            assert {k: v for k, v in c.items() if k != "seconds"} == \
                {k: v for k, v in cpu[kind].items() if k != "seconds"}, \
                f"(l).4 {kind} extenders: card != CPU"
            assert len(c["placements"]) == limit and c["fail_type"] == \
                "LimitReached", c["fail_message"]
            assert all(i % EXT_DROP_EVERY for i in c["placements"])
            assert c["calls"] == {"filter": limit, "prioritize": limit,
                                  **({"bind": limit} if kind == "http"
                                     else {})}, c["calls"]

        # the per-cycle split on the initial state: the device pass, the
        # copy of [N] bool + [N] float to the host, the chains
        pb = enc.encode_problem(ClusterSnapshot.from_objects(nodes),
                                default_pod(pod), SchedulerProfile())
        cfg = sim.static_config(pb)
        consts = sim.build_consts(pb, dev)
        carry = sim._init_carry(pb, consts)
        compute_ms = cuda_ms(lambda: ext_mod._compute(cfg, consts, carry),
                             reps=20)
        feasible, total = ext_mod._compute(cfg, consts, carry)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            f_host = feasible.cpu().numpy()
            t_host = total.cpu().numpy()
        copy_ms = (time.perf_counter() - t0) / 20 * 1e3
        assert t_host.shape == (N_NODES,)
        names = pb.snapshot.node_names
        exts = zone_extenders(ext_mod, extender_verdicts(nodes))
        t0 = time.perf_counter()
        for _ in range(5):
            feasible_names = [names[i] for i in np.flatnonzero(f_host)]
            surviving = ext_mod.run_filter_chain(exts, pb.pod,
                                                 feasible_names)
            ext_mod.run_prioritize_chain(exts, pb.pod, surviving)
        chains_ms = (time.perf_counter() - t0) / 5 * 1e3
        for kind, limit, what in (
                ("callable", EXT_LIMIT, f"callable extenders (filter drops "
                                        f"index % {EXT_DROP_EVERY} == 0, "
                                        f"prioritize by zone, weight 2)"),
                ("http", HTTP_LIMIT, "HTTP extender (filterVerb, "
                                     "prioritizeVerb, bindVerb; NodeNames)")):
            wall = card[kind]["seconds"]
            print(f"(l).4 {what}, limit {limit}: {limit} placements in "
                  f"{wall:.3f} s on the card ({limit / wall:.0f} "
                  f"placements/s, {wall / limit * 1e3:.3f} ms/cycle), "
                  f"{cpu[kind]['seconds']:.3f} s on the CPU (child process); "
                  f"calls {card[kind]['calls']}; card == CPU (placements, "
                  f"fail type, message, counts, rung)")
        print(f"(l).4 per-cycle split on the initial state, {N_NODES} "
              f"nodes: device compute {compute_ms:.3f} ms (CUDA events), "
              f"host copy of [N] bool + [N] float {copy_ms:.3f} ms, chains "
              f"{chains_ms:.3f} ms over {len(feasible_names)} names; "
              f"kernel-1 launches 0; the CPU child waited for "
              f"{cpu['waited']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"(l) phase time: {time.perf_counter() - t_phase:.1f} s")
    return {"kernel1": launches}


# ---------------------------------------------------------------------------
# (m) telemetry and (n) resilience
# ---------------------------------------------------------------------------


def prometheus_lines(text: str) -> int:
    """The number of series lines of a Prometheus text dump; raises on a
    line that is not Prometheus text."""
    import re
    line_re = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
        r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*='
        r'"[^"]*")*\})? -?(\d+(\.\d+)?([eE][+-]?\d+)?|\+?Inf|NaN)$')
    lines = text.splitlines()
    for line in lines:
        assert line_re.match(line), f"not Prometheus text: {line!r}"
    return len(lines)


def write_cell(tmp, nodes, pods, pod, tag):
    """The cluster as a JSON snapshot and the pod as a JSON podspec, the
    files a user hands the CLIs; returns (snapshot path, podspec path)."""
    snap_path = os.path.join(tmp, f"{tag}-snapshot.json")
    pod_path = os.path.join(tmp, f"{tag}-pod.json")
    with open(snap_path, "w") as f:
        json.dump({"nodes": nodes, "pods": pods}, f)
    with open(pod_path, "w") as f:
        json.dump(pod, f)
    return snap_path, pod_path


def run_cli(run, argv):
    """A CLI's run(argv) in-process: (exit code, stdout)."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run(argv)
    return rc, out.getvalue()


def telemetry_phase(dev) -> dict:
    """Phase (m): telemetry on the scan cell (10,000 nodes, 16 zones, the
    zone-spread pod, limit 20,000) through the cluster-capacity CLI and
    `hypercc profile` on the card.  Returns kernel 1's launches on the
    (m).1 run and kernel 1's and kernel 2's in (m).3's profile runs."""
    import glob
    import shutil
    import tempfile

    import torch
    from cluster_capacity_tpu_torch import ClusterCapacity, obs
    from cluster_capacity_tpu_torch.cli import cluster_capacity as cli
    from cluster_capacity_tpu_torch.cli import profile as profile_cli
    from cluster_capacity_tpu_torch.engine import fused, fused_batched
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.obs import flight
    from cluster_capacity_tpu_torch.obs import profile as obs_profile
    from cluster_capacity_tpu_torch.utils.metrics import default_registry

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_m_")
    name, nodes, pod, _pct = problems()[0]
    real_steps = fused.fused_steps
    try:
        snap_path, pod_path = write_cell(tmp, nodes, [], pod, "scan")
        # the scan pod without its spread: the closed form answers it
        _s, fit_path = write_cell(tmp, nodes, [], bench_pod(), "fit")
        base = ["--snapshot", snap_path, "--max-limit",
                str(TELEMETRY_LIMIT), "-o", "json"]

        # ---- (m).1 the four telemetry outputs --------------------------
        obs.default_collector.reset()
        default_registry.reset()
        m, t = os.path.join(tmp, "m1.prom"), os.path.join(tmp, "m1.jsonl")
        pdir, fdir = os.path.join(tmp, "prof"), os.path.join(tmp, "flight")
        events = []

        def timed_steps(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_steps(*args, **kw)
            stop.record()
            events.append((start, stop))
            return out

        fused.fused_steps = timed_steps
        fused.LAUNCHES = 0
        t0 = time.perf_counter()
        rc, out = run_cli(cli.run, ["--podspec", pod_path] + base + [
            "--metrics-dump", m, "--trace-out", t, "--profile-out", pdir,
            "--flight-dir", fdir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fused.fused_steps = real_steps
        launches = fused.LAUNCHES
        assert rc == 0, rc
        st = json.loads(out)["status"]
        assert (st["replicas"], st["rung"], st["degraded"]) == \
            (TELEMETRY_LIMIT, "fused", False), st["rung"]
        assert launches > 0 and len(events) == launches
        kernel_ms = sum(a.elapsed_time(b) for a, b in events)
        n_series = prometheus_lines(open(m).read())
        spans = [json.loads(line) for line in open(t)]
        solve = [e for e in spans if e["name"] == "degrade.solve_one"]
        guard = [e for e in spans if e["name"] == "guard:engine.solve"]
        assert len(solve) == len(guard) == 1
        assert guard[0]["args"]["parent_id"] == solve[0]["args"]["span_id"]
        assert (guard[0]["args"]["site"], guard[0]["args"]["rung"],
                guard[0]["args"]["outcome"]) == ("engine.solve", "fused", "ok")
        with open(os.path.join(pdir, "attribution.json")) as f:
            rows = json.load(f)["rows"]
        solve_rows = [r for r in rows if r["site"] == "engine.solve"]
        device_s = sum(r["device_s"] for r in solve_rows)
        assert device_s * 1e3 >= kernel_ms, (device_s, kernel_ms)
        traces = glob.glob(os.path.join(pdir, obs_profile.TRACE_PREFIX + "*"))
        assert len(traces) == 1, traces
        with open(traces[0]) as f:
            prof_events = json.load(f)["traceEvents"]
        prof_kernels = [e for e in prof_events
                        if e.get("cat") == "kernel"
                        and "fused_steps_kernel" in e.get("name", "")]
        assert prof_kernels, "the torch.profiler trace holds no kernel-1 " \
                             "launch: CUPTI traced no device activity"
        prof_ms = sum(e.get("dur", 0.0) for e in prof_kernels) / 1e3
        assert not os.path.isdir(fdir) or not os.listdir(fdir)
        print(f"(m).1 cluster-capacity --metrics-dump --trace-out "
              f"--profile-out --flight-dir on the scan cell ({name}, "
              f"{N_NODES} nodes), limit {TELEMETRY_LIMIT}: "
              f"{st['replicas']} placements in {wall:.3f} s, {launches} "
              f"kernel-1 launches, rung fused; {n_series} Prometheus lines "
              f"parsed; {len(spans)} spans (degrade.solve_one > "
              f"guard:engine.solve, rung fused); attribution engine.solve "
              f"device_s {device_s * 1e3:.3f} ms >= kernel 1 by CUDA events "
              f"{kernel_ms:.3f} ms over the same {launches} launches; "
              f"torch.profiler trace {os.path.basename(traces[0])} "
              f"({os.path.getsize(traces[0])} bytes): {len(prof_kernels)} "
              f"fused_steps_kernel events, {prof_ms:.3f} ms; no flight "
              f"bundle")

        # ---- (m).2 an injected fault under the flight recorder ---------
        fdir2 = os.path.join(tmp, "flight2")
        rc, out = run_cli(cli.run, ["--podspec", fit_path] + base + [
            "--flight-dir", fdir2, "--inject-fault", "engine.solve:oom"])
        flight.uninstall()
        assert rc == 0, rc
        st = json.loads(out)["status"]
        assert (st["degraded"], st["rung"]) == (True, "fast_path"), st
        bundles = sorted(os.listdir(fdir2))
        assert len(bundles) == 1 and bundles[0].endswith("-DeviceOOM"), \
            bundles
        bundle = flight.load_bundle(os.path.join(fdir2, bundles[0]))
        kernel_txt = bundle["kernel"] or ""
        assert "kernel: fused_steps_kernel" in kernel_txt, kernel_txt
        assert "launch_plan (the card's cluster slots)" in kernel_txt
        man = bundle["manifest"]
        assert "CC_INJECT_FAULT=engine.solve:oom" in man["repro"]["line"]
        assert man["platform"]["device"] == torch.cuda.get_device_name(0)
        plan_line = next(line for line in kernel_txt.splitlines()
                         if line.startswith("launch_plan"))
        print(f"(m).2 the same CLI on the scan cell's nodes with the "
              f"spread-free pod and --inject-fault engine.solve:oom: "
              f"{st['replicas']} placements, degraded, rung {st['rung']}; "
              f"one flight bundle {bundles[0]} ({', '.join(man['files'])}); "
              f"kernel.txt: {plan_line}; repro: {man['repro']['line']}")

        # ---- (m).3 hypercc profile solve / sweep with calibration -------
        fused.LAUNCHES = fused_batched.LAUNCHES = 0
        for scenario in ("solve", "sweep"):
            # each table shows its own run's spans, as a fresh process would
            obs.default_collector.reset()
            default_registry.reset()
            rc, out = run_cli(profile_cli.run, [scenario])
            assert rc == 0, rc
            assert "calibrated rate:" in out and "engine." in out, out
            print(f"(m).3 hypercc profile {scenario} (calibration on the "
                  f"card, best of {profile_cli.DEFAULT_REPS}):")
            for line in out.rstrip().splitlines():
                print(f"  {line}")
        torch.cuda.synchronize()
        profile_k1, profile_k2 = fused.LAUNCHES, fused_batched.LAUNCHES
        assert profile_k1 > 0 and profile_k2 > 0

        # ---- (m).4 placements/s with telemetry on and off ----------------
        snap = ClusterSnapshot.from_objects(nodes)

        def scan_run(telemetry):
            cc = ClusterCapacity(default_pod(pod), max_limit=TELEMETRY_LIMIT)
            cc.set_snapshot(snap)
            t0 = time.perf_counter()
            if telemetry:
                obs.install_recompile_hook()
                flight.install(os.path.join(tmp, "flight4"))
                with obs_profile.capture(None):
                    r = cc.run()
                obs.write_metrics(os.path.join(tmp, "m4.prom"), atomic=True)
                obs.write_trace(os.path.join(tmp, "m4.jsonl"), atomic=True)
                flight.uninstall()
            else:
                r = cc.run()
            torch.cuda.synchronize()
            assert r.placed_count == TELEMETRY_LIMIT and not r.degraded
            return TELEMETRY_LIMIT / (time.perf_counter() - t0)

        warm = [scan_run(False), scan_run(True)]
        rates = {"off": [], "on": []}
        for mode in ("off", "on", "on", "off") * TELEMETRY_ROUNDS:
            rates[mode].append(scan_run(mode == "on"))
        med = {m: float(np.median(v)) for m, v in rates.items()}
        spread = {m: (max(v) - min(v)) / med[m] * 100
                  for m, v in rates.items()}
        print(f"(m).4 the scan cell through ClusterCapacity.run, limit "
              f"{TELEMETRY_LIMIT}, after one warm-up run each way "
              f"({warm[0]:.0f}, {warm[1]:.0f}) and {TELEMETRY_ROUNDS} "
              f"rounds of off, on, on, off: telemetry off "
              f"{', '.join(f'{x:.0f}' for x in rates['off'])} placements/s, "
              f"on (memory sampling, flight recorder armed, metrics and "
              f"trace written) {', '.join(f'{x:.0f}' for x in rates['on'])} "
              f"placements/s; medians off {med['off']:.0f}, on "
              f"{med['on']:.0f} ({(med['on'] / med['off'] - 1) * 100:+.2f}%"
              f"), spread (max - min) / median off {spread['off']:.2f}%, on "
              f"{spread['on']:.2f}%")
    finally:
        fused.fused_steps = real_steps
        flight.uninstall()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"(m) phase time: {time.perf_counter() - t_phase:.1f} s")
    return {"kernel1": launches, "profile1": profile_k1,
            "profile2": profile_k2}


def resilience_cluster(n=N_NODES):
    """Phase (n)'s cluster: the scan cell's nodes (n of them), with one
    resident pod of priority 0 (500m / 1 GiB) on every RESIDENT_EVERY-th
    node."""
    nodes = make_nodes(n=n)
    pods = [{"metadata": {"name": f"resident-{i:06d}",
                          "namespace": "default"},
             "spec": {"nodeName": nodes[i]["metadata"]["name"],
                      "priority": 0,
                      "containers": [{"name": "c", "resources": {"requests": {
                          "cpu": "500m", "memory": "1Gi"}}}]}}
            for i in range(0, n, RESIDENT_EVERY)]
    return nodes, pods


def resilience_runs(device: str, n: int, limit1: int, limit2: int,
                    full: bool = False) -> dict:
    """Phase (n)'s three sweeps through the resilience CLI on `device`, at
    n nodes: "n1" the scan pod (zone spread, sequential scenarios) at
    limit1, "n2" the spread-free pod with bounds at limit2, "n2_no_bounds"
    the same without.  Each over every single-node failure (deduped) and
    every zone.  Returns {run: {"report", "seconds", "drain_s",
    "drains_reused", "kernel1", "kernel2", "batch"}}.

    full=True (the card's full-width sweeps): a drain depends on the
    cluster and the failed nodes, not on the probe pod, so "n2" and
    "n2_no_bounds" reuse the drains "n1" made instead of making them
    again; and the inputs and `chosen` of "n2_no_bounds"'s first kernel-2
    launch come back under "held" (not JSON) for the check against the
    plain version."""
    import shutil
    import tempfile

    import torch
    from cluster_capacity_tpu_torch.cli import resilience as res_cli
    from cluster_capacity_tpu_torch.engine import fused, fused_batched
    from cluster_capacity_tpu_torch.resilience import analyzer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_n_")
    nodes, pods = resilience_cluster(n)
    scan_pod = problems()[0][2]
    real_drain, real_batched = analyzer._drain, \
        fused_batched.fused_steps_batched
    drain_s, reused, batches = [0.0], [0], []
    drains, held, record = {}, [], [False]

    def timed_drain(snapshot, scenario, *args, **kw):
        key = tuple(scenario.failed)
        if full and key in drains:
            reused[0] += 1
            return drains[key]
        t0 = time.perf_counter()
        try:
            d = real_drain(snapshot, scenario, *args, **kw)
        finally:
            drain_s[0] += time.perf_counter() - t0
        drains[key] = d
        return d

    def sized_batched(const, carry, scalars, tables, k, *args, **kw):
        batches.append(int(const.shape[0]))
        inputs = None
        if record[0] and not held:
            inputs = tuple(t.clone() for t in (const, carry, scalars)) + (
                type(tables)(tables.i.clone(), tables.f.clone()), k)
        out = real_batched(const, carry, scalars, tables, k, *args, **kw)
        if inputs is not None:
            held.append((inputs, out[2].clone()))
        return out

    analyzer._drain = timed_drain
    fused_batched.fused_steps_batched = sized_batched
    out = {}
    try:
        snap_path, spread_path = write_cell(tmp, nodes, pods, scan_pod, "n1")
        # without the spread every scenario is mask-exact (batched)
        _s, fit_path = write_cell(tmp, nodes, pods, bench_pod(), "n2")
        for run, pod_path, limit, extra in (
                ("n1", spread_path, limit1, []),
                ("n2", fit_path, limit2, []),
                ("n2_no_bounds", fit_path, limit2, ["--no-bounds"])):
            drain_s[0], reused[0] = 0.0, 0
            record[0] = full and run == "n2_no_bounds"
            del batches[:]
            fused.LAUNCHES = fused_batched.LAUNCHES = 0
            t0 = time.perf_counter()
            rc, text = run_cli(res_cli.run, [
                "--snapshot", snap_path, "--podspec", pod_path, "--nodes",
                "--zones", "--max-limit", str(limit), "-o", "json",
                "--device", device] + extra)
            if device == "cuda":
                torch.cuda.synchronize()
            assert rc == 0, (run, rc)
            out[run] = {"report": json.loads(text),
                        "seconds": time.perf_counter() - t0,
                        "drain_s": drain_s[0], "drains_reused": reused[0],
                        "kernel1": fused.LAUNCHES,
                        "kernel2": fused_batched.LAUNCHES,
                        "batch": sorted(set(batches))}
    finally:
        analyzer._drain = real_drain
        fused_batched.fused_steps_batched = real_batched
        shutil.rmtree(tmp, ignore_errors=True)
    if full:
        assert held, "(n).2 --no-bounds launched no kernel 2 to hold"
        out["held"] = held[0]
    return out


def resilience_cpu_runs() -> int:
    """The child process (`chip_smoke.py --resilience-cpu`, no card):
    phase (n)'s sweeps at RES_CHECK_NODES nodes on the CPU; prints them as
    one JSON line."""
    import torch
    torch.set_num_threads(2)
    print(json.dumps(resilience_runs("cpu", RES_CHECK_NODES, RES_CHECK_LIMIT,
                                     RES_CHECK_LIMIT)))
    return 0


def _rows_without_provenance(report) -> list:
    drop = ("boundedOf", "rung", "degraded")
    return [{k: v for k, v in row.items() if k not in drop}
            for row in report["status"]["scenarios"]]


def resilience_phase(dev) -> dict:
    """Phase (n): N-k resilience sweeps of the scan cell with a resident
    pod on every 50th node, through `hypercc resilience` on the card.
    Returns the kernels' launches on the runs, and the held kernel-2
    launch's max_abs_err: {"kernel1": n, "kernel2": n, "err": x}."""
    import torch
    from cluster_capacity_tpu_torch.engine import fused_batched

    t_phase = time.perf_counter()
    # started here, not with the script, so (a)-(i) run beside the same
    # two CPU children as before this phase existed
    start_cpu_runs("--resilience-cpu")
    check = resilience_runs("cuda", RES_CHECK_NODES, RES_CHECK_LIMIT,
                            RES_CHECK_LIMIT)
    full = resilience_runs("cuda", N_NODES, RESILIENCE_LIMIT,
                           RESILIENCE_LIMIT, full=True)
    (const, carry, scalars, tables, k), chosen = full.pop("held")
    runs = list(check.values()) + list(full.values())
    launches = {key: sum(r[key] for r in runs)
                for key in ("kernel1", "kernel2")}

    # the first kernel-2 launch of (n).2 --no-bounds at full width against
    # the plain version on the same inputs: the main path's placements over
    # the first K_HELD steps, and a K_HELD-step launch's every output
    kh = min(K_HELD, k)
    t0 = time.perf_counter()
    plain = fused_batched.fused_steps_batched_reference(
        const, carry, scalars, tables, kh)
    torch.cuda.synchronize()
    held_plain_s = time.perf_counter() - t0
    kern = fused_batched.fused_steps_batched(const, carry, scalars, tables,
                                             kh)
    err = _assert_equal(kern, plain, f"(n).2 kernel 2 at B = "
                                     f"{const.shape[0]}, {kh} steps")
    assert torch.equal(chosen[:, :kh], plain[2]), \
        "(n).2 the main path's kernel-2 placements differ from the plain " \
        "version's"
    print(f"(n).2 {N_NODES} nodes: the first kernel-2 launch of --no-bounds "
          f"(B = {const.shape[0]} scenarios, {k} steps) == the plain "
          f"version over its first {kh} steps (placements of the main "
          f"path's launch, and a {kh}-step launch's carry, scalars and "
          f"chosen; max_abs_err {err}, plain {held_plain_s:.1f} s); "
          f"{int((plain[2] >= 0).sum())} placements held")
    cpu = cpu_results("--resilience-cpu")
    for run in ("n1", "n2", "n2_no_bounds"):
        assert check[run]["report"] == cpu[run]["report"], \
            f"(n) {run} at {RES_CHECK_NODES} nodes: card != CPU"

    for tag, runs in ((f"{RES_CHECK_NODES} nodes", check),
                      (f"{N_NODES} nodes", full)):
        n1, n2, nb = (runs[k] for k in ("n1", "n2", "n2_no_bounds"))
        s1, s2, sb = (r["report"]["status"] for r in (n1, n2, nb))
        for st in (s1, s2, sb):
            assert not st["degraded"], st["worstRung"]
        assert s1["batchedScenarios"] == 0 and s1["sequentialScenarios"] > 0
        assert n1["kernel1"] > 0, "(n).1 never launched kernel 1"
        assert s2["sequentialScenarios"] == 0
        assert s2["bounds"]["pruned"] == s2["batchedScenarios"] > 0
        assert n2["kernel2"] == 0
        assert sb["bounds"] is None and sb["batchedScenarios"] == \
            s2["batchedScenarios"]
        assert nb["kernel2"] > 0, "(n).2 --no-bounds never launched kernel 2"
        assert {r["rung"] for r in sb["scenarios"]} == {"fused_batched"}
        assert _rows_without_provenance(n2["report"]) == \
            _rows_without_provenance(nb["report"]), \
            "(n).2 the bracket's rows differ from kernel 2's"
        label = "card == CPU (child process)" \
            if runs is check else "card alone"
        depth = RES_CHECK_LIMIT if runs is check else RESILIENCE_LIMIT
        print(f"(n).1 {tag}, {s1['baselineHeadroom']} baseline headroom, "
              f"the scan pod (zone spread) at --max-limit {depth}, "
              f"{len(s1['scenarios'])} scenarios (single nodes deduped, "
              f"16 zones): {s1['sequentialScenarios']} sequential, "
              f"{s1['batchedScenarios']} batched, "
              f"{s1['collapsedScenarios']} deduped, "
              f"{(s1['bounds'] or {}).get('pruned', 0)} bracket-proved; "
              f"kernel 1 {n1['kernel1']} launches, kernel 2 "
              f"{n1['kernel2']}; drains {n1['drain_s']:.3f} s; wall "
              f"{n1['seconds']:.3f} s; minKToStranded "
              f"{s1['minKToStranded']}; {label}")
        print(f"(n).2 {tag}, the spread-free pod at --max-limit "
              f"{depth}: bounds on {s2['batchedScenarios']} "
              f"batched, {s2['collapsedScenarios']} deduped, "
              f"{s2['bounds']['pruned']} proved by bracket_group's device "
              f"shot, not degraded, kernel 2 0 launches, wall "
              f"{n2['seconds']:.3f} s (drains {n2['drain_s']:.3f} s, "
              f"{n2['drains_reused']} reused from (n).1); --no-bounds the "
              f"same rows through kernel 2: {nb['kernel2']} launches at B "
              f"= {nb['batch']}, wall {nb['seconds']:.3f} s (drains "
              f"{nb['drain_s']:.3f} s, {nb['drains_reused']} reused); "
              f"{label}")
    child = ", ".join(f"{k} {cpu[k]['seconds']:.1f}"
                      for k in ("n1", "n2", "n2_no_bounds"))
    print(f"(n) the CPU child's runs at {RES_CHECK_NODES} nodes took "
          f"{child} s; waited {cpu['waited']:.1f} s for them; phase time: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches, err=err)


# ---------------------------------------------------------------------------
# (o) interleaved shared-state sweeps, (p) the capacity daemon
# ---------------------------------------------------------------------------

def interleave_mix():
    """bench.py's interleave cell: 50 templates from RandomState(7), each
    100/250/500m cpu with a zone DoNotSchedule spread of maxSkew 4 or 8 on
    its own label, on the sweep cell's 10,000 nodes (8 zones, 16/32 cores,
    64/128 GiB, seed 7)."""
    rng = np.random.RandomState(7)
    nodes = make_nodes(zones=8, seed=7, cpus=(16000, 32000), mems=(64, 128))
    templates = []
    for k in range(INTERLEAVE_TEMPLATES):
        templates.append({
            "metadata": {"name": f"t{k}", "labels": {"app": f"t{k}"}},
            "spec": {"containers": [{
                "name": "c", "resources": {"requests": {
                    "cpu": f"{int(rng.choice([100, 250, 500]))}m"}}}],
                "topologySpreadConstraints": [{
                    "maxSkew": int(rng.choice([4, 8])), "topologyKey": ZONE,
                    "whenUnsatisfiable": "DoNotSchedule",
                    "labelSelector": {"matchLabels": {"app": f"t{k}"}}}]}})
    return nodes, templates


def mix_filter(pod, names):
    """bench.py's interleave extender Filter: drops every node whose index
    is a multiple of 7."""
    return {"NodeNames": [nm for nm in names
                          if int(nm.rsplit("-", 1)[-1]) % 7 != 0]}


def mix_prioritize(pod, names):
    """bench.py's interleave extender Prioritize: 5 to names ending in 1."""
    return [{"Host": nm, "Score": 5 if nm.endswith("1") else 0}
            for nm in names]


def tiered_mix(n=TIERED_NODES):
    """(o).5: test_fuzz_tiered_preemption_corpus's shape at n nodes: a
    priority-0 resident of 12 cores on every 25th node (half of them under
    a PDB that allows no disruption), and five templates over three tiers —
    a zone spread, a preferred hostname anti-affinity, a host port, two
    plain.  Returns (nodes, pods, objects, templates)."""
    nodes = make_nodes(n=n, zones=8, seed=7, cpus=(16000, 32000),
                       mems=(64, 128))
    pods = []
    for i in range(0, n, 25):
        labels = {"app": "victim"}
        if i % 50 == 0:
            labels["guard"] = "y"
        pods.append({"metadata": {"name": f"v{i}", "namespace": "default",
                                  "labels": labels},
                     "spec": {"nodeName": f"node-{i:06d}", "priority": 0,
                              "containers": [{"name": "c", "resources": {
                                  "requests": {"cpu": "12000m",
                                               "memory": "1Gi"}}}]}})
    pdb = {"metadata": {"name": "guard", "namespace": "default"},
           "spec": {"selector": {"matchLabels": {"guard": "y"}}},
           "status": {"disruptionsAllowed": 0}}

    def tpl(name, cpu, prio, **spec):
        t = {"metadata": {"name": name, "labels": {"app": name}},
             "spec": {"priority": prio, "containers": [{
                 "name": "c", "resources": {"requests": {
                     "cpu": f"{cpu}m", "memory": "1Gi"}}}]}}
        t["spec"].update(spec)
        return t

    sel = lambda name: {"matchLabels": {"app": name}}
    templates = [
        tpl("t0", 6000, 20, topologySpreadConstraints=[{
            "maxSkew": 2, "topologyKey": ZONE,
            "whenUnsatisfiable": "DoNotSchedule", "labelSelector": sel("t0")}]),
        tpl("t1", 2000, 10, affinity={"podAntiAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [{
                "weight": 10, "podAffinityTerm": {
                    "topologyKey": "kubernetes.io/hostname",
                    "labelSelector": sel("t1")}}]}}),
        tpl("t2", 1500, 10),
        tpl("t3", 4000, 0),
        tpl("t4", 5000, 20),
    ]
    templates[2]["spec"]["containers"][0]["ports"] = [
        {"hostPort": 8080, "protocol": "TCP"}]
    return nodes, pods, {"pdbs": [pdb]}, templates


def interleave_runs(device: str) -> dict:
    """Phase (o)'s runs held card == CPU, on `device`: "o1" the mix at
    max_total INTERLEAVE_CHECK, "o2" the same with the bench's extender,
    "o4" `cluster-capacity --interleave` -o json on three podspecs of the
    mix at --max-limit INTERLEAVE_CHECK, "o5" the tiered mix with victims,
    host ports and a PDB.  Returns {run: {"results" or "report",
    "seconds"}}."""
    import shutil
    import tempfile

    from cluster_capacity_tpu_torch.cli import cluster_capacity as cc_cli
    from cluster_capacity_tpu_torch.engine.extenders import ExtenderConfig
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.parallel.interleave import (
        sweep_interleaved_auto)
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    nodes, raw = interleave_mix()
    snap = ClusterSnapshot.from_objects(nodes)
    templates = [default_pod(t) for t in raw]
    ext = SchedulerProfile()
    ext.extenders = [ExtenderConfig(filter_callable=mix_filter,
                                    prioritize_callable=mix_prioritize,
                                    weight=3)]
    t_nodes, t_pods, t_objs, t_raw = tiered_mix()
    tiered = ClusterSnapshot.from_objects(t_nodes, t_pods, **t_objs)
    out = {}
    for run, s, tpls, prof, limit in (
            ("o1", snap, templates, SchedulerProfile(), INTERLEAVE_CHECK),
            ("o2", snap, templates, ext, INTERLEAVE_CHECK),
            ("o5", tiered, [default_pod(t) for t in t_raw],
             SchedulerProfile(), 0)):
        t0 = time.perf_counter()
        res = sweep_interleaved_auto(s, tpls, prof, max_total=limit,
                                     device=device)
        out[run] = {"results": [outcome(r) for r in res],
                    "seconds": time.perf_counter() - t0}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_o_")
    try:
        snap_path, _ = write_cell(tmp, nodes, [], raw[0], "o4")
        argv = ["--snapshot", snap_path, "--interleave", "--max-limit",
                str(INTERLEAVE_CHECK), "-o", "json", "--device", device]
        for k in range(3):
            path = os.path.join(tmp, f"o4-{k}.json")
            with open(path, "w") as f:
                json.dump(raw[k], f)
            argv += ["--podspec", path]
        t0 = time.perf_counter()
        rc, text = run_cli(cc_cli.run, argv)
        assert rc == 0, rc
        report = json.loads(text)
        report["status"].pop("creationTimestamp")
        out["o4"] = {"report": report, "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def interleave_cpu_runs() -> int:
    """The child process (`chip_smoke.py --interleave-cpu`, no card): phase
    (o)'s runs on the CPU; prints them as one JSON line."""
    import torch
    torch.set_num_threads(2)
    print(json.dumps(interleave_runs("cpu")))
    return 0


def interleave_phase(dev) -> None:
    """Phase (o): interleaved shared-state sweeps of the bench's 50-template
    mix at 10,000 nodes on the card: the guarded front door at max_total
    INTERLEAVE_LIMIT (the interleave engine, not the object loop, pops/s
    and us/pop under CUDA-graph replay), the extender study, bounds=True
    through bracket_mix's device auction, the CLI, and the tiered mix with
    preemption; card == CPU on the child's runs."""
    import torch
    from cluster_capacity_tpu_torch.bounds import bracket
    from cluster_capacity_tpu_torch.engine import encode as enc
    from cluster_capacity_tpu_torch.engine import fused, fused_batched
    from cluster_capacity_tpu_torch.engine import simulator as sim
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.obs import names as obs_names
    from cluster_capacity_tpu_torch.parallel import interleave as il
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile
    from cluster_capacity_tpu_torch.utils.metrics import default_registry

    t_phase = time.perf_counter()
    nodes, raw = interleave_mix()
    snap = ClusterSnapshot.from_objects(nodes)
    templates = [default_pod(t) for t in raw]
    profile = SchedulerProfile()
    keys = il.union_topology_keys(templates)
    pbs = enc.encode_problems_shared(snap, templates, profile,
                                     ipa_extra_keys=keys)
    assert il.eligible(snap, templates, profile, pbs) is None

    # the step's chunks timed on the card: every run_steps call between
    # CUDA events (the host loop syncs after each chunk anyway)
    real_run_steps = sim.run_steps
    step_ms, steps = [0.0], [0]

    def timed_run_steps(step, cfg, consts, state, k):
        start, stop = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_run_steps(step, cfg, consts, state, k)
        stop.record()
        stop.synchronize()
        step_ms[0] += start.elapsed_time(stop)
        steps[0] += k
        return out

    def runs_ok():
        return default_registry.get(
            obs_names.GUARD_RUNS, site="parallel.interleave",
            rung="interleave", phase="execute", outcome="ok")

    sim.run_steps = timed_run_steps
    fused.LAUNCHES = fused_batched.LAUNCHES = 0
    try:
        ok0 = runs_ok()
        deg0 = default_registry.counter_total(obs_names.DEGRADATIONS)
        t0 = time.perf_counter()
        res = il.sweep_interleaved_auto(snap, templates, profile,
                                        max_total=INTERLEAVE_LIMIT)
        wall = time.perf_counter() - t0
        cold_ms, cold_steps = step_ms[0], steps[0]
        step_ms[0], steps[0] = 0.0, 0
        t0 = time.perf_counter()
        res = il.sweep_interleaved_auto(snap, templates, profile,
                                        max_total=INTERLEAVE_LIMIT)
        warm = time.perf_counter() - t0
    finally:
        sim.run_steps = real_run_steps
    pops = sum(r.placed_count for r in res)
    assert pops == INTERLEAVE_LIMIT, pops
    assert {r.fail_type for r in res} == {"LimitReached"}
    assert not any(r.degraded for r in res), "(o).1 degraded"
    assert runs_ok() - ok0 == 2, "(o).1 the interleave engine did not serve"
    assert default_registry.counter_total(obs_names.DEGRADATIONS) == deg0
    assert fused.LAUNCHES == fused_batched.LAUNCHES == 0
    us_pop = step_ms[0] * 1e3 / steps[0]
    print(f"(o).1 {len(templates)} templates x {N_NODES} nodes, max_total "
          f"{INTERLEAVE_LIMIT}: rung interleave (guard parallel.interleave "
          f"ok, not degraded, no kernel launch), {pops} pops; cold "
          f"{wall:.3f} s (step chunks {cold_ms / 1e3:.3f} s over "
          f"{cold_steps} steps, graph capture included), warm {warm:.3f} s "
          f"= {pops / warm:.0f} pops/s end to end; the step under "
          f"CUDA-graph replay {us_pop:.1f} us/pop ({steps[0]} steps, "
          f"{step_ms[0] / 1e3:.3f} s)")

    # (o).3 bounds=True: the mix's joint bracket on the card
    t0 = time.perf_counter()
    joint, claims, degraded = bracket.bracket_mix(pbs, device=dev)
    torch.cuda.synchronize()
    mix_s = time.perf_counter() - t0
    assert not degraded, "(o).3 the device auction degraded"
    t0 = time.perf_counter()
    host = bracket._auction_host(pbs)
    host_s = time.perf_counter() - t0
    assert claims == host, "(o).3 device claims != host claims"
    auction_ms = cuda_ms(lambda: bracket.auction_device(pbs, device=dev))
    res_b = il.sweep_interleaved_auto(snap, templates, profile,
                                      max_total=INTERLEAVE_LIMIT,
                                      bounds=True)
    assert [outcome(r) for r in res_b] == [outcome(r) for r in res], \
        "(o).3 bounds=True changed the answers"
    print(f"(o).3 bounds=True: bracket_mix on the card [{joint.lower}, "
          f"{joint.upper}] (claims {sum(claims)}, == the float64 host "
          f"auction, not degraded; {mix_s:.3f} s with the solo uppers; "
          f"auction_device {auction_ms:.1f} ms by CUDA events, the host "
          f"auction {host_s * 1e3:.1f} ms); the {INTERLEAVE_LIMIT}-pop "
          f"answers equal (o).1's")

    card = interleave_runs("cuda")
    cpu = cpu_results("--interleave-cpu")
    for run in ("o1", "o2", "o4", "o5"):
        key = "report" if run == "o4" else "results"
        assert card[run][key] == cpu[run][key], f"(o) {run}: card != CPU"
    for run, what in (("o1", "the mix"),
                      ("o2", "the mix with the bench's callable "
                             "Filter+Prioritize extender")):
        rs = card[run]["results"]
        assert not any(r["degraded"] for r in rs)
        print(f"({run[0]}).{run[1]} {what} at max_total {INTERLEAVE_CHECK}: "
              f"{sum(len(r['placements']) for r in rs)} pops, card == CPU; "
              f"card {card[run]['seconds']:.3f} s, CPU "
              f"{cpu[run]['seconds']:.3f} s")
    st = card["o4"]["report"]["status"]
    placed = [sum(x["replicas"] for x in p["replicasOnNodes"])
              for p in st["pods"]]
    assert sum(placed) == INTERLEAVE_CHECK, placed
    print(f"(o).4 cluster-capacity --interleave, 3 podspecs, --max-limit "
          f"{INTERLEAVE_CHECK}, -o json: card == --device cpu ({placed} "
          f"placed, {st['failReason']!r}; card {card['o4']['seconds']:.3f} "
          f"s, CPU {cpu['o4']['seconds']:.3f} s)")
    o5 = card["o5"]["results"]
    assert any(r["fail_type"] == "Unschedulable" for r in o5)
    # more cores placed than were free at the start: evictions happened
    t_nodes, t_pods, _objs, t_raw = tiered_mix()
    cores = lambda obj: int(obj["spec"]["containers"][0]["resources"][
        "requests"]["cpu"][:-1])
    free = sum(int(n["status"]["allocatable"]["cpu"][:-1])
               for n in t_nodes) - sum(cores(p) for p in t_pods)
    used = sum(len(r["placements"]) * cores(t) for r, t in zip(o5, t_raw))
    assert used > free, "(o).5 no victim was evicted"
    print(f"(o).5 tiered mix at {TIERED_NODES} nodes (victims, host ports, "
          f"a PDB): {[len(r['placements']) for r in o5]} placements "
          f"({used} millicores placed of {free} free at the start: "
          f"preemption evicted), card == CPU; card "
          f"{card['o5']['seconds']:.3f} s, CPU {cpu['o5']['seconds']:.3f} s")
    print(f"(o) waited {cpu['waited']:.1f} s for the CPU child; phase time: "
          f"{time.perf_counter() - t_phase:.1f} s")


def serve_script(nodes):
    """(p)'s delta script, one delta an iteration from the second: every
    delta class (mask flips, pod churn, a drain, axis growth) and one
    malformed delta, which is quarantined and rolled back."""
    pod = lambda name, node: {
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"nodeName": node, "containers": [{"name": "c", "resources": {
            "requests": {"cpu": "2", "memory": "4Gi"}}}]}}
    name = lambda i: nodes[i]["metadata"]["name"]
    grown = json.loads(json.dumps(nodes[7]))
    grown["metadata"]["name"] = "node-grown"
    grown["metadata"]["labels"]["kubernetes.io/hostname"] = "node-grown"
    bad = pod("bad", name(3))
    bad["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "lots"
    return [
        {"op": "remove_node", "node": name(11)},
        {"op": "add_pod", "pod": pod("churn-1", name(12))},
        {"op": "add_node", "node": grown},
        {"op": "add_pod", "pod": bad},
        {"op": "restore_node", "node": name(11)},
        {"op": "remove_pod", "namespace": "default", "name": "churn-1"},
        {"op": "remove_pods_on", "node": name(12)},
        {"op": "remove_node", "node": name(40)},
        {"op": "add_pod", "pod": pod("churn-2", name(41))},
        {"op": "restore_node", "node": name(40)},
        {"op": "remove_pod", "namespace": "default", "name": "churn-2"},
        {"op": "remove_node", "node": name(99)},
        {"op": "add_pod", "pod": pod("churn-3", name(100))},
        {"op": "restore_node", "node": name(99)},
        {"op": "remove_pod", "namespace": "default", "name": "churn-3"},
        {"op": "remove_node", "node": name(200)},
        {"op": "restore_node", "node": name(200)},
        {"op": "add_pod", "pod": pod("churn-4", name(201))},
        {"op": "remove_pod", "namespace": "default", "name": "churn-4"},
    ]


def serve_phase(dev) -> dict:
    """Phase (p): the capacity daemon at full width — a SnapshotStore of
    the scan cell's 10,000 nodes serving the scan pod at limit
    SERVE_LIMIT (kernel 1), the fit-only 4 cpu / 8 GiB pod (the closed
    form), and 12 templates of the sweep cell (one per signature class) at
    limit 100, coalesced into one solve_group (kernel 2), for
    SERVE_ITERATIONS iterations under serve_script's deltas; then the
    breaker drills, `hypercc serve --strict` and the port soak.  Returns
    the kernels' launches on the main path and the held launches'
    max_abs_err: {"kernel1": n, "kernel2": n, "err": x}."""
    import shutil
    import tempfile

    import torch
    from cluster_capacity_tpu_torch.cli import hypercc
    from cluster_capacity_tpu_torch.engine import fast_path, fused
    from cluster_capacity_tpu_torch.engine import fused_batched
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.obs import flight, recompile
    from cluster_capacity_tpu_torch.parallel import sweep as sweep_mod
    from cluster_capacity_tpu_torch.runtime import degrade, faults, guard
    from cluster_capacity_tpu_torch.serve import (BreakerConfig, ServeConfig,
                                                  SnapshotStore, Supervisor)
    from cluster_capacity_tpu_torch.serve import soak
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    t_phase = time.perf_counter()
    _name, nodes, scan_raw, _pct = problems()[0]
    scan_pod = default_pod(scan_raw)
    fit_raw = bench_pod()
    fit_raw["metadata"]["name"] = "fit-only"
    fit_raw["spec"]["containers"][0]["resources"]["requests"] = {
        "cpu": "4", "memory": "8Gi"}
    fit_pod = default_pod(fit_raw)
    _sw_nodes, sweep_raw = sweep_cell()
    group, seen = [], set()
    for t in sweep_raw:          # the first template of each class
        req = t["spec"]["containers"][0]["resources"]["requests"]
        key = (req["cpu"], req["memory"],
               t["spec"]["topologySpreadConstraints"][0]["maxSkew"])
        if key not in seen:
            seen.add(key)
            group.append(default_pod(t))
    assert len(group) == 12, len(group)

    store = SnapshotStore(ClusterSnapshot.from_objects(nodes),
                          SchedulerProfile())
    sup = Supervisor(store, ServeConfig(breaker=BreakerConfig(
        threshold=3, window_s=60.0, cooldown_s=SERVE_COOLDOWN)))
    script = serve_script(nodes)

    def drain_items():
        """The scan and fit-only pods: their limits differ, so each takes
        the per-item ladder."""
        sup.submit(scan_pod, max_limit=SERVE_LIMIT)
        sup.submit(fit_pod)
        return sup.drain()

    def drain_group():
        for t in group:
            sup.submit(t, max_limit=SWEEP_LIMIT)
        return sup.drain()

    def verify_items(a):
        """Each answer against a fresh offline solve on its rung."""
        with faults.suspended():
            pbs = store.problems([scan_pod, fit_pod])
            for ans, pb, limit in zip(a, pbs, (SERVE_LIMIT, 0)):
                assert ans.error is None, ans.error
                if ans.rung == degrade.RUNG_FUSED:
                    ref = fast_path.solve_auto(pb, max_limit=limit)
                else:
                    assert ans.rung == degrade.RUNG_FAST_PATH, ans.rung
                    ref = fast_path.solve_fast(pb, max_limit=limit)
                assert list(ans.result.placements) == list(ref.placements), \
                    "(p) a served answer != its offline solve"
                assert (ans.result.fail_type, ans.result.fail_message) == \
                    (ref.fail_type, ref.fail_message)

    def verify_group(b):
        """The group's answers against one offline solve_group (or, pinned
        per item, each template's offline kernel-1 solve)."""
        with faults.suspended():
            gpbs = store.problems(group)
            if {x.rung for x in b} == {degrade.RUNG_BATCHED}:
                refs = sweep_mod.solve_group(gpbs, max_limit=SWEEP_LIMIT)
            else:
                refs = [fast_path.solve_auto(pb, max_limit=SWEEP_LIMIT)
                        for pb in gpbs]
            for ans, ref in zip(b, refs):
                assert ans.error is None, ans.error
                assert list(ans.result.placements) == list(ref.placements)
                assert ans.result.fail_message == ref.fail_message

    # capture the first launch of each kernel on serve's path
    real1, real2 = fused.fused_steps, fused_batched.fused_steps_batched
    held = {}

    def held1(const, planes, scalars, table, k, *args, **kw):
        inputs = None if "k1" in held else (
            const.clone(), planes.clone(), scalars.clone(), table, k)
        out = real1(const, planes, scalars, table, k, *args, **kw)
        if inputs is not None:
            held["k1"] = (inputs, out[2].clone())
        return out

    def held2(const, carry, scalars, tables, k, *args, **kw):
        inputs = None if "k2" in held else (
            const.clone(), carry.clone(), scalars.clone(),
            type(tables)(tables.i.clone(), tables.f.clone()), k)
        out = real2(const, carry, scalars, tables, k, *args, **kw)
        if inputs is not None:
            held["k2"] = (inputs, out[2].clone())
        return out

    lat, serve_s, rec, applied = [], 0.0, [], []
    # recompiles must stay flat from the first iteration after which every
    # delta class has been applied (iteration i applies script[i - 2])
    firsts = {}
    for i, d in enumerate(script):
        firsts.setdefault(d["op"], i)
    all_classes_at = 2 + max(firsts.values())
    # the kernels' counts cover serve's drains only, not the offline
    # solves that check them
    launches = {"kernel1": 0, "kernel2": 0}
    fused.fused_steps, fused_batched.fused_steps_batched = held1, held2
    tally = recompile.CompileTally().__enter__()
    try:
        for it in range(1, SERVE_ITERATIONS + 1):
            if it > 1:
                applied.append(sup.apply_delta(script[it - 2]))
            fused.LAUNCHES = fused_batched.LAUNCHES = 0
            t0 = time.perf_counter()
            a = drain_items()
            b = drain_group()
            torch.cuda.synchronize()
            serve_s += time.perf_counter() - t0
            launches["kernel1"] += fused.LAUNCHES
            launches["kernel2"] += fused_batched.LAUNCHES
            rec.append(tally.count)
            assert [x.rung for x in a] == [degrade.RUNG_FUSED] * 2, \
                [x.rung for x in a]
            assert {x.rung for x in b} == {degrade.RUNG_BATCHED}
            assert not any(x.degraded or x.error for x in a + b)
            lat += [x.latency_s for x in a + b]
            verify_items(a)
            verify_group(b)
    finally:
        tally.__exit__(None, None, None)
        fused.fused_steps, fused_batched.fused_steps_batched = real1, real2
    assert launches["kernel1"] > 0 and launches["kernel2"] > 0, launches
    assert applied.count(False) == 1 and store.quarantined == 1
    assert store.full_rebuilds >= 1
    flat = rec[all_classes_at - 1:]
    assert len(set(flat)) == 1, f"(p) recompiles moved: {rec}"

    answers = sum(1 for _ in lat)
    lat.sort()
    pct = lambda q: lat[min(len(lat) - 1, int(q * (len(lat) - 1)))] * 1e3
    print(f"(p) serve at {N_NODES} nodes: {SERVE_ITERATIONS} iterations, "
          f"{answers} answers (the scan pod at limit {SERVE_LIMIT} on kernel "
          f"1, the fit-only pod on the closed form, 12 sweep templates in "
          f"one solve_group on kernel 2), every answer == its offline solve; "
          f"{len(script[:SERVE_ITERATIONS - 1])} deltas ({store.applied} "
          f"applied, {store.quarantined} quarantined, "
          f"{store.full_rebuilds} full rebuild); {answers / serve_s:.2f} "
          f"queries/s over {serve_s:.3f} s of drains, latency p50 "
          f"{pct(0.5):.1f} ms p99 {pct(0.99):.1f} ms; kernel 1 "
          f"{launches['kernel1']} launches, kernel 2 {launches['kernel2']}; "
          f"compiles (kernel builds and graph captures, "
          f"obs/recompile.CompileTally) {rec[0]} after iteration 1, "
          f"{flat[0]} from iteration {all_classes_at} (every delta class "
          f"seen) to {SERVE_ITERATIONS}")

    # the held launches against the plain versions over K_HELD steps
    err = 0.0
    for tag, real, ref_fn in (
            ("k1", real1, fused.fused_steps_reference),
            ("k2", real2, fused_batched.fused_steps_batched_reference)):
        (const, planes, scalars, table, k), chosen = held[tag]
        kh = min(K_HELD, k)
        plain = ref_fn(const, planes, scalars, table, kh)
        kern = real(const, planes, scalars, table, kh)
        err = max(err, _assert_equal(kern, plain, f"(p) {tag} held"))
        first = chosen[:, :kh] if tag == "k2" else chosen.reshape(-1)[:kh]
        assert torch.equal(first, plain[2] if tag == "k2"
                           else plain[2].reshape(-1)), \
            f"(p) serve's first {tag} launch != the plain version"
        print(f"(p) serve's first kernel-{tag[1]} launch ({k} steps, "
              f"{const.shape[0]} const rows) == the plain version over its "
              f"first {kh} steps (max_abs_err {err})")

    # breaker drills: a solve_group OOM burst (one drain a retry and a
    # fallback, the next opens the breaker) pins the group per item
    faults.install_text(["parallel.solve_group:oom:1:0"])
    try:
        burst = [drain_group() for _ in range(2)]
    finally:
        faults.clear()
    gbr = sup.board.breaker(degrade.RUNG_BATCHED)
    assert gbr.state == "open", gbr.state
    pinned = drain_group()           # inside the cooldown, fault cleared
    for b in burst + [pinned]:
        assert {x.rung for x in b} == {degrade.RUNG_FUSED}, "(p) not pinned"
        assert all(x.degraded for x in b)
        verify_group(b)
    time.sleep(SERVE_COOLDOWN * 1.2)
    b = drain_group()
    assert {x.rung for x in b} == {degrade.RUNG_BATCHED} and \
        gbr.state == "closed", "(p) the half-open probe did not close"
    verify_group(b)
    # engine.solve:oom on the fit-only pod pins it to fast_path
    faults.install_text(["engine.solve:oom:1:0"])
    try:
        for _ in range(3):
            sup.submit(fit_pod)
            ans, = sup.drain()
            assert (ans.rung, ans.degraded) == (degrade.RUNG_FAST_PATH, True)
    finally:
        faults.clear()
    sbr = sup.board.breaker(degrade.RUNG_FUSED)
    assert sbr.state == "open"
    sup.submit(fit_pod)
    ans, = sup.drain()
    assert ans.rung == degrade.RUNG_FAST_PATH, "(p) fit-only not pinned"
    time.sleep(SERVE_COOLDOWN * 1.2)
    sup.submit(fit_pod)
    ans, = sup.drain()
    assert (ans.rung, ans.degraded, sbr.state) == (degrade.RUNG_FUSED, False,
                                                   "closed")
    print(f"(p) breakers: parallel.solve_group:oom opened the batched "
          f"breaker (the group pinned to per-item kernel 1, answers equal), "
          f"engine.solve:oom pinned the fit-only pod to fast_path; both "
          f"closed by their half-open probes after the {SERVE_COOLDOWN} s "
          f"cooldown")

    # a request deadline on the card: the watchdog threads stay pooled
    timed = Supervisor(store, ServeConfig(deadline_s=30.0))
    for _ in range(6):
        assert timed.serve(fit_pod).error is None
    assert guard.watchdog_threads() <= guard._MAX_IDLE_WATCHDOGS
    print(f"(p) 6 fit-only serves under a 30 s deadline: "
          f"{guard.watchdog_threads()} watchdog thread(s) alive (pool cap "
          f"{guard._MAX_IDLE_WATCHDOGS})")

    # hypercc serve --strict on a JSON snapshot with a delta script
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p_")
    try:
        snap_path, pod_path = write_cell(tmp, nodes, [], scan_raw, "p")
        fit_path = os.path.join(tmp, "p-fit.json")
        with open(fit_path, "w") as f:
            json.dump(fit_raw, f)
        deltas = os.path.join(tmp, "p-deltas.jsonl")
        with open(deltas, "w") as f:
            for d in script[:4]:
                f.write(json.dumps(d) + "\n")
        t0 = time.perf_counter()
        rc, text = run_cli(hypercc.run, [
            "serve", "--snapshot", snap_path, "--podspec", pod_path,
            "--podspec", fit_path, "--deltas", deltas, "--iterations", "5",
            "--max-limit", str(CLI_SERVE_LIMIT), "--strict"])
        cli_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = text.splitlines()
    assert rc == 0 and len(lines) == 5, (rc, text)
    assert all("state=ok" in x for x in lines), text
    print(f"(p) hypercc serve --deltas (4) --iterations 5 --max-limit "
          f"{CLI_SERVE_LIMIT} --strict: exit 0 in {cli_s:.3f} s; last line "
          f"{lines[-1]!r}")

    # the port's chaos soak, smoke mode, on the card
    t0 = time.perf_counter()
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "soak_torch.json")
    rc = soak.main(["--smoke", "--out", out_path])
    soak_s = time.perf_counter() - t0
    flight.uninstall()
    assert rc == 0, "(p) the soak failed"
    with open(out_path) as f:
        doc = json.load(f)
    assert soak_s < SOAK_BUDGET_S, soak_s
    print(f"(p) soak --smoke on the card: exit 0 in {soak_s:.1f} s; "
          f"{doc['soak_answers']} answers, {doc['soak_queries_per_sec']} "
          f"q/s steady, p50 {doc['soak_p50_latency_ms']} ms p99 "
          f"{doc['soak_p99_latency_ms']} ms, {doc['soak_faults_injected']} "
          f"faults, {doc['soak_breakers_opened']} breaker opens, "
          f"{doc['soak_steady_recompiles']} steady recompiles")
    print(f"(p) phase time: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches, err=err)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"


def mesh_worker(base: str, out_path: str, limit: int) -> int:
    """One process of (q).7 (`chip_smoke.py --mesh-worker BASE OUT LIMIT`,
    CC_COORDINATOR / CC_NUM_PROCESSES / CC_PROCESS_ID set): joins the gloo
    process group, loads its shard of the snapshot, solves the scan pod on
    the mesh of every process's card and, as process 0, writes the
    outcome."""
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.parallel import distributed as dist
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    dist.initialize(backend="gloo", timeout_s=300)
    try:
        mesh = dist.global_mesh(device="cuda")
        snap = dist.load_snapshot_distributed(base)
        with open(base + ".pod.json") as f:
            pod = default_pod(json.load(f))
        pb = encode_problem(snap, pod, SchedulerProfile())
        t0 = time.perf_counter()
        res = dist.solve_on_mesh(pb, mesh, max_limit=limit)
        seconds = time.perf_counter() - t0
        if dist.process_index() == 0:
            with open(out_path, "w") as f:
                json.dump(dict(outcome(res), seconds=seconds,
                               processes=dist.process_count(),
                               mesh=mesh.shape), f)
    finally:
        import torch.distributed as tdist
        tdist.destroy_process_group()
    return 0


def _two_process_mesh(nodes, pod, limit: int) -> dict:
    """(q).7: two processes on the one card, joined over gloo, run
    distributed.solve_on_mesh on a 1x2 mesh (one shard each); returns
    process 0's outcome."""
    import shutil
    import socket
    import tempfile

    from cluster_capacity_tpu_torch.parallel import distributed as dist

    tmp = tempfile.mkdtemp(prefix="cc-mesh-")
    procs = []
    try:
        base = os.path.join(tmp, "snap")
        dist.write_sharded_snapshot(base, nodes, num_shards=2)
        with open(base + ".pod.json", "w") as f:
            json.dump(pod, f)
        out = os.path.join(tmp, "out.json")
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        for pid in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-worker",
                 base, out, str(limit)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=dict(os.environ, CC_COORDINATOR=f"127.0.0.1:{port}",
                         CC_NUM_PROCESSES="2", CC_PROCESS_ID=str(pid))))
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"(q).7 worker failed ({p.returncode}):\n"
                                   f"{log[-4000:]}")
        with open(out) as f:
            return json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_phase(dev, card: str) -> dict:
    """Phase (q): the device mesh on the card — a logical 2×2 mesh of the
    one card (four shards, two mesh rows) through the entry points, every
    answer held against the unsharded one on the kernels.  Returns kernel
    1's and kernel 2's launches, each counted from 0 just before a run and
    read just after it, by the path that made them: {"mesh": the sharded
    runs' (none: the mesh path runs no kernel), "mesh_fallback": the run
    that the injected fault sends down to the unsharded rung,
    "mesh_reference": the unsharded answers the sharded ones are held
    against}, each {"kernel1": n, "kernel2": n}."""
    import shutil
    import tempfile

    import torch
    from cluster_capacity_tpu_torch import ClusterCapacity, bounds
    from cluster_capacity_tpu_torch.cli import hypercc
    from cluster_capacity_tpu_torch.engine import fused, fused_batched
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.parallel import mesh as mesh_lib
    from cluster_capacity_tpu_torch.parallel import sweep
    from cluster_capacity_tpu_torch.resilience import scenarios as scen
    from cluster_capacity_tpu_torch.runtime import faults
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    t_phase = time.perf_counter()
    mesh = mesh_lib.make_mesh(n_node_shards=2, n_batch_shards=2,
                              devices=[dev] * 4)
    launches = {path: {"kernel1": 0, "kernel2": 0}
                for path in ("mesh", "mesh_fallback", "mesh_reference")}

    def kernels(fn, path="mesh_reference"):
        """fn() with the kernels' launches counted into launches[path]."""
        fused.LAUNCHES = fused_batched.LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        launches[path]["kernel1"] += fused.LAUNCHES
        launches[path]["kernel2"] += fused_batched.LAUNCHES
        return out

    def sharded(fn):
        """fn() on the mesh: (result, wall seconds); no kernel launches."""
        t0 = time.perf_counter()
        out = kernels(fn, "mesh")
        wall = time.perf_counter() - t0
        assert launches["mesh"] == {"kernel1": 0, "kernel2": 0}, \
            "the mesh path launched a kernel"
        return out, wall

    def estimate(nodes, pod, limit, **kw):
        cc = ClusterCapacity(default_pod(pod), max_limit=limit, **kw)
        cc.sync_with_objects(nodes)
        return cc.run()

    def same(a, b, what):
        assert (a.placements, a.fail_type, a.fail_message) == \
            (b.placements, b.fail_type, b.fail_message), what

    # (q).1 / (q).2: the scan cell through ClusterCapacity(mesh=...)
    _name, nodes, pod, _pct = problems()[0]
    for tag, n, limit in (("(q).1", N_NODES, MESH_LIMIT),
                          ("(q).2", fused.MAX_NODES, MESH_BIG_LIMIT)):
        cell = nodes if n == N_NODES else make_nodes(n=n)
        want = kernels(lambda: estimate(cell, pod, limit))
        got, wall = sharded(lambda: estimate(cell, pod, limit, mesh=mesh))
        same(got, want, tag)
        assert (got.rung, got.degraded) == ("sharded_batched", False), \
            (got.rung, got.degraded)
        print(f"{tag} scan pod at {n} nodes, limit {limit}, 2x2 mesh of "
              f"one card: {got.placed_count} placements == kernel 1's, "
              f"{got.fail_type}; {wall:.3f} s, {wall / limit * 1e3:.3f} "
              f"ms/step (eager, encode included) [{card}]")

    # (q).3: the sweep cell on the mesh
    snodes, templates = sweep_cell()
    snap = ClusterSnapshot.from_objects(snodes)
    tpods = [default_pod(t) for t in templates]
    want = kernels(lambda: sweep.sweep(snap, tpods,
                                       max_limit=MESH_SWEEP_LIMIT))
    got, wall = sharded(lambda: sweep.sweep(snap, tpods,
                                            max_limit=MESH_SWEEP_LIMIT,
                                            mesh=mesh))
    for i, (a, b) in enumerate(zip(got, want)):
        same(a, b, f"(q).3 template {i}")
    assert {r.rung for r in got} == {"sharded_batched"}, \
        {r.rung for r in got}
    print(f"(q).3 sweep cell, {len(tpods)} templates, limit "
          f"{MESH_SWEEP_LIMIT}, 2x2 mesh: every answer == kernel 2's group "
          f"answer, {wall:.3f} s [{card}]")

    # (q).4: bracket_group on the resilience cell's scenarios
    rnodes, rpods = resilience_cluster()
    rsnap = ClusterSnapshot.from_objects(rnodes, rpods)
    probe = default_pod({"metadata": {"name": "probe"}, "spec": {
        "containers": [{"name": "c", "resources": {"requests": {
            "cpu": "4", "memory": "8Gi"}}}]}})
    sc = scen.zone_scenarios(rsnap) + \
        scen.single_node_scenarios(rsnap)[:MESH_BRACKET_SCENARIOS]
    pbs = []
    for s in sc:
        alive = np.ones(rsnap.num_nodes, dtype=bool)
        alive[list(s.failed)] = False
        pbs.append(encode_problem(rsnap, probe, SchedulerProfile(),
                                  alive_mask=alive))
    plain, pdeg = bounds.bracket_group(pbs, device=dev)
    (got, gdeg), wall = sharded(lambda: bounds.bracket_group(
        pbs, mesh=mesh, device=dev))
    assert not pdeg and not gdeg
    frac_ulps = 0
    for a, b in zip(got, plain):
        assert (a.lower, a.upper, a.exact, a.method) == \
            (b.lower, b.upper, b.exact, b.method), (a, b)
        fa, fb = np.float32(a.frac), np.float32(b.frac)
        ulps = abs(int(fa.view(np.int32)) - int(fb.view(np.int32)))
        frac_ulps = max(frac_ulps, ulps)
    assert frac_ulps <= 16, frac_ulps
    print(f"(q).4 bracket_group over {len(pbs)} resilience scenarios at "
          f"{rsnap.num_nodes} nodes on the mesh: lower/upper/exact/method "
          f"== unsharded, frac within {frac_ulps} float32 ulps, "
          f"{wall * 1e3:.1f} ms [{card}]")

    # (q).5: the CLIs with --mesh 1x1, and --mesh 2x2 refused
    tmp = tempfile.mkdtemp(prefix="cc-mesh-cli-")
    try:
        small = make_nodes(n=MESH_CHECK_NODES)
        snap_path, pod_path = write_cell(tmp, small, [], pod, "mesh")
        pod2 = json.loads(json.dumps(pod))
        pod2["metadata"]["name"] = "bench-pod-2"
        pod2["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "300m"
        pod2_path = os.path.join(tmp, "mesh-pod2.json")
        with open(pod2_path, "w") as f:
            json.dump(pod2, f)
        cli = ["--snapshot", snap_path, "--max-limit", str(MESH_CHECK_LIMIT)]
        rc, out = run_cli(hypercc.run, ["cluster-capacity", "--podspec",
                                        pod_path, "-o", "json", "--mesh",
                                        "1x1"] + cli)
        doc = json.loads(out)
        assert rc == 0 and doc["status"]["rung"] == "sharded_batched" \
            and not doc["status"]["degraded"], (rc, doc["status"])
        # the spread-free pod: its scenarios are mask-exact and batch
        free_path = os.path.join(tmp, "mesh-free-pod.json")
        with open(free_path, "w") as f:
            json.dump(bench_pod(), f)
        rc, out = run_cli(hypercc.run, ["resilience", "--snapshot",
                                        snap_path, "--podspec", free_path,
                                        "--max-limit",
                                        str(MESH_CHECK_LIMIT), "--zones",
                                        "--no-bounds", "-o", "json",
                                        "--mesh", "1x1"])
        doc = json.loads(out)
        rungs = {r["rung"] for r in doc["status"]["scenarios"]
                 if r["batched"]}
        assert rc == 0 and doc["status"]["mesh"] == {"batch": 1, "nodes": 1}
        assert rungs == {"sharded_batched"}, rungs
        rc, out = run_cli(hypercc.run, ["serve", "--snapshot", snap_path,
                                        "--podspec", pod_path, "--podspec",
                                        pod2_path, "--max-limit",
                                        str(MESH_CHECK_LIMIT),
                                        "--iterations", "2", "--strict",
                                        "--verbose", "--mesh", "1x1"])
        assert rc == 0 and "rung=sharded_batched" in out, (rc, out)
        for argv in (["cluster-capacity", "--podspec", pod_path] + cli,
                     ["resilience", "--snapshot", snap_path],
                     ["serve", "--snapshot", snap_path, "--podspec",
                      pod_path]):
            import contextlib
            import io
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = run_cli(hypercc.run, argv + ["--mesh", "2x2"])[0]
            assert rc == 1 and "mesh 2x2 needs 4 devices, have 1" in \
                err.getvalue(), (argv[0], rc, err.getvalue())
        print(f"(q).5 cluster-capacity, resilience and serve --strict with "
              f"--mesh 1x1: rung sharded_batched, status.mesh "
              f"{{'batch': 1, 'nodes': 1}}; --mesh 2x2 exits 1 \"mesh 2x2 "
              f"needs 4 devices, have 1\"")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (q).6: a classified fault at the sharded rung
    want = kernels(lambda: estimate(nodes, pod, MESH_CHECK_LIMIT))
    with faults.inject("parallel.sharded:oom"):
        got = kernels(lambda: estimate(nodes, pod, MESH_CHECK_LIMIT,
                                       mesh=mesh), "mesh_fallback")
    same(got, want, "(q).6")
    assert (got.rung, got.degraded) == ("fused_batched", True), \
        (got.rung, got.degraded)
    print(f"(q).6 parallel.sharded:oom: served by fused_batched, degraded, "
          f"{got.placed_count} placements == the healthy run's")

    # (q).7: two processes on the one card through gloo
    small = make_nodes(n=MESH_CHECK_NODES)
    want = kernels(lambda: estimate(small, pod, MESH_CHECK_LIMIT))
    t0 = time.perf_counter()
    got = _two_process_mesh(small, pod, MESH_CHECK_LIMIT)
    wall = time.perf_counter() - t0
    assert (got["placements"], got["fail_type"], got["fail_message"]) == \
        (want.placements, want.fail_type, want.fail_message), got
    assert got["processes"] == 2 and got["mesh"] == {"batch": 1, "nodes": 2}
    print(f"(q).7 two processes on the one card (gloo, 1x2 mesh) at "
          f"{MESH_CHECK_NODES} nodes, limit {MESH_CHECK_LIMIT}: == the "
          f"single-process answer; solve {got['seconds']:.3f} s, "
          f"{wall:.1f} s with the processes' start [{card}]")

    # (q).8: card == CPU on the 2x2 mesh: the sampled soft-spread problem
    _name, _n, bpod, pct = problems()[1]
    bnodes = make_nodes(n=MESH_CHECK_NODES, taint_every=10)
    profile = SchedulerProfile()
    profile.percentage_of_nodes_to_score = pct
    cpu_mesh = mesh_lib.make_mesh(n_node_shards=2, n_batch_shards=2,
                                  device="cpu")
    want = kernels(lambda: estimate(bnodes, bpod, MESH_CHECK_LIMIT,
                                    profile=profile))
    got, wall = sharded(lambda: estimate(bnodes, bpod, MESH_CHECK_LIMIT,
                                         profile=profile, mesh=mesh))
    cpu = estimate(bnodes, bpod, MESH_CHECK_LIMIT, profile=profile,
                   mesh=cpu_mesh, device="cpu")
    same(got, want, "(q).8 card mesh vs kernel 1")
    same(got, cpu, "(q).8 card == CPU")
    print(f"(q).8 soft spread + preferred anti-affinity + taints, "
          f"{pct}% sampling, {MESH_CHECK_NODES} nodes, limit "
          f"{MESH_CHECK_LIMIT}, 2x2 mesh: card == CPU == kernel 1, "
          f"{wall:.3f} s on the card [{card}]")
    print(f"(q) phase time: {time.perf_counter() - t_phase:.1f} s; kernel "
          f"launches by path {launches} [{card}]")
    return launches


if __name__ == "__main__":
    if sys.argv[1:] == ["--interleave-cpu"]:
        sys.exit(interleave_cpu_runs())
    if sys.argv[1:] == ["--dra-cpu"]:
        sys.exit(dra_cpu_runs())
    if sys.argv[1:] == ["--frontend-cpu"]:
        sys.exit(frontend_cpu_runs())
    if sys.argv[1:] == ["--resilience-cpu"]:
        sys.exit(resilience_cpu_runs())
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2], sys.argv[3], int(sys.argv[4])))
    try:
        sys.exit(main())
    finally:
        for proc in _CPU_RUNS.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
