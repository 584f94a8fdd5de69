#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's fused kernels and its two bench cells, for
one checkout, on one NVIDIA card.

    python3 tools/kernel_ab.py ROOT TAG

ROOT is the root of a checkout of this repository (it holds chip_smoke.py
and cluster_capacity_tpu_torch/); its kernels build into ROOT/build/ab.
Every line printed starts with TAG.  To compare two checkouts, run them
one after another on the same card as separate processes, in the order
parent, change, change, parent.

Measured, with CUDA events over repeated launches after a warm-up launch:
kernel 1 (us/step, 512-step launches) on chip_smoke's problems (a), (b) and
(c) at the launch plan's cluster size, and at 16 CTAs where the checkout
takes a cluster size; kernel 1's latency floor (the scan problem's flags at
128 nodes, 4,096 steps); kernel 2 (us/step, 128-step launches) on the bench
sweep group at B = 12, 32 and 100.  Host clock, each three times: the scan
cell through ClusterCapacity.run (100,000 placements) and the sweep cell
through sweep() (100 templates x 100), in placements per second.
"""

from __future__ import annotations

import inspect
import os
import sys
import time


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    os.environ["CC_TORCH_BUILD_DIR"] = os.path.join(root, "build", "ab")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cluster_capacity_tpu_torch import ClusterCapacity
    from cluster_capacity_tpu_torch.engine import fused, fused_batched
    from cluster_capacity_tpu_torch.engine.fused import KernelTable
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.parallel.sweep import sweep
    if not fused.__file__.startswith(root):
        raise RuntimeError(f"imported {fused.__file__}, not from {root}")
    dev = torch.device("cuda")
    say = lambda msg: print(f"{tag} {msg}", flush=True)
    fused.build()
    takes_cluster = "cluster" in inspect.signature(fused.fused_steps).parameters

    def per_step(launch, args, k, **kw):
        launch(*args, k, **kw)
        return cs.cuda_ms(lambda: launch(*args, k, **kw), reps=3) / k * 1e3

    k = 512
    for name, nodes, pod, pct in cs.problems():
        prob = cs.packed(nodes, pod, pct, dev)
        say(f"kernel 1 {name}: {per_step(fused.fused_steps, prob, k):.2f} "
            f"us/step at the plan's cluster")
        if takes_cluster:
            say(f"kernel 1 {name}: "
                f"{per_step(fused.fused_steps, prob, k, cluster=16):.2f} "
                f"us/step at cluster 16")
    name, nodes, pod, pct = cs.problems()[0]
    floor = cs.packed(cs.make_nodes(n=128), pod, pct, dev)
    say(f"kernel 1 floor (128 nodes): "
        f"{per_step(fused.fused_steps, floor, 4096):.3f} us/step")

    sweep_nodes, tpls = cs.sweep_cell()
    const, planes, scalars, tables = cs.packed_group(sweep_nodes, tpls, 100,
                                                     dev)
    for b in (12, 32, 100):
        sub = lambda t: t[:b].contiguous()
        group = (sub(const), sub(planes), sub(scalars),
                 KernelTable(sub(tables.i), sub(tables.f)))
        say(f"kernel 2 B={b}: "
            f"{per_step(fused_batched.fused_steps_batched, group, 128):.2f} "
            f"us/step")

    snapshot = ClusterSnapshot.from_objects(sweep_nodes)
    pods = [default_pod(t) for t in tpls]
    for _rep in range(3):
        cc = ClusterCapacity(default_pod(pod), max_limit=cs.MAX_LIMIT)
        cc.sync_with_objects(nodes)
        t0 = time.perf_counter()
        r = cc.run()
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = sweep(snapshot, pods, max_limit=cs.SWEEP_LIMIT, device=dev)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        placed = sum(x.placed_count for x in results)
        say(f"scan cell {r.placed_count / scan_s:.0f} placements/s "
            f"({scan_s:.3f} s); sweep cell {placed / sweep_s:.0f} "
            f"placements/s ({sweep_s:.3f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
