#!/usr/bin/env python3
"""Time kernel 1 of the PyTorch/CUDA port at every cluster size, over a
grid of node counts, for one checkout, on one NVIDIA card.

    python3 tools/cluster_grid.py ROOT TAG [OUT.json [NODES,...]]

ROOT is the root of a checkout of this repository (it holds chip_smoke.py,
portbench/ and cluster_capacity_tpu_torch/); its kernels build into
ROOT/build/grid.  Every line printed starts with TAG; OUT.json, where
given, gets every row.

Five problem families, each encoded and packed as engine.simulator.solve
packs it, at 640, 1,280, 2,560, 5,000, 10,000 and 20,000 nodes (node
lanes 640 to 20,096) or at the comma-separated NODES:

- `spread`: portbench's k8s-5000n nodes and residents and its `spread`
  pod (a hard zone spread), resized;
- `prefanti`: portbench's k8s-5000n-prefanti nodes and residents and its
  `prefanti` pod (InterPodAffinity's preferred planes live), resized;
- `prefspread`: portbench's k8s-5000n-prefspread nodes and residents and
  its `prefspread` pod (a soft zone spread: the score's second
  cluster-wide min/max reduction live at every step), resized;
- `b`, `c`: chip_smoke.py's problems (b) and (c), on its make_nodes; (c)
  in one zone, so that its required hostname anti-affinity leaves every
  node open to the zone affinity and 512 steps stay live from 640 nodes.

For each, kernel 1 runs 512 live steps at each cluster size the card
schedules and at the checkout's own launch plan; the time is us/step by
CUDA events (chip_smoke.cuda_ms, median of three rounds of three
launches), and every cluster size's outputs are held equal to the
single-CTA launch's, bit for bit.  The `spread` family at 128 nodes gives
the latency floor at each size.
"""

from __future__ import annotations

import copy
import json
import os
import sys

NODES = (640, 1280, 2560, 5000, 10000, 20000)
K = 512


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    out_path = sys.argv[3] if len(sys.argv) > 3 else None
    counts = [int(n) for n in sys.argv[4].split(",")] \
        if len(sys.argv) > 4 else NODES
    sys.path.insert(0, root)
    os.environ["CC_TORCH_BUILD_DIR"] = os.path.join(root, "build", "grid")
    import torch
    if not torch.cuda.is_available():
        print("cluster_grid: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cluster_capacity_tpu_torch.engine import fused
    from cluster_capacity_tpu_torch.engine import simulator as sim
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile
    from portbench.harness import load_json
    from portbench.program import profile_of
    from portbench.reference.cluster import make_cluster, make_pod
    if not fused.__file__.startswith(root):
        raise RuntimeError(f"imported {fused.__file__}, not from {root}")
    dev = torch.device("cuda")
    say = lambda msg: print(f"{tag} {msg}", flush=True)
    fused.build()
    slots = fused.cluster_slots()
    sizes = [c for c in fused.CLUSTER_SIZES if slots.get(c, 0) >= 1]
    say(f"card {torch.cuda.get_device_name()}; cluster slots {slots}")

    def pack(nodes, pods, pod, profile):
        pb = encode_problem(ClusterSnapshot.from_objects(nodes, pods),
                            default_pod(pod), profile)
        cfg = sim.static_config(pb)
        fused.check_eligible(cfg, pb)
        consts = sim.build_consts(pb, dev)
        pk = fused._pack_meta(cfg, pb)
        planes, scalars = fused._pack_carry(pk, sim._init_carry(pb, consts))
        return (fused._pack_consts(pk, consts), planes, scalars,
                fused.kernel_table(pk, dev))

    def portbench_family(config, traffic):
        cfg = load_json("configs", config)
        pod = make_pod(load_json("traffic", traffic)["pod"])

        def make(n):
            c = copy.deepcopy(cfg)
            c["nodes"] = n
            nodes, pods = make_cluster(c, seed=2 ** 31 + 7)
            return pack(nodes, pods, pod, profile_of(cfg))
        return make

    def smoke_family(index):
        _name, _nodes, pod, pct = cs.problems()[index]
        taints = 10 if index == 1 else 0
        zones = 1 if index == 2 else cs.N_ZONES

        def make(n):
            profile = SchedulerProfile()
            profile.percentage_of_nodes_to_score = pct
            return pack(cs.make_nodes(n=n, zones=zones, taint_every=taints),
                        [], pod, profile)
        return make

    families = [("spread", portbench_family("k8s-5000n", "spread")),
                ("prefanti", portbench_family("k8s-5000n-prefanti",
                                              "prefanti")),
                ("prefspread", portbench_family("k8s-5000n-prefspread",
                                                "prefspread")),
                ("b", smoke_family(1)), ("c", smoke_family(2))]
    rows = []

    def measure(family, n, prob):
        const, planes = prob[0], prob[1]
        npad = const.shape[1] * fused.LANES
        n_const, n_carry = const.shape[0], planes.shape[0]
        plan = fused.card_plan(npad, n_const, n_carry)
        base = None
        for c in sizes + ["plan"]:
            kw = {} if c == "plan" else {"cluster": c}
            run = lambda: fused.fused_steps(*prob, K, **kw)
            got = run()
            torch.cuda.synchronize()
            live = bool((got[2] >= 0).all())
            if base is None:
                base = got
            equal = all(torch.equal(a, b) for a, b in zip(got, base))
            us = cs.cuda_ms(run, reps=3) / K * 1e3
            used = fused.LAST_PLAN
            row = {"family": family, "nodes": n, "npad": npad,
                   "n_const": n_const, "n_carry": n_carry,
                   "cluster": used.cluster, "lanes": used.lanes,
                   "threads": used.threads, "resident": used.resident,
                   "all_resident": used.resident == fused.SCRATCH_PLANES
                   + n_const + n_carry, "at_plan": c == "plan",
                   "us_per_step": round(us, 3), "equal": equal,
                   "live": live}
            rows.append(row)
            say(f"{family} n={n} npad={npad} planes={n_const}+{n_carry} "
                f"{'plan ' if c == 'plan' else ''}C={used.cluster} "
                f"lanes={used.lanes} threads={used.threads} "
                f"resident={used.resident}{'' if row['all_resident'] else '*'}"
                f" {us:.3f} us/step equal={equal} live={live}")
        say(f"{family} n={n}: the plan takes {plan.describe()}")

    for family, make in families:
        for n in counts:
            measure(family, n, make(n))
    measure("floor", 128, families[0][1](128))
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump({"tag": tag, "slots": slots, "rows": rows}, fh,
                      indent=1)
    bad = [r for r in rows if not (r["equal"] and r["live"])]
    for r in bad:
        say(f"NOT EQUAL OR STOPPED: {r}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
