"""Chaos soak harness for the capacity daemon: drive serve.Supervisor
in-process under a randomized fault-injection schedule plus scripted
snapshot churn, on the card (default) or the CPU, and continuously assert
the serving contract the daemon promises:

    python -m cluster_capacity_tpu_torch.serve.soak [--smoke] [--device cpu]


1. **Bit-identity.**  Every served answer (healthy, degraded, or
   breaker-pinned) equals a fresh offline solve of the same encoded
   problem on the same rung, with injection suspended: whatever the
   supervisor's restarts, memo drops, delta ingestion and breaker pinning
   did to the daemon's state, the answer must match a clean-state
   computation exactly.  (Cross-rung parity is the parity/fuzz suites'
   contract; near-tie states on a homogeneous fleet can order two equal
   nodes differently across kernels, so the soak pins same-rung identity.)
2. **Zero steady-state recompiles.**  After the warmup phase has visited
   every rung, every delta class, and both alive-mask states,
   ``cc_recompiles_total`` must stay flat: churn moves tensor *data*,
   never tensor *shapes*.  A compile here is a kernel build or a
   CUDA-graph capture (obs/recompile.py).
3. **Breaker lifecycle.**  The scripted fault bursts must open circuit
   breakers, pin requests to the rung below, and recover through the
   half-open probe within the pinned cooldown plus a small scheduling
   slack (asserted over the steady region — warmup recoveries also absorb
   the harness's own offline-verification wall time); the run must end
   with every breaker closed.
4. **A flight bundle per classified fault.**  The flight recorder dumps
   exactly one bundle for every injected fault the guard classified
   (unclassified 'error'-kind injections crash-restart the worker
   instead and are excluded by construction).
5. **Bounded growth.**  Watchdog threads stay pooled, the span ring and
   the shared-encode memo stay capped, and every submitted request gets
   exactly one answer — nothing leaks, nothing is dropped.

The run writes its artifact (sustained queries/s, p50/p99 latency,
fault/recovery counts) only to ``--out``, by default build/soak_torch.json
under the checkout.  Exit 0 = every invariant held; 1 = violations (listed
in the artifact's ``failures``).

Smoke mode runs the same phases with a shorter steady loop; the full soak
just turns the iteration count up.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# -- synthetic cluster ------------------------------------------------------
# Sized so every template's capacity sits mid-way inside one power-of-two
# budget bucket (parallel/sweep rounds the batched chunk length up to one),
# with enough headroom that +-2 dead nodes and a bounded churn-pod pool
# never cross a bucket edge.

N_NODES_START = 15          # warmup adds one (the add_node drill) -> 16
NODE_CPU_M = 10000
NODE_MEM = 40 * 10 ** 9
BASE_PODS_PER_NODE = 2      # pre-bound pods so remove_pod has targets
CHURN_POD_CPU_M = 250
CHURN_POD_MEM = 5 * 10 ** 8
MAX_DEAD_NODES = 2
MAX_POD_POOL = 6



def _node(name: str) -> dict:
    alloc = {"cpu": f"{NODE_CPU_M}m", "memory": str(NODE_MEM),
             "pods": "500"}
    return {"metadata": {"name": name, "labels": {}},
            "spec": {},
            "status": {"allocatable": alloc, "capacity": dict(alloc)}}


def _pod(name: str, node: str, cpu_m: int = CHURN_POD_CPU_M,
         mem: int = CHURN_POD_MEM) -> dict:
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"nodeName": node,
                     "containers": [{"name": "c0", "resources": {
                         "requests": {"cpu": f"{cpu_m}m",
                                      "memory": str(mem)}}}]}}


def _template(name: str, cpu_m: int, mem: int) -> dict:
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{"name": "c0", "resources": {
                "requests": {"cpu": f"{cpu_m}m", "memory": str(mem)}}}]}}


def build_templates() -> List[dict]:
    # three distinct signature classes + one duplicate (proves coalescing);
    # requested sizes keep each class's capacity mid-bucket (see above)
    small = _template("soak-small", 500, 10 ** 9)
    large = _template("soak-large", 900, 2 * 10 ** 9)
    memory = _template("soak-mem", 750, 3 * 10 ** 9)
    dup = json.loads(json.dumps(small))
    dup["metadata"]["name"] = "soak-small-dup"
    return [small, large, memory, dup]


# -- the harness ------------------------------------------------------------


class Soak:
    def __init__(self, args):
        self.args = args
        self.rng = random.Random(args.seed)
        self.failures: List[str] = []
        self.latencies: List[float] = []
        self.pod_pool: List[Tuple[str, str]] = []   # (pod name, node name)
        self.pod_seq = 0
        self.dead: List[str] = []
        self.expect_applied = 0
        self.expect_quarantined = 0
        self.expect_error_fires = 0
        self.verified = 0
        self.mismatches = 0
        self.thread_base = 0
        self._ref_cache: Dict[str, tuple] = {}   # per-drain offline refs

    def fail(self, msg: str) -> None:
        self.failures.append(msg)
        print(f"soak: INVARIANT VIOLATED: {msg}", file=sys.stderr)

    # -- setup --------------------------------------------------------------

    def build(self) -> None:
        from ..models.snapshot import ClusterSnapshot
        from ..obs import flight, install_recompile_hook
        from ..serve import (BreakerConfig, ServeConfig,
                                                SnapshotStore, Supervisor)
        from ..utils.config import SchedulerProfile

        nodes = [_node(f"soak-node-{i:02d}") for i in range(N_NODES_START)]
        pods = [_pod(f"base-pod-{i:02d}-{j}", n["metadata"]["name"])
                for i, n in enumerate(nodes)
                for j in range(BASE_PODS_PER_NODE)]
        snapshot = ClusterSnapshot.from_objects(nodes, pods)
        self.templates = build_templates()
        self.store = SnapshotStore(snapshot, SchedulerProfile())
        self.config = ServeConfig(
            deadline_s=self.args.deadline,
            breaker=BreakerConfig(threshold=3, window_s=30.0,
                                  cooldown_s=self.args.cooldown),
            device=self.args.device)
        self.sup = Supervisor(self.store, self.config)
        install_recompile_hook()
        flight.install(self.args.flight_dir,
                       argv=["python", "-m", "cluster_capacity_tpu_torch."
                             "serve.soak", f"--seed={self.args.seed}"],
                       max_bundles=100000, capture_ir=False)
        import threading
        self.thread_base = threading.active_count()
        # process-wide counters may have counted before this run (the soak
        # also runs in-process, from the tests): count from here
        from ..obs import names as obs_names
        from ..utils.metrics import default_registry
        self.injected0 = default_registry.counter_total(
            obs_names.FAULTS_INJECTED)
        self.coalesced0 = default_registry.counter_total(
            obs_names.SERVE_COALESCED)

    # -- one serving round --------------------------------------------------

    def drain(self, verify: bool = True, expect_errors: bool = False):
        n_before = len(self.sup._pending)
        for tpl in self.templates:
            self.sup.submit(tpl)
        answers = self.sup.drain()
        self._ref_cache.clear()   # store state is fixed until the next delta
        want = n_before + len(self.templates)
        if len(answers) != want:
            self.fail(f"drain dropped requests: {len(answers)} answers for "
                      f"{want} submissions")
        for i, a in enumerate(answers):
            if a.error is not None:
                if not expect_errors:
                    self.fail(f"unexpected error answer: {a.error}")
                continue
            self.latencies.append(a.latency_s)
            if verify:
                self.verify_answer(a, i)
        return answers

    def verify_answer(self, answer, index: int) -> None:
        """Invariant 1: the served answer must be bit-identical to a fresh
        offline solve of the same encoded problem (the store's shared
        encode — the daemon and the reference must see the same IPA
        vocabulary) on the same rung.  Group-served answers are checked
        against one offline ``solve_group`` over the drain's signature
        classes (mirroring the supervisor's coalescing); per-item rungs are
        checked against their own kernel.  Cross-rung equality is the
        parity suites' contract on tie-free fixtures — on this homogeneous
        fleet, near-tie states may legally order two equal nodes
        differently across kernels."""
        from ..engine import fast_path
        from ..parallel import sweep as sweep_mod
        from ..runtime import degrade, faults

        rung = answer.rung
        tpl = answer.request.template["metadata"]["name"]
        with faults.suspended():
            pbs = self.store.problems(self.templates)
            pb = pbs[index]
            if rung == degrade.RUNG_BATCHED:
                refs = self._ref_cache.get("group")
                if refs is None:
                    cache: dict = {}
                    sigs = [sweep_mod._solve_signature(p, cache)
                            for p in pbs]
                    class_of: Dict[bytes, int] = {}
                    order = []
                    for s, p in zip(sigs, pbs):
                        if s not in class_of:
                            class_of[s] = len(order)
                            order.append(p)
                    refs = (sigs, class_of, sweep_mod.solve_group(
                        order, device=self.args.device))
                    self._ref_cache["group"] = refs
                sigs, class_of, group = refs
                ref = group[class_of[sigs[index]]]
            elif rung == degrade.RUNG_FUSED:
                ref = fast_path.solve_auto(pb, device=self.args.device)
            elif rung == degrade.RUNG_FAST_PATH:
                ref = fast_path.solve_fast(pb, device=self.args.device)
            else:
                ref = degrade._solve_oracle(pb)
        got = answer.result
        if ref is None:
            # solve_fast returned None offline but the daemon served on the
            # fast_path rung — the eligibility decision itself diverged
            self.mismatches += 1
            self.fail(f"bit-identity: offline {rung} reference ineligible "
                      f"but the daemon served on it (template={tpl})")
            return
        if got.placed_count != ref.placed_count:
            self.mismatches += 1
            self.fail(
                f"bit-identity: served placed_count {got.placed_count} != "
                f"offline {ref.placed_count} (rung={rung}, "
                f"degraded={answer.degraded}, template={tpl})")
        elif not np.array_equal(np.asarray(got.placements),
                                np.asarray(ref.placements)):
            self.mismatches += 1
            self.fail(
                f"bit-identity: placement vector diverged on rung "
                f"{rung} (template={tpl})")
        self.verified += 1

    # -- churn --------------------------------------------------------------

    def node_names(self) -> List[str]:
        return list(self.store.snapshot.node_names)

    def apply(self, delta: dict, expect_ok: bool) -> None:
        ok = self.sup.apply_delta(delta)
        if ok:
            self.expect_applied += 1
        else:
            self.expect_quarantined += 1
        if ok != expect_ok:
            self.fail(f"delta {delta.get('op')!r} expected "
                      f"{'applied' if expect_ok else 'quarantined'}, got "
                      f"{'applied' if ok else 'quarantined'}")

    def churn_step(self, i: int) -> None:
        rng = self.rng
        if i % 7 == 3:
            # malformed deltas, rotated: the store must quarantine and the
            # loop must not care
            bad_pod = _pod("bad-pod", self.node_names()[0])
            bad_pod["spec"]["containers"][0]["resources"]["requests"][
                "cpu"] = "not-a-cpu"
            bad = [{"op": "remove_node", "node": "ghost-node"},
                   {"op": "add_pod", "pod": bad_pod},
                   {"op": "defragment_node", "node": self.node_names()[0]},
                   ][i % 3]
            self.apply(bad, expect_ok=False)
            return
        alive = [n for n in self.node_names() if n not in self.dead]
        choices = ["add_pod"]
        if self.pod_pool:
            choices.append("remove_pod")
        if len(self.dead) < MAX_DEAD_NODES and len(alive) > 2:
            choices.append("remove_node")
        if self.dead:
            choices += ["restore_node", "restore_node"]
        op = rng.choice(choices)
        if op == "add_pod" and len(self.pod_pool) >= MAX_POD_POOL:
            op = "remove_pod"
        if op == "add_pod":
            self.pod_seq += 1
            name = f"churn-pod-{self.pod_seq:04d}"
            node = rng.choice(self.node_names())
            self.apply({"op": "add_pod", "pod": _pod(name, node)},
                       expect_ok=True)
            self.pod_pool.append((name, node))
        elif op == "remove_pod":
            name, _node_name = self.pod_pool.pop(
                rng.randrange(len(self.pod_pool)))
            self.apply({"op": "remove_pod", "namespace": "default",
                        "name": name}, expect_ok=True)
        elif op == "remove_node":
            node = rng.choice(alive)
            self.apply({"op": "remove_node", "node": node}, expect_ok=True)
            self.dead.append(node)
        else:
            node = self.dead.pop(rng.randrange(len(self.dead)))
            self.apply({"op": "restore_node", "node": node}, expect_ok=True)

    # -- phases -------------------------------------------------------------

    def settle_breakers(self, label: str, timeout_s: float = 60.0) -> None:
        """Serve healthily until every breaker has closed (half-open probes
        need live traffic to fire)."""
        from ..runtime import faults
        faults.clear()
        t0 = time.monotonic()
        while not self.sup.board.all_closed():
            if time.monotonic() - t0 > timeout_s:
                self.fail(f"{label}: breakers failed to close within "
                          f"{timeout_s:g}s: {self.sup.board.open_breakers()}")
                return
            self.drain(verify=True)
            time.sleep(self.args.cooldown / 4)

    def warmup(self) -> None:
        """Visit every rung, every delta class, and both alive-mask states
        so the steady phase measures a fully traced program."""
        from ..runtime import faults
        from ..runtime.faults import (
            KIND_CORRUPT, KIND_ERROR, KIND_HANG, KIND_OOM, FaultSpec,
            SITE_FAST_PATH, SITE_GROUP, SITE_SOLVE)

        log = print if self.args.verbose else (lambda *a, **k: None)
        faults.clear()
        self.drain()                                     # group/batched rung
        log("soak: warmup: healthy group solve OK")

        # delta classes: mask off/on, incremental pod churn, axis growth
        names = self.node_names()
        self.apply({"op": "remove_node", "node": names[1]}, expect_ok=True)
        self.drain()                                     # masked encode
        self.apply({"op": "restore_node", "node": names[1]}, expect_ok=True)
        self.drain()
        self.apply({"op": "add_pod",
                    "pod": _pod("warm-pod-0001", names[2])}, expect_ok=True)
        self.drain()
        self.apply({"op": "remove_pod", "namespace": "default",
                    "name": "warm-pod-0001"}, expect_ok=True)
        self.drain()
        self.apply({"op": "remove_pods_on", "node": names[3]},
                   expect_ok=True)
        self.drain()
        self.apply({"op": "add_node",
                    "node": _node(f"soak-node-{N_NODES_START:02d}")},
                   expect_ok=True)
        self.drain()            # node axis grew: the one allowed recompile
        log("soak: warmup: all delta classes applied "
            f"(full_rebuilds={self.store.full_rebuilds})")

        # transient faults the retry policy absorbs (same rung, no descent)
        faults.clear()
        faults.install([FaultSpec(SITE_GROUP, KIND_OOM, at=1, times=1)])
        self.drain()
        faults.clear()
        faults.install([FaultSpec(SITE_GROUP, KIND_HANG, at=1, times=1)])
        self.drain()

        # full-ladder burst: group, fused and fast_path all dead -> per-item
        # descent to the oracle; opens all three breakers (they close in the
        # settle pass, which also warms the half-open probe path)
        faults.clear()
        faults.install([FaultSpec(SITE_GROUP, KIND_OOM, at=1, times=0),
                        FaultSpec(SITE_SOLVE, KIND_OOM, at=1, times=0),
                        FaultSpec(SITE_FAST_PATH, KIND_CORRUPT, at=1,
                                  times=0)])
        self.drain()
        log("soak: warmup: full-ladder descent exercised "
            f"(open={self.sup.board.open_breakers()})")

        # unclassified device error: crash-restart drill (error answers,
        # worker state dropped, next drain healthy on warm caches)
        faults.clear()
        faults.install([FaultSpec(SITE_GROUP, KIND_ERROR, at=1, times=1)])
        self.expect_error_fires += 1
        restarts_before = self.sup.restarts
        self.drain(expect_errors=True)
        if self.sup.restarts != restarts_before + 1:
            self.fail("error-kind injection did not crash-restart the "
                      "worker")
        self.settle_breakers("warmup")
        log("soak: warmup: crash-restart drill OK, breakers settled")

    def steady(self) -> Dict[str, float]:
        """The measured region: randomized faults + churn, zero recompiles
        allowed, every answer verified."""
        from ..obs import names as obs_names
        from ..runtime import faults
        from ..runtime.faults import (
            KIND_CORRUPT, KIND_HANG, KIND_OOM, FaultSpec, SITE_GROUP,
            SITE_SOLVE)
        from ..utils.metrics import default_registry

        iters = self.args.steady
        burst = min(4, max(2, iters // 6))   # scripted breaker-burst start
        kinds = (KIND_OOM, KIND_HANG, KIND_CORRUPT)
        recompiles0 = default_registry.counter_total(obs_names.RECOMPILES)
        # recovery latencies are asserted over the measured region only:
        # warmup recoveries are stretched by the harness's own offline
        # oracle verification (a ~20s host solve pause means no traffic,
        # so no probes), which is harness wall time, not daemon latency
        rec0 = {b.site: len(b.recovery_latencies)
                for b in self.sup.board.breakers()}
        self.latencies = []
        answers0 = self.sup.answers
        t0 = time.monotonic()
        for i in range(iters):
            faults.clear()
            if burst <= i < burst + 3:
                # sustained group-site failure: opens the batched-rung
                # breaker, pinning the next drains to the per-item ladder
                faults.install([FaultSpec(SITE_GROUP, KIND_OOM, at=1,
                                          times=0)])
            if burst + 1 <= i < burst + 4:
                # cascading second burst while the group rung is pinned:
                # the per-item fused rung faults too -> fast_path serves
                faults.install([FaultSpec(SITE_SOLVE, KIND_OOM, at=1,
                                          times=0)])
            if i >= burst + 4 and self.rng.random() < 0.2:
                # background noise: a single transient fault the retry
                # policy (times=1) or one ladder descent (times=2) absorbs
                faults.install([FaultSpec(
                    SITE_GROUP, self.rng.choice(kinds), at=1,
                    times=self.rng.choice((1, 2)))])
            self.churn_step(i)
            self.drain(verify=True)
            if self.args.verbose and (i + 1) % 10 == 0:
                print(f"soak: steady {i + 1}/{iters} "
                      f"(open={self.sup.board.open_breakers()}, "
                      f"deltas={self.store.applied}"
                      f"+{self.store.quarantined}q)")
        self.settle_breakers("steady tail")
        wall = time.monotonic() - t0
        recompiles = (default_registry.counter_total(obs_names.RECOMPILES)
                      - recompiles0)
        served = self.sup.answers - answers0
        recoveries = [lat for b in self.sup.board.breakers()
                      for lat in b.recovery_latencies[rec0.get(b.site, 0):]]
        return {"wall_s": wall, "answers": served,
                "steady_recompiles": recompiles,
                "recoveries": recoveries}

    # -- final invariants ---------------------------------------------------

    def check_final(self, steady: Dict[str, float]) -> None:
        import threading

        from ..engine import encode as enc
        from ..obs import flight
        from ..obs import names as obs_names
        from ..obs.spans import MAX_SPANS, \
            default_collector
        from ..runtime import guard
        from ..utils.metrics import default_registry

        # 2: compile cost is a warmup-only resource
        if steady["steady_recompiles"] > 0:
            self.fail(f"{int(steady['steady_recompiles'])} recompile(s) in "
                      f"the steady region — churn moved a tensor shape or "
                      f"the chunk quantization regressed")

        # 3: breakers opened under the scripted bursts and all recovered
        opened = self.sup.board.opened_total()
        if opened < 2:
            self.fail(f"scripted bursts opened only {opened} breaker(s); "
                      f"expected the group burst and the fused cascade")
        if not self.sup.board.all_closed():
            self.fail(f"breakers still open at end of run: "
                      f"{self.sup.board.open_breakers()}")
        recov = sorted(steady["recoveries"])
        slack = 5.0 * self.args.cooldown + 2.0
        if recov and recov[-1] > self.args.cooldown + slack:
            self.fail(f"breaker recovery took {recov[-1]:.2f}s; pinned "
                      f"cooldown {self.args.cooldown:g}s + slack "
                      f"{slack:g}s")
        if opened and not self.sup.board.recovery_latencies():
            self.fail("breakers opened but recorded no recovery latency")

        # 4: one flight bundle per classified injected fault
        injected = default_registry.counter_total(
            obs_names.FAULTS_INJECTED) - self.injected0
        classified = int(injected) - self.expect_error_fires
        bundles = len(flight.bundle_paths())
        if bundles != classified:
            self.fail(f"flight bundles {bundles} != classified injected "
                      f"faults {classified} (total injected {int(injected)},"
                      f" unclassified {self.expect_error_fires})")

        # 5: bounded growth
        wt = guard.watchdog_threads()
        if wt > guard._MAX_IDLE_WATCHDOGS + 1:
            self.fail(f"watchdog threads accumulated: {wt} alive "
                      f"(pool cap {guard._MAX_IDLE_WATCHDOGS})")
        threads = threading.active_count()
        if threads > self.thread_base + guard._MAX_IDLE_WATCHDOGS + 2:
            self.fail(f"thread count grew {self.thread_base} -> {threads}")
        if len(default_collector.spans()) > MAX_SPANS:
            self.fail("span ring exceeded MAX_SPANS")
        memo = getattr(self.store.snapshot, "_memo", {}) or {}
        shared = memo.get(("encode_problems_shared",))
        if shared is not None and len(shared) > enc._SHARED_MEMO_CAP:
            self.fail(f"shared-encode memo grew past its cap: "
                      f"{len(shared)} > {enc._SHARED_MEMO_CAP}")

        # bookkeeping exactness: the store agrees with the script
        if self.store.applied != self.expect_applied:
            self.fail(f"applied deltas {self.store.applied} != scripted "
                      f"{self.expect_applied}")
        if self.store.quarantined != self.expect_quarantined:
            self.fail(f"quarantined deltas {self.store.quarantined} != "
                      f"scripted {self.expect_quarantined}")
        if self.expect_quarantined == 0:
            self.fail("churn script produced no quarantined deltas — the "
                      "validation path went unexercised")

    # -- artifact -----------------------------------------------------------

    def artifact(self, steady: Dict[str, float]) -> Dict[str, object]:
        import torch

        from ..obs import flight
        from ..obs import names as obs_names
        from ..utils.metrics import default_registry

        lat = sorted(self.latencies)

        def pct(p: float) -> float:
            return lat[min(len(lat) - 1, int(p * (len(lat) - 1)))] if lat \
                else 0.0

        recov = sorted(steady["recoveries"])   # measured region only
        qps = (steady["answers"] / steady["wall_s"]
               if steady["wall_s"] > 0 else 0.0)
        return {
            "soak": 1,
            "ok": not self.failures,
            "platform": self.args.device,
            "device": (torch.cuda.get_device_name(0)
                       if self.args.device == "cuda" else "cpu"),
            "mode": "smoke" if self.args.smoke else "full",
            "seed": self.args.seed,
            "steady_iterations": self.args.steady,
            "nodes": len(self.node_names()),
            "soak_queries_per_sec": round(qps, 2),
            "soak_answers": int(self.sup.answers),
            "soak_p50_latency_ms": round(pct(0.50) * 1e3, 3),
            "soak_p99_latency_ms": round(pct(0.99) * 1e3, 3),
            "soak_max_latency_ms": round((lat[-1] if lat else 0.0) * 1e3, 3),
            "soak_verified_answers": self.verified,
            "soak_bit_mismatches": self.mismatches,
            "soak_steady_recompiles": int(steady["steady_recompiles"]),
            "soak_faults_injected": int(default_registry.counter_total(
                obs_names.FAULTS_INJECTED) - self.injected0),
            "soak_flight_bundles": len(flight.bundle_paths()),
            "soak_breakers_opened": int(self.sup.board.opened_total()),
            "soak_breaker_recovery_p99_s": round(
                recov[min(len(recov) - 1, int(0.99 * (len(recov) - 1)))]
                if recov else 0.0, 3),
            "soak_breaker_recovery_max_s": round(recov[-1], 3) if recov
            else 0.0,
            "soak_deltas_applied": int(self.store.applied),
            "soak_deltas_quarantined": int(self.store.quarantined),
            "soak_full_rebuilds": int(self.store.full_rebuilds),
            "soak_coalesced": int(default_registry.counter_total(
                obs_names.SERVE_COALESCED) - self.coalesced0),
            "soak_worker_restarts": int(self.sup.restarts),
            "soak_degraded_answers": int(self.sup.degraded_answers),
            "soak_error_answers": int(self.sup.error_answers),
            "failures": list(self.failures),
        }

    # -- driver -------------------------------------------------------------

    def run(self) -> int:
        t_all = time.monotonic()
        self.build()
        print(f"soak: {self.args.steady} steady iteration(s), seed "
              f"{self.args.seed}, cooldown {self.args.cooldown:g}s, "
              f"flight dir {self.args.flight_dir}")
        self.warmup()
        print(f"soak: warmup complete ({self.sup.answers} answers, "
              f"{self.store.full_rebuilds} full rebuild(s)); entering "
              f"steady phase")
        steady = self.steady()
        self.check_final(steady)
        doc = self.artifact(steady)
        os.makedirs(os.path.dirname(os.path.abspath(self.args.out)),
                    exist_ok=True)
        with open(self.args.out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2)
            fh.write("\n")
        wall = time.monotonic() - t_all
        print(f"soak: {doc['soak_answers']} answers "
              f"({doc['soak_queries_per_sec']} q/s steady, p99 "
              f"{doc['soak_p99_latency_ms']}ms), "
              f"{doc['soak_faults_injected']} fault(s) injected, "
              f"{doc['soak_flight_bundles']} flight bundle(s), "
              f"{doc['soak_breakers_opened']} breaker open(s) "
              f"(recovery max {doc['soak_breaker_recovery_max_s']}s), "
              f"{doc['soak_deltas_applied']} delta(s) applied + "
              f"{doc['soak_deltas_quarantined']} quarantined, "
              f"{doc['soak_steady_recompiles']} steady recompile(s) "
              f"[{wall:.1f}s wall]")
        print(f"soak: wrote {os.path.relpath(self.args.out, ROOT)}")
        if self.failures:
            print(f"soak: FAIL — {len(self.failures)} invariant "
                  f"violation(s)", file=sys.stderr)
            return 1
        print("soak: OK — every invariant held")
        return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cluster_capacity_tpu_torch.serve.soak",
        description="Chaos soak harness for the capacity daemon.")
    ap.add_argument("--smoke", action="store_true",
                    help="short run: the same phases, fewer steady "
                         "iterations")
    ap.add_argument("--steady", type=int, default=0,
                    help="steady-phase iterations (default: 24 smoke, "
                         "120 full)")
    ap.add_argument("--seed", type=int, default=20260805)
    ap.add_argument("--cooldown", type=float, default=0.75,
                    help="breaker cooldown (the recovery assertion pins "
                         "against this)")
    ap.add_argument("--deadline", type=float, default=10.0,
                    help="per-request guard deadline (exercises the pooled "
                         "watchdog on every call)")
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "build", "soak_torch.json"),
                    help="artifact path (default build/soak_torch.json)")
    ap.add_argument("--device", default="cuda",
                    help="Device to run on: cuda (default) or cpu.")
    ap.add_argument("--flight-dir", default="",
                    help="flight recorder dir (default: a temp dir)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.steady <= 0:
        args.steady = 24 if args.smoke else 120
    if not args.flight_dir:
        args.flight_dir = tempfile.mkdtemp(prefix="cc-soak-flight-")
    from ..obs import flight
    try:
        return Soak(args).run()
    finally:
        # the recorder is process-wide: disarm it for an in-process caller
        flight.uninstall()


if __name__ == "__main__":
    sys.exit(main())
