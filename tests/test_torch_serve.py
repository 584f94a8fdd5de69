"""The port's capacity daemon (serve/: breakers, the snapshot store, the
supervisor, `hypercc serve`, the soak) on the CPU against the JAX
package's.

Every test of tests/test_serve.py runs twice, once over each package, as
one scenario function handed a namespace of that package's modules (`Pkg`).
The scenario makes tests/test_serve.py's assertions and returns a record of
what it saw — every answer's result fields, rung, degraded flag, error and
coalescing count, the breaker states — and the two records must be equal.
Tolerance: exact, except the text of an `error`-kind fault's answer, whose
device wording differs on purpose (ROADMAP queue 3).  The sharded-breaker
drill runs over a 1x1 mesh in both packages.
"""

import json
import os
import threading
import types

import numpy as np
import pytest

from helpers import build_test_node, build_test_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "examples", "cluster-snapshot.yaml")
PODSPEC = os.path.join(REPO, "examples", "pod.yaml")


def _load(pkg: str) -> types.SimpleNamespace:
    """One package's serving modules, with its device settings."""
    import importlib
    root = {"jax": "cluster_capacity_tpu",
            "torch": "cluster_capacity_tpu_torch"}[pkg]
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    ns = types.SimpleNamespace(
        name=pkg,
        SchedulerProfile=mod("utils.config").SchedulerProfile,
        fast_path=mod("engine.fast_path"),
        default_pod=mod("models.podspec").default_pod,
        ClusterSnapshot=mod("models.snapshot").ClusterSnapshot,
        flight=mod("obs.flight"), names=mod("obs.names"),
        degrade=mod("runtime.degrade"), faults=mod("runtime.faults"),
        guard=mod("runtime.guard"),
        DeviceOOM=mod("runtime.errors").DeviceOOM,
        serve=mod("serve"), breaker=mod("serve.breaker"),
        sweep=mod("parallel.sweep"), mesh=mod("parallel.mesh"),
        registry=mod("utils.metrics").default_registry,
        serve_cli=mod("cli.serve"), hypercc=mod("cli.hypercc"),
        device={} if pkg == "jax" else {"device": "cpu"},
        cli_device=[] if pkg == "jax" else ["--device", "cpu"])
    return ns


PKGS = {name: _load(name) for name in ("jax", "torch")}


@pytest.fixture(autouse=True)
def _clean_faults():
    for p in PKGS.values():
        p.faults.clear()
    yield
    for p in PKGS.values():
        p.faults.clear()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _template(p, name="tpl", cpu=500, mem=10 ** 9):
    return p.default_pod(build_test_pod(name, cpu, mem))


def _nodes(n_nodes):
    # heterogeneous allocatable (no two nodes tie), so every rung breaks
    # placement ties identically and cross-rung comparisons are bit-exact
    return [build_test_node(f"srv-{i}", 2000 + 317 * i,
                            (4 + i) * 1024 ** 3, 32)
            for i in range(n_nodes)]


def _store(p, n_nodes=5, pods_per_node=0):
    pods = [build_test_pod(f"base-{i}-{j}", 100, 10 ** 8,
                           node_name=f"srv-{i}")
            for i in range(n_nodes) for j in range(pods_per_node)]
    return p.serve.SnapshotStore(
        p.ClusterSnapshot.from_objects(_nodes(n_nodes), pods),
        p.SchedulerProfile())


def _sup(p, store=None, clock=None, threshold=3, cooldown=5.0, **cfg):
    config = p.serve.ServeConfig(
        breaker=p.serve.BreakerConfig(threshold=threshold, window_s=60.0,
                                      cooldown_s=cooldown),
        **({"clock": clock} if clock is not None else {}),
        **p.device, **cfg)
    return p.serve.Supervisor(store or _store(p), config)


def _solve_auto(p, pb, **kw):
    return p.fast_path.solve_auto(pb, **kw, **p.device)


def _same(a, b):
    assert a.placed_count == b.placed_count
    assert np.array_equal(np.asarray(a.placements), np.asarray(b.placements))
    assert a.fail_type == b.fail_type


def _result(r):
    if r is None:
        return None
    return (list(r.placements), r.placed_count, r.fail_type, r.fail_message,
            dict(r.fail_counts), r.rung, r.degraded)


def _answer(a):
    """An Answer as plain values; an error answer keeps its fault class
    only (the device wording of oom/error faults differs by design)."""
    err = None if a.error is None else a.error.split(":", 1)[0]
    return (a.request.id, _result(a.result), err, a.rung, a.degraded,
            a.coalesced)


def _states(sup):
    return sorted((site, rung, state)
                  for (site, rung), state in sup.board.states().items())


def both(scenario):
    """Run `scenario(pkg)` over each package; their records must match."""
    records = {name: scenario(p) for name, p in PKGS.items()}
    assert records["torch"] == records["jax"]
    return records["torch"]


# --- breaker unit lifecycle (fake clock) ------------------------------------

def _breaker(p, threshold=3, window=60.0, cooldown=5.0):
    clock = FakeClock()
    cfg = p.serve.BreakerConfig(threshold=threshold, window_s=window,
                                cooldown_s=cooldown)
    return p.serve.Breaker("engine.solve", "fused", cfg, clock=clock), clock


def test_breaker_opens_at_threshold_within_window():
    def scenario(p):
        br, clock = _breaker(p, threshold=3, window=10.0)
        trace = []
        for _ in range(2):
            br.record_fault(p.DeviceOOM("x"))
        trace.append(br.state)
        clock.advance(11.0)          # the first two faults age out
        br.record_fault(p.DeviceOOM("x"))
        trace.append(br.state)
        br.record_fault(p.DeviceOOM("x"))
        br.record_fault(p.DeviceOOM("x"))
        trace.append(br.state)
        assert trace == [p.serve.STATE_CLOSED, p.serve.STATE_CLOSED,
                         p.serve.STATE_OPEN]
        assert br.opened_count == 1
        return trace
    both(scenario)


def test_breaker_halfopen_probe_closes_and_records_recovery():
    def scenario(p):
        br, clock = _breaker(p, threshold=1, cooldown=5.0)
        br.record_fault(p.DeviceOOM("x"))
        trace = [br.state, br.allow()]
        clock.advance(5.0)
        trace += [br.allow(), br.state, br.allow()]
        clock.advance(1.0)
        br.record_success()
        trace.append(br.state)
        assert br.recovery_latencies == [6.0]
        br.record_fault(p.DeviceOOM("x"))
        trace += [br.state, br.opened_count]
        assert trace == ["open", False, True, "half_open", False, "closed",
                         "open", 2]
        return trace
    both(scenario)


def test_breaker_probe_fault_reopens_and_restarts_cooldown():
    def scenario(p):
        br, clock = _breaker(p, threshold=1, cooldown=5.0)
        br.record_fault(p.DeviceOOM("x"))
        clock.advance(5.0)
        trace = [br.allow()]
        br.record_fault(p.DeviceOOM("probe died"))
        trace.append(br.state)
        clock.advance(4.9)
        trace.append(br.allow())             # cooldown restarted
        clock.advance(0.2)
        trace.append(br.allow())
        br.record_success()
        trace.append(br.state)
        assert trace == [True, "open", False, True, "closed"]
        return trace
    both(scenario)


def test_breaker_abort_releases_probe_slot():
    def scenario(p):
        br, clock = _breaker(p, threshold=1, cooldown=5.0)
        br.record_fault(p.DeviceOOM("x"))
        clock.advance(5.0)
        trace = [br.allow()]
        br.record_abort()
        trace.append(br.state)
        clock.advance(5.0)
        trace.append(br.allow())             # NOT wedged: probe slot free
        br.record_success()
        br.record_abort()                    # abort while closed: no-op
        trace.append(br.state)
        assert trace == [True, "open", True, "closed"]
        return trace
    both(scenario)


def test_breaker_faults_while_open_do_not_rearm():
    def scenario(p):
        br, clock = _breaker(p, threshold=1, cooldown=5.0)
        br.record_fault(p.DeviceOOM("x"))
        clock.advance(4.0)
        br.record_fault(p.DeviceOOM("y"))    # final-rung traffic fault
        clock.advance(1.0)
        assert br.allow()                    # original cooldown, not reset
        return br.state
    both(scenario)


def test_breaker_board_last_rung_always_admitted():
    def scenario(p):
        board = p.serve.BreakerBoard(p.serve.BreakerConfig(threshold=1),
                                     clock=FakeClock())
        br = board.breaker("oracle")
        br.record_fault(p.DeviceOOM("x"))
        out = (br.state, board.allow_rung("oracle", is_last=True),
               board.allow_rung("oracle"))
        assert out == ("open", True, False)
        return out
    both(scenario)


def test_breaker_config_validates():
    def scenario(p):
        msgs = []
        for kw in ({"threshold": 0}, {"window_s": 0.0},
                   {"cooldown_s": -1.0}):
            with pytest.raises(ValueError) as ei:
                p.serve.BreakerConfig(**kw)
            msgs.append(str(ei.value))
        return msgs
    both(scenario)


# --- supervised serving ------------------------------------------------------

def test_serve_healthy_answer_matches_engine():
    def scenario(p):
        sup = _sup(p)
        ans = sup.serve(_template(p))
        assert ans.ok and ans.error is None and not ans.degraded
        assert ans.rung == p.degrade.RUNG_FUSED
        with p.faults.suspended():
            ref = _solve_auto(p, sup.store.problems([_template(p)])[0])
        _same(ans.result, ref)
        return _answer(ans)
    both(scenario)


def test_coalescing_shares_one_solve():
    def scenario(p):
        sup = _sup(p)
        t = _template(p, "dup")
        before = p.registry.counter_total(p.names.SERVE_COALESCED)
        for _ in range(3):
            sup.submit(t)
        sup.submit(_template(p, "other", cpu=900))
        answers = sup.drain()
        assert len(answers) == 4
        assert all(a.error is None for a in answers)
        dups = [a for a in answers if a.request.template is t]
        assert all(a.coalesced == 3 for a in dups)
        _same(dups[0].result, dups[1].result)
        after = p.registry.counter_total(p.names.SERVE_COALESCED)
        assert after - before == 2               # 3 requests -> 1 solve
        return [_answer(a) for a in answers]
    both(scenario)


def test_breaker_open_pins_rung_bit_identical():
    def scenario(p):
        clock = FakeClock()
        sup = _sup(p, clock=clock, threshold=1, cooldown=1000.0)
        tpl = _template(p)
        with p.faults.suspended():
            ref = _solve_auto(p, sup.store.problems([tpl])[0])
        with p.faults.inject("engine.solve:oom:1:0"):
            a1 = sup.serve(tpl)
        assert a1.degraded and a1.rung == p.degrade.RUNG_FAST_PATH
        assert sup.board.breaker(p.degrade.RUNG_FUSED).state == "open"
        a2 = sup.serve(tpl)
        assert a2.degraded and a2.rung == p.degrade.RUNG_FAST_PATH
        for a in (a1, a2):
            _same(a.result, ref)
        return [_answer(a1), _answer(a2), _states(sup)]
    both(scenario)


def test_halfopen_probe_closes_via_organic_traffic():
    def scenario(p):
        clock = FakeClock()
        sup = _sup(p, clock=clock, threshold=1, cooldown=5.0)
        tpl = _template(p)
        with p.faults.inject("engine.solve:oom:1:0"):
            a1 = sup.serve(tpl)
        br = sup.board.breaker(p.degrade.RUNG_FUSED)
        assert br.state == "open"
        clock.advance(6.0)
        ans = sup.serve(tpl)                     # the half-open probe
        assert br.state == "closed"
        assert ans.rung == p.degrade.RUNG_FUSED and not ans.degraded
        assert br.recovery_latencies and br.recovery_latencies[0] >= 5.0
        return [_answer(a1), _answer(ans), br.recovery_latencies]
    both(scenario)


def test_canary_probe_recovers_buried_rung():
    def scenario(p):
        clock = FakeClock()
        sup = _sup(p, clock=clock, threshold=1, cooldown=5.0)
        tpl = _template(p)
        f = p.faults
        f.install([f.FaultSpec(f.SITE_SOLVE, f.KIND_OOM, at=1, times=0),
                   f.FaultSpec(f.SITE_FAST_PATH, f.KIND_CORRUPT, at=1,
                               times=0)])
        a1 = sup.serve(tpl)
        assert a1.rung == p.degrade.RUNG_ORACLE and a1.degraded
        states = _states(sup)
        f.clear()
        clock.advance(6.0)
        a2 = sup.serve(tpl)
        assert a2.rung == p.degrade.RUNG_FUSED and not a2.degraded
        assert sup.board.all_closed()
        return [_answer(a1), states, _answer(a2), _states(sup)]
    rec = both(scenario)
    assert {rung: state for _site, rung, state in rec[1]} == {
        "fused": "open", "fast_path": "open", "oracle": "closed"}


def test_group_fallback_isolates_poisoned_request():
    def scenario(p):
        sup = _sup(p, threshold=100)
        t1, t2 = _template(p, "a"), _template(p, "b", cpu=900)
        with p.faults.suspended():
            ref = _solve_auto(p, sup.store.problems([t2])[0])
        f = p.faults
        f.install([f.FaultSpec(site, f.KIND_CORRUPT, at=1, times=1)
                   for site in (f.SITE_GROUP, f.SITE_SOLVE,
                                f.SITE_FAST_PATH, f.SITE_ORACLE)])
        sup.submit(t1)
        sup.submit(t2)
        answers = sup.drain()
        f.clear()
        a1, a2 = answers
        assert a1.error is not None and "NumericCorruption" in a1.error
        assert a2.error is None and a2.degraded
        _same(a2.result, ref)
        return [_answer(a) for a in answers] + [a1.error]
    both(scenario)


def test_retry_stops_when_fault_opens_breaker():
    def scenario(p):
        sleeps = []
        sup = _sup(p, threshold=1, cooldown=1000.0, backoff_s=0.01,
                   sleep=sleeps.append)
        with p.faults.inject("engine.solve:hang:1:0"):
            ans = sup.serve(_template(p))
        assert ans.error is None and ans.degraded
        assert ans.rung == p.degrade.RUNG_FAST_PATH
        assert sup.board.breaker(p.degrade.RUNG_FUSED).state == "open"
        assert sleeps == []
        return _answer(ans)
    both(scenario)


def test_canary_probe_replays_max_limit(monkeypatch):
    def scenario(p):
        clock = FakeClock()
        sup = _sup(p, clock=clock, threshold=1, cooldown=5.0)
        tpl = _template(p)
        f = p.faults
        f.install([f.FaultSpec(f.SITE_SOLVE, f.KIND_OOM, at=1, times=0),
                   f.FaultSpec(f.SITE_FAST_PATH, f.KIND_CORRUPT, at=1,
                               times=0)])
        a1 = sup.serve(tpl, max_limit=3)
        assert a1.rung == p.degrade.RUNG_ORACLE and a1.degraded
        f.clear()
        clock.advance(6.0)
        seen = []
        orig = p.fast_path.solve_fast

        def spy(pb, max_limit=0, **kw):
            seen.append(max_limit)
            return orig(pb, max_limit=max_limit, **kw)

        monkeypatch.setattr(p.fast_path, "solve_fast", spy)
        a2 = sup.serve(tpl, max_limit=3)
        monkeypatch.undo()
        assert a2.rung == p.degrade.RUNG_FUSED and not a2.degraded
        assert sup.board.all_closed()
        assert seen and all(ml == 3 for ml in seen)
        return [_answer(a1), _answer(a2), seen]
    both(scenario)


def test_unclassified_probe_error_does_not_wedge_breaker():
    def scenario(p):
        clock = FakeClock()
        sup = _sup(p, clock=clock, threshold=1, cooldown=5.0)
        t1, t2 = _template(p, "a"), _template(p, "b", cpu=900)
        rec = []
        with p.faults.inject("parallel.solve_group:oom:1:0"):
            sup.submit(t1)
            sup.submit(t2)
            answers = sup.drain()
        assert len(answers) == 2 and all(a.error is None for a in answers)
        rec.append([_answer(a) for a in answers])
        gbr = sup.board.breaker(p.degrade.RUNG_BATCHED)
        assert gbr.state == "open"
        clock.advance(6.0)
        restarts = sup.restarts
        with p.faults.inject("parallel.solve_group:error:1:1"):
            sup.submit(t1)
            sup.submit(t2)
            answers = sup.drain()
        assert len(answers) == 2
        assert all(a.error is not None for a in answers)
        assert sup.restarts == restarts + 1
        assert gbr.state == "open" and not gbr._probe_in_flight
        rec.append([_answer(a) for a in answers])
        clock.advance(6.0)
        sup.submit(t1)
        sup.submit(t2)
        answers = sup.drain()
        assert all(a.error is None for a in answers)
        assert gbr.state == "closed"
        rec.append([_answer(a) for a in answers])
        return rec
    both(scenario)


def test_sharded_breaker_falls_back_without_dropped_request(capsys):
    """tests/test_serve.py's drill over a 1x1 mesh: a parallel.sharded
    fault opens the sharded breaker, the group is answered by the unsharded
    batched rung (degraded, the same answers, no request dropped), and
    after the cooldown the sharded rung serves again; `serve --mesh 1x1`
    and `hypercc serve --mesh auto` run.  Answer for answer equal to the
    JAX package."""
    def scenario(p):
        clock = FakeClock()
        store = _store(p)
        mesh = p.mesh.make_mesh(n_node_shards=1, n_batch_shards=1,
                                **p.device)
        config = p.serve.ServeConfig(
            breaker=p.serve.BreakerConfig(threshold=1, window_s=60.0,
                                          cooldown_s=5.0),
            clock=clock, **p.device)
        sup = p.serve.Supervisor(store, config, mesh=mesh)
        t1, t2 = _template(p, "a"), _template(p, "b", cpu=900)
        with p.faults.suspended():
            refs = p.sweep.solve_group(store.problems([t1, t2]),
                                       **p.device)
        with p.faults.inject("parallel.sharded:oom:1:0"):
            sup.submit(t1)
            sup.submit(t2)
            answers = sup.drain()
        assert len(answers) == 2
        assert all(a.error is None and a.degraded for a in answers)
        assert {a.rung for a in answers} == {p.degrade.RUNG_BATCHED}
        assert sup.board.breaker(p.degrade.RUNG_SHARDED).state == "open"
        for a, ref in zip(answers, refs):
            _same(a.result, ref)
        p.faults.clear()
        clock.advance(6.0)
        sup.submit(t1)
        sup.submit(t2)
        healed = sup.drain()
        assert all(a.error is None for a in healed)
        assert {a.rung for a in healed} == {p.degrade.RUNG_SHARDED}
        assert sup.board.all_closed()
        assert p.serve_cli.run(["--snapshot", SNAPSHOT, "--podspec",
                                PODSPEC, "--mesh", "1x1"]
                               + p.cli_device) == 0
        assert p.hypercc.run(["serve", "--snapshot", SNAPSHOT, "--podspec",
                              PODSPEC, "--mesh", "auto"]
                             + p.cli_device) == 0
        capsys.readouterr()
        return [[_answer(a) for a in answers], [_answer(a) for a in healed]]
    both(scenario)


def test_request_ids_and_answers_are_one_to_one():
    def scenario(p):
        sup = _sup(p)
        reqs = [sup.submit(_template(p, f"t{i}", cpu=400 + 100 * i))
                for i in range(4)]
        answers = sup.drain()
        assert [a.request.id for a in answers] == [r.id for r in reqs]
        assert sup.drain() == []
        return [_answer(a) for a in answers]
    both(scenario)


# --- strict contract --------------------------------------------------------

def test_strict_trips_on_degraded_answer_past_grace():
    def scenario(p):
        sup = _sup(p, strict=True, strict_after=0)
        with p.faults.inject("engine.solve:oom:1:0"):
            ans = sup.serve(_template(p))
        assert ans.degraded and sup.strict_tripped
        return _answer(ans)
    both(scenario)


def test_strict_after_grace_tolerates_warmup_degradation():
    def scenario(p):
        sup = _sup(p, strict=True, strict_after=2)
        trips = []
        with p.faults.inject("engine.solve:oom:1:0"):
            for _ in range(3):
                sup.serve(_template(p))
                trips.append(sup.strict_tripped)
        assert trips == [False, False, True]
        return trips
    both(scenario)


def test_serve_cli_strict_exits_3(capsys):
    def scenario(p):
        argv = ["--snapshot", SNAPSHOT, "--podspec", PODSPEC,
                "--inject-fault", "engine.solve:oom:1:0"] + p.cli_device
        rcs = [p.serve_cli.run(argv + ["--strict"])]
        p.faults.clear()
        rcs.append(p.serve_cli.run(argv + ["--strict", "--strict-after",
                                           "8", "--iterations", "2"]))
        p.faults.clear()
        rcs.append(p.serve_cli.run(argv))
        assert rcs == [3, 0, 0]
        return rcs, capsys.readouterr()
    out = both(scenario)
    assert "state=degraded" in out[1].out


# --- delta ingestion --------------------------------------------------------

def test_remove_node_mask_equals_physical_removal():
    def scenario(p):
        store = _store(p, n_nodes=5, pods_per_node=1)
        tpl = _template(p)
        assert store.apply({"op": "remove_node", "node": "srv-2"})
        masked = _solve_auto(p, store.problems([tpl])[0])
        nodes = [n for i, n in enumerate(_nodes(5)) if i != 2]
        pods = [build_test_pod(f"base-{i}-0", 100, 10 ** 8,
                               node_name=f"srv-{i}")
                for i in range(5) if i != 2]
        phys = p.serve.SnapshotStore(
            p.ClusterSnapshot.from_objects(nodes, pods),
            p.SchedulerProfile())
        physical = _solve_auto(p, phys.problems([tpl])[0])
        assert masked.placed_count == physical.placed_count
        names_masked = [store.snapshot.node_names[int(i)]
                        for i in masked.placements]
        names_phys = [phys.snapshot.node_names[int(i)]
                      for i in physical.placements]
        assert "srv-2" not in names_masked
        assert sorted(names_masked) == sorted(names_phys)
        assert store.apply({"op": "restore_node", "node": "srv-2"})
        restored = _solve_auto(p, store.problems([tpl])[0])
        fresh = _solve_auto(p, _store(p, 5, 1).problems([tpl])[0])
        _same(restored, fresh)
        return [_result(masked), _result(physical), _result(restored)]
    both(scenario)


def test_pod_churn_roundtrip_and_counters():
    def scenario(p):
        store = _store(p, n_nodes=4)
        tpl = _template(p)
        base = _solve_auto(p, store.problems([tpl])[0])
        pod = build_test_pod("churn-1", 400, 5 * 10 ** 8, node_name="srv-1")
        assert store.apply({"op": "add_pod", "pod": pod})
        shrunk = _solve_auto(p, store.problems([tpl])[0])
        assert shrunk.placed_count < base.placed_count
        assert store.apply({"op": "remove_pod", "namespace": "default",
                            "name": "churn-1"})
        back = _solve_auto(p, store.problems([tpl])[0])
        _same(back, base)
        assert (store.applied, store.quarantined, store.generation) == \
            (2, 0, 2)
        return [_result(base), _result(shrunk), _result(back)]
    both(scenario)


def test_quarantine_rolls_back_to_last_good():
    def scenario(p):
        store = _store(p, n_nodes=4)
        tpl = _template(p)
        base = _solve_auto(p, store.problems([tpl])[0])
        gen = store.generation
        bad_pod = build_test_pod("bad", 100, 10 ** 8, node_name="srv-0")
        bad_pod["spec"]["containers"][0]["resources"]["requests"][
            "cpu"] = "not-a-cpu"
        verdicts = [store.apply(delta) for delta in (
            {"op": "remove_node", "node": "ghost"},
            {"op": "add_pod", "pod": bad_pod},
            {"op": "add_pod", "pod": build_test_pod("unbound", 100, 100)},
            {"op": "remove_pod", "namespace": "default", "name": "ghost"},
            {"op": "defragment_node", "node": "srv-0"},
            "not-a-delta",
            {"op": "remove_node", "node": ""})]
        assert verdicts == [False] * 7
        assert store.quarantined == 7 and store.applied == 0
        assert store.generation == gen
        _same(_solve_auto(p, store.problems([tpl])[0]), base)
        return _result(base)
    both(scenario)


def test_remove_last_alive_node_quarantined():
    def scenario(p):
        store = _store(p, n_nodes=2)
        out = (store.apply({"op": "remove_node", "node": "srv-0"}),
               store.apply({"op": "remove_node", "node": "srv-1"}),
               bool(store.alive[1]))
        assert out == (True, False, True)
        return out
    both(scenario)


def test_add_node_grows_axis_with_full_rebuild():
    def scenario(p):
        store = _store(p, n_nodes=3)
        tpl = _template(p)
        base = _solve_auto(p, store.problems([tpl])[0])
        new = build_test_node("srv-9", 4000, 8 * 1024 ** 3, 32)
        assert store.apply({"op": "add_node", "node": new})
        assert store.full_rebuilds == 1 and store.snapshot.num_nodes == 4
        grown = _solve_auto(p, store.problems([tpl])[0])
        assert grown.placed_count > base.placed_count
        assert store.apply({"op": "add_node", "node": new}) is False
        return [_result(base), _result(grown)]
    both(scenario)


def test_add_node_preserves_aux_objects():
    svc = {"metadata": {"name": "svc-a", "namespace": "default"},
           "spec": {"selector": {"app": "a"}}}
    pvc = {"metadata": {"name": "pvc-a", "namespace": "default"},
           "spec": {"storageClassName": "fast"}}

    def scenario(p):
        nodes = _nodes(3)
        store = p.serve.SnapshotStore(
            p.ClusterSnapshot.from_objects(nodes, [], services=[svc],
                                           pvcs=[pvc]),
            p.SchedulerProfile())
        new = build_test_node("srv-9", 4000, 8 * 1024 ** 3, 32)
        assert store.apply({"op": "add_node", "node": new})
        assert store.snapshot.services == [svc]
        assert store.snapshot.pvcs == [pvc]
        fresh = p.serve.SnapshotStore(
            p.ClusterSnapshot.from_objects(nodes + [new], [],
                                           services=[svc], pvcs=[pvc]),
            p.SchedulerProfile())
        tpl = _template(p)
        got = _solve_auto(p, store.problems([tpl])[0])
        _same(got, _solve_auto(p, fresh.problems([tpl])[0]))
        return _result(got)
    both(scenario)


def test_supervisor_survives_bad_deltas_mid_serving():
    def scenario(p):
        sup = _sup(p)
        tpl = _template(p)
        ref = sup.serve(tpl)
        assert sup.apply_delta({"op": "remove_node", "node": "ghost"}) \
            is False
        ans = sup.serve(tpl)
        assert ans.error is None
        _same(ans.result, ref.result)
        return [_answer(ref), _answer(ans)]
    both(scenario)


# --- containment: watchdogs, flight recorder --------------------------------

def test_watchdog_threads_stay_pooled_across_deadline_serves():
    def scenario(p):
        sup = _sup(p, deadline_s=30.0)
        tpl = _template(p)
        answers = [sup.serve(tpl) for _ in range(6)]
        assert all(a.error is None for a in answers)
        assert p.guard.watchdog_threads() <= p.guard._MAX_IDLE_WATCHDOGS
        return [_answer(a)[1:] for a in answers]
    both(scenario)


def test_concurrent_flight_dumps_are_serialized(tmp_path):
    def scenario(p):
        fdir = str(tmp_path / p.name)
        p.flight.install(fdir, argv=["test"], max_bundles=4,
                         capture_ir=False)
        try:
            errs = []

            def dump(i):
                try:
                    p.flight.on_fault(p.DeviceOOM(f"boom {i}",
                                                  site="engine.solve"))
                except Exception as exc:  # pragma: no cover
                    errs.append(exc)

            threads = [threading.Thread(target=dump, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errs
            # how many of the 8 racing dumps find the recorder busy and
            # skip is up to the scheduler; the bound and the codes are not
            paths = p.flight.bundle_paths()
            codes = [p.flight.load_bundle(x)["manifest"]["fault"]["code"]
                     for x in paths]
            assert set(codes) == {"DeviceOOM"}
            return 0 < len(paths) <= 4
        finally:
            p.flight.uninstall()
    both(scenario)


def test_breaker_transitions_reach_metrics_and_events():
    def scenario(p):
        clock = FakeClock()
        sup = _sup(p, clock=clock, threshold=1, cooldown=5.0)
        before = p.registry.counter_total(p.names.BREAKER_TRANSITIONS)
        with p.faults.inject("engine.solve:oom:1:0"):
            sup.serve(_template(p))
        clock.advance(6.0)
        sup.serve(_template(p))
        after = p.registry.counter_total(p.names.BREAKER_TRANSITIONS)
        assert after - before >= 3
        site = p.breaker.RUNG_SITE[p.degrade.RUNG_FUSED]
        gauge = p.registry.get_gauge(p.names.BREAKER_STATE, site=site,
                                     rung=p.degrade.RUNG_FUSED)
        assert gauge == 0.0
        return after - before, gauge
    both(scenario)


# --- the daemon CLI and the soak ---------------------------------------------

def _churn_script(tmp_path):
    """A delta script with every delta class, one malformed line and one
    unknown op."""
    lines = [
        {"op": "remove_node", "node": "kube-node-1"},
        {"op": "add_pod", "pod": build_test_pod("churn-a", 150,
                                                100 * 1024 ** 2,
                                                node_name="kube-node-2")},
        {"op": "restore_node", "node": "kube-node-1"},
        {"op": "remove_pod", "namespace": "default", "name": "churn-a"},
        {"op": "remove_pods_on", "node": "kube-node-3"},
        {"op": "defragment_node", "node": "kube-node-0"},
        {"op": "add_node", "node": build_test_node(
            "kube-node-9", 2000, 4 * 1024 ** 3, 110)},
    ]
    text = "\n".join(json.dumps(d) for d in lines[:5]) + "\n{not json\n" + \
        "\n".join(json.dumps(d) for d in lines[5:]) + "\n"
    path = tmp_path / "deltas.jsonl"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--verbose"],
                                   ["--max-limit", "9", "--verbose"]],
                         ids=["summary", "verbose", "limit9"])
def test_hypercc_serve_cli_byte_equal(tmp_path, capsys, extra):
    """`hypercc serve --deltas` over a churn script: stdout and the exit
    code equal the JAX CLI's, line for line."""
    deltas = _churn_script(tmp_path)
    argv = ["serve", "--snapshot", SNAPSHOT, "--podspec", PODSPEC,
            "--podspec", os.path.join(REPO, "examples", "pod-spec.yaml"),
            "--deltas", deltas] + extra
    outs = {}
    for name, p in PKGS.items():
        rc = p.hypercc.run(argv + p.cli_device)
        outs[name] = (rc, capsys.readouterr().out)
    assert outs["torch"] == outs["jax"]
    lines = outs["torch"][1].splitlines()
    assert outs["torch"][0] == 0 and len(lines) >= 9
    if not extra:
        assert lines[-1].endswith("deltas=6(+2 quarantined)")


def test_hypercc_serve_strict_exits_3(tmp_path, capsys):
    deltas = _churn_script(tmp_path)
    argv = ["serve", "--snapshot", SNAPSHOT, "--podspec", PODSPEC,
            "--deltas", deltas, "--iterations", "5", "--strict",
            "--inject-fault", "engine.solve:oom:1:0"]
    outs = {}
    for name, p in PKGS.items():
        rc = p.hypercc.run(argv + p.cli_device)
        p.faults.clear()
        cap = capsys.readouterr()
        outs[name] = (rc, cap.out, cap.err.splitlines()[-1])
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == 3


def test_port_soak_smoke(tmp_path, capsys):
    """The port's chaos soak, smoke phases with a short steady region on
    the CPU: every invariant holds and the artifact lands at --out only."""
    from cluster_capacity_tpu_torch.serve import soak
    out = tmp_path / "soak.json"
    rc = soak.main(["--smoke", "--device", "cpu", "--steady", "8",
                    "--out", str(out), "--flight-dir",
                    str(tmp_path / "flight")])
    assert rc == 0, capsys.readouterr().err
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["failures"] == []
    assert doc["platform"] == "cpu"
    assert doc["soak_steady_recompiles"] == 0
    assert doc["soak_bit_mismatches"] == 0
    assert doc["soak_breakers_opened"] >= 2
    assert doc["soak_flight_bundles"] == doc["soak_faults_injected"] - 1
    assert "soak: OK" in capsys.readouterr().out
