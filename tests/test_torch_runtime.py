"""The port's hardened runtime (runtime/errors, faults, guard, degrade)
against the JAX package's chaos drills (tests/test_runtime.py), mirrored:
spec parsing, fire timing, the CC_INJECT_FAULT variable, classification
of PyTorch's device errors, validate_result, the watchdog, the ladder to
fast_path and to the oracle, retries, group OOM halving, worst_rung, and
the CLI's --inject-fault/--strict, byte-equal to the JAX CLI.

The invariant everywhere: a degraded solve serves the same numbers as the
healthy run, and the port's rung, degraded flag, placements, messages and
counts equal the JAX package's under the same fault spec.  Tolerance:
exact.
"""

import json
import time

import pytest
import torch
import yaml

from cluster_capacity_tpu.cli import cluster_capacity as jcli
from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.runtime import degrade as jdegrade
from cluster_capacity_tpu.runtime import faults as jfaults
from cluster_capacity_tpu.runtime import guard as jguard
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu.utils.events import default_recorder as j_events
from cluster_capacity_tpu_torch.cli import cluster_capacity as tcli
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.engine import simulator as tsim
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.runtime import degrade, errors, faults, guard
from cluster_capacity_tpu_torch.runtime.errors import (CompileTimeout,
                                                       DeviceOOM,
                                                       ExecuteTimeout,
                                                       NumericCorruption)
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile
from cluster_capacity_tpu_torch.utils.events import default_recorder as t_events

from helpers import build_test_node, build_test_pod


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _probe(cpu=500, name="probe", spread=False):
    pod = build_test_pod(name, cpu, 0, labels={"app": name})
    if spread:
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": name}}}]
    return pod


def _nodes(num_nodes=4, cpu=2000, pods=8):
    return [build_test_node(f"n{i}", cpu, 4 * 1024 ** 3, pods,
                            labels={"topology.kubernetes.io/zone":
                                    f"z{i % 3}"})
            for i in range(num_nodes)]


def _pbs(num_nodes=4, probe=None, **kw):
    """(JAX problem, port problem) for one fit-only (or spread) fixture."""
    node_list, the_pod = _nodes(num_nodes, **kw), probe or _probe()
    return (jenc.encode_problem(JSnap.from_objects(node_list),
                                j_default_pod(the_pod), JProfile()),
            tenc.encode_problem(TSnap.from_objects(node_list),
                                t_default_pod(the_pod), TProfile()))


def _same(a, b):
    assert a.placements == b.placements
    assert a.placed_count == b.placed_count
    assert a.fail_type == b.fail_type
    assert a.fail_message == b.fail_message
    assert a.fail_counts == b.fail_counts


def _same_stamped(a, b):
    _same(a, b)
    assert (a.rung, a.degraded) == (b.rung, b.degraded)


def _both_one(specs, jpb, tpb, **kw):
    """solve_one_guarded of both packages under the same fault specs."""
    with jfaults.inject(*specs):
        want = jdegrade.solve_one_guarded(jpb, **kw)
    with faults.inject(*specs):
        got = degrade.solve_one_guarded(tpb, device="cpu", **kw)
    return want, got


# --- fault-spec parsing + counter semantics ---------------------------------

def test_parse_spec_forms():
    for text, want in (("engine.solve:oom", ("engine.solve", "oom", 1, 1)),
                       ("parallel.solve_group:hang:3",
                        ("parallel.solve_group", "hang", 3, 1)),
                       ("engine.fast_path:corrupt:2:0",
                        ("engine.fast_path", "corrupt", 2, 0))):
        s = faults.parse_spec(text)
        j = jfaults.parse_spec(text)
        assert (s.site, s.kind, s.at, s.times) == want == \
            (j.site, j.kind, j.at, j.times)
    assert faults.SITES == jfaults.SITES


@pytest.mark.parametrize("bad", [
    "engine.solve",                 # no kind
    "nowhere:oom",                  # unknown site
    "engine.solve:sparks",          # unknown kind
    "engine.solve:oom:zero",        # non-integer at
    "engine.solve:oom:0",           # at is 1-based
    "engine.solve:oom:1:-1",        # negative times
    "a:b:c:d:e",                    # too many fields
])
def test_parse_spec_rejects(bad):
    with pytest.raises(ValueError) as got:
        faults.parse_spec(bad)
    with pytest.raises(ValueError) as want:
        jfaults.parse_spec(bad)
    assert str(got.value) == str(want.value)


def test_fault_fires_at_nth_call_for_times_calls():
    with faults.inject("engine.solve:oom:2:2"):
        assert faults.fire("engine.solve") is None          # call 1
        for _ in range(2):                                  # calls 2, 3
            with pytest.raises(faults.SimulatedDeviceError,
                               match="CUDA out of memory"):
                faults.fire("engine.solve")
        assert faults.fire("engine.solve") is None          # call 4
        assert faults.fire("engine.oracle") is None


def test_fault_times_zero_fires_forever():
    with faults.inject("engine.oracle:hang:1:0"):
        for _ in range(5):
            with pytest.raises(faults.SimulatedHang):
                faults.fire("engine.oracle")


def test_suspended_blocks_and_restores():
    with faults.inject("engine.solve:oom:1:0"):
        with faults.suspended():
            assert faults.fire("engine.solve") is None
        with pytest.raises(faults.SimulatedDeviceError):
            faults.fire("engine.solve")


def test_env_var_installs_specs(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR,
                       "engine.solve:oom, parallel.solve_group:corrupt")
    faults.clear()
    with pytest.raises(faults.SimulatedDeviceError):
        faults.fire("engine.solve")
    spec = faults.fire("parallel.solve_group")
    assert spec is not None and spec.kind == faults.KIND_CORRUPT
    assert faults.ENV_VAR == jfaults.ENV_VAR


# --- classification + validation --------------------------------------------

def test_classify_pytorch_device_errors():
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.02 GiB is free.")
    assert isinstance(guard.classify_device_error(oom, site="s"), DeviceOOM)
    status = RuntimeError("CUDA error: out of memory\nCUDA kernel errors "
                          "might be asynchronously reported")
    assert isinstance(guard.classify_device_error(status), DeviceOOM)
    accel = torch.AcceleratorError("CUDA error: out of memory")
    assert isinstance(guard.classify_device_error(accel), DeviceOOM)
    assert isinstance(guard.classify_device_error(MemoryError()), DeviceOOM)
    sim_oom = faults.SimulatedDeviceError("CUDA out of memory. (injected)")
    assert isinstance(guard.classify_device_error(sim_oom), DeviceOOM)
    # unclassified: a sticky CUDA error, a launch the plan refuses, a
    # failed build, a plain host error
    for exc in (torch.AcceleratorError(
                    "CUDA error: an illegal memory access was encountered"),
                RuntimeError("fused_steps kernel launch failed: CUDA error 2 "
                             "(cluster of 4 CTAs)"),
                RuntimeError("fused_steps: the card cannot schedule a "
                             "cluster of 16 CTAs"),
                RuntimeError("nvcc failed (1):\nerror"),
                ValueError("boom")):
        assert guard.classify_device_error(exc) is None, exc


def test_fault_codes_and_strings_match_jax():
    from cluster_capacity_tpu.runtime import errors as jerrors
    for name in ("RuntimeFault", "DeviceOOM", "CompileTimeout",
                 "ExecuteTimeout", "NumericCorruption",
                 "SnapshotValidationError"):
        t, j = getattr(errors, name), getattr(jerrors, name)
        assert t.code == j.code
        assert str(t("m", site="engine.solve")) == \
            str(j("m", site="engine.solve"))
        assert str(t("m")) == str(j("m"))


def test_guard_propagates_engine_bugs_raw():
    def bug():
        raise ValueError("engine bug")
    with pytest.raises(ValueError, match="engine bug"):
        guard.run(bug, site=faults.SITE_SOLVE)

    def refused():
        raise RuntimeError("fused_steps: the card cannot schedule a "
                           "cluster of 16 CTAs")
    with pytest.raises(RuntimeError, match="cannot schedule"):
        guard.run(refused, site=faults.SITE_SOLVE)


def test_real_oom_inside_guard_is_device_oom():
    def alloc():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 1024.00 GiB.")
    with pytest.raises(DeviceOOM) as ei:
        guard.run(alloc, site=faults.SITE_SOLVE)
    assert ei.value.site == "engine.solve"
    assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)


def test_error_kind_propagates_unclassified():
    _jpb, tpb = _pbs()
    with faults.inject("engine.solve:error"):
        with pytest.raises(faults.SimulatedDeviceError, match="CUDA error"):
            degrade.solve_one_guarded(tpb, device="cpu")


def test_validate_result_rejects_bad_planes():
    ok = tsim.SolveResult(placements=[0, 1], placed_count=2, fail_type="",
                          fail_message="", node_names=["a", "b"])
    guard.validate_result(ok, 2)
    for bad in (tsim.SolveResult(placements=[0], placed_count=3,
                                 fail_type="", fail_message=""),
                tsim.SolveResult(placements=[5], placed_count=1,
                                 fail_type="", fail_message=""),
                tsim.SolveResult(placements=[], placed_count=0,
                                 fail_type="", fail_message="",
                                 fail_counts={"r": float("nan")})):
        with pytest.raises(NumericCorruption) as got:
            guard.validate_result(bad, 2, site="s")
        with pytest.raises(Exception) as want:
            jguard.validate_result(bad, 2, site="s")
        assert str(got.value) == str(want.value)


def test_deadline_watchdog_abandons_real_hang():
    with pytest.raises(ExecuteTimeout):
        guard.run(lambda: time.sleep(2), site=faults.SITE_SOLVE,
                  deadline=0.05)
    with pytest.raises(CompileTimeout):
        guard.run(lambda: time.sleep(2), site=faults.SITE_GROUP,
                  deadline=0.05, phase=guard.PHASE_COMPILE)
    assert guard.run(lambda: 41 + 1, site=faults.SITE_SOLVE,
                     deadline=5.0) == 42
    # healthy deadline calls reuse pooled workers
    before = guard.watchdog_threads()
    for _ in range(20):
        guard.run(lambda: 1, site=faults.SITE_SOLVE, deadline=5.0)
    assert guard.watchdog_threads() <= before + 1


# --- single-solve degradation ladder ----------------------------------------

@pytest.mark.parametrize("kind", ["oom", "hang", "corrupt"])
def test_ladder_falls_to_fast_path_like_jax(kind):
    jpb, tpb = _pbs()
    healthy = degrade.solve_one_guarded(tpb, device="cpu")
    assert (healthy.rung, healthy.degraded) == (degrade.RUNG_FUSED, False)
    want, got = _both_one([f"engine.solve:{kind}"], jpb, tpb)
    assert (got.rung, got.degraded) == (degrade.RUNG_FAST_PATH, True)
    _same(got, healthy)
    _same_stamped(got, want)


def test_ladder_falls_to_oracle_like_jax():
    jpb, tpb = _pbs()
    healthy = degrade.solve_one_guarded(tpb, device="cpu")
    want, got = _both_one(["engine.solve:oom:1:0",
                           "engine.fast_path:oom:1:0"], jpb, tpb)
    assert (got.rung, got.degraded) == (degrade.RUNG_ORACLE, True)
    _same(got, healthy)
    _same_stamped(got, want)


def test_ladder_oracle_with_limit_like_jax():
    jpb, tpb = _pbs(num_nodes=3)
    healthy = degrade.solve_one_guarded(tpb, max_limit=5, device="cpu")
    want, got = _both_one(["engine.solve:oom:1:0",
                           "engine.fast_path:oom:1:0"], jpb, tpb,
                          max_limit=5)
    assert got.rung == degrade.RUNG_ORACLE
    assert got.fail_type == tsim.FAIL_LIMIT_REACHED
    _same(got, healthy)
    _same_stamped(got, want)


def test_spread_problem_corrupt_descends_to_oracle_like_jax():
    """The closed form does not take a spread problem, so a corrupt kernel
    answer descends past fast_path (None) to the oracle; its answer equals
    the port's oracle run directly and the JAX ladder's."""
    from cluster_capacity_tpu_torch.engine import oracle as toracle
    jpb, tpb = _pbs(num_nodes=6, probe=_probe(300, spread=True))
    want, got = _both_one(["engine.solve:corrupt"], jpb, tpb, max_limit=20)
    assert (got.rung, got.degraded) == (degrade.RUNG_ORACLE, True)
    _same_stamped(got, want)
    direct, _ = toracle.simulate(tpb.snapshot, tpb.pod, tpb.profile,
                                 max_limit=20)
    assert got.placements == direct


def test_retries_reattempt_same_rung():
    jpb, tpb = _pbs()
    healthy = degrade.solve_one_guarded(tpb, device="cpu")
    want, got = _both_one(["engine.solve:oom"], jpb, tpb, retries=1)
    assert got.rung == degrade.RUNG_FUSED
    _same(got, healthy)
    _same_stamped(got, want)


def test_degradation_records_events_like_jax():
    jpb, tpb = _pbs()
    for kind in ("hang", "corrupt", "oom"):
        j_events.clear()
        t_events.clear()
        _both_one([f"engine.solve:{kind}"], jpb, tpb)
        got = [(e.object_name, e.reason) for e in t_events.events]
        want = [(e.object_name, e.reason) for e in j_events.events]
        assert got == want and got
        deg = t_events.by_reason(degrade.EVENT_DEGRADED)
        assert deg and deg[0].message.startswith(
            "DeviceOOM at engine.solve: falling back to fast_path: "
            if kind == "oom" else "")
        if kind != "oom":
            # the messages carry no device wording: byte-equal
            assert [e.message for e in t_events.events] == \
                [e.message for e in j_events.events]


# --- batched-group ladder ----------------------------------------------------

def _group_pbs(count=5):
    node_list = _nodes()
    jsnap, tsnap = JSnap.from_objects(node_list), TSnap.from_objects(node_list)
    tpls = [_probe(100 * (i + 1), name=f"p{i}") for i in range(count)]
    return ([jenc.encode_problem(jsnap, j_default_pod(t), JProfile())
             for t in tpls],
            [tenc.encode_problem(tsnap, t_default_pod(t), TProfile())
             for t in tpls])


def _both_group(specs, jpbs, tpbs):
    with jfaults.inject(*specs):
        want = jdegrade.solve_group_guarded(jpbs)
    with faults.inject(*specs):
        got = degrade.solve_group_guarded(tpbs, device="cpu")
    return want, got


def test_group_oom_splits_geometrically_like_jax():
    jpbs, tpbs = _group_pbs()
    healthy = degrade.solve_group_guarded(tpbs, device="cpu")
    assert all(r.rung == degrade.RUNG_BATCHED and not r.degraded
               for r in healthy)
    t_events.clear()
    want, got = _both_group(["parallel.solve_group:oom"], jpbs, tpbs)
    assert all(r.rung == degrade.RUNG_BATCHED and r.degraded for r in got)
    for a, b, c in zip(got, healthy, want):
        _same(a, b)
        _same_stamped(a, c)
    assert any("falling back to fused_batched[2+3]" in e.message
               for e in t_events.by_reason(degrade.EVENT_DEGRADED))


def test_group_oom_forever_falls_to_per_item_ladder_like_jax():
    jpbs, tpbs = _group_pbs()
    healthy = degrade.solve_group_guarded(tpbs, device="cpu")
    want, got = _both_group(["parallel.solve_group:oom:1:0"], jpbs, tpbs)
    assert all(r.rung == degrade.RUNG_FUSED and r.degraded for r in got)
    for a, b, c in zip(got, healthy, want):
        _same(a, b)
        _same_stamped(a, c)


def test_group_corrupt_caught_by_validation_like_jax():
    jpbs, tpbs = _group_pbs()
    healthy = degrade.solve_group_guarded(tpbs, device="cpu")
    want, got = _both_group(["parallel.solve_group:corrupt"], jpbs, tpbs)
    assert all(r.degraded for r in got)
    for a, b, c in zip(got, healthy, want):
        _same(a, b)
        _same_stamped(a, c)


def test_sweep_fast_path_group_fault_like_jax():
    """A small-limit sweep whose closed-form group faults: the templates
    fall to the per-template ladder, flagged degraded, same numbers."""
    from cluster_capacity_tpu.parallel import sweep as jsweep
    node_list = _nodes(6)
    tpls = [_probe(100 * (i + 1), name=f"p{i}") for i in range(4)]
    healthy = tsweep.sweep(TSnap.from_objects(node_list),
                           [t_default_pod(t) for t in tpls], max_limit=3,
                           device="cpu")
    with jfaults.inject("engine.fast_path:oom"):
        want = jsweep.sweep(JSnap.from_objects(node_list),
                            [j_default_pod(t) for t in tpls], max_limit=3)
    with faults.inject("engine.fast_path:oom"):
        got = tsweep.sweep(TSnap.from_objects(node_list),
                           [t_default_pod(t) for t in tpls], max_limit=3,
                           device="cpu")
    assert all(r.degraded for r in got)
    for a, b, c in zip(got, healthy, want):
        _same(a, b)
        _same_stamped(a, c)


def test_worst_rung_ordering():
    mk = lambda rung: tsim.SolveResult(placements=[], placed_count=0,
                                       fail_type="", fail_message="",
                                       rung=rung)
    assert degrade.worst_rung([]) == ""
    assert degrade.worst_rung([mk("fused_batched"), mk("oracle"),
                               mk("fast_path")]) == "oracle"
    assert degrade.worst_rung([mk("fused_batched"), mk("fused")]) == "fused"
    assert degrade.LADDER == jdegrade.LADDER


# --- CLI ----------------------------------------------------------------------

def _write_cluster(tmp_path):
    snap_path = tmp_path / "snap.yaml"
    pod_path = tmp_path / "pod.yaml"
    snap_path.write_text(yaml.safe_dump({"nodes": _nodes(3), "pods": []}))
    pod_path.write_text(yaml.safe_dump(build_test_pod("probe", 500, 0)))
    return str(snap_path), str(pod_path)


def _cli_both(argv, capsys):
    """(JAX rc, stdout), (port rc, stdout) of one CLI invocation; the faults
    each CLI installs are cleared after it."""
    out = []
    for module, extra, harness in ((jcli, [], jfaults),
                                   (tcli, ["--device", "cpu"], faults)):
        rc = module.run(argv + extra)
        out.append((rc, capsys.readouterr().out))
        harness.clear()
    return out


def _drop_timestamp(text):
    data = json.loads(text)
    data["status"].pop("creationTimestamp")
    return data


def test_cli_inject_fault_strict_json_like_jax(tmp_path, capsys):
    snap, pod = _write_cluster(tmp_path)
    base = ["--snapshot", snap, "--podspec", pod, "-o", "json"]
    (jrc, jout), (trc, tout) = _cli_both(base, capsys)
    assert jrc == trc == 0
    healthy = _drop_timestamp(tout)
    assert healthy == _drop_timestamp(jout)
    assert healthy["status"]["degraded"] is False

    for spec in ("engine.solve:oom", "engine.solve:hang",
                 "engine.solve:corrupt"):
        (jrc, jout), (trc, tout) = _cli_both(
            base + ["--inject-fault", spec, "--strict"], capsys)
        assert jrc == trc == 3
        degraded = _drop_timestamp(tout)
        assert degraded == _drop_timestamp(jout)
        assert degraded["status"]["degraded"] is True
        assert degraded["status"]["rung"] == degrade.RUNG_FAST_PATH
        assert degraded["status"]["replicas"] == \
            healthy["status"]["replicas"]

    (jrc, jout), (trc, tout) = _cli_both(
        base + ["--inject-fault", "engine.solve:oom:1:0",
                "--inject-fault", "engine.fast_path:oom:1:0", "--strict"],
        capsys)
    assert jrc == trc == 3
    assert _drop_timestamp(tout) == _drop_timestamp(jout)
    assert _drop_timestamp(tout)["status"]["rung"] == degrade.RUNG_ORACLE


def test_cli_degraded_warning_text_like_jax(tmp_path, capsys):
    snap, pod = _write_cluster(tmp_path)
    for fmt in ([], ["--verbose"]):
        (jrc, jout), (trc, tout) = _cli_both(
            ["--snapshot", snap, "--podspec", pod,
             "--inject-fault", "engine.solve:oom"] + fmt, capsys)
        assert jrc == trc == 0           # degraded alone is not an error
        assert tout == jout
        assert "WARNING: solve degraded" in tout


def test_cli_env_var_and_bad_spec(tmp_path, capsys, monkeypatch):
    snap, pod = _write_cluster(tmp_path)
    assert tcli.run(["--snapshot", snap, "--podspec", pod, "--device",
                     "cpu", "--inject-fault", "bogus-spec"]) == 1
    assert "bad fault spec" in capsys.readouterr().err
    monkeypatch.setenv(faults.ENV_VAR, "engine.solve:oom")
    faults.clear()
    jfaults.clear()
    (jrc, jout), (trc, tout) = _cli_both(
        ["--snapshot", snap, "--podspec", pod, "-o", "json", "--strict"],
        capsys)
    assert jrc == trc == 3
    assert _drop_timestamp(tout) == _drop_timestamp(jout)


def test_cli_error_kind_raises(tmp_path):
    snap, pod = _write_cluster(tmp_path)
    with pytest.raises(faults.SimulatedDeviceError):
        tcli.run(["--snapshot", snap, "--podspec", pod, "--device", "cpu",
                  "--inject-fault", "engine.solve:error"])


def test_cli_strict_after_still_refused(tmp_path, capsys):
    """--strict-after is served since the front-end slice: one degraded
    run inside the grace exits 0, past it exits 3, as the JAX CLI does."""
    snap, pod = _write_cluster(tmp_path)
    base = ["--snapshot", snap, "--podspec", pod, "-o", "json", "--strict",
            "--inject-fault", "engine.solve:oom"]
    for after, rc in (("1", 0), ("0", 3)):
        (jrc, jout), (trc, tout) = _cli_both(base + ["--strict-after", after],
                                             capsys)
        assert jrc == trc == rc
        assert _drop_timestamp(tout) == _drop_timestamp(jout)
        assert _drop_timestamp(tout)["status"]["degraded"] is True
