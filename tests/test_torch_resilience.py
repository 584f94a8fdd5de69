"""The port's resilience sweeps (resilience/, cli/resilience.py) against the
JAX package's, on tests/test_resilience.py's fixtures.

Each case feeds the same cluster, scenarios and probe to both packages'
`analyze` in the same process and compares the whole report
(SurvivabilityReport.to_dict(): every row's headroom, drain counts,
messages, placements, batched / deduped / bounded provenance and rung, the
bounds block and the headline numbers) in the default float32 profile and
under SchedulerProfile.parity().  The CLI is held byte for byte in text
and JSON, and its --metrics-dump / --trace-out with durations masked.
Tolerance: exact.
"""

import json
import os
import re

import numpy as np
import pytest

from cluster_capacity_tpu import obs as jobs
from cluster_capacity_tpu.cli import resilience as jcli
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.resilience import analyzer as janalyzer
from cluster_capacity_tpu.resilience import scenarios as jscen
from cluster_capacity_tpu.runtime import faults as jfaults
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu.utils.metrics import default_registry as jreg
from cluster_capacity_tpu_torch import obs as tobs
from cluster_capacity_tpu_torch.cli import hypercc as thypercc
from cluster_capacity_tpu_torch.cli import resilience as tcli
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.resilience import analyzer as tanalyzer
from cluster_capacity_tpu_torch.resilience import scenarios as tscen
from cluster_capacity_tpu_torch.runtime import faults as tfaults
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile
from cluster_capacity_tpu_torch.utils.metrics import default_registry as treg

from helpers import build_test_node, build_test_pod
from torch_trace import PORT_ONLY_SERIES, as_jax_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZONE = "topology.kubernetes.io/zone"
PROFILES = {"float32": (JProfile, TProfile),
            "parity": (JProfile.parity, TProfile.parity)}


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for f in (jfaults, tfaults):
        f.clear()
    for o, r in ((jobs, jreg), (tobs, treg)):
        o.default_collector.reset()
        r.reset()
    yield
    for f in (jfaults, tfaults):
        f.clear()


def _probe(cpu=500, mem=0, name="probe"):
    return build_test_pod(name, cpu, mem)


def _heterogeneous_nodes(n, seed):
    rng = np.random.RandomState(seed)
    cpus = rng.randint(6, 16, size=n) * 250
    return [build_test_node(f"node-{i:03d}", int(cpus[i]), 8 * 1024 ** 3, 4,
                            labels={ZONE: f"z{i % 4}"})
            for i in range(n)]


def _spread(pod):
    pod["metadata"]["labels"] = {"name": pod["metadata"]["name"]}
    pod["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": 1, "topologyKey": ZONE,
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"name": pod["metadata"]["name"]}},
    }]
    return pod


def _prio(pod, p):
    pod["spec"]["priority"] = p
    return pod


_PDB = {"metadata": {"name": "pdb", "namespace": "default"},
        "spec": {"selector": {"matchLabels": {"app": "guarded"}}},
        "status": {"disruptionsAllowed": 0}}


def _cases():
    """(name, nodes, pods, objs, probe, scenario kinds, analyze kwargs):
    tests/test_resilience.py's clusters, one per behaviour."""
    twins = [build_test_node(f"twin-{i}", 2000, 4 * 1024 ** 3, 6)
             for i in range(6)] + [build_test_node("odd", 4000,
                                                   8 * 1024 ** 3, 6)]
    zones9 = [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 4,
                              labels={ZONE: f"z{i % 3}"}) for i in range(9)]
    return [
        ("batched-single-node", _heterogeneous_nodes(24, seed=3), [], {},
         _probe(), ("node",), dict(dedup=False, keep_placements=True)),
        ("drained-pods", [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 6)
                          for i in range(5)],
         [build_test_pod("p0", 700, 0, node_name="n0"),
          build_test_pod("p1", 300, 0, node_name="n0")], {},
         _probe(), ("node",), dict(keep_placements=True)),
        ("spread-sequential", [build_test_node(
            f"n{i}", 4000, 8 * 1024 ** 3, 8, labels={ZONE: f"z{i % 2}"})
            for i in range(4)], [], {}, _spread(_probe()), ("node", "zone"),
         dict(dedup=False, keep_placements=True)),
        ("preempt-squatter", [build_test_node("n0", 1000, int(1e9), 10),
                              build_test_node("n1", 1000, int(1e9), 10)],
         [_prio(build_test_pod("vip", 800, 0, node_name="n0"), 100),
          _prio(build_test_pod("squatter", 800, 0, node_name="n1"), 0)],
         {}, _probe(cpu=800), ("node",), {}),
        ("pdb-push", [build_test_node("n0", 1000, int(1e9), 10),
                      build_test_node("protected", 1000, int(1e9), 10),
                      build_test_node("open", 1000, int(1e9), 10)],
         [_prio(build_test_pod("vip", 800, 0, node_name="n0"), 100),
          _prio(build_test_pod("guarded", 800, 0, node_name="protected",
                               labels={"app": "guarded"}), 0),
          _prio(build_test_pod("plain", 800, 0, node_name="open"), 0)],
         {"pdbs": [_PDB]}, _probe(cpu=800), ("node",),
         dict(keep_placements=True)),
        ("pdb-unreprievable", [build_test_node("n0", 1000, int(1e9), 10),
                               build_test_node("n1", 1000, int(1e9), 10)],
         [_prio(build_test_pod("vip", 700, 0, node_name="n0"), 100),
          _prio(build_test_pod("guarded", 500, 0, node_name="n1",
                               labels={"app": "guarded"}), 0),
          _prio(build_test_pod("small", 300, 0, node_name="n1"), 0)],
         {"pdbs": [_PDB]}, _probe(cpu=700), ("node",), {}),
        ("stranded-order", [build_test_node("n0", 2000, int(4e9), 10),
                            build_test_node("n1", 1000, int(4e9), 10)],
         [_prio(build_test_pod("lo", 800, 0, node_name="n0"), 1),
          _prio(build_test_pod("hi", 800, 0, node_name="n0"), 50)],
         {}, _probe(cpu=800), ("node",), {}),
        ("zones", zones9, [], {}, _probe(), ("zone",),
         dict(keep_placements=True)),
        ("random-nk", zones9, [build_test_pod("r", 900, 0, node_name="n4")],
         {}, _probe(), ("random",), {}),
        ("drain-list", zones9, [build_test_pod("d", 900, 0, node_name="n2")],
         {}, _probe(), ("drain",), dict(max_limit=12)),
        ("dedup-twins", twins, [], {}, _probe(), ("node",), {}),
        ("dedup-twins-no-bounds", twins, [], {}, _probe(), ("node",),
         dict(bounds=False)),
        ("limit-pruned", _heterogeneous_nodes(12, seed=5), [], {}, _probe(),
         ("node", "zone"), dict(max_limit=20)),
        ("worst-nodes", [build_test_node("big", 4000, 8 * 1024 ** 3, 8),
                         build_test_node("small", 1000, 1024 ** 3, 8)],
         [build_test_pod("p", 1100, 0, node_name="big")], {},
         _probe(cpu=900), ("node",), {}),
    ]


def _scenarios(mod, snap, kinds):
    out = []
    for kind in kinds:
        if kind == "node":
            out += mod.single_node_scenarios(snap)
        elif kind == "zone":
            out += mod.zone_scenarios(snap)
        elif kind == "random":
            out += mod.random_nk_scenarios(snap, 2, 5, seed=7)
        else:
            out.append(mod.drain_list_scenario(
                snap, [snap.node_names[2], snap.node_names[0]]))
    return out


def _analyze_both(case, prof, **extra):
    _name, nodes, pods, objs, probe, kinds, kw = case
    kw = dict(kw, **extra)
    jp, tp = (f() for f in PROFILES[prof])
    jsnap = JSnap.from_objects(nodes, pods, **objs)
    tsnap = TSnap.from_objects(nodes, pods, **objs)
    want = janalyzer.analyze(jsnap, _scenarios(jscen, jsnap, kinds),
                             j_default_pod(probe), profile=jp, **kw)
    got = tanalyzer.analyze(tsnap, _scenarios(tscen, tsnap, kinds),
                            t_default_pod(probe), profile=tp, device="cpu",
                            **kw)
    return want, got


@pytest.mark.parametrize("prof", sorted(PROFILES))
@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_analyze_matches_jax(case, prof):
    want, got = _analyze_both(case, prof)
    assert got.to_dict() == want.to_dict()
    assert got.worst_rung == want.worst_rung
    assert not got.degraded


def test_batched_scenarios_ride_one_group():
    """The single-node family of a fit-only probe is mask-exact: every row
    is batched (bounds off: one kernel 2 group; bounds on: every row
    proved by the bracket), as in the JAX package."""
    case = _cases()[0]
    _want, got = _analyze_both(case, "float32", bounds=False)
    assert got.batched_scenarios == 24 and got.sequential_scenarios == 0
    assert {r.rung for r in got.scenarios} == {"fused_batched"}
    _want, got = _analyze_both(case, "float32", keep_placements=False)
    assert {r.rung for r in got.scenarios} == {"bounds"}
    assert got.bounds["pruned"] == 24


def test_scenario_groups_match_jax(monkeypatch):
    """The masked scenarios of one sweep fall into the same kernel 2 groups
    in both packages (static_config reads num_alive, so single-node and
    zone failures form separate groups when it matters): the same group
    sizes, in the same order."""
    from cluster_capacity_tpu.runtime import degrade as jdeg
    from cluster_capacity_tpu_torch.runtime import degrade as tdeg
    sizes = {"j": [], "t": []}
    for key, mod in (("j", jdeg), ("t", tdeg)):
        real = mod.solve_group_guarded

        def spy(pbs, *a, _real=real, _key=key, **kw):
            sizes[_key].append(len(pbs))
            return _real(pbs, *a, **kw)
        monkeypatch.setattr(mod, "solve_group_guarded", spy)
    case = _cases()[12]
    want, got = _analyze_both(case, "float32", bounds=False, dedup=False)
    assert got.to_dict() == want.to_dict()
    assert sizes["t"] == sizes["j"] and sum(sizes["t"]) == 16


@pytest.mark.parametrize("prof", sorted(PROFILES))
def test_analyze_explain_matches_jax(prof):
    """explain=True: every row's bottleneck and deltaCapacity, and the
    baseline bottleneck, equal the JAX package's."""
    for case in (_cases()[1], _cases()[2], _cases()[10]):
        want, got = _analyze_both(case, prof, explain=True)
        assert got.to_dict() == want.to_dict()
        assert got.baseline_bottleneck is not None


def test_journal_kill_and_resume_matches_jax(tmp_path):
    """A journal cut after two rows resumes to the uninterrupted report,
    in both packages, and each package resumes the other's journal; a
    journal of another sweep is refused by both."""
    from cluster_capacity_tpu.runtime.errors import \
        CheckpointCorruption as JCorrupt
    from cluster_capacity_tpu_torch.runtime.errors import \
        CheckpointCorruption as TCorrupt
    _name, nodes, pods, objs, probe, kinds, _kw = _cases()[2]
    jsnap = JSnap.from_objects(nodes, pods, **objs)
    tsnap = TSnap.from_objects(nodes, pods, **objs)
    jsc, tsc = _scenarios(jscen, jsnap, kinds), _scenarios(tscen, tsnap,
                                                            kinds)
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    full_j = janalyzer.analyze(jsnap, jsc, j_default_pod(probe),
                               profile=JProfile(), journal=jpath)
    full_t = tanalyzer.analyze(tsnap, tsc, t_default_pod(probe),
                               profile=TProfile(), journal=tpath,
                               device="cpu")
    assert full_t.to_dict() == full_j.to_dict()
    for path in (jpath, tpath):
        lines = open(path).read().splitlines(keepends=True)
        assert len(lines) > 3
        with open(path, "w") as f:
            f.writelines(lines[:3])
    # each package resumes the other's cut journal
    res_t = tanalyzer.analyze(tsnap, tsc, t_default_pod(probe),
                              profile=TProfile(), journal=jpath,
                              resume=True, device="cpu")
    res_j = janalyzer.analyze(jsnap, jsc, j_default_pod(probe),
                              profile=JProfile(), journal=tpath, resume=True)
    assert res_t.to_dict() == res_j.to_dict() == full_j.to_dict()
    other = t_default_pod(_probe(cpu=300, name="other"))
    with pytest.raises(TCorrupt, match="different sweep"):
        tanalyzer.analyze(tsnap, tsc, other, profile=TProfile(),
                          journal=tpath, resume=True, device="cpu")
    with pytest.raises(JCorrupt, match="different sweep"):
        janalyzer.analyze(jsnap, jsc, j_default_pod(_probe(cpu=300,
                                                           name="other")),
                          profile=JProfile(), journal=jpath, resume=True)


def test_scenario_enumeration_and_dedup_match_jax():
    nodes = _heterogeneous_nodes(16, seed=9) + [
        build_test_node("bare", 1000, 1024 ** 3, 4)]
    pods = [build_test_pod("pa", 500, 0, node_name="node-003")]
    jsnap, tsnap = JSnap.from_objects(nodes, pods), TSnap.from_objects(nodes,
                                                                       pods)
    for kinds in (("node",), ("zone",), ("random",), ("drain",)):
        js, ts = _scenarios(jscen, jsnap, kinds), _scenarios(tscen, tsnap,
                                                             kinds)
        assert [(s.name, s.kind, s.failed) for s in ts] == \
            [(s.name, s.kind, s.failed) for s in js]
    from cluster_capacity_tpu.engine import encode as jenc
    from cluster_capacity_tpu_torch.engine import encode as tenc
    jpb = jenc.encode_problem(jsnap, j_default_pod(_probe()), JProfile())
    tpb = tenc.encode_problem(tsnap, t_default_pod(_probe()), TProfile())
    jsc = jscen.single_node_scenarios(jsnap)
    tsc = tscen.single_node_scenarios(tsnap)
    assert tscen.dedup_single_node(tpb, tsc) == \
        jscen.dedup_single_node(jpb, jsc)
    assert [tscen.node_signature(tpb, i) for i in range(len(nodes))] == \
        [jscen.node_signature(jpb, i) for i in range(len(nodes))]
    with pytest.raises(ValueError, match="unknown node"):
        tscen.drain_list_scenario(tsnap, ["node-001", "ghost"])
    with pytest.raises(ValueError):
        tscen.random_nk_scenarios(tsnap, 40, 1)


def test_group_fault_falls_back_like_jax():
    """parallel.solve_group:oom on every attempt: the group halves down to
    B=1 and then serves through the per-item ladder, degraded; the report
    equals the JAX package's under the same spec."""
    spec = "parallel.solve_group:oom:1:99"
    _name, nodes, _pods, _objs, probe, kinds, _kw = _cases()[0]
    jsnap, tsnap = JSnap.from_objects(nodes), TSnap.from_objects(nodes)
    with jfaults.inject(spec):
        want = janalyzer.analyze(jsnap, _scenarios(jscen, jsnap, kinds),
                                 j_default_pod(probe), profile=JProfile(),
                                 dedup=False, bounds=False)
    with tfaults.inject(spec):
        got = tanalyzer.analyze(tsnap, _scenarios(tscen, tsnap, kinds),
                                t_default_pod(probe), profile=TProfile(),
                                dedup=False, bounds=False, device="cpu")
    assert got.to_dict() == want.to_dict()
    assert got.degraded and got.worst_rung == want.worst_rung


def test_mesh_refused_by_name(tmp_path, capsys):
    """The mesh is served: analyze(mesh=2x4) equals the JAX package's
    sharded sweep row for row (status.mesh included), and `resilience
    --mesh 2x4` prints the JAX CLI's bytes; 'auto' on the CPU runs
    unsharded."""
    from cluster_capacity_tpu.parallel import mesh as jmesh
    from cluster_capacity_tpu_torch.parallel import mesh as tmesh
    nodes = _heterogeneous_nodes(6, seed=1)
    jsnap, tsnap = JSnap.from_objects(nodes), TSnap.from_objects(nodes)
    want = janalyzer.analyze(jsnap, jscen.single_node_scenarios(jsnap),
                             j_default_pod(_probe()), max_limit=20,
                             mesh=jmesh.make_mesh(4, 2), dedup=False)
    got = tanalyzer.analyze(tsnap, tscen.single_node_scenarios(tsnap),
                            t_default_pod(_probe()), max_limit=20,
                            mesh=tmesh.make_mesh(4, 2, device="cpu"),
                            dedup=False, device="cpu")
    assert got.mesh == want.mesh == {"batch": 2, "nodes": 4}
    assert got.to_dict() == want.to_dict()
    snap_file = os.path.join(REPO, "examples", "cluster-snapshot.yaml")
    (rc_j, out_j), (rc_t, out_t) = _run_both(
        capsys, ["--snapshot", snap_file, "--mesh", "2x4", "-o", "json"])
    assert rc_j == rc_t == 0 and out_t == out_j
    assert tcli.run(["--snapshot", snap_file, "--device", "cpu",
                     "--mesh=auto"]) == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _snap_file(tmp_path):
    path = tmp_path / "snap.json"
    path.write_text(json.dumps({
        "nodes": [
            {"metadata": {"name": f"n{i}",
                          "labels": {ZONE: f"z{i % 2}"}},
             "status": {"allocatable": {"cpu": "2", "memory": "4Gi",
                                        "pods": "8"}}}
            for i in range(4)],
        "pods": [{"metadata": {"name": "res", "namespace": "default"},
                  "spec": {"nodeName": "n1", "containers": [
                      {"name": "c", "resources": {"requests": {
                          "cpu": "600m", "memory": "1Gi"}}}]}}],
    }))
    return str(path)


def _run_both(capsys, argv):
    rc_j = jcli.run(list(argv))
    out_j = capsys.readouterr()
    rc_t = tcli.run(list(argv) + ["--device", "cpu"])
    out_t = capsys.readouterr()
    return (rc_j, out_j.out), (rc_t, out_t.out)


@pytest.mark.parametrize("flags", [
    [],
    ["--verbose"],
    ["-o", "json"],
    ["-o", "yaml"],
    ["--zones", "--random-k", "2", "--samples", "3", "--drain", "n0,n1",
     "-o", "json"],
    ["--nodes", "--zones", "--explain", "--verbose"],
    ["--no-dedup", "--no-bounds", "--max-limit", "5", "-o", "json"],
    ["--parity", "--zones", "--verbose"],
    ["--inject-fault", "parallel.solve_group:oom:1:99", "--no-bounds",
     "-o", "json"],
], ids=lambda f: " ".join(f) or "default")
def test_cli_byte_equal(tmp_path, capsys, flags):
    argv = ["--snapshot", _snap_file(tmp_path)] + flags
    (rc_j, out_j), (rc_t, out_t) = _run_both(capsys, argv)
    assert (rc_t, out_t) == (rc_j, out_j)
    assert rc_t == 0


def test_cli_examples_snapshot_byte_equal(capsys):
    """The README example: examples/cluster-snapshot.yaml, every mode."""
    snap = os.path.join(REPO, "examples", "cluster-snapshot.yaml")
    for flags in ([], ["--zones", "-o", "json"], ["--verbose"]):
        (rc_j, out_j), (rc_t, out_t) = _run_both(
            capsys, ["--snapshot", snap] + flags)
        assert (rc_t, out_t) == (rc_j, out_j)


def test_cli_errors_match_jax(tmp_path, capsys):
    snap = _snap_file(tmp_path)
    for argv in ([], ["--snapshot", snap, "--drain", "ghost"],
                 ["--snapshot", snap, "-o", "bogus"],
                 ["--snapshot", snap, "--random-k", "9"],
                 ["--snapshot", snap, "--resume"]):
        rc_j = jcli.run(list(argv))
        err_j = capsys.readouterr().err
        rc_t = tcli.run(list(argv) + ["--device", "cpu"])
        err_t = capsys.readouterr().err
        assert (rc_t, err_t) == (rc_j, err_j), argv
        assert rc_t == 1


def test_cli_strict_exit_and_flight(tmp_path, capsys):
    """--strict on a degraded sweep exits 3 in both packages, and the
    armed flight recorder leaves bundles in both."""
    from cluster_capacity_tpu.obs import flight as jflight
    from cluster_capacity_tpu_torch.obs import flight as tflight
    snap = _snap_file(tmp_path)
    outs = []
    try:
        for run, sub, extra in ((jcli.run, "j", []),
                                (tcli.run, "t", ["--device", "cpu"])):
            fdir = str(tmp_path / f"flight-{sub}")
            rc = run(["--snapshot", snap, "--no-bounds", "--strict", "-o",
                      "json", "--flight-dir", fdir, "--inject-fault",
                      "parallel.solve_group:oom:1:99"] + extra)
            outs.append((rc, capsys.readouterr().out,
                         sorted(n.split("-", 2)[2]
                                for n in os.listdir(fdir))))
    finally:
        # the CLIs leave their recorders armed for the process: disarm
        # them, so later tests in this worker dump no bundles here
        jflight.uninstall()
        tflight.uninstall()
    assert outs[1] == outs[0]
    assert outs[1][0] == 3 and "StrictDegraded" in outs[1][2]


_DURATION = re.compile(r"(_seconds(_total|_sum)?\{[^}]*\}|_seconds_sum) .*$")


def _masked_metrics(text):
    """Prometheus text with every duration value masked, and without the
    compile counters (the JAX package counts XLA compiles on the CPU, the
    port's eager CPU run compiles nothing: a deliberate difference) or the
    series only the port records."""
    out = []
    for line in text.splitlines():
        if line.startswith(("cc_recompiles_total", "cc_compile_seconds")
                           + PORT_ONLY_SERIES):
            continue
        if "_seconds_bucket" in line:
            out.append(line.split("{")[0] + "{...}")
            continue
        out.append(_DURATION.sub(r"\1 <d>", line))
    return out


def _span_shape(path, port=False):
    """The trace's events as (name, args), span ids replaced by positions
    (each collector numbers its spans process-wide), the port's as the JAX
    package records them (torch_trace.as_jax_trace)."""
    events = [json.loads(line) for line in open(path)]
    if port:
        events = as_jax_trace(events)
    index = {ev["args"]["span_id"]: i for i, ev in enumerate(events)}
    out = []
    for ev in events:
        assert ev["ph"] == "X" and ev["pid"] == 1
        assert isinstance(ev["ts"], float) and isinstance(ev["dur"], float)
        args = {k: v for k, v in ev["args"].items() if k != "compile_s"}
        args["span_id"] = index[args["span_id"]]
        if "parent_id" in args:
            args["parent_id"] = index.get(args["parent_id"])
        out.append((ev["name"], args))
    return out


@pytest.mark.parametrize("flags", [
    ["--nodes", "-o", "json", "--no-bounds",
     "--inject-fault", "parallel.solve_group:oom:1:99"],
    ["--nodes", "--explain", "--drain", "kube-node-1,kube-node-2"],
], ids=["group-oom", "explain-drain"])
def test_cli_metrics_and_trace_match_jax(tmp_path, capsys, flags):
    """--metrics-dump and --trace-out: the same Prometheus series and
    values (durations masked) and the same span tree (names, sites, rungs,
    phases, batches, outcomes, parents) as the JAX CLI."""
    snap = os.path.join(REPO, "examples", "cluster-snapshot.yaml")
    got = {}
    for pkg, run, extra, obs_mod, reg in (
            ("j", jcli.run, [], jobs, jreg),
            ("t", tcli.run, ["--device", "cpu"], tobs, treg)):
        obs_mod.default_collector.reset()
        reg.reset()
        m, t = str(tmp_path / f"{pkg}.prom"), str(tmp_path / f"{pkg}.jsonl")
        rc = run(["--snapshot", snap, "--metrics-dump", m, "--trace-out", t]
                 + flags + extra)
        assert rc == 0
        got[pkg] = (capsys.readouterr().out, _masked_metrics(open(m).read()),
                    _span_shape(t, port=pkg == "t"))
    assert got["t"] == got["j"]
    text = "\n".join(got["t"][1])
    assert 'cc_resilience_scenarios{state="completed"}' in text
    assert "cc_guard_runs_total" in text


def test_hypercc_resilience_subcommand(tmp_path, capsys):
    argv = ["resilience", "--snapshot", _snap_file(tmp_path), "-o", "json",
            "--device", "cpu"]
    assert thypercc.run(argv) == 0
    data = json.loads(capsys.readouterr().out)
    assert [s["kind"] for s in data["status"]["scenarios"]] == ["node"] * 4
    # serve is dispatched now: without --snapshot argparse exits 2
    with pytest.raises(SystemExit) as ei:
        thypercc.run(["serve"])
    assert ei.value.code == 2
    assert "--snapshot" in capsys.readouterr().err
