"""The port's telemetry layer (obs/, utils/metrics.py, utils/trace.py)
against the JAX package's, mirroring tests/test_obs.py where it is not
about perfgate, trend or irgate.

The same drills run through both packages in one process: the span tree
of a ladder descent (names, sites, rungs, phases, outcomes, parents,
first-call marks), the metric series they leave (names, labels, counts;
durations masked), the trace-event JSONL keys, the Prometheus rendering,
the --watch loop's atomic telemetry rewrite, and CompileTally scoping fed
through the port's record_compile.  Tolerance: exact.
"""

import json
import os
import re
from types import SimpleNamespace

import pytest

from cluster_capacity_tpu import obs as jobs
from cluster_capacity_tpu.cli import cluster_capacity as jcli
from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.runtime import degrade as jdegrade
from cluster_capacity_tpu.runtime import faults as jfaults
from cluster_capacity_tpu.utils import metrics as jmetrics
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu.utils.events import default_recorder as jevents
from cluster_capacity_tpu_torch import obs
from cluster_capacity_tpu_torch.cli import cluster_capacity as tcli
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.obs import names as obs_names
from cluster_capacity_tpu_torch.obs import recompile as rc
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.runtime import degrade, faults
from cluster_capacity_tpu_torch.utils import metrics
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile
from cluster_capacity_tpu_torch.utils.events import default_recorder
from cluster_capacity_tpu_torch.utils.metrics import default_registry

from helpers import build_test_node, build_test_pod
from torch_trace import PORT_ONLY_SERIES, as_jax_spans, as_jax_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jreg = jmetrics.default_registry


def _reset():
    for f in (faults, jfaults):
        f.clear()
    for o, r, e in ((obs, default_registry, default_recorder),
                    (jobs, jreg, jevents)):
        o.default_collector.reset()
        r.reset()
        e.clear()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    _reset()
    yield
    _reset()


def _nodes(num_nodes=4, cpu=2000, pods=8):
    return [build_test_node(f"n{i}", cpu, 4 * 1024 ** 3, pods,
                            labels={"topology.kubernetes.io/zone":
                                    f"z{i % 2}"})
            for i in range(num_nodes)]


def _pbs(**kw):
    node_list = _nodes(**kw)
    probe = build_test_pod("probe", 500)
    return (jenc.encode_problem(JSnap.from_objects(node_list),
                                j_default_pod(probe), JProfile()),
            tenc.encode_problem(TSnap.from_objects(node_list),
                                t_default_pod(probe), TProfile()))


def _tree(spans):
    """Each span's name, site, rung, phase, batch, first-call mark and
    outcome, with its parent named by position: the tree without ids,
    threads or times."""
    index = {s.span_id: i for i, s in enumerate(spans)}
    return [(s.name, s.site, s.rung, s.phase, s.batch, s.first_call,
             s.outcome, index.get(s.parent_id)) for s in spans]


def _norm(events):
    """Trace events as (name, args) with span ids replaced by positions
    (each collector numbers its spans process-wide)."""
    index = {e["args"]["span_id"]: i for i, e in enumerate(events)}
    out = []
    for e in events:
        args = dict(e["args"], span_id=index[e["args"]["span_id"]])
        if "parent_id" in args:
            args["parent_id"] = index.get(args["parent_id"])
        args.pop("compile_s", None)
        out.append((e["name"], args))
    return out


_DURATION = re.compile(r"^(\S*_seconds(_total|_sum)?(\{[^}]*\})?) .*$")


def masked(text):
    """Prometheus text with every duration value masked (bucket counts of
    duration histograms too), without the compile counters, which the
    JAX package feeds from XLA's CPU compiles and the port's eager CPU run
    never touches, and without the series only the port records."""
    out = []
    for line in text.splitlines():
        if line.startswith(("cc_recompiles_total", "cc_compile_seconds")
                           + PORT_ONLY_SERIES):
            continue
        if "_seconds_bucket" in line:
            out.append(line.rsplit(" ", 1)[0])
            continue
        out.append(_DURATION.sub(r"\1 <d>", line))
    return out


# --- span collection ---------------------------------------------------------

@pytest.mark.parametrize("specs", [
    ("engine.solve:oom", "engine.fast_path:oom"),
    ("engine.solve:oom",),
    ("engine.solve:hang",),
    ("engine.solve:corrupt",),
    (),
], ids=["to-oracle", "to-fast-path", "hang", "corrupt", "healthy"])
def test_ladder_descent_span_tree_matches_jax(specs):
    """The ladder leaves the same span tree and the same metric series in
    both packages: one degrade.solve_one parent, one guard child per rung
    attempted, each closed with the fault code that ended it."""
    jpb, tpb = _pbs()
    with jfaults.inject(*specs):
        want = jdegrade.solve_one_guarded(jpb)
    with faults.inject(*specs):
        got = degrade.solve_one_guarded(tpb, device="cpu")
    assert (got.rung, got.degraded, got.placements) == \
        (want.rung, want.degraded, want.placements)
    assert _tree(as_jax_spans(obs.default_collector.spans())) == \
        _tree(jobs.default_collector.spans())
    assert masked(default_registry.render()) == masked(jreg.render())
    assert [(e.reason, e.message) for e in default_recorder.events] == \
        [(e.reason, e.message.replace(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate",
            "CUDA out of memory. Tried to allocate memory on the device"))
         for e in jevents.events]
    if specs == ("engine.solve:oom", "engine.fast_path:oom"):
        spans = {s.name: s for s in obs.default_collector.spans()}
        parent = spans["degrade.solve_one"]
        assert spans["guard:engine.solve"].outcome == "DeviceOOM"
        assert spans["guard:engine.oracle"].parent_id == parent.span_id
        assert default_registry.get(
            obs_names.FAULTS_INJECTED, site="engine.solve", kind="oom") == 1
        assert default_registry.get(
            obs_names.DEGRADATIONS, site="engine.solve", fault="DeviceOOM",
            to_rung=degrade.RUNG_FAST_PATH) == 1


def test_group_ladder_and_sweep_gauges_match_jax():
    """A sweep whose batched group OOMs on every attempt halves down to
    single templates and the per-item ladder: the span tree, the sweep
    gauges and the counters equal the JAX package's."""
    from cluster_capacity_tpu.parallel import sweep as jsweep
    node_list = _nodes(num_nodes=6)
    pods = [build_test_pod(f"t{i}", 300 + 100 * i, 0,
                           labels={"app": f"t{i}"}) for i in range(4)]
    for p in pods:
        p["spec"]["affinity"] = {"nodeAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [{
                "weight": 1, "preference": {"matchExpressions": [
                    {"key": "topology.kubernetes.io/zone",
                     "operator": "In", "values": ["z0"]}]}}]}}
    spec = "parallel.solve_group:oom:1:99"
    with jfaults.inject(spec):
        want = jsweep.sweep(JSnap.from_objects(node_list),
                            [j_default_pod(p) for p in pods],
                            profile=JProfile())
    with faults.inject(spec):
        got = tsweep.sweep(TSnap.from_objects(node_list),
                           [t_default_pod(p) for p in pods],
                           profile=TProfile(), device="cpu")
    assert [(r.placements, r.rung, r.degraded) for r in got] == \
        [(r.placements, r.rung, r.degraded) for r in want]
    assert _tree(as_jax_spans(obs.default_collector.spans())) == \
        _tree(jobs.default_collector.spans())
    assert masked(default_registry.render()) == masked(jreg.render())
    assert default_registry.get_gauge(obs_names.SWEEP_TEMPLATES) == 4


def test_rung_inheritance_and_first_call_match_jax():
    trees = []
    for c in (obs.Collector(), jobs.Collector()):
        with c.span("outer", rung="fused"):
            with c.span("inner", site="x.y"):
                pass
            with c.span("inner2", site="x.y", batch=3):
                pass
        trees.append(_tree(c.spans()))
    assert trees[0] == trees[1]
    inner, inner2 = trees[0][1], trees[0][2]
    assert inner[2] == "fused" and inner[5] and not inner2[5]


def test_span_buffer_bounded_like_jax():
    got = []
    for c in (obs.Collector(max_spans=8), jobs.Collector(max_spans=8)):
        for i in range(20):
            with c.span(f"s{i}"):
                pass
        got.append(([s.name for s in c.spans()], c.dropped))
    assert got[0] == got[1] == ([f"s{i}" for i in range(12, 20)], 12)


def test_guard_span_outcome_and_histogram_match_jax():
    for mod in (obs, jobs):
        with pytest.raises(ValueError):
            with mod.guard_span(site="t.site", phase="execute", rung="fused"):
                raise ValueError("boom")
    assert default_registry.get(
        obs_names.GUARD_RUNS, site="t.site", rung="fused", phase="execute",
        outcome="ValueError") == 1
    assert masked(default_registry.render()) == masked(jreg.render())


# --- metrics rendering -------------------------------------------------------

def test_prometheus_render_matches_jax():
    """The registry's exposition text is the JAX package's, byte for byte,
    for the same series (tests/test_obs.py's golden drill)."""
    texts = []
    for mod in (metrics, jmetrics):
        reg = mod.Registry()
        reg.inc(obs_names.GUARD_RUNS, outcome="DeviceOOM",
                site="engine.solve", rung="fused", phase="execute",
                amount=2.0)
        reg.inc(obs_names.GUARD_RUNS, outcome="ok", site="engine.solve",
                rung="fused", phase="execute")
        reg.set_gauge(obs_names.SWEEP_GROUPS, 3, mode="batched")
        reg.observe(obs_names.GUARD_DURATION, 0.0015, site="engine.solve",
                    rung="fused", phase="execute")
        reg.observe(obs_names.GUARD_DURATION, 5.0, site="engine.solve",
                    rung="fused", phase="execute")
        reg.observe(mod.SCHEDULING_DURATION, 0.2)
        texts.append(reg.render())
    assert texts[0] == texts[1]
    assert 'cc_sweep_groups{mode="batched"} 3' in texts[0]
    assert (metrics.SCHEDULE_ATTEMPTS, metrics.SCHEDULING_DURATION,
            metrics.PENDING_PODS, metrics.FRAMEWORK_EXTENSION_POINT_DURATION
            ) == (jmetrics.SCHEDULE_ATTEMPTS, jmetrics.SCHEDULING_DURATION,
                  jmetrics.PENDING_PODS,
                  jmetrics.FRAMEWORK_EXTENSION_POINT_DURATION)
    assert metrics._LATENCY_BUCKETS == jmetrics._LATENCY_BUCKETS


def test_names_match_jax():
    from cluster_capacity_tpu.obs import names as jnames
    assert {k: v for k, v in vars(obs_names).items() if k.isupper()} == \
        {k: v for k, v in vars(jnames).items() if k.isupper()}


def test_render_is_valid_prometheus_text():
    _jpb, tpb = _pbs()
    with faults.inject("engine.solve:oom"):
        degrade.solve_one_guarded(tpb, device="cpu")
    text = default_registry.render()
    line_re = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
        r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*='
        r'"[^"]*")*\})? -?(\d+(\.\d+)?([eE][+-]?\d+)?|\+?Inf|NaN)$')
    assert "cc_guard_run_duration_seconds_bucket" in text
    for line in text.splitlines():
        assert line_re.match(line), f"not Prometheus text: {line!r}"


# --- trace export ------------------------------------------------------------

def test_trace_export_jsonl_matches_jax(tmp_path):
    """Trace-event JSONL: the same events with the same keys and args
    (span ids, parents, sites, rungs, outcomes) as the JAX package's;
    timestamps, durations and thread ids are each package's own."""
    jpb, tpb = _pbs()
    spec = ("engine.solve:oom", "engine.fast_path:oom")
    with jfaults.inject(*spec):
        jdegrade.solve_one_guarded(jpb)
    with faults.inject(*spec):
        degrade.solve_one_guarded(tpb, device="cpu")
    events = []
    for mod, name in ((obs, "t"), (jobs, "j")):
        path = tmp_path / f"{name}.jsonl"
        n = mod.write_trace(str(path))
        lines = path.read_text().splitlines()
        assert n == len(lines) >= 4
        events.append([json.loads(line) for line in lines])
    assert _norm(as_jax_trace(events[0])) == _norm(events[1])
    for got, want in zip(*events):
        assert sorted(got) == sorted(want)
        assert (got["ph"], got["pid"]) == (want["ph"], want["pid"])
        assert isinstance(got["ts"], float) and isinstance(got["dur"], float)


# --- the CLI -------------------------------------------------------------

def _cli_both(tmp_path, capsys, flags):
    out = {}
    for pkg, run, extra in (("j", jcli.run, []),
                            ("t", tcli.run, ["--device", "cpu"])):
        _reset()
        m, t = str(tmp_path / f"{pkg}.prom"), str(tmp_path / f"{pkg}.jsonl")
        rc_ = run(["--podspec", os.path.join(REPO, "examples", "pod.yaml"),
                   "--snapshot", os.path.join(REPO, "examples",
                                              "cluster-snapshot.yaml"),
                   "--metrics-dump", m, "--trace-out", t] + flags + extra)
        cap = capsys.readouterr()
        events = [json.loads(line) for line in open(t)]
        if pkg == "t":
            events = as_jax_trace(events, cli_snapshot=True)
        out[pkg] = (rc_, cap.out, masked(open(m).read()), _norm(events))
    return out


@pytest.mark.parametrize("flags", [
    [],
    ["--inject-fault", "engine.solve:oom", "-o", "json"],
    ["--podspec", os.path.join(REPO, "examples", "pod-spec.yaml")],
    ["--explain", "--verbose"],
], ids=["solve", "oom", "sweep", "explain"])
def test_cli_telemetry_matches_jax(tmp_path, capsys, flags):
    """The main CLI's --metrics-dump and --trace-out: the same report, the
    same series (durations masked) and the same spans as the JAX CLI."""
    out = _cli_both(tmp_path, capsys, flags)
    strip = re.compile(r'"creationTimestamp": "[^"]*"')
    assert out["t"][0] == out["j"][0] == 0
    assert strip.sub("", out["t"][1]) == strip.sub("", out["j"][1])
    assert out["t"][2:] == out["j"][2:]


def test_cli_trace_and_metrics_flags(tmp_path, capsys):
    """--trace prints the phase spans to stderr, --metrics the registry;
    no flag is refused any more, and --mesh records the sharded rung's
    guard span with the mesh shape."""
    args = ["--podspec", os.path.join(REPO, "examples", "pod.yaml"),
            "--snapshot", os.path.join(REPO, "examples",
                                       "cluster-snapshot.yaml"),
            "--device", "cpu"]
    from cluster_capacity_tpu_torch.utils.trace import default_tracer
    try:
        assert tcli.run(args + ["--trace", "--metrics"]) == 0
    finally:
        default_tracer.enabled = False
    err = capsys.readouterr().err
    assert 'Trace: "Running placement scan" took' in err
    assert "scheduler_schedule_attempts_total" in err
    assert tcli.run(args + ["--mesh", "2x4"]) == 0
    assert capsys.readouterr().out == "52\n"
    spans = [sp for sp in obs.default_collector.spans()
             if sp.site == "parallel.sharded"]
    assert spans and spans[-1].rung == "sharded_batched"
    assert spans[-1].attrs["mesh_shape"] == {"batch": 2, "nodes": 4}


def test_watch_loop_rewrites_telemetry_atomically(tmp_path):
    """--period loop: the metrics/trace dumps are rewritten inside the loop
    (temp + rename) and no .tmp residue survives the run."""
    mpath = str(tmp_path / "metrics.prom")
    tpath = str(tmp_path / "trace.jsonl")
    seen = []
    real_replace = os.replace

    def spy(src, dst):
        seen.append(dst)
        return real_replace(src, dst)

    os.replace = spy
    try:
        rc_ = tcli.run([
            "--podspec", os.path.join(REPO, "examples", "pod.yaml"),
            "--snapshot", os.path.join(REPO, "examples",
                                       "cluster-snapshot.yaml"),
            "--period", "0.01", "--period-iterations", "2", "--watch",
            "--metrics-dump", mpath, "--trace-out", tpath, "--device", "cpu"])
    finally:
        os.replace = real_replace
    assert rc_ == 0
    # each iteration rewrites both, then the final dump rewrites both again
    assert seen.count(mpath) == 3 and seen.count(tpath) == 3
    assert not os.path.exists(mpath + ".tmp")
    assert not os.path.exists(tpath + ".tmp")
    with open(mpath, encoding="utf-8") as fh:
        assert 'scheduler_schedule_attempts_total' in fh.read()
    with open(tpath, encoding="utf-8") as fh:
        names = [json.loads(line)["name"] for line in fh if line.strip()]
    assert names.count("degrade.solve_one") == 2


# --- compile accounting ------------------------------------------------------

def test_compile_tally_scoped_through_record_compile():
    """CompileTally counts only the compiles recorded inside its scope;
    record_compile feeds the counters and the open sited span."""
    with rc.CompileTally() as outside:
        pass
    before = default_registry.counter_total(obs_names.RECOMPILES)
    with rc.CompileTally() as tally:
        with obs.span("holder", site="test.compile") as sp:
            rc.record_compile(0.25)
        rc.record_compile(0.5)
    rc.record_compile(1.0)
    assert (tally.count, tally.seconds) == (2, 0.75)
    assert (outside.count, outside.seconds) == (0, 0.0)
    assert rc._tallies == []
    assert sp.compile_s == 0.25
    assert default_registry.counter_total(obs_names.RECOMPILES) == before + 3
    assert default_registry.counter_total(obs_names.COMPILE_SECONDS) >= 1.75
    assert rc.installed() and not rc.install_recompile_hook()


def test_cpu_solve_compiles_nothing():
    """An eager CPU solve builds no kernel and captures no graph, so the
    compile counter stays where it was (the JAX package counts XLA's CPU
    compiles here; a deliberate difference)."""
    obs.install_recompile_hook()
    before = default_registry.counter_total(obs_names.RECOMPILES)
    _jpb, tpb = _pbs()
    degrade.solve_one_guarded(tpb, device="cpu")
    assert default_registry.counter_total(obs_names.RECOMPILES) == before


def test_explain_records_metrics_like_jax():
    """build_explanation counts cc_explains_total{rung} and sets the
    per-reason node gauges, as the JAX package does."""
    jpb, tpb = _pbs(num_nodes=3, cpu=1000)
    jdegrade.solve_one_guarded(jpb, explain=True)
    degrade.solve_one_guarded(tpb, explain=True, device="cpu")
    assert masked(default_registry.render()) == masked(jreg.render())
    assert default_registry.counter_total(obs_names.EXPLAINS) == 1
    assert default_registry.get_gauge(obs_names.EXPLAIN_REASON_NODES,
                                      reason="Insufficient cpu") == 3


# --- spans inside the port: clocks, costs, identifiers -----------------------

def _spans_named(prefix=""):
    return [s for s in obs.default_collector.spans()
            if s.name.startswith(prefix)]


def test_gc_pause_charged_once_to_the_inner_span():
    """A collection inside nested spans is charged to the innermost span
    open on the collecting thread, once; a collection with no span open is
    charged to none."""
    import gc
    with obs.span("outer") as outer:
        with obs.span("inner") as inner:
            gc.collect()
        with obs.span("sibling") as sibling:
            pass
    gc.collect()
    assert (inner.gc_n, outer.gc_n, sibling.gc_n) == (1, 0, 0)
    assert 0 < inner.gc_s <= inner.duration_s
    assert outer.gc_s == sibling.gc_s == 0.0
    args = {e["name"]: e["args"] for e in obs.trace_events()}
    assert args["inner"]["gc_n"] == 1 and args["inner"]["gc_s"] >= 0
    assert "gc_n" not in args["outer"] and "gc_s" not in args["outer"]


def test_spans_keep_the_perf_counter_and_the_epoch():
    import time
    before_pc, before_epoch = time.perf_counter(), time.time()
    with obs.span("timed") as sp:
        pass
    assert before_pc <= sp.perf_start <= sp.perf_end <= time.perf_counter()
    assert sp.duration_s == sp.perf_end - sp.perf_start
    assert abs(sp.start_s - before_epoch) < 1.0
    ev = obs.trace_events([sp])[0]
    assert ev["ts"] == pytest.approx(sp.start_s * 1e6)


def test_profiler_mirrors_spans_as_user_annotations(tmp_path, monkeypatch):
    """Under a CPU torch.profiler each span is a record_function range of
    its name, on the trace's clock and nested in the range around it; with
    no profiler running no range is opened."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from cluster_capacity_tpu_torch.obs import spans as spans_mod
    opened = []
    real = spans_mod._profiler_range
    monkeypatch.setattr(spans_mod, "_profiler_range",
                        lambda name: opened.append(name) or real(name))
    with obs.span("idle.outer"):
        with obs.span("idle.inner"):
            pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.outer"):
            with obs.span("mirror.outer"):
                with obs.span("mirror.inner"):
                    torch.ones(4).add_(1)
    assert opened == ["mirror.outer", "mirror.inner"]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events["traceEvents"]
    marks = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"}
    for inner, outer in (("mirror.outer", "bench.outer"),
                         ("mirror.inner", "mirror.outer")):
        assert marks[outer][0] <= marks[inner][0] <= marks[inner][1] \
            <= marks[outer][1], (inner, outer)
    assert "idle.outer" not in marks


def _estimate(num_nodes=4, lower=False):
    """A tiny estimate that ends Unschedulable; with `lower`, each node
    holds a resident of the probe's priority and a smaller one that ranks
    below it, whose eviction would not make room."""
    from cluster_capacity_tpu_torch.framework import ClusterCapacity
    probe = build_test_pod("probe", 500)
    residents = []
    if lower:
        probe["spec"]["priority"] = 10
        for i in range(num_nodes):
            peer = build_test_pod(f"peer{i}", 1300, node_name=f"n{i}")
            peer["spec"]["priority"] = 10
            residents += [peer, build_test_pod(f"low{i}", 100,
                                               node_name=f"n{i}")]
    cc = ClusterCapacity(probe, device="cpu")
    cc.sync_with_objects(_nodes(num_nodes=num_nodes), residents)
    obs.default_collector.reset()
    result = cc.run()
    return cc, result


def test_one_run_shares_one_trace_id():
    """Every span of one ClusterCapacity.run() descends from its root and
    carries the root's id as trace_id, in the collector and the export.
    Lower-priority residents make the dry run open its children too."""
    _cc, result = _estimate(lower=True)
    assert result.fail_type == "Unschedulable"
    spans = obs.default_collector.spans()
    roots = [s for s in spans if s.parent_id is None]
    assert len(roots) == 1 and len(spans) > 5
    assert {s.trace_id for s in spans} == {roots[0].span_id}
    assert {e["args"]["trace_id"] for e in obs.trace_events()} == \
        {roots[0].span_id}


@pytest.mark.parametrize("lower", [False, True])
def test_dryrun_spans_split_the_cycles_evaluate(lower):
    """An estimate that ends Unschedulable opens preemption.dryrun, no
    longer than the cycle's evaluate.  Where no resident ranks below the
    probe it takes the no_candidate path and opens no child; where one
    does, the full dry run holds clones, filter and pick, each shorter than
    it.  The encode and the snapshot have spans of their own names."""
    from cluster_capacity_tpu_torch.utils.trace import (SPAN_ENCODE,
                                                        SPAN_SNAPSHOT)
    cc, result = _estimate(lower=lower)
    assert result.placed_count > 0
    by_name = {s.name: s for s in _spans_named()}
    dry = by_name["preemption.dryrun"]
    children = ("preemption.clones", "preemption.filter", "preemption.pick")
    assert dry.duration_s <= cc.cycle_seconds[-1]["evaluate"]
    if not lower:
        assert dry.attrs == {"path": "no_candidate",
                             "lower_priority_pods": 0}
        assert not set(children) & set(by_name)
    else:
        assert dry.attrs == {"path": "full", "lower_priority_pods": 1}
        for child in children:
            assert by_name[child].parent_id == dry.span_id
            assert by_name[child].duration_s < dry.duration_s
        assert by_name["preemption.filter"].attrs == {
            "nodes": 4, "no_victims": 0, "candidates": 0,
            "engine": "table", "rows_rebuilt": 4}
    assert SPAN_ENCODE in by_name and SPAN_SNAPSHOT not in by_name


def test_sync_with_objects_opens_the_snapshot_span():
    from cluster_capacity_tpu_torch.framework import ClusterCapacity
    from cluster_capacity_tpu_torch.utils.trace import SPAN_SNAPSHOT
    cc = ClusterCapacity(build_test_pod("probe", 500), device="cpu")
    cc.sync_with_objects(_nodes())
    assert [s.name for s in obs.default_collector.spans()] == [SPAN_SNAPSHOT]


def test_every_snapshot_build_is_one_span_with_its_collections(
        monkeypatch):
    """ClusterSnapshot.from_objects, whoever calls it, runs in one snapshot
    span, and a collection during the build is charged to that span."""
    import gc
    from cluster_capacity_tpu_torch.utils.trace import SPAN_SNAPSHOT
    real = TSnap._from_objects.__func__

    def collecting(cls, *a, **kw):
        gc.collect()
        return real(cls, *a, **kw)
    monkeypatch.setattr(TSnap, "_from_objects", classmethod(collecting))
    snap = TSnap.from_objects(_nodes())
    assert snap.node_names
    (sp,) = obs.default_collector.spans()
    assert sp.name == SPAN_SNAPSHOT and sp.parent_id is None
    assert sp.gc_n == 1 and 0 < sp.gc_s <= sp.duration_s


def test_cli_trace_holds_one_snapshot_span(tmp_path):
    from cluster_capacity_tpu_torch.utils.trace import SPAN_SNAPSHOT
    t = str(tmp_path / "t.jsonl")
    assert tcli.run(["--podspec", os.path.join(REPO, "examples", "pod.yaml"),
                     "--snapshot", os.path.join(REPO, "examples",
                                                "cluster-snapshot.yaml"),
                     "--trace-out", t, "--device", "cpu"]) == 0
    names = [json.loads(line)["name"] for line in open(t)]
    assert names.count(SPAN_SNAPSHOT) == 1


def test_cpu_race_records_replay_wait_and_drain():
    """The interleave race on the CPU: every chunk runs its eager steps in
    steps.replay, then interleave.wait and interleave.drain, all under the
    guard span of the race and in its trace."""
    from cluster_capacity_tpu_torch.parallel import interleave as til
    snap = TSnap.from_objects(_nodes(num_nodes=6, pods=40))
    templates = [t_default_pod(build_test_pod(f"t{i}", 100 * (i + 1), 0,
                                              labels={"app": f"t{i}"}))
                 for i in range(3)]
    results = til.sweep_interleaved_auto(snap, templates, TProfile(),
                                         max_total=60, device="cpu")
    assert sum(r.placed_count for r in results) == 60
    spans = obs.default_collector.spans()
    guard = [s for s in spans if s.site == faults.SITE_INTERLEAVE]
    assert len(guard) == 1
    names = [s.name for s in spans]
    chunks = names.count("interleave.wait")
    assert chunks >= 60 // til.CPU_CHUNK
    assert names.count("interleave.drain") == chunks
    assert names.count("steps.replay") == chunks
    assert names.count("interleave.encode") == 2    # templates, group
    for s in spans:
        if s.name.startswith(("steps.", "interleave.")):
            assert s.trace_id == guard[0].trace_id
            assert s.duration_s is not None and s.duration_s >= 0


def test_watchdog_spans_hang_from_the_callers_span():
    """A deadline call runs on a watchdog thread; the spans it opens there
    take the caller's guard span as their parent."""
    from cluster_capacity_tpu_torch.runtime import guard

    def work():
        with obs.span("on.worker") as sp:
            return sp

    with obs.span("caller") as caller:
        sp = guard.run(work, site="test.watchdog", deadline=30.0)
    gspan = next(s for s in obs.default_collector.spans()
                 if s.site == "test.watchdog")
    assert sp.thread_id != caller.thread_id
    assert sp.parent_id == gspan.span_id
    assert gspan.parent_id == caller.span_id
    assert sp.trace_id == caller.trace_id == caller.span_id


def test_compiles_charge_the_span_without_the_hook(monkeypatch):
    """record_compile charges the open sited span's compile_s and
    compiles whether or not install_recompile_hook() ran; the counters
    stay opt-in."""
    monkeypatch.setattr(rc, "_installed", False)
    before = default_registry.counter_total(obs_names.RECOMPILES)
    with obs.span("holder", site="test.compile") as sp:
        rc.record_compile(0.25)
        rc.record_compile(0.5)
    rc.record_compile(1.0)
    assert (sp.compiles, sp.compile_s) == (2, 0.75)
    assert default_registry.counter_total(obs_names.RECOMPILES) == before
    args = obs.trace_events([sp])[0]["args"]
    assert (args["compiles"], args["compile_s"]) == (2, 0.75)


# --- InterPodAffinity: the encoder's span and counter, the kernel's planes ---

def _host_nodes(num_nodes=4):
    return [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 8,
                            labels={"topology.kubernetes.io/zone":
                                    f"z{i % 2}",
                                    "kubernetes.io/hostname": f"n{i}"})
            for i in range(num_nodes)]


def _ipa_pod(name, node="", labels=None, affinity=None, namespace="default"):
    pod = build_test_pod(name, 100, node_name=node, labels=labels or {},
                         namespace=namespace)
    if affinity:
        pod["spec"]["affinity"] = affinity
    return pod


def _soft_anti():
    return {"podAntiAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution": [{
            "weight": 1, "podAffinityTerm": {
                "labelSelector": {"matchLabels": {"foo": ""}},
                "topologyKey": "kubernetes.io/hostname",
                "namespaces": ["sched-1", "sched-0"]}}]}}


def _hard_zone_anti():
    return {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"app": "web"}},
            "topologyKey": "topology.kubernetes.io/zone"}]}}


# (pod, residents) -> path, ipa.encode's attrs (None: no span)
_IPA_CASES = {
    "trivial": (lambda: _ipa_pod("p"),
                lambda: [_ipa_pod("r0", "n0")], "trivial", None),
    # a resident's required zone anti-affinity matches the pod: a static
    # mask, no group of the pod's own
    "indexed": (lambda: _ipa_pod("p", labels={"app": "web"}),
                lambda: [_ipa_pod("r0", "n0", affinity=_hard_zone_anti()),
                         _ipa_pod("r1", "n1")],
                "indexed", {"groups": 0, "domains": 0, "pod_terms": 0,
                            "resident_terms": 1, "residents_read": 1}),
    # the published template on both sides: every resident read
    "pod_terms": (lambda: _ipa_pod("p", labels={"foo": ""},
                                   affinity=_soft_anti(),
                                   namespace="sched-1"),
                  lambda: [_ipa_pod(f"r{i}", f"n{i}", labels={"foo": ""},
                                    affinity=_soft_anti(),
                                    namespace="sched-0") for i in range(3)]
                  + [_ipa_pod("r3", "n3")],
                  "pod_terms", {"groups": 1, "domains": 4, "pod_terms": 1,
                                "resident_terms": 3, "residents_read": 4}),
}


@pytest.mark.parametrize("case", sorted(_IPA_CASES))
def test_ipa_encode_span_and_counter(case):
    """Every encode counts once in cc_ipa_encodes_total by its path; the
    non-trivial ones run in an ipa.encode span inside the encode span,
    whose attrs count the groups, their domains, the pod's terms, the
    residents' terms that match the pod and the residents read."""
    from cluster_capacity_tpu_torch.ops import inter_pod_affinity as tipa
    make_pod, make_residents, path, attrs = _IPA_CASES[case]
    snap = TSnap.from_objects(_host_nodes(), make_residents())
    with obs.span("test.encode") as outer:
        tipa.encode(snap, make_pod())
    assert default_registry.get(metrics.IPA_ENCODES, path=path) == 1
    assert default_registry.counter_total(metrics.IPA_ENCODES) == 1
    spans = _spans_named("ipa.encode")
    assert outer.attrs["ipa_path"] == ("trivial" if path == "trivial"
                                       else "indexed")
    if attrs is None:
        assert spans == []
        return
    assert len(spans) == 1 and spans[0].parent_id == outer.span_id
    assert spans[0].attrs == attrs
    assert outer.attrs["ipa_residents_read"] == attrs["residents_read"]


@pytest.mark.parametrize("case,groups,planes", [
    ("zone_spread", 0, []),
    ("preferred_anti", 1, ["preferred"]),
    ("required_anti", 1, ["filter", "anti_affinity"])])
def test_kernel_drive_span_names_the_live_ipa_planes(case, groups, planes):
    """Kernel 1's drive runs in fused.launch under Running placement scan,
    its attrs InterPodAffinity's groups and live planes."""
    from cluster_capacity_tpu_torch.framework import ClusterCapacity
    from cluster_capacity_tpu_torch.utils.trace import SPAN_SOLVE
    affinity = {"zone_spread": None, "preferred_anti": _soft_anti(),
                "required_anti": _hard_zone_anti()}[case]
    pod = _ipa_pod("p", labels={"foo": "", "app": "web"}, affinity=affinity,
                   namespace="sched-1")
    if case == "zone_spread":        # kernel 1 without InterPodAffinity
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "web"}}}]
    cc = ClusterCapacity(pod, max_limit=3, device="cpu")
    cc.sync_with_objects(_host_nodes())
    obs.default_collector.reset()
    result = cc.run()
    assert result.placed_count == (2 if case == "required_anti" else 3)
    (launch,) = _spans_named("fused.launch")
    assert launch.attrs == {"ipa_groups": groups, "ipa_planes": planes,
                            "ss_rows": 0, "ss_hostname_rows": 0}
    by_id = {s.span_id: s for s in obs.default_collector.spans()}
    up = launch
    while up.parent_id is not None and up.name != SPAN_SOLVE:
        up = by_id[up.parent_id]
    assert up.name == SPAN_SOLVE


# --- PodTopologySpread: the encoder's span and counter, the kernel's rows ---

_ZONE = "topology.kubernetes.io/zone"
_HOST = "kubernetes.io/hostname"


def _spread(key, skew, action, labels=None, exprs=None):
    sel = {"matchLabels": labels} if labels is not None else \
        {"matchExpressions": exprs}
    return {"maxSkew": skew, "topologyKey": key, "whenUnsatisfiable": action,
            "labelSelector": sel}


_BLUE_IN = [{"key": "color", "operator": "In", "values": ["blue"]}]
_WEB_SVC = {"metadata": {"name": "web", "namespace": "default"},
            "spec": {"selector": {"app": "web"}}}


def _spread_pod(*constraints):
    pod = _ipa_pod("p", labels={"color": "blue", "app": "web"})
    if constraints:
        pod["spec"]["topologySpreadConstraints"] = list(constraints)
    return pod


# kind -> (the pod, the encode that runs, pts.encode's attrs); the
# cluster: 4 nodes in two zones, 3 residents
_PTS_CASES = {
    "hard": (lambda: _spread_pod(_spread(_ZONE, 1, "DoNotSchedule",
                                         {"color": "blue"})),
             lambda tpts, snap, pod: tpts.encode_constraints(
                 snap, pod, "DoNotSchedule"),
             {"constraints": 1, "hostname_rows": 0, "domains": 2,
              "residents_read": 3}),
    "soft": (lambda: _spread_pod(_spread(_ZONE, 5, "ScheduleAnyway",
                                         exprs=_BLUE_IN),
                                 _spread(_HOST, 2, "ScheduleAnyway",
                                         exprs=_BLUE_IN)),
             lambda tpts, snap, pod: tpts.encode_constraints(
                 snap, pod, "ScheduleAnyway"),
             {"constraints": 2, "hostname_rows": 1, "domains": 2 + 4,
              "residents_read": 6}),
    "system_default": (lambda: _spread_pod(),
                       lambda tpts, snap, pod: tpts.encode_system_default(
                           snap, pod),
                       {"constraints": 2, "hostname_rows": 1,
                        "domains": 4 + 2, "residents_read": 6}),
    "empty": (lambda: _spread_pod(),
              lambda tpts, snap, pod: tpts.encode_constraints(
                  snap, pod, "DoNotSchedule"),
              {"constraints": 0, "hostname_rows": 0, "domains": 0,
               "residents_read": 0}),
}


@pytest.mark.parametrize("case", sorted(_PTS_CASES))
def test_spread_encode_span_and_counter(case):
    """Every PodTopologySpread encode counts once in
    cc_spread_encodes_total by its kind and runs in a pts.encode span
    inside the span open over it, whose attrs count the constraints, the
    hostname rows, the domains summed over the rows and the residents
    read."""
    from cluster_capacity_tpu_torch.ops import pod_topology_spread as tpts
    make_pod, encode, attrs = _PTS_CASES[case]
    kind = "hard" if case == "empty" else case
    residents = [_ipa_pod("r0", "n0", labels={"color": "blue"}),
                 _ipa_pod("r1", "n1", labels={"app": "web"}),
                 _ipa_pod("r2", "n2")]
    snap = TSnap.from_objects(_host_nodes(), residents, services=[_WEB_SVC])
    with obs.span("test.encode") as outer:
        got = encode(tpts, snap, make_pod())
    assert got.num_constraints == attrs["constraints"]
    assert default_registry.get(metrics.SPREAD_ENCODES, kind=kind) == 1
    assert default_registry.counter_total(metrics.SPREAD_ENCODES) == 1
    (span,) = _spans_named("pts.encode")
    assert span.parent_id == outer.span_id
    assert span.attrs == dict(attrs, kind=kind)


def test_system_default_constraints_are_upstreams():
    """A pod that a Service selects and that declares no constraint gets
    upstream's systemDefaultConstraints: hostname maxSkew 3, zone maxSkew
    5, both ScheduleAnyway, with the Service's selector; a pod that no
    Service selects gets none."""
    from cluster_capacity_tpu_torch.engine.encode import encode_problem
    from cluster_capacity_tpu_torch.ops import pod_topology_spread as tpts
    snap = TSnap.from_objects(_host_nodes(), [], services=[_WEB_SVC])
    assert [(c["topologyKey"], c["maxSkew"], c["whenUnsatisfiable"])
            for c in tpts.SYSTEM_DEFAULT_CONSTRAINTS] == [
        (_HOST, 3, "ScheduleAnyway"), (_ZONE, 5, "ScheduleAnyway")]
    ss = encode_problem(snap, t_default_pod(_spread_pod()),
                        TProfile()).spread_soft
    assert ss.topology_keys == [_HOST, _ZONE]
    assert ss.max_skew.tolist() == [3.0, 5.0]
    assert ss.is_hostname.tolist() == [True, False]
    assert ss.selectors == [{"matchLabels": {"app": "web"}}] * 2
    other = _ipa_pod("q", labels={"app": "db"})
    assert encode_problem(snap, t_default_pod(other),
                          TProfile()).spread_soft.num_constraints == 0


@pytest.mark.parametrize("case,rows,host_rows", [
    ("zone", 1, 0), ("zone_and_hostname", 2, 1), ("system_default", 2, 1),
    ("hard_only", 0, 0)])
def test_kernel_drive_span_counts_the_soft_spread_rows(case, rows,
                                                       host_rows):
    """fused.launch's ss_rows and ss_hostname_rows on the CPU's plain
    version: the soft rows in the kernel's planes, 0 where none is
    live."""
    from cluster_capacity_tpu_torch.framework import ClusterCapacity
    soft_zone = _spread(_ZONE, 5, "ScheduleAnyway", exprs=_BLUE_IN)
    pod = {"zone": lambda: _spread_pod(soft_zone),
           "zone_and_hostname": lambda: _spread_pod(
               soft_zone, _spread(_HOST, 2, "ScheduleAnyway",
                                  exprs=_BLUE_IN)),
           "system_default": lambda: _spread_pod(),
           "hard_only": lambda: _spread_pod(_spread(
               _ZONE, 1, "DoNotSchedule", {"color": "blue"}))}[case]()
    cc = ClusterCapacity(pod, max_limit=3, device="cpu")
    cc.sync_with_objects(_host_nodes(), services=[_WEB_SVC])
    obs.default_collector.reset()
    assert cc.run().placed_count == 3
    (launch,) = _spans_named("fused.launch")
    assert (launch.attrs["ss_rows"], launch.attrs["ss_hostname_rows"]) == \
        (rows, host_rows)


# the cluster slots an H100 reported for the kernels' full blocks
_H100_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


@pytest.fixture
def card_stand_in(monkeypatch):
    """The CPU runs kernel 1's plain version and launches nothing, so the
    card is stood in for: its cluster slots, and a launch that plans as
    fused_steps does and then runs the plain version.  Yields the plans
    of the launches."""
    from cluster_capacity_tpu_torch.engine import fused as tfused
    plain = tfused.fused_steps
    plans = []

    def launch(const, carry, scalars, table, k, cluster=None):
        shape = (const.shape[1] * tfused.LANES, const.shape[0],
                 carry.shape[0])
        plan = tfused.card_plan(*shape, 1, cluster)
        assert plan == tfused.launch_plan(*shape, slots=_H100_SLOTS)
        plans.append(plan)
        tfused.LAUNCHES += 1
        tfused.LAST_PLAN = plan
        return plain(const, carry, scalars, table, k)

    monkeypatch.setattr(tfused, "cluster_slots", lambda: _H100_SLOTS)
    monkeypatch.setattr(tfused, "fused_steps", launch)
    monkeypatch.setattr(tfused, "LAUNCHES", tfused.LAUNCHES)
    monkeypatch.setattr(tfused, "LAST_PLAN", tfused.LAST_PLAN)
    return plans


# a step reduces the hard spread's minimum, the normalisers and the argmax
@pytest.mark.parametrize("num_nodes,cluster,lanes,reduce,reductions", [
    (4, 1, 128, "cta", 3), (2000, 8, 256, "push", 3)])
def test_kernel_drive_span_carries_the_launch_plan(
        card_stand_in, num_nodes, cluster, lanes, reduce, reductions):
    """Where kernel 1 launches, fused.launch carries the cluster size and
    the node lanes per CTA of the launches' plan, how a cluster-wide
    reduction gathers the CTAs' partials (`push` at C > 1, `cta` at
    C = 1) and the cluster-wide reductions a placing step runs."""
    from cluster_capacity_tpu_torch.framework import ClusterCapacity
    plans = card_stand_in
    pod = _ipa_pod("p", labels={"app": "web"})
    pod["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "web"}}}]
    cc = ClusterCapacity(pod, max_limit=3, device="cpu")
    cc.sync_with_objects(_host_nodes(num_nodes))
    obs.default_collector.reset()
    assert cc.run().placed_count == 3
    (launch_span,) = _spans_named("fused.launch")
    assert plans and set(plans) == {plans[-1]}
    assert (plans[-1].cluster, plans[-1].lanes) == (cluster, lanes)
    assert launch_span.attrs == {"ipa_groups": 0, "ipa_planes": [],
                                 "ss_rows": 0, "ss_hostname_rows": 0,
                                 "cluster": cluster, "lanes": lanes,
                                 "reduce": reduce,
                                 "reductions_per_step": reductions}


def _tiny_cell_answer(config, mix, limit):
    """One answer of a benchmark cell at its tiny cut
    (portbench/tests/portbench_tiny.py), on the CPU."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "portbench_tiny", os.path.join(REPO, "portbench", "tests",
                                       "portbench_tiny.py"))
    pt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pt)
    from portbench import harness
    from portbench.entries import estimate
    from portbench.reference import cluster as gen
    cell = SimpleNamespace(
        config=pt.tiny_copy("configs", config,
                            harness.load_json("configs", config)),
        traffic=pt.tiny_copy("traffic", mix,
                             harness.load_json("traffic", mix)))
    data = gen.make_objects(cell.config, cell.traffic, 2 ** 31 + 5)
    obs.default_collector.reset()
    ans = estimate.answer(cell, data, limit, "cpu")
    assert ans.placed == limit
    (launch,) = _spans_named("fused.launch")
    return launch


# the cells whose answers kernel 1 sets the pace of: a step runs the hard
# spread's minimum, the normalisers' and the argmax (.spread); the
# normalisers', which carry IPA's min/max, and the argmax (.prefanti);
# the normalisers', the soft spread's min/max and the argmax (.prefspread)
_KERNEL_CELLS = [("k8s-5000n", "spread", 3),
                 ("k8s-5000n-prefanti", "prefanti", 2),
                 ("k8s-5000n-prefspread", "prefspread", 3)]


@pytest.mark.parametrize("config,mix,reductions", _KERNEL_CELLS,
                         ids=[c[0] for c in _KERNEL_CELLS])
def test_kernel_drive_span_counts_the_cells_reductions(card_stand_in,
                                                       config, mix,
                                                       reductions):
    """The benchmark's kernel-1 cells at their tiny cuts: where the kernel
    launches, fused.launch carries the reductions a placing step of the
    cell's template runs; its one CTA of 128 lanes gathers them inside
    the CTA."""
    launch = _tiny_cell_answer(config, mix, 4)
    assert card_stand_in and card_stand_in[-1].cluster == 1
    assert (launch.attrs["reduce"], launch.attrs["reductions_per_step"]) \
        == ("cta", reductions)


@pytest.mark.parametrize("config,mix", [c[:2] for c in _KERNEL_CELLS],
                         ids=[c[0] for c in _KERNEL_CELLS])
def test_kernel_drive_span_has_no_launch_attrs_on_the_cpu(config, mix):
    """The CPU runs kernel 1's plain version: fused.launch carries none of
    the launch's attrs."""
    launch = _tiny_cell_answer(config, mix, 4)
    assert not {"cluster", "lanes", "reduce",
                "reductions_per_step"} & set(launch.attrs)


@pytest.mark.parametrize("pct", [10, 40])
def test_reductions_per_step_count_the_sampling_search(pct):
    """A template whose profile scores a sample of the nodes runs the
    sampling search's bs_iters reductions a step, besides the normalisers'
    and the argmax: bs_iters + 2 or more."""
    from cluster_capacity_tpu_torch.engine import fused as tfused
    from cluster_capacity_tpu_torch.engine import simulator as tsim
    profile = TProfile()
    profile.percentage_of_nodes_to_score = pct
    pb = tenc.encode_problem(TSnap.from_objects(_host_nodes(400)),
                             t_default_pod(_ipa_pod("p")), profile)
    cfg = tsim.static_config(pb)
    table = tfused.kernel_table(tfused._pack_meta(cfg, pb))
    ints = table.i.tolist()
    bs_iters = ints[tfused.IOFF["bs_iters"]]
    assert ints[tfused.IOFF["sample_k"]] > 0 and bs_iters == 10
    assert tfused.reductions_per_step(table) == bs_iters + 2
