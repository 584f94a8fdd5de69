"""The port's deep-profiling layer (obs/profile.py, obs/costmodel.py,
obs/flight.py, obs/entries.py and `hypercc profile`) against the JAX
package's, mirroring tests/test_profile.py.

Held equal between the packages: the calibration report on the same
measured dict and budgets, the attribution rows of the same guarded drill
(site, rung, phase, calls, batch, faults; seconds are each package's own),
the flight bundle's manifest (all but `platform`, `ir` and `created`, and
the IR file's name: kernel.txt here, jaxpr.txt there), the recorder's
bound, and the `hypercc profile` table and JSON.  Tolerance: exact.
"""

import copy
import json
import os

import pytest

from cluster_capacity_tpu import obs as jobs
from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.obs import costmodel as jcost
from cluster_capacity_tpu.obs import flight as jflight
from cluster_capacity_tpu.obs import profile as jprofile
from cluster_capacity_tpu.runtime import degrade as jdegrade
from cluster_capacity_tpu.runtime import faults as jfaults
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu.utils.events import default_recorder as jevents
from cluster_capacity_tpu.utils.metrics import default_registry as jreg
from cluster_capacity_tpu_torch import obs
from cluster_capacity_tpu_torch.cli import hypercc
from cluster_capacity_tpu_torch.cli import profile as profile_cli
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.obs import costmodel, entries, flight
from cluster_capacity_tpu_torch.obs import names as obs_names
from cluster_capacity_tpu_torch.obs import profile as obs_profile
from cluster_capacity_tpu_torch.runtime import degrade, faults
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile
from cluster_capacity_tpu_torch.utils.events import default_recorder
from cluster_capacity_tpu_torch.utils.metrics import default_registry

from helpers import build_test_node, build_test_pod
from torch_trace import as_jax_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset():
    for f, fl in ((faults, flight), (jfaults, jflight)):
        f.clear()
        fl.uninstall()
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


def _pbs(num_nodes=4, cpu=2000, pods=8):
    node_list = [build_test_node(f"n{i}", cpu, 4 * 1024 ** 3, pods)
                 for i in range(num_nodes)]
    probe = build_test_pod("probe", 500)
    return (jenc.encode_problem(JSnap.from_objects(node_list),
                                j_default_pod(probe), JProfile()),
            tenc.encode_problem(TSnap.from_objects(node_list),
                                t_default_pod(probe), TProfile()))


# --- cost-model calibration --------------------------------------------------

_BUDGETS = {
    "entries": {
        "fused/n8": {"flops": 1000.0, "live_bytes": 4096},
        "scan/n8": {"flops": 2000.0, "live_bytes": 8192},
        "fast_path/n8b3": {"flops": 500.0, "live_bytes": 2048},
        "oracle/n4": {"flops": 0, "live_bytes": 0},
    },
}

_MEASURED = {
    "at-par": {"fused/n8": {"device_s": 1.0, "rung": "fused"},
               "scan/n8": {"device_s": 2.0, "rung": "fused"},
               "fast_path/n8b3": {"device_s": 0.5, "rung": "fast_path"}},
    "inflated": {"fused/n8": {"device_s": 4.0, "rung": "fused"},
                 "scan/n8": {"device_s": 2.0, "rung": "fused"},
                 "fast_path/n8b3": {"device_s": 0.5, "rung": "fast_path"}},
    "zero-flops": {"oracle/n4": {"device_s": 0.3, "rung": "oracle"},
                   "fused/n8": {"device_s": 1.0, "rung": "fused"}},
    "watermark": {"fused/n8": {"device_s": 1.0, "rung": "fused",
                               "mem_peak_bytes": 8192, "compile_s": 0.5}},
    "unpinned": {"ghost/n1": {"device_s": 1.0, "rung": "aux"},
                 "fused/n8": {"device_s": 0.0}},
}


@pytest.mark.parametrize("budgets", ["fixture", "repo"])
@pytest.mark.parametrize("case", sorted(_MEASURED))
def test_calibration_matches_jax(case, budgets):
    """costmodel.calibrate, render_calibration and the efficiency gauges
    equal the JAX package's on the same measured dict, against the test's
    pins and the repo's tools/irgate/budgets.json."""
    pins = _BUDGETS if budgets == "fixture" else costmodel.load_budgets()
    if budgets == "repo":
        assert pins == jcost.load_budgets()
        assert costmodel.DEFAULT_BUDGETS_PATH == jcost.DEFAULT_BUDGETS_PATH
    measured = _MEASURED[case]
    got = costmodel.calibrate(copy.deepcopy(measured), pins, platform="cpu")
    want = jcost.calibrate(copy.deepcopy(measured), pins, platform="cpu")
    assert got == want
    assert costmodel.render_calibration(got) == jcost.render_calibration(want)
    costmodel.to_registry(got)
    jcost.to_registry(want)
    assert default_registry.render() == jreg.render()


def test_calibration_flags_inflated_entry_by_name_and_ratio():
    report = costmodel.calibrate(_MEASURED["inflated"], _BUDGETS,
                                 platform="cpu")
    assert report["entries"]["fused/n8"]["efficiency"] == 0.25
    assert [f["entry"] for f in report["flagged"]] == ["fused/n8"]
    assert default_registry.get_gauge(obs_names.KERNEL_EFFICIENCY,
                                      entry="fused/n8", rung="fused") == 0.0
    costmodel.to_registry(report)
    assert default_registry.get_gauge(obs_names.KERNEL_EFFICIENCY,
                                      entry="fused/n8", rung="fused") == 0.25


def test_write_calibration_atomic(tmp_path):
    report = costmodel.calibrate({"fused/n8": {"device_s": 1.0}}, _BUDGETS,
                                 platform="cpu")
    path = str(tmp_path / "calibration.json")
    costmodel.write_calibration(path, report)
    assert not os.path.exists(path + ".tmp")
    with open(path, encoding="utf-8") as fh:
        assert json.load(fh) == report


# --- device-time attribution -------------------------------------------------

def _rows_shape(rows):
    """Attribution rows without their seconds, in site/rung/phase order
    (the table orders them by device seconds, each package's own)."""
    return sorted(({k: v for k, v in r.items() if k not in ("device_s",
                                                            "compile_s")}
                   for r in rows),
                  key=lambda r: (r["site"], r["rung"], r["phase"]))


@pytest.mark.parametrize("specs", [
    ("engine.solve:oom",),
    ("engine.solve:oom", "engine.fast_path:oom"),
    (),
], ids=["fast-path", "oracle", "healthy"])
def test_attribution_rows_match_jax(specs):
    """The same guarded drill leaves the same attribution rows (site,
    rung, phase, calls, batch, faults, memory column) in both packages;
    device_summary's sites and the table's rows follow."""
    jpb, tpb = _pbs()
    with jfaults.inject(*specs):
        jdegrade.solve_one_guarded(jpb)
    with faults.inject(*specs):
        res = degrade.solve_one_guarded(tpb, device="cpu")
    assert res.degraded == bool(specs)
    rows, jrows = obs_profile.attribution(), jprofile.attribution()
    assert _rows_shape(rows) == _rows_shape(jrows)
    summary = obs_profile.device_summary()
    assert set(summary["sites"]) == set(jprofile.device_summary()["sites"])
    assert summary["device_s"] == pytest.approx(
        sum(r["device_s"] for r in rows), abs=1e-6)
    assert default_registry.counter_total(obs_names.DEVICE_SECONDS) > 0.0
    rendered = obs_profile.render_attribution(rows)
    assert rendered.splitlines()[0] == \
        jprofile.render_attribution(jrows).splitlines()[0]
    assert "engine.solve" in rendered
    assert obs_profile.render_attribution([]) == \
        jprofile.render_attribution([])


def test_group_attribution_carries_batch_like_jax():
    """parallel.solve_group rows carry the group's batch volume."""
    jpbs = [_pbs()[0] for _ in range(3)]
    tpbs = [_pbs()[1] for _ in range(3)]
    jdegrade.solve_group_guarded(jpbs)
    degrade.solve_group_guarded(tpbs, device="cpu")
    rows = _rows_shape(obs_profile.attribution())
    assert rows == _rows_shape(jprofile.attribution())
    assert rows[0]["site"] == "parallel.solve_group" and rows[0]["batch"] == 3


def test_write_attribution_schema_and_atomicity(tmp_path):
    degrade.solve_one_guarded(_pbs()[1], device="cpu")
    path = str(tmp_path / "attribution.json")
    obs_profile.write_attribution(path, extra={"scenario": "solve"})
    assert not os.path.exists(path + ".tmp")
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    assert doc["schema"] == obs_profile.ATTRIBUTION_SCHEMA == \
        jprofile.ATTRIBUTION_SCHEMA
    assert doc["scenario"] == "solve"
    assert any(r["site"] == "engine.solve" for r in doc["rows"])


def test_capture_writes_torch_trace_and_restores_sampling(tmp_path):
    """capture(out_dir) runs the block under torch.profiler and exports a
    Chrome trace there; the memory-sampling flag is restored; on the CPU
    there are no device memory stats, so no watermark is recorded."""
    obs_profile.enable_memory_sampling(False)
    out = str(tmp_path / "prof")
    with obs_profile.capture(out, memory=True):
        assert obs_profile.memory_sampling_enabled()
        degrade.solve_one_guarded(_pbs()[1], device="cpu")
    assert not obs_profile.memory_sampling_enabled()
    traces = [n for n in os.listdir(out)
              if n.startswith(obs_profile.TRACE_PREFIX)]
    assert len(traces) == 1
    with open(os.path.join(out, traces[0]), encoding="utf-8") as fh:
        assert "traceEvents" in json.load(fh)
    assert obs_profile.device_memory_stats() is None
    assert obs_profile.sample_watermark() is None
    assert obs_profile._peak_bytes({"allocated_bytes.all.peak": 123,
                                    "reserved_bytes.all.peak": 456}) == 123
    assert obs_profile._peak_bytes(None) is None


def test_capture_survives_a_profiler_failure(tmp_path, capsys, monkeypatch):
    """A profiler that cannot start is reported and the block still runs."""
    def broken():
        raise RuntimeError("no profiler here")
    monkeypatch.setattr(obs_profile, "_start_profiler", broken)
    ran = []
    with obs_profile.capture(str(tmp_path / "p")):
        ran.append(1)
    assert ran == [1]
    assert "continuing without" in capsys.readouterr().err


def test_tracer_profile_exports_a_trace(tmp_path):
    from cluster_capacity_tpu_torch.utils.trace import Tracer
    tr = Tracer()
    with tr.profile():
        pass
    out = str(tmp_path / "tp")
    tr.enable(profile_dir=out)
    with tr.profile():
        degrade.solve_one_guarded(_pbs()[1], device="cpu")
    assert any(n.startswith(obs_profile.TRACE_PREFIX)
               for n in os.listdir(out))


# --- flight recorder ---------------------------------------------------------

_PORT_ONLY = ("platform", "ir", "created")


def _unnumbered(path):
    """A bundle's directory name without its sequence number (each
    recorder numbers its bundles process-wide)."""
    head, _seq, code = os.path.basename(path).split("-", 2)
    return f"{head}-{code}"


def _comparable(manifest):
    m = {k: v for k, v in manifest.items() if k not in _PORT_ONLY}
    m["files"] = [f.replace("jaxpr.txt", "kernel.txt") for f in m["files"]]
    msg = m["fault"]["message"]
    m["fault"]["message"] = msg.replace(
        "RESOURCE_EXHAUSTED: Out of memory while trying to allocate",
        "CUDA out of memory. Tried to allocate memory on the device")
    return m


def _bundle_both(tmp_path, spec, pbs=None, argv=("cluster-capacity",
                                                "--podspec", "p.yaml")):
    jpb, tpb = pbs or _pbs()
    for fl, inject, solve, pb, sub in (
            (jflight, jfaults.inject, jdegrade.solve_one_guarded, jpb, "j"),
            (flight, faults.inject, degrade.solve_one_guarded, tpb, "t")):
        fl.install(str(tmp_path / sub), argv=list(argv))
        with inject(spec):
            if fl is flight:
                solve(pb, device="cpu")
            else:
                solve(pb)
    return jflight.bundle_paths(), flight.bundle_paths()


def test_flight_bundle_round_trip_matches_jax(tmp_path):
    """An injected OOM under an armed recorder: one bundle in each package
    with the same name, and the same manifest but for platform, ir and
    created; the port's kernel.txt names kernel 1 and its launch plan; the
    repro spec re-triggers the same fault code."""
    jb, tb = _bundle_both(tmp_path, "engine.solve:oom")
    assert len(tb) == len(jb) == 1
    assert _unnumbered(tb[0]) == _unnumbered(jb[0]) == "flight-DeviceOOM"
    jbundle, tbundle = jflight.load_bundle(jb[0]), flight.load_bundle(tb[0])
    assert _comparable(tbundle["manifest"]) == _comparable(jbundle["manifest"])
    man = tbundle["manifest"]
    assert man["schema"] == flight.FLIGHT_SCHEMA == jflight.FLIGHT_SCHEMA
    assert man["ir"] == {"entry": "fused/n8", "file": "kernel.txt"}
    assert set(man["platform"]) >= {"python", "platform", "env", "torch",
                                    "cuda", "device"}
    assert man["platform"]["device"] == "cpu"
    kernel = tbundle["kernel"]
    assert "kernel: fused_steps_kernel" in kernel
    assert "launch_plan (nominal cluster slots" in kernel
    assert "resident planes" in kernel and "source sha256:" in kernel
    assert "aten ops per step:" in kernel
    assert [ev["name"] for ev in as_jax_trace(tbundle["spans"])] == \
        [ev["name"] for ev in jbundle["spans"]]
    assert "cc_faults_injected_total" in tbundle["metrics"]
    repro = man["repro"]
    assert repro["env"] == {faults.ENV_VAR: "engine.solve:oom"}
    assert repro["line"] == jbundle["manifest"]["repro"]["line"]
    faults.clear()
    with faults.inject(repro["env"][faults.ENV_VAR]):
        assert degrade.solve_one_guarded(_pbs()[1], device="cpu").degraded
    assert len(flight.bundle_paths()) == 2
    man2 = flight.load_bundle(flight.bundle_paths()[-1])["manifest"]
    assert man2["fault"]["code"] == "DeviceOOM"
    assert any("DeviceOOM@engine.solve" in d for d in man2["degradations"])


def test_flight_kernel_txt_for_the_group_site(tmp_path):
    """parallel.solve_group maps to kernel 2 and its grid of B clusters;
    a host site (the oracle) gets a note, as the JAX package notes its
    host sites."""
    flight.install(str(tmp_path / "f"))
    tpbs = [_pbs()[1] for _ in range(2)]
    with faults.inject("parallel.solve_group:oom:1:99"):
        degrade.solve_group_guarded(tpbs, device="cpu")
    first = flight.load_bundle(flight.bundle_paths()[0])
    assert first["manifest"]["ir"] == {"entry": "fused_batched/n8b3",
                                       "file": "kernel.txt"}
    assert "kernel: fused_steps_batched_kernel" in first["kernel"]
    assert "CTAs (3 x cluster" in first["kernel"]
    flight.uninstall()
    flight.install(str(tmp_path / "g"))
    with faults.inject("engine.solve:oom", "engine.fast_path:oom",
                       "engine.oracle:oom"):
        with pytest.raises(Exception):
            degrade.solve_one_guarded(_pbs()[1], device="cpu")
    notes = [flight.load_bundle(p)["manifest"]["ir"]
             for p in flight.bundle_paths()]
    assert notes[-1] == {"note": "no kernel serves site 'engine.oracle' "
                                 "(host or plain PyTorch ops)"}


def test_flight_recorder_is_bounded_like_jax(tmp_path):
    for fl, inject, solve, pb, sub in (
            (jflight, jfaults.inject, jdegrade.solve_one_guarded,
             _pbs()[0], "j"),
            (flight, faults.inject, degrade.solve_one_guarded,
             _pbs()[1], "t")):
        fl.install(str(tmp_path / sub), max_bundles=2, capture_ir=False)
        for _ in range(3):
            with inject("engine.solve:oom"):
                if fl is flight:
                    solve(pb, device="cpu")
                else:
                    solve(pb)
    for fl, sub, reg in ((flight, "t", default_registry), (jflight, "j",
                                                           jreg)):
        fdir = str(tmp_path / sub)
        on_disk = sorted(n for n in os.listdir(fdir)
                         if n.startswith("flight-"))
        assert len(on_disk) == 2
        assert fl.bundle_paths() == [os.path.join(fdir, n) for n in on_disk]
        assert reg.get(obs_names.FLIGHT_BUNDLES, code="DeviceOOM") == 3
    assert [_unnumbered(p) for p in flight.bundle_paths()] == \
        [_unnumbered(p) for p in jflight.bundle_paths()]


def test_flight_strict_failure_and_noop_match_jax(tmp_path):
    paths = []
    for fl, sub in ((flight, "t"), (jflight, "j")):
        fl.install(str(tmp_path / sub), capture_ir=False)
        paths.append(fl.on_strict("--strict: solve served by degraded rung "
                                  "oracle"))
    tman, jman = (flight.load_bundle(p)["manifest"] for p in paths)
    assert _comparable(tman) == _comparable(jman)
    assert tman["fault"]["code"] == "StrictDegraded"
    flight.uninstall()
    with faults.inject("engine.solve:oom"):
        assert degrade.solve_one_guarded(_pbs()[1], device="cpu").degraded
    assert flight.bundle_paths() == []


def test_export_atomic_writes_leave_no_temp_files(tmp_path):
    degrade.solve_one_guarded(_pbs()[1], device="cpu")
    mpath = str(tmp_path / "metrics.prom")
    tpath = str(tmp_path / "trace.jsonl")
    obs.write_metrics(mpath, atomic=True)
    assert obs.write_trace(tpath, atomic=True) > 0
    for p in (mpath, tpath):
        assert os.path.exists(p) and not os.path.exists(p + ".tmp")


# --- hypercc profile ---------------------------------------------------------

def test_canonical_entries_are_the_jax_ladder_less_the_later_slices():
    import sys
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tools.irgate import entries as ir_entries
    jax_names = [s.name for s in ir_entries.canonical_entries()]
    port = [s.name for s in entries.canonical_entries()]
    assert [n for n in jax_names if n not in entries.MISSING] == port
    assert {s.name: s.rung for s in entries.canonical_entries()} == \
        {s.name: s.rung for s in ir_entries.canonical_entries()
         if s.name not in entries.MISSING}
    assert set(entries.MISSING) <= set(jax_names)


@pytest.mark.parametrize("scenario", ["solve", "sweep", "resilience"])
def test_profile_cli_attribution_matches_jax(scenario, capsys):
    """`hypercc profile <scenario> --no-calibrate -o json`: the same
    attribution rows (seconds masked) as the JAX command."""
    from cluster_capacity_tpu.cli import profile as jprofile_cli
    argv = [scenario, "--nodes", "6", "--no-calibrate", "-o", "json"]
    assert jprofile_cli.run(list(argv)) == 0
    want = json.loads(capsys.readouterr().out)
    _reset()
    assert hypercc.run(["profile"] + argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["scenario"] == want["scenario"] == scenario
    assert _rows_shape(got["attribution"]) == _rows_shape(want["attribution"])


def test_profile_cli_table_and_calibration(capsys, monkeypatch):
    """The table form, then calibration at CC_PROFILE_REPS=1 over the
    port's entries: every entry measured and joined against the repo's
    budgets, the missing ones named on stderr."""
    assert profile_cli.run(["solve", "--nodes", "6", "--no-calibrate",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("scenario: solve (6 nodes)")
    assert "engine.solve" in out and "device_s" in out
    monkeypatch.setenv(profile_cli.ENV_REPS, "1")
    assert profile_cli.run(["solve", "--nodes", "6", "-o", "json",
                            "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    doc = json.loads(cap.out)
    report = doc["calibration"]
    assert report["platform"] == "cpu"
    assert sorted(report["entries"]) == \
        sorted(s.name for s in entries.canonical_entries())
    pins = costmodel.load_budgets()["entries"]
    for name, e in report["entries"].items():
        assert e["flops"] == float(pins[name]["flops"])
        assert e["device_s"] > 0 and e["compile_s"] == 0.0
    for name in entries.MISSING:
        assert name in cap.err
    assert "calibrated rate:" in costmodel.render_calibration(report)


def test_profile_cli_fault_flight_and_artifacts(tmp_path, capsys):
    fdir, pdir = str(tmp_path / "flight"), str(tmp_path / "prof")
    assert profile_cli.run(["solve", "--nodes", "6", "--no-calibrate",
                            "-o", "json", "--flight-dir", fdir,
                            "--profile-out", pdir, "--device", "cpu",
                            "--inject-fault", "engine.solve:oom"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert {r["site"] for r in doc["attribution"]} >= {"engine.solve",
                                                        "engine.fast_path"}
    bundles = [n for n in os.listdir(fdir) if n.startswith("flight-")]
    assert bundles and "DeviceOOM" in bundles[0]
    names = os.listdir(pdir)
    assert "attribution.json" in names
    assert any(n.startswith(obs_profile.TRACE_PREFIX) for n in names)
