"""The harness on the CPU: tiny cells end to end against the reference,
the result line, finding files by name, the metric arithmetic and the
import rule."""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import portbench_tiny as pt
from portbench import harness, run, trace

CELLS = ["k8s-5000n.spread", "gke-10000n.race"]


def _run(cell, dirs, seed=2 ** 31 + 77, seconds=0.5, traced=False):
    out = io.StringIO()
    rc = run.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                      time.perf_counter(), dirs=dirs, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_is_correct(tmp_path, workload):
    """The port on the CPU at a tiny size of each cell, held to the
    reference in full."""
    cell, dirs = pt.tiny_cell(tmp_path, workload)
    res = _run(cell, dirs)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(v["value"] == 0 for v in res["checks"].values())


def test_result_line_schema(tmp_path):
    cell, dirs = pt.tiny_cell(tmp_path, "k8s-5000n.spread")
    res = _run(cell, dirs)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"placements_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    traced = _run(cell, dirs, traced=True)
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    # per-layer metrics only; host-clock ones are read on the CPU too
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"snapshot_ms.pps", "encode_ms.pps",
            "dryrun_ms.pps"} <= set(traced["metrics"])


def test_every_metric_has_a_reader_and_every_cell_reports():
    bench = pt.bench()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert harness.find_file("metrics", m["name"], ".py")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = harness.load_cell(bench, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
        assert harness.find_file("entries", cell.traffic["entry"], ".py")
    assert e2e["setup_s"]["bound"] <= 0.25


def test_a_new_mix_is_found_by_name(tmp_path):
    """A mix file dropped into a searched directory is picked up with no
    edit to any file that is there."""
    cell, dirs = pt.tiny_cell(tmp_path, "k8s-5000n.spread")
    mix = dict(cell.traffic, pod={"name": "big", "cpu": "1", "memory": "1Gi"})
    (tmp_path / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    bench = pt.bench()
    bench["workloads"].append({"name": "k8s-5000n.throwaway",
                               "config": "k8s-5000n", "traffic": "throwaway",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "k8s-5000n.spread" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["k8s-5000n.throwaway"]
    new = harness.load_cell(bench, "k8s-5000n.throwaway", dirs)
    assert new.traffic["pod"]["name"] == "big"
    res = _run(new, dirs)
    assert res["correct"] is True


def test_the_race_traces_a_steady_stretch(tmp_path):
    """The traced race is a whole study with the profiler on only over the
    chunks from step trace_from on, trace_steps steps of them."""
    from portbench.reference import cluster as gen
    cell, dirs = pt.tiny_cell(tmp_path, "gke-10000n.race")
    entry = harness.load_module("entries", cell.traffic["entry"])
    data = gen.make_objects(cell.config, cell.traffic, 2 ** 31 + 5)
    t0 = time.perf_counter()
    ans, s = entry.traced(cell, data, torch.device("cpu"))
    whole = time.perf_counter() - t0
    assert ans.placed == cell.traffic["max_limit"]
    assert s.steps == cell.traffic["trace_steps"]
    assert s.window[0] <= s.solve[0] < s.solve[1] <= s.window[1]
    assert 0 < s.window_s < whole / 2


def test_reservoir_is_drawn_from_the_seed():
    def draw(seed):
        r = harness.Reservoir(3, seed)
        for i in range(50):
            r.offer(i)
        return r.items
    assert draw(5) == draw(5)
    assert len(draw(5)) == 3
    assert draw(5) != draw(6)


def test_idle_share_from_a_synthetic_timeline():
    us = 1e6
    ev = [
        {"cat": "user_annotation", "name": trace.ANSWER, "ph": "X",
         "ts": 0.0, "dur": 10 * us},
        {"cat": "user_annotation", "name": trace.SOLVE, "ph": "X",
         "ts": 2 * us, "dur": 6 * us},
        {"cat": "kernel", "name": "k1", "ph": "X", "ts": 2 * us, "dur": 2 * us},
        {"cat": "kernel", "name": "k1", "ph": "X", "ts": 3 * us, "dur": 2 * us},
        {"cat": "gpu_memcpy", "name": "copy", "ph": "X", "ts": 9 * us,
         "dur": 2 * us},
        {"cat": "cpu_op", "name": "host_work", "ph": "X", "ts": 5 * us,
         "dur": 4 * us},
    ]
    s = trace.summarize(ev)
    assert s.window_s == pytest.approx(10.0)
    assert s.busy_s == pytest.approx(4.0)       # [2, 5] and [9, 10]
    assert s.solve_busy_s == pytest.approx(3.0)
    assert s.solve_kernels == 2 and s.kernels == 2
    info = harness.RunInfo(cell=None, window_s=1.0, answers=[], trace=s)
    from portbench import readers
    assert readers.device_idle_pct(info) == pytest.approx(60.0)
    gaps = dict(s.idle_gaps)
    assert gaps["host_work"] == pytest.approx(4.0)
    assert gaps["host (no traced op)"] == pytest.approx(2.0)
    assert dict(s.device_ops)["k1"] == pytest.approx(4.0)   # summed


def test_forbidden_modules_compared_whole():
    assert harness.loaded_forbidden(["cluster_capacity_tpu_torch.engine",
                                     "jaxtyping", "numpy"]) == []
    assert harness.loaded_forbidden(["cluster_capacity_tpu.engine", "jax",
                                     "flax.linen"]) == \
        ["cluster_capacity_tpu", "flax", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole tiny run in a fresh process, then sys.modules."""
    dirs = pt.tiny_dirs(tmp_path)
    code = (
        "import sys, time, io, torch\n"
        f"sys.path.insert(0, {pt.ROOT!r}); sys.path.insert(0, {pt.HERE!r})\n"
        "import portbench_tiny as pt\n"
        "from portbench import harness, run\n"
        f"dirs = {json.dumps(dirs)}\n"
        "for w in ('k8s-5000n.spread', 'gke-10000n.race'):\n"
        "    cell = harness.load_cell(pt.bench(), w, dirs)\n"
        "    rc = run.run_cell(cell, 3, 0.2, False, torch.device('cpu'),\n"
        "                      time.perf_counter(), dirs=dirs, out=io.StringIO())\n"
        "    assert rc == 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "cluster_capacity_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES)


def test_outside_a_full_checkout_it_refuses(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    has no program: no result, a non-zero exit."""
    import shutil
    shutil.copytree(pt.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(pt.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "k8s-5000n.spread", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_a_card_it_refuses():
    """No CUDA device: no result, a non-zero exit."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "k8s-5000n.spread", "--seed", "1", "--seconds", "1"],
                         cwd=pt.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_cell_on_the_card():
    """The real command, a short window, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "gke-10000n.race", "--seed", str(2 ** 31 + 9),
                          "--seconds", "2", "--trace", "1"],
                         cwd=pt.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
