"""Tiny versions of the benchmark's cells for CPU tests: the same
configuration and traffic files with the node count, the template count
and the limits cut down."""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

TINY_NODES = {"k8s-5000n": 60, "gke-10000n": 48}
TINY_TEMPLATES = {"race": 6}
# the race's pops, and its traced stretch in the CPU's chunks of 16 steps
TINY_RACE = {"max_limit": 240, "warmup_limit": 240, "trace_from": 64,
             "trace_steps": 64}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_dirs(tmp_path) -> dict:
    """Search directories holding cut-down copies of every configuration
    and mix."""
    cdir, tdir = tmp_path / "configs", tmp_path / "traffic"
    cdir.mkdir()
    tdir.mkdir()
    for name, n in TINY_NODES.items():
        cfg = harness.load_json("configs", name)
        cfg["nodes"] = n
        (cdir / f"{name}.json").write_text(json.dumps(cfg))
    for path in os.listdir(os.path.join(BENCH_DIR, "traffic")):
        name = path[:-5]
        mix = harness.load_json("traffic", name)
        if "templates" in mix:
            mix["templates"]["count"] = TINY_TEMPLATES.get(name, 6)
        if name == "race":
            mix.update(TINY_RACE)
        (tdir / f"{name}.json").write_text(json.dumps(mix))
    return {"configs": [str(cdir)], "traffic": [str(tdir)]}


def tiny_cell(tmp_path, workload: str):
    dirs = tiny_dirs(tmp_path)
    return harness.load_cell(bench(), workload, dirs), dirs
