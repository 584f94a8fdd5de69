"""Tiny versions of the benchmark's cells for CPU tests: the same
configuration and traffic files with the node count, the template count
and the limits cut down.  A configuration or a mix may carry its own cut
as a `tiny` object of overrides (`{"nodes": 60}`, `{"max_limit": 64}`, a
nested object merged into the one it names); the tables below hold the
cuts of the files that carry none."""

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


def _overlay(obj: dict, tiny: dict) -> dict:
    """obj with tiny's keys set over it, nested objects merged."""
    for key, value in tiny.items():
        if isinstance(value, dict) and isinstance(obj.get(key), dict):
            _overlay(obj[key], value)
        else:
            obj[key] = value
    return obj


def _table_cut(kind: str, name: str, obj: dict) -> dict:
    """The cut of a file that carries no `tiny` object of its own."""
    if kind == "configs":
        return {"nodes": TINY_NODES[name]} if name in TINY_NODES else {}
    tiny = {}
    if "templates" in obj:
        tiny["templates"] = {"count": TINY_TEMPLATES.get(name, 6)}
    if name == "race":
        tiny.update(TINY_RACE)
    return tiny


def tiny_copy(kind: str, name: str, obj: dict) -> dict:
    """A configuration ("configs") or a mix ("traffic") cut down: by its
    own `tiny` object where it has one, else by the tables."""
    return _overlay(obj, obj.get("tiny") or _table_cut(kind, name, obj))


def tiny_dirs(tmp_path) -> dict:
    """Search directories holding cut-down copies of every configuration
    and mix."""
    dirs = {}
    for kind in ("configs", "traffic"):
        out = tmp_path / kind
        out.mkdir()
        for path in sorted(os.listdir(os.path.join(BENCH_DIR, kind))):
            if not path.endswith(".json"):
                continue
            name = path[:-5]
            obj = tiny_copy(kind, name, harness.load_json(kind, name))
            (out / path).write_text(json.dumps(obj))
        dirs[kind] = [str(out)]
    return dirs


def tiny_cell(tmp_path, workload: str):
    dirs = tiny_dirs(tmp_path)
    return harness.load_cell(bench(), workload, dirs), dirs
