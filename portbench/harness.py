"""The benchmark's general parts: finding a cell's configuration, traffic
mix, entry and per-layer metric readers by name, the statistics, and the
result line.

Everything that belongs to one configuration, one mix, one entry or one
per-layer metric lives in a file of its own that is found by the name
BENCHMARK.json gives it: configs/<config>.json, traffic/<mix>.json,
entries/<entry>.py and metrics/<metric>.py under this folder.  A new cell,
mix or metric is new files and entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cluster_capacity_tpu")


def search_dirs(kind: str) -> List[str]:
    """Where files of one kind ("configs", "traffic", "entries",
    "metrics") are looked for."""
    return [os.path.join(HERE, kind)]


def find_file(kind: str, name: str, suffix: str,
              dirs: Optional[Sequence[str]] = None) -> str:
    for d in (dirs if dirs is not None else search_dirs(kind)):
        path = os.path.join(d, name + suffix)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no {kind} file named {name}{suffix}")


def load_json(kind: str, name: str,
              dirs: Optional[Sequence[str]] = None) -> dict:
    with open(find_file(kind, name, ".json", dirs)) as f:
        return json.load(f)


def load_module(kind: str, name: str,
                dirs: Optional[Sequence[str]] = None):
    """The module in <kind>/<name>.py, loaded by its path (a metric's name
    may hold dots)."""
    path = find_file(kind, name, ".py", dirs)
    mod_name = "portbench_" + kind + "_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _for_cell(metrics: Sequence[dict], cell: str,
              reported: Optional[set] = None) -> List[dict]:
    """The metrics a cell reports: those that list it, and those without a
    list where the cell reports the end-to-end metric they move."""
    out = []
    for m in metrics:
        cells = m.get("workloads")
        if cells is not None:
            if cell in cells:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def load_cell(bench: dict, workload: str,
              dirs: Optional[Dict[str, Sequence[str]]] = None) -> Cell:
    dirs = dirs or {}
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload named {workload} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json("configs", conf["name"], dirs.get("configs"))
    traffic = load_json("traffic", entry["traffic"], dirs.get("traffic"))
    e2e = _for_cell(bench["end_to_end"], workload)
    reported = {m["name"] for m in e2e}
    per_layer = _for_cell(bench["per_layer"], workload, reported)
    return Cell(workload, config, traffic, int(entry["chips"]), e2e,
                per_layer)


# --- statistics -------------------------------------------------------------

def mean(values: Sequence[float]) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


class Reservoir:
    """A uniform sample of at most `size` of the items offered, drawn from
    the seed (Algorithm R), so the checked answers are the seed's choice
    among all that completed."""

    def __init__(self, size: int, seed: int):
        self.size = max(1, int(size))
        self.rng = random.Random(seed)
        self.items: List[Any] = []
        self.seen = 0

    def offer(self, item: Any) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.items[j] = item


# --- the run's record -------------------------------------------------------

@dataclass
class AnswerRecord:
    """What the window keeps of every answer (the sampled ones are kept
    whole, apart)."""
    index: int
    start: float
    end: float
    placed: int
    failed: bool
    phases: Dict[str, float] = field(default_factory=dict)
    summary: Any = None


@dataclass
class RunInfo:
    """What a per-layer metric reader reads."""
    cell: Cell
    window_s: float
    answers: List[AnswerRecord]
    setup_s: float = 0.0
    trace: Optional[Any] = None          # trace.TraceSummary of the slice
    shapes: Dict[str, float] = field(default_factory=dict)

    def phase_ms(self, phase: str) -> Optional[float]:
        """Mean milliseconds per answer of one phase over the window."""
        vals = [a.phases[phase] for a in self.answers
                if not a.failed and phase in a.phases]
        m = mean(vals)
        return None if m is None else m * 1000.0


def read_metrics(cell: Cell, info: RunInfo,
                 dirs: Optional[Sequence[str]] = None,
                 end_to_end: bool = False) -> Dict[str, dict]:
    """Each metric of the cell (its end-to-end ones, or its per-layer ones)
    from its own reader; a reader that finds nothing to read returns None
    and the metric is left out."""
    out = {}
    for m in (cell.end_to_end if end_to_end else cell.per_layer):
        reader = load_module("metrics", m["name"], dirs)
        value = reader.read(info)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def loaded_forbidden(modules: Optional[Sequence[str]] = None) -> List[str]:
    """Top-level names in sys.modules that the benchmark must never load,
    compared whole (the port's own name begins with the JAX package's)."""
    names = sys.modules.keys() if modules is None else modules
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
