"""Bounded flight recorder: self-contained triage bundles on fault.

When installed (``--flight-dir`` on either CLI, or programmatically), every
classified ``RuntimeFault`` crossing guard.run — and every ``--strict``
failure — dumps one bundle directory:

    flight-NNN-<code>/
        MANIFEST.json   schema cc-flight/1: fault, injected specs, ladder
                        transitions, platform/env info, repro command, file
                        listing
        spans.jsonl     last-N spans as Chrome trace events (loadable in
                        Perfetto like --trace-out output)
        metrics.prom    full registry snapshot (Prometheus text)
        events.jsonl    event-recorder ring tail
        kernel.txt      what serves the failing site on the device: for a
                        kernel's site (engine.solve: kernel 1, and the scan
                        step beside it; parallel.solve_group: kernel 2) the
                        kernel's name, the launch_plan of the site's
                        canonical entry (obs/entries.py; cluster size and
                        resident planes), its grid and plane shapes, the
                        plan of this process's last launch, the nvcc flags
                        and a hash of csrc/fused_steps.cu; for the scan
                        step the aten ops of one step and the steps of a
                        captured CUDA graph; for a mesh site
                        (parallel.sharded, parallel.interleave_sharded)
                        the note that no hand-written kernel serves the
                        mesh path; for the rest (oracle, extenders,
                        bounds, the closed form) a note in the manifest

The recorder is bounded (oldest bundles pruned beyond ``max_bundles``),
re-entrancy-guarded (a fault raised while dumping never recurses), and
never lets a dump failure mask the fault being raised.  Dump + prune run
under a module lock so faults on concurrent threads serialize their bundles
instead of colliding on the sequence number or double-pruning the
directory; the ``in_dump`` flag still catches same-thread recursion, which
the re-entrant lock would happily allow.  kernel.txt packs its entry on the
host and counts one step's ops on the CPU: it launches nothing.

The repro line synthesizes a ``CC_INJECT_FAULT`` spec from the fault's
site + code, so re-running it deterministically re-triggers the same fault
code through the real classifier path — whether the original fault was
injected or organic.

Import discipline: obs imports only utils and stdlib at module scope; the
runtime faults harness, the engine and torch are imported lazily inside the
dump path (post-mortem code, not the hot path).
"""

from __future__ import annotations

import json
import os
import platform as platform_mod
import shlex
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils import metrics as metrics_mod
from . import export, names
from . import spans as spans_mod

FLIGHT_SCHEMA = "cc-flight/1"
MANIFEST_NAME = "MANIFEST.json"
DEFAULT_MAX_BUNDLES = 16

_ROOT = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", ".."))

# Tail sizes: a bundle is a triage artifact, not an archive.
MAX_BUNDLE_SPANS = 256
MAX_BUNDLE_EVENTS = 256
KERNEL_FILE = "kernel.txt"

# fault site -> (kernel, canonical entry packed for its plan, batch).  Only
# the sites a hand-written kernel serves have one; engine.solve's scan-step
# route is described beside kernel 1 (SCAN_ENTRY).
SITE_TO_KERNEL = {
    "engine.solve": ("fused_steps_kernel", "fused/n8", 1),
    "parallel.solve_group": ("fused_steps_batched_kernel",
                             "fused_batched/n8b3", 3),
}
SCAN_SITES = {"engine.solve": "scan/n8"}
# mesh sites -> their canonical entry: no hand-written kernel serves a mesh
# (the sharded steps are eager torch ops on every shard), and kernel.txt
# says so
MESH_SITES = {"parallel.sharded": "sharded_group/n8b2",
              "parallel.interleave_sharded": "interleave_sharded/n8t2"}

# fault code -> injection kind producing the same code through the real
# classifier (runtime/guard.classify_device_error); used for the repro spec.
_CODE_TO_KIND = {
    "DeviceOOM": "oom",
    "CompileTimeout": "hang",
    "ExecuteTimeout": "hang",
    "NumericCorruption": "corrupt",
}

_state: Dict[str, Any] = {  # guarded by _dump_lock
    "config": None,          # dict(dir, argv, max_bundles, capture_ir)
    "in_dump": False,
    "seq": 0,
    "bundles": [],           # paths dumped this process, oldest first
    "degradations": [],      # ladder + breaker transitions noted since install
}

# Serializes dump + prune across threads.  RLock (not Lock) because the dump
# path may classify a *new* fault on the same thread; that recursion is cut
# by `in_dump`, not by deadlocking here.
_dump_lock = threading.RLock()


def install(directory: str, *, argv: Optional[List[str]] = None,
            max_bundles: int = DEFAULT_MAX_BUNDLES,
            capture_ir: bool = True) -> None:
    """Arm the recorder.  ``argv`` is the command line quoted into each
    bundle's repro line (program name first)."""
    os.makedirs(directory, exist_ok=True)
    with _dump_lock:
        _state["config"] = {
            "dir": directory,
            "argv": list(argv) if argv else [],
            "max_bundles": max(1, int(max_bundles)),
            "capture_ir": bool(capture_ir),
        }
        _state["bundles"] = []
        _state["degradations"] = []


def installed() -> bool:
    with _dump_lock:
        return _state["config"] is not None


def uninstall() -> None:
    with _dump_lock:
        _state["config"] = None
        _state["bundles"] = []
        _state["degradations"] = []


def bundle_paths() -> List[str]:
    """Bundles dumped by this process, oldest first (pruned ones removed)."""
    with _dump_lock:
        paths = list(_state["bundles"])
    return [p for p in paths if os.path.isdir(p)]


def on_degradation(fault, next_rung: str) -> None:
    """degrade._record's hook: note a ladder transition for the manifest."""
    with _dump_lock:
        if _state["config"] is None:
            return
        ring = _state["degradations"]
        ring.append(f"{getattr(fault, 'code', type(fault).__name__)}"
                    f"@{getattr(fault, 'site', '') or '?'} -> {next_rung}")
        del ring[:-64]


def on_breaker(site: str, rung: str, old_state: str, new_state: str) -> None:
    """serve/breaker's hook: note a circuit-breaker transition so the next
    bundle's manifest shows the breaker history alongside ladder moves."""
    with _dump_lock:
        if _state["config"] is None:
            return
        ring = _state["degradations"]
        ring.append(f"breaker {site}/{rung}: {old_state} -> {new_state}")
        del ring[:-64]


def on_fault(fault) -> Optional[str]:
    """guard._record_fault_event's hook: dump a bundle for a classified
    fault.  Returns the bundle path, or None (not installed / re-entrant /
    dump failed — failures are reported to stderr, never raised).  Safe to
    call from concurrent threads: dumps serialize on a module lock."""
    # benign double-checked fast path: a stale read can only skip or
    # attempt a dump; the decision that matters is re-validated under
    # _dump_lock two lines down
    if _state["config"] is None or _state["in_dump"]:
        return None
    with _dump_lock:
        # re-check under the lock: another thread may have uninstalled the
        # recorder while we waited, and same-thread recursion re-enters here
        if _state["config"] is None or _state["in_dump"]:
            return None
        _state["in_dump"] = True
        try:
            return _dump(fault)
        except Exception as exc:
            sys.stderr.write(f"obs.flight: bundle dump failed: {exc}\n")
            return None
        finally:
            _state["in_dump"] = False


class _StrictFailure:
    """Fault-shaped stand-in for a --strict exit (no exception raised)."""

    code = "StrictDegraded"

    def __init__(self, detail: str, site: str = ""):
        self.site = site
        self.detail = {"reason": detail}
        self._message = detail

    def __str__(self) -> str:
        return self._message


def on_strict(detail: str) -> Optional[str]:
    """CLI hook: a --strict run is about to exit non-zero because the solve
    degraded; bundle the telemetry even though nothing raised."""
    return on_fault(_StrictFailure(detail))


def load_bundle(path: str) -> Dict[str, Any]:
    """Round-trip a bundle directory back into dicts (triage tooling and
    the chaos drills both go through this)."""
    with open(os.path.join(path, MANIFEST_NAME), encoding="utf-8") as fh:
        manifest = json.load(fh)
    out: Dict[str, Any] = {"manifest": manifest, "spans": [], "events": [],
                           "metrics": "", "kernel": None}
    spans_path = os.path.join(path, "spans.jsonl")
    if os.path.exists(spans_path):
        with open(spans_path, encoding="utf-8") as fh:
            out["spans"] = [json.loads(line) for line in fh if line.strip()]
    events_path = os.path.join(path, "events.jsonl")
    if os.path.exists(events_path):
        with open(events_path, encoding="utf-8") as fh:
            out["events"] = [json.loads(line) for line in fh if line.strip()]
    metrics_path = os.path.join(path, "metrics.prom")
    if os.path.exists(metrics_path):
        with open(metrics_path, encoding="utf-8") as fh:
            out["metrics"] = fh.read()
    kernel_path = os.path.join(path, KERNEL_FILE)
    if os.path.exists(kernel_path):
        with open(kernel_path, encoding="utf-8") as fh:
            out["kernel"] = fh.read()
    return out


# ---------------------------------------------------------------------------
# dump internals
# ---------------------------------------------------------------------------

def _repro(fault) -> Dict[str, Any]:  # caller holds _dump_lock
    from ..runtime import faults
    site = getattr(fault, "site", "") or ""
    code = getattr(fault, "code", "") or ""
    spec = ""
    if site in faults.SITES:
        spec = f"{site}:{_CODE_TO_KIND.get(code, 'error')}"
    argv = _state["config"]["argv"]
    if argv:
        cmd = " ".join(shlex.quote(a) for a in argv)
    else:
        cmd = "<re-run the failing command>"
    prefix = f"{faults.ENV_VAR}={shlex.quote(spec)} " if spec else ""
    return {
        "env": {faults.ENV_VAR: spec} if spec else {},
        "argv": argv,
        "line": prefix + cmd,
    }


def _platform_info() -> Dict[str, Any]:
    info: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": platform_mod.platform(),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(("CC_", "CUDA_", "TORCH_"))},
    }
    try:
        import torch
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        info["device"] = (torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else "cpu")
    except Exception:
        pass
    return info


def _kernel_lines(kernel: str, entry_name: str, b: int) -> List[str]:
    """The kernel's name, the launch plan of its site's canonical entry
    (the card's cluster slots when there is a card, the nominal ones
    otherwise), the grid and plane shapes, this process's last launch plan,
    the nvcc flags and the source hash."""
    import hashlib

    import torch

    from ..engine import fused, fused_batched
    from ..engine import simulator as sim
    from . import entries

    n = int(entry_name.split("/n")[1].split("b")[0])
    pb = entries.problem(n)
    pk = fused._pack_meta(sim.static_config(pb), pb)
    npad = pk.meta.s * fused.LANES
    n_const, n_carry = len(pk.const_names), len(pk.carry_names)
    if torch.cuda.is_available():
        plan = fused.card_plan(npad, n_const, n_carry, b)
        slots = "the card's cluster slots"
    else:
        plan = fused.launch_plan(npad, n_const, n_carry, b)
        slots = f"nominal cluster slots (N_SM // C, N_SM = {fused.N_SM})"
    last = (fused.LAST_PLAN if kernel == "fused_steps_kernel"
            else fused_batched.LAST_PLAN)
    with open(fused._SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    lead = f"[{b}, " if b > 1 else "["
    return [
        f"kernel: {kernel} ({os.path.relpath(fused._SRC, _ROOT)})",
        f"entry: {entry_name} ({n} nodes, batch {b})",
        f"launch_plan ({slots}): cluster {plan.cluster}, resident planes "
        f"{plan.resident_scratch} scratch + {plan.resident_carry} carry + "
        f"{plan.resident_const} const",
        f"plan: {plan.describe()}",
        f"grid: {b * plan.cluster} CTAs ({b} x cluster {plan.cluster}), "
        f"{plan.threads} threads each",
        f"planes: const {lead}{n_const}, {pk.meta.s}, {fused.LANES}] f32, "
        f"carry {lead}{n_carry}, {pk.meta.s}, {fused.LANES}] f32",
        f"last launch in this process: "
        f"{last.describe() if last is not None else 'none'}",
        f"nvcc flags: {' '.join(fused.NVCC_FLAGS)}",
        f"source sha256: {digest}",
    ]


def _scan_lines(entry_name: str) -> List[str]:
    """The aten ops of one scan step of the site's canonical entry, counted
    on the CPU, and the steps a captured CUDA graph replays."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..engine import simulator as sim
    from . import entries

    class _Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    n = int(entry_name.split("/n")[1])
    pb = entries.problem(n, affinity=True)
    cfg = sim.static_config(pb)
    consts = sim.build_consts(pb, torch.device("cpu"))
    carry = sim._init_carry(pb, consts)
    with _Count() as count:
        sim._step(cfg, consts, carry)
    return [
        f"scan step: engine/simulator._step on {entry_name} "
        f"({n} nodes, float32)",
        f"aten ops per step: {count.ops}",
        f"captured graph: {sim._GRAPH_STEPS} steps a replay, "
        f"{count.ops * sim._GRAPH_STEPS} ops; LRU of {sim._GRAPH_CACHE} "
        f"graphs",
    ]


def _capture_kernel(site: str) -> tuple:
    """(kernel.txt text, entry name) for the failing site, or (None, note)
    for a site no kernel or captured step serves."""
    from ..runtime import faults
    if site in MESH_SITES:
        return (f"site: {site} (canonical entry {MESH_SITES[site]})\n"
                f"no hand-written kernel serves the mesh path: the sharded "
                f"step runs as eager PyTorch ops on every shard "
                f"(parallel/mesh.py), as the JAX package's meshes run XLA "
                f"and its Pallas kernels are single-device\n",
                MESH_SITES[site])
    kern = SITE_TO_KERNEL.get(site)
    if kern is None:
        return None, (f"no kernel serves site {site!r} (host or plain "
                      f"PyTorch ops)")
    lines: List[str] = []
    with faults.suspended():
        lines += _kernel_lines(*kern)
        if site in SCAN_SITES:
            lines += ["", "beside it, for problems outside the kernel's "
                      "envelope:"] + _scan_lines(SCAN_SITES[site])
    return "\n".join(lines) + "\n", kern[1]


def _dump(fault) -> str:  # caller holds _dump_lock
    from ..runtime import faults
    from ..utils.events import default_recorder

    cfg = _state["config"]
    # snapshot telemetry FIRST, before kernel.txt's packing runs
    span_tail = spans_mod.default_collector.spans()[-MAX_BUNDLE_SPANS:]
    span_events = export.trace_events(span_tail)
    metrics_text = metrics_mod.default_registry.render()
    event_tail = default_recorder.tail(MAX_BUNDLE_EVENTS)
    injected = faults.installed_specs()

    code = getattr(fault, "code", type(fault).__name__)
    _state["seq"] += 1
    name = f"flight-{_state['seq']:03d}-{code}"
    path = os.path.join(cfg["dir"], name)
    while os.path.exists(path):  # collision across processes
        _state["seq"] += 1
        name = f"flight-{_state['seq']:03d}-{code}"
        path = os.path.join(cfg["dir"], name)
    os.makedirs(path)

    files = ["spans.jsonl", "metrics.prom", "events.jsonl"]
    with open(os.path.join(path, "spans.jsonl"), "w",
              encoding="utf-8") as fh:
        for ev in span_events:
            fh.write(json.dumps(ev) + "\n")
    with open(os.path.join(path, "metrics.prom"), "w",
              encoding="utf-8") as fh:
        fh.write(metrics_text)
    with open(os.path.join(path, "events.jsonl"), "w",
              encoding="utf-8") as fh:
        for ev in event_tail:
            fh.write(json.dumps({
                "reason": ev.reason, "message": ev.message,
                "object": ev.object_name, "ts": ev.timestamp}) + "\n")

    ir: Dict[str, Any] = {}
    if cfg["capture_ir"]:
        text, note = _capture_kernel(getattr(fault, "site", "") or "")
        if text is not None:
            with open(os.path.join(path, KERNEL_FILE), "w",
                      encoding="utf-8") as fh:
                fh.write(text)
            files.append(KERNEL_FILE)
            ir = {"entry": note, "file": KERNEL_FILE}
        else:
            ir = {"note": note}
    else:
        ir = {"note": "ir capture disabled"}

    manifest = {
        "schema": FLIGHT_SCHEMA,
        "created": time.time(),
        "fault": {
            "code": code,
            "site": getattr(fault, "site", "") or "",
            "message": str(fault),
            "detail": getattr(fault, "detail", None),
        },
        "injected": injected,
        "degradations": list(_state["degradations"]),
        "platform": _platform_info(),
        "repro": _repro(fault),
        "ir": ir,
        "files": files,
    }
    tmp = os.path.join(path, MANIFEST_NAME + ".tmp")
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=2, default=str)
        fh.write("\n")
    os.replace(tmp, os.path.join(path, MANIFEST_NAME))

    _state["bundles"].append(path)
    metrics_mod.default_registry.inc(names.FLIGHT_BUNDLES, code=code)
    _prune(cfg)
    sys.stderr.write(f"obs.flight: wrote {path}\n")
    return path


def _prune(cfg: Dict[str, Any]) -> None:  # caller holds _dump_lock
    """Keep only the newest max_bundles bundle dirs in the flight dir."""
    import shutil
    try:
        entries = [os.path.join(cfg["dir"], n)
                   for n in os.listdir(cfg["dir"])
                   if n.startswith("flight-")]
        entries = [p for p in entries if os.path.isdir(p)]
        entries.sort(key=lambda p: (os.path.getmtime(p), p))
        for stale in entries[:-cfg["max_bundles"]]:
            shutil.rmtree(stale, ignore_errors=True)
    except OSError:
        pass
