"""Guarded-dispatch time/memory attribution and programmatic profiler
capture.

Three surfaces, all fed from the guard.run choke point:

1. per-dispatch accounting — ``guard_span`` (obs/spans.py) accumulates
   ``cc_device_seconds_total{site,rung,phase}`` for every guarded call (the
   host wall time inside the guard, whatever of it the card was busy: the
   device's own time is in the profiler's trace, surface 3) and,
   when memory sampling is on, asks this module to sample the card's
   ``torch.cuda.memory_stats()`` watermark into ``cc_device_peak_bytes`` and
   the span's attrs (so watermarks ride into the trace JSONL for free);
2. aggregation — ``attribution()`` folds the span buffer into site × rung ×
   phase rows (calls, guarded wall seconds as ``device_s``, compile
   seconds, batch volume, fault count, peak bytes) and ``render_attribution()`` prints the table the
   ``hypercc profile`` subcommand shows;
3. capture — ``capture(out_dir)`` runs the block under ``torch.profiler``
   (CPU activity, and CUDA activity on the card) and exports a Chrome trace
   into ``out_dir``; a profiler failure is reported to stderr and the block
   runs on without it, and memory sampling is on for the block.  Every
   collector span opened in the block is a range of the trace
   (obs/spans.py).

Import discipline: torch is only imported inside functions, and only its
host-side queries are touched (``memory_stats`` reads the caching
allocator's counters — never a device sync).
"""

from __future__ import annotations

import contextlib
import json
import os
import itertools
import sys
from typing import Any, Dict, List, Optional

from ..utils import metrics as metrics_mod
from . import names
from . import spans as spans_mod

ATTRIBUTION_SCHEMA = "cc-attribution/1"

# Process-wide sampling switch: memory_stats() is cheap but not free, so the
# per-dispatch watermark sample is opt-in (capture() turns it on; the
# always-on path pays only this dict lookup).  Toggled before worker threads
# start; readers only observe a stable bool slot (GIL-atomic read).
_sampling = {"memory": False}


def enable_memory_sampling(on: bool = True) -> None:
    _sampling["memory"] = bool(on)


def memory_sampling_enabled() -> bool:
    return _sampling["memory"]


def device_memory_stats() -> Optional[Dict[str, Any]]:
    """``torch.cuda.memory_stats()`` of the current card, or None on the
    CPU (no card, or the caching allocator not initialised yet)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    if not isinstance(stats, dict) or not stats:
        return None
    return stats


def _peak_bytes(stats: Optional[Dict[str, Any]]) -> Optional[int]:
    """The allocator's peak of allocated bytes (the number
    ``torch.cuda.max_memory_allocated`` reports)."""
    if not stats:
        return None
    v = stats.get("allocated_bytes.all.peak")
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return int(v)
    return None


def sample_watermark() -> Optional[int]:
    """Current device-memory watermark in bytes; records the gauge.  None
    (and no gauge write) where the backend has no memory stats."""
    peak = _peak_bytes(device_memory_stats())
    if peak is not None:
        metrics_mod.default_registry.set_gauge(names.DEVICE_PEAK_BYTES, peak)
    return peak


def maybe_sample(sp: spans_mod.Span) -> None:
    """guard_span's per-dispatch hook: watermark into the span attrs when
    sampling is enabled.  Fast no-op otherwise."""
    if not _sampling["memory"]:
        return
    peak = sample_watermark()
    if peak is not None:
        sp.attrs["mem_peak_bytes"] = peak


TRACE_PREFIX = "torch-trace"
_trace_seq = itertools.count(1)


def _start_profiler():
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _trace_path(out_dir: str) -> str:
    return os.path.join(out_dir, f"{TRACE_PREFIX}-{os.getpid()}-"
                                 f"{next(_trace_seq)}.json")


def _stop_profiler(prof, out_dir: str) -> str:
    """Stop `prof` and export its Chrome trace into `out_dir`; returns the
    trace file's path."""
    prof.stop()
    path = _trace_path(out_dir)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def capture(out_dir: Optional[str] = None, *, memory: bool = True):
    """Run a block under programmatic torch.profiler capture.

    ``out_dir`` is the profiler trace directory (created if missing); the
    Chrome trace lands there as ``torch-trace-<pid>-<n>.json``.  Pass None
    to skip the profiler and only enable watermark sampling.  Profiler
    failures are reported to stderr and swallowed — profiling must never
    take a solve down.
    """
    prof = None
    prev_mem = _sampling["memory"]
    if memory:
        enable_memory_sampling(True)
    if out_dir:
        try:
            os.makedirs(out_dir, exist_ok=True)
            prof = _start_profiler()
        except Exception as exc:
            sys.stderr.write(f"obs.profile: torch.profiler capture "
                             f"unavailable ({exc}); continuing without\n")
    try:
        yield
    finally:
        _sampling["memory"] = prev_mem
        if prof is not None:
            try:
                _stop_profiler(prof, out_dir)
            except Exception as exc:
                sys.stderr.write(f"obs.profile: profiler stop/export "
                                 f"failed: {exc}\n")


def attribution(span_list: Optional[List[spans_mod.Span]] = None
                ) -> List[Dict[str, Any]]:
    """Fold sited spans into site × rung × phase attribution rows, ordered
    by descending device seconds."""
    if span_list is None:
        span_list = spans_mod.default_collector.spans()
    rows: Dict[tuple, Dict[str, Any]] = {}
    for sp in span_list:
        if not sp.site:
            continue
        key = (sp.site, sp.rung or "-", sp.phase or "-")
        row = rows.get(key)
        if row is None:
            row = rows[key] = {
                "site": key[0], "rung": key[1], "phase": key[2],
                "calls": 0, "device_s": 0.0, "compile_s": 0.0,
                "batch": 0, "faults": 0, "mem_peak_bytes": None,
            }
        row["calls"] += 1
        row["device_s"] += sp.duration_s or 0.0
        row["compile_s"] += sp.compile_s
        row["batch"] += sp.batch or 0
        if sp.outcome not in ("", "ok"):
            row["faults"] += 1
        peak = sp.attrs.get("mem_peak_bytes")
        if isinstance(peak, (int, float)) and not isinstance(peak, bool):
            prev = row["mem_peak_bytes"]
            row["mem_peak_bytes"] = int(max(prev or 0, peak))
    out = sorted(rows.values(),
                 key=lambda r: (-r["device_s"], r["site"], r["rung"]))
    for row in out:
        row["device_s"] = round(row["device_s"], 6)
        row["compile_s"] = round(row["compile_s"], 6)
    return out


def device_summary(span_list: Optional[List[spans_mod.Span]] = None
                   ) -> Dict[str, Any]:
    """Compact per-run roll-up for bench artifacts: total guarded device
    seconds, attributed compile seconds, the per-site split, and the memory
    watermark when the backend exposed one."""
    rows = attribution(span_list)
    sites: Dict[str, float] = {}
    peak: Optional[int] = None
    total = compile_s = 0.0
    for row in rows:
        total += row["device_s"]
        compile_s += row["compile_s"]
        sites[row["site"]] = round(
            sites.get(row["site"], 0.0) + row["device_s"], 6)
        if row["mem_peak_bytes"] is not None:
            peak = max(peak or 0, row["mem_peak_bytes"])
    out: Dict[str, Any] = {
        "device_s": round(total, 6),
        "compile_s": round(compile_s, 6),
        "sites": dict(sorted(sites.items())),
    }
    if peak is not None:
        out["mem_peak_bytes"] = peak
    return out


def render_attribution(rows: Optional[List[Dict[str, Any]]] = None) -> str:
    """The attribution table ``hypercc profile`` prints."""
    if rows is None:
        rows = attribution()
    if not rows:
        return "no guarded dispatches recorded\n"
    headers = ("site", "rung", "phase", "calls", "device_s", "compile_s",
               "batch", "faults", "mem_peak")
    table: List[tuple] = [headers]
    for r in rows:
        mem = ("-" if r["mem_peak_bytes"] is None
               else f"{r['mem_peak_bytes'] / 1e6:.1f}MB")
        table.append((r["site"], r["rung"], r["phase"], str(r["calls"]),
                      f"{r['device_s']:.4f}", f"{r['compile_s']:.4f}",
                      str(r["batch"]), str(r["faults"]), mem))
    widths = [max(len(row[i]) for row in table) for i in range(len(headers))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths))
                     .rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines) + "\n"


def write_attribution(path: str,
                      rows: Optional[List[Dict[str, Any]]] = None,
                      extra: Optional[Dict[str, Any]] = None) -> None:
    """Attribution rows as a JSON artifact (atomic: temp + rename)."""
    if rows is None:
        rows = attribution()
    doc: Dict[str, Any] = {"schema": ATTRIBUTION_SCHEMA, "rows": rows}
    if extra:
        doc.update(extra)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
    os.replace(tmp, path)
