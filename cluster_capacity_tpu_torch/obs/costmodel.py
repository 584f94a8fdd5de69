"""Cost-model calibration: measured entry cost vs the static budgets.

The repo pins a static cost model per canonical ladder entry (FLOPs and
live bytes, tools/irgate/budgets.json, read here as a JSON data file).  The
FLOPs count the work of each entry at its tiny canonical shape, and that
work is the same whatever implements it, so the port's entries
(obs/entries.py, the same names and shapes) are held to the same pins.
This module joins measured device seconds (and memory watermarks where
available) against those pins and asks one question per entry: *is the
kernel achieving the platform's calibrated FLOPs rate?*

The yardstick is self-calibrating: each entry's achieved rate is
``flops / device_s``, and the calibrated platform rate is the **median**
achieved rate across entries — robust, so a single drifted kernel cannot
move its own yardstick.  Efficiency is
``rate / calibrated_rate``: ~1.0 across the board on a healthy run, and an
entry that got 4× slower shows ~0.25 and is flagged by name with its
ratio.  Host-side entries with a zero-FLOPs budget (the oracle rung) have
no device rate by construction and report efficiency 1.0 by convention.

Import discipline: stdlib only (budgets.json is read with ``json``;
nothing of tools/ is imported).
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Any, Dict, List, Optional

from ..utils import metrics as metrics_mod
from . import names

CALIBRATION_SCHEMA = "cc-calibration/1"

# Flag threshold: an entry below half the calibrated rate is drifting.
DEFAULT_FLAG_BELOW = 0.5

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_BUDGETS_PATH = os.path.normpath(os.path.join(
    _HERE, "..", "..", "tools", "irgate", "budgets.json"))


def load_budgets(path: str = DEFAULT_BUDGETS_PATH
                 ) -> Optional[Dict[str, Any]]:
    """The budgets doc, or None when the pins are absent (a tree without
    tools/irgate/budgets.json)."""
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def _budget_entries(budgets: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    if not budgets:
        return {}
    entries = budgets.get("entries", budgets)
    return entries if isinstance(entries, dict) else {}


def calibrate(measured: Dict[str, Dict[str, Any]],
              budgets: Optional[Dict[str, Any]] = None,
              *, flag_below: float = DEFAULT_FLAG_BELOW,
              platform: str = "") -> Dict[str, Any]:
    """Join measured entry costs against the static budgets.

    ``measured`` maps entry name -> {"device_s": seconds, optionally
    "rung" and "mem_peak_bytes"}; ``budgets`` is the budgets doc
    (or its flat "entries" map).  Returns the calibration report dict
    (schema cc-calibration/1) with an efficiency ratio present for every
    measured entry.
    """
    pins = _budget_entries(budgets if budgets is not None
                           else load_budgets())
    rates: Dict[str, float] = {}
    for name, m in measured.items():
        pin = pins.get(name) or {}
        flops = float(pin.get("flops", 0) or 0)
        dt = float(m.get("device_s", 0.0) or 0.0)
        if flops > 0 and dt > 0:
            rates[name] = flops / dt
    calibrated = statistics.median(rates.values()) if rates else 0.0

    entries: Dict[str, Any] = {}
    flagged: List[Dict[str, Any]] = []
    for name in sorted(measured):
        m = measured[name]
        pin = pins.get(name) or {}
        flops = float(pin.get("flops", 0) or 0)
        live = float(pin.get("live_bytes", 0) or 0)
        dt = float(m.get("device_s", 0.0) or 0.0)
        rate = rates.get(name)
        note = ""
        if rate is not None and calibrated > 0:
            efficiency = rate / calibrated
        else:
            # host rung / missing pin: no device rate exists, so the entry
            # is definitionally at par — present, never flagged
            efficiency = 1.0
            note = ("host-side entry: zero-FLOPs budget" if flops <= 0
                    else "no measurement")
        peak = m.get("mem_peak_bytes")
        mem_ratio = (round(float(peak) / live, 4)
                     if isinstance(peak, (int, float)) and live > 0
                     else None)
        entry: Dict[str, Any] = {
            "rung": m.get("rung", ""),
            "flops": flops,
            "live_bytes": live,
            "device_s": round(dt, 6),
            "flops_per_sec": round(rate, 2) if rate is not None else None,
            "efficiency": round(efficiency, 4),
        }
        if mem_ratio is not None:
            entry["mem_ratio"] = mem_ratio
        # compile attribution (cli/profile.py tallies the warmup call):
        # rides into calibration.json so compile creep is visible next to
        # the efficiency it eventually erodes
        comp = m.get("compile_s")
        if isinstance(comp, (int, float)):
            entry["compile_s"] = round(float(comp), 6)
        if note:
            entry["note"] = note
        entries[name] = entry
        if rate is not None and efficiency < flag_below:
            flagged.append({
                "entry": name,
                "efficiency": round(efficiency, 4),
                "message": (f"{name}: efficiency {efficiency:.2f} below "
                            f"{flag_below:g} — measured "
                            f"{rate:.0f} flops/s vs calibrated "
                            f"{calibrated:.0f} flops/s"),
            })
    return {
        "schema": CALIBRATION_SCHEMA,
        "platform": platform,
        "calibrated_flops_per_sec": round(calibrated, 2),
        "flag_below": flag_below,
        "entries": entries,
        "flagged": flagged,
    }


def to_registry(report: Dict[str, Any], registry=None) -> None:
    """Export per-entry efficiency as cc_kernel_efficiency gauges."""
    registry = registry or metrics_mod.default_registry
    for name, entry in report.get("entries", {}).items():
        eff = entry.get("efficiency")
        if eff is None:
            continue
        registry.set_gauge(names.KERNEL_EFFICIENCY, float(eff),
                           entry=name, rung=entry.get("rung", "") or "-")


def render_calibration(report: Dict[str, Any]) -> str:
    """The calibration table ``hypercc profile`` prints."""
    entries = report.get("entries", {})
    if not entries:
        return "no calibration entries\n"
    headers = ("entry", "rung", "flops", "device_s", "flops/s",
               "efficiency", "mem_ratio")
    table: List[tuple] = [headers]
    for name in sorted(entries):
        e = entries[name]
        rate = e.get("flops_per_sec")
        table.append((
            name, e.get("rung", "") or "-", f"{e['flops']:.0f}",
            f"{e['device_s']:.4f}",
            "-" if rate is None else f"{rate:.0f}",
            f"{e['efficiency']:.3f}",
            "-" if e.get("mem_ratio") is None else f"{e['mem_ratio']:.2f}",
        ))
    widths = [max(len(row[i]) for row in table) for i in range(len(headers))]
    lines = [f"calibrated rate: "
             f"{report.get('calibrated_flops_per_sec', 0):.0f} flops/s"]
    for i, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths))
                     .rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    for flag in report.get("flagged", []):
        lines.append(f"FLAGGED: {flag['message']}")
    return "\n".join(lines) + "\n"


def write_calibration(path: str, report: Dict[str, Any]) -> None:
    """Calibration report as a JSON artifact (atomic: temp + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2)
        fh.write("\n")
    os.replace(tmp, path)
