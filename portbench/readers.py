"""Arithmetic the metric readers under metrics/ share."""

from __future__ import annotations

from typing import Optional

from portbench.harness import RunInfo
from portbench.reference import roofline


def completed(info: RunInfo):
    return [a for a in info.answers if a.summary is not None]


def placements_per_s(info: RunInfo) -> Optional[float]:
    """All placements of the answers completed in the window over the
    window's whole time."""
    done = completed(info)
    if not done or info.window_s <= 0:
        return None
    return sum(a.placed for a in done) / info.window_s


def step_device_us(info: RunInfo) -> Optional[float]:
    """Device busy time inside the traced answer's solve, per step."""
    t = info.trace
    if t is None or not t.steps or t.solve is None or t.solve_busy_s <= 0:
        return None
    return t.solve_busy_s / t.steps * 1e6


def step_roofline(info: RunInfo) -> Optional[float]:
    """The least time for the traced solve's steps (from the cell's
    shapes) over the device time they took, in percent."""
    t = info.trace
    if t is None or not t.steps or t.solve is None or t.solve_busy_s <= 0:
        return None
    s = info.shapes
    least = roofline.least_seconds(
        int(s["nodes"]), int(s["resources"]), int(s["hard_spreads"]),
        t.steps, kind=str(s.get("kind", "")))
    return 100.0 * least["seconds"] / t.solve_busy_s


def device_idle_pct(info: RunInfo) -> Optional[float]:
    """The share of the traced slice with no kernel or copy on the card."""
    t = info.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def launches_per_step(info: RunInfo) -> Optional[float]:
    t = info.trace
    if t is None or not t.steps or t.solve is None or not t.solve_kernels:
        return None
    return t.solve_kernels / t.steps
