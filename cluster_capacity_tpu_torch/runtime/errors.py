"""Structured error taxonomy of the hardened runtime.

Every failure the solve supervisor knows how to recover from is a
RuntimeFault subclass with a stable `code` (machine-readable, shows up in
reports), the dispatch `site` it was observed at, and a free-form `detail`
dict.  Anything that is NOT a RuntimeFault — a CUDA launch the plan refuses,
a failed kernel build, an illegal address, a plain Python bug — propagates
raw on purpose: degrading would paper over an engine defect, while
OOM/timeout/corruption are environmental and the ladder's rungs serve the
same numbers.

A leaf module (no package imports) so models/ and utils/ can raise these
without cycles.  The classes, codes and string forms match the JAX
package's ``runtime/errors.py``.
"""

from __future__ import annotations

from typing import Optional


class RuntimeFault(Exception):
    """Base class: a classified solve failure with a stable `code`."""

    code = "RuntimeFault"

    def __init__(self, message: str = "", *, site: str = "",
                 detail: Optional[dict] = None):
        super().__init__(message)
        self.site = site
        self.detail = dict(detail or {})

    def __str__(self) -> str:
        base = super().__str__()
        return f"[{self.code}@{self.site}] {base}" if self.site \
            else f"[{self.code}] {base}"


class DeviceOOM(RuntimeFault):
    """Device allocation failure (torch.cuda.OutOfMemoryError, CUDA's "out
    of memory" status, host MemoryError).  Recoverable: split the batch or
    drop a rung."""

    code = "DeviceOOM"


class CompileTimeout(RuntimeFault):
    """A compile-phase dispatch (kernel build, first batched launch) did not
    finish within the wall-clock deadline."""

    code = "CompileTimeout"


class ExecuteTimeout(RuntimeFault):
    """A dispatched computation did not produce results within the
    wall-clock deadline."""

    code = "ExecuteTimeout"


class NumericCorruption(RuntimeFault):
    """A solve returned planes that cannot be valid: NaN counts, negative
    placement indices, counts disagreeing with the placement list."""

    code = "NumericCorruption"


class SnapshotValidationError(RuntimeFault):
    """Malformed or partial snapshot input.  `field_path` names the exact
    offending field (e.g. ``nodes[3].status.allocatable.cpu``)."""

    code = "SnapshotValidation"

    def __init__(self, message: str = "", *, field_path: str = "",
                 site: str = "", detail: Optional[dict] = None):
        detail = dict(detail or {})
        if field_path:
            detail.setdefault("field_path", field_path)
        super().__init__(message, site=site, detail=detail)
        self.field_path = field_path

    def __str__(self) -> str:
        base = Exception.__str__(self)
        path = f" at {self.field_path}" if self.field_path else ""
        return f"[{self.code}{path}] {base}"


class CheckpointCorruption(RuntimeFault):
    """A .npz checkpoint bundle or scenario journal failed its checksum,
    is truncated, or belongs to a different run."""

    code = "CheckpointCorruption"
