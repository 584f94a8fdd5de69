"""Error types shared by the snapshot loaders.

A leaf module (no package imports) so models/ and utils/ can raise these
without cycles.  The classes and their string forms match the JAX package's
``runtime/errors.py``, so a malformed snapshot reads the same in both.
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
