"""Version info (pkg/version/version.go analog: ldflags-injected build info
with regex major/minor split; here populated from package metadata/env)."""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

from .. import __version__


@dataclass(frozen=True)
class Info:
    version: str
    major: str
    minor: str
    git_sha: str
    build_date: str

    def __str__(self) -> str:
        return self.version


def get() -> Info:
    """version.Get() (version.go:55-69): split major/minor from the version
    string; sha/date from build env when present."""
    m = re.match(r"^v?(\d+)\.(\d+)", __version__)
    major, minor = (m.group(1), m.group(2)) if m else ("", "")
    return Info(version=__version__, major=major, minor=minor,
                git_sha=os.environ.get("CC_GIT_SHA", ""),
                build_date=os.environ.get("CC_BUILD_DATE", ""))
