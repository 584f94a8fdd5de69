"""hypercc: busybox-style multiplexer over the CLI front-ends.

Mirrors the reference's cmd/hypercc/main.go:30-39 — dispatch on the
basename the binary was invoked as (or the first argument):
`cluster-capacity`, `genpod`, `explain`, or the `hypercc` umbrella, plus
`--version` / `version`.  `python -m cluster_capacity_tpu_torch` routes
here.  The JAX package's `profile`, `resilience` and `serve` subcommands are
refused by name (exit 2) until their slices land.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from . import cluster_capacity as cc_cli
from . import explain as explain_cli
from . import genpod as genpod_cli

_COMMANDS = {
    "cluster-capacity": cc_cli.run,
    "genpod": genpod_cli.run,
    "explain": explain_cli.run,
}

# Subcommands of the JAX package's hypercc that this package does not run yet.
_LATER_COMMANDS = ("profile", "resilience", "serve")


def run(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("--version", "version"):
        from ..utils.version import get
        print(f"hypercc {get()}")
        return 0
    base = os.path.basename(sys.argv[0]) if sys.argv else "hypercc"
    if base in _COMMANDS:
        return _COMMANDS[base](argv, prog=base)
    if argv and argv[0] in _COMMANDS:
        cmd = argv[0]
        return _COMMANDS[cmd](argv[1:], prog=cmd)
    if argv and argv[0] in _LATER_COMMANDS:
        print(f"Error: {argv[0]} is not ported yet (ROADMAP: port queue, "
              f"later slices)", file=sys.stderr)
        return 2
    prog = "hypercc"
    print(f"usage: {prog} <command> [flags]\n\ncommands:\n"
          "  cluster-capacity   estimate schedulable instances of a pod\n"
          "  genpod             generate a pod spec from namespace limits\n"
          "  explain            why-not / why-here / bottleneck attribution "
          "for one solve\n",
          file=sys.stderr)
    return 0 if argv and argv[0] in ("-h", "--help") else 1


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
