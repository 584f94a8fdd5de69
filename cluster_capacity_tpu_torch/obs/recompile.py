"""Compile counter: the port's compiles → registry + span attribution.

Three things compile in this package, and each calls `record_compile` with
its seconds:

- the first-use nvcc build (or load) of csrc/fused_steps.cu
  (engine/fused._load);
- the native libccsnap build (models/native._load);
- each CUDA-graph capture of the scan or explain step
  (engine/simulator._graph_for; its LRU holds a few graphs, so a capture
  after an eviction counts again).

`record_compile` always charges the seconds, and one compile, to the
innermost open *sited* span (its `compile_s` and `compiles`), which is how
a guard span's wall time splits into compile vs execute.  Once the hook is
installed it also increments cc_recompiles_total /
cc_compile_seconds_total and feeds every open CompileTally.  On the CPU an
eager run compiles nothing, so the count stays 0 there.

`install_recompile_hook()` keeps the one-shot, opt-in contract of the JAX
package's listener for the counters and tallies: until it is called (the
CLIs call it for --metrics-dump/--trace-out runs, `hypercc profile` always
does, and CompileTally does on first use) they record nothing.
"""

from __future__ import annotations

import threading

from ..utils import metrics as metrics_mod
from . import names
from . import spans as spans_mod

_lock = threading.Lock()
_installed = False  # guarded by _lock
_registry = None  # guarded by _lock
# live CompileTally sinks: scoped measurement subscribes/unsubscribes here
_tallies: list = []  # guarded by _lock


class CompileTally:
    """Scoped compile tally: counts compiles and compile seconds recorded
    while the ``with`` block is open.  Installs the process-wide hook on
    first use and registers itself as a sink for its lifetime."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0

    def __enter__(self) -> "CompileTally":
        install_recompile_hook()
        with _lock:
            _tallies.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _lock:
            if self in _tallies:
                _tallies.remove(self)


def install_recompile_hook(registry=None) -> bool:
    """Turn on the registry counters once; returns True when this call did
    the installation."""
    global _installed, _registry
    with _lock:
        if _installed:
            return False
        _installed = True
        _registry = registry or metrics_mod.default_registry
    return True


def installed() -> bool:
    with _lock:
        return _installed


def record_compile(seconds: float) -> None:
    """One compile of `seconds`: the innermost open sited span always; the
    counters and every open tally once the hook is installed."""
    sp = spans_mod.default_collector.active_sited()
    if sp is not None:
        sp.compile_s += seconds
        sp.compiles += 1
    with _lock:
        if not _installed:
            return
        reg = _registry
        sinks = tuple(_tallies)
    reg.inc(names.RECOMPILES)
    reg.inc(names.COMPILE_SECONDS, seconds)
    for tally in sinks:
        tally.count += 1
        tally.seconds += seconds
