"""Kubernetes resource.Quantity parsing/formatting.

The reference consumes `k8s.io/apimachinery/pkg/api/resource.Quantity` values
everywhere resource amounts appear (pod requests, node allocatable).  This module
re-implements the exact subset of Quantity behaviour the scheduler depends on:

- suffix parsing: decimal SI (n, u, m, "", k, M, G, T, P, E), binary (Ki..Ei),
  and scientific notation (e.g. "1e3").
- `MilliValue()` = ceil(value * 1000)   (used for CPU)
- `Value()`      = ceil(value)          (used for memory / scalar resources)
- canonical formatting for report output (e.g. "150m", "100Mi").

Reference behaviour: vendor/k8s.io/apimachinery/pkg/api/resource/quantity.go
(consumed at e.g. pkg/framework/report.go:110-143 and
cmd/cluster-capacity/app/options/options.go:79-147).
"""

from __future__ import annotations

import functools
import math
import re
from decimal import Decimal, InvalidOperation
from fractions import Fraction

_BINARY_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}

_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
    r"(?:(?P<suffix>[numkMGTPE]|[KMGTPE]i)|(?P<exp>[eE][+-]?[0-9]+))?$"
)


class QuantityError(ValueError):
    pass


def parse_quantity(s) -> Fraction:
    """Parse a Kubernetes quantity string (or number) into an exact Fraction."""
    if isinstance(s, bool):
        raise QuantityError(f"invalid quantity {s!r}")
    if isinstance(s, int):
        return Fraction(s)
    if isinstance(s, float):
        return Fraction(Decimal(repr(s)))
    if not isinstance(s, str):
        raise QuantityError(f"invalid quantity {s!r}")
    s = s.strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise QuantityError(f"unable to parse quantity {s!r}")
    sign = -1 if m.group("sign") == "-" else 1
    try:
        base = Fraction(Decimal(m.group("num")))
    except InvalidOperation as e:  # pragma: no cover - regex should prevent
        raise QuantityError(f"unable to parse quantity {s!r}") from e
    suffix = m.group("suffix")
    exp = m.group("exp")
    if suffix in _BINARY_SUFFIXES:
        mult = Fraction(_BINARY_SUFFIXES[suffix])
    elif suffix in _DECIMAL_SUFFIXES:
        mult = _DECIMAL_SUFFIXES[suffix]
    elif suffix is None and exp:
        mult = Fraction(10) ** int(exp[1:])
    elif suffix is None:
        mult = Fraction(1)
    else:  # pragma: no cover
        raise QuantityError(f"unable to parse quantity {s!r}")
    return sign * base * mult


def milli_value(s) -> int:
    """Quantity.MilliValue(): value*1000, rounded up (away from zero for >0)."""
    if isinstance(s, str):
        return _milli_of_text(s)
    return int(math.ceil(parse_quantity(s) * 1000))


def int_value(s) -> int:
    """Quantity.Value(): rounded up to the nearest integer."""
    if isinstance(s, str):
        return _int_of_text(s)
    return int(math.ceil(parse_quantity(s)))


# A cluster repeats a handful of quantity strings across its pods (every
# clone of a template carries the same requests), and the preemption loop
# re-reads every pod each cycle: parse each distinct string once.
@functools.lru_cache(maxsize=4096)
def _milli_of_text(s: str) -> int:
    return int(math.ceil(parse_quantity(s) * 1000))


@functools.lru_cache(maxsize=4096)
def _int_of_text(s: str) -> int:
    return int(math.ceil(parse_quantity(s)))


def format_milli(milli: int) -> str:
    """Format a milli-value the way Quantity.String() does for CPU values."""
    if milli % 1000 == 0:
        return str(milli // 1000)
    return f"{milli}m"


def format_bytes(n: int) -> str:
    """Format a byte count canonically (BinarySI), matching Quantity.String().

    Quantity canonicalizes to the largest binary suffix that divides evenly,
    falling back to the plain integer.
    """
    if n == 0:
        return "0"
    for suffix in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
        div = _BINARY_SUFFIXES[suffix]
        if n % div == 0:
            return f"{n // div}{suffix}"
    return str(n)
