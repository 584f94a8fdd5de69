"""The port's CEL evaluator (ops/cel.py, ops/relinear.py) against the JAX
package's, through tests/test_cel.py's 20 test functions.

Each test function runs with its module's `cel`, `Device` and
`cel_matches` replaced by dual proxies: every call goes to both packages
with the same arguments, the results must be equal (compared with their
types, so True is not 1) or both calls must raise the same exception type
with the same message, and the JAX package's result (or exception) goes
back to the test, whose own assertions then hold as well.  `DualModule`
and `Dual` are shared with tests/test_torch_dra.py.  Tolerance: exact.
"""

import copy
import dataclasses
import sys
from fractions import Fraction

import numpy as np
import pytest

import test_cel as jt
from cluster_capacity_tpu.ops import cel as jcel
from cluster_capacity_tpu.ops import dynamic_resources as jdra
from cluster_capacity_tpu_torch.ops import cel as tcel
from cluster_capacity_tpu_torch.ops import dynamic_resources as tdra
from cluster_capacity_tpu_torch.ops import relinear as trelinear

CALLS = {"n": 0}


class Dual:
    """One value from each package (a Device, a compiled AST, ...).  Reads
    of other attributes come from the JAX half; writes go to both."""

    def __init__(self, j, t):
        object.__setattr__(self, "j", j)
        object.__setattr__(self, "t", t)

    def __getattr__(self, name):
        return getattr(self.j, name)

    def __setattr__(self, name, value):
        setattr(self.j, name, copy.deepcopy(value))
        setattr(self.t, name, copy.deepcopy(value))


def side(v, s):
    """`v` with every Dual replaced by its package-`s` half ("j"/"t")."""
    if isinstance(v, Dual):
        return v.j if s == "j" else v.t
    if isinstance(v, list):
        return [side(x, s) for x in v]
    if isinstance(v, tuple):
        return tuple(side(x, s) for x in v)
    if isinstance(v, dict):
        return {k: side(x, s) for k, x in v.items()}
    return v


def plain(v):
    """A comparable form of a result that keeps every value's type."""
    if isinstance(v, Dual):
        return plain(v.j)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple((f.name, plain(getattr(v, f.name)))
                      for f in dataclasses.fields(v)))
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tolist())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(plain(x) for x in v))
    if isinstance(v, dict):
        return ("dict", tuple((plain(k), plain(x)) for k, x in v.items()))
    if isinstance(v, (set, frozenset)):
        return ("set", tuple(sorted(map(repr, v))))
    if isinstance(v, (bool, int, float, str, bytes, Fraction)) or v is None:
        return (type(v).__name__, v)
    return (type(v).__name__, repr(v))


def _simple(v) -> bool:
    return isinstance(v, (bool, int, float, str, bytes, Fraction,
                          type(None))) or \
        (isinstance(v, (list, tuple, dict, set)) and not isinstance(v, Dual))


def call_both(fj, ft, *args, **kw):
    """Call both packages' function; assert equal results or equal
    exceptions; return the JAX package's result (wrapped with the port's
    as a Dual when it is an object the test passes on)."""
    CALLS["n"] += 1
    outs = []
    for fn, s in ((fj, "j"), (ft, "t")):
        try:
            outs.append((fn(*side(args, s), **side(kw, s)), None))
        except Exception as e:          # compared, then re-raised below
            outs.append((None, e))
    (rj, ej), (rt, et) = outs
    if ej is not None or et is not None:
        assert ej is not None and et is not None, (ej, et)
        assert type(ej).__name__ == type(et).__name__
        assert str(ej) == str(et)
        raise ej
    assert plain(rj) == plain(rt)
    return rj if _simple(rj) else Dual(rj, rt)


class DualModule:
    """Attribute access returns dual callables over the same name in both
    modules; exception classes and constants come from the JAX module."""

    def __init__(self, jmod, tmod):
        self._j, self._t = jmod, tmod

    def __getattr__(self, name):
        vj, vt = getattr(self._j, name), getattr(self._t, name)
        if isinstance(vj, type) and issubclass(vj, BaseException):
            return vj
        if callable(vj):
            return lambda *a, **k: call_both(vj, vt, *a, **k)
        assert plain(vj) == plain(vt), name
        return vj


CEL_TESTS = sorted(n for n in dir(jt) if n.startswith("test_"))


def test_every_cel_test_is_mirrored():
    assert len(CEL_TESTS) == 20


@pytest.mark.parametrize("name", CEL_TESTS)
def test_cel_matches_jax(name, monkeypatch):
    dra = DualModule(jdra, tdra)
    monkeypatch.setattr(jt, "cel", DualModule(jcel, tcel))
    monkeypatch.setattr(jt, "Device", dra.Device)
    monkeypatch.setattr(jt, "cel_matches", dra.cel_matches)
    before = CALLS["n"]
    getattr(jt, name)()
    assert CALLS["n"] > before          # the test went through both


@pytest.mark.parametrize("seed", range(6))
def test_relinear_matches_jax_on_random_patterns(seed):
    """The port's linear-time regex (behind CEL matches()) against the JAX
    package's on seeded random patterns and subjects: the same match, or
    the same RegexError."""
    from cluster_capacity_tpu.ops import relinear as jrelinear
    rng = np.random.RandomState(seed)
    atoms = ["a", "b", "ab", "[ab]", "[^a]", ".", "\\d", "x|a", "(a|b)",
             "(a"]
    quants = ["", "*", "+", "?", "{1,2}"]
    for _ in range(60):
        pat = "".join(rng.choice(atoms) + rng.choice(quants)
                      for _ in range(int(rng.randint(1, 4))))
        if rng.rand() < 0.3:
            pat = "^" + pat
        if rng.rand() < 0.3:
            pat += "$"
        subj = "".join(rng.choice(list("ab1x"))
                       for _ in range(int(rng.randint(0, 9))))
        try:
            call_both(jrelinear.search, trelinear.search, pat, subj)
        except jrelinear.RegexError:
            pass                        # equal on both sides (call_both)


def test_port_modules_are_the_ports():
    """The dual proxies really compare two implementations."""
    assert tcel is not jcel and tdra.cel_mod is tcel
    assert "cluster_capacity_tpu_torch" in tdra.__name__
    assert sys.modules[tcel.__name__] is tcel
