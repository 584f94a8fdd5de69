"""Linear-time regular-expression matching for CEL `matches()`.

The reference evaluates CEL `matches()` with RE2 via cel-go: no
backreferences, no lookaround, and guaranteed linear-time matching.
Python's `re` is a backtracking engine, so a hostile cluster-sourced
selector like `"aaa...b".matches("(a+)+$")` would hang the solver
(exponential backtracking).  This module implements the RE2-shaped subset
CEL selectors actually use as a Thompson NFA simulated in
O(len(subject) * states):

    literals, '.', escapes (\\d \\w \\s \\D \\W \\S \\n \\t ...),
    character classes [...] / [^...] with ranges, grouping (...) and
    (?:...), alternation |, repetition * + ? {m} {m,} {m,n}, anchors ^ $.

Unsupported syntax (backreferences, lookaround, inline flags) raises
RegexError — the CEL layer maps that to an evaluation error, i.e. the
device does not match, mirroring cel-go's compile error path.  State and
subject caps bound the simulation regardless of input.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

MAX_STATES = 2048
MAX_SUBJECT = 65536


class RegexError(Exception):
    pass


_CLASS_ESCAPES = {
    "d": lambda c: c.isdigit(),
    "D": lambda c: not c.isdigit(),
    "w": lambda c: c.isalnum() or c == "_",
    "W": lambda c: not (c.isalnum() or c == "_"),
    "s": lambda c: c in " \t\n\r\f\v",
    "S": lambda c: c not in " \t\n\r\f\v",
}
_CHAR_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
                 "0": "\0", "a": "\a", "b": "\b"}


class _Nfa:
    """States: eps[i] = epsilon targets; pred[i] = (fn, target) consuming
    transition; anchor[i] = ('^'|'$', target) position-conditional epsilon;
    accept = accepting state id."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.pred: List[Optional[Tuple[Callable, int]]] = []
        self.anchor: List[Optional[Tuple[str, int]]] = []

    def new_state(self) -> int:
        if len(self.eps) >= MAX_STATES:
            raise RegexError("regex too complex")
        self.eps.append([])
        self.pred.append(None)
        self.anchor.append(None)
        return len(self.eps) - 1


class _Compiler:
    """Recursive-descent pattern → NFA fragment (start, out-state)."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.nfa = _Nfa()

    def compile(self) -> Tuple[_Nfa, int, int]:
        start, out = self.alternation()
        if self.i < len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r}")
        return self.nfa, start, out

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def alternation(self) -> Tuple[int, int]:
        frags = [self.concat()]
        while self.peek() == "|":
            self.i += 1
            frags.append(self.concat())
        if len(frags) == 1:
            return frags[0]
        s = self.nfa.new_state()
        out = self.nfa.new_state()
        for fs, fo in frags:
            self.nfa.eps[s].append(fs)
            self.nfa.eps[fo].append(out)
        return s, out

    def concat(self) -> Tuple[int, int]:
        frags = []
        while self.peek() not in ("", "|", ")"):
            frags.append(self.repeat())
        if not frags:
            s = self.nfa.new_state()
            return s, s
        start, out = frags[0]
        for fs, fo in frags[1:]:
            self.nfa.eps[out].append(fs)
            out = fo
        return start, out

    def repeat(self) -> Tuple[int, int]:
        atom_start = self.i
        start, out = self.atom()
        atom_end = self.i
        ch = self.peek()
        if ch and ch in "*+?":
            self.i += 1
            nxt = self.peek()
            if nxt and nxt in "*+?":
                raise RegexError("double quantifier")
            return self._apply_quant(start, out, ch)
        if ch == "{":
            m, n = self._parse_counts()
            return self._expand_counts(start, out, m, n,
                                       self.p[atom_start:atom_end])
        return start, out

    def _apply_quant(self, start: int, out: int, q: str) -> Tuple[int, int]:
        s = self.nfa.new_state()
        o = self.nfa.new_state()
        if q == "*":
            self.nfa.eps[s] += [start, o]
            self.nfa.eps[out] += [start, o]
        elif q == "+":
            self.nfa.eps[s].append(start)
            self.nfa.eps[out] += [start, o]
        else:  # ?
            self.nfa.eps[s] += [start, o]
            self.nfa.eps[out].append(o)
        return s, o

    def _parse_counts(self) -> Tuple[int, int]:
        j = self.p.find("}", self.i)
        if j < 0:
            raise RegexError("unterminated {}")
        body = self.p[self.i + 1:j]
        self.i = j + 1
        parts = body.split(",")
        try:
            if len(parts) == 1:
                m = n = int(parts[0])
            elif len(parts) == 2:
                m = int(parts[0]) if parts[0] else 0
                n = int(parts[1]) if parts[1] else -1
            else:
                raise ValueError
        except ValueError:
            raise RegexError(f"bad counts {{{body}}}")
        if m < 0 or (n != -1 and n < m) or m > 256 or n > 256:
            raise RegexError("counts out of range")
        return m, n

    def _expand_counts(self, start: int, out: int, m: int, n: int,
                       atom_src: str) -> Tuple[int, int]:
        """a{m,n} → m copies then (n-m) optional copies (or a* tail for
        open-ended).  Copies re-compile the atom source."""
        def copy() -> Tuple[int, int]:
            sub = _Compiler(atom_src)
            sub.nfa = self.nfa          # share the state arena
            s, o = sub.atom()
            if sub.i != len(atom_src):
                raise RegexError("bad repeat atom")
            return s, o

        s0 = self.nfa.new_state()
        cur = s0
        first = (start, out)
        for k in range(m):
            fs, fo = first if k == 0 else copy()
            self.nfa.eps[cur].append(fs)
            cur = fo
        if n == -1:                      # {m,} → tail*
            fs, fo = copy() if m else first
            ts, to = self._apply_quant(fs, fo, "*")
            self.nfa.eps[cur].append(ts)
            return s0, to
        end = self.nfa.new_state()
        for k in range(n - m):
            fs, fo = copy() if (m or k) else first
            os_, oo = self._apply_quant(fs, fo, "?")
            self.nfa.eps[cur].append(os_)
            cur = oo
        self.nfa.eps[cur].append(end)
        return s0, end

    def atom(self) -> Tuple[int, int]:
        ch = self.peek()
        if ch == "":
            raise RegexError("dangling quantifier or empty atom")
        if ch == "(":
            self.i += 1
            if self.p[self.i:self.i + 2] == "?:":
                self.i += 2
            elif self.peek() == "?":
                raise RegexError("unsupported group flags")
            start, out = self.alternation()
            if self.peek() != ")":
                raise RegexError("unbalanced parenthesis")
            self.i += 1
            return start, out
        if ch and ch in "*+?{":
            raise RegexError("quantifier without atom")
        if ch == ")":
            raise RegexError("unbalanced parenthesis")
        if ch == "^":
            self.i += 1
            return self._anchor("^")
        if ch == "$":
            self.i += 1
            return self._anchor("$")
        if ch == "[":
            return self._char_class()
        if ch == ".":
            self.i += 1
            return self._pred(lambda c: c != "\n")
        if ch == "\\":
            self.i += 1
            return self._escape()
        self.i += 1
        return self._pred(lambda c, ch=ch: c == ch)

    def _anchor(self, kind: str) -> Tuple[int, int]:
        s = self.nfa.new_state()
        o = self.nfa.new_state()
        self.nfa.anchor[s] = (kind, o)
        return s, o

    def _pred(self, fn) -> Tuple[int, int]:
        s = self.nfa.new_state()
        o = self.nfa.new_state()
        self.nfa.pred[s] = (fn, o)
        return s, o

    def _escape(self) -> Tuple[int, int]:
        ch = self.peek()
        if ch == "":
            raise RegexError("trailing backslash")
        self.i += 1
        if ch in _CLASS_ESCAPES:
            return self._pred(_CLASS_ESCAPES[ch])
        if ch in _CHAR_ESCAPES:
            lit = _CHAR_ESCAPES[ch]
            return self._pred(lambda c, lit=lit: c == lit)
        if ch.isdigit():
            raise RegexError("backreferences are not supported")
        return self._pred(lambda c, ch=ch: c == ch)

    def _char_class(self) -> Tuple[int, int]:
        self.i += 1                     # consume '['
        negate = False
        if self.peek() == "^":
            negate = True
            self.i += 1
        items: List[Callable] = []
        first = True
        while True:
            ch = self.peek()
            if ch == "":
                raise RegexError("unterminated character class")
            if ch == "]" and not first:
                self.i += 1
                break
            first = False
            if ch == "\\":
                self.i += 1
                e = self.peek()
                if e == "":
                    raise RegexError("trailing backslash")
                self.i += 1
                if e in _CLASS_ESCAPES:
                    items.append(_CLASS_ESCAPES[e])
                    continue
                ch = _CHAR_ESCAPES.get(e, e)
            else:
                self.i += 1
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.i += 1
                hi = self.peek()
                if hi == "\\":
                    self.i += 1
                    hi = _CHAR_ESCAPES.get(self.peek(), self.peek())
                if hi == "":
                    raise RegexError("bad range")
                self.i += 1
                lo_c, hi_c = ch, hi
                if lo_c > hi_c:
                    raise RegexError("reversed range")
                items.append(
                    lambda c, lo=lo_c, hi=hi_c: lo <= c <= hi)
            else:
                items.append(lambda c, ch=ch: c == ch)

        def member(c, items=tuple(items), neg=negate):
            hit = any(f(c) for f in items)
            return hit != neg

        return self._pred(member)


def _closure(nfa: _Nfa, states: set, at_start: bool, at_end: bool) -> set:
    stack = list(states)
    seen = set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
        a = nfa.anchor[s]
        if a is not None:
            kind, t = a
            ok = at_start if kind == "^" else at_end
            if ok and t not in seen:
                seen.add(t)
                stack.append(t)
    return seen


@functools.lru_cache(maxsize=512)
def _compiled(pattern: str):
    """Compiled (nfa, start, accept) per pattern.  matches() sits inside
    the DRA slot-column hot loop over nodes x devices — without this cache
    every evaluation rebuilt up to MAX_STATES NFA states (mirrors the CEL
    AST cache in dynamic_resources._compiled)."""
    return _Compiler(pattern).compile()


def search(pattern: str, subject: str) -> bool:
    """RE2-style unanchored partial match (cel-spec matches())."""
    if len(subject) > MAX_SUBJECT:
        raise RegexError("subject too long")
    nfa, start, accept = _compiled(pattern)
    n = len(subject)
    current: set = set()
    for pos in range(n + 1):
        at_start = pos == 0
        at_end = pos == n
        current.add(start)              # unanchored: start anywhere
        current = _closure(nfa, current, at_start, at_end)
        if accept in current:
            return True
        if pos == n:
            break
        c = subject[pos]
        nxt = set()
        for s in current:
            p = nfa.pred[s]
            if p is not None and p[0](c):
                nxt.add(p[1])
        current = nxt
    return False
