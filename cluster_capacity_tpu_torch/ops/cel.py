"""CEL (Common Expression Language) subset evaluator for DRA selectors.

The reference's structured DRA allocator evaluates
`spec.devices.requests[].selectors[].cel.expression` with cel-go plus the
Kubernetes DRA environment (vendor/.../dynamicresources/, cel-go upstream;
expressions look like `device.attributes["gpu.example.com"].model ==
"a100"`).  Earlier rounds approximated this with a token-rewrite into a
sandboxed Python `eval`; this module replaces that with a real lexer +
recursive-descent parser + tree-walking evaluator, so semantics come from
the CEL spec rather than from Python's:

- `/` and `%` on ints TRUNCATE TOWARD ZERO (Python floors);
- `&&` / `||` are commutative and error-absorbing
  (`false && <error>` is false, `true || <error>` is true);
- arithmetic is typed: `list * int`, `string * int`, or boolean operands
  to `&&` raise evaluation errors (which callers map to "no match" — the
  reference treats runtime CEL errors as a non-matching device);
- `in` works over list literals and map keys; `?:` is lazy;
- functions from the k8s CEL environment that selectors actually use:
  size(), string startsWith/endsWith/contains/matches, int(), double(),
  string(), quantity() with compareTo/isGreaterThan/isLessThan/asInteger/
  asApproximateFloat (quantities reduce to numbers here — capacities are
  folded to numbers at slice parse time, dynamic_resources._parse_devices).

There is deliberately no Python `eval` anywhere: the expression source is
cluster-controlled (live sync pulls anyone's ResourceClaimTemplates), and
a tree walker over a closed AST cannot reach Python state at all.  Memory
stays linear in expression length (no repetition operators exist in CEL;
`+` concatenation over an L-char expression builds O(L) elements).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

MAX_EXPR_LEN = 4096
_MAX_REGEX_LEN = 512
_MAX_PARSE_DEPTH = 80


class CelError(Exception):
    """Evaluation or parse error — callers treat it as 'no match'."""


_INT64_MIN, _INT64_MAX = -2 ** 63, 2 ** 63 - 1


# --------------------------------------------------------------------------
# lexer
# --------------------------------------------------------------------------

_TWO_CHAR = ("&&", "||", "==", "!=", "<=", ">=")
_ONE_CHAR = "()[]{}.,:?+-*/%<>!"
_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z_0-9]*")
_NUM_RE = re.compile(
    r"0x[0-9a-fA-F]+[uU]?|\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?"
    r"|\d+(?:[eE][+-]?\d+)?[uU]?")

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "'": "'",
            "\\": "\\", "0": "\0", "a": "\a", "b": "\b", "f": "\f",
            "v": "\v", "`": "`", "?": "?"}


@dataclass
class _Tok:
    kind: str          # num / str / ident / op
    value: Any
    pos: int


def _lex(src: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n = 0, len(src)
    while i < n:
        ch = src[i]
        if ch in " \t\r\n":
            i += 1
            continue
        two = src[i:i + 2]
        if two in _TWO_CHAR:
            toks.append(_Tok("op", two, i))
            i += 2
            continue
        if ch in "\"'":
            raw = False
            j = i + 1
            buf = []
            while j < n and src[j] != ch:
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    if esc == "x" and j + 3 < n:
                        try:
                            buf.append(chr(int(src[j + 2:j + 4], 16)))
                            j += 4
                            continue
                        except ValueError:
                            raise CelError("bad \\x escape")
                    buf.append(_ESCAPES.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise CelError("unterminated string")
            toks.append(_Tok("str", "".join(buf), i))
            i = j + 1
            continue
        if (ch == "r" or ch == "R") and i + 1 < n and src[i + 1] in "\"'":
            q = src[i + 1]
            j = src.find(q, i + 2)
            if j < 0:
                raise CelError("unterminated raw string")
            toks.append(_Tok("str", src[i + 2:j], i))
            i = j + 1
            continue
        m = _NUM_RE.match(src, i)
        if m and (ch.isdigit() or ch == "."):
            raw = m.group(0)
            text = raw.rstrip("uU")
            is_float = not text.startswith("0x") and (
                "." in text or "e" in text or "E" in text)
            if raw != text and is_float:
                # the uint suffix only attaches to integer literals
                raise CelError(f"bad numeric literal {raw!r}")
            try:
                if text.startswith("0x"):
                    v: Any = int(text, 16)
                elif is_float:
                    v = float(text)
                else:
                    v = int(text)
            except (ValueError, OverflowError):
                raise CelError(f"bad numeric literal {text!r}")
            toks.append(_Tok("num", v, i))
            i = m.end()
            continue
        m = _IDENT_RE.match(src, i)
        if m:
            toks.append(_Tok("ident", m.group(0), i))
            i = m.end()
            continue
        if ch in _ONE_CHAR:
            toks.append(_Tok("op", ch, i))
            i += 1
            continue
        raise CelError(f"unexpected character {ch!r}")
    toks.append(_Tok("op", "<eof>", n))
    return toks


# --------------------------------------------------------------------------
# parser — CEL precedence: ?: < || < && < relations < +- < */% < unary <
# member/index/call < primary
# --------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0
        self.depth = 0

    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, op: str) -> None:
        t = self.next()
        if t.kind != "op" or t.value != op:
            raise CelError(f"expected {op!r} at {t.pos}")

    def _enter(self):
        self.depth += 1
        if self.depth > _MAX_PARSE_DEPTH:
            raise CelError("expression too deeply nested")

    def parse(self):
        node = self.ternary()
        if self.peek().value != "<eof>":
            raise CelError(f"trailing tokens at {self.peek().pos}")
        return node

    def ternary(self):
        self._enter()
        try:
            cond = self.logical_or()
            if self.peek().kind == "op" and self.peek().value == "?":
                self.next()
                a = self.ternary()
                self.expect(":")
                b = self.ternary()
                return ("cond", cond, a, b)
            return cond
        finally:
            self.depth -= 1

    def logical_or(self):
        node = self.logical_and()
        while self.peek().kind == "op" and self.peek().value == "||":
            self.next()
            node = ("or", node, self.logical_and())
        return node

    def logical_and(self):
        node = self.relation()
        while self.peek().kind == "op" and self.peek().value == "&&":
            self.next()
            node = ("and", node, self.relation())
        return node

    def relation(self):
        node = self.addition()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("==", "!=", "<", "<=", ">",
                                              ">="):
                self.next()
                node = ("cmp", t.value, node, self.addition())
            elif t.kind == "ident" and t.value == "in":
                self.next()
                node = ("in", node, self.addition())
            else:
                return node

    def addition(self):
        node = self.multiplication()
        while self.peek().kind == "op" and self.peek().value in "+-":
            op = self.next().value
            node = ("arith", op, node, self.multiplication())
        return node

    def multiplication(self):
        node = self.unary()
        while self.peek().kind == "op" and self.peek().value in "*/%":
            op = self.next().value
            node = ("arith", op, node, self.unary())
        return node

    def unary(self):
        t = self.peek()
        if t.kind == "op" and t.value == "!":
            self.next()
            return ("not", self.unary())
        if t.kind == "op" and t.value == "-":
            self.next()
            return ("neg", self.unary())
        return self.member()

    def member(self):
        node = self.primary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value == ".":
                self.next()
                name = self.next()
                if name.kind != "ident":
                    raise CelError("expected identifier after '.'")
                if self.peek().kind == "op" and self.peek().value == "(":
                    self.next()
                    args = self._args()
                    node = ("method", name.value, node, args)
                else:
                    node = ("field", node, name.value)
            elif t.kind == "op" and t.value == "[":
                self.next()
                idx = self.ternary()
                self.expect("]")
                node = ("index", node, idx)
            else:
                return node

    def _args(self) -> list:
        args = []
        if not (self.peek().kind == "op" and self.peek().value == ")"):
            args.append(self.ternary())
            while self.peek().kind == "op" and self.peek().value == ",":
                self.next()
                args.append(self.ternary())
        self.expect(")")
        return args

    def primary(self):
        self._enter()
        try:
            t = self.next()
            if t.kind == "num":
                return ("lit", t.value)
            if t.kind == "str":
                return ("lit", t.value)
            if t.kind == "ident":
                if t.value == "true":
                    return ("lit", True)
                if t.value == "false":
                    return ("lit", False)
                if t.value == "null":
                    return ("lit", None)
                if self.peek().kind == "op" and self.peek().value == "(":
                    self.next()
                    args = self._args()
                    return ("call", t.value, args)
                return ("var", t.value)
            if t.kind == "op" and t.value == "(":
                node = self.ternary()
                self.expect(")")
                return node
            if t.kind == "op" and t.value == "[":
                items = []
                if not (self.peek().kind == "op"
                        and self.peek().value == "]"):
                    items.append(self.ternary())
                    while self.peek().kind == "op" \
                            and self.peek().value == ",":
                        self.next()
                        items.append(self.ternary())
                self.expect("]")
                return ("list", items)
            if t.kind == "op" and t.value == "{":
                entries = []
                if not (self.peek().kind == "op"
                        and self.peek().value == "}"):
                    while True:
                        k = self.ternary()
                        self.expect(":")
                        entries.append((k, self.ternary()))
                        if self.peek().kind == "op" \
                                and self.peek().value == ",":
                            self.next()
                            continue
                        break
                self.expect("}")
                return ("map", entries)
            raise CelError(f"unexpected token {t.value!r} at {t.pos}")
        finally:
            self.depth -= 1


# --------------------------------------------------------------------------
# evaluator
# --------------------------------------------------------------------------

class Quantity(float):
    """resource.Quantity stand-in: a number with the k8s CEL quantity
    comparison methods.  Capacities fold to plain numbers at slice parse
    time; quantity("40Gi") in a selector produces one of these."""


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _same_kind(a, b) -> bool:
    if _is_num(a) and _is_num(b):
        return True
    return type(a) is type(b)


def _truthy_bool(v):
    if not isinstance(v, bool):
        raise CelError("operand is not a boolean")
    return v


class _Env:
    def __init__(self, variables: Dict[str, Any]):
        self.vars = variables

    # -- dispatch ----------------------------------------------------------
    def eval(self, node) -> Any:
        kind = node[0]
        if kind == "call" and node[1] == "has":
            # has() is a macro: its argument is a field selection tested
            # for PRESENCE, never evaluated into an error
            if len(node[2]) != 1:
                raise CelError("has() takes one argument")
            arg = node[2][0]
            # cel-go rejects has(m["x"]) at compile time — only field
            # selections are testable (use `"x" in m` for maps)
            if arg[0] != "field":
                raise CelError("has() needs a field selection")
            try:
                self.eval(arg)
                return True
            except CelError:
                return False
        return getattr(self, "_eval_" + kind)(node)

    def _eval_lit(self, node):
        return node[1]

    def _eval_var(self, node):
        try:
            return self.vars[node[1]]
        except KeyError:
            raise CelError(f"undeclared reference {node[1]!r}")

    def _eval_list(self, node):
        return [self.eval(x) for x in node[1]]

    def _eval_map(self, node):
        out = {}
        for k, v in node[1]:
            out[self.eval(k)] = self.eval(v)
        return out

    def _eval_not(self, node):
        return not _truthy_bool(self.eval(node[1]))

    def _eval_neg(self, node):
        v = self.eval(node[1])
        if not _is_num(v):
            raise CelError("unary minus on non-number")
        return self._int64(-v)

    def _eval_and(self, node):
        # commutative error absorption (cel-spec logical operators)
        lv = rv = None
        le = re_ = None
        try:
            lv = _truthy_bool(self.eval(node[1]))
        except CelError as e:
            le = e
        try:
            rv = _truthy_bool(self.eval(node[2]))
        except CelError as e:
            re_ = e
        if lv is False or rv is False:
            return False
        if le is not None:
            raise le
        if re_ is not None:
            raise re_
        return True

    def _eval_or(self, node):
        lv = rv = None
        le = re_ = None
        try:
            lv = _truthy_bool(self.eval(node[1]))
        except CelError as e:
            le = e
        try:
            rv = _truthy_bool(self.eval(node[2]))
        except CelError as e:
            re_ = e
        if lv is True or rv is True:
            return True
        if le is not None:
            raise le
        if re_ is not None:
            raise re_
        return False

    def _eval_cond(self, node):
        return self.eval(node[2]) if _truthy_bool(self.eval(node[1])) \
            else self.eval(node[3])

    def _eval_cmp(self, node):
        op, a, b = node[1], self.eval(node[2]), self.eval(node[3])
        if op == "==":
            return self._eq(a, b)
        if op == "!=":
            return not self._eq(a, b)
        # ordering: numbers cross-compare (the k8s CEL env enables
        # cross-type numeric comparisons); strings compare to strings;
        # bools order bool-to-bool (false < true, CEL standard library)
        if isinstance(a, bool) and isinstance(b, bool):
            pass
        elif _is_num(a) and _is_num(b):
            pass
        elif isinstance(a, str) and isinstance(b, str):
            pass
        else:
            raise CelError("no ordering between operand types")
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        return a >= b

    @staticmethod
    def _eq(a, b) -> bool:
        if a is None or b is None:
            return a is None and b is None
        if isinstance(a, bool) or isinstance(b, bool):
            return isinstance(a, bool) and isinstance(b, bool) and a == b
        if _is_num(a) and _is_num(b):
            return float(a) == float(b)
        if not _same_kind(a, b):
            return False
        # typed element equality: Python's [True] == [1] is true, cel-go's
        # is false (bool vs int) — recurse so members keep CEL typing
        if isinstance(a, list):
            return len(a) == len(b) and all(
                _Env._eq(x, y) for x, y in zip(a, b))
        if isinstance(a, dict):
            if len(a) != len(b):
                return False
            for k, v in a.items():
                if k not in b:
                    return False
                # typed key check: Python hashes True and 1 to the same
                # key, but cel-go's {true: x} != {1: x}
                bk = next(kk for kk in b if kk == k)
                if isinstance(k, bool) != isinstance(bk, bool):
                    return False
                if not _Env._eq(v, b[k]):
                    return False
            return True
        return a == b

    def _eval_in(self, node):
        item = self.eval(node[1])
        cont = self.eval(node[2])
        if isinstance(cont, list):
            return any(self._eq(item, x) for x in cont)
        if isinstance(cont, dict):
            return item in cont
        raise CelError("'in' needs a list or map")

    @staticmethod
    def _int64(v):
        """CEL ints are int64: overflowing arithmetic is an evaluation
        error (cel-go raises; the device would be non-matching), never a
        silent Python bignum."""
        if isinstance(v, int) and not _INT64_MIN <= v <= _INT64_MAX:
            raise CelError("integer overflow")
        return v

    def _eval_arith(self, node):
        op = node[1]
        a = self.eval(node[2])
        b = self.eval(node[3])
        if op == "+":
            if isinstance(a, str) and isinstance(b, str):
                return a + b
            if isinstance(a, list) and isinstance(b, list):
                return a + b
            if _is_num(a) and _is_num(b):
                return self._int64(a + b)
            raise CelError("no + overload for operand types")
        if not (_is_num(a) and _is_num(b)):
            raise CelError(f"no {op} overload for operand types")
        if op == "-":
            return self._int64(a - b)
        if op == "*":
            return self._int64(a * b)
        both_int = isinstance(a, int) and isinstance(b, int)
        if op == "/":
            if b == 0:
                raise CelError("division by zero")
            if both_int:
                q = abs(a) // abs(b)           # CEL truncates toward zero
                return self._int64(q if (a >= 0) == (b >= 0) else -q)
            return a / b
        # op == "%"
        if b == 0:
            raise CelError("modulo by zero")
        if not both_int:
            raise CelError("modulo needs integers")
        r = abs(a) % abs(b)                    # sign follows the dividend
        return r if a >= 0 else -r

    def _eval_field(self, node):
        obj = self.eval(node[1])
        name = node[2]
        if isinstance(obj, dict):
            if name in obj:
                return obj[name]
            raise CelError(f"no such key {name!r}")
        raise CelError(f"no such field {name!r}")

    def _eval_index(self, node):
        obj = self.eval(node[1])
        idx = self.eval(node[2])
        if isinstance(obj, dict):
            if idx in obj:
                return obj[idx]
            raise CelError(f"no such key {idx!r}")
        if isinstance(obj, list):
            if not isinstance(idx, int) or isinstance(idx, bool):
                raise CelError("index must be an int")
            if 0 <= idx < len(obj):
                return obj[idx]
            raise CelError("index out of range")
        # CEL has no string index operator (cel-spec: lists and maps only)
        raise CelError("value is not indexable")

    # -- functions ---------------------------------------------------------
    def _eval_call(self, node):
        name, args = node[1], [self.eval(a) for a in node[2]]

        def one(want=None):
            if len(args) != 1:
                raise CelError(f"{name}() takes one argument")
            if want is not None and not isinstance(args[0], want):
                raise CelError(f"bad argument to {name}()")
            return args[0]

        if name == "size":
            v = one()
            if isinstance(v, (str, list, dict)):
                return len(v)
            raise CelError("size() needs string/list/map")
        if name == "int":
            v = one()
            if isinstance(v, bool) or not isinstance(v, (int, float, str)):
                raise CelError("int() conversion")
            try:
                return self._int64(int(v))
            except (ValueError, OverflowError):
                raise CelError("int() conversion")
        if name == "double":
            v = one()
            if isinstance(v, bool) or not isinstance(v, (int, float, str)):
                raise CelError("double() conversion")
            try:
                return float(v)
            except ValueError:
                raise CelError("double() conversion")
        if name == "string":
            v = one()
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, (int, str)):
                return str(v)
            if isinstance(v, float):
                return repr(v)
            raise CelError("string() conversion")
        if name == "quantity":
            v = one(str)
            from ..utils.quantity import parse_quantity
            try:
                return Quantity(parse_quantity(v))
            except Exception:
                raise CelError(f"bad quantity {v!r}")
        if name == "isQuantity":
            v = one()
            if not isinstance(v, str):
                return False
            from ..utils.quantity import parse_quantity
            try:
                parse_quantity(v)
                return True
            except Exception:
                return False
        raise CelError(f"unknown function {name}()")

    def _eval_method(self, node):
        name, recv_node, arg_nodes = node[1], node[2], node[3]
        recv = self.eval(recv_node)
        args = [self.eval(a) for a in arg_nodes]

        def one_str() -> str:
            if len(args) != 1 or not isinstance(args[0], str):
                raise CelError(f"{name}() takes one string")
            return args[0]

        def one_num():
            if len(args) != 1 or not _is_num(args[0]):
                raise CelError(f"{name}() takes one quantity/number")
            return args[0]

        if isinstance(recv, str):
            if name == "startsWith":
                return recv.startswith(one_str())
            if name == "endsWith":
                return recv.endswith(one_str())
            if name == "contains":
                return one_str() in recv
            if name == "matches":
                # RE2-shaped linear-time engine (ops/relinear.py): the
                # pattern is cluster-controlled, and Python's backtracking
                # re would let '(a+)+$' take exponential time
                from . import relinear
                pat = one_str()
                if len(pat) > _MAX_REGEX_LEN:
                    raise CelError("regex too long")
                try:
                    return relinear.search(pat, recv)
                except relinear.RegexError as e:
                    raise CelError(f"regex: {e}")
            if name == "size":
                if args:
                    raise CelError("size() takes no arguments")
                return len(recv)
        if _is_num(recv):
            # quantity comparison helpers (k8s CEL quantity library);
            # capacities are numbers here, so they work on both
            if name == "compareTo":
                b = one_num()
                return (recv > b) - (recv < b)
            if name == "isGreaterThan":
                return recv > one_num()
            if name == "isLessThan":
                return recv < one_num()
            if name == "asInteger":
                if args:
                    raise CelError("asInteger() takes no arguments")
                return int(recv)
            if name == "asApproximateFloat":
                if args:
                    raise CelError("asApproximateFloat() takes no args")
                return float(recv)
        if isinstance(recv, (list, dict)) and name == "size" and not args:
            return len(recv)
        raise CelError(f"unknown method .{name}()")


def _tree_depth(root) -> int:
    """Iterative AST depth: the evaluator recurses per level, so deep trees
    (including LEFT-nested chains the iterative parse loops build, e.g. a
    4 KB '1+1+1+...' or '.x.x.x...') must be rejected here rather than
    blow the interpreter's recursion limit mid-solve."""
    depth = 0
    stack = [(root, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        if not isinstance(node, tuple):
            continue
        # AST nodes carry a kind string at [0]; map-literal entries are
        # bare (key, value) pairs — walk every element of those
        children = node[1:] if node and isinstance(node[0], str) else node
        for child in children:
            if isinstance(child, tuple):
                stack.append((child, d + 1))
            elif isinstance(child, list):
                for item in child:
                    if isinstance(item, tuple):
                        stack.append((item, d + 1))
    return depth


def compile_expr(src: str):
    """Parse once; returns the AST (raises CelError on syntax errors)."""
    if len(src) > MAX_EXPR_LEN:
        raise CelError("expression too long")
    ast = _Parser(_lex(src)).parse()
    if _tree_depth(ast) > _MAX_PARSE_DEPTH:
        raise CelError("expression too deeply nested")
    return ast


def evaluate(ast, variables: Dict[str, Any]) -> Any:
    return _Env(variables).eval(ast)
