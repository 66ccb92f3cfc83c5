"""Vectorized SQL predicate/expression engine with 3-valued NULL logic.

The reference leans on Spark SQL strings for row-level predicates: `where`
filters (analyzers/Analyzer.scala:385-402 conditionalSelection),
`Compliance(instance, predicate)` (analyzers/Compliance.scala:37),
`isContainedIn`'s generated IN-lists (checks/Check.scala:836-841) and
`isNonNegative`'s `COALESCE(col, 0.0) >= 0` (checks/Check.scala:676).
This module parses the same predicate surface and evaluates it vectorized
over a Table into (values, null-mask) pairs, reproducing SQL/Kleene NULL
semantics exactly (the NullHandlingTests contract — SURVEY.md §7 hard parts).

Evaluation is host-side numpy (strings must stay on host); the resulting
boolean masks are what ships to device for the fused reductions.

The port's own copy of deequ_tpu/data/expr.py, over the port's Table and
Column.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.data.table import Column, ColumnType, Table


class ExpressionParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<bq>`[^`]+`)
  | (?P<op><=|>=|!=|<>|==|=|<|>|\(|\)|,|\+|-|\*|/|%)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "AND", "OR", "NOT", "IS", "NULL", "IN", "BETWEEN", "LIKE", "RLIKE",
    "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE", "END",
}


@dataclass
class Token:
    kind: str  # num | str | op | ident | kw
    text: str
    # source span [pos, end) into the original expression string; -1 on
    # synthesized tokens. Excluded from equality so token comparisons
    # stay purely textual.
    pos: int = field(default=-1, compare=False)
    end: int = field(default=-1, compare=False)


def _tokenize(s: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise ExpressionParseError(f"cannot tokenize at {s[pos:pos+20]!r}")
        start, pos = m.start(), m.end()
        if m.lastgroup == "ws":
            continue
        kind = m.lastgroup
        text = m.group()
        if kind == "ident" and text.upper() in _KEYWORDS:
            tokens.append(Token("kw", text.upper(), start, pos))
        elif kind == "bq":
            tokens.append(Token("ident", text[1:-1], start, pos))
        else:
            tokens.append(Token(kind, text, start, pos))
    return tokens


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Node:
    # source span (start, end) into the expression string this node was
    # parsed from; deliberately unannotated so it stays a plain class
    # attribute (NOT a dataclass field) and subclass constructors and
    # equality are unchanged. The lint layer reads it to anchor
    # diagnostics.
    span = None


@dataclass
class Lit(Node):
    value: object  # float | str | bool | None


@dataclass
class Col(Node):
    name: str


@dataclass
class Un(Node):
    op: str  # 'neg' | 'not'
    x: Node


@dataclass
class Bin(Node):
    op: str
    l: Node
    r: Node


@dataclass
class IsNull(Node):
    x: Node
    negated: bool


@dataclass
class InList(Node):
    x: Node
    items: List[Node]
    negated: bool


@dataclass
class Between(Node):
    x: Node
    lo: Node
    hi: Node
    negated: bool


@dataclass
class Like(Node):
    x: Node
    pattern: Node
    regex: bool
    negated: bool


@dataclass
class Func(Node):
    name: str
    args: List[Node]


@dataclass
class Case(Node):
    branches: List[Tuple[Node, Node]]
    otherwise: Optional[Node]


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> Optional[Token]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise ExpressionParseError("unexpected end of expression")
        self.i += 1
        return t

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise ExpressionParseError(f"expected {text or kind}, got {t.text!r}")
        return t

    def accept_kw(self, kw: str) -> bool:
        t = self.peek()
        if t is not None and t.kind == "kw" and t.text == kw:
            self.i += 1
            return True
        return False

    def _span(self, node: Node, start_i: int) -> Node:
        # Anchor the node to the [start_i, self.i) token range. Inner nodes
        # keep the tighter span they were given when first constructed.
        if node.span is None and 0 <= start_i < self.i <= len(self.tokens):
            a = self.tokens[start_i].pos
            b = self.tokens[self.i - 1].end
            if a >= 0 and b >= 0:
                node.span = (a, b)
        return node

    # grammar: or_expr
    def parse(self) -> Node:
        node = self.or_expr()
        if self.peek() is not None:
            raise ExpressionParseError(f"trailing input at {self.peek().text!r}")
        return node

    def or_expr(self) -> Node:
        start = self.i
        node = self.and_expr()
        while self.accept_kw("OR"):
            node = self._span(Bin("or", node, self.and_expr()), start)
        return node

    def and_expr(self) -> Node:
        start = self.i
        node = self.not_expr()
        while self.accept_kw("AND"):
            node = self._span(Bin("and", node, self.not_expr()), start)
        return node

    def not_expr(self) -> Node:
        start = self.i
        if self.accept_kw("NOT"):
            return self._span(Un("not", self.not_expr()), start)
        return self.predicate()

    def predicate(self) -> Node:
        start = self.i
        node = self.add_expr()
        t = self.peek()
        if t is None:
            return node
        if t.kind == "op" and t.text in ("=", "==", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = {"=": "eq", "==": "eq", "!=": "ne", "<>": "ne", "<": "lt",
                  "<=": "le", ">": "gt", ">=": "ge"}[t.text]
            return self._span(Bin(op, node, self.add_expr()), start)
        if t.kind == "kw":
            negated = False
            if t.text == "IS":
                self.next()
                negated = self.accept_kw("NOT")
                self.expect("kw", "NULL")
                return self._span(IsNull(node, negated), start)
            if t.text == "NOT":
                self.next()
                negated = True
                t = self.peek()
                if t is None or t.kind != "kw":
                    raise ExpressionParseError("expected IN/BETWEEN/LIKE after NOT")
            if self.accept_kw("IN"):
                self.expect("op", "(")
                items = [self.add_expr()]
                while self.peek() and self.peek().kind == "op" and self.peek().text == ",":
                    self.next()
                    items.append(self.add_expr())
                self.expect("op", ")")
                return self._span(InList(node, items, negated), start)
            if self.accept_kw("BETWEEN"):
                lo = self.add_expr()
                self.expect("kw", "AND")
                hi = self.add_expr()
                return self._span(Between(node, lo, hi, negated), start)
            if self.accept_kw("LIKE"):
                return self._span(
                    Like(node, self.add_expr(), regex=False, negated=negated), start
                )
            if self.accept_kw("RLIKE"):
                return self._span(
                    Like(node, self.add_expr(), regex=True, negated=negated), start
                )
            if negated:
                raise ExpressionParseError("dangling NOT")
        return node

    def add_expr(self) -> Node:
        start = self.i
        node = self.mul_expr()
        while True:
            t = self.peek()
            if t is not None and t.kind == "op" and t.text in ("+", "-"):
                self.next()
                node = self._span(
                    Bin("add" if t.text == "+" else "sub", node, self.mul_expr()), start
                )
            else:
                return node

    def mul_expr(self) -> Node:
        start = self.i
        node = self.unary()
        while True:
            t = self.peek()
            if t is not None and t.kind == "op" and t.text in ("*", "/", "%"):
                self.next()
                op = {"*": "mul", "/": "div", "%": "mod"}[t.text]
                node = self._span(Bin(op, node, self.unary()), start)
            else:
                return node

    def unary(self) -> Node:
        start = self.i
        t = self.peek()
        if t is not None and t.kind == "op" and t.text == "-":
            self.next()
            return self._span(Un("neg", self.unary()), start)
        if t is not None and t.kind == "op" and t.text == "+":
            self.next()
            return self.unary()
        return self.atom()

    def atom(self) -> Node:
        start = self.i
        t = self.next()
        if t.kind == "num":
            return self._span(Lit(float(t.text)), start)
        if t.kind == "str":
            return self._span(Lit(t.text[1:-1].replace("''", "'")), start)
        if t.kind == "kw":
            if t.text == "TRUE":
                return self._span(Lit(True), start)
            if t.text == "FALSE":
                return self._span(Lit(False), start)
            if t.text == "NULL":
                return self._span(Lit(None), start)
            if t.text == "CASE":
                branches = []
                otherwise = None
                while self.accept_kw("WHEN"):
                    cond = self.or_expr()
                    self.expect("kw", "THEN")
                    branches.append((cond, self.or_expr()))
                if self.accept_kw("ELSE"):
                    otherwise = self.or_expr()
                self.expect("kw", "END")
                return self._span(Case(branches, otherwise), start)
            raise ExpressionParseError(f"unexpected keyword {t.text}")
        if t.kind == "op" and t.text == "(":
            node = self.or_expr()
            self.expect("op", ")")
            return node
        if t.kind == "ident":
            nxt = self.peek()
            if nxt is not None and nxt.kind == "op" and nxt.text == "(":
                self.next()
                args: List[Node] = []
                if not (self.peek() and self.peek().kind == "op" and self.peek().text == ")"):
                    args.append(self.or_expr())
                    while self.peek() and self.peek().kind == "op" and self.peek().text == ",":
                        self.next()
                        args.append(self.or_expr())
                self.expect("op", ")")
                return self._span(Func(t.text.upper(), args), start)
            return self._span(Col(t.text), start)
        raise ExpressionParseError(f"unexpected token {t.text!r}")


def parse(expression: str) -> Node:
    return _Parser(_tokenize(expression)).parse()


# ---------------------------------------------------------------------------
# Evaluator: (values ndarray, null bool ndarray, kind)
# ---------------------------------------------------------------------------

# kind: 'num' | 'str' | 'bool'
Series = Tuple[np.ndarray, np.ndarray, str]


def _const(n: int, value, kind: str) -> Series:
    if value is None:
        return np.zeros(n), np.ones(n, dtype=bool), kind
    if kind == "str":
        arr = np.empty(n, dtype=object)
        arr[:] = value
        return arr, np.zeros(n, dtype=bool), "str"
    if kind == "bool":
        return np.full(n, bool(value)), np.zeros(n, dtype=bool), "bool"
    return np.full(n, float(value)), np.zeros(n, dtype=bool), "num"


def _col_series(col: Column) -> Series:
    null = ~col.valid
    if col.ctype == ColumnType.STRING:
        return col.values, null, "str"
    if col.ctype == ColumnType.BOOLEAN:
        return col.values.astype(bool), null, "bool"
    return col.numeric_values()[0], null, "num"


def _to_num(s: Series) -> Series:
    vals, null, kind = s
    if kind == "num":
        return s
    if kind == "bool":
        return vals.astype(np.float64), null, "num"
    # same parse as Column.numeric_values (ops/strings.parse_floats), so
    # a Compliance predicate and a Mean/Sum analyzer agree on which rows
    # of a string column are numeric — vectorized over unique values
    from deequ_tpu_torch.ops.strings import parse_floats

    present = ~null
    if not present.any():
        return np.zeros(len(vals)), null.copy(), "num"
    uniques, inv = np.unique(
        np.asarray(vals[present], dtype=object).astype(str), return_inverse=True
    )
    u_vals, u_ok = parse_floats(uniques)
    out = np.zeros(len(vals))
    extra_null = np.zeros(len(vals), dtype=bool)
    out[present] = u_vals[inv]
    extra_null[present] = ~u_ok[inv]
    return out, null | extra_null, "num"


def _to_str(s: Series) -> Series:
    vals, null, kind = s
    if kind == "str":
        return s
    out = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        if kind == "num":
            f = float(v)
            out[i] = str(int(f)) if f == int(f) else str(f)
        elif kind == "bool":
            out[i] = "true" if v else "false"
    return out, null, "str"


def _coerce_pair(l: Series, r: Series) -> Tuple[Series, Series]:
    lk, rk = l[2], r[2]
    if lk == rk:
        return l, r
    # numeric wins (Spark-style implicit cast of strings/bools to double)
    if "num" in (lk, rk):
        return _to_num(l), _to_num(r)
    # bool vs str -> compare as strings 'true'/'false'
    return _to_str(l), _to_str(r)


def _cmp(op: str, l: Series, r: Series) -> Series:
    l, r = _coerce_pair(l, r)
    lv, ln, kind = l
    rv, rn, _ = r
    null = ln | rn
    if kind == "str":
        lv = lv.astype(str)
        rv = rv.astype(str)
    fn = {
        "eq": lambda a, b: a == b,
        "ne": lambda a, b: a != b,
        "lt": lambda a, b: a < b,
        "le": lambda a, b: a <= b,
        "gt": lambda a, b: a > b,
        "ge": lambda a, b: a >= b,
    }[op]
    with np.errstate(invalid="ignore"):
        out = fn(lv, rv)
    return np.asarray(out, dtype=bool) & ~null, null, "bool"


def _arith(op: str, l: Series, r: Series) -> Series:
    lv, ln, _ = _to_num(l)
    rv, rn, _ = _to_num(r)
    null = ln | rn
    with np.errstate(divide="ignore", invalid="ignore"):
        if op == "add":
            out = lv + rv
        elif op == "sub":
            out = lv - rv
        elif op == "mul":
            out = lv * rv
        elif op == "div":
            out = np.where(rv != 0, lv / np.where(rv != 0, rv, 1.0), np.nan)
            null = null | (rv == 0)  # SQL: x/0 -> NULL
        elif op == "mod":
            out = np.where(rv != 0, np.fmod(lv, np.where(rv != 0, rv, 1.0)), np.nan)
            null = null | (rv == 0)
        else:
            raise ExpressionParseError(op)
    return np.where(null, 0.0, out), null, "num"


def _kleene_and(l: Series, r: Series) -> Series:
    lv, ln, _ = l
    rv, rn, _ = r
    lv = lv.astype(bool) & ~ln
    rv = rv.astype(bool) & ~rn
    false_l = ~lv & ~ln
    false_r = ~rv & ~rn
    out = lv & rv
    null = (ln | rn) & ~false_l & ~false_r
    return out, null, "bool"


def _kleene_or(l: Series, r: Series) -> Series:
    lv, ln, _ = l
    rv, rn, _ = r
    lv = lv.astype(bool) & ~ln
    rv = rv.astype(bool) & ~rn
    out = lv | rv
    null = (ln | rn) & ~lv & ~rv
    return out, null, "bool"


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def _eval(node: Node, table: Table, n: int) -> Series:
    if isinstance(node, Lit):
        if node.value is None:
            return _const(n, None, "num")
        if isinstance(node.value, bool):
            return _const(n, node.value, "bool")
        if isinstance(node.value, (int, float)):
            return _const(n, node.value, "num")
        return _const(n, node.value, "str")
    if isinstance(node, Col):
        return _col_series(table.column(node.name))
    if isinstance(node, Un):
        x = _eval(node.x, table, n)
        if node.op == "neg":
            v, nl, _ = _to_num(x)
            return -v, nl, "num"
        v, nl, _ = x
        return ~(v.astype(bool) & ~nl) & ~nl, nl, "bool"
    if isinstance(node, Bin):
        if node.op == "and":
            return _kleene_and(_eval(node.l, table, n), _eval(node.r, table, n))
        if node.op == "or":
            return _kleene_or(_eval(node.l, table, n), _eval(node.r, table, n))
        if node.op in ("eq", "ne", "lt", "le", "gt", "ge"):
            return _cmp(node.op, _eval(node.l, table, n), _eval(node.r, table, n))
        return _arith(node.op, _eval(node.l, table, n), _eval(node.r, table, n))
    if isinstance(node, IsNull):
        _, nl, _ = _eval(node.x, table, n)
        out = ~nl if node.negated else nl
        return out, np.zeros(n, dtype=bool), "bool"
    if isinstance(node, InList):
        x = _eval(node.x, table, n)
        acc: Optional[Series] = None
        for item in node.items:
            c = _cmp("eq", x, _eval(item, table, n))
            acc = c if acc is None else _kleene_or(acc, c)
        if acc is None:
            acc = _const(n, False, "bool")
        if node.negated:
            v, nl, _ = acc
            return ~v & ~nl, nl, "bool"
        return acc
    if isinstance(node, Between):
        x = _eval(node.x, table, n)
        lo = _cmp("ge", x, _eval(node.lo, table, n))
        hi = _cmp("le", x, _eval(node.hi, table, n))
        out = _kleene_and(lo, hi)
        if node.negated:
            v, nl, _ = out
            return ~v & ~nl, nl, "bool"
        return out
    if isinstance(node, Like):
        xv, xn, _ = _to_str(_eval(node.x, table, n))
        pat = node.pattern
        if not isinstance(pat, Lit) or not isinstance(pat.value, str):
            raise ExpressionParseError("LIKE/RLIKE pattern must be a string literal")
        rx = re.compile(pat.value if node.regex else _like_to_regex(pat.value))
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            if not xn[i]:
                s = str(xv[i])
                out[i] = bool(rx.search(s)) if node.regex else bool(rx.match(s))
        if node.negated:
            out = ~out & ~xn
        return out, xn, "bool"
    if isinstance(node, Func):
        return _eval_func(node, table, n)
    if isinstance(node, Case):
        conds = [_eval(cond, table, n) for cond, _ in node.branches]
        thens = [_eval(then, table, n) for _, then in node.branches]
        otherwise = (
            _eval(node.otherwise, table, n) if node.otherwise is not None else None
        )
        results = thens + ([otherwise] if otherwise is not None else [])
        kind = _common_kind([s[2] for s in results]) if results else "num"
        results = [_coerce_kind(s, kind) for s in results]
        result_v = np.empty(n, dtype=object) if kind == "str" else np.zeros(
            n, dtype=bool if kind == "bool" else np.float64
        )
        if kind == "str":
            result_v[:] = ""
        result_null = np.ones(n, dtype=bool)
        assigned = np.zeros(n, dtype=bool)
        for (cv, cn, _), (tv, tn, _) in zip(conds, results[: len(thens)]):
            hit = cv.astype(bool) & ~cn & ~assigned
            result_v[hit] = tv[hit]
            result_null[hit] = tn[hit]
            assigned |= hit
        if otherwise is not None:
            ov, on, _ = results[-1]
            rest = ~assigned
            result_v[rest] = ov[rest]
            result_null[rest] = on[rest]
        return result_v, result_null, kind
    raise ExpressionParseError(f"cannot evaluate {node}")


def _common_kind(kinds: Sequence[str]) -> str:
    if "str" in kinds:
        return "str"
    if "num" in kinds:
        return "num"
    return "bool"


def _coerce_kind(s: Series, kind: str) -> Series:
    if s[2] == kind:
        return s
    if kind == "str":
        return _to_str(s)
    if kind == "num":
        return _to_num(s)
    v, nl, _ = s
    return v.astype(bool), nl, "bool"


def _eval_func(node: Func, table: Table, n: int) -> Series:
    name = node.name
    if name == "COALESCE":
        args = [_eval(arg, table, n) for arg in node.args]
        if not args:
            return np.zeros(n), np.ones(n, dtype=bool), "num"
        kind = _common_kind([s[2] for s in args])
        args = [_coerce_kind(s, kind) for s in args]
        out_v = np.empty(n, dtype=object) if kind == "str" else np.zeros(
            n, dtype=bool if kind == "bool" else np.float64
        )
        if kind == "str":
            out_v[:] = ""
        out_null = np.ones(n, dtype=bool)
        for v, nl, _ in args:
            fill = out_null & ~nl
            out_v[fill] = v[fill]
            out_null &= nl
        return out_v, out_null, kind
    if name == "ABS":
        v, nl, _ = _to_num(_eval(node.args[0], table, n))
        return np.abs(v), nl, "num"
    if name in ("LENGTH", "LEN", "CHAR_LENGTH"):
        v, nl, _ = _to_str(_eval(node.args[0], table, n))
        out = np.array([len(str(x)) if not nl[i] else 0 for i, x in enumerate(v)], dtype=np.float64)
        return out, nl, "num"
    if name in ("LOWER", "UPPER", "TRIM"):
        v, nl, _ = _to_str(_eval(node.args[0], table, n))
        fn = {"LOWER": str.lower, "UPPER": str.upper, "TRIM": str.strip}[name]
        out = np.empty(n, dtype=object)
        for i, x in enumerate(v):
            out[i] = fn(str(x)) if not nl[i] else ""
        return out, nl, "str"
    if name == "ISNULL":
        _, nl, _ = _eval(node.args[0], table, n)
        return nl.copy(), np.zeros(n, dtype=bool), "bool"
    if name == "ISNOTNULL":
        _, nl, _ = _eval(node.args[0], table, n)
        return ~nl, np.zeros(n, dtype=bool), "bool"
    raise ExpressionParseError(f"unknown function {name}")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class Predicate:
    """A parsed SQL-ish expression evaluable over a Table."""

    def __init__(self, expression: str):
        self.expression = expression
        self.ast = parse(expression)

    def eval_mask(self, table: Table) -> np.ndarray:
        """Boolean row mask; NULL -> False (SQL WHERE semantics)."""
        v, null, kind = _eval(self.ast, table, table.num_rows)
        return np.asarray(v, dtype=bool) & ~null

    def eval(self, table: Table) -> Series:
        return _eval(self.ast, table, table.num_rows)

    def referenced_columns(self) -> List[str]:
        out: List[str] = []

        def walk(node: Node):
            if isinstance(node, Col):
                out.append(node.name)
            for f in getattr(node, "__dataclass_fields__", {}):
                v = getattr(node, f)
                if isinstance(v, Node):
                    walk(v)
                elif isinstance(v, list):
                    for item in v:
                        if isinstance(item, Node):
                            walk(item)
                        elif isinstance(item, tuple):
                            for x in item:
                                if isinstance(x, Node):
                                    walk(x)

        walk(self.ast)
        return out


def eval_predicate(expression: str, table: Table) -> np.ndarray:
    return Predicate(expression).eval_mask(table)


def validate_expression(expression: str) -> None:
    """Raise ExpressionParseError if the expression does not parse."""
    parse(expression)


def normalize_expression(expression: str) -> str:
    """Canonical text for an expression: token-normalized, single-spaced.

    Two where-clauses that normalize identically are semantically the same
    predicate even if they differ in whitespace, backticks, `==` vs `=`,
    keyword case, or numeric literal spelling (`1` vs `1.0`). The fused-scan
    batcher groups jobs by where-clause *text*, so the lint layer uses this
    to flag formatting-only differences that would silently break fusion.

    Raises ExpressionParseError if the expression does not tokenize.
    """
    canon_ops = {"==": "=", "<>": "!="}
    parts: List[str] = []
    for tok in _tokenize(expression):
        text = tok.text
        if tok.kind == "op":
            text = canon_ops.get(text, text)
        elif tok.kind == "num":
            text = repr(float(text))
        elif tok.kind == "ident":
            # backticks were stripped by the tokenizer; re-quote uniformly
            text = f"`{text}`"
        parts.append(text)
    return " ".join(parts)
