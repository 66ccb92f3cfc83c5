"""Typed expression analysis: static dtype + nullability inference.

Walks the `data/expr.py` AST against a `SchemaInfo`, mirroring the
evaluator's coercion rules (`_coerce_pair` / `_to_num` / Kleene logic)
WITHOUT touching data. Inference is conservative on nullability: it may
report nullable for an expression that never yields NULL, but must never
report non-nullable for one that can — the differential suite
(tests/test_lint_static_vs_eval.py) enforces exactly that contract
against real evaluation.

Kinds are the evaluator's: 'num' | 'str' | 'bool'.

The port's copy of deequ_tpu/lint/typecheck.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

from deequ_tpu_torch.data.expr import (
    Between,
    Bin,
    Case,
    Col,
    ExpressionParseError,
    Func,
    InList,
    IsNull,
    Like,
    Lit,
    Node,
    Un,
    parse,
)
from deequ_tpu_torch.data.table import ColumnType
from deequ_tpu_torch.lint.diagnostics import Diagnostic, Severity
from deequ_tpu_torch.lint.schema import SchemaInfo

_CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")
_ARITH_OPS = ("add", "sub", "mul", "div", "mod")

_KIND_OF_CTYPE = {
    ColumnType.STRING: "str",
    ColumnType.BOOLEAN: "bool",
    # LONG / DOUBLE / DECIMAL / TIMESTAMP all evaluate through as_float()
}


@dataclass
class TypedExpr:
    kind: str  # 'num' | 'str' | 'bool'
    nullable: bool


def _parses_as_float(text: str) -> bool:
    try:
        float(text)
        return True
    except (TypeError, ValueError):
        return False


class _Analyzer:
    def __init__(self, schema: SchemaInfo, source: Optional[str]):
        self.schema = schema
        self.source = source
        self.diags: List[Diagnostic] = []

    def _diag(
        self,
        code: str,
        severity: Severity,
        message: str,
        node: Optional[Node] = None,
        suggestion: Optional[str] = None,
    ) -> None:
        self.diags.append(
            Diagnostic(
                code,
                severity,
                message,
                source=self.source,
                span=getattr(node, "span", None),
                suggestion=suggestion,
            )
        )

    # -- coercions (mirror _to_num / _to_str) -------------------------------

    def _as_num(self, t: TypedExpr, node: Node, context: str) -> TypedExpr:
        if t.kind == "num":
            return t
        if t.kind == "bool":
            return TypedExpr("num", t.nullable)
        # str -> num: parse failures become NULLs at eval time
        if isinstance(node, Lit) and isinstance(node.value, str):
            if not _parses_as_float(node.value):
                self._diag(
                    "DQ103",
                    Severity.ERROR,
                    f"string literal {node.value!r} is not numeric; "
                    f"{context} always yields NULL",
                    node,
                )
                return TypedExpr("num", True)
            return TypedExpr("num", t.nullable)
        self._diag(
            "DQ102",
            Severity.WARNING,
            f"string expression coerced to a number in {context}; "
            "non-numeric rows become NULL",
            node,
        )
        return TypedExpr("num", True)

    def _coerce_pair(
        self, lt: TypedExpr, rt: TypedExpr, lnode: Node, rnode: Node, context: str
    ) -> Tuple[TypedExpr, TypedExpr, str]:
        if lt.kind == rt.kind:
            return lt, rt, lt.kind
        if "num" in (lt.kind, rt.kind):
            if "bool" in (lt.kind, rt.kind):
                self._diag(
                    "DQ102",
                    Severity.WARNING,
                    f"comparing a boolean with a number in {context}",
                    lnode if lt.kind == "bool" else rnode,
                )
            lt2 = self._as_num(lt, lnode, context) if lt.kind != "num" else lt
            rt2 = self._as_num(rt, rnode, context) if rt.kind != "num" else rt
            return lt2, rt2, "num"
        # bool vs str -> both compared as strings 'true'/'false'
        self._diag(
            "DQ102",
            Severity.WARNING,
            f"comparing a boolean with a string in {context}; the boolean "
            "is rendered as 'true'/'false'",
            lnode if lt.kind == "bool" else rnode,
        )
        return TypedExpr("str", lt.nullable), TypedExpr("str", rt.nullable), "str"

    def _expect_bool(self, t: TypedExpr, node: Node, context: str) -> None:
        if t.kind == "str":
            self._diag(
                "DQ102",
                Severity.WARNING,
                f"string expression used as a boolean in {context}",
                node,
            )

    # -- walk ----------------------------------------------------------------

    def visit(self, node: Node) -> TypedExpr:
        if isinstance(node, Lit):
            if node.value is None:
                return TypedExpr("num", True)
            if isinstance(node.value, bool):
                return TypedExpr("bool", False)
            if isinstance(node.value, (int, float)):
                return TypedExpr("num", False)
            return TypedExpr("str", False)

        if isinstance(node, Col):
            fld = self.schema.field(node.name)
            if fld is None:
                self._diag(
                    "DQ101",
                    Severity.ERROR,
                    f"unresolved column {node.name!r}",
                    node,
                    suggestion=self.schema.suggest(node.name),
                )
                return TypedExpr("num", True)
            return TypedExpr(
                _KIND_OF_CTYPE.get(fld.ctype, "num"), bool(fld.nullable)
            )

        if isinstance(node, (Bin,)) and node.op in ("and", "or"):
            lt = self.visit(node.l)
            rt = self.visit(node.r)
            self._expect_bool(lt, node.l, f"{node.op.upper()}")
            self._expect_bool(rt, node.r, f"{node.op.upper()}")
            return TypedExpr("bool", lt.nullable or rt.nullable)

        if isinstance(node, Bin) and node.op in _CMP_OPS:
            lt = self.visit(node.l)
            rt = self.visit(node.r)
            lt2, rt2, _ = self._coerce_pair(lt, rt, node.l, node.r, "a comparison")
            return TypedExpr("bool", lt2.nullable or rt2.nullable)

        if isinstance(node, Bin) and node.op in _ARITH_OPS:
            lt = self._as_num(self.visit(node.l), node.l, "arithmetic")
            rt = self._as_num(self.visit(node.r), node.r, "arithmetic")
            nullable = lt.nullable or rt.nullable
            if node.op in ("div", "mod"):
                # x/0 -> NULL; only a provably non-zero literal divisor is safe
                safe = isinstance(node.r, Lit) and isinstance(
                    node.r.value, (int, float)
                ) and not isinstance(node.r.value, bool) and float(node.r.value) != 0.0
                nullable = nullable or not safe
            return TypedExpr("num", nullable)

        if isinstance(node, Bin):
            return TypedExpr("num", True)

        if isinstance(node, Un):
            if node.op == "neg":
                t = self._as_num(self.visit(node.x), node.x, "negation")
                return TypedExpr("num", t.nullable)
            t = self.visit(node.x)
            self._expect_bool(t, node.x, "NOT")
            return TypedExpr("bool", t.nullable)

        if isinstance(node, IsNull):
            self.visit(node.x)
            return TypedExpr("bool", False)

        if isinstance(node, InList):
            xt = self.visit(node.x)
            nullable = xt.nullable
            for item in node.items:
                it = self.visit(item)
                it2_l, it2_r, _ = self._coerce_pair(
                    xt, it, node.x, item, "an IN list"
                )
                nullable = nullable or it2_l.nullable or it2_r.nullable
            if not node.items:
                nullable = False
            return TypedExpr("bool", nullable)

        if isinstance(node, Between):
            xt = self.visit(node.x)
            lo = self.visit(node.lo)
            hi = self.visit(node.hi)
            l1, l2, _ = self._coerce_pair(xt, lo, node.x, node.lo, "BETWEEN")
            h1, h2, _ = self._coerce_pair(xt, hi, node.x, node.hi, "BETWEEN")
            return TypedExpr(
                "bool", l1.nullable or l2.nullable or h1.nullable or h2.nullable
            )

        if isinstance(node, Like):
            xt = self.visit(node.x)
            kw = "RLIKE" if node.regex else "LIKE"
            if xt.kind == "num":
                self._diag(
                    "DQ102",
                    Severity.WARNING,
                    f"{kw} applied to a numeric expression; it is matched "
                    "against its decimal rendering",
                    node.x,
                )
            pat = node.pattern
            if not isinstance(pat, Lit) or not isinstance(pat.value, str):
                self._diag(
                    "DQ103",
                    Severity.ERROR,
                    f"{kw} pattern must be a string literal",
                    pat,
                )
            elif node.regex:
                try:
                    re.compile(pat.value)
                except re.error as e:
                    self._diag(
                        "DQ103",
                        Severity.ERROR,
                        f"invalid regular expression {pat.value!r}: {e}",
                        pat,
                    )
            return TypedExpr("bool", xt.nullable)

        if isinstance(node, Func):
            return self._visit_func(node)

        if isinstance(node, Case):
            results: List[TypedExpr] = []
            for cond, then in node.branches:
                ct = self.visit(cond)
                self._expect_bool(ct, cond, "CASE WHEN")
                results.append(self.visit(then))
            otherwise = (
                self.visit(node.otherwise) if node.otherwise is not None else None
            )
            all_results = results + ([otherwise] if otherwise is not None else [])
            kinds = [t.kind for t in all_results]
            if "str" in kinds:
                kind = "str"
            elif "num" in kinds:
                kind = "num"
            elif kinds:
                kind = "bool"
            else:
                kind = "num"
            nullable = (
                node.otherwise is None
                or any(t.nullable for t in all_results)
                # str results coerced to num can gain NULLs
                or (kind == "num" and any(t.kind == "str" for t in all_results))
            )
            return TypedExpr(kind, nullable)

        return TypedExpr("num", True)

    def _visit_func(self, node: Func) -> TypedExpr:
        name = node.name
        args = [self.visit(a) for a in node.args]

        def need(n: int) -> bool:
            if len(node.args) < n:
                self._diag(
                    "DQ105",
                    Severity.ERROR,
                    f"{name} expects at least {n} argument(s), got {len(node.args)}",
                    node,
                )
                return False
            return True

        if name == "COALESCE":
            if not args:
                return TypedExpr("num", True)
            kinds = [t.kind for t in args]
            if "str" in kinds:
                kind = "str"
            elif "num" in kinds:
                kind = "num"
            else:
                kind = "bool"
            nullable = all(
                t.nullable or (kind == "num" and t.kind == "str") for t in args
            )
            return TypedExpr(kind, nullable)
        if name == "ABS":
            if not need(1):
                return TypedExpr("num", True)
            t = self._as_num(args[0], node.args[0], "ABS")
            return TypedExpr("num", t.nullable)
        if name in ("LENGTH", "LEN", "CHAR_LENGTH"):
            if not need(1):
                return TypedExpr("num", True)
            return TypedExpr("num", args[0].nullable)
        if name in ("LOWER", "UPPER", "TRIM"):
            if not need(1):
                return TypedExpr("str", True)
            return TypedExpr("str", args[0].nullable)
        if name in ("ISNULL", "ISNOTNULL"):
            if not need(1):
                return TypedExpr("bool", False)
            return TypedExpr("bool", False)
        self._diag(
            "DQ104",
            Severity.ERROR,
            f"unknown function {name}; the scan would fail at evaluation time",
            node,
        )
        return TypedExpr("num", True)


def analyze_ast(
    ast: Node, schema: SchemaInfo, source: Optional[str] = None
) -> Tuple[TypedExpr, List[Diagnostic]]:
    analyzer = _Analyzer(schema, source)
    typed = analyzer.visit(ast)
    return typed, analyzer.diags


def analyze_expression(
    expression: str, schema: SchemaInfo
) -> Tuple[Optional[TypedExpr], List[Diagnostic]]:
    """Parse + typecheck an expression against a schema. On parse failure
    returns (None, [DQ100 diagnostic]); never raises."""
    try:
        ast = parse(expression)
    except ExpressionParseError as e:
        return None, [
            Diagnostic(
                "DQ100",
                Severity.ERROR,
                f"expression does not parse: {e}",
                source=expression,
            )
        ]
    typed, diags = analyze_ast(ast, schema, source=expression)
    return typed, diags
