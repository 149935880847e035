"""Query DSL (counterpart of ``tiatoolbox_tpu/annotation/dsl.py:1-315``).

One predicate string, two evaluation modes.

A restricted-Python predicate such as ``props["class"] == 2`` can be
evaluated directly (``PY_GLOBALS``, post-query filtering) or compiled
into an SQLite WHERE clause (``SQL_GLOBALS``) by evaluating the same
string against operator-overloading proxy objects. Same contract as
reference ``annotation/dsl.py:72-459``.

Never evaluate untrusted input: ``eval`` is used for parsing.
"""

from __future__ import annotations

import json
import re
from numbers import Number


class SQLExpr:
    """Base class for SQL expression fragments built via operators."""

    def _sql(self) -> str:
        raise NotImplementedError

    def __str__(self) -> str:
        return self._sql()

    def __repr__(self) -> str:
        return self._sql()

    def __hash__(self) -> int:
        return hash(self._sql())

    # comparison / arithmetic operators → binary fragments
    def __eq__(self, other):  # type: ignore[override]
        return _Bin(self, "==", other)

    def __ne__(self, other):  # type: ignore[override]
        return _Bin(self, "!=", other)

    def __gt__(self, other):
        return _Bin(self, ">", other)

    def __ge__(self, other):
        return _Bin(self, ">=", other)

    def __lt__(self, other):
        return _Bin(self, "<", other)

    def __le__(self, other):
        return _Bin(self, "<=", other)

    def __add__(self, other):
        return _Bin(self, "+", other)

    def __radd__(self, other):
        return _Bin(other, "+", self)

    def __sub__(self, other):
        return _Bin(self, "-", other)

    def __rsub__(self, other):
        return _Bin(other, "-", self)

    def __mul__(self, other):
        return _Bin(self, "*", other)

    def __rmul__(self, other):
        return _Bin(other, "*", self)

    def __truediv__(self, other):
        # sqlite `/` truncates on int operands; force real division to
        # match python semantics
        return _Bin(_Bin(self, "*", 1.0), "/", other)

    def __rtruediv__(self, other):
        return _Bin(_Bin(other, "*", 1.0), "/", self)

    def __floordiv__(self, other):
        # real division first: sqlite int `/` truncates toward zero,
        # which disagrees with python floor division for negatives
        return _Func("FLOOR", _Bin(_Bin(self, "*", 1.0), "/", other))

    def __rfloordiv__(self, other):
        return _Func("FLOOR", _Bin(_Bin(other, "*", 1.0), "/", self))

    def __mod__(self, other):
        # python modulo takes the divisor's sign and works on floats;
        # sqlite `%` truncates AND casts operands to INTEGER. Compile the
        # definition directly: a - FLOOR(a/b)*b (real division), which is
        # float-correct and sign-correct in one form.
        return _mod_fragment(self, other)

    def __rmod__(self, other):
        return _mod_fragment(other, self)

    def __pow__(self, other):
        return _Func("POWER", self, other)

    def __rpow__(self, other):
        return _Func("POWER", other, self)

    def __neg__(self):
        return _Prefix("-", self)

    def __abs__(self):
        return _Func("ABS", self)

    # and/or arrive as & / | when used with eval (bool ops short-circuit
    # on truthiness; the stores rewrite and/or → &/| is NOT done, python
    # `and`/`or` call __bool__; instead the reference relies on eval
    # returning fragments for `x and y` via truthiness of lhs. Keep &/|
    # plus truthy-passthrough for `and`/`or`.
    def __and__(self, other):
        return _Bin(self, "AND", other)

    def __rand__(self, other):
        return _Bin(other, "AND", self)

    def __or__(self, other):
        return _Bin(self, "OR", other)

    def __ror__(self, other):
        return _Bin(other, "OR", self)

    def __bool__(self) -> bool:
        # `a and b` evaluates truthiness of a then returns b — returning
        # True makes `and` yield the RHS fragment; this loses the LHS,
        # so predicates should prefer `&`/`|`. Matches reference caveat.
        return True

    def __contains__(self, other) -> bool:
        msg = "Use has_key(props, key) or json contains via `x in props[...]`."
        raise TypeError(msg)


def _fmt(value) -> str:
    if isinstance(value, SQLExpr):
        return value._sql()
    if isinstance(value, str):
        return json.dumps(value)
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, Number):
        return str(value)
    msg = f"Unsupported literal in SQL expression: {value!r}"
    raise TypeError(msg)


class _Bin(SQLExpr):
    def __init__(self, lhs, op: str, rhs) -> None:
        self.lhs, self.op, self.rhs = lhs, op, rhs

    def _sql(self) -> str:
        return f"({_fmt(self.lhs)} {self.op} {_fmt(self.rhs)})"


class _Prefix(SQLExpr):
    def __init__(self, op: str, operand) -> None:
        self.op, self.operand = op, operand

    def _sql(self) -> str:
        return f"({self.op}{_fmt(self.operand)})"


class _Func(SQLExpr):
    def __init__(self, name: str, *args) -> None:
        self.name, self.args = name, args

    def _sql(self) -> str:
        return f"{self.name}({', '.join(_fmt(a) for a in self.args)})"


def _mod_fragment(a, b):
    # a - FLOOR(a*1.0/b)*b: python float/sign semantics in one form, with
    # each operand compiled into the fragment only twice (vs 3x for the
    # ((a%b)+b)%b rewrite, which is also integer-only under sqlite's `%`).
    return _Bin(
        a, "-", _Bin(_Func("FLOOR", _Bin(_Bin(a, "*", 1.0), "/", b)), "*", b)
    )


class SQLJSONDictionary(SQLExpr):
    """``props`` proxy: compiles key access to SQLite json_extract."""

    def __init__(self, acc: str = "") -> None:
        self.acc = acc

    def _sql(self) -> str:
        return f"json_extract(properties, '$.{self.acc}')"

    def __getitem__(self, key) -> "SQLJSONDictionary":
        key_str = f"[{key}]" if isinstance(key, int) else f'"{key}"'
        joiner = "." if self.acc and not isinstance(key, int) else ""
        return SQLJSONDictionary(self.acc + joiner + key_str)

    def get(self, key, default=None):
        return _Func("IFNULL", self[key], default)

    def __contains__(self, key) -> bool:  # "key" in props → compiled later
        msg = "Use has_key(props, key) in SQL mode."
        raise TypeError(msg)


class SQLRegex(SQLExpr):
    """Regex match fragment (REGEXP custom function)."""

    def __init__(self, pattern, string, flags: int = 0) -> None:
        self.pattern, self.string, self.flags = pattern, string, flags

    def _sql(self) -> str:
        if self.flags:
            return f"REGEXP({_fmt(self.pattern)}, {_fmt(self.string)}, {int(self.flags)})"
        return f"({_fmt(self.string)} REGEXP {_fmt(self.pattern)})"

    @classmethod
    def search(cls, pattern, string, flags=0) -> "SQLRegex":
        return cls(pattern, string, int(flags))


def _sql_is_none(x):
    return _Postfix(x, "IS NULL")


def _sql_is_not_none(x):
    return _Postfix(x, "IS NOT NULL")


class _Postfix(SQLExpr):
    def __init__(self, operand, op: str) -> None:
        self.operand, self.op = operand, op

    def _sql(self) -> str:
        return f"({_fmt(self.operand)} {self.op})"


def _sql_list_sum(x):
    return _Func("LISTSUM", x)


class _Raw(SQLExpr):
    def __init__(self, sql: str) -> None:
        self.sql = sql

    def _sql(self) -> str:
        return self.sql


def _sql_has_key(dictionary, key):
    if not isinstance(dictionary, SQLJSONDictionary):
        msg = "Unsupported type for has_key."
        raise TypeError(msg)
    # json_type is NULL only when the path is absent; json_extract is
    # also NULL for keys holding a JSON null, which has_key must count
    child = dictionary[key]
    return _Postfix(_Raw(f"json_type(properties, '$.{child.acc}')"), "IS NOT NULL")


def _sql_contains(container, item):
    return _Func("CONTAINS", container, item)


# -- python-mode helpers -------------------------------------------------------


def py_is_none(x) -> bool:
    """True when x is None (python-eval mode helper)."""
    return x is None


def py_is_not_none(x) -> bool:
    """True when x is not None (python-eval mode helper)."""
    return x is not None


def py_regexp(pattern, string, flags: int = 0):
    """First regex match of pattern in string, or None."""
    match = re.compile(pattern, flags=flags).search(string)
    return match[0] if match else None


def json_list_sum(json_list: str):
    """SQL custom function: sum of a JSON-encoded number list."""
    return sum(json.loads(json_list))


def json_contains(json_str: str, x) -> bool:
    """SQL custom function: membership in a JSON-encoded container."""
    return x in json.loads(json_str)


_COMMON_BUILTINS = {"abs": abs}

SQL_GLOBALS = {
    "__builtins__": {**_COMMON_BUILTINS, "sum": _sql_list_sum},
    "props": SQLJSONDictionary(),
    "is_none": _sql_is_none,
    "is_not_none": _sql_is_not_none,
    "regexp": SQLRegex.search,
    "has_key": _sql_has_key,
    "contains": _sql_contains,
    "re": re.RegexFlag,
}

PY_GLOBALS = {
    "__builtins__": {**_COMMON_BUILTINS, "sum": sum},
    "is_none": py_is_none,
    "is_not_none": py_is_not_none,
    "regexp": py_regexp,
    "has_key": lambda a, b: b in a,
    "contains": lambda a, b: b in a,
    "re": re.RegexFlag,
}
