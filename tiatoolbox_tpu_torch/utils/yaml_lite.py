"""A YAML subset writer and reader of the port's own (the card machine has no PyYAML).

``dump`` writes what ``yaml.dump(data)`` writes (PyYAML's default
``Dumper``: block style, sorted keys, width 80, indent 2, non-ASCII escaped
in double quotes) for mappings and sequences of ``None``, ``bool``,
``int``, ``float`` and ``str``, and tags a ``tuple`` ``!!python/tuple`` as
``yaml.dump`` does. Scalar styles and line folding follow PyYAML's emitter
(``Emitter.analyze_scalar``, ``choose_scalar_style``, ``write_plain``,
``write_single_quoted``, ``write_double_quoted``), and a string that would
read back as another type (``"1.5"``, ``"yes"``, ``"~"``, a date) is
quoted, as PyYAML's implicit resolvers decide. It is what JAX's
``save_yaml`` writes (``tiatoolbox_tpu/utils/misc.py:252-262``).

``load`` reads what ``yaml.safe_load`` reads for configuration files
(JAX ``cli/common.py:262-279``): block and flow mappings and sequences,
plain scalars (YAML 1.1's null, bool, int and float resolution, as
``SafeLoader``), single- and double-quoted strings, multi-line scalars,
comments and an opening ``---``.

Anything else is refused by name with ``YamlLiteError``: anchors and
aliases, tags, block scalars (``|``, ``>``), complex keys (``?``),
directives, several documents, timestamps, merge keys, and in ``dump``
other value types (numpy scalars among them) and keys that PyYAML would
write as complex keys.
"""

from __future__ import annotations

import math
import re

__all__ = ["YamlLiteError", "dump", "load"]


class YamlLiteError(ValueError):
    """YAML outside the subset that the port reads or writes."""


# PyYAML's implicit resolvers (``yaml/resolver.py``) in its order, which
# decides between two matches: (tag, pattern, the first characters it takes)
_RESOLVERS = [
    (
        "bool",
        re.compile(
            r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$"
        ),
        "yYnNtTfFoO",
    ),
    (
        "float",
        re.compile(
            r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
            |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
            |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""",
            re.X,
        ),
        "-+0123456789.",
    ),
    (
        "int",
        re.compile(
            r"""^(?:[-+]?0b[0-1_]+
            |[-+]?0[0-7_]+
            |[-+]?(?:0|[1-9][0-9_]*)
            |[-+]?0x[0-9a-fA-F_]+
            |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
            re.X,
        ),
        "-+0123456789",
    ),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"^(?:~|null|Null|NULL|)$"), "~nN"),
    (
        "timestamp",
        re.compile(
            r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
            |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
            (?:[Tt]|[ \t]+)[0-9][0-9]?
            :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
            (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
            re.X,
        ),
        "0123456789",
    ),
    ("value", re.compile(r"^(?:=)$"), "="),
    ("yaml", re.compile(r"^(?:!|&|\*)$"), "!&*"),
]


def resolve_plain(value: str) -> str:
    """The tag PyYAML's resolver gives a plain scalar: ``str`` or another."""
    if value == "":
        return "null"
    for name, regex, first in _RESOLVERS:
        if value[0] in first and regex.match(value):
            return name
    return "str"


# -- writer ---------------------------------------------------------------------

_BREAKS = "\n\x85\u2028\u2029"
_SPACE_OR_BREAK = "\0 \t\r\n\x85\u2028\u2029"
_ESCAPES = {
    "\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0a": "n", "\x0b": "v", "\x0c": "f",
    "\x0d": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N", "\xa0": "_", "\u2028": "L",
    "\u2029": "P",
}


def _analyze(scalar: str) -> dict:
    """PyYAML's ``Emitter.analyze_scalar`` with ``allow_unicode=False``."""
    if not scalar:
        return {"empty": True, "multiline": False, "flow_plain": False, "block_plain": True, "single": True}
    block_ind = flow_ind = line_breaks = special = False
    leading_space = leading_break = trailing_space = trailing_break = False
    break_space = space_break = False
    if scalar.startswith(("---", "...")):
        block_ind = flow_ind = True
    preceded_ws = True
    followed_ws = len(scalar) == 1 or scalar[1] in _SPACE_OR_BREAK
    prev_space = prev_break = False
    n = len(scalar)
    for index, ch in enumerate(scalar):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                flow_ind = block_ind = True
            if ch in "?:":
                flow_ind = True
                if followed_ws:
                    block_ind = True
            if ch == "-" and followed_ws:
                flow_ind = block_ind = True
        else:
            if ch in ",?[]{}":
                flow_ind = True
            if ch == ":":
                flow_ind = True
                if followed_ws:
                    block_ind = True
            if ch == "#" and preceded_ws:
                flow_ind = block_ind = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7e"):
            special = True  # allow_unicode is False: every other character is escaped
        if ch == " ":
            if index == 0:
                leading_space = True
            if index == n - 1:
                trailing_space = True
            if prev_break:
                break_space = True
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            if index == 0:
                leading_break = True
            if index == n - 1:
                trailing_break = True
            if prev_space:
                space_break = True
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded_ws = ch in _SPACE_OR_BREAK
        followed_ws = index + 2 >= n or scalar[index + 2] in _SPACE_OR_BREAK
    flow_plain = block_plain = single = True
    if leading_space or leading_break or trailing_space or trailing_break:
        flow_plain = block_plain = False
    if break_space:
        flow_plain = block_plain = single = False
    if space_break or special:
        flow_plain = block_plain = single = False
    if line_breaks:
        flow_plain = block_plain = False
    if flow_ind:
        flow_plain = False
    if block_ind:
        block_plain = False
    return {
        "empty": False,
        "multiline": line_breaks,
        "flow_plain": flow_plain,
        "block_plain": block_plain,
        "single": single,
    }


def _represent_float(value: float) -> str:
    """PyYAML's ``represent_float``."""
    if value != value:
        return ".nan"
    if value == math.inf:
        return ".inf"
    if value == -math.inf:
        return "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _represent_scalar(value) -> tuple[str, bool]:
    """(text, plain-implicit): whether the text reads back as the value's type."""
    if value is None:
        return "null", True
    kind = type(value)
    if kind is bool:
        return ("true" if value else "false"), True
    if kind is int:
        return str(value), True
    if kind is float:
        return _represent_float(value), True
    if kind is str:
        return value, resolve_plain(value) == "str"
    msg = f"yaml_lite writes None, bool, int, float, str, list, tuple and dict, not {kind.__name__}."
    raise YamlLiteError(msg)


class _Emitter:
    """The state of PyYAML's ``Emitter`` that the block subset reaches."""

    best_width = 80
    best_indent = 2

    def __init__(self) -> None:
        self.out: list[str] = []
        self.indent: int | None = None
        self.indents: list = []
        self.flow_level = 0
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.open_ended = False
        self.root_context = False
        self.mapping_context = False
        self.simple_key_context = False

    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def increase_indent(self, *, flow: bool = False, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = self.best_indent if flow else 0
        elif not indentless:
            self.indent += self.best_indent

    def write_indicator(self, indicator: str, need_whitespace: bool, *, whitespace=False, indention=False) -> None:
        data = indicator if self.whitespace or not need_whitespace else " " + indicator
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False
        self.write(data)

    def write_line_break(self, data: str = "\n") -> None:
        self.whitespace = True
        self.indention = True
        self.out.append(data)
        self.column = 0

    def write_indent(self) -> None:
        indent = self.indent or 0
        if not self.indention or self.column > indent or (self.column == indent and not self.whitespace):
            self.write_line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    # -- nodes ------------------------------------------------------------------

    def node(self, value, *, root=False, mapping=False, simple_key=False) -> None:
        self.root_context = root
        self.mapping_context = mapping
        self.simple_key_context = simple_key
        if isinstance(value, (list, tuple)):
            if type(value) is tuple:
                self.write_indicator("!!python/tuple", True)
            self.sequence(list(value))
        elif isinstance(value, dict):
            self.mapping(value)
        else:
            self.scalar(value)

    def sequence(self, items: list) -> None:
        if not items:
            self.empty_flow("[", "]")
            return
        indentless = self.mapping_context and not self.indention
        self.increase_indent(indentless=indentless)
        for item in items:
            self.write_indent()
            self.write_indicator("-", True, indention=True)
            self.node(item)
        self.indent = self.indents.pop()

    def mapping(self, data: dict) -> None:
        if not data:
            self.empty_flow("{", "}")
            return
        items = list(data.items())
        try:
            items = sorted(items)
        except TypeError:
            pass
        self.increase_indent()
        for key, value in items:
            self.write_indent()
            self.simple_key(key)
            self.node(key, mapping=True, simple_key=True)
            self.write_indicator(":", False)
            self.node(value, mapping=True)
        self.indent = self.indents.pop()

    def simple_key(self, key) -> None:
        """PyYAML's ``check_simple_key``: the port refuses what fails it."""
        if isinstance(key, (list, tuple, dict)):
            msg = "yaml_lite writes scalar mapping keys only (PyYAML would write a complex key)."
            raise YamlLiteError(msg)
        text, _ = _represent_scalar(key)
        info = _analyze(text)
        if len(text) >= 128 or info["empty"] or info["multiline"]:
            msg = f"yaml_lite does not write complex keys (PyYAML's '?' form): {key!r}."
            raise YamlLiteError(msg)

    def empty_flow(self, start: str, end: str) -> None:
        self.write_indicator(start, True, whitespace=True)
        self.flow_level += 1
        self.increase_indent(flow=True)
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.write_indicator(end, False)

    def scalar(self, value) -> None:
        text, plain_ok = _represent_scalar(value)
        info = _analyze(text)
        style = '"'
        if plain_ok and not (self.simple_key_context and (info["empty"] or info["multiline"])) and (
            (self.flow_level and info["flow_plain"]) or (not self.flow_level and info["block_plain"])
        ):
            style = ""
        elif info["single"] and not (self.simple_key_context and info["multiline"]):
            style = "'"
        self.increase_indent(flow=True)
        split = not self.simple_key_context
        if style == '"':
            self.write_double_quoted(text, split)
        elif style == "'":
            self.write_single_quoted(text, split)
        else:
            self.write_plain(text, split)
        self.indent = self.indents.pop()

    # -- scalar writers (PyYAML's, on this emitter's state) ---------------------

    def _breaks(self, text: str, start: int, end: int) -> None:
        if text[start] == "\n":
            self.write_line_break()
        for br in text[start:end]:
            self.write_line_break("\n" if br == "\n" else br)
        self.write_indent()

    def write_plain(self, text: str, split: bool) -> None:
        if self.root_context:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > self.best_width and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self._breaks(text, start, end)
                    self.whitespace = self.indention = False
                    start = end
            elif ch is None or ch in " " + _BREAKS:
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
            end += 1

    def write_single_quoted(self, text: str, split: bool) -> None:
        self.write_indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (
                        start + 1 == end
                        and self.column > self.best_width
                        and split
                        and start != 0
                        and end != len(text)
                    ):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self._breaks(text, start, end)
                    start = end
            elif (ch is None or ch in " " + _BREAKS or ch == "'") and start < end:
                self.write(text[start:end])
                start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
            end += 1
        self.write_indicator("'", False)

    def write_double_quoted(self, text: str, split: bool) -> None:
        self.write_indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or not ("\x20" <= ch <= "\x7e"):
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _ESCAPES:
                        data = "\\" + _ESCAPES[ch]
                    elif ch <= "\xff":
                        data = f"\\x{ord(ch):02X}"
                    elif ch <= "\uffff":
                        data = f"\\u{ord(ch):04X}"
                    else:
                        data = f"\\U{ord(ch):08X}"
                    self.write(data)
                    start = end + 1
            if 0 < end < len(text) - 1 and (ch == " " or start >= end) and self.column + (end - start) > self.best_width and split:
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.write_indicator('"', False)


def dump(data) -> str:
    """The text ``yaml.dump(data)`` writes, for a mapping or sequence root."""
    if not isinstance(data, (dict, list, tuple)):
        msg = f"yaml_lite writes a mapping or a sequence at the root, not {type(data).__name__}."
        raise YamlLiteError(msg)
    emitter = _Emitter()
    emitter.node(data, root=True)
    emitter.write_indent()  # the document's end
    if emitter.open_ended:
        emitter.write_indicator("...", True)
        emitter.write_indent()
    return "".join(emitter.out)


# -- reader ---------------------------------------------------------------------


def _construct_plain(text: str):
    """``SafeConstructor``'s value for a plain scalar."""
    kind = resolve_plain(text)
    if kind == "str":
        return text
    if kind == "null":
        return None
    if kind == "bool":
        return text.lower() in ("yes", "true", "on")
    if kind in ("int", "float"):
        value = text.replace("_", "")
        sign = 1
        if value[0] == "-":
            sign = -1
        if value[0] in "+-":
            value = value[1:]
        if kind == "float":
            value = value.lower()
            if value == ".inf":
                return sign * math.inf
            if value == ".nan":
                return math.nan
            if ":" in value:
                return sign * _sexagesimal(value, float)
            return sign * float(value)
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    msg = f"yaml_lite does not read {kind} scalars: {text!r}."
    raise YamlLiteError(msg)


def _sexagesimal(value: str, kind):
    digits = [kind(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for digit in digits:
        out += digit * base
        base *= 60
    return out


_DQ_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0a", "v": "\x0b",
    "f": "\x0c", "r": "\x0d", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
    "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}


class _Reader:
    """A recursive reader over the text with a cursor (line and column known)."""

    def __init__(self, text: str) -> None:
        if re.search(r"^ *\t", text, re.M):
            msg = "yaml_lite does not read tab indentation."
            raise YamlLiteError(msg)
        self.text = text.replace("\r\n", "\n")
        self.pos = 0

    # -- cursor helpers -------------------------------------------------------------

    def peek(self, offset: int = 0) -> str:
        i = self.pos + offset
        return self.text[i] if i < len(self.text) else ""

    def column(self) -> int:
        return self.pos - (self.text.rfind("\n", 0, self.pos) + 1)

    def error(self, what: str):
        line = self.text.count("\n", 0, self.pos) + 1
        return YamlLiteError(f"yaml_lite: {what} (line {line}).")

    def skip_space(self) -> None:
        while self.peek() == " ":
            self.pos += 1

    def skip_comment(self) -> None:
        self.skip_space()
        if self.peek() == "#":
            while self.peek() not in ("", "\n"):
                self.pos += 1

    def at_line_end(self) -> bool:
        self.skip_comment()
        return self.peek() in ("", "\n")

    def next_content(self) -> int | None:
        """Move past blank and comment lines; the next content's column, or None at the end."""
        while True:
            self.skip_comment()
            if self.peek() == "\n":
                self.pos += 1
                continue
            if self.peek() == "":
                return None
            return self.column()

    def is_separator(self, offset: int) -> bool:
        return self.peek(offset) in ("", " ", "\n")

    def at_marker(self) -> bool:
        """Whether the cursor is on a ``---`` or ``...`` line start."""
        return self.column() == 0 and self.text.startswith(("---", "..."), self.pos) and self.is_separator(3)

    # -- documents ------------------------------------------------------------------

    def document(self):
        col = self.next_content()
        if col is None:
            return None
        if col == 0 and self.text.startswith("---", self.pos) and self.is_separator(3):
            self.pos += 3
            if self.at_line_end():
                col = self.next_content()
                if col is None:
                    return None
                value = self.block_node(-1)
            else:
                self.skip_space()
                value = self.block_node(-1)
        else:
            value = self.block_node(-1)
        col = self.next_content()
        if col is not None and self.text.startswith("...", self.pos) and self.is_separator(3):
            self.pos += 3
            col = self.next_content()
        if col is not None:
            raise self.error("content after the document (yaml_lite reads one document)")
        return value

    # -- block nodes ------------------------------------------------------------------

    def check_refused(self) -> None:
        ch = self.peek()
        names = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                 ">": "block scalars", "%": "directives", "@": "reserved indicators",
                 "`": "reserved indicators"}
        if ch in names:
            raise self.error(f"{names[ch]} are refused")
        if ch == "?" and self.is_separator(1):
            raise self.error("complex keys are refused")
        if self.column() == 0 and self.text.startswith("---", self.pos) and self.is_separator(3):
            raise self.error("several documents are refused")

    def block_node(self, parent_indent: int):
        """The node at the cursor, which sits on content, inside a parent at ``parent_indent``."""
        self.check_refused()
        col = self.column()
        if self.peek() == "-" and self.is_separator(1):
            return self.block_sequence(col)
        if self.line_has_key():
            return self.block_mapping(col)
        return self.inline_value(parent_indent)

    def line_has_key(self) -> bool:
        """Whether the content at the cursor is ``key:`` followed by a separator."""
        save = self.pos
        try:
            ch = self.peek()
            if ch in "[{":
                return False
            if ch in "'\"":
                self.quoted()
                self.skip_space()
                return self.peek() == ":" and self.is_separator(1)
            while self.peek() not in ("", "\n"):
                if self.peek() == ":" and self.is_separator(1):
                    return True
                if self.peek() == "#" and self.text[self.pos - 1] == " ":
                    return False
                self.pos += 1
            return False
        except YamlLiteError:
            return False
        finally:
            self.pos = save

    def block_sequence(self, col: int) -> list:
        items = []
        while True:
            self.pos += 1  # the '-'
            if self.at_line_end():
                nxt = self.next_content()
                if nxt is not None and nxt > col:
                    items.append(self.block_node(col))
                else:
                    items.append(None)
            else:
                self.skip_space()
                items.append(self.block_node(col))
            nxt = self.next_content()
            if nxt is None or nxt < col or self.at_marker():
                return items
            if nxt > col:
                raise self.error("bad indentation of a sequence entry")
            if not (self.peek() == "-" and self.is_separator(1)):
                return items

    def block_mapping(self, col: int) -> dict:
        out = {}
        while True:
            self.check_refused()
            key = self.key()
            self.pos += 1  # the ':'
            if self.at_line_end():
                nxt = self.next_content()
                if nxt is not None and (nxt > col or (nxt == col and self.peek() == "-" and self.is_separator(1))):
                    value = self.block_node(col)
                else:
                    value = None
            else:
                self.skip_space()
                self.check_refused()
                if self.peek() == "-" and self.is_separator(1):
                    raise self.error("a block sequence cannot start on its key's line")
                if self.line_has_key():
                    raise self.error("a mapping cannot start on its key's line")
                value = self.inline_value(col)
            try:
                out[key] = value
            except TypeError:
                raise self.error("an unhashable key") from None
            nxt = self.next_content()
            if nxt is None or nxt < col or self.at_marker():
                return out
            if nxt > col:
                raise self.error("bad indentation of a mapping entry")
            if self.peek() == "-" and self.is_separator(1):
                return out

    def key(self):
        ch = self.peek()
        if ch in "'\"":
            value = self.quoted()
            self.skip_space()
        else:
            start = self.pos
            while not (self.peek() == ":" and self.is_separator(1)):
                if self.peek() in ("", "\n"):
                    raise self.error("a key without ':'")
                self.pos += 1
            value = _construct_plain(self.text[start : self.pos].rstrip(" "))
        if self.peek() != ":":
            raise self.error("a key without ':'")
        return value

    def inline_value(self, parent_indent: int):
        """A scalar or a flow collection that starts at the cursor."""
        ch = self.peek()
        if ch in "[{":
            value = self.flow_node()
        elif ch in "'\"":
            value = self.quoted(parent_indent)
        else:
            return self.plain_block(parent_indent)
        if not self.at_line_end():
            raise self.error("content after a value")
        return value

    def plain_block(self, parent_indent: int):
        """A plain scalar in block context, with its continuation lines."""
        self.check_refused()
        return _construct_plain(self.plain(flow=False, parent_indent=parent_indent))

    def plain(self, *, flow: bool, parent_indent: int = -1) -> str:
        """PyYAML's ``scan_plain``: runs of text joined by their folded spaces."""
        chunks: list[str] = []
        spaces = ""
        while self.peek() != "#":
            start = self.pos
            while True:
                c = self.peek()
                if c in ("", " ", "\t", "\n"):
                    break
                if c == ":" and (self.peek(1) in ("", " ", "\t", "\n") or (flow and self.peek(1) in ",[]{}")):
                    if not flow:
                        raise self.error("a mapping value where a scalar was expected")
                    break
                if flow and c in ",?[]{}":
                    break
                self.pos += 1
            if self.pos == start:
                break
            chunks.append(spaces)
            chunks.append(self.text[start : self.pos])
            ws_start = self.pos
            while self.peek() in (" ", "\t"):
                self.pos += 1
            spaces = self.text[ws_start : self.pos]
            if self.peek() == "\n":
                save = self.pos
                self.pos += 1
                breaks = 0
                while True:
                    while self.peek() == " ":
                        self.pos += 1
                    if self.peek() != "\n":
                        break
                    breaks += 1
                    self.pos += 1
                at_marker = self.column() == 0 and self.text.startswith(("---", "..."), self.pos) and self.is_separator(3)
                if at_marker or self.peek() == "" or (not flow and self.column() <= parent_indent):
                    self.pos = save
                    break
                spaces = "\n" * breaks if breaks else " "
            if not spaces:
                break
        return "".join(chunks)

    # -- flow nodes ------------------------------------------------------------------

    def flow_space(self) -> None:
        while True:
            self.skip_comment()
            if self.peek() == "\n":
                self.pos += 1
                continue
            return

    def flow_node(self):
        self.flow_space()
        self.check_refused()
        ch = self.peek()
        if ch == "[":
            self.pos += 1
            out = []
            while True:
                self.flow_space()
                if self.peek() == "]":
                    self.pos += 1
                    return out
                item = self.flow_node()
                self.flow_space()
                if self.peek() == ":":
                    raise self.error("a single-pair mapping inside a flow sequence is refused")
                out.append(item)
                if self.peek() == ",":
                    self.pos += 1
                elif self.peek() != "]":
                    raise self.error("expected ',' or ']'")
        if ch == "{":
            self.pos += 1
            out = {}
            while True:
                self.flow_space()
                if self.peek() == "}":
                    self.pos += 1
                    return out
                key = self.flow_node()
                self.flow_space()
                value = None
                if self.peek() == ":":
                    self.pos += 1
                    self.flow_space()
                    if self.peek() not in ",}":
                        value = self.flow_node()
                        self.flow_space()
                try:
                    out[key] = value
                except TypeError:
                    raise self.error("an unhashable key") from None
                if self.peek() == ",":
                    self.pos += 1
                elif self.peek() != "}":
                    raise self.error("expected ',' or '}'")
        if ch in "'\"":
            return self.quoted()
        if ch in ("", ",", "]", "}"):
            raise self.error("a flow entry is missing")
        return _construct_plain(self.plain(flow=True))

    # -- quoted scalars -----------------------------------------------------------

    def quoted(self, parent_indent: int = -1) -> str:
        quote = self.peek()
        self.pos += 1
        chunks: list[str] = []
        while True:
            ch = self.peek()
            if ch == "":
                raise self.error("an unterminated quoted scalar")
            if quote == "'" and ch == "'":
                if self.peek(1) == "'":
                    chunks.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(chunks)
            if quote == '"' and ch == '"':
                self.pos += 1
                return "".join(chunks)
            if quote == '"' and ch == "\\":
                nxt = self.peek(1)
                if nxt == "\n":
                    self.pos += 2
                    self.fold_breaks(chunks, escaped=True)
                    continue
                if nxt in _DQ_ESCAPES:
                    chunks.append(_DQ_ESCAPES[nxt])
                    self.pos += 2
                    continue
                if nxt in _DQ_HEX:
                    n = _DQ_HEX[nxt]
                    digits = self.text[self.pos + 2 : self.pos + 2 + n]
                    if len(digits) != n or not all(c in "0123456789abcdefABCDEF" for c in digits):
                        raise self.error("a bad escape in a double-quoted scalar")
                    chunks.append(chr(int(digits, 16)))
                    self.pos += 2 + n
                    continue
                raise self.error(f"an unknown escape \\{nxt} in a double-quoted scalar")
            if ch in " \t" or ch == "\n":
                start = self.pos
                while self.peek() in (" ", "\t"):
                    self.pos += 1
                if self.peek() == "\n":
                    self.pos += 1
                    self.fold_breaks(chunks, escaped=False)
                else:
                    chunks.append(self.text[start : self.pos])
                continue
            chunks.append(ch)
            self.pos += 1

    def fold_breaks(self, chunks: list, *, escaped: bool) -> None:
        """YAML's flow folding after a line break inside quotes."""
        breaks = 0
        while True:
            while self.peek() in (" ", "\t"):
                self.pos += 1
            if self.peek() == "\n":
                breaks += 1
                self.pos += 1
                continue
            break
        if self.column() == 0 and self.text.startswith(("---", "..."), self.pos):
            raise self.error("a document marker inside a quoted scalar")
        if escaped:
            chunks.append("\n" * breaks)
        else:
            chunks.append("\n" * breaks if breaks else " ")


def load(text: str):
    """The value ``yaml.safe_load(text)`` gives, for the subset above."""
    return _Reader(text).document()
