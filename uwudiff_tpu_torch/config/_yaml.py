"""A YAML reader for the subset the repo's configs use (no PyYAML needed).

What it reads: block mappings and sequences (``- - {...}`` nesting
included), flow mappings and sequences, plain and quoted scalars resolved
as PyYAML's ``safe_load`` resolves them (YAML 1.1: ``null``/``~``/empty,
``true``/``yes``/``on`` and their opposites, decimal integers, floats with
a dot such as ``1.0e-05``, ``.inf``/``.nan``; anything else stays a
string), and comments. What it refuses, by raising ``ValueError``:
anchors, aliases, tags, block scalars (``|``, ``>``), several documents,
merge keys, tabs in indentation and flow collections spread over lines,
so that a file outside the subset is never misread.
"""

from __future__ import annotations

import re

__all__ = ["load_yaml"]

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
# plain scalars PyYAML resolves to values this reader does not make
_OTHER_RESOLVED = re.compile(r"[-+]?(0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?)$"
                             r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_SPECIAL_FLOATS = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
                   "+.inf": float("inf"), "+.Inf": float("inf"), "+.INF": float("inf"),
                   "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf"),
                   ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}


def _fail(lineno: int, msg: str):
    raise ValueError(f"YAML line {lineno}: {msg} (outside the subset this reader takes)")


def _plain(text: str, lineno: int):
    """A plain (unquoted) scalar, resolved as PyYAML's safe loader does."""
    if text and text[0] in "&*!|>%@`":
        _fail(lineno, f"{text[0]!r} starts an anchor, alias, tag, block scalar or reserved scalar")
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    if text == "<<":
        _fail(lineno, "merge keys")
    if _OTHER_RESOLVED.match(text):
        _fail(lineno, f"{text!r} resolves to an octal, hexadecimal, binary, sexagesimal or timestamp value")
    return text


def _quoted(text: str, i: int, lineno: int) -> tuple[str, int]:
    """The quoted string starting at ``text[i]``; returns (value, index past it)."""
    quote = text[i]
    out, j = [], i + 1
    while j < len(text):
        c = text[j]
        if quote == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if quote == '"' and c == "\\":
            esc = text[j + 1:j + 2]
            table = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0", " ": " "}
            if esc not in table:
                _fail(lineno, f"escape \\{esc}")
            out.append(table[esc])
            j += 2
            continue
        if quote == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    _fail(lineno, "a quoted string that does not end on its line")


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a space,
    outside quotes."""
    quote, skip = None, False
    for i, c in enumerate(line):
        if skip:
            skip = False
        elif quote:
            if c == "\\" and quote == '"':
                skip = True
            elif c == quote and quote == "'" and line[i + 1:i + 2] == "'":
                skip = True  # '' inside single quotes
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """A flow collection (``{...}``/``[...]``) on one line."""

    def __init__(self, text: str, lineno: int):
        self.text, self.i, self.lineno = text, 0, lineno

    def _ws(self):
        while self.i < len(self.text) and self.text[self.i] == " ":
            self.i += 1

    def parse(self):
        value = self._node()
        self._ws()
        if self.i != len(self.text):
            _fail(self.lineno, f"trailing text {self.text[self.i:]!r}")
        return value

    def _node(self):
        self._ws()
        c = self.text[self.i:self.i + 1]
        if c == "{":
            return self._collection("}", True)
        if c == "[":
            return self._collection("]", False)
        if c in ("'", '"'):
            value, self.i = _quoted(self.text, self.i, self.lineno)
            return value
        start = self.i
        while self.i < len(self.text) and self.text[self.i] not in ",]}":
            if self.text[self.i] == ":" and self.text[self.i + 1:self.i + 2] in (" ", ",", "]", "}", ""):
                break
            self.i += 1
        return _plain(self.text[start:self.i].strip(), self.lineno)

    def _collection(self, close: str, mapping: bool):
        self.i += 1
        out = {} if mapping else []
        while True:
            self._ws()
            if self.text[self.i:self.i + 1] == close:
                self.i += 1
                return out
            if self.i >= len(self.text):
                _fail(self.lineno, "a flow collection that does not end on its line")
            if mapping:
                key = self._node()
                self._ws()
                if self.text[self.i:self.i + 1] != ":":
                    _fail(self.lineno, f"flow mapping entry {key!r} without a value")
                self.i += 1
                out[key] = self._node()
            else:
                out.append(self._node())
            self._ws()
            if self.text[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.text[self.i:self.i + 1] != close:
                _fail(self.lineno, f"unexpected {self.text[self.i:]!r} in a flow collection")


def _scalar_or_flow(text: str, lineno: int):
    text = text.strip()
    if text[:1] in ("{", "["):
        return _Flow(text, lineno).parse()
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, 0, lineno)
        if text[end:].strip():
            _fail(lineno, f"text after a quoted scalar: {text[end:]!r}")
        return value
    return _plain(text, lineno)


def _split_key(text: str, lineno: int):
    """``key: rest`` -> (key, rest) or None when ``text`` is not a mapping entry."""
    if text[:1] in ("'", '"'):
        key, end = _quoted(text, 0, lineno)
        rest = text[end:].lstrip(" ")
        if rest[:1] != ":":
            return None
        return key, rest[1:].strip()
    if text[:1] in ("{", "["):
        return None
    m = re.match(r"([^:#]*?[^ ]|):( |$)", text)
    if m is None:
        return None
    return _plain(m.group(1), lineno), text[m.end():].strip()


class _Block:
    """The block structure: lines as (indent, text, line number)."""

    def __init__(self, lines):
        self.lines, self.pos = lines, 0

    def parse(self, indent: int):
        _, text, _ = self.lines[self.pos]
        if text.startswith("- ") or text == "-":
            return self._sequence(indent)
        return self._mapping(indent)

    def _value_after(self, rest: str, indent: int, lineno: int, sequence_ok: bool):
        """The value of an entry whose text after the indicator is ``rest``:
        inline, or the indented block on the following lines (a sequence may
        sit at the mapping key's own indent)."""
        if rest:
            return _scalar_or_flow(rest, lineno)
        if self.pos < len(self.lines):
            nxt_indent, nxt_text, _ = self.lines[self.pos]
            if nxt_indent > indent or (sequence_ok and nxt_indent == indent and nxt_text.startswith("-")):
                return self.parse(nxt_indent)
        return None

    def _mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.pos < len(self.lines):
            ind, text, lineno = self.lines[self.pos]
            if ind < indent:
                break
            if ind > indent:
                _fail(lineno, "unexpected indentation")
            kv = _split_key(text, lineno)
            if kv is None:
                _fail(lineno, f"expected a mapping entry, found {text!r}")
            key, rest = kv
            if key in out:
                _fail(lineno, f"duplicate key {key!r}")
            self.pos += 1
            out[key] = self._value_after(rest, indent, lineno, sequence_ok=True)
        return out

    def _sequence(self, indent: int) -> list:
        out: list = []
        while self.pos < len(self.lines):
            ind, text, lineno = self.lines[self.pos]
            if ind < indent or not (text.startswith("- ") or text == "-"):
                if ind > indent:
                    _fail(lineno, "unexpected indentation")
                break
            if ind > indent:
                _fail(lineno, "unexpected indentation")
            rest = text[1:].lstrip(" ")
            if not rest:
                self.pos += 1
                out.append(self._value_after("", indent, lineno, sequence_ok=False))
                continue
            # the item's text is a node of its own, indented past the dash:
            # re-read it in place as a line at that indent
            item_indent = ind + (len(text) - len(rest))
            if rest.startswith("- ") or rest == "-" or _split_key(rest, lineno) is not None:
                self.lines[self.pos] = (item_indent, rest, lineno)
                out.append(self.parse(item_indent))
            else:
                self.pos += 1
                out.append(_scalar_or_flow(rest, lineno))
        return out


def load_yaml(text: str):
    """The document in ``text`` as plain Python values (what
    ``yaml.safe_load`` gives for the subset); an empty document is None."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t") or "\t" in line[: len(line) - len(body)]:
            _fail(lineno, "a tab in the indentation")
        if line.startswith(("---", "...", "%")):
            _fail(lineno, "document markers and directives")
        lines.append((len(line) - len(body), body, lineno))
    if not lines:
        return None
    block = _Block(lines)
    if lines[0][0] != 0:
        _fail(lines[0][2], "a document that does not start at column 0")
    if len(lines) == 1 and _split_key(lines[0][1], lines[0][2]) is None and not lines[0][1].startswith("-"):
        return _scalar_or_flow(lines[0][1], lines[0][2])
    value = block.parse(0)
    if block.pos != len(lines):
        _fail(lines[block.pos][2], "unexpected text after the document")
    return value
