"""A reader and a writer for the subset of YAML that the experiment configs
use, in the standard library alone (the card's machine has no PyYAML).

:func:`loads` reads what ``configs/default.yaml`` and the JAX package's
``save_yaml`` (``yaml.safe_dump(..., sort_keys=False)``) write, and gives
what ``yaml.safe_load`` gives for it:

* block mappings nested by indentation, and block sequences of scalars,
  also at their key's own indentation (``save_yaml`` writes a list as
  ``- 4`` lines under its key);
* flow sequences of scalars on one line (``[1, 2, 4, 8]``) and the empty
  flow mapping ``{}``;
* plain, single-quoted and double-quoted scalars on one line, and comments;
* plain scalars resolved as PyYAML's YAML 1.1 resolver does: ``~``,
  ``null`` and an empty value are None; ``yes``/``no``/``on``/``off``/
  ``true``/``false`` in PyYAML's three spellings are booleans; a float
  needs a dot (``1.0e-4`` is a float, ``1e-4`` and ``1.0e4`` are strings);
  ints may be binary, octal (a leading 0), hexadecimal or base 60.

Everything else raises :class:`YAMLSubsetError` with its line number, and
is never read as something else: anchors, aliases, tags, block scalars,
multi-line scalars, more than one document, directives, complex keys, merge
keys, nested collections inside a sequence, non-empty flow mappings and
timestamps (which PyYAML turns into dates).

:func:`dumps` writes a tree of dicts, lists and tuples of scalars in the
same layout as ``yaml.safe_dump(..., sort_keys=False)``, with floats
written as PyYAML writes them (``1.0e-06``: with a dot, so that a YAML 1.1
reader reads a float back) and every string that would read back as
something else quoted, so that both :func:`loads` and ``yaml.safe_load``
give the tree back.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YAMLSubsetError", "loads", "dumps"]


class YAMLSubsetError(ValueError):
    """A YAML construct outside the subset, or malformed YAML."""

    def __init__(self, line: Optional[int], what: str):
        super().__init__(f"line {line}: {what}" if line else what)
        self.line = line


# PyYAML's implicit resolvers (yaml/resolver.py), in its order of trial
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# the first character each resolver is tried for (PyYAML's ``first``)
_FIRST = (("bool", _BOOL, "yYnNtTfFoO"), ("float", _FLOAT, "-+0123456789."),
          ("int", _INT, "-+0123456789"), ("merge", re.compile(r"^<<$"), "<"),
          ("null", _NULL, "~nN"), ("timestamp", _TIMESTAMP, "0123456789"),
          ("value", re.compile(r"^=$"), "="))
# characters that cannot start a plain scalar (``-``, ``?``, ``:`` can when
# a non-space follows)
_NOT_PLAIN_START = set(",[]{}#&*!|>'\"%@`")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _base60(value)
    return sign * int(value)


def _base60(value: str):
    total = 0
    for part in value.split(":"):
        total = total * 60 + (float(part) if "." in part else int(part))
    return total


def _float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * float(_base60(value))
    return sign * float(value)


def resolve_plain(text: str, line: Optional[int] = None) -> Any:
    """A plain scalar's value, as PyYAML's safe loader resolves it."""
    first = text[:1]
    for kind, pattern, starts in _FIRST:
        if (first in starts or (kind == "null" and not text)) and pattern.match(text):
            if kind == "bool":
                return text.lower() in ("yes", "true", "on")
            if kind == "float":
                return _float(text)
            if kind == "int":
                return _int(text)
            if kind == "null":
                return None
            raise YAMLSubsetError(line, f"{text!r} resolves to a YAML {kind}, "
                                        "which is outside the subset; quote it")
    return text


def _single_quoted(s: str, start: int, line: int) -> Tuple[str, int]:
    """The single-quoted scalar at ``s[start]`` (``''`` an escaped quote),
    and the index after its closing quote."""
    out, i = [], start + 1
    while i < len(s):
        if s[i] == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(s[i])
        i += 1
    raise YAMLSubsetError(line, "a single-quoted scalar that does not end on its "
                                "line (multi-line scalars are outside the subset)")


def _double_quoted(s: str, start: int, line: int) -> Tuple[str, int]:
    """The double-quoted scalar at ``s[start]`` and the index after it."""
    out, i = [], start + 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[i + 2:i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9A-Fa-f]+", digits):
                    raise YAMLSubsetError(line, f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise YAMLSubsetError(line, f"escape \\{e} is outside the subset "
                                        "(a line break inside a scalar, or unknown)")
        out.append(c)
        i += 1
    raise YAMLSubsetError(line, "a double-quoted scalar that does not end on its "
                                "line (multi-line scalars are outside the subset)")


def _quoted(s: str, start: int, line: int) -> Tuple[str, int]:
    return (_single_quoted if s[start] == "'" else _double_quoted)(s, start, line)


def _rest_is_comment(s: str, i: int, line: int, what: str) -> None:
    rest = s[i:]
    if rest.strip() and not re.match(r"[ \t]+#", rest):
        raise YAMLSubsetError(line, f"unexpected text after {what}: {rest.strip()!r}")


def _plain(text: str, line: int, flow: bool = False) -> Any:
    """A plain scalar (comment already cut), checked and resolved."""
    c = text[:1]
    if c in _NOT_PLAIN_START or (c in "-?:" and text[1:2] in ("", " ")):
        raise YAMLSubsetError(line, f"{text!r}: a value starting with {c!r} "
                                    "(an anchor, alias, tag, block scalar, nested "
                                    "collection or reserved indicator) is outside "
                                    "the subset")
    if ": " in text or text.endswith(":") or (flow and (":" in text or "#" in text)):
        raise YAMLSubsetError(line, f"{text!r}: a mapping inside a value is "
                                    "outside the subset")
    return resolve_plain(text, line)


def _cut_comment(text: str) -> str:
    """A plain scalar's text up to a comment (``#`` after a space)."""
    m = re.search(r"[ \t]#", text)
    return (text[:m.start()] if m else text).rstrip(" \t")


def _flow_sequence(s: str, line: int) -> List[Any]:
    """``[a, b, ...]`` of scalars, the whole of ``s`` (after the comment,
    which :func:`_inline` leaves on)."""
    items: List[Any] = []
    i = 1
    expect_item = True
    while True:
        while i < len(s) and s[i] in " \t":
            i += 1
        if i >= len(s):
            raise YAMLSubsetError(line, "a flow sequence that does not end on its "
                                        "line is outside the subset")
        c = s[i]
        if c == "]":
            if expect_item and items:
                raise YAMLSubsetError(line, "an empty entry in a flow sequence")
            _rest_is_comment(s, i + 1, line, "a flow sequence")
            return items
        if not expect_item:
            if c != ",":
                raise YAMLSubsetError(line, f"expected ',' or ']' in a flow "
                                            f"sequence, found {c!r}")
            i += 1
            expect_item = True
            continue
        if c in "[{":
            raise YAMLSubsetError(line, "a nested flow collection is outside "
                                        "the subset")
        if c in "'\"":
            value, i = _quoted(s, i, line)
            items.append(value)
        else:
            j = i
            while j < len(s) and s[j] not in ",]":
                j += 1
            text = s[i:j].rstrip(" \t")
            if not text:
                raise YAMLSubsetError(line, "an empty entry in a flow sequence")
            items.append(_plain(text, line, flow=True))
            i = j
        expect_item = False


def _inline(text: str, line: int) -> Tuple[bool, Any]:
    """(present, value) of the text after ``key:`` or ``-``: (False, None)
    when only a comment or nothing follows."""
    s = text.lstrip(" \t")
    if not s or s.startswith("#"):
        return False, None
    c = s[0]
    if c in "'\"":
        value, i = _quoted(s, 0, line)
        _rest_is_comment(s, i, line, "a quoted scalar")
        return True, value
    if c == "[":
        return True, _flow_sequence(s, line)
    if c == "{":
        m = re.match(r"\{[ \t]*\}", s)
        if not m:
            raise YAMLSubsetError(line, "a non-empty flow mapping is outside the "
                                        "subset")
        _rest_is_comment(s, m.end(), line, "a flow mapping")
        return True, {}
    return True, _plain(_cut_comment(s), line)


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text

    @property
    def is_item(self) -> bool:
        return self.text == "-" or self.text.startswith(("- ", "-\t"))

    def key(self) -> Optional[Tuple[Any, str]]:
        """(key, the text after its colon) when the line is a mapping entry."""
        s = self.text
        if s[0] in "'\"":
            key, i = _quoted(s, 0, self.no)
            m = re.match(r"[ \t]*:(?=[ \t]|$)", s[i:])
            return (key, s[i + m.end():]) if m else None
        m = re.search(r":(?=[ \t]|$)", s)
        if not m:
            return None
        comment = re.search(r"[ \t]#", s)
        if comment and comment.start() < m.start():
            return None
        key_text = s[:m.start()].rstrip(" \t")
        if key_text.startswith(("?", "<<")) or key_text[:1] in _NOT_PLAIN_START:
            raise YAMLSubsetError(self.no, f"key {key_text!r} is outside the subset "
                                           "(complex, merge, anchored or tagged keys)")
        return _plain(key_text, self.no), s[m.end():]


# YAML's line breaks (PyYAML's reader); str.splitlines would also split at
# form feeds and other separators, which YAML keeps inside a line
_LINE_BREAK = re.compile("\r\n|[\r\n\x85\u2028\u2029]")


def _lines(text: str) -> List[_Line]:
    out: List[_Line] = []
    started = False
    for no, raw in enumerate(_LINE_BREAK.split(text), 1):
        body = raw.rstrip(" \t")
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith("\t"):
            raise YAMLSubsetError(no, "a tab in the indentation")
        indent = len(body) - len(stripped)
        if indent == 0 and stripped.startswith("%"):
            raise YAMLSubsetError(no, "directives are outside the subset")
        if indent == 0 and re.match(r"(---|\.\.\.)(?=[ \t]|$)", stripped):
            marker_rest = stripped[3:].strip()
            if stripped.startswith("---") and not started and (
                    not marker_rest or marker_rest.startswith("#")):
                started = True      # one explicit document start
                continue
            raise YAMLSubsetError(no, "a document marker: more than one document, "
                                      "or content after ---, is outside the subset")
        started = True
        out.append(_Line(no, indent, stripped))
    return out


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        line = self.peek()
        if line.is_item:
            return self.sequence(line.indent)
        if line.key() is not None:
            return self.mapping(line.indent)
        if indent >= 0:
            raise YAMLSubsetError(line.no, "a value on the line after its key (a "
                                           "multi-line scalar) is outside the subset")
        present, value = _inline(line.text, line.no)
        self.i += 1
        if self.peek() is not None:
            raise YAMLSubsetError(self.peek().no, "text after a top-level scalar")
        return value

    def child(self, parent: _Line) -> Any:
        """The block value of a key or item whose inline value is empty."""
        nxt = self.peek()
        if nxt is None or nxt.indent < parent.indent:
            return None
        if nxt.indent > parent.indent:
            return self.block(parent.indent)
        if nxt.is_item and not parent.is_item:
            return self.sequence(nxt.indent)   # a sequence at its key's indentation
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise YAMLSubsetError(line.no, "bad indentation (or a multi-line "
                                               "scalar, outside the subset)")
            entry = line.key()
            if entry is None:
                raise YAMLSubsetError(line.no, f"expected 'key: value', found "
                                               f"{line.text!r}")
            key, rest = entry
            try:
                hash(key)
            except TypeError:
                raise YAMLSubsetError(line.no, "an unhashable key") from None
            self.i += 1
            present, value = _inline(rest, line.no)
            if not present:
                value = self.child(line)
            else:
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise YAMLSubsetError(nxt.no, "a continuation line (a multi-line "
                                                  "scalar) is outside the subset")
            out[key] = value

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent or not (
                    line.indent == indent and line.is_item):
                if line is not None and line.indent > indent:
                    raise YAMLSubsetError(line.no, "bad indentation in a sequence")
                return out
            self.i += 1
            text = line.text[1:]
            present, value = _inline(text, line.no)
            if not present:
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise YAMLSubsetError(nxt.no, "a collection inside a block "
                                                  "sequence is outside the subset")
            elif isinstance(value, (list, dict)) and value:
                raise YAMLSubsetError(line.no, "a collection inside a block "
                                               "sequence is outside the subset")
            else:
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise YAMLSubsetError(nxt.no, "a continuation line (a multi-line "
                                                  "scalar) is outside the subset")
            out.append(value)


def loads(text: str) -> Any:
    """The YAML document ``text`` (of the subset) as Python values: what
    ``yaml.safe_load`` gives, lists for sequences; None for an empty
    document."""
    lines = _lines(text)
    if not lines:
        return None
    if lines[0].indent != 0:
        raise YAMLSubsetError(lines[0].no, "the document's first line is indented")
    parser = _Parser(lines)
    value = parser.block(-1)
    if parser.peek() is not None:
        raise YAMLSubsetError(parser.peek().no, "bad indentation")
    return value


def _float_text(v: float) -> str:
    """PyYAML's ``represent_float``."""
    if v != v:
        return ".nan"
    if v == math.inf:
        return ".inf"
    if v == -math.inf:
        return "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


_SAFE_PLAIN = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./+-]*")


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, str):
        if _SAFE_PLAIN.fullmatch(v) and resolve_plain_or_none(v) == v:
            return v
        if v.isprintable():
            return "'" + v.replace("'", "''") + "'"
        return '"' + "".join(_escaped(c) for c in v) + '"'
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as a YAML scalar")


def _escaped(c: str) -> str:
    """One character of a double-quoted scalar."""
    if c in '"\\':
        return "\\" + c
    if c.isprintable():
        return c
    n = ord(c)
    return f"\\x{n:02X}" if n < 0x100 else f"\\u{n:04X}" if n < 0x10000 else f"\\U{n:08X}"


def resolve_plain_or_none(text: str) -> Any:
    """:func:`resolve_plain`, with None (not a string) for text that
    resolves to a type outside the subset."""
    try:
        return resolve_plain(text)
    except YAMLSubsetError:
        return None


def _dump(value: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    for key, v in value.items():
        k = _scalar_text(key)
        if isinstance(v, dict):
            if v:
                out.append(f"{pad}{k}:")
                _dump(v, indent + 2, out)
            else:
                out.append(f"{pad}{k}: {{}}")
        elif isinstance(v, (list, tuple)):
            if not v:
                out.append(f"{pad}{k}: []")
                continue
            out.append(f"{pad}{k}:")
            for item in v:
                if isinstance(item, (dict, list, tuple)):
                    raise TypeError("a collection inside a sequence is outside "
                                    "the subset")
                out.append(f"{pad}- {_scalar_text(item)}")
        else:
            out.append(f"{pad}{k}: {_scalar_text(v)}")


def dumps(tree: dict) -> str:
    """A mapping of scalars, mappings and sequences of scalars as YAML, in
    ``yaml.safe_dump(tree, sort_keys=False)``'s layout."""
    if not isinstance(tree, dict):
        raise TypeError("the document must be a mapping")
    if not tree:
        return "{}\n"
    out: List[str] = []
    _dump(tree, 0, out)
    return "\n".join(out) + "\n"
