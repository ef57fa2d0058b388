"""A reader of the flat YAML schema of ``configs/*.yaml``, without PyYAML.

The experiment configs and the fine-tuning hyper-parameters are one mapping
of ``key: value`` lines, each value a scalar or a flow list of scalars, with
``#`` comments. This reader returns what ``yaml.safe_load`` returns on such a
file (YAML 1.1's implicit types: ``null``/``~``, the booleans
``true``/``yes``/``on`` and their negations, decimal ints and floats with a
dot, ``.inf``, ``.nan``; anything else a string, so ``1e-5`` stays a string
as PyYAML leaves it). A file outside the schema (indented or nested blocks,
block lists, flow mappings, anchors, aliases, tags, block scalars, document
markers, duplicate keys, keys YAML reads as no string, tabs; octal, hex, binary and sexagesimal numbers)
raises ``ValueError`` naming the line.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*")
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# the other numbers YAML 1.1 resolves (octal, binary, hex, sexagesimal)
_OTHER_NUMBER = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r",
            "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _plain(text: str, lineno: int) -> Any:
    """A plain (unquoted) scalar resolved as ``yaml.safe_load`` resolves it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    m = _INF.fullmatch(text)
    if m:
        return float("-inf") if m.group(1) == "-" else float("inf")
    if _NAN.fullmatch(text):
        return float("nan")
    if _OTHER_NUMBER.fullmatch(text):
        raise ValueError(f"line {lineno}: the number {text!r} is outside the flat schema")
    if text[0] in "&*!|>%@`{}[]',\"?" or text in ("-", ":") or text.startswith(("- ", ": ")) \
            or ": " in text or text.endswith(":") or " #" in text:
        raise ValueError(f"line {lineno}: {text!r} is outside the flat schema")
    return text


def _quoted(text: str, pos: int, lineno: int) -> tuple[str, int]:
    """The quoted scalar starting at ``text[pos]`` and the index after it."""
    quote = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            nxt = text[i + 1:i + 2]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                i += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(nxt)
            digits = text[i + 2:i + 2 + width] if width else ""
            if not width or len(digits) != width or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                raise ValueError(f"line {lineno}: bad escape in a double-quoted string")
            out.append(chr(int(digits, 16)))
            i += 2 + width
            continue
        out.append(c)
        i += 1
    raise ValueError(f"line {lineno}: unterminated quoted string (multi-line strings are outside the flat schema)")


def _comment_or_end(text: str, pos: int, lineno: int) -> None:
    """Nothing but a comment (``#`` after whitespace) may follow a quoted
    scalar or a flow list."""
    rest = text[pos:]
    if rest.strip() and not re.match(r"\s+#", rest):
        raise ValueError(f"line {lineno}: unexpected {rest.strip()!r} after a value")


def _strip_comment(text: str) -> str:
    """A plain scalar's text without its trailing comment (``#`` after
    whitespace)."""
    m = re.search(r"\s#", text)
    return (text[:m.start()] if m else text).strip()


def _flow_list(text: str, lineno: int) -> tuple[list, int]:
    """The flow list starting at ``text[0] == "["`` and the index after it."""
    items: list = []
    i = 1
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise ValueError(f"line {lineno}: unterminated flow list (multi-line lists are outside the flat schema)")
        if text[i] == "]" and not items:
            return items, i + 1
        if text[i] in "'\"":
            value, i = _quoted(text, i, lineno)
        elif text[i] in "[{":
            raise ValueError(f"line {lineno}: nested collections are outside the flat schema")
        else:
            j = i
            while j < len(text) and text[j] not in ",]":
                j += 1
            raw = text[i:j].strip()
            if not raw:
                raise ValueError(f"line {lineno}: an empty item in a flow list")
            value, i = _plain(raw, lineno), j
        items.append(value)
        while i < len(text) and text[i] == " ":
            i += 1
        if i < len(text) and text[i] == ",":
            i += 1
            continue
        if i < len(text) and text[i] == "]":
            return items, i + 1
        raise ValueError(f"line {lineno}: expected ',' or ']' in a flow list")


def _value(text: str, lineno: int) -> Any:
    if not text or text.startswith("#"):
        return None
    if text[0] in "'\"":
        value, end = _quoted(text, 0, lineno)
        _comment_or_end(text, end, lineno)
        return value
    if text[0] == "[":
        value, end = _flow_list(text, lineno)
        _comment_or_end(text, end, lineno)
        return value
    return _plain(_strip_comment(text), lineno)


def loads(text: str) -> dict[str, Any] | None:
    """The mapping of a flat-schema YAML document (``None`` for a document
    with no key, as ``yaml.safe_load`` returns)."""
    out: dict[str, Any] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        if "\t" in line:
            raise ValueError(f"line {lineno}: tabs are outside the flat schema")
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if line[0] == " ":
            raise ValueError(f"line {lineno}: indented or nested blocks are outside the flat schema")
        key, sep, rest = line.partition(":")
        if not sep or not _KEY.fullmatch(key) or (rest and not rest[0].isspace()):
            raise ValueError(f"line {lineno}: {stripped!r} is not a 'key: value' line")
        if not isinstance(_plain(key, lineno), str):  # PyYAML would read `on`, `null`, ... as no string
            raise ValueError(f"line {lineno}: the key {key!r} is not a string in YAML 1.1")
        if key in out:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        out[key] = _value(rest.strip(), lineno)
    return out or None


def load(path: str | Path) -> dict[str, Any] | None:
    """`loads` of the file at ``path``."""
    return loads(Path(path).read_text())
