"""The subset of YAML that the port's configuration files use, in the
standard library (the card's machine has no PyYAML).

Block mappings and sequences (a sequence may sit at its key's indent,
and an item may open a mapping: "- key: value"), flow lists, which may
span lines, plain and quoted scalars resolved as PyYAML's safe loader
(YAML 1.1) resolves them, comments, and tags, each handed to the
caller's `tag` function with the node's kind ("scalar", "mapping" or
"sequence") and its value (the scalar's text for a scalar).  Anchors,
aliases, flow mappings, block scalars, multi-line plain or quoted
scalars, dates and directives are outside the subset: they raise
`errors.BadRequest` naming the line, as does anything malformed.
"""

from __future__ import annotations

import re

from ..errors import BadRequest

_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
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
_DATE = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


def strip_comment(line: str) -> str:
    """The line without its comment: a '#' at the start or after white
    space, outside quoted scalars (a quote opens one only where a token
    starts)."""
    quote, i = None, 0
    while i < len(line):
        ch = line[i]
        if quote == "'" and ch == "'" and line[i + 1: i + 2] == "'":
            i += 1                                  # '' inside single quotes
        elif quote == '"' and ch == "\\":
            i += 1                                  # an escape inside double quotes
        elif quote and ch == quote:
            quote = None
        elif not quote and ch in "'\"" and (i == 0 or line[i - 1] in " \t[,"):
            quote = ch
        elif not quote and ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _sexagesimal(text: str, conv):
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += conv(part) * base
        base *= 60
    return value


def resolve_scalar(text: str):
    """A plain scalar's value as PyYAML's safe loader resolves it: null,
    booleans (yes / no / on / off too), floats (which need their dot),
    binary / octal / decimal / hex / base-60 ints, else the string."""
    t = text.strip()
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t in _BOOL:
        return _BOOL[t]
    if t in ("=", "<<") or _DATE.match(t):
        raise BadRequest(f"the YAML scalar {t!r} is outside the supported subset")
    sign = -1 if t[0] == "-" else 1
    digits = t.replace("_", "").lstrip("+-")
    if _FLOAT.match(t):
        low = digits.lower()
        if low == ".inf":
            return sign * float("inf")
        if low == ".nan":
            return float("nan")
        return sign * (_sexagesimal(low, float) if ":" in low else float(low))
    if _INT.match(t):
        if digits == "0":
            return 0
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits[0] == "0":
            return sign * int(digits, 8)
        return sign * (_sexagesimal(digits, int) if ":" in digits else int(digits))
    return t


def _quoted(text: str, where: str) -> tuple[str, int]:
    """The quoted scalar at the start of text and the index after it."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1: i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            e = text[i + 1: i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX:
                n = _HEX[e]
                try:
                    out.append(chr(int(text[i + 2: i + 2 + n], 16)))
                except ValueError:
                    raise BadRequest(f"{where}: a bad escape in {text!r}") from None
                i += 2 + n
            else:
                raise BadRequest(f"{where}: a bad escape in {text!r}")
            continue
        out.append(ch)
        i += 1
    raise BadRequest(f"{where}: an unterminated quoted scalar (multi-line quoted scalars "
                     f"are outside the supported subset): {text!r}")


class _Parser:
    def __init__(self, text: str, tag, source: str):
        self.tag, self.source = tag, source
        self.lines = []                 # (line number, indent, text)
        for no, raw in enumerate(text.splitlines(), start=1):
            line = strip_comment(raw).rstrip()
            if not line.strip():
                continue
            body = line.lstrip(" ")
            if body.startswith("\t"):
                raise BadRequest(f"{self.at(no)}: a tab in the indentation")
            if not self.lines and body in ("---",):
                continue
            if body.startswith(("%", "---", "...")):
                raise BadRequest(f"{self.at(no)}: directives and further documents are "
                                 "outside the supported subset")
            self.lines.append([no, len(line) - len(body), body])

    def at(self, no: int) -> str:
        return f"{self.source}, line {no}"

    def scalar(self, text: str, no: int):
        try:
            return resolve_scalar(text)
        except BadRequest as e:
            raise BadRequest(f"{self.at(no)}: {e}") from None

    def node(self, kind: str, value, tag, no: int):
        if tag is None:
            return self.scalar(value, no) if kind == "plain" else value
        if self.tag is None:
            raise BadRequest(f"{self.at(no)}: tag {tag} is outside the supported subset")
        return self.tag(tag, "scalar" if kind in ("plain", "quoted") else kind, value,
                        self.at(no))

    # -- block structure ------------------------------------------------

    def block(self, i: int, indent: int):
        no, ind, text = self.lines[i]
        if text == "-" or text.startswith("- "):
            return self.sequence(i, ind)
        if self.split_key(text, no) is None:
            raise BadRequest(f"{self.at(no)}: expected 'key: value' or '- item', got "
                             f"{text!r} (multi-line plain scalars are outside the subset)")
        return self.mapping(i, ind)

    def split_key(self, text: str, no: int):
        """(key, rest) of a 'key: rest' line, or None."""
        if text[0] in "'\"":
            key, j = _quoted(text, self.at(no))
            rest = text[j:].lstrip(" ")
            if rest == ":" or rest.startswith(": "):
                return key, rest[1:].strip()
            return None
        m = re.search(r":(?: |$)", text)
        if m is None or text[0] in "[{!&*|>":
            return None
        return self.scalar(text[: m.start()], no), text[m.end():].strip()

    def mapping(self, i: int, indent: int):
        out = {}
        while i < len(self.lines) and self.lines[i][1] == indent:
            no, _, text = self.lines[i]
            kv = None if text == "-" or text.startswith("- ") else self.split_key(text, no)
            if kv is None:
                raise BadRequest(f"{self.at(no)}: expected 'key: value', got {text!r}")
            key, rest = kv
            out[key], i = self.value(rest, i + 1, indent, no, in_mapping=True)
        return ("mapping", out), self.check_dedent(i, indent)

    def sequence(self, i: int, indent: int):
        out = []
        while (i < len(self.lines) and self.lines[i][1] == indent
               and (self.lines[i][2] == "-" or self.lines[i][2].startswith("- "))):
            no, _, text = self.lines[i]
            rest = text[1:].lstrip(" ")
            if rest and (rest == "-" or rest.startswith("- ") or self.split_key(rest, no)):
                # "- key: value" or "- - item": the item's block starts on this line
                self.lines[i] = [no, indent + len(text) - len(rest), rest]
                (_, item), i = self.block(i, self.lines[i][1])
            else:
                item, i = self.value(rest, i + 1, indent, no)
            out.append(item)
        return ("sequence", out), self.check_dedent(i, indent)

    def check_dedent(self, i: int, indent: int) -> int:
        if i < len(self.lines) and self.lines[i][1] > indent:
            no, _, text = self.lines[i]
            raise BadRequest(f"{self.at(no)}: unexpected indentation: {text!r}")
        return i

    def value(self, rest: str, i: int, indent: int, no: int, in_mapping: bool = False):
        """The node after a key or a dash: (value, next line)."""
        tag = None
        if rest.startswith("!"):
            tag, _, rest = rest.partition(" ")
            rest = rest.strip()
        if not rest:
            nxt = self.lines[i] if i < len(self.lines) else None
            if nxt is not None and (nxt[1] > indent or (
                    in_mapping and nxt[1] == indent
                    and (nxt[2] == "-" or nxt[2].startswith("- ")))):
                (kind, val), i = self.block(i, nxt[1])
                return self.node(kind, val, tag, no), i
            return self.node("plain", "", tag, no), i
        if rest[0] == "[":
            while rest.count("[") > rest.count("]") and i < len(self.lines):
                rest += " " + self.lines[i][2]
                i += 1
            val, j = self.flow(rest, 0, no)
            if rest[j:].strip():
                raise BadRequest(f"{self.at(no)}: unexpected text after a flow list: "
                                 f"{rest[j:]!r}")
            return self.node("sequence", val, tag, no), i
        if rest[0] in "{&*|>%@`":
            raise BadRequest(f"{self.at(no)}: {rest!r} is outside the supported YAML subset "
                             "(flow mappings, anchors, aliases, block scalars)")
        if rest[0] in "'\"":
            val, j = _quoted(rest, self.at(no))
            if rest[j:].strip():
                raise BadRequest(f"{self.at(no)}: unexpected text after a quoted scalar: "
                                 f"{rest[j:]!r}")
            return self.node("quoted", val, tag, no), i
        if re.search(r":(?: |$)", rest):
            raise BadRequest(f"{self.at(no)}: a mapping value is not allowed here: {rest!r}")
        if i < len(self.lines) and self.lines[i][1] > indent:
            raise BadRequest(f"{self.at(self.lines[i][0])}: multi-line plain scalars are "
                             "outside the supported subset")
        return self.node("plain", rest, tag, no), i

    def flow(self, text: str, pos: int, no: int):
        """The flow list at text[pos] == '[': (list, index after it)."""
        items, pos = [], pos + 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text):
                raise BadRequest(f"{self.at(no)}: an unterminated flow list: {text!r}")
            if text[pos] == "]":
                return items, pos + 1
            tag = None
            if text[pos] == "!":
                end = pos
                while end < len(text) and text[end] not in " ,]":
                    end += 1
                tag, pos = text[pos:end], end
                while pos < len(text) and text[pos] == " ":
                    pos += 1
            if pos < len(text) and text[pos] == "[":
                val, pos = self.flow(text, pos, no)
                items.append(self.node("sequence", val, tag, no))
            elif pos < len(text) and text[pos] in "'\"":
                val, j = _quoted(text[pos:], self.at(no))
                items.append(self.node("quoted", val, tag, no))
                pos += j
            elif pos < len(text) and text[pos] in "{&*|>":
                raise BadRequest(f"{self.at(no)}: {text[pos:]!r} is outside the supported "
                                 "YAML subset")
            else:
                end = pos
                while end < len(text) and text[end] not in ",]":
                    end += 1
                items.append(self.node("plain", text[pos:end].strip(), tag, no))
                pos = end
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos < len(text) and text[pos] == ",":
                pos += 1
            elif pos < len(text) and text[pos] != "]":
                raise BadRequest(f"{self.at(no)}: expected ',' or ']' in {text!r}")


def load(text: str, tag=None, source: str = "<yaml>"):
    """The document's value.  tag(tag, kind, value, where) builds a tagged
    node; without it a tag raises.  An empty document is None."""
    p = _Parser(text, tag, source)
    if not p.lines:
        return None
    (_, value), i = p.block(0, p.lines[0][1])
    if i < len(p.lines):
        no, _, rest = p.lines[i]
        raise BadRequest(f"{p.at(no)}: unexpected text after the document: {rest!r}")
    return value
