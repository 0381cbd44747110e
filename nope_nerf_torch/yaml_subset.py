"""The YAML the configs are written in, read and written without PyYAML.

`loads` reads the subset of YAML that configs/** and the port's own writers
use: block mappings nested by indentation, block sequences, flow mappings and
flow sequences (nested, spanning lines, JSON with quoted keys among them),
plain, single-quoted and double-quoted (JSON's escapes) scalars, `#`
comments and the empty document (None); the top node is a mapping. Plain
scalars resolve as `yaml.safe_load` (YAML 1.1) resolves them: PyYAML's null,
bool, int (decimal, octal, hex) and float patterns, everything else a string.
What no config and no writer of the port holds raises ValueError naming the
file and the line: anchors, aliases, tags, block scalars (`|`, `>`),
multi-line plain or quoted scalars, explicit keys, pairs inside flow
sequences, timestamps, binary and sexagesimal numbers, merge keys, escapes
past JSON's, a byte-order mark, and more than one document.

`dumps` writes block YAML that both `loads` and `yaml.safe_load` read back to
the same value: dicts as block mappings, lists as block sequences (indentless
under a key, as PyYAML writes them), empty ones in flow form, and every string
that would resolve to another type, or that is not a safe plain scalar,
single-quoted. A string with a character that is not printable is refused.
"""

from __future__ import annotations

import math
import numbers
import re
from typing import Any, List, Optional, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), tried in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^(?:[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# what PyYAML resolves to a timestamp, a binary or a sexagesimal number (refused)
_REFUSED_PLAIN = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt \t].*)?
                    |[-+]?0b[0-1_]+
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$""", re.X)

# JSON's double-quoted escapes but \uXXXX, which _Reader.quoted reads
_ESCAPES = {"b": "\x08", "t": "\t", "n": "\n", "f": "\x0c", "r": "\r", '"': '"',
            "\\": "\\", "/": "/"}

_FLOW_IND = ",[]{}"
_WS = " \t"
_REFUSED = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars (|)",
            ">": "block scalars (>)", "%": "directives", "@": "reserved indicators (@)",
            "`": "reserved indicators (`)", "?": "explicit keys (?)"}


def _resolve_plain(text: str) -> Any:
    """A plain scalar's value as `yaml.safe_load` gives it; raises ValueError
    for the types this reader does not take (timestamps, binary and
    sexagesimal numbers, `<<`, `=`)."""
    if text[0] in "-+0123456789" and _REFUSED_PLAIN.match(text):
        raise ValueError(f"{text!r} (a timestamp, binary or sexagesimal number)")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if text[0] in "-+0123456789." and _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        return sign * float(value)
    if text[0] in "-+0123456789" and _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * int(value)
    if text in ("<<", "="):
        raise ValueError(f"the {text!r} scalar (merge key / value tag)")
    return text


class _Reader:
    """Recursive descent over the document's lines. Block structure follows
    the lines' indentation; a flow collection's text may span lines."""

    def __init__(self, text: str, path: str):
        self.path = path
        self.lines = [ln[:-1] if ln.endswith("\r") else ln for ln in text.split("\n")]
        if text.startswith("\ufeff"):
            self.fail(0, "a byte-order mark")

    def fail(self, ln: int, what: str):
        raise ValueError(f"{self.path}:{ln + 1}: {what} (not in the YAML subset the "
                         "configs are read in)")

    # -- lines ------------------------------------------------------------
    def indent(self, ln: int) -> int:
        line = self.lines[ln]
        n = len(line) - len(line.lstrip(" "))
        if line[n:n + 1] == "\t":
            self.fail(ln, "a tab in the indentation")
        return n

    def is_content(self, ln: int) -> bool:
        body = self.lines[ln].strip(" \t")
        return bool(body) and not body.startswith("#")

    def next_content(self, ln: int) -> Optional[int]:
        while ln < len(self.lines) and not self.is_content(ln):
            ln += 1
        return ln if ln < len(self.lines) else None

    def rest_is_empty(self, ln: int, col: int) -> bool:
        """Only spaces and a comment from col to the end of the line."""
        body = self.lines[ln][col:].lstrip(_WS)
        return not body or body.startswith("#")

    def skip_ws(self, ln: int, col: int) -> int:
        line = self.lines[ln]
        while col < len(line) and line[col] in _WS:
            col += 1
        return col

    # -- document ---------------------------------------------------------
    def document(self) -> Any:
        ln = self.next_content(0)
        if ln is not None and self.lines[ln].rstrip(_WS) == "---":
            ln = self.next_content(ln + 1)
        for i in range(ln or 0, len(self.lines)):
            line = self.lines[i]
            if line.startswith("%"):
                self.fail(i, "directives")
            if line[:3] in ("---", "...") and line[3:4] in ("", " ", "\t"):
                self.fail(i, "document markers (more than one document)")
        if ln is None:
            return None
        top = ln
        value, ln = self.node(ln, self.indent(ln), -1)
        if ln is not None:
            self.fail(ln, "content after the document's top node")
        if not isinstance(value, dict):
            self.fail(top, "a document whose top node is not a mapping")
        return value

    def node(self, ln: int, col: int, parent: int) -> Tuple[Any, Optional[int]]:
        """The node starting at (ln, col), whose lines are indented more than
        `parent`; returns it and the next content line after it."""
        text = self.lines[ln][col:]
        if text == "-" or text.startswith("- ") or text.startswith("-\t"):
            return self.block_seq(ln, col)
        if self.map_key(ln, col, probe=True) is not None:
            return self.block_map(ln, col)
        return self.inline(ln, col, parent)

    def block_seq(self, ln: int, col: int) -> Tuple[list, Optional[int]]:
        items: List[Any] = []
        first = True
        while ln is not None and (first or self.indent(ln) == col):
            text = self.lines[ln][col:]
            if not (text == "-" or text[:2] in ("- ", "-\t")):
                break
            first = False
            c2 = self.skip_ws(ln, col + 1)
            if self.rest_is_empty(ln, c2):
                nxt = self.next_content(ln + 1)
                if nxt is not None and self.indent(nxt) > col:
                    value, ln = self.node(nxt, self.indent(nxt), col)
                else:
                    value, ln = None, nxt
            else:
                value, ln = self.node(ln, c2, col)
            items.append(value)
        if ln is not None and self.indent(ln) > col:
            self.fail(ln, "an indentation that fits no block")
        return items, ln

    def block_map(self, ln: int, col: int) -> Tuple[dict, Optional[int]]:
        out: dict = {}
        first = True
        while ln is not None and (first or self.indent(ln) == col):
            key_col = col if first else self.indent(ln)
            first = False
            found = self.map_key(ln, key_col)
            if found is None:
                if self.lines[ln][key_col:key_col + 1] == "-":
                    self.fail(ln, "a sequence entry where a mapping key belongs")
                self.fail(ln, "a line that is not a 'key: value' pair")
            key, c2 = found
            c2 = self.skip_ws(ln, c2)
            if self.rest_is_empty(ln, c2):
                nxt = self.next_content(ln + 1)
                if nxt is not None and self.indent(nxt) > col:
                    value, ln = self.node(nxt, self.indent(nxt), col)
                elif (nxt is not None and self.indent(nxt) == col
                      and self.lines[nxt][col:col + 2] in ("- ", "-\t", "-")):
                    value, ln = self.block_seq(nxt, col)       # indentless sequence
                else:
                    value, ln = None, nxt
            else:
                value, ln = self.inline(ln, c2, col)
            out[key] = value
        if ln is not None and self.indent(ln) > col:
            self.fail(ln, "an indentation that fits no block")
        return out, ln

    def map_key(self, ln: int, col: int, probe: bool = False):
        """(key, column after its ':') when (ln, col) starts an implicit
        block-mapping key, else None."""
        line = self.lines[ln]
        ch = line[col:col + 1]
        if ch in ("'", '"'):
            key, end = self.quoted(ln, col)
            end = self.skip_ws(ln, end)
            if line[end:end + 1] == ":" and line[end + 1:end + 2] in ("", " ", "\t"):
                return key, end + 1
            return None
        if ch in ("[", "{"):
            return None
        if ch == "?" and line[col + 1:col + 2] in ("", " ", "\t"):
            self.fail(ln, "explicit keys (?)")
        i = col
        while i < len(line):
            c = line[i]
            if c == "#" and i > col and line[i - 1] in _WS:
                return None
            if c == ":" and line[i + 1:i + 2] in ("", " ", "\t"):
                text = line[col:i].rstrip(_WS)
                if not text:
                    self.fail(ln, "an empty mapping key")
                if probe:
                    return text, i + 1
                self.check_plain_start(ln, text)
                try:
                    return _resolve_plain(text), i + 1
                except ValueError as e:
                    self.fail(ln, str(e))
            i += 1
        return None

    def check_plain_start(self, ln: int, text: str) -> None:
        ch = text[0]
        if ch in _REFUSED and not (ch == "?" and text[1:2] not in ("", " ", "\t")):
            self.fail(ln, _REFUSED[ch])
        if ch in "-:" and text[1:2] in ("", " ", "\t"):
            self.fail(ln, f"a plain scalar starting with {ch!r} and a space")
        if ch in "#" + _FLOW_IND:
            self.fail(ln, f"a plain scalar starting with {ch!r}")

    def inline(self, ln: int, col: int, parent: int) -> Tuple[Any, Optional[int]]:
        """A value that starts on its line at col: a flow collection, a quoted
        scalar or a plain scalar; nothing may follow it but a comment."""
        line = self.lines[ln]
        ch = line[col:col + 1]
        if ch in ("[", "{"):
            flow = _Flow(self, ln, col)
            value = flow.node()
            ln, end = flow.ln, flow.col
        elif ch in ("'", '"'):
            value, end = self.quoted(ln, col)
        else:
            end = len(line)
            for i in range(col + 1, len(line)):
                if line[i] == "#" and line[i - 1] in _WS:
                    end = i
                    break
            text = line[col:end].rstrip(_WS)
            self.check_plain_start(ln, text)
            if ": " in text or ":\t" in text or text.endswith(":"):
                self.fail(ln, "a mapping value inside a plain scalar")
            try:
                value = _resolve_plain(text)
            except ValueError as e:
                self.fail(ln, str(e))
            nxt = self.next_content(ln + 1)
            if nxt is not None and self.indent(nxt) > parent:
                self.fail(nxt, "a multi-line plain scalar")
            return value, nxt
        if not self.rest_is_empty(ln, end):
            self.fail(ln, "text after a complete value")
        nxt = self.next_content(ln + 1)
        if nxt is not None and self.indent(nxt) > parent >= 0:
            self.fail(nxt, "an indentation that fits no block")
        return value, nxt

    def quoted(self, ln: int, col: int) -> Tuple[str, int]:
        """A single- or double-quoted scalar on one line: (its text, the column
        after the closing quote)."""
        line = self.lines[ln]
        q = line[col]
        out = []
        i = col + 1
        while i < len(line):
            c = line[i]
            if q == "'":
                if c == "'":
                    if line[i + 1:i + 2] == "'":
                        out.append("'")
                        i += 2
                        continue
                    return "".join(out), i + 1
                out.append(c)
                i += 1
                continue
            if c == '"':
                return "".join(out), i + 1
            if c == "\\":
                e = line[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                digits = line[i + 2:i + 6]
                if e == "u" and re.fullmatch(r"[0-9a-fA-F]{4}", digits):
                    out.append(chr(int(digits, 16)))
                    i += 6
                    continue
                self.fail(ln, "a line break or an escape past JSON's in a double-quoted "
                              "scalar")
            out.append(c)
            i += 1
        self.fail(ln, "a quoted scalar that spans lines")


class _Flow:
    """A flow collection read character by character; line breaks are spaces
    between its tokens, `#` after a space starts a comment."""

    def __init__(self, reader: _Reader, ln: int, col: int):
        self.r, self.ln, self.col = reader, ln, col

    def peek(self) -> str:
        line = self.r.lines[self.ln]
        return line[self.col] if self.col < len(line) else "\n"

    def skip(self) -> None:
        """Past spaces, line breaks and comments."""
        while True:
            line = self.r.lines[self.ln]
            while self.col < len(line) and line[self.col] in _WS:
                self.col += 1
            if self.col < len(line) and line[self.col] != "#":
                return
            if self.ln + 1 >= len(self.r.lines):
                self.r.fail(self.ln, "a flow collection that is never closed")
            self.ln, self.col = self.ln + 1, 0

    def node(self) -> Any:
        self.skip()
        ch = self.peek()
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.map()
        if ch in ("'", '"'):
            value, self.col = self.r.quoted(self.ln, self.col)
            return value
        return self.plain()

    def plain(self) -> Any:
        line = self.r.lines[self.ln]
        start = i = self.col
        if line[i] in _REFUSED:
            self.r.fail(self.ln, _REFUSED[line[i]])
        if line[i] in "-" and line[i + 1:i + 2] in ("", " ", "\t"):
            self.r.fail(self.ln, "a block sequence entry inside a flow collection")
        while i < len(line):
            c = line[i]
            if c in _FLOW_IND:
                break
            if c == ":" and (i + 1 >= len(line) or line[i + 1] in _WS + _FLOW_IND):
                break
            if c in _WS:
                j = i
                while j < len(line) and line[j] in _WS:
                    j += 1
                if j >= len(line) or line[j] == "#" or line[j] in _FLOW_IND or (
                        line[j] == ":" and (j + 1 >= len(line)
                                            or line[j + 1] in _WS + _FLOW_IND)):
                    break
                i = j
                continue
            i += 1
        text = line[start:i].rstrip(_WS)
        self.col = i
        if i >= len(line.rstrip(_WS)) and text:
            # a line break inside a plain scalar folds it over two lines
            save = (self.ln, self.col)
            self.skip()
            if self.peek() not in _FLOW_IND + ":":
                self.r.fail(self.ln, "a multi-line plain scalar")
            self.ln, self.col = save
        if not text:
            if self.peek() != ":":
                self.r.fail(self.ln, "an empty entry in a flow collection")
            return None
        try:
            return _resolve_plain(text)
        except ValueError as e:
            self.r.fail(self.ln, str(e))

    def seq(self) -> list:
        self.col += 1
        items: List[Any] = []
        while True:
            self.skip()
            if self.peek() == "]":
                self.col += 1
                return items
            items.append(self.node())
            self.skip()
            if self.peek() == ":":
                self.r.fail(self.ln, "a 'key: value' pair inside a flow sequence")
            if self.peek() == ",":
                self.col += 1
            elif self.peek() != "]":
                self.r.fail(self.ln, "a flow sequence entry not followed by ',' or ']'")

    def map(self) -> dict:
        self.col += 1
        out: dict = {}
        while True:
            self.skip()
            if self.peek() == "}":
                self.col += 1
                return out
            key = None if self.peek() == ":" else self.key(self.node())
            self.skip()
            value = None
            if self.peek() == ":":
                self.col += 1
                self.skip()
                if self.peek() not in ",}":
                    value = self.node()
                self.skip()
            out[key] = value
            if self.peek() == ",":
                self.col += 1
            elif self.peek() != "}":
                self.r.fail(self.ln, "a flow mapping entry not followed by ',' or '}'")

    def key(self, value: Any) -> Any:
        if isinstance(value, (list, dict)):
            self.r.fail(self.ln, "a collection as a mapping key")
        return value


def loads(text: str, path: str = "<string>") -> Any:
    """The YAML document in `text` (read from `path`, named in errors)."""
    return _Reader(text, path).document()


# -- writing ------------------------------------------------------------------

def _plain_ok(s: str) -> bool:
    """s can be written plain: printable ASCII, no indicator that could end
    or start something else, and it resolves back to the same string."""
    if not s or s != s.strip(" ") or not all(0x20 <= ord(c) <= 0x7e for c in s):
        return False
    if s[0] in "-?:,[]{}#&*!|>'\"%@`" or any(c in s for c in "#,[]{}'\"") or ":" in s:
        return False
    try:
        return _resolve_plain(s) == s and isinstance(_resolve_plain(s), str)
    except ValueError:
        return False


def _scalar(value: Any) -> str:
    """One scalar as `loads` and `yaml.safe_load` read it back."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, numbers.Integral):
        return str(int(value))
    if isinstance(value, numbers.Real):
        value = float(value)
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:            # 1e-05 -> 1.0e-05, as PyYAML
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if _plain_ok(value):
            return value
        if value.isprintable():
            return "'" + value.replace("'", "''") + "'"
        raise ValueError(f"cannot write the string {value!r} as YAML: a character in it "
                         "is not printable")
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def _block(value: Any, indent: int, out: List[str], prefix: str) -> None:
    """value as lines at `indent`; the first line starts with `prefix`
    (a key with its ':' or a '- '), which may already hold content."""
    pad = " " * indent
    if isinstance(value, dict) and value:
        first = True
        for k, v in value.items():
            key = _scalar(k) + ":"
            lead = prefix if first else pad
            first = False
            if isinstance(v, dict) and v:
                out.append(lead + key)
                _block(v, indent + 2, out, " " * (indent + 2))
            elif isinstance(v, (list, tuple)) and v:
                out.append(lead + key)
                _block(v, indent, out, pad)
            else:
                out.append(lead + key + " " + _flat(v))
        return
    if isinstance(value, (list, tuple)) and value:
        first = True
        for v in value:
            lead = (prefix if first else pad) + "- "
            first = False
            if (isinstance(v, (dict, list, tuple))) and v:
                _block(v, indent + 2, out, lead)
            else:
                out.append(lead + _flat(v))
        return
    out.append(prefix + _flat(value))


def _flat(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar(value)


def dumps(value: Any) -> str:
    """value (dicts, lists, str, int, float, bool, None) as block YAML."""
    out: List[str] = []
    _block(value, 0, out, "")
    return "\n".join(out) + "\n"
