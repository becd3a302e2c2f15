"""The YAML subset of the daemon's config file, parsed without pyyaml.

The twin reads its config file with ``yaml.safe_load`` (twin
``config/spec.py:parse_config_file``); the card machine has no pyyaml, so
this module parses the subset such a file uses and resolves every plain
scalar by the YAML 1.1 rules pyyaml applies (``on``/``yes`` are booleans,
``0x1F`` is 31, ``017`` is 15, ``1_000`` is 1000, ``1:30`` is 90; ``0o17``,
``60s`` and ``1m30s`` stay strings). The subset:

- block mappings and block sequences, sequences of mappings
  (``- name: ...``) and the indentless sequence under a key;
- flow sequences and flow mappings, across lines too (a JSON document is
  one flow mapping);
- plain, single-quoted and double-quoted scalars; quoted scalars may span
  lines (folded as pyyaml folds them), plain scalars only inside a flow
  collection;
- ``#`` comments, ``null`` / ``~`` / an empty value, one leading ``---``.

Everything else raises :class:`YamlSubsetError` (a ``ConfigError``) naming
the line: anchors, aliases, tags, directives, block scalars (``|``,
``>``), explicit keys (``?``), complex keys, single-pair mappings inside
flow sequences, a multi-line plain scalar in block context, timestamps,
merge keys, tabs outside quoted scalars, and more than one document. The
parser never returns a value that differs from ``yaml.safe_load``'s: what
it cannot parse the same way, it refuses.
"""

from __future__ import annotations

import bisect
import re
from typing import Any, List, Optional, Tuple

from gpu_feature_discovery_tpu_torch.config.spec import ConfigError


class YamlSubsetError(ConfigError):
    """A document outside the subset, or malformed; names its line."""

    def __init__(self, line: int, message: str):
        super().__init__(f"line {line}: {message}")
        self.line = line


# YAML 1.1 implicit types, as pyyaml's resolver matches them (re.X: the
# blanks in the patterns are not part of them).
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
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
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_VALUE = re.compile(r"^(?:=)$")

# First character -> the resolvers tried, in pyyaml's registration order.
_RESOLVERS: dict = {}
for _tag, _regex, _first in (
    ("bool", _BOOL, "yYnNtTfFoO"),
    ("float", _FLOAT, "-+0123456789."),
    ("int", _INT, "-+0123456789"),
    ("merge", _MERGE, "<"),
    ("null", _NULL, "~nN"),
    ("timestamp", _TIMESTAMP, "0123456789"),
    ("value", _VALUE, "="),
):
    for _ch in _first:
        _RESOLVERS.setdefault(_ch, []).append((_tag, _regex))

_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}

# Double-quoted escapes (pyyaml's table) and the \x, \u, \U code widths.
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09",
    "n": "\x0A", "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B",
    " ": "\x20", '"': '"', "\\": "\\", "/": "/", "N": "\x85", "_": "\xA0",
    "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}

# pyyaml's reader refuses anything outside this set; the three YAML 1.1
# line breaks beyond \n are refused here too.
_NON_PRINTABLE = re.compile(
    "[^\x09\x0A\x20-\x7E\xA0-\u2027\u202A-\uD7FF\uE000-\uFFFD"
    "\U00010000-\U0010FFFF]"
)

_EOF = "\0"
# A plain scalar cannot start with one of these (pyyaml check_plain).
_PLAIN_FORBIDDEN_FIRST = "-?:,[]{}#&*!|>'\"%@`"
_FLOW_INDICATORS = ",[]{}"


def safe_load(text: str) -> Any:
    """The one document of ``text``, as ``yaml.safe_load`` would return
    it; None for an empty document. YamlSubsetError names the line of
    anything outside the subset."""
    return _Parser(text).document()


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
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
        total, base = 0, 1
        for digit in reversed([int(part) for part in value.split(":")]):
            total += digit * base
            base *= 60
        return sign * total
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        total, base = 0.0, 1
        for digit in reversed([float(part) for part in value.split(":")]):
            total += digit * base
            base *= 60
        return sign * total
    return sign * float(value)


class _Parser:
    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        self.text = text
        self.n = len(text)
        self._line_starts = [0] + [i + 1 for i, ch in enumerate(text) if ch == "\n"]
        # A '...' closes the document only after its node has begun.
        self._node_seen = False
        bad = _NON_PRINTABLE.search(text)
        if bad is not None:
            self.fail(bad.start(), f"character {bad.group()!r} is not allowed")

    # -- positions -----------------------------------------------------------

    def line(self, pos: int) -> int:
        return bisect.bisect_right(self._line_starts, pos)

    def column(self, pos: int) -> int:
        return pos - self._line_starts[self.line(pos) - 1]

    def fail(self, pos: int, message: str):
        raise YamlSubsetError(self.line(min(pos, self.n)), message)

    def peek(self, pos: int) -> str:
        return self.text[pos] if pos < self.n else _EOF

    def _marker_at(self, pos: int) -> bool:
        """A document marker (``---`` or ``...``) at a line start."""
        return (self.text[pos:pos + 3] in ("---", "...")
                and self.peek(pos + 3) in _EOF + " \t\n")

    # -- block structure -----------------------------------------------------

    def next_content(self, pos: int) -> Optional[Tuple[int, int]]:
        """(content position, indent) of the first line at or after the
        line start ``pos`` that holds more than blanks and a comment; None
        at the end of the document (the end of the text, or a ``...``
        line with nothing but blanks and comments after it)."""
        while pos < self.n:
            i = pos
            while self.peek(i) == " ":
                i += 1
            ch = self.peek(i)
            if ch == "\t":
                self.fail(i, "tabs are allowed only inside quoted scalars")
            if ch == "#":
                while self.peek(i) not in "\n" + _EOF:
                    i += 1
                ch = self.peek(i)
            if ch == "\n":
                pos = i + 1
                continue
            if ch == _EOF:
                return None
            if i == pos and self._marker_at(i):
                if self.text.startswith("...", i) and self._node_seen:
                    rest = self.next_content(self.line_end(i + 3))
                    if rest is None:
                        return None
                self.fail(i, "one document per file: a document marker may "
                             "only open (---) or close (...) it")
            if i == pos and ch == "%":
                self.fail(i, "directives are not supported")
            return i, i - pos
        return None

    def line_end(self, pos: int) -> int:
        """After a node in block context: blanks and a comment, then the
        line break; the start of the next line."""
        while self.peek(pos) == " ":
            pos += 1
        ch = self.peek(pos)
        if ch == "#":
            while self.peek(pos) not in "\n" + _EOF:
                pos += 1
            ch = self.peek(pos)
        if ch == "\t":
            self.fail(pos, "tabs are allowed only inside quoted scalars")
        if ch == _EOF:
            return self.n
        if ch != "\n":
            self.fail(pos, f"unexpected {ch!r} after a value")
        return pos + 1

    def document(self) -> Any:
        start = 0
        # Blank and comment lines may precede one leading '---'.
        while start < self.n:
            i = start
            while self.peek(i) == " ":
                i += 1
            if self.peek(i) not in "#\n":
                break
            while self.peek(i) not in "\n" + _EOF:
                i += 1
            start = i + 1
        if self.text.startswith("---", start) and self._marker_at(start):
            i = start + 3
            while self.peek(i) == " ":
                i += 1
            if self.peek(i) not in "#\n" + _EOF:
                self.fail(i, "content on the '---' line is not supported")
            start = self.line_end(i)
        first = self.next_content(start)
        if first is None:
            return None
        pos, indent = first
        self._node_seen = True
        value, end = self.block_node(pos, indent, -1)
        rest = self.next_content(end)
        if rest is not None:
            self.fail(rest[0], "content after the document's top-level node "
                               "(bad indentation?)")
        return value

    def _is_entry(self, pos: int) -> bool:
        return self.peek(pos) == "-" and self.peek(pos + 1) in " \n" + _EOF

    def block_node(self, pos: int, col: int, parent: int) -> Tuple[Any, int]:
        """The node starting at ``pos`` (column ``col``) inside the block
        collection at column ``parent`` (-1 at the top): a block sequence,
        a block mapping, or one inline node. Returns (value, start of the
        line after it)."""
        if self._is_entry(pos):
            return self.block_sequence(pos, col)
        if self.key(pos) is not None:
            return self.block_mapping(pos, col)
        value, end = self.inline(pos, parent + 1)
        return value, self.line_end(end)

    def block_sequence(self, pos: int, col: int) -> Tuple[list, int]:
        items: List[Any] = []
        while True:
            i = pos + 1
            while self.peek(i) == " ":
                i += 1
            if self.peek(i) in "#\n" + _EOF:
                end = self.line_end(i)
                nxt = self.next_content(end)
                if nxt is not None and nxt[1] > col:
                    item, end = self.block_node(*nxt, col)
                else:
                    item = None
            else:
                # Compact form: the item starts on the entry's own line.
                item, end = self.block_node(i, col + (i - pos), col)
            items.append(item)
            nxt = self.next_content(end)
            if nxt is None or nxt[1] < col:
                return items, end
            if nxt[1] > col:
                self.fail(nxt[0], "bad indentation")
            if not self._is_entry(nxt[0]):
                return items, end
            pos = nxt[0]

    def block_mapping(self, pos: int, col: int) -> Tuple[dict, int]:
        mapping: dict = {}
        while True:
            parsed = self.key(pos)
            if parsed is None:
                self.fail(pos, "expected a 'key: value' line")
            key, after = parsed
            i = after
            while self.peek(i) == " ":
                i += 1
            if self.peek(i) in "#\n" + _EOF:
                end = self.line_end(i)
                nxt = self.next_content(end)
                if nxt is not None and nxt[1] > col:
                    value, end = self.block_node(*nxt, col)
                elif nxt is not None and nxt[1] == col and self._is_entry(nxt[0]):
                    # The indentless sequence: its entries at the key's column.
                    value, end = self.block_sequence(nxt[0], col)
                else:
                    value = None
            else:
                value, i = self.inline(i, col + 1)
                end = self.line_end(i)
            mapping[key] = value
            nxt = self.next_content(end)
            if nxt is None or nxt[1] < col:
                return mapping, end
            if nxt[1] > col:
                self.fail(nxt[0], "bad indentation")
            pos = nxt[0]

    def key(self, pos: int) -> Optional[Tuple[Any, int]]:
        """(key, position after its ':') when a block mapping key starts at
        ``pos``, else None."""
        ch = self.peek(pos)
        if ch in "?:" and self.peek(pos + 1) in " \n" + _EOF:
            self.fail(pos, "explicit and empty keys are not supported")
        text = None
        if ch in "'\"":
            key, end = self.quoted(pos)
        elif ch in "[{":
            _, end = self.flow_collection(pos)
            while self.peek(end) == " ":
                end += 1
            if self.peek(end) == ":":
                self.fail(pos, "complex (collection) keys are not supported")
            return None
        elif self._plain_starts(pos, flow=False):
            text, end = self.plain_block(pos, None)
        else:
            return None
        i = end
        while self.peek(i) == " ":
            i += 1
        if self.peek(i) != ":" or self.peek(i + 1) not in " \n" + _EOF:
            return None
        if self.line(i) != self.line(pos):
            self.fail(pos, "a key must be on one line")
        if i - pos > 1024:
            self.fail(pos, "a key longer than 1024 characters")
        if text is not None:
            key = self.resolve(text, pos)
        return key, i + 1

    def inline(self, pos: int, min_col: int) -> Tuple[Any, int]:
        """One node starting at ``pos`` in block context: a flow collection
        or a quoted scalar (either may run over later lines), or a plain
        scalar folded over the lines at column ``min_col`` or beyond."""
        ch = self.peek(pos)
        if ch in "[{":
            return self.flow_collection(pos)
        if ch in "'\"":
            return self.quoted(pos)
        if self._is_entry(pos):
            self.fail(pos, "a sequence entry cannot start here")
        self._check_plain_start(pos, flow=False)
        text, end = self.plain_block(pos, min_col)
        return self.resolve(text, pos), end

    # -- scalars -------------------------------------------------------------

    def _plain_starts(self, pos: int, flow: bool) -> bool:
        ch = self.peek(pos)
        nxt = self.peek(pos + 1)
        if ch in _EOF + " \t\n":
            return False
        if ch not in _PLAIN_FORBIDDEN_FIRST:
            return True
        return nxt not in _EOF + " \t\n" and (ch == "-" or (not flow and ch in "?:"))

    def _check_plain_start(self, pos: int, flow: bool) -> None:
        if self._plain_starts(pos, flow):
            return
        ch = self.peek(pos)
        what = {
            "&": "anchors", "*": "aliases", "!": "tags",
            "|": "block scalars", ">": "block scalars",
            "?": "explicit keys", "%": "directives",
        }.get(ch)
        if what:
            self.fail(pos, f"{what} are not supported")
        self.fail(pos, f"unexpected {ch!r}" if ch != _EOF else "unexpected end of file")

    def plain_block(self, pos: int, min_col: Optional[int]) -> Tuple[str, int]:
        """A plain scalar in block context (pyyaml's scan_plain at no flow
        level): it ends at ' #' or at ': ', and folds over the following
        lines whose content starts at column ``min_col`` or beyond (None:
        one line only). Returns the text and the position after its last
        character."""
        return self._plain(pos, flow=False, min_col=min_col)

    def plain_flow(self, pos: int) -> Tuple[str, int]:
        """A plain scalar in flow context: it also ends at a flow
        indicator, and folds over any line break."""
        return self._plain(pos, flow=True, min_col=0)

    def _plain(self, pos: int, flow: bool, min_col: Optional[int]) -> Tuple[str, int]:
        stops = _EOF + " \t\n" + (_FLOW_INDICATORS if flow else "")
        chunks: List[str] = []
        spaces: List[str] = []
        i = end = pos
        while self.peek(i) != "#":
            length = 0
            while True:
                ch = self.peek(i + length)
                if ch == "\t":
                    self.fail(i + length, "tabs are allowed only inside quoted scalars")
                if (ch in _EOF + " \n"
                        or (ch == ":" and self.peek(i + length + 1) in stops)
                        or (flow and ch in ",?[]{}")):
                    break
                length += 1
            if length == 0:
                break
            chunks.extend(spaces)
            chunks.append(self.text[i:i + length])
            i = end = i + length
            spaces, i = self._plain_spaces(i, flow, fold=min_col is not None)
            if not spaces or self.peek(i) == "#":
                break
            if min_col is not None and self.column(i) < min_col:
                break
        return "".join(chunks), end

    def _plain_spaces(self, i: int, flow: bool, fold: bool) -> Tuple[List[str], int]:
        """The blanks after a plain chunk: themselves, or the folding of
        the line breaks they cross ([' '] for one, a '\\n' per blank line);
        [] when the scalar ends here."""
        start = i
        while self.peek(i) == " ":
            i += 1
        whitespaces = self.text[start:i]
        if self.peek(i) == "\t":
            self.fail(i, "tabs are allowed only inside quoted scalars")
        if self.peek(i) != "\n":
            return ([whitespaces] if whitespaces else []), i
        if not fold:
            return [], i
        breaks: List[str] = []
        while True:
            i += 1  # past the line break at i
            if self._marker_at(i):
                if flow:
                    self.fail(i, "a document marker inside a flow collection")
                return [], i
            while self.peek(i) == " ":
                i += 1
            ch = self.peek(i)
            if ch == "\t":
                self.fail(i, "tabs are allowed only inside quoted scalars")
            if ch != "\n":
                return (breaks if breaks else [" "]), i
            breaks.append("\n")

    def quoted(self, pos: int) -> Tuple[str, int]:
        """A single- or double-quoted scalar, folded over line breaks as
        pyyaml's scan_flow_scalar folds it."""
        quote = self.text[pos]
        double = quote == '"'
        chunks: List[str] = []
        i = pos + 1
        while True:
            i = self._quoted_non_spaces(i, double, chunks, pos)
            if self.peek(i) == quote:
                return "".join(chunks), i + 1
            i = self._quoted_spaces(i, chunks, pos)

    def _quoted_non_spaces(self, i: int, double: bool, chunks: List[str],
                           start: int) -> int:
        while True:
            j = i
            while self.peek(j) not in "'\"\\ \t\n" + _EOF:
                j += 1
            if j > i:
                chunks.append(self.text[i:j])
                i = j
            ch = self.peek(i)
            if not double and ch == "'" and self.peek(i + 1) == "'":
                chunks.append("'")
                i += 2
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                i += 1
            elif double and ch == "\\":
                i += 1
                ch = self.peek(i)
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    i += 1
                elif ch in _ESCAPE_CODES:
                    width = _ESCAPE_CODES[ch]
                    digits = self.text[i + 1:i + 1 + width]
                    if len(digits) != width or any(
                            d not in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(i, f"bad \\{ch} escape in a double-quoted scalar")
                    code = int(digits, 16)
                    if code > 0x10FFFF:
                        self.fail(i, f"escape \\{ch}{digits} is out of range")
                    chunks.append(chr(code))
                    i += 1 + width
                elif ch == "\n":
                    i = self._quoted_breaks(i + 1, chunks)
                else:
                    self.fail(i, f"unknown escape \\{ch} in a double-quoted scalar")
            else:
                return i

    def _quoted_spaces(self, i: int, chunks: List[str], start: int) -> int:
        j = i
        while self.peek(j) in " \t":
            j += 1
        whitespaces = self.text[i:j]
        ch = self.peek(j)
        if ch == _EOF:
            self.fail(start, "unterminated quoted scalar")
        if ch == "\n":
            before = len(chunks)
            j = self._quoted_breaks(j + 1, chunks)
            if len(chunks) == before:
                chunks.append(" ")
            return j
        chunks.append(whitespaces)
        return j

    def _quoted_breaks(self, i: int, chunks: List[str]) -> int:
        while True:
            if self._marker_at(i):
                self.fail(i, "a document marker inside a quoted scalar")
            while self.peek(i) in " \t":
                i += 1
            if self.peek(i) != "\n":
                return i
            chunks.append("\n")
            i += 1

    def resolve(self, text: str, pos: int) -> Any:
        """A plain scalar's value by the YAML 1.1 implicit types."""
        if text == "":
            return None
        for tag, regex in _RESOLVERS.get(text[0], ()):
            if not regex.match(text):
                continue
            if tag == "bool":
                return _BOOL_VALUES[text.lower()]
            if tag == "null":
                return None
            try:
                if tag == "int":
                    return _construct_int(text)
                if tag == "float":
                    return _construct_float(text)
            except ValueError:
                self.fail(pos, f"{text!r} is not a valid {tag}")
            self.fail(pos, f"{text!r} resolves to a YAML {tag}, which is not "
                           "supported (quote it for a string)")
        return text

    # -- flow collections ----------------------------------------------------

    def skip_flow_space(self, i: int) -> int:
        while True:
            ch = self.peek(i)
            if ch == " ":
                i += 1
            elif ch == "\n":
                i += 1
                if self._marker_at(i):
                    self.fail(i, "a document marker inside a flow collection")
            elif ch == "#":
                while self.peek(i) not in "\n" + _EOF:
                    i += 1
            elif ch == "\t":
                self.fail(i, "tabs are allowed only inside quoted scalars")
            else:
                return i

    def flow_node(self, pos: int) -> Tuple[Any, int]:
        ch = self.peek(pos)
        if ch in "[{":
            return self.flow_collection(pos)
        if ch in "'\"":
            return self.quoted(pos)
        self._check_plain_start(pos, flow=True)
        text, end = self.plain_flow(pos)
        return self.resolve(text, pos), end

    def flow_collection(self, pos: int) -> Tuple[Any, int]:
        if self.peek(pos) == "[":
            return self._flow_sequence(pos)
        return self._flow_mapping(pos)

    def _flow_sequence(self, pos: int) -> Tuple[list, int]:
        items: List[Any] = []
        i = pos + 1
        while True:
            i = self.skip_flow_space(i)
            if self.peek(i) == "]":
                return items, i + 1
            if self.peek(i) == _EOF:
                self.fail(pos, "unterminated flow sequence")
            item, i = self.flow_node(i)
            i = self.skip_flow_space(i)
            if self.peek(i) == ":":
                self.fail(i, "single-pair mappings inside a flow sequence are "
                             "not supported")
            items.append(item)
            if self.peek(i) == ",":
                i += 1
            elif self.peek(i) == "]":
                return items, i + 1
            else:
                self.fail(i, "expected ',' or ']' in a flow sequence")

    def _flow_mapping(self, pos: int) -> Tuple[dict, int]:
        mapping: dict = {}
        i = pos + 1
        while True:
            i = self.skip_flow_space(i)
            ch = self.peek(i)
            if ch == "}":
                return mapping, i + 1
            if ch == _EOF:
                self.fail(pos, "unterminated flow mapping")
            if ch in "?:":
                self.fail(i, "explicit and empty keys are not supported")
            key_pos = i
            key, i = self.flow_node(i)
            if isinstance(key, (list, dict)):
                self.fail(key_pos, "complex (collection) keys are not supported")
            i = self.skip_flow_space(i)
            value = None
            if self.peek(i) == ":":
                if self.line(i) != self.line(key_pos) or i - key_pos > 1024:
                    self.fail(key_pos, "a key and its ':' must be on one line")
                i = self.skip_flow_space(i + 1)
                if self.peek(i) not in ",}":
                    value, i = self.flow_node(i)
                    i = self.skip_flow_space(i)
            mapping[key] = value
            if self.peek(i) == ",":
                i += 1
            elif self.peek(i) == "}":
                return mapping, i + 1
            else:
                self.fail(i, "expected ',' or '}' in a flow mapping")
