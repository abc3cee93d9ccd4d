# Frozen copy of msckf_stereo_c_torch/io/yaml_subset.py at commit 50013dad8c92.
"""A strict reader for the YAML subset of the repository's config files.

The three files under ``config/`` use block mappings nested by indentation
(``cam0:``, ``cam1:``), ``key: scalar`` lines whose keys may hold ``/``
(``noise/gyro: 0.005``), whole-line and trailing comments, and flow lists
``[...]`` that may span several lines and may start on the line after their
key (Kalibr's ``T_cam_imu:``).  ``read_yaml`` parses exactly that and raises
``ValueError`` naming the file and line for anything else: block lists,
quotes, anchors, tags, flow mappings, block scalars, tabs, document markers,
duplicate keys, and the number forms below that the subset does not resolve.
It never guesses.

Scalars resolve as PyYAML's ``safe_load`` resolves them (YAML 1.1): null
(``~``, ``null``), the YAML 1.1 booleans (``yes``/``no``/``on``/``off``/
``true``/``false`` in their three cases), decimal integers, and floats only
in YAML 1.1's form, which needs a dot and a signed exponent: ``1.5e-05`` is a
float but ``1e-5`` is the string ``'1e-5'`` (the loaders' ``float()`` turns
it into the same number).  Octal, hexadecimal, binary and sexagesimal
integers, and numbers with ``_`` in them, raise instead of resolving.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_./\-]*$")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
# YAML 1.1's float (PyYAML's resolver) without the '_' and ':' forms.
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# Number-like forms YAML 1.1 resolves in ways the subset does not take on:
# octal (leading 0), 0x / 0b, sexagesimal (':'), '_' separators.
_EXOTIC = re.compile(r"[-+]?(?:0[0-9_]+|0[xXbB][0-9a-fA-F_]*|[0-9][0-9_]*(?::[0-9_.]+)+|[0-9.]*_[0-9_.eE+-]*)$")
_NULLS = ("~", "null", "Null", "NULL", "")
_TRUE = ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")
_FALSE = ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")
# A plain scalar may not start with these (YAML indicators the subset lacks).
_BAD_START = set("[]{},&*!|>'\"%@`#?:-")


class _Lines:
    """The file's lines with comments cut and blank lines dropped:
    (line number, indent, text)."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.items: List[Tuple[int, int, str]] = []
        for no, raw in enumerate(text.splitlines(), start=1):
            line = _strip_comment(raw)
            if not line.strip():
                continue
            if "\t" in line:
                self.fail(no, "tab")
            body = line.lstrip(" ")
            self.items.append((no, len(line) - len(body), body.rstrip()))
        self.pos = 0

    def fail(self, no: int, what: str):
        raise ValueError(f"{self.path}:{no}: {what} (not in the YAML subset read here)")

    def peek(self) -> Optional[Tuple[int, int, str]]:
        return self.items[self.pos] if self.pos < len(self.items) else None


def _strip_comment(line: str) -> str:
    """The line without its comment: '#' at the start or after whitespace."""
    for i, ch in enumerate(line):
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(lines: _Lines, no: int, text: str) -> Any:
    """Resolve one plain scalar as PyYAML's SafeLoader would."""
    s = text.strip()
    if s in _NULLS:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if s[0] in _BAD_START and not (s[0] == "-" and len(s) > 1 and s[1] != " "):
        lines.fail(no, f"scalar {s!r}")
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    if _INF.match(s):
        return float("-inf") if s[0] == "-" else float("inf")
    if _NAN.match(s):
        return float("nan")
    if _EXOTIC.match(s):
        lines.fail(no, f"number form {s!r}")
    if ": " in s or s.endswith(":") or any(c in s for c in "[]{},\"'"):
        lines.fail(no, f"scalar {s!r}")
    return s


def _flow_list(lines: _Lines, no: int, text: str) -> List[Any]:
    """A flow list of scalars that starts with '[' in ``text`` and may go on
    over the following lines (whatever their indent) to its ']'."""
    parts = [text]
    while "]" not in parts[-1]:
        nxt = lines.peek()
        if nxt is None:
            lines.fail(no, "flow list without its ']'")
        lines.pos += 1
        parts.append(nxt[2])
    body = " ".join(parts)
    if body.count("[") != 1 or body.count("]") != 1 or not body.endswith("]"):
        lines.fail(no, f"flow list {body!r}")
    inner = body[1:-1].strip()
    if not inner:
        return []
    items = [x.strip() for x in inner.split(",")]
    if any(not x for x in items):
        lines.fail(no, f"empty item in flow list {body!r}")
    return [_scalar(lines, no, x) for x in items]


def _mapping(lines: _Lines, indent: int) -> dict:
    """The block mapping whose keys sit at ``indent``."""
    out: dict = {}
    while True:
        item = lines.peek()
        if item is None or item[1] < indent:
            return out
        no, ind, text = item
        if ind > indent:
            lines.fail(no, "unexpected indentation")
        lines.pos += 1
        if text in ("---", "...") or text.startswith(("--- ", "- ")) or text == "-":
            lines.fail(no, f"{text.split()[0]!r}")
        key, sep, rest = text.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            lines.fail(no, f"line {text!r} is not 'key: value'")
        key = key.strip()
        if not _KEY.match(key) or key in _NULLS or key in _TRUE or key in _FALSE or _INT.match(key):
            lines.fail(no, f"key {key!r}")
        if key in out:
            lines.fail(no, f"duplicate key {key!r}")
        rest = rest.strip()
        if rest.startswith("["):
            out[key] = _flow_list(lines, no, rest)
        elif rest:
            out[key] = _scalar(lines, no, rest)
        else:
            nxt = lines.peek()
            if nxt is None or nxt[1] <= indent:
                out[key] = None
            elif nxt[2].startswith("["):
                lines.pos += 1
                out[key] = _flow_list(lines, nxt[0], nxt[2])
                after = lines.peek()
                if after is not None and after[1] > indent:
                    lines.fail(after[0], "unexpected indentation")
            else:
                out[key] = _mapping(lines, nxt[1])


def parse_yaml(text: str, path: str = "<string>") -> Optional[dict]:
    """Parse ``text`` (the subset above); ``path`` names it in errors.
    Returns the top-level mapping, or None for a document with no content
    (as ``safe_load`` does)."""
    lines = _Lines(path, text)
    first = lines.peek()
    if first is None:
        return None
    if first[1] != 0:
        lines.fail(first[0], "indented first line")
    out = _mapping(lines, 0)
    rest = lines.peek()
    if rest is not None:
        lines.fail(rest[0], "unexpected indentation")
    return out


def read_yaml(path: str) -> Optional[dict]:
    """Parse the YAML file at ``path`` (the subset above)."""
    with open(path) as f:
        return parse_yaml(f.read(), path)
