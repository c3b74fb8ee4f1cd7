"""Dotted-target factory and YAML config loading.

``load_yaml`` reads the YAML subset that the shipped ``configs/*.yaml``
use, and that ``yaml.safe_dump`` writes, to the object that PyYAML's
``yaml.safe_load`` gives, and needs no PyYAML: nested block mappings and
block sequences (``- item``, ``- - item``, ``- key: value``); flow sequences
and mappings on one line (nested too, ``[[], [5]]``, ``{data: -1}``);
plain, single- and double-quoted scalars; ``#`` comments; YAML 1.1's
implicit types as PyYAML resolves them. That includes its quirks: ``1e-5``
and ``1.0e5`` are strings (its float pattern needs a dot and a signed
exponent), ``on`` / ``off`` / ``yes`` / ``no`` are bools, and
``2017-12-31`` is a ``datetime.date``. Anything else (anchors, aliases,
tags, block or multi-line scalars, directives, several documents, flow
collections over several lines) raises :class:`YamlSubsetError` naming the
file and the line, rather than being misread.
"""

from __future__ import annotations

import datetime
import importlib
import re
from typing import Any, Dict, List, Tuple


def get_obj_from_str(path: str):
    """The object at a dotted import path, ``"package.module.Name"``."""
    module, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def instantiate_from_config(cfg: Dict) -> Any:
    """``cfg["target"](**cfg.get("params", {}))``, the target by import
    path."""
    if "target" not in cfg:
        raise KeyError("expected a `target` key")
    return get_obj_from_str(cfg["target"])(**cfg.get("params", {}))


class YamlSubsetError(ValueError):
    """A YAML construct outside the subset :func:`load_yaml` reads."""


# PyYAML's implicit resolvers of YAML 1.1 (yaml/resolver.py), in its order.
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
_DATE = re.compile(r"^([0-9]{4})-([0-9]{2})-([0-9]{2})$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}"
                        r":[0-9]{2}:[0-9]{2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ",
            "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters that may not start a plain scalar, and what they start
_INDICATORS = {"&": "anchors", "*": "aliases", "!": "tags",
               "|": "block scalars", ">": "block scalars", "%": "directives",
               "@": "reserved indicators", "`": "reserved indicators",
               "?": "complex keys"}


class _Reader:
    def __init__(self, path: str, text: str):
        self.path = path
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, text)
        for no, raw in enumerate(text.lstrip("\ufeff").splitlines(), 1):
            body = raw.rstrip()
            stripped = body.lstrip(" ")
            if not stripped or stripped.startswith("#"):
                continue
            if stripped[0] == "\t":
                self.fail(no, "tabs in the indentation")
            self.lines.append((no, len(body) - len(stripped), stripped))

    def fail(self, no: int, what: str):
        raise YamlSubsetError(f"{self.path}:{no}: {what} (load_yaml reads the "
                              f"subset of YAML that configs/*.yaml use)")

    # -- scalars -------------------------------------------------------------
    def resolve(self, no: int, s: str) -> Any:
        """A plain scalar as PyYAML's implicit resolvers type it."""
        if _BOOL.match(s):
            return s.lower() in ("yes", "true", "on")
        if _FLOAT.match(s) or _INT.match(s):
            if ":" in s:
                self.fail(no, f"sexagesimal number {s!r}")
            t = s.replace("_", "")
            if _INT.match(s):
                sign = -1 if t[0] == "-" else 1
                t = t.lstrip("+-")
                if t.startswith("0b"):
                    return sign * int(t[2:], 2)
                if t.startswith("0x"):
                    return sign * int(t[2:], 16)
                if len(t) > 1 and t[0] == "0":
                    return sign * int(t, 8)
                return sign * int(t)
            low = t.lower()
            if low.endswith(".inf"):
                return float("-inf") if low[0] == "-" else float("inf")
            if low == ".nan":
                return float("nan")
            return float(t)
        if _NULL.match(s):
            return None
        if s in ("<<", "="):
            self.fail(no, f"the {s!r} merge or value key")
        m = _DATE.match(s)
        if m:
            return datetime.date(*map(int, m.groups()))
        if _TIMESTAMP.match(s):
            self.fail(no, f"timestamp with a time of day {s!r}")
        return s

    def quoted(self, no: int, s: str, i: int) -> Tuple[str, int]:
        """The quoted scalar that starts at s[i]; returns (value, index after
        its closing quote)."""
        q, out, i = s[i], [], i + 1
        while i < len(s):
            c = s[i]
            if c == q:
                if q == "'" and s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if q == '"' and c == "\\":
                e = s[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                n = _HEX_ESCAPES.get(e)
                code = s[i + 2:i + 2 + n] if n else ""
                if not n or len(code) != n or not all(
                        ch in "0123456789abcdefABCDEF" for ch in code):
                    self.fail(no, f"escape {s[i:i + 2]!r}")
                out.append(chr(int(code, 16)))
                i += 2 + n
                continue
            out.append(c)
            i += 1
        self.fail(no, "a quoted scalar over several lines")

    def rest_is_comment(self, no: int, s: str, i: int):
        rest = s[i:]
        if rest.strip() and not (rest[:1].isspace() and rest.lstrip().startswith("#")):
            self.fail(no, f"unexpected text {rest.strip()!r}")

    # -- flow collections ----------------------------------------------------
    def flow(self, no: int, s: str, i: int) -> Tuple[Any, int]:
        """The flow collection that starts at s[i] ('[' or '{')."""
        close = "]" if s[i] == "[" else "}"
        out: Any = [] if close == "]" else {}
        i += 1
        while True:
            i = self.skip_spaces(s, i)
            if i >= len(s) or s[i] == "#":
                self.fail(no, "a flow collection over several lines")
            if s[i] == close:
                return out, i + 1
            if close == "]":
                item, i = self.flow_node(no, s, i, close)
                out.append(item)
            else:
                key, i = self.flow_node(no, s, i, close)
                i = self.skip_spaces(s, i)
                if s[i:i + 1] != ":":
                    self.fail(no, "a flow mapping entry without ': '")
                value, i = self.flow_node(no, s, self.skip_spaces(s, i + 1), close)
                if key in out:
                    self.fail(no, f"duplicate key {key!r}")
                out[key] = value
            i = self.skip_spaces(s, i)
            if s[i:i + 1] == ",":
                i += 1
            elif s[i:i + 1] != close:
                self.fail(no, f"expected ',' or {close!r} in a flow collection")

    @staticmethod
    def skip_spaces(s: str, i: int) -> int:
        while i < len(s) and s[i] in " \t":
            i += 1
        return i

    def flow_node(self, no: int, s: str, i: int, close: str) -> Tuple[Any, int]:
        if i >= len(s):
            self.fail(no, "a flow collection over several lines")
        c = s[i]
        if c in "[{":
            return self.flow(no, s, i)
        if c in "'\"":
            return self.quoted(no, s, i)
        if c in _INDICATORS or (c == "-" and s[i + 1:i + 2] in ("", " ")):
            self.fail(no, _INDICATORS.get(c, "a block sequence in a flow collection"))
        if c in ",]}":
            self.fail(no, "an empty node in a flow collection")
        j = i
        while j < len(s) and s[j] not in ",[]{}":
            if s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " ,[]{}"):
                break
            if s[j] == "#" and s[j - 1] in " \t":
                self.fail(no, "a flow collection over several lines")
            j += 1
        if j < len(s) and s[j] in "[{":
            self.fail(no, f"a flow indicator inside the scalar {s[i:j + 1]!r}")
        if s[j:j + 1] == ":" and close == "]":
            self.fail(no, "a mapping inside a flow sequence")
        return self.resolve(no, s[i:j].rstrip()), j

    # -- block mappings ------------------------------------------------------
    def key(self, no: int, s: str) -> Tuple[Any, int]:
        """The key of a ``key: value`` line and the index after its ':'."""
        if s[0] in "'\"":
            key, i = self.quoted(no, s, 0)
            i = self.skip_spaces(s, i)
        else:
            if s[0] in "[{":
                self.fail(no, "flow collections as keys")
            m = re.search(r":(?:\s|$)", s)
            hash_at = re.search(r"\s#", s)
            if not m or (hash_at and hash_at.start() < m.start()):
                self.fail(no, "expected 'key: value'")
            key, i = self.resolve(no, s[:m.start()].rstrip()), m.start()
        if s[i:i + 1] != ":" or s[i + 1:i + 2] not in ("", " ", "\t"):
            self.fail(no, "expected 'key: value'")
        return key, i + 1

    def value(self, no: int, s: str, i: int) -> Tuple[bool, Any]:
        """(False, value) for an inline value, (True, None) for none."""
        i = self.skip_spaces(s, i)
        if i >= len(s) or s[i] == "#":
            return True, None
        c = s[i]
        if c in "[{":
            v, j = self.flow(no, s, i)
        elif c in "'\"":
            v, j = self.quoted(no, s, i)
        elif c in _INDICATORS:
            self.fail(no, _INDICATORS[c])
        elif c in ",]}":
            self.fail(no, f"a plain scalar that starts with {c!r}")
        elif c == "-" and s[i + 1:i + 2] in ("", " "):
            self.fail(no, "a sequence entry on the line of a key")
        else:
            m = re.search(r"\s#", s[i:])
            text = (s[i:i + m.start()] if m else s[i:]).rstrip()
            if re.search(r":(?:\s|$)", text):
                self.fail(no, "a mapping value on the line of another key")
            return False, self.resolve(no, text)
        self.rest_is_comment(no, s, j)
        return False, v

    @staticmethod
    def is_entry(s: str) -> bool:
        """Whether a line's text is a block sequence entry, ``- ...``."""
        return s[0] == "-" and s[1:2] in ("", " ")

    def block(self, k: int, indent: int) -> Tuple[Any, int]:
        """The block node whose first line, lines[k], is at ``indent``: a
        sequence, a mapping, or a scalar or flow collection on its line."""
        no, _, s = self.lines[k]
        if s.startswith("---") or s.startswith("..."):
            self.fail(no, "document markers")
        if self.is_entry(s):
            return self.sequence(k, indent)
        if s[0] in _INDICATORS:
            self.fail(no, _INDICATORS[s[0]])
        if s[0] in "'\"":
            _, j = self.quoted(no, s, 0)
            is_key = re.match(r"\s*:(?:\s|$)", s[j:]) is not None
        else:
            is_key = re.match(r"[^\[{#]*?:(?:\s|$)", s) is not None
        if is_key:
            return self.mapping(k, indent)
        _, v = self.value(no, s, 0)
        if k + 1 < len(self.lines) and self.lines[k + 1][1] > indent:
            self.fail(self.lines[k + 1][0], "unexpected indentation "
                                            "(multi-line scalars are not read)")
        return v, k + 1

    def sequence(self, k: int, indent: int) -> Tuple[List, int]:
        """A block sequence: ``- item`` lines at ``indent``. An item's text
        starts a node at its own column (``- a: 1`` opens a mapping whose
        next keys line up with ``a``, ``- - 1`` a nested sequence)."""
        out: List = []
        while (k < len(self.lines) and self.lines[k][1] == indent
               and self.is_entry(self.lines[k][2])):
            no, ind, s = self.lines[k]
            rest = s[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                k += 1
                if k < len(self.lines) and self.lines[k][1] > indent:
                    v, k = self.block(k, self.lines[k][1])
                else:
                    v = None
            else:
                col = ind + len(s) - len(rest)
                self.lines[k] = (no, col, rest)
                v, k = self.block(k, col)
            out.append(v)
        if k < len(self.lines) and self.lines[k][1] > indent:
            self.fail(self.lines[k][0], "unexpected indentation")
        return out, k

    def mapping(self, k: int, indent: int) -> Tuple[Dict, int]:
        out: Dict = {}
        while k < len(self.lines):
            no, ind, s = self.lines[k]
            if ind < indent:
                break
            if ind > indent:
                self.fail(no, "unexpected indentation (multi-line scalars are "
                              "not read)")
            if s.startswith("---") or s.startswith("..."):
                self.fail(no, "document markers")
            if self.is_entry(s):
                self.fail(no, "a sequence entry where a key was expected")
            if s[0] in _INDICATORS:
                self.fail(no, _INDICATORS[s[0]])
            key, i = self.key(no, s)
            if key in out:
                self.fail(no, f"duplicate key {key!r}")
            empty, v = self.value(no, s, i)
            k += 1
            if empty and k < len(self.lines):
                nxt_ind, nxt = self.lines[k][1], self.lines[k][2]
                # a key's block value is indented, or a sequence at the
                # key's own indentation
                if nxt_ind > indent or (nxt_ind == indent and self.is_entry(nxt)):
                    v, k = self.block(k, nxt_ind)
            out[key] = v
        return out, k

    def document(self) -> Any:
        if not self.lines:
            return None
        out, k = self.block(0, self.lines[0][1])
        if k < len(self.lines):
            self.fail(self.lines[k][0], "unexpected indentation")
        return out


def load_yaml(path: str) -> Dict:
    """The YAML file at ``path``, as ``yaml.safe_load`` reads it, for the
    subset in this module's docstring; raises :class:`YamlSubsetError`
    (file and line) for anything outside it."""
    with open(path, encoding="utf-8") as f:
        return _Reader(path, f.read()).document()
