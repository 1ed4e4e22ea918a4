"""Training configs: a YAML reader for the subset the training configs use,
semicolon key-path CLI overrides, and run directories (counterpart of
``esr_tpu/config/parser.py``).

The reader is not PyYAML, and never falls back to it (the card's machine
has none). It reads what ``configs/train_*.yml`` are written in, with
PyYAML's ``safe_load`` (YAML 1.1) meaning:

- block mappings indented with spaces, ``#`` comments;
- flow lists of scalars (``[a, "b", 0.5]``) and the empty flow mapping
  ``{}``;
- block sequences of mappings (``- name: x`` items, as the SLO files under
  ``configs/`` write their rules);
- anchors ``&X`` on a value or a nested mapping, and aliases ``*X``;
- the ``!!float`` tag;
- single- and double-quoted strings;
- plain scalars: ``null``/``~``, the YAML 1.1 booleans (``true``, ``no``,
  ``On`` ...), decimal ints, floats with a dot or a special value
  (``1.5``, ``1.0e-3``, ``.inf``), else strings (so ``1e-3`` without a tag
  is the string PyYAML also makes of it).

Anything else (block sequences of scalars, non-empty flow mappings, other
tags, multi-line scalars, octal/hex/sexagesimal numbers, tabs, documents
markers) raises ``ValueError`` naming the line.
"""

from __future__ import annotations

import os
import re
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

from esr_tpu_torch.utils.logging import setup_logging
from esr_tpu_torch.utils.trackers import to_yaml

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
# YAML 1.1 numbers outside the subset: binary, octal, hex, base 60
_REFUSED_NUMBER = re.compile(
    r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
    r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$"
)
_ANCHOR = re.compile(r"[^\s\[\]{},]+")


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v.startswith("-") else 1.0
    v = v.lstrip("+-")
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    return sign * float(v)


def _plain(text: str, where: str):
    """A plain scalar, resolved as PyYAML's ``safe_load`` resolves it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return _float(text)
    if _REFUSED_NUMBER.match(text):
        raise ValueError(f"{where}: number form {text!r} is outside the supported YAML subset")
    if text[0] in "!&*|>%@`[]{}" or ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: {text!r} is outside the supported YAML subset")
    return text


def _quoted(text: str, where: str) -> Tuple[str, str]:
    """A quoted string at the start of ``text``; returns (value, rest)."""
    q = text[0]
    out: List[str] = []
    i = 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            simple = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}
            if esc not in simple:
                raise ValueError(f"{where}: escape \\{esc} is outside the supported YAML subset")
            out.append(simple[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise ValueError(f"{where}: unterminated quoted string")


def _strip_comment(line: str) -> str:
    """Cut a ``#`` comment (at line start or after a space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i].rstrip()
    return line.rstrip()


def _split_flow(body: str, where: str) -> List[str]:
    """Items of a flow list body (no nesting), quotes respected."""
    items, cur, quote = [], [], None
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch in "[]{}":
            raise ValueError(f"{where}: nested flow collections are outside the supported YAML subset")
        elif ch == ",":
            items.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    last = "".join(cur).strip()
    if last or items:
        items.append(last)
    if any(not item for item in items):
        raise ValueError(f"{where}: empty flow list item")
    return items


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.anchors: Dict[str, object] = {}
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        for n, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise ValueError(f"{name}:{n}: tab indentation")
            content = _strip_comment(raw)
            if not content.strip():
                continue
            stripped = content.lstrip(" ")
            indent = len(content) - len(stripped)
            if stripped.startswith("- ") or stripped == "-":
                # a sequence item: a "-" marker line, then its content one
                # column past the dash's indentation
                self.lines.append((n, indent, "-"))
                rest = stripped[1:].lstrip(" ")
                if rest:
                    self.lines.append((n, indent + len(stripped) - len(rest), rest))
                continue
            if stripped.startswith(("---", "...", "? ")):
                raise ValueError(f"{name}:{n}: {stripped[:3]!r} is outside the supported YAML subset")
            self.lines.append((n, indent, stripped))

    def value(self, text: str, where: str):
        """An inline value: alias, tagged, quoted, flow list or plain."""
        if text.startswith("*"):
            name = text[1:]
            if not _ANCHOR.fullmatch(name):
                raise ValueError(f"{where}: bad alias {text!r}")
            if name not in self.anchors:
                raise ValueError(f"{where}: alias *{name} before its anchor")
            return self.anchors[name]
        if text.startswith("!!"):
            tag, _, rest = text.partition(" ")
            if tag != "!!float":
                raise ValueError(f"{where}: tag {tag} is outside the supported YAML subset")
            rest = rest.strip()
            if rest[:1] in ("'", '"'):
                rest, tail = _quoted(rest, where)
                if tail.strip():
                    raise ValueError(f"{where}: text after a quoted string")
            try:
                return _float(rest)
            except ValueError:
                raise ValueError(f"{where}: !!float of {rest!r}") from None
        if text[:1] in ("'", '"'):
            val, tail = _quoted(text, where)
            if tail.strip():
                raise ValueError(f"{where}: text after a quoted string")
            return val
        if text == "{}":
            return {}
        if text.startswith("["):
            if not text.endswith("]"):
                raise ValueError(f"{where}: a flow list must end on its line")
            return [self.value(item, where) for item in _split_flow(text[1:-1], where)]
        return _plain(text, where)

    def mapping(self, i: int, indent: int) -> Tuple[Dict, int]:
        out: Dict = {}
        while i < len(self.lines):
            n, ind, content = self.lines[i]
            where = f"{self.name}:{n}"
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"{where}: unexpected indentation")
            key_text, rest = self._split_key(content, where)
            key = self.value(key_text, where) if key_text[:1] in "'\"" else _plain(key_text, where)
            anchor = None
            if rest.startswith("&"):
                anchor, _, rest = rest[1:].partition(" ")
                if not _ANCHOR.fullmatch(anchor):
                    raise ValueError(f"{where}: bad anchor &{anchor}")
                rest = rest.strip()
            i += 1
            if rest:
                val = self.value(rest, where)
            elif i < len(self.lines) and self.lines[i][2] == "-" and self.lines[i][1] >= indent:
                val, i = self.sequence(i, self.lines[i][1])
            elif i < len(self.lines) and self.lines[i][1] > indent:
                val, i = self.mapping(i, self.lines[i][1])
            else:
                val = None
            if anchor is not None:
                self.anchors[anchor] = val
            out[key] = val
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[List, int]:
        """A block sequence whose items are mappings."""
        out: List = []
        while i < len(self.lines) and self.lines[i][1:] == (indent, "-"):
            n = self.lines[i][0]
            i += 1
            if i >= len(self.lines) or self.lines[i][1] <= indent:
                raise ValueError(f"{self.name}:{n}: an empty sequence item is outside the "
                                 "supported YAML subset")
            if re.search(r":(?: |$)", self.lines[i][2]) is None:
                raise ValueError(f"{self.name}:{n}: a sequence of scalars is outside the "
                                 "supported YAML subset")
            item, i = self.mapping(i, self.lines[i][1])
            out.append(item)
        return out, i

    @staticmethod
    def _split_key(content: str, where: str) -> Tuple[str, str]:
        if content[:1] in ("'", '"'):
            _, tail = _quoted(content, where)
            key_text = content[: len(content) - len(tail)]
            rest = tail
            if not (rest == ":" or rest.startswith(": ")):
                raise ValueError(f"{where}: expected 'key: value'")
            return key_text, rest[1:].strip()
        m = re.search(r":(?: |$)", content)
        if m is None:
            raise ValueError(f"{where}: expected 'key: value' (outside the supported YAML subset)")
        return content[: m.start()].rstrip(), content[m.end():].strip()


def loads(text: str, name: str = "<yaml>") -> Optional[Dict]:
    """Parse a document of the supported subset; ``None`` when empty."""
    reader = _Reader(text, name)
    if not reader.lines:
        return None
    first_indent = reader.lines[0][1]
    out, i = reader.mapping(0, first_indent)
    if i != len(reader.lines):
        n = reader.lines[i][0]
        raise ValueError(f"{name}:{n}: unexpected indentation")
    return out


def load_config(path: str) -> Dict:
    with open(path) as f:
        return loads(f.read(), path)


def parse_scalar(value: str):
    """CLI override value -> config value, as ``yaml.safe_load`` would read
    it, then a bare ``1e-3`` as a float (the reference's fallback)."""
    parsed = _Reader("", "<override>").value(value.strip(), "<override>")
    if isinstance(parsed, str):
        try:
            return float(parsed)
        except ValueError:
            return parsed
    return parsed


def set_by_path(tree: Dict, keypath: str, value: str) -> None:
    """``set_by_path(cfg, 'a;b;c', 'v')`` -> ``cfg['a']['b']['c'] = v``
    (``v`` parsed by :func:`parse_scalar`); missing intermediate mappings
    are created."""
    keys = keypath.split(";")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = parse_scalar(value)


def apply_overrides(config: Dict, overrides: Sequence[str]) -> Dict:
    """Apply ``key;path=value`` strings in order (later wins)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not of the form key;path=value")
        keypath, value = ov.split("=", 1)
        set_by_path(config, keypath, value)
    return config


class RunConfig:
    """Effective config + run directories of one training run:
    ``<output>/models/<experiment>/<runid>`` (checkpoints, the effective
    ``config.yml``) and ``<output>/logs/<experiment>/<runid>``. Under data
    parallelism every process makes the directories and only the main one
    (``is_main``) writes ``config.yml``. Making them also sets up the
    logging (:func:`~esr_tpu_torch.utils.logging.setup_logging`): the
    console, and ``<log_dir>/info.txt``; a process that is not the main one
    logs WARNING and above only."""

    def __init__(self, config: Dict, runid: Optional[str] = None,
                 resume: Optional[str] = None, reset: bool = False, seed: int = 123,
                 make_dirs: bool = True, is_main: bool = True):
        self.config = config
        self.resume = resume
        self.reset = reset
        self.seed = seed
        self.runid = runid or datetime.now().strftime(r"%m%d_%H%M%S")
        out = config["trainer"]["output_path"]
        exp = config["experiment"]
        self.save_dir = os.path.join(out, "models", exp, self.runid)
        self.log_dir = os.path.join(out, "logs", exp, self.runid)
        if make_dirs:
            os.makedirs(self.save_dir, exist_ok=True)
            os.makedirs(self.log_dir, exist_ok=True)
            if is_main:
                with open(os.path.join(self.save_dir, "config.yml"), "w") as f:
                    f.write(to_yaml(config))
            setup_logging(self.log_dir, is_main=is_main)

    @classmethod
    def from_args(cls, config_path: str, overrides: Sequence[str] = (),
                  runid: Optional[str] = None, resume: Optional[str] = None,
                  reset: bool = False, seed: int = 123,
                  make_dirs: bool = True, is_main: bool = True) -> "RunConfig":
        config = apply_overrides(load_config(config_path), overrides)
        return cls(config, runid, resume, reset, seed, make_dirs, is_main)

    def __getitem__(self, name: str):
        return self.config[name]

    def get(self, name: str, default=None):
        return self.config.get(name, default)
