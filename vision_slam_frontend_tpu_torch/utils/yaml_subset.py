"""A reader and writer for the YAML the port meets, without PyYAML.

The port runs where PyYAML is not installed, and reads three kinds of YAML
file: the configs `FrontendConfig.save` writes (its own and the JAX
package's, which is `yaml.safe_dump` block style), and EuRoC's
`sensor.yaml`. This module reads that subset on every machine:

  - block mappings and block sequences by indentation, including sequences
    of sequences (`- - 1.0`) and sequences at their key's indentation;
  - flow sequences and mappings (`[a, b]`, `{k: v}`), which may span lines;
  - `#` comments, whole-line or trailing; `%` directives and `---`;
  - plain, single- and double-quoted scalars, resolved as `yaml.safe_load`
    resolves them (YAML 1.1: `true`/`yes`/`on`, `null`/`~`, ints in
    decimal, octal, hex, binary and base 60, floats only with a dot, `.inf`
    and `.nan`).

Anchors, aliases, tags, block scalars (`|`, `>`), multi-line plain scalars,
timestamps and several documents are refused with a ValueError. `dump`
writes block style with sorted keys, as `yaml.safe_dump` does, and formats
floats so that every YAML 1.1 reader reads them back as floats.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULL = ("~", "null", "Null", "NULL", "")
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")


class _Line:
    __slots__ = ("indent", "text", "number")

    def __init__(self, indent: int, text: str, number: int):
        self.indent, self.text, self.number = indent, text, number


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    """`line` without a trailing `# comment` (a `#` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
            elif ch == "\\" and quote == '"':
                continue
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _depth(text: str) -> int:
    """Open flow brackets in `text` (outside quotes)."""
    depth, quote = 0, None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _lines(text: str) -> List[_Line]:
    out: List[_Line] = []
    pending = None
    for number, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {number}: tab in indentation")
        body = _strip_comment(raw)
        if pending is not None:  # a flow collection spanning lines
            pending.text += " " + body.strip()
            if _depth(pending.text) <= 0:
                pending = None
            continue
        stripped = body.strip()
        if not stripped or (raw.startswith("%") and not out):
            continue
        if stripped in ("---", "..."):
            if out:
                raise ValueError(f"line {number}: several YAML documents are not supported")
            continue
        line = _Line(len(body) - len(body.lstrip()), stripped, number)
        out.append(line)
        if _depth(stripped) > 0:
            pending = line
    if pending is not None:
        raise ValueError(f"line {pending.number}: unterminated flow collection")
    return out


def _resolve(plain: str) -> Any:
    """A plain scalar as yaml.safe_load resolves it."""
    if plain in _NULL:
        return None
    if plain in _BOOL:
        return _BOOL[plain]
    if plain[0] in "&*!|>@`":
        raise ValueError(f"unsupported YAML construct {plain!r}")
    if _INT.match(plain):
        v = plain.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * _base60(v)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(plain):
        v = plain.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * float(_base60(v))
        return sign * float(v)
    if _TIMESTAMP.match(plain):
        raise ValueError(f"unsupported YAML timestamp {plain!r}")
    return plain


def _base60(v: str):
    parts = v.split(":")
    value = float(parts[-1]) if "." in parts[-1] else int(parts[-1])
    base = 1
    for part in reversed(parts[:-1]):
        base *= 60
        value += int(part) * base
    return value


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i]; returns (value, index after it)."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        ch = text[j]
        if q == "'" and ch == "'":
            if text[j + 1 : j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and ch == "\\":
            esc = text[j + 1 : j + 2]
            simple = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0", "r": "\r", " ": " "}
            if esc in simple:
                out.append(simple[esc])
                j += 2
            elif esc in ("x", "u", "U"):
                width = {"x": 2, "u": 4, "U": 8}[esc]
                out.append(chr(int(text[j + 2 : j + 2 + width], 16)))
                j += 2 + width
            else:
                raise ValueError(f"unsupported escape \\{esc} in {text!r}")
            continue
        if q == '"' and ch == '"':
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise ValueError(f"unterminated quoted scalar in {text!r}")


def _scalar(text: str) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, 0)
        if text[end:].strip():
            raise ValueError(f"text after a quoted scalar: {text!r}")
        return value
    return _resolve(text)


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """The flow node starting at text[i] (after spaces); returns (value, end)."""
    while i < len(text) and text[i] == " ":
        i += 1
    if text[i] in "[{":
        close = "]" if text[i] == "[" else "}"
        seq: list = []
        mapping: dict = {}
        i += 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i >= len(text):
                raise ValueError(f"unterminated flow collection {text!r}")
            if text[i] == close:
                return (seq if close == "]" else mapping), i + 1
            if close == "}":
                key, i = _flow(text, i)
                while text[i] == " ":
                    i += 1
                if text[i] != ":":
                    raise ValueError(f"expected ':' in flow mapping {text!r}")
                value, i = _flow(text, i + 1)
                mapping[key] = value
            else:
                value, i = _flow(text, i)
                seq.append(value)
            while i < len(text) and text[i] == " ":
                i += 1
            if i < len(text) and text[i] == ",":
                i += 1
    if text[i] in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",]}" and not (text[j] == ":" and text[j + 1 : j + 2] in (" ", "")):
        j += 1
    return _resolve(text[i:j].strip()), j


def _value(text: str) -> Any:
    """A value written on its key's or dash's line."""
    if text[0] in "[{":
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"text after a flow collection: {text!r}")
        return value
    if text[0] in "|>":
        raise ValueError(f"block scalars are not supported: {text!r}")
    return _scalar(text)


def _split_key(text: str):
    """(key, rest) of a `key: value` or `key:` line, else None."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0)
        rest = text[end:]
        if rest.startswith(":") and rest[1:2] in (" ", ""):
            return key, rest[1:].strip()
        return None
    m = re.search(r":(?: |$)", text)
    if m is None or text[0] in "[{":
        return None
    return _resolve(text[: m.start()].strip()), text[m.end() :].strip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: List[_Line], i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at lines[i], at `indent`."""
    if _is_item(lines[i].text):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _nested(lines: List[_Line], i: int, indent: int, allow_same_indent_seq: bool) -> Tuple[Any, int]:
    """The node below a `key:` or `-` with nothing after it, at lines[i]."""
    if i < len(lines):
        nxt = lines[i]
        if nxt.indent > indent or (allow_same_indent_seq and nxt.indent == indent and _is_item(nxt.text)):
            return _block(lines, i, nxt.indent)
    return None, i


def _sequence(lines: List[_Line], i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines) and lines[i].indent == indent and _is_item(lines[i].text):
        line = lines[i]
        rest = line.text[1:].lstrip()
        if not rest:
            value, i = _nested(lines, i + 1, indent, allow_same_indent_seq=False)
        elif _is_item(rest) or _split_key(rest) is not None:
            # An inline block node: `- - x` or `- key: x`; its later lines sit
            # at the column where it starts.
            column = indent + (len(line.text) - len(rest))
            lines[i] = _Line(column, rest, line.number)
            value, i = _block(lines, i, column)
        else:
            value, i = _value(rest), i + 1
        out.append(value)
    if i < len(lines) and lines[i].indent > indent:
        raise ValueError(f"line {lines[i].number}: bad indentation")
    return out, i


def _mapping(lines: List[_Line], i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i].indent == indent and not _is_item(lines[i].text):
        line = lines[i]
        split = _split_key(line.text)
        if split is None:
            raise ValueError(f"line {line.number}: expected 'key: value', got {line.text!r}")
        key, rest = split
        if rest:
            value, i = _value(rest), i + 1
        else:
            value, i = _nested(lines, i + 1, indent, allow_same_indent_seq=True)
        out[key] = value
    if i < len(lines) and lines[i].indent > indent:
        raise ValueError(f"line {lines[i].number}: bad indentation")
    return out, i


def loads(text: str) -> Any:
    """The YAML document in `text` (None for an empty one)."""
    lines = _lines(text)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0].text) is None and not _is_item(lines[0].text):
        return _value(lines[0].text)
    value, i = _block(lines, 0, lines[0].indent)
    if i != len(lines):
        raise ValueError(f"line {lines[i].number}: unexpected {lines[i].text!r}")
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _plain_ok(s: str) -> bool:
    if not s or s != s.strip() or _resolve_safe(s) is not s:
        return False
    if s[0] in "-?:,[]{}#&*!|>'\"%@`" or ": " in s or " #" in s or s.endswith(":"):
        return False
    return all(ch.isprintable() for ch in s)


def _resolve_safe(s: str):
    try:
        return _resolve(s)
    except ValueError:
        return None


def _format_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return v if _plain_ok(v) else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _plain_python(v: Any) -> Any:
    """numpy scalars and arrays as Python numbers and lists."""
    if hasattr(v, "tolist") and not isinstance(v, (str, bytes)):
        return v.tolist()
    return v


def _dump(v: Any, indent: int, out: List[str], prefix: str) -> None:
    """Append `v` to `out`; `prefix` is what its first line starts with."""
    v = _plain_python(v)
    pad = " " * indent
    if isinstance(v, dict) and v:
        first = True
        for key in sorted(v):
            head = prefix if first else pad
            first = False
            val = _plain_python(v[key])
            k = _format_scalar(key)
            if isinstance(val, dict) and val:
                out.append(f"{head}{k}:")
                _dump(val, indent + 2, out, " " * (indent + 2))
            elif isinstance(val, (list, tuple)) and val:
                out.append(f"{head}{k}:")
                _dump(list(val), indent, out, pad)
            else:
                out.append(f"{head}{k}: {_inline(val)}")
    elif isinstance(v, (list, tuple)) and v:
        first = True
        for item in v:
            head = prefix if first else pad
            first = False
            item = _plain_python(item)
            if (isinstance(item, dict) or isinstance(item, (list, tuple))) and item:
                _dump(item, indent + 2, out, head + "- ")
            else:
                out.append(f"{head}- {_inline(item)}")
    else:
        out.append(prefix + _inline(v))


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _format_scalar(v)


def dumps(data: Any) -> str:
    """`data` (dicts, lists, str, int, float, bool, None; numpy values as
    Python's) as block-style YAML with sorted keys."""
    out: List[str] = []
    _dump(data, 0, out, "")
    return "\n".join(out) + "\n"


def dump(data: Any, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(data))
