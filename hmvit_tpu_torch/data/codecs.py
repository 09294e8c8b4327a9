"""File codecs of the dataset, on the standard library and numpy only: PNG
(over ``zlib`` and ``struct``) and the YAML subset the OPV2V frame files
use.  The JAX package reads and writes these files with OpenCV and
PyYAML; the port's data path needs neither, nor Pillow.

PNG: :func:`write_png` writes 8-bit grey or RGB with filter 0 on every
row; :func:`read_png` reads 8-bit grey, grey + alpha, RGB and RGBA, not
interlaced, with any of the five row filters (so it also reads what
``cv2.imwrite`` writes).  Pixels come back in the file's channel order
(RGB), not OpenCV's BGR.  :func:`resize_bilinear` is ``cv2.resize``'s
``INTER_LINEAR`` (half-pixel centres, edge clamp) in float64, rounded to
uint8: it may differ from OpenCV's fixed-point weights by one grey level.

YAML: :func:`yaml_dump` writes what PyYAML's ``safe_dump`` writes for
nested mappings (int and str keys, sorted unless ``sort_keys=False``),
lists, floats, ints, bools, null and strings, in block style, with
PyYAML's anchors and aliases for a list or dict held more than once.
:func:`yaml_load` reads that block style,
one-line flow sequences and mappings, quoted strings, comments and the
``!!python/tuple`` tag, and resolves plain scalars as PyYAML's
``SafeLoader`` does (YAML 1.1: ``yes`` is true, ``1e5`` is a string).
``yaml_load(..., hypes=True)`` reads the model configurations
("hypes") as the JAX package's config loader does: anchors (``&name``
before a value) and aliases (``*name`` as a whole value, the anchored
object itself, shared as PyYAML shares it) are read too, and a plain
scalar that is neither null, bool nor int is a float also with an
unsigned exponent or none but an exponent (``2e-4``, ``1.0e5``).
Anything else (anchors and aliases outside hypes, aliases inside a flow,
merge keys ``<<``, other tags, block scalars, multi-line scalars or
flows, octal, hex, sexagesimal or underscored numbers, timestamps,
several documents) raises :class:`YamlSubsetError` naming it.
"""
from __future__ import annotations

import math
import re
import struct
import zlib

import numpy as np

# -- PNG -------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, at bit depth 8
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W) grey or (H, W, 3) RGB uint8 image."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png: uint8 images only, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"write_png: (H, W) or (H, W, 3), got {img.shape}")
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 a row
    rows[:, 1:] = img.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One PNG scanline's filter undone (row, prev: uint8 of one row)."""
    if kind == 0:
        return row
    if kind == 2:  # Up
        return row + prev
    if kind == 1:  # Sub: a running sum per channel, mod 256
        sums = np.cumsum(row.reshape(-1, bpp).astype(np.int64), axis=0)
        return (sums % 256).astype(np.uint8).reshape(-1)
    # Average and Paeth depend on the reconstructed left neighbour
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    n = len(out)
    if kind == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    elif kind == 4:
        for i in range(n):
            if i >= bpp:
                a, c = out[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG: unknown row filter {kind}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced PNG -> (H, W, C) uint8 in the file's
    channel order (C = 1 grey, 2 grey + alpha, 3 RGB, 4 RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit grey / grey + alpha / RGB / "
                         f"RGBA, not interlaced, is read (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 1 + w * c
    if raw.size != h * stride:
        raise ValueError(f"{path}: {raw.size} bytes of pixel data for "
                         f"{h} x {stride}")
    raw = raw.reshape(h, stride)
    kinds = raw[:, 0]
    if not kinds.any():
        return raw[:, 1:].reshape(h, w, c).copy()
    out = np.empty((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(kinds[y]), raw[y, 1:], prev, c)
    return out.reshape(h, w, c)


def read_rgb(path: str) -> np.ndarray:
    """A PNG as OpenCV reads it in colour, in RGB order (``cv2.imread`` ->
    ``COLOR_BGR2RGB``): (H, W, 3) uint8, a grey file replicated to three
    channels, an alpha channel dropped."""
    img = read_png(path)
    if img.shape[2] < 3:
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return img[:, :, :3]


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """(H, W, C) uint8 -> (size, size, C), or (h, w, C) for ``size = (h,
    w)``, uint8 by ``cv2.resize``'s ``INTER_LINEAR`` sampling; the image
    itself when it has that size."""
    out_h, out_w = (size, size) if np.ndim(size) == 0 else size
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img

    def taps(n_in, n_out):
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        x0 = np.floor(x)
        frac = x - x0
        x0 = x0.astype(np.int64)
        frac = np.where(x0 < 0, 0.0, frac)
        x0 = np.clip(x0, 0, n_in - 1)
        frac = np.where(x0 >= n_in - 1, 0.0, frac)
        return x0, np.minimum(x0 + 1, n_in - 1), frac

    y0, y1, fy = taps(h, out_h)
    x0, x1, fx = taps(w, out_w)
    f = img.astype(np.float64)
    rows = (f[y0] * (1.0 - fy)[:, None, None] + f[y1] * fy[:, None, None])
    out = (rows[:, x0] * (1.0 - fx)[None, :, None]
           + rows[:, x1] * fx[None, :, None])
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def grey_of(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 grey by OpenCV's 8-bit
    ``COLOR_BGR2GRAY``: fixed point with 15 fraction bits, ``(R 9798 +
    G 19235 + B 3735 + 16384) >> 15`` (the 14-bit ``(R 4899 + G 9617 +
    B 1868 + 8192) >> 14`` of OpenCV's 16-bit path is one lower on about
    a quarter of a percent of 8-bit pixels)."""
    c = rgb.astype(np.int32)  # at most 255 * 32768 + 16384
    grey = (c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
            + 16384) >> 15
    return grey.astype(np.uint8)


def read_grey(path: str) -> np.ndarray:
    """A PNG as OpenCV reads it in colour and turns it grey
    (``cv2.imread`` -> ``cv2.cvtColor(..., COLOR_BGR2GRAY)``): a grey
    file replicated to three channels, an alpha channel dropped, then
    :func:`grey_of`."""
    return grey_of(read_rgb(path))


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, ...) -> (size, size, ...) by ``cv2.resize``'s
    ``INTER_NEAREST`` sampling: source index ``floor(i * (1 / (size /
    n)))`` in double precision, at most n - 1 (not ``i * n // size``:
    where ``i * n / size`` is an integer the double quotient may round
    below it)."""
    def index(n):
        inv = 1.0 / (size / n)
        return np.minimum(np.floor(np.arange(size) * inv).astype(np.int64),
                          n - 1)

    return img[index(img.shape[0])][:, index(img.shape[1])]


# -- YAML subset ------------------------------------------------------------


class YamlSubsetError(ValueError):
    """A YAML construct outside the subset :func:`yaml_load` reads."""


_TUPLE_TAG = "!!python/tuple"
_NULLS = {"", "~", "null", "Null", "NULL"}
_BOOLS = {w: v for v, words in (
    (True, "yes Yes YES true True TRUE on On ON"),
    (False, "no No NO false False FALSE off Off OFF"))
    for w in words.split()}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# the JAX config loader's float resolver, tried after the YAML 1.1 ones
# (its underscored and sexagesimal forms stay outside the subset)
_HYPES_FLOAT = re.compile(
    r"(?:[-+]?[0-9]+\.[0-9]*(?:[eE][-+]?[0-9]+)?|[-+]?[0-9]+[eE][-+]?[0-9]+)$")
# plain scalars PyYAML resolves to a type this reader does not take:
# binary, octal, hex, sexagesimal and underscored numbers, timestamps,
# the merge key and the value key
_OUTSIDE = [
    (re.compile(r"[-+]?0b[0-1_]+$"), "a binary integer"),
    (re.compile(r"[-+]?0[0-7_]+$"), "an octal integer"),
    (re.compile(r"[-+]?0x[0-9a-fA-F_]+$"), "a hexadecimal integer"),
    (re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"),
     "a sexagesimal number"),
    (re.compile(r"[-+]?[0-9_]*_[0-9_]*(?:\.[0-9_]*)?(?:[eE][-+][0-9]+)?$"),
     "a number with underscores"),
    (re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}"), "a timestamp"),
    (re.compile(r"(?:<<|=)$"), "a merge or value key"),
]


def _resolve_plain(text: str, where: str, hypes: bool = False):
    """A plain scalar's value, by PyYAML's YAML 1.1 resolver (with the
    config loader's float pattern after it when ``hypes``)."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if hypes and _HYPES_FLOAT.match(text):
        return float(text)
    m = _INF.match(text)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    for pattern, what in _OUTSIDE:
        if pattern.match(text) and any(ch.isdigit() or ch in "<=" for ch in
                                       text):
            raise YamlSubsetError(f"{where}: {text!r} is {what}, outside "
                                  f"the YAML subset read here")
    if text[0] in "&*!|>%@`?{}[],#'\"":
        raise YamlSubsetError(f"{where}: the plain scalar {text!r} starts "
                              f"with an indicator outside the subset")
    return text


def _quoted(text: str, where: str) -> str:
    """The value of a whole single- or double-quoted scalar."""
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise YamlSubsetError(f"{where}: unterminated quoted scalar {text!r}")
    body = text[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise YamlSubsetError(f"{where}: stray quote in {text!r}")
        return body.replace("''", "'")
    out, i = [], 0
    escapes = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t",
               "r": "\r", "0": "\0"}
    while i < len(body):
        ch = body[i]
        if ch == '"':
            raise YamlSubsetError(f"{where}: stray quote in {text!r}")
        if ch == "\\":
            nxt = body[i + 1:i + 2]
            if nxt in escapes:
                out.append(escapes[nxt])
                i += 2
                continue
            if nxt in ("x", "u"):
                n = 2 if nxt == "x" else 4
                out.append(chr(int(body[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            raise YamlSubsetError(f"{where}: escape \\{nxt} outside the "
                                  f"subset")
        out.append(ch)
        i += 1
    return "".join(out)


def _scalar(text: str, where: str, hypes: bool = False):
    text = text.strip()
    if text[:1] in ("'", '"'):
        return _quoted(text, where)
    return _resolve_plain(text, where, hypes)


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a ``#`` at the start or after
    a space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " -[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(content: str):
    """(key text, rest) of a ``key: value`` entry, or None."""
    quote = None
    depth = 0
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"" and i == 0:
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif (ch == ":" and depth == 0
              and (i + 1 == len(content) or content[i + 1] == " ")):
            return content[:i], content[i + 1:].strip()
    return None


def _flow(text: str, where: str, hypes: bool = False):
    """A one-line flow sequence or mapping of scalars or flows."""
    pos = 0

    def skip():
        nonlocal pos
        while pos < len(text) and text[pos] == " ":
            pos += 1

    def item(stop):
        nonlocal pos
        skip()
        if pos >= len(text):
            raise YamlSubsetError(f"{where}: unterminated or multi-line "
                                  f"flow collection {text!r}")
        if text[pos] in "[{":
            return node()
        start = pos
        quote = text[pos] if text[pos] in "'\"" else None
        pos += 1 if quote else 0
        while pos < len(text):
            ch = text[pos]
            if quote:
                if ch == quote:
                    if quote == "'" and text[pos + 1:pos + 2] == "'":
                        pos += 1  # an escaped quote
                    else:
                        quote = None
            elif ch in stop:
                break
            pos += 1
        return text[start:pos].strip()

    def node():
        nonlocal pos
        opener = text[pos]
        closer = "]" if opener == "[" else "}"
        pos += 1
        out = [] if opener == "[" else {}
        skip()
        if pos < len(text) and text[pos] == closer:
            pos += 1
            return out
        while True:
            if opener == "[":
                raw = item(",]")
                out.append(raw if not isinstance(raw, str)
                           else _scalar(raw, where, hypes))
            else:
                raw = item(":,}")
                if pos >= len(text) or text[pos] != ":":
                    raise YamlSubsetError(f"{where}: flow mapping entry "
                                          f"without ': ' in {text!r}")
                pos += 1
                val = item(",}")
                out[_scalar(raw, where, hypes)] = (
                    val if not isinstance(val, str)
                    else _scalar(val, where, hypes))
            skip()
            if pos >= len(text):
                raise YamlSubsetError(f"{where}: unterminated or multi-line "
                                      f"flow collection {text!r}")
            if text[pos] == closer:
                pos += 1
                return out
            if text[pos] != ",":
                raise YamlSubsetError(f"{where}: unexpected {text[pos]!r} "
                                      f"in flow collection {text!r}")
            pos += 1

    value = node()
    skip()
    if pos != len(text):
        raise YamlSubsetError(f"{where}: text after a flow collection: "
                              f"{text!r}")
    return value


class _Lines:
    """The document's content lines as (line number, indent, text), and
    the reading's mode (``hypes``) and anchors."""

    def __init__(self, source: str, hypes: bool = False):
        self.hypes = hypes
        self.anchors = {}
        self.items = []
        started = False
        for no, raw in enumerate(source.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip(" \t"))]:
                raise YamlSubsetError(f"line {no}: tab indentation")
            line = _strip_comment(raw)
            if not line.strip():
                continue
            if line.startswith("%"):
                raise YamlSubsetError(f"line {no}: directives are outside "
                                      f"the subset")
            if line.rstrip() in ("---", "..."):
                if started or line.rstrip() == "...":
                    raise YamlSubsetError(f"line {no}: several documents "
                                          f"are outside the subset")
                continue
            started = True
            indent = len(line) - len(line.lstrip(" "))
            self.items.append([no, indent, line.strip()])


def _inline(text: str, lines: _Lines, i: int, indent: int, where: str,
            seq_ok_at_indent: bool):
    """The value written after ``key:`` or ``- `` on line i: (value, the
    next line's index)."""
    tag = None
    if text.startswith("!"):
        tag, _, text = text.partition(" ")
        if tag != _TUPLE_TAG:
            raise YamlSubsetError(f"{where}: the tag {tag} is outside the "
                                  f"subset (only {_TUPLE_TAG})")
        text = text.strip()
    anchor = None
    if text[:1] in ("&", "*") and not lines.hypes:
        raise YamlSubsetError(f"{where}: anchors and aliases are outside "
                              f"the subset (they are read in hypes only)")
    if text[:1] == "*":
        name = text[1:]
        if tag is not None or not re.fullmatch(r"[^\s\[\]{},]+", name):
            raise YamlSubsetError(f"{where}: an alias is read only as a "
                                  f"whole value, got {text!r}")
        if name not in lines.anchors:
            raise YamlSubsetError(f"{where}: alias *{name} of no anchor")
        nxt = i + 1
        if nxt < len(lines.items) and lines.items[nxt][1] > indent:
            raise YamlSubsetError(f"line {lines.items[nxt][0]}: a node "
                                  f"after an alias")
        return lines.anchors[name], nxt
    if text[:1] == "&":
        anchor, _, text = text[1:].partition(" ")
        text = text.strip()
        if not anchor or text[:1] in ("&", "*", "!"):
            raise YamlSubsetError(f"{where}: an anchor is read only before "
                                  f"an untagged value")
    if text[:1] in ("|", ">"):
        raise YamlSubsetError(f"{where}: block scalars are outside the "
                              f"subset")
    if text:
        value = (_flow(text, where, lines.hypes) if text[0] in "[{"
                 else _scalar(text, where, lines.hypes))
        nxt = i + 1
    else:
        value, nxt = None, i + 1
        if nxt < len(lines.items):
            _, ind, content = lines.items[nxt]
            seq_here = (seq_ok_at_indent and ind == indent
                        and (content == "-" or content.startswith("- ")))
            if ind > indent or seq_here:
                value, nxt = _node(lines, nxt, ind)
    if nxt < len(lines.items) and lines.items[nxt][1] > indent and text:
        raise YamlSubsetError(f"line {lines.items[nxt][0]}: multi-line "
                              f"scalars are outside the subset")
    if tag is not None:
        if not isinstance(value, list):
            raise YamlSubsetError(f"{where}: {_TUPLE_TAG} on a non-sequence")
        value = tuple(value)
    if anchor is not None:
        lines.anchors[anchor] = value
    return value, nxt


def _node(lines: _Lines, i: int, indent: int):
    """The block node whose first line is i, at column ``indent``."""
    no, ind, content = lines.items[i]
    if content == "-" or content.startswith("- "):
        out = []
        while i < len(lines.items):
            no, ind, content = lines.items[i]
            if ind != indent or not (content == "-"
                                     or content.startswith("- ")):
                break
            rest = content[1:].lstrip(" ")
            inner = indent + len(content) - len(rest)
            where = f"line {no}"
            if rest and (rest == "-" or rest.startswith("- ")
                         or (_split_key(rest) is not None
                             and rest[0] not in "[{")):
                # a compact nested node: its first line is this one's rest
                lines.items[i] = [no, inner, rest]
                value, i = _node(lines, i, inner)
            else:
                value, i = _inline(rest, lines, i, indent, where, False)
            out.append(value)
        return out, i
    if _split_key(content) is None:
        value, nxt = _inline(content, lines, i, indent - 1, f"line {no}",
                             False)
        return value, nxt
    out = {}
    while i < len(lines.items):
        no, ind, content = lines.items[i]
        if ind != indent:
            break
        split = _split_key(content)
        if split is None:
            raise YamlSubsetError(f"line {no}: expected 'key: value' at "
                                  f"column {indent}, got {content!r}")
        key_text, rest = split
        if key_text.startswith("?"):
            raise YamlSubsetError(f"line {no}: complex keys are outside "
                                  f"the subset")
        key = _scalar(key_text, f"line {no}", lines.hypes)
        if key in out:
            raise YamlSubsetError(f"line {no}: duplicate key {key!r}")
        out[key], i = _inline(rest, lines, i, indent, f"line {no}", True)
    return out, i


def yaml_load(source: str, hypes: bool = False):
    """Parse a YAML document of the subset (module docstring); ``hypes``
    reads a model configuration (anchors, aliases, the config floats)."""
    lines = _Lines(source, hypes)
    if not lines.items:
        return None
    value, i = _node(lines, 0, lines.items[0][1])
    if i != len(lines.items):
        no, ind, content = lines.items[i]
        raise YamlSubsetError(f"line {no}: unexpected {content!r} at column "
                              f"{ind}")
    return value


def yaml_load_file(path: str, hypes: bool = False):
    with open(path) as f:
        return yaml_load(f.read(), hypes)


def _dump_scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        try:
            plain = (value == value.strip() and value
                     and not re.search(r": |:$| #|[\n'\"]", value)
                     and _resolve_plain(value, "") == value
                     and _resolve_plain(value, "", hypes=True) == value)
        except YamlSubsetError:
            plain = False
        return value if plain else "'" + value.replace("'", "''") + "'"
    raise TypeError(f"yaml_dump: cannot write {type(value).__name__}")


class _Dumper:
    """The block lines of one :func:`yaml_dump` call.  A list or dict
    that the value holds more than once (by identity) is written as
    PyYAML writes it: an anchor ``&idNNN`` where it first appears and an
    alias ``*idNNN`` after.  The numbers follow PyYAML's
    ``Serializer.anchor_node``: a walk over the value in writing order
    numbers a node when it meets the node the second time."""

    def __init__(self, root: dict, sort_keys: bool):
        self.sort_keys = sort_keys
        self.out: list = []
        self.emitted: set = set()
        self.anchors = self._number(root)

    def keys(self, mapping: dict) -> list:
        if self.sort_keys:
            try:
                return sorted(mapping)
            except TypeError:
                pass
        return list(mapping)

    def _number(self, root) -> dict:
        seen: dict = {}  # id -> None, or the anchor once met twice
        count = 0

        def visit(node):
            nonlocal count
            if not isinstance(node, (dict, list)):
                return
            if id(node) in seen:
                if seen[id(node)] is None:
                    count += 1
                    seen[id(node)] = f"id{count:03d}"
                return
            seen[id(node)] = None
            for child in ([node[k] for k in self.keys(node)]
                          if isinstance(node, dict) else node):
                visit(child)

        visit(root)
        return {k: v for k, v in seen.items() if v is not None}

    def block(self, value, indent: int, in_seq: bool):
        """Append the block lines of a non-scalar ``value``."""
        pad = " " * indent
        if isinstance(value, dict):
            for n, key in enumerate(self.keys(value)):
                lead = pad if not (in_seq and n == 0) else ""
                self.entry(lead + _dump_scalar(key) + ":", value[key],
                           indent, mapping=True)
        else:
            for n, item in enumerate(value):
                lead = pad if not (in_seq and n == 0) else ""
                self.entry(lead + "-", item, indent, mapping=False)

    def entry(self, head: str, value, indent: int, mapping: bool):
        out = self.out
        if not isinstance(value, (dict, list)):
            out.append(f"{head} {_dump_scalar(value)}")
            return
        anchor = self.anchors.get(id(value))
        if anchor is not None:
            if id(value) in self.emitted:
                out.append(f"{head} *{anchor}")
                return
            self.emitted.add(id(value))
            head = f"{head} &{anchor}"
        if len(value) == 0:
            out.append(f"{head} " + ("{}" if isinstance(value, dict)
                                     else "[]"))
        elif mapping or anchor is not None:
            out.append(head)
            # PyYAML writes a mapping's sequence at the key's own column
            nested = mapping and isinstance(value, list)
            self.block(value, indent if nested else indent + 2, False)
        else:
            out.append(head + " ")
            self.block(value, indent + 2, True)
            _join_compact(out, head)


def _join_compact(out: list, head: str):
    """Join a ``- `` line with the first line of the node written after
    it (``- - 1.0``, ``- key: value``)."""
    idx = len(out) - 1
    while out[idx] != head + " ":
        idx -= 1
    out[idx:idx + 2] = [head + " " + out[idx + 1]]


def yaml_dump(value: dict, sort_keys: bool = True) -> str:
    """Block-style YAML of a mapping (module docstring); ``sort_keys``
    as PyYAML's (False: insertion order)."""
    if not isinstance(value, dict):
        raise TypeError("yaml_dump: a mapping at the top level")
    dumper = _Dumper(value, sort_keys)
    dumper.block(value, 0, False)
    return "\n".join(dumper.out) + "\n"
