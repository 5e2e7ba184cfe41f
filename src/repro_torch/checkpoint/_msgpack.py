"""The subset of MessagePack the port's manifests and fabric messages
use, in pure Python.

``packb`` writes the bytes ``msgpack.packb`` writes with its defaults
(the shortest int, str, bin, array and map forms; float as float64; str
as UTF-8 with the str8 form; tuples as arrays). Like msgpack's default
``strict_types=False`` it packs subclasses of int, float, str, list,
tuple and dict as their base type (``np.float64`` is a float; an
``IntEnum`` member an int). ``unpackb`` reads them back as
``msgpack.unpackb`` does with its defaults (arrays as lists, str keys
only); ``strict_map_key=False`` also reads int and other hashable map
keys, as the fabric's wire needs. Maps, arrays, str, bytes, int, float,
bool and None are supported; anything else raises ``TypeError`` on
pack. Every malformed input raises ``ValueError`` on unpack: truncated
data, unknown type bytes, a key of the wrong type or an unhashable one,
nesting deeper than msgpack's 1024 containers, extra bytes. The port
keeps its own codec so that reading and writing the reference's
``manifest.msgpack`` and its fabric frames needs no package beyond the
standard library.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

_INT_FORMS = (  # (lowest, highest, prefix, struct format)
    (0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
    (0, 0xFFFFFFFF, 0xCE, ">I"), (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
    (-0x80, 0x7F, 0xD0, ">b"), (-0x8000, 0x7FFF, 0xD1, ">h"),
    (-0x80000000, 0x7FFFFFFF, 0xD2, ">i"),
    (-0x8000000000000000, 0x7FFFFFFFFFFFFFFF, 0xD3, ">q"),
)


def _int(v: int, out: List[bytes]):
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    for lo, hi, prefix, fmt in _INT_FORMS:
        if (v >= 0) == (lo == 0) and lo <= v <= hi:
            out.append(bytes([prefix]) + struct.pack(fmt, v))
            return
    raise OverflowError(f"integer {v} does not fit 64 bits")


def _header(n: int, fix: int, fix_max: int, forms, out: List[bytes]):
    """A length header: the fix form below ``fix_max``, else the first
    of ``forms`` ((limit, prefix, struct format)) that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for limit, prefix, fmt in forms:
        if n <= limit:
            out.append(bytes([prefix]) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} is too large for MessagePack")


_STR = ((0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"), (0xFFFFFFFF, 0xDB, ">I"))
_BIN = ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"), (0xFFFFFFFF, 0xC6, ">I"))
_ARRAY = ((0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I"))
_MAP = ((0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I"))


def _pack(obj: Any, out: List[bytes]):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", float(obj)))
    elif isinstance(obj, str):
        data = str.encode(obj, "utf-8")
        _header(len(data), 0xA0, 32, _STR, out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray)):
        _header(len(obj), None, 0, _BIN, out)
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, _ARRAY, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {  # prefix -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {  # prefix -> (kind, struct format of the length, its size)
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


# msgpack's unpacker holds at most this many open containers
MAX_DEPTH = 1024
# an open map's slot before its key is read
_NO_KEY = object()


def _take(buf: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(buf):
        raise ValueError("truncated MessagePack data")
    return buf[pos:pos + n], pos + n


def _head(buf: bytes, pos: int) -> Tuple[str, Any, int]:
    """One object's header at ``pos``: ("value", the object, next pos)
    for a scalar, ("array"/"map", its length, next pos) for a
    container."""
    head, pos = _take(buf, pos, 1)
    b = head[0]
    if b <= 0x7F:
        return "value", b, pos
    if b >= 0xE0:
        return "value", b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        return "array", b & 0x0F, pos
    elif 0x80 <= b <= 0x8F:
        return "map", b & 0x0F, pos
    elif b == 0xC0:
        return "value", None, pos
    elif b in (0xC2, 0xC3):
        return "value", b == 0xC3, pos
    elif b in _FIXED:
        fmt, size = _FIXED[b]
        raw, pos = _take(buf, pos, size)
        return "value", struct.unpack(fmt, raw)[0], pos
    elif b in _LENGTH:
        kind, fmt, size = _LENGTH[b]
        raw, pos = _take(buf, pos, size)
        n = struct.unpack(fmt, raw)[0]
        if kind in ("array", "map"):
            return kind, n, pos
    else:
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")
    raw, pos = _take(buf, pos, n)
    return "value", (raw.decode("utf-8") if kind == "str" else raw), pos


def _check_key(key: Any, strict_map_key: bool) -> None:
    if strict_map_key:
        if not isinstance(key, str):
            raise ValueError(f"map key {key!r}: only str keys are read")
        return
    try:
        hash(key)
    except TypeError:
        raise ValueError(f"map key of type {type(key).__name__} is "
                         f"unhashable") from None


def unpackb(buf: bytes, strict_map_key: bool = True) -> Any:
    """Read one MessagePack object that spans all of ``buf``; without
    ``strict_map_key`` map keys may be any hashable object."""
    buf = bytes(buf)
    # open containers: [list or dict, items still to read, key or _NO_KEY]
    stack: List[list] = []
    pos = 0
    while True:
        kind, obj, pos = _head(buf, pos)
        if kind != "value":
            if len(stack) >= MAX_DEPTH:
                raise ValueError(f"MessagePack data nests deeper than "
                                 f"{MAX_DEPTH} containers")
            if obj:
                stack.append([[] if kind == "array" else {}, obj, _NO_KEY])
                continue
            obj = [] if kind == "array" else {}
        # place the finished object; close every container it completes
        while stack:
            top = stack[-1]
            into = top[0]
            if isinstance(into, list):
                into.append(obj)
            elif top[2] is _NO_KEY:
                _check_key(obj, strict_map_key)
                top[2] = obj
                break                      # the value comes next
            else:
                into[top[2]] = obj
                top[2] = _NO_KEY
            top[1] -= 1
            if top[1]:
                break
            obj = stack.pop()[0]
        else:
            if pos != len(buf):
                raise ValueError(f"{len(buf) - pos} bytes of extra data "
                                 f"after the MessagePack object")
            return obj
