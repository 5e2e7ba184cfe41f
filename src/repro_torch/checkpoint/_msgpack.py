"""The subset of MessagePack a checkpoint manifest uses, in pure Python.

``packb`` writes the bytes ``msgpack.packb`` writes with its defaults
(the shortest int, str, bin, array and map forms; float as float64; str
as UTF-8 with the str8 form; tuples as arrays), and ``unpackb`` reads
them back as ``msgpack.unpackb`` does with its defaults (arrays as
lists, str keys only). Maps, arrays, str, bytes, int, float, bool and
None are supported; anything else raises ``TypeError`` on pack and
``ValueError`` on unpack. The port keeps its own codec so that reading
and writing the reference's ``manifest.msgpack`` needs no package
beyond the standard library.
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
    elif type(obj) is int:
        _int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
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


def _take(buf: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(buf):
        raise ValueError("truncated MessagePack data")
    return buf[pos:pos + n], pos + n


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    head, pos = _take(buf, pos, 1)
    b = head[0]
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif b == 0xC0:
        return None, pos
    elif b in (0xC2, 0xC3):
        return b == 0xC3, pos
    elif b in _FIXED:
        fmt, size = _FIXED[b]
        raw, pos = _take(buf, pos, size)
        return struct.unpack(fmt, raw)[0], pos
    elif b in _LENGTH:
        kind, fmt, size = _LENGTH[b]
        raw, pos = _take(buf, pos, size)
        n = struct.unpack(fmt, raw)[0]
    else:
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")
    if kind in ("str", "bin"):
        raw, pos = _take(buf, pos, n)
        return (raw.decode("utf-8") if kind == "str" else raw), pos
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        if not isinstance(k, str):
            raise ValueError(f"map key {k!r}: only str keys are read")
        out[k], pos = _unpack(buf, pos)
    return out, pos


def unpackb(buf: bytes) -> Any:
    obj, pos = _unpack(bytes(buf), 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes of extra data after the "
                         f"MessagePack object")
    return obj
