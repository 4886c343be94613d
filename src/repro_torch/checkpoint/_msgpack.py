"""MessagePack for the checkpoint index, in pure Python.

The index of a checkpoint (``index.msgpack``) is written and read by the
JAX package with the ``msgpack`` module; the port keeps the format without
the module.  :func:`pack` gives the bytes ``msgpack.packb`` gives with its
defaults (``use_bin_type=True``: str as str, bytes as bin; each int in its
smallest encoding; a Python float as float64; maps in insertion order);
:func:`unpack` reads them back as ``msgpack.unpackb`` does with
``raw=False`` (str decoded, arrays as lists).  Only the types an index
holds are covered: maps, lists and tuples, str, bytes, int (up to 64 bits,
negative too), float, bool and None.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple


def pack(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(len(data), 0xA0, 32, b"\xd9", b"\xda", b"\xdb") + data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_header(len(data), None, 0, b"\xc4", b"\xc5", b"\xc6") + data)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, None, b"\xdc", b"\xdd"))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, None, b"\xde", b"\xdf"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -32 <= n < 0:
        return struct.pack("b", n)
    if n > 0:
        for code, fmt, hi in ((b"\xcc", ">B", 0xFF), (b"\xcd", ">H", 0xFFFF),
                              (b"\xce", ">I", 0xFFFFFFFF), (b"\xcf", ">Q", 2 ** 64 - 1)):
            if n <= hi:
                return code + struct.pack(fmt, n)
    else:
        for code, fmt, lo in ((b"\xd0", ">b", -2 ** 7), (b"\xd1", ">h", -2 ** 15),
                              (b"\xd2", ">i", -2 ** 31), (b"\xd3", ">q", -2 ** 63)):
            if n >= lo:
                return code + struct.pack(fmt, n)
    raise OverflowError("Integer value out of range")


def _header(n: int, fix, fix_limit: int, c8, c16, c32) -> bytes:
    if fix is not None and n < fix_limit:
        return struct.pack("B", fix | n)
    if c8 is not None and n <= 0xFF:
        return c8 + struct.pack(">B", n)
    if n <= 0xFFFF:
        return c16 + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return c32 + struct.pack(">I", n)
    raise ValueError(f"object of length {n} is too large to pack")


def unpack(data: bytes) -> Any:
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"extra data: {len(data) - pos} bytes after the object")
    return obj


_FIXED = {
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
    0xCA: ">f", 0xCB: ">d",
}
_LEN = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
        0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
        0xDC: (">H", "array"), 0xDD: (">I", "array"),
        0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(buf):
        raise ValueError("truncated MessagePack data")
    return buf[pos:pos + n], pos + n


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    head, pos = _take(buf, pos, 1)
    b = head[0]
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        return _body("str", b & 0x1F, buf, pos)
    if 0x90 <= b <= 0x9F:
        return _body("array", b & 0x0F, buf, pos)
    if 0x80 <= b <= 0x8F:
        return _body("map", b & 0x0F, buf, pos)
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], pos
    if b in _LEN:
        fmt, kind = _LEN[b]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        return _body(kind, struct.unpack(fmt, raw)[0], buf, pos)
    raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")


def _body(kind: str, n: int, buf: memoryview, pos: int) -> Tuple[Any, int]:
    if kind in ("str", "bin"):
        raw, pos = _take(buf, pos, n)
        return (bytes(raw).decode("utf-8") if kind == "str" else bytes(raw)), pos
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos
