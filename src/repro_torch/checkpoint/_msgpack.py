"""The part of MessagePack that checkpoint files use, as ``msgpack``'s
``packb`` (``use_bin_type=True``) writes it and its ``unpackb``
(``raw=False``, ``strict_map_key=False``) reads it: maps, str, bin,
integers and arrays. The JAX package writes its checkpoints with the
``msgpack`` package, which the port does not depend on; the bytes are the
same. Any other type raises ``TypeError``."""
from __future__ import annotations

import struct


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    the 8-/16-/32-bit forms in ``codes`` (None where the kind has none)
    that holds ``n``."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} exceeds 2**32 - 1")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: integer {v} out of range")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: integer {v} out of range")


def _pack(out: bytearray, v) -> None:
    if isinstance(v, bool) or v is None:
        raise TypeError(f"msgpack subset: {type(v).__name__} is not "
                        f"written by checkpoints")
    if isinstance(v, int):
        _int(out, v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _head(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _head(out, len(b), 0, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(v).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for maps, str, bin, integers and arrays."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.num(">B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c < 0x90:
            return self.map(c & 0x0F)
        if 0x90 <= c < 0xA0:
            return self.array(c & 0x0F)
        if 0xA0 <= c < 0xC0:
            return bytes(self.take(c & 0x1F)).decode("utf-8")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self.num(ints[c])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if c not in lengths:
            raise ValueError(f"msgpack subset: type byte {c:#04x} is not "
                             f"read by checkpoints")
        n = self.num(lengths[c])
        if c <= 0xC6:
            return bytes(self.take(n))
        if c <= 0xDB:
            return bytes(self.take(n)).decode("utf-8")
        return self.array(n) if c <= 0xDD else self.map(n)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes):
    """``msgpack.unpackb(data, strict_map_key=False)`` for what
    :func:`packb` writes."""
    r = _Reader(data)
    obj = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra data after the object")
    return obj
