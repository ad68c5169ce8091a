"""Pure-Python TFRecord framing + tf.train.Example wire codec.

Fallback for environments without the native library; semantics match
native/tfrecord.cpp exactly (same format, same masked crc32c).
"""

from __future__ import annotations

import struct

# -- crc32c ------------------------------------------------------------------

_TABLE = []


def _crc_table():
    if _TABLE:
        return _TABLE
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (poly ^ (c >> 1)) if c & 1 else (c >> 1)
        _TABLE.append(c)
    return _TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- framing -----------------------------------------------------------------

def write_record(f, data: bytes):
    header = struct.pack("<Q", len(data))
    f.write(header)
    f.write(struct.pack("<I", masked_crc(header)))
    f.write(data)
    f.write(struct.pack("<I", masked_crc(data)))


def read_records(f):
    while True:
        header = f.read(12)
        if not header:
            return
        if len(header) != 12:
            raise IOError("truncated TFRecord header")
        (length,) = struct.unpack("<Q", header[:8])
        (lcrc,) = struct.unpack("<I", header[8:])
        if masked_crc(header[:8]) != lcrc:
            raise IOError("corrupt TFRecord length crc")
        data = f.read(length)
        if len(data) != length:
            raise IOError("truncated TFRecord data")
        tail = f.read(4)
        if len(tail) != 4:  # the JAX package's copy raises struct.error
            raise IOError("truncated TFRecord data crc")
        (dcrc,) = struct.unpack("<I", tail)
        if masked_crc(data) != dcrc:
            raise IOError("corrupt TFRecord data crc")
        yield data


# -- proto wire helpers ------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf, pos):
    r = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        r |= (b & 0x7F) << shift
        if not b & 0x80:
            return r, pos
        shift += 7


def _len_delim(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


# -- Example encode ----------------------------------------------------------

def encode_example(features: dict) -> bytes:
    """features: {name: (kind, values)} with kind in {'bytes','float','int64'}
    and values a list."""
    fmap = b""
    for name in sorted(features):
        kind, values = features[name]
        if kind == "int64":
            packed = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in values)
            feature = _len_delim(3, _len_delim(1, packed))
        elif kind == "float":
            packed = struct.pack(f"<{len(values)}f", *values)
            feature = _len_delim(2, _len_delim(1, packed))
        elif kind == "bytes":
            lst = b"".join(_len_delim(1, v) for v in values)
            feature = _len_delim(1, lst)
        else:
            raise ValueError(f"unknown feature kind {kind!r}")
        entry = _len_delim(1, name.encode()) + _len_delim(2, feature)
        fmap += _len_delim(1, entry)
    return _len_delim(1, fmap)


# -- Example decode ----------------------------------------------------------

_KINDS = {1: "bytes", 2: "float", 3: "int64"}


def decode_example(data: bytes) -> dict:
    """Returns {name: (kind, values)}."""
    out = {}
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        length, pos = _read_varint(data, pos)
        fend = pos + length
        if tag >> 3 == 1:  # Features
            q = pos
            while q < fend:
                etag, q = _read_varint(data, q)
                elen, q = _read_varint(data, q)
                eend = q + elen
                name, kind, values = None, None, []
                m = q
                while m < eend:
                    mtag, m = _read_varint(data, m)
                    mlen, m = _read_varint(data, m)
                    if mtag >> 3 == 1:
                        name = data[m:m + mlen].decode()
                    elif mtag >> 3 == 2:
                        kind, values = _decode_feature(data[m:m + mlen])
                    m += mlen
                if name is not None:
                    out[name] = (kind, values)
                q = eend
        pos = fend
    return out


def _decode_feature(buf: bytes):
    pos = 0
    end = len(buf)
    kind = None
    values = []
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field = tag >> 3
        length, pos = _read_varint(buf, pos)
        lend = pos + length
        kind = _KINDS.get(field)
        q = pos
        while q < lend:
            vtag, q = _read_varint(buf, q)
            vwire = vtag & 7
            if field == 1:  # bytes
                blen, q = _read_varint(buf, q)
                values.append(buf[q:q + blen])
                q += blen
            elif field == 2:  # float: packed or single fixed32
                if vwire == 2:
                    blen, q = _read_varint(buf, q)
                    values.extend(struct.unpack(f"<{blen // 4}f", buf[q:q + blen]))
                    q += blen
                else:
                    values.extend(struct.unpack("<f", buf[q:q + 4]))
                    q += 4
            elif field == 3:  # int64: packed or single varint
                if vwire == 2:
                    blen, q = _read_varint(buf, q)
                    vend = q + blen
                    while q < vend:
                        v, q = _read_varint(buf, q)
                        values.append(v - (1 << 64) if v >= 1 << 63 else v)
                else:
                    v, q = _read_varint(buf, q)
                    values.append(v - (1 << 64) if v >= 1 << 63 else v)
        pos = lend
    return kind, values
