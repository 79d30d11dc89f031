"""TFRecord IO: pure-Python codec, no TensorFlow dependency.

Parity with the reference's tfrecords datasource
(`python/ray/data/datasource/tfrecords_datasource.py`, which imports
tensorflow): the wire format is implemented directly — length-delimited
records with masked CRC32C framing, and a hand-rolled encoder/decoder for
the stable `tf.train.Example` protobuf schema (features: map<string,
Feature>; Feature: oneof {bytes_list, float_list, int64_list}).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

import numpy as np

# ------------------------------------------------------------------ crc32c

_CRC_TABLE: List[int] = []


def _make_table() -> None:
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------- record frame


def write_records(path: str, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        for rec in records:
            hdr = struct.pack("<Q", len(rec))
            f.write(hdr)
            f.write(struct.pack("<I", _masked_crc(hdr)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


def read_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return
            (length,) = struct.unpack("<Q", hdr)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(hdr):
                raise ValueError(f"{path}: corrupt length header")
            rec = f.read(length)
            (rcrc,) = struct.unpack("<I", f.read(4))
            if rcrc != _masked_crc(rec):
                raise ValueError(f"{path}: corrupt record payload")
            yield rec


# --------------------------------------------------- tf.train.Example codec
# Minimal protobuf wire codec for the fixed Example schema:
#   Example{ features: Features=1 }  Features{ feature: map<str,Feature>=1 }
#   Feature{ bytes_list=1 | float_list=2 | int64_list=3 }
#   BytesList{ value: repeated bytes=1 }   FloatList{ value: repeated float=1 }
#   Int64List{ value: repeated int64=1 }


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _len_field(field_no: int, payload: bytes) -> bytes:
    return _varint(field_no << 3 | 2) + _varint(len(payload)) + payload


def _encode_feature(values: Any) -> bytes:
    arr = np.asarray(values)
    if arr.dtype.kind in ("S", "U", "O") or isinstance(values, (bytes, str)):
        items = values if isinstance(values, (list, tuple, np.ndarray)) else [values]
        payload = b"".join(
            _len_field(1, v.encode() if isinstance(v, str) else bytes(v))
            for v in items)
        return _len_field(1, payload)  # bytes_list
    if arr.dtype.kind == "f":
        payload = _varint(1 << 3 | 2) + _varint(4 * arr.size) + \
            arr.astype("<f4").tobytes()  # packed floats
        return _len_field(2, payload)
    payload = b"".join(_varint(1 << 3 | 0) + _varint(int(v) & (2**64 - 1))
                       for v in arr.reshape(-1))
    return _len_field(3, payload)  # int64_list


def encode_example(features: Dict[str, Any]) -> bytes:
    feats = b""
    for name, values in features.items():
        key = _len_field(1, name.encode())
        val = _len_field(2, _encode_feature(values))
        feats += _len_field(1, key + val)  # map entry
    return _len_field(1, feats)  # Example.features


def _decode_feature(buf: bytes):
    tag, pos = _read_varint(buf, 0)
    field = tag >> 3
    ln, pos = _read_varint(buf, pos)
    payload = buf[pos:pos + ln]
    if field == 1:  # bytes_list
        out = []
        p = 0
        while p < len(payload):
            _, p = _read_varint(payload, p)   # tag (field 1, wire 2)
            sz, p = _read_varint(payload, p)
            out.append(payload[p:p + sz])
            p += sz
        return out
    if field == 2:  # float_list (packed or unpacked)
        out = []
        p = 0
        while p < len(payload):
            t, p = _read_varint(payload, p)
            if t & 7 == 2:  # packed
                sz, p = _read_varint(payload, p)
                out.extend(np.frombuffer(payload, "<f4", sz // 4, p).tolist())
                p += sz
            else:  # single fixed32
                out.append(struct.unpack_from("<f", payload, p)[0])
                p += 4
        return np.asarray(out, np.float32)
    # int64_list
    out = []
    p = 0
    while p < len(payload):
        t, p = _read_varint(payload, p)
        if t & 7 == 2:  # packed
            sz, p = _read_varint(payload, p)
            end = p + sz
            while p < end:
                v, p = _read_varint(payload, p)
                out.append(v - 2**64 if v >= 2**63 else v)
        else:
            v, p = _read_varint(payload, p)
            out.append(v - 2**64 if v >= 2**63 else v)
    return np.asarray(out, np.int64)


def decode_example(data: bytes) -> Dict[str, Any]:
    # unwrap Example.features
    tag, pos = _read_varint(data, 0)
    assert tag >> 3 == 1, "not an Example"
    ln, pos = _read_varint(data, pos)
    feats = data[pos:pos + ln]
    out: Dict[str, Any] = {}
    p = 0
    while p < len(feats):
        _, p = _read_varint(feats, p)       # map-entry tag
        entry_len, p = _read_varint(feats, p)
        entry = feats[p:p + entry_len]
        p += entry_len
        ep = 0
        name, value = "", None
        while ep < len(entry):
            etag, ep = _read_varint(entry, ep)
            eln, ep = _read_varint(entry, ep)
            payload = entry[ep:ep + eln]
            ep += eln
            if etag >> 3 == 1:
                name = payload.decode()
            else:
                value = _decode_feature(payload)
        out[name] = value
    return out
