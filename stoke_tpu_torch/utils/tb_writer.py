"""TensorBoard event writer of the port, standard library only.

A copy of the JAX package's writer (``stoke_tpu/utils/tb_writer.py``), so
one run's event files are alike in both packages:

- **TFRecord framing**: ``[uint64 len][u32 masked_crc(len)][payload]
  [u32 masked_crc(payload)]`` per record, CRC32C (Castagnoli) with
  TensorFlow's mask rotation.
- **Event protobuf**, hand-encoded: ``Event{wall_time(1,double),
  step(2,varint), file_version(3,string) | summary(5,msg)}``;
  ``Summary{value(1,msg)}``; ``Summary.Value{tag(1,string),
  simple_value(2,float)}``.

Files are named ``events.out.tfevents.<ts>.<host>.<pid>`` under the log
dir, which TensorBoard's loader globs for. :func:`read_scalar_events`
reads one back (CRC-checked).
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

# --------------------------------------------------------------------------- #
# CRC32C (Castagnoli, reflected poly 0x82F63B78) + TF masking
# --------------------------------------------------------------------------- #

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# minimal protobuf wire encoding
# --------------------------------------------------------------------------- #


def _varint(n: int) -> bytes:
    # proto int64 convention: negatives encode as the 64-bit two's
    # complement (10-byte varint) — without the mask a negative n would
    # loop forever (-1 >> 7 == -1 in Python)
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _bytes_field(1, tag.encode("utf-8")) + _float_field(2, float(value))
    summary = _bytes_field(1, val)
    return (
        _double_field(1, wall_time)
        + _varint_field(2, int(step))
        + _bytes_field(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    return _double_field(1, wall_time) + _bytes_field(
        3, b"brain.Event:2"
    )


# --------------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------------- #


class TBEventWriter:
    """Append-only scalar event writer for one log directory.

    Drop-in for the ``add_scalar``/``flush``/``close`` subset of
    ``torch.utils.tensorboard.SummaryWriter`` the facade uses."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
            f".{os.getpid()}"
        )
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()
        self._write_record(_version_event(time.time()))
        self.flush()

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        with self._lock:
            self._f.write(header)
            self._f.write(struct.pack("<I", _masked_crc(header)))
            self._f.write(payload)
            self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float,
                   step: Optional[int] = None) -> None:
        self._write_record(
            _scalar_event(tag, value, step or 0, time.time())
        )

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def read_scalar_events(path: str):
    """Parse a TB event file back into ``[(tag, value, step), ...]`` —
    the verification half of the format contract (CRC-checked)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError(f"{path}: corrupt record header")
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError(f"{path}: corrupt record payload")
            out.extend(_parse_event(payload))
    return out


def _parse_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wt = key >> 3, key & 7
        if wt == 0:
            val = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wt == 1:
            val = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            val = buf[i:i + ln]
            i += ln
        elif wt == 5:
            val = buf[i:i + 4]
            i += 4
        else:  # pragma: no cover - not produced by this writer
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_event(payload: bytes):
    step = 0
    scalars = []
    for field, wt, val in _parse_fields(payload):
        if field == 2 and wt == 0:
            step = val
        elif field == 5 and wt == 2:  # summary
            for f2, w2, v2 in _parse_fields(val):
                if f2 == 1 and w2 == 2:  # value
                    tag, num = None, None
                    for f3, w3, v3 in _parse_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            (num,) = struct.unpack("<f", v3)
                    if tag is not None and num is not None:
                        scalars.append((tag, num, step))
    return scalars
