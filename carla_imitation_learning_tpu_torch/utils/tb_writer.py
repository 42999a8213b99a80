"""Dependency-free TensorBoard scalar event writer (the JAX package's
``utils/tb_writer.py``; it imports neither torch nor tensorflow).

TensorBoard event files are TFRecords of serialized ``Event`` protos, and
scalars need three proto fields, so the varint and CRC code below writes
files that TensorBoard's loader reads directly.

Format notes:
- TFRecord framing: u64 length, masked crc32c(length), payload,
  masked crc32c(payload); mask(crc) = ((crc>>15 | crc<<17) + 0xa282ead8).
- Event proto: wall_time (double, field 1), step (int64, field 2),
  file_version (string, field 3, first record only), summary (field 5).
- Summary proto: repeated Value (field 1); Value: tag (string, field 1),
  simple_value (float, field 2).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78  # CRC-32C (Castagnoli), reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _scalar_value(tag: str, value: float) -> bytes:
    v = _len_delim(1, tag.encode()) + _key(2, 5) + struct.pack("<f", value)
    return _len_delim(1, v)  # Summary.value


def _event(wall_time: float, step: int | None = None, summary: bytes = b"",
           file_version: str | None = None) -> bytes:
    ev = _key(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        ev += _key(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        ev += _len_delim(3, file_version.encode())
    if summary:
        ev += _len_delim(5, summary)
    return ev


class TBEventWriter:
    """Minimal SummaryWriter-compatible scalar writer."""

    def __init__(self, log_dir: str | os.PathLike):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        fname = f"events.out.tfevents.{time.time():.6f}.{socket.gethostname()}"
        self._f = open(self.log_dir / fname, "ab", buffering=0)
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(time.time(), step=int(step),
                            summary=_scalar_value(tag, float(value))))

    def flush(self) -> None:
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except ValueError:
            pass
