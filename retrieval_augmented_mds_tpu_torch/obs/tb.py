"""Minimal TensorBoard event writer — zero dependencies.

Counterpart of ``retrieval_augmented_mds_tpu/obs/tb.py``, owned by the port
(a copy: the same records, byte for byte but for the wall times and the
file name's time and host).

The reference dual-logs every metric to MLFlow + TensorBoard
(config/no_mips.yaml:18-25, sotasum/pretrain.py:570-579). The JSONL
logger (obs/logging.py) stays the default here; this writer restores
ecosystem compatibility behind `logging.tensorboard: true`: scalar
summaries in the standard `events.out.tfevents.*` TFRecord format that
TensorBoard (and anything speaking its protocol) reads directly.

Hand-rolled on purpose: an Event file is just TFRecord-framed protobufs
(varint/fixed64/length-delimited wire types + masked CRC32C), ~80 lines —
not worth importing tensorflow or tensorboard into the training process
for.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# --- CRC32C (Castagnoli, reflected poly 0x82F63B78) -----------------------

_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire helpers -------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _float32(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _int64(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    # Event proto: 1=wall_time double, 2=step int64, 3=file_version
    # string, 5=summary message; Summary: repeated 1=Value; Value:
    # 1=tag string, 2=simple_value float
    ev = _double(1, wall_time)
    if step is not None:
        ev += _int64(2, step)
    if file_version is not None:
        ev += _bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _bytes(1, _bytes(1, tag.encode()) + _float32(2, float(v)))
            for tag, v in scalars.items()
        )
        ev += _bytes(5, summary)
    return ev


class TBEventWriter:
    """Append-only scalar event writer, one TFRecord per `add_scalars`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir,
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}",
        )
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))
        self._f.flush()

    def add_scalars(self, step: int, scalars: dict[str, float]) -> None:
        clean = {}
        for k, v in scalars.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        if clean:
            self._write(_event(time.time(), step=int(step), scalars=clean))

    def close(self) -> None:
        self._f.close()
