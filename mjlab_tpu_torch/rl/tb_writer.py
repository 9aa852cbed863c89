"""Minimal, dependency-free TensorBoard event-file writer.

A copy of mjlab_tpu/rl/tb_writer.py: the port imports nothing of the JAX
package, and the card's machine has no tensorboard package.

Implements exactly what the runner's `logger: "tensorboard"` option needs
(reference src/mjlab/rl/config.py:85-90 routes rsl-rl to
torch.utils.tensorboard): scalar summaries in the TFRecord/Event format
TensorBoard reads. Hand-rolled protobuf encoding in the same spirit as
rl/onnx_proto.py — the environment ships no tensorboard package, and the
format is tiny:

    TFRecord framing: <len u64><masked crc32c(len) u32><data><crc32c(data) u32>
    Event proto:      1: wall_time (double), 2: step (int64),
                      5: summary (Summary)
    Summary proto:    1: repeated Value { 1: tag (string),
                                          2: simple_value (float) }

The JAX package's copy is verified against TensorBoard's own reader in
tests/test_tb_writer.py; tests/test_torch_train.py holds this one to it.
"""

from __future__ import annotations

import os
import socket
import struct
import time


# -- crc32c (Castagnoli), software table --

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tab = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tab.append(c)
        _CRC_TABLE = tab
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# -- protobuf wire encoding --


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


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _summary(values: dict[str, float]) -> bytes:
    out = b""
    for tag, v in values.items():
        val = _bytes_field(1, tag.encode()) + _float_field(2, float(v))
        out += _bytes_field(1, val)
    return out


def _event(step: int, values: dict[str, float], wall_time: float) -> bytes:
    ev = _double_field(1, wall_time) + _int64_field(2, step)
    ev += _bytes_field(5, _summary(values))
    return ev


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


class SummaryWriter:
    """Scalar-only tensorboard writer, torch-SummaryWriter-shaped API."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d" % (
            int(time.time()),
            socket.gethostname(),
            os.getpid(),
        )
        self._f = open(os.path.join(log_dir, fname), "ab")
        # file-version event, required by tensorboard's loader
        ver = _double_field(1, time.time()) + _bytes_field(
            3, b"brain.Event:2"
        )
        self._f.write(_record(ver))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self.add_scalars_dict({tag: value}, global_step)

    def add_scalars_dict(self, values: dict[str, float], step: int) -> None:
        self._f.write(_record(_event(step, values, time.time())))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
