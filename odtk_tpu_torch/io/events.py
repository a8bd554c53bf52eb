"""TensorBoard scalars without tensorboard or tensorboardX.

``SummaryWriter`` has the part of ``tensorboardX.SummaryWriter`` that the
trainer calls (``odtk_tpu/train.py`` uses ``add_scalar``, ``close``):
``add_scalar(tag, value, step)``, ``flush()``, ``close()``. It writes one
event file, ``events.out.tfevents.<seconds>.<hostname>``, in the
TFRecord framing TensorBoard reads: each record is the data's length
(u64, little-endian), the masked CRC-32C of those 8 bytes, the data, and
the masked CRC-32C of the data. The first event carries
``file_version = "brain.Event:2"``; each scalar is an ``Event`` with a
``Summary`` of one ``Value`` (``tag``, ``simple_value``), its protobuf
encoded here field by field. Tags are cleaned as tensorboardX cleans
them (a character other than a letter, a digit or one of ``_-/.``
becomes ``_``, and leading slashes go), so a run's tags are those of
the JAX trainer's run.
"""

import os
import re
import socket
import struct
import time


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()
_INVALID_TAG_CHARACTERS = re.compile(r'[^-/\w\.]')


def crc32c(data):
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n):
    n &= 0xFFFFFFFFFFFFFFFF           # an int64 as protobuf writes it
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number, wire, payload):
    """A protobuf field: its key, then ``payload`` (length-prefixed for
    wire type 2)."""
    key = _varint(number << 3 | wire)
    if wire == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def _event(wall_time, step=0, file_version=None, summary=None):
    """An ``Event``: wall_time = 1 (double), step = 2 (int64, left out
    at 0 as protobuf leaves defaults out), file_version = 3, summary = 5."""
    out = _field(1, 1, struct.pack('<d', wall_time))
    if step:
        out += _field(2, 0, _varint(step))
    if file_version is not None:
        out += _field(3, 2, file_version.encode())
    if summary is not None:
        out += _field(5, 2, summary)
    return out


def _scalar_summary(tag, value):
    """A ``Summary`` of one ``Value``: tag = 1, simple_value = 2 (float)."""
    value = _field(1, 2, tag.encode()) + _field(2, 5,
                                                struct.pack('<f', value))
    return _field(1, 2, value)


class SummaryWriter:
    """Scalars into an event file under ``log_dir`` (created)."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        name = 'events.out.tfevents.{:010d}.{}'.format(
            int(time.time()), socket.gethostname())
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, 'wb')
        self._write(_event(time.time(), file_version='brain.Event:2'))
        self.flush()

    def _write(self, data):
        header = struct.pack('<Q', len(data))
        self._file.write(header + struct.pack('<I', _masked_crc(header))
                         + data + struct.pack('<I', _masked_crc(data)))

    def add_scalar(self, tag, value, step):
        tag = _INVALID_TAG_CHARACTERS.sub('_', tag).lstrip('/')
        self._write(_event(time.time(), int(step),
                           summary=_scalar_summary(tag, float(value))))

    def flush(self):
        self._file.flush()

    def close(self):
        if not self._file.closed:
            self._file.close()
