"""TensorBoard event-file writer and reader: the port's own copy of
``sggan_tpu/utils/summary.py`` (numpy only), held to it by
``tests/test_torch_data.py``.  The text below is the JAX module's.

Self-contained TensorBoard event-file writer (zero dependencies).

The reference logs per-epoch scalars (Generator/Discriminator Loss,
Overall/Mean/FreqW Accuracy, Mean IoU) and an image summary through
tf.summary (model.py:23-34, 263-268, 374-378).  TensorFlow is not part of
this stack, so we emit the tfevents format directly: TFRecord framing
(length + masked CRC32C) around hand-encoded Event/Summary protobuf
messages.  TensorBoard reads these natively; tag names match the
reference so existing dashboards keep working.
"""

from __future__ import annotations

import io
import os
import struct
import time

import numpy as np

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []
_POLY = 0x82F63B78


def _make_table():
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
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


# ------------------------------------------------------- protobuf encoding

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _f_int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _f_str(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode())


# --------------------------------------------------------------- messages

def _summary_value_scalar(tag: str, value: float) -> bytes:
    # Summary.Value: tag=1, simple_value=2
    return _f_str(1, tag) + _f_float(2, float(value))


def _summary_value_image(tag: str, png: bytes, h: int, w: int,
                         colorspace: int = 3) -> bytes:
    # Summary.Image: height=1, width=2, colorspace=3, encoded_image_string=4
    img = (_f_int(1, h) + _f_int(2, w) + _f_int(3, colorspace)
           + _f_bytes(4, png))
    # Summary.Value: tag=1, image=4
    return _f_str(1, tag) + _f_bytes(4, img)


def _event(step: int, summary_values: bytes = b"", file_version: str = "",
           wall_time: float = None) -> bytes:
    # Event: wall_time=1 (double), step=2, file_version=3, summary=5
    msg = _f_double(1, wall_time if wall_time is not None else time.time())
    if step is not None:
        msg += _f_int(2, step)
    if file_version:
        msg += _f_str(3, file_version)
    if summary_values:
        # Summary: repeated value=1 — already encoded as Value submessages
        msg += _f_bytes(5, summary_values)
    return msg


# ----------------------------------------------------------------- writer

def _parse_fields(buf: bytes) -> dict:
    """Minimal proto wire-format parser: {field_number: [values]}."""
    fields: dict = {}
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
        field, wire = key >> 3, key & 7
        if wire == 0:
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 1:
            v = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        elif wire == 5:
            v = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            v = buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"wire type {wire}")
        fields.setdefault(field, []).append(v)
    return fields


def read_scalars(event_file: str) -> dict:
    """Read back {tag: [(step, value), ...]} from a tfevents file (ours or
    TensorFlow's, as long as records are uncompressed)."""
    out: dict = {}
    with open(event_file, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # header crc
            payload = f.read(length)
            f.read(4)  # payload crc
            ev = _parse_fields(payload)
            step = ev.get(2, [0])[0]
            for summ in ev.get(5, []):
                for val in _parse_fields(summ).get(1, []):
                    vf = _parse_fields(val)
                    if 2 in vf:  # simple_value
                        tag = vf[1][0].decode()
                        out.setdefault(tag, []).append((step, vf[2][0]))


class SummaryWriter:
    """Minimal tf.summary.create_file_writer equivalent."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.sggan_tpu"
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write_record(_event(None, file_version="brain.Event:2"))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int):
        self._write_record(
            _event(step, _f_bytes(1, _summary_value_scalar(tag, value))))

    def image(self, tag: str, img_u8: np.ndarray, step: int):
        """img_u8: (H, W, 3) or (N, H, W, 3) uint8; batches are stacked
        vertically (matching the reference's concat image summary,
        model.py:441-448)."""
        from PIL import Image
        img_u8 = np.asarray(img_u8)
        if img_u8.ndim == 4:
            img_u8 = img_u8.reshape(-1, *img_u8.shape[2:])
        buf = io.BytesIO()
        Image.fromarray(img_u8).save(buf, format="PNG")
        v = _summary_value_image(tag, buf.getvalue(), img_u8.shape[0],
                                 img_u8.shape[1])
        self._write_record(_event(step, _f_bytes(1, v)))

    def close(self):
        self._f.close()
