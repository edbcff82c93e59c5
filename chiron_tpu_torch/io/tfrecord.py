"""TFRecord / tf.train.Example reading and writing WITHOUT TensorFlow.

A copy of ``chiron_tpu/io/tfrecord.py``: either package reads the files the
other writes, byte for byte.

Parity: chiron/chiron_input.py:318-427 (``read_tfrecord``) consumes TFRecord
files whose Examples hold three bytes features — ``raw_data`` (int16 signal),
``features`` (|S8 strings in groups of three: start, end, base), ``fname`` —
via ``tf.python_io.tf_record_iterator`` + ``tf.train.Example``. This module
re-implements just enough of the TFRecord framing and protobuf wire format
to read (and, for tests/tooling, write) those files with numpy alone, then
feeds the exact same windowing path (io.labels.read_raw).

TFRecord framing per record:
  uint64 LE payload length | uint32 masked crc32c(length) | payload |
  uint32 masked crc32c(payload),  mask(c) = ((c>>15 | c<<17) + 0xa282ead8).

Proto wire layout parsed (field numbers from tensorflow/core/example):
  Example{1: Features}  Features{1: map<string, Feature> entries}
  map entry{1: key, 2: Feature}  Feature{1: BytesList, 2: FloatList,
  3: Int64List}  *List{1: repeated value}.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from chiron_tpu_torch.io.labels import label_from_rows, read_raw
from chiron_tpu_torch.io.signal import normalize_signal_unique

SIGNAL_DTYPE = np.int16  # chiron/chiron_input.py:26

# ---------------------------------------------------------------------------
# crc32c (Castagnoli) — table-driven; TFRecord uses the masked form
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = np.zeros(256, np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table[i] = c
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ int(table[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire helpers
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in record payload")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:  # fixed64
            val = struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_example(payload: bytes) -> Dict[str, list]:
    """Parse a serialized tf.train.Example into {name: list of values}."""
    out: Dict[str, list] = {}
    for field, _, features_buf in _iter_fields(payload):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _iter_fields(features_buf):
            if f2 != 1:  # Features.feature map entry
                continue
            key = None
            values: list = []
            for f3, _, val in _iter_fields(entry):
                if f3 == 1:
                    key = val.decode()
                elif f3 == 2:  # Feature
                    for f4, wire4, lst in _iter_fields(val):
                        if f4 == 1:  # BytesList
                            values.extend(
                                v for f5, _, v in _iter_fields(lst) if f5 == 1
                            )
                        elif f4 == 2:  # FloatList (packed or repeated)
                            for f5, w5, v in _iter_fields(lst):
                                if f5 != 1:
                                    continue
                                if w5 == 2:
                                    values.extend(
                                        np.frombuffer(v, "<f4").tolist()
                                    )
                                else:
                                    values.append(
                                        struct.unpack("<f", struct.pack("<I", v))[0]
                                    )
                        elif f4 == 3:  # Int64List (packed or repeated)
                            for f5, w5, v in _iter_fields(lst):
                                if f5 != 1:
                                    continue
                                if w5 == 2:
                                    pos = 0
                                    while pos < len(v):
                                        x, pos = _read_varint(v, pos)
                                        values.append(x)
                                else:
                                    values.append(v)
            if key is not None:
                out[key] = values
    return out


def iter_tfrecords(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if verify_crc and _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"corrupt TFRecord length crc in {path}")
            payload = f.read(length)
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and _masked_crc(payload) != data_crc:
                raise ValueError(f"corrupt TFRecord payload crc in {path}")
            yield payload


# ---------------------------------------------------------------------------
# writer (tests / data prep)
# ---------------------------------------------------------------------------

def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, data: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(data)) + data


def make_example(features: Dict[str, bytes]) -> bytes:
    """Serialize {name: bytes} into a tf.train.Example (BytesList values)."""
    entries = b""
    for key, val in features.items():
        feature = _len_field(1, _len_field(1, val))  # Feature.bytes_list.value
        entry = _len_field(1, key.encode()) + _len_field(2, feature)
        entries += _len_field(1, entry)
    return _len_field(1, entries)  # Example.features


def write_tfrecord(path: str, examples: List[bytes]) -> None:
    with open(path, "wb") as f:
        for payload in examples:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))


def write_training_tfrecord(path: str, reads) -> None:
    """Write (fname, signal int16 array, [(start, end, base_char)]) reads.

    Produces the reference's production layout: ``features`` is an |S8
    array in groups of three whose base cell holds the *repr* of a python
    bytes object (e.g. ``b'A'``) — read back via ``.decode()[2]``
    (chiron/chiron_input.py:612-613).
    """
    examples = []
    for fname, signal, rows in reads:
        feats = []
        for start, end, base in rows:
            if len(str(start)) > 8 or len(str(end)) > 8:
                raise ValueError(
                    f"{fname}: offset {max(start, end)} does not fit the "
                    "reference's |S8 feature layout (>= 1e8 samples); "
                    "truncating would corrupt labels on round trip"
                )
            feats.extend([str(start), str(end), repr(base.encode())])
        feat_arr = np.asarray(feats, dtype="S8")
        examples.append(
            make_example(
                {
                    "raw_data": np.asarray(signal, SIGNAL_DTYPE).tobytes(),
                    "features": feat_arr.tobytes(),
                    "fname": fname.encode(),
                }
            )
        )
    write_tfrecord(path, examples)


# ---------------------------------------------------------------------------
# training-set reader (parity: read_tfrecord, chiron_input.py:318-427)
# ---------------------------------------------------------------------------

def _decode_base_cell(cell: bytes) -> str:
    """The reference stores |S8 cells like b"b'A'" and reads char [2]."""
    s = cell.decode()
    if len(s) >= 3 and s[0] == "b" and s[1] in "'\"":
        return s[2]
    return s[0]


def read_tfrecord_pairs(path: str):
    """Yield (fname, signal float array, [(start, end, base_char)]) reads."""
    for payload in iter_tfrecords(path):
        ex = parse_example(payload)
        raw = np.frombuffer(ex["raw_data"][0], SIGNAL_DTYPE).astype(np.float32)
        feats = np.frombuffer(ex["features"][0], "S8")
        rows = [
            (
                int(feats[i]),
                int(feats[i + 1]),
                _decode_base_cell(feats[i + 2]),
            )
            for i in range(0, len(feats), 3)
        ]
        fname = ex.get("fname", [b""])[0].decode()
        yield fname, raw, rows


def read_tfrecord_data_sets(
    path: str,
    seq_length: int = 300,
    k_mer: int = 1,
    max_segments_num=None,
    skip_start: int = 10,
    sig_norm=None,
):
    """TFRecord file(s) -> dense training arrays (read_raw windowing).

    ``path`` may be one .tfrecords file or a directory of them. Returns the
    same (events, event_lengths, labels, label_lengths) arrays as
    io.labels.read_raw_data_sets.
    """
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith((".tfrecord", ".tfrecords"))
        )
    else:
        files = [path]

    events, event_lengths, labels, label_lengths = [], [], [], []
    for fn in files:
        for _, signal, rows in read_tfrecord_pairs(fn):
            if len(signal) == 0:
                continue
            # moments over unique signal values (read_signal_tfrecord parity,
            # chiron/chiron_input.py:557-567)
            signal = normalize_signal_unique(signal, sig_norm)
            f_label = label_from_rows(
                rows, skip_start=skip_start, window_n=(k_mer - 1) // 2
            )
            ev, evl, lb, lbl = read_raw(signal, f_label, seq_length)
            events += ev
            event_lengths += evl
            labels += lb
            label_lengths += lbl
            if max_segments_num is not None and len(events) > max_segments_num:
                break
        if max_segments_num is not None and len(events) > max_segments_num:
            events = events[:max_segments_num]
            event_lengths = event_lengths[:max_segments_num]
            labels = labels[:max_segments_num]
            label_lengths = label_lengths[:max_segments_num]
            break

    n = len(events)
    if n == 0:
        return (
            np.zeros((0, seq_length), np.float32),
            np.zeros(0, np.int32),
            np.zeros((0, 0), np.int32),
            np.zeros(0, np.int32),
        )
    max_label = max(label_lengths)
    label_arr = np.full((n, max_label), -1, np.int32)
    for i, lb in enumerate(labels):
        label_arr[i, : len(lb)] = lb
    return (
        np.asarray(events, np.float32),
        np.asarray(event_lengths, np.int32),
        label_arr,
        np.asarray(label_lengths, np.int32),
    )
