"""TF-free reader for TensorFlow checkpoint ``.index`` files.

A copy of ``chiron_tpu/tools/tf_index.py`` (standard library only), so that
the port imports nothing of the JAX package; the tests hold the two copies
to the same outputs.

The reference ships its pretrained models as TF1 Saver checkpoints whose
data blobs are absent in this mount (.MISSING_LARGE_BLOBS) but whose
``.index`` files survive (model/DNA_default/final.ckpt-158301.index). The
index is a LevelDB-format SSTable mapping variable names to
BundleEntryProto records (dtype, shape, shard offsets) — enough to recover
every variable name and shape in the reference graph without TensorFlow.
Used to validate tools/convert_tf_checkpoint.py's name maps against the
real graphs (and by its coverage test).

Format: blocks of prefix-compressed key/value entries, each block followed
by a 1-byte compression tag + crc32; a 48-byte footer holds varint64
BlockHandles of the metaindex and index blocks plus the table magic.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

TABLE_MAGIC = 0xDB4775248B80FB57

# tensorflow DataType enum (tensor.proto) for the entries we expect
DTYPE_NAMES = {
    0: "invalid", 1: "float32", 2: "float64", 3: "int32", 4: "uint8",
    5: "int16", 6: "int8", 7: "string", 9: "int64", 10: "bool",
    14: "bfloat16", 19: "float16",
}


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in .index file")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _block_entries(block: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode one table block's prefix-compressed (key, value) entries."""
    if len(block) < 4:
        return []
    n_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    out = []
    while pos < data_end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        out.append((key, block[pos:pos + value_len]))
        pos += value_len
    return out


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Fetch a block by handle; tag byte 0 = raw, 1 = snappy."""
    raw = data[offset:offset + size]
    tag = data[offset + size]
    if tag == 0:
        return raw
    if tag == 1:
        try:
            import snappy  # type: ignore

            return snappy.uncompress(raw)
        except ImportError:
            raise ValueError(".index block is snappy-compressed; "
                             "python-snappy unavailable")
    raise ValueError(f"unknown block compression tag {tag}")


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _parse_shape(buf: bytes) -> List[int]:
    """TensorShapeProto: repeated Dim dim = 2 {int64 size = 1}."""
    dims: List[int] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 2 and wire == 2:
            n, pos = _varint(buf, pos)
            sub = buf[pos:pos + n]
            pos += n
            spos = 0
            size = None
            while spos < len(sub):
                stag, spos = _varint(sub, spos)
                if stag >> 3 == 1 and stag & 7 == 0:
                    size, spos = _varint(sub, spos)
                else:
                    spos = _skip_field(sub, spos, stag & 7)
            dims.append(size if size is not None else -1)
        else:
            pos = _skip_field(buf, pos, wire)
    return dims


def _parse_entry(buf: bytes) -> Dict:
    """BundleEntryProto: dtype = 1, shape = 2, shard = 3, offset 4, size 5."""
    out = {"dtype": None, "shape": []}
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 0:
            v, pos = _varint(buf, pos)
            out["dtype"] = DTYPE_NAMES.get(v, str(v))
        elif field == 2 and wire == 2:
            n, pos = _varint(buf, pos)
            out["shape"] = _parse_shape(buf[pos:pos + n])
            pos += n
        elif field == 5 and wire == 0:
            out["size"], pos = _varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wire)
    return out


def list_variables(index_path: str) -> Dict[str, Dict]:
    """Variable name -> {dtype, shape} from a checkpoint .index file."""
    with open(index_path, "rb") as f:
        data = f.read()
    if len(data) < 48:
        raise ValueError(f"{index_path}: too short for an SSTable")
    footer = data[-48:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != TABLE_MAGIC:
        raise ValueError(f"{index_path}: bad table magic {magic:#x}")
    pos = 0
    _, pos = _varint(footer, pos)          # metaindex offset
    _, pos = _varint(footer, pos)          # metaindex size
    idx_off, pos = _varint(footer, pos)    # index block handle
    idx_size, pos = _varint(footer, pos)
    index_block = _read_block(data, idx_off, idx_size)
    out: Dict[str, Dict] = {}
    for _, handle in _block_entries(index_block):
        off, hpos = _varint(handle, 0)
        size, _ = _varint(handle, hpos)
        for key, value in _block_entries(_read_block(data, off, size)):
            name = key.decode("utf-8", errors="replace")
            if not name:
                continue  # empty key = BundleHeaderProto
            out[name] = _parse_entry(value)
    return out


def model_variables(index_path: str) -> Dict[str, Dict]:
    """list_variables filtered to model weights (no optimizer/bookkeeping)."""
    skip_suffixes = ("/Adam", "/Adam_1", "/Momentum", "/RMSProp",
                     "/RMSProp_1", "/ExponentialMovingAverage")
    skip_names = {"global_step", "beta1_power", "beta2_power"}
    out = {}
    for name, info in list_variables(index_path).items():
        if name in skip_names or name.endswith(skip_suffixes):
            continue
        out[name] = info
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="List variables in a TF checkpoint .index (no TF needed)."
    )
    p.add_argument("index_path")
    p.add_argument("--all", action="store_true",
                   help="include optimizer slots and bookkeeping variables")
    args = p.parse_args(argv)
    var_fn = list_variables if args.all else model_variables
    for name, info in sorted(var_fn(args.index_path).items()):
        print(f"{name}\t{info['dtype']}\t{info['shape']}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
