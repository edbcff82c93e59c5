"""fast5 (HDF5) reading: raw signal, channel calibration, references.

A copy of ``chiron_tpu/io/fast5.py`` (reference: chiron/chiron_input.py:541-555,
chiron/utils/extract_sig_ref.py:149-193). ``h5py`` is imported inside the
functions that open a file, so the package imports on machines without it
(use ``.signal`` input there).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from chiron_tpu_torch.io.signal import normalize_signal_unique


def read_signal_fast5(fast5_path: str, normalize=None) -> np.ndarray:
    """Raw signal of the first read in a (single-read) fast5 file."""
    import h5py

    with h5py.File(fast5_path, "r") as root:
        signal = np.asarray(list(root["/Raw/Reads"].values())[0][("Signal")])
    return normalize_signal_unique(signal, normalize)


def _decode_attr(val):
    return val.decode("utf-8") if isinstance(val, bytes) else str(val)


def rescale_to_pa(
    raw_signal: np.ndarray, offset: float, range_s: float, digitisation: float
) -> np.ndarray:
    """Digital units -> picoamps: (sig+offset)*range/digitisation
    (chiron/utils/extract_sig_ref.py:154-158)."""
    return ((raw_signal + offset) * float(range_s) / float(digitisation)).astype(
        np.float32
    )


def extract_read(
    input_data,
    input_file: str,
    mode: str = "dna",
    unit: bool = False,
    polya: Optional[dict] = None,
) -> Tuple[np.ndarray, str, str]:
    """Signal + embedded reference + read id from a single-read fast5.

    Parity: chiron/utils/extract_sig_ref.py:149-175 (pA rescale via channel
    calibration when ``unit``; RNA polyA clip + reversal).
    """
    read_h = list(input_data["/Raw/Reads"].values())[0]
    raw_signal = np.asarray(read_h[("Signal")])
    read_id = _decode_attr(read_h.attrs["read_id"]) if "read_id" in read_h.attrs else ""
    if unit:
        attrs = input_data["/UniqueGlobalKey/channel_id/"].attrs
        raw_signal = rescale_to_pa(
            raw_signal,
            float(attrs["offset"]),
            float(attrs["range"]),
            float(attrs["digitisation"]),
        )
    if mode == "rna":
        if polya is not None:
            key = (os.path.basename(input_file), read_id)
            if key in polya:
                raw_signal = raw_signal[polya[key]:]
        raw_signal = raw_signal[::-1]
    reference = _embedded_reference(input_data, os.path.basename(input_file))
    return raw_signal, reference, read_id


def extract_read_v2(root_h, mode: str = "dna") -> Tuple[np.ndarray, str, str]:
    """Multi-read fast5 layout (chiron/utils/extract_sig_ref.py:178-193)."""
    read_h = root_h["Raw"]
    raw_signal = np.asarray(read_h[("Signal")])
    read_id = _decode_attr(read_h.attrs["read_id"]) if "read_id" in read_h.attrs else ""
    if mode == "rna":
        raw_signal = raw_signal[::-1]
    reference = _embedded_reference(root_h, read_id)
    return raw_signal, reference, read_id


def _embedded_reference(h5_group, name: str) -> str:
    try:
        ref = np.asarray(
            h5_group[("Analyses/Basecall_1D_000/BaseCalled_template/Fastq")]
        ).tobytes()
        lines = ref.decode("UTF-8").split("\n")
        return "@%s\n" % name.split(".")[0] + "\n".join(lines[1:])
    except Exception:
        try:
            return (
                np.asarray(h5_group[("Analyses/Alignment_000/Aligned_template/Fasta")])
                .tobytes()
                .decode("UTF-8")
            )
        except Exception:
            return ""


def iter_fast5_reads(
    fast5_path: str, mode: str = "dna", unit: bool = False, polya=None
) -> Iterator[Tuple[str, np.ndarray, str, str]]:
    """Yield (suffix, signal, reference, read_id) for every read in a fast5.

    Single-read files yield one item with suffix ''; multi-read files yield
    one per read with the read-id group name as suffix (matching the
    reference's output naming, extract_sig_ref.py:128-144).
    """
    import h5py

    with h5py.File(fast5_path, "r") as input_data:
        if "Raw" in list(input_data):
            signal, ref, read_id = extract_read(input_data, fast5_path, mode, unit, polya)
            yield "", signal, ref, read_id
        else:
            for read_group in input_data:
                signal, ref, read_id = extract_read_v2(input_data[read_group], mode)
                yield read_group, signal, ref, read_id
