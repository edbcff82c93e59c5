"""The basecall (`chiron call`) pipeline: host IO -> device decode -> assembly.

Port of ``chiron_tpu/eval/pipeline.py`` (reference: chiron/chiron_eval.py:244-522).
One device step per batch runs the CNN+BiLSTM forward, the path
probability and the CTC decode (greedy or beam search), and packs all
outputs into ONE uint8 buffer, so each batch costs one device->host copy.
PyTorch enqueues CUDA work asynchronously: the consumer loop issues the next
batch's step before the readback threads block on earlier ones. Windows
are read and uploaded by a producer thread; reads are assembled and
written by a host writer thread.

Batches are packed across file boundaries and regrouped per (file, window
index) on the host. The final partial batch is wrap-padded with index -1
sentinels (chiron_eval.py:352-367): BN statistics depend on the batch, so
the batch is exactly the JAX package's.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict, deque
from typing import Iterator, List, Tuple

import numpy as np
import torch

from chiron_tpu_torch import config as C
from chiron_tpu_torch.assembly import (
    consensus_to_bases,
    get_assembler_kernel,
    qs,
    simple_assembly,
    simple_assembly_qs,
)
from chiron_tpu_torch.io.signal import read_signal_for_eval
from chiron_tpu_torch.io.writers import ensure_output_dirs, write_output, write_run_meta
from chiron_tpu_torch.ops.beam import beam_search_decode
from chiron_tpu_torch.ops.ctc_greedy import greedy_decode
from chiron_tpu_torch.params import Basecaller, from_jax_params
from chiron_tpu_torch.train.checkpoint import restore_latest
from chiron_tpu_torch.utils.device import resolve_device


def path_prob(logits: torch.Tensor) -> torch.Tensor:
    """Mean (top1 - top2) logit gap per window (chiron_eval.py:116-136).

    Averaged over the full window length including padding frames, as the
    reference does.
    """
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).mean(dim=-1)


def pack_step_outputs(decoded, lengths, score, prob, two_bit: bool = True):
    """Pack the step outputs into ONE uint8 buffer [B, *].

    With a 4-label alphabet every decoded label fits 2 bits (4 per byte,
    [B, ceil(T/4) + 12]); wider alphabets use int8 ([B, T + 12]). Then
    4 bytes each of length (int32), score and prob (float32), little-endian.
    """
    b, t = decoded.shape
    if two_bit:
        t4 = -(-t // 4) * 4
        d = torch.clamp(decoded, min=0).to(torch.int32)
        d = torch.nn.functional.pad(d, (0, t4 - t)).reshape(b, t4 // 4, 4)
        weights = torch.tensor([1, 4, 16, 64], dtype=torch.int32, device=d.device)
        dec8 = (d * weights).sum(dim=-1).to(torch.uint8)
    else:
        dec8 = decoded.to(torch.int8).view(torch.uint8)
    len8 = lengths.to(torch.int32).contiguous().view(torch.uint8).reshape(b, 4)
    sc8 = score.to(torch.float32).contiguous().view(torch.uint8).reshape(b, 4)
    pr8 = prob.to(torch.float32).contiguous().view(torch.uint8).reshape(b, 4)
    return torch.cat([dec8, len8, sc8, pr8], dim=1)


def unpack_step_outputs(buf: np.ndarray, two_bit: bool = True):
    """Host-side inverse of pack_step_outputs."""
    t = buf.shape[1] - 12
    if two_bit:
        packed = buf[:, :t]
        decoded = np.empty((buf.shape[0], t * 4), np.uint8)
        decoded[:, 0::4] = packed & 3
        decoded[:, 1::4] = (packed >> 2) & 3
        decoded[:, 2::4] = (packed >> 4) & 3
        decoded[:, 3::4] = (packed >> 6) & 3
    else:
        decoded = buf[:, :t].view(np.int8)
    lengths = np.ascontiguousarray(buf[:, t:t + 4]).view(np.int32)[:, 0]
    score = np.ascontiguousarray(buf[:, t + 4:t + 8]).view(np.float32)[:, 0]
    prob = np.ascontiguousarray(buf[:, t + 8:t + 12]).view(np.float32)[:, 0]
    return decoded, lengths, score, prob


def two_bit_labels(config) -> bool:
    """2-bit label packing is only valid for <=4 non-blank classes."""
    return C.class_n(config) - 1 <= 4


def decode_step(model: Basecaller, x: torch.Tensor, seq_len: torch.Tensor,
                beam: int, length_bonus: float = 0.0) -> torch.Tensor:
    """One device step: forward, path prob, CTC decode, pack.

    ``length_bonus`` is the beam decoder's additive log-score per emitted
    label; greedy decode (beam 0) ignores it.
    """
    with torch.no_grad():
        logits = model(x, seq_len)
        prob = path_prob(logits)
        if beam == 0:
            decoded, lengths, score = greedy_decode(logits, seq_len)
        else:
            decoded, lengths, score = beam_search_decode(
                logits, seq_len, beam_width=beam, length_bonus=float(length_bonus))
        return pack_step_outputs(decoded, lengths, score, prob,
                                 two_bit=two_bit_labels(model.config))


def list_input_files(input_path: str, recursive: bool = True) -> Tuple[str, List[str]]:
    """Resolve the (dir, relative file list) pair (chiron_eval.py:277-291)."""
    if os.path.isdir(input_path):
        if recursive:
            file_list = []
            dir_len = len(input_path) + 1
            for dirpath, _, filenames in os.walk(input_path + "/"):
                for filename in filenames:
                    file_list.append(os.path.join(dirpath[dir_len:], filename))
        else:
            file_list = os.listdir(input_path)
        file_dir = input_path
    else:
        file_list = [os.path.basename(input_path)]
        file_dir = os.path.abspath(os.path.join(input_path, os.path.pardir))
    file_list = sorted(
        f for f in file_list if f.endswith(".signal") or f.endswith(".fast5")
    )
    return file_dir, file_list


def _batch_stream(
    file_dir: str,
    file_list: List[str],
    flags,
    ratio: float,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, List[str], dict]]:
    """Yield fixed-size batches packed across files.

    Each yield: (x [B, L], seq_len_frames [B], window_idx [B], fnames [B],
    read_meta {fname: (n_windows, reading_time)}).
    """
    from concurrent.futures import ThreadPoolExecutor

    # per-file reads run in a small ordered-lookahead pool, overlapping IO
    # across files while results are consumed strictly in list order
    read_pool = ThreadPoolExecutor(max_workers=3)

    def _read_one(name):
        t0 = time.time()
        windows, lengths = read_signal_for_eval(
            os.path.join(file_dir, name),
            flags.start,
            step=flags.jump,
            seg_length=flags.segment_len,
            normalize=getattr(flags, "sig_norm", None),
            reverse_fast5=flags.reverse_fast5,
        )
        return windows, lengths, time.time() - t0

    lookahead: deque = deque()
    for name in file_list[:3]:
        lookahead.append((name, read_pool.submit(_read_one, name)))
    try:
        yield from _drain_files(file_list, lookahead, min(3, len(file_list)),
                                read_pool, _read_one, flags.batch_size,
                                flags.segment_len, ratio)
    finally:
        # a consumer abort must not leave lookahead reads running
        read_pool.shutdown(wait=False, cancel_futures=True)


def _drain_files(file_list, lookahead, submitted, read_pool, _read_one, bsz, seg, ratio):
    buf_x = np.zeros((0, seg), np.float32)
    buf_len = np.zeros(0, np.int32)
    buf_idx = np.zeros(0, np.int64)
    buf_fn: List[str] = []
    meta = {}
    for _ in range(len(file_list)):
        name, fut = lookahead.popleft()
        if submitted < len(file_list):
            nxt = file_list[submitted]
            lookahead.append((nxt, read_pool.submit(_read_one, nxt)))
            submitted += 1
        t0 = time.time()
        try:
            windows, lengths, rtime = fut.result()
            t0 = time.time() - rtime  # preserve per-file reading_time
        except Exception as e:
            # per-file fault tolerance: a corrupt input must not abort the
            # run; -1 window count marks "unreadable" (vs 0 = empty)
            print(f"WARNING: skipping unreadable input {name}: {e}")
            meta[name] = (-1, time.time() - t0)
            continue
        meta[name] = (len(windows), time.time() - t0)
        buf_x = np.concatenate([buf_x, windows], axis=0)
        buf_len = np.concatenate([buf_len, lengths])
        buf_idx = np.concatenate([buf_idx, np.arange(len(windows))])
        buf_fn.extend([name] * len(windows))
        while len(buf_x) >= bsz:
            yield (
                buf_x[:bsz],
                np.round(buf_len[:bsz] / ratio).astype(np.int32),
                buf_idx[:bsz],
                buf_fn[:bsz],
                meta,
            )
            meta = {}
            buf_x = buf_x[bsz:]
            buf_len = buf_len[bsz:]
            buf_idx = buf_idx[bsz:]
            buf_fn = buf_fn[bsz:]
    n = len(buf_x)
    if n > 0:
        pad = bsz - n
        buf_x = np.pad(buf_x, ((0, pad), (0, 0)), mode="wrap")
        buf_len = np.pad(buf_len, (0, pad), mode="wrap")
        buf_idx = np.concatenate([buf_idx, np.full(pad, -1)])
        buf_fn = buf_fn + [""] * pad
        yield (
            buf_x,
            np.round(buf_len / ratio).astype(np.int32),
            buf_idx,
            buf_fn,
            meta,
        )


def _prefetch(iterator, depth: int = 4):
    """Run an iterator in a producer thread with a bounded queue
    (the reference's producer thread, chiron_eval.py:304-372)."""
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=depth)
    _END = object()
    err = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # surface producer errors in the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item


def load_model(model_dir: str, config, device) -> Basecaller:
    """The port's model from the newest checkpoint in ``model_dir``."""
    params, _ = restore_latest(model_dir) if model_dir else (None, None)
    if params is None:
        raise FileNotFoundError(f"no parameter checkpoint found in {model_dir!r}")
    return from_jax_params(params, config, device)


def evaluation(flags) -> dict:
    """Run basecalling over all input files. Returns summary stats."""
    if getattr(flags, "bf16", False):
        raise NotImplementedError("--bf16 is not supported by the PyTorch port yet")
    if int(getattr(flags, "n_devices", 0) or 1) > 1:
        raise NotImplementedError("multi-GPU decode is not supported by the PyTorch port yet")
    device = resolve_device(getattr(flags, "device", "cuda"))
    config_path = os.path.join(flags.model, "model.json") if flags.model else None
    config = C.read_config(config_path)
    model = load_model(flags.model, config, device)

    ensure_output_dirs(flags.output)
    file_dir, file_list = list_input_files(flags.input, getattr(flags, "recursive", True))
    test_number = getattr(flags, "test_number", None)
    if test_number is not None:
        file_list = file_list[: int(test_number)]
    print(f"Found {len(file_list)} files.")

    ratio = model.ratio(flags.segment_len)
    alphabet = C.alphabet(config)
    two_bit = two_bit_labels(config)
    # an explicit flag wins; else the model's calibrated default from
    # model.json, else 0.0 (exact reference semantics)
    length_bonus = getattr(flags, "length_bonus", None)
    if length_bonus is None:
        length_bonus = float(config.get("length_bonus", 0.0) or 0.0)

    acc = defaultdict(dict)  # fname -> {idx: (bases, prob)}
    counts = {}  # fname -> expected window count
    timing = {}  # fname -> (start_time, reading_time)
    total_windows = 0
    inflight: deque = deque()
    pipeline_depth = 6
    base_lut = np.frombuffer(alphabet.encode(), np.uint8)

    from concurrent.futures import ThreadPoolExecutor

    fin_futures = []

    def drain_one(finalizer):
        nonlocal total_windows
        packed_fut, widx, fnames = inflight.popleft()
        decoded, lengths, score, prob = unpack_step_outputs(packed_fut.result(),
                                                            two_bit=two_bit)
        for i in range(len(fnames)):
            if widx[i] < 0:
                continue
            fn = fnames[i]
            n = int(lengths[i])
            bases = base_lut[decoded[i, :n]].tobytes().decode()
            acc[fn][int(widx[i])] = (bases, float(prob[i]))
            total_windows += 1
        for fn in list(acc.keys()):
            if fn in counts and len(acc[fn]) == counts[fn]:
                fin_futures.append(
                    finalizer(_finalize_file, fn, acc.pop(fn), flags, timing[fn], alphabet)
                )

    def _upload(stream):
        # host->device upload runs in the producer thread (via _prefetch)
        for x, sl, widx, fnames, meta in stream:
            yield (torch.from_numpy(x).to(device), torch.from_numpy(sl).to(device),
                   widx, fnames, meta)

    def _readback(out):
        return out.cpu().numpy()

    with ThreadPoolExecutor(max_workers=1) as pool, \
            ThreadPoolExecutor(max_workers=4) as readback_pool:
        for x, sl, widx, fnames, meta in _prefetch(
            _upload(_batch_stream(file_dir, file_list, flags, ratio))
        ):
            for fn, (nwin, rtime) in meta.items():
                counts[fn] = nwin
                timing[fn] = (time.time() - rtime, rtime)  # (start, reading)
            out = decode_step(model, x, sl, flags.beam, length_bonus)
            inflight.append((readback_pool.submit(_readback, out), widx, fnames))
            if len(inflight) > pipeline_depth:
                drain_one(pool.submit)
        while inflight:
            drain_one(pool.submit)
        total_bases = sum(f.result() for f in fin_futures)
    # genuinely empty inputs still get (empty) output files; unreadable
    # inputs (count -1) are skipped
    for fn in file_list:
        if counts.get(fn) == 0 and fn not in acc:
            total_bases += _finalize_file(fn, {}, flags, timing[fn], alphabet)
        elif fn in acc and counts.get(fn, -1) == len(acc[fn]):
            total_bases += _finalize_file(fn, acc.pop(fn), flags, timing[fn], alphabet)
    return {
        "n_files": len(file_list),
        "total_bases": total_bases,
        "total_windows": total_windows,
    }


def _finalize_file(fname: str, windows: dict, flags, times,
                   alphabet: str = "ACGT") -> int:
    """Assemble one read's windows and write outputs. Returns base count."""
    start_time, reading_time = times
    idxs = sorted(windows.keys())
    bpreads = [windows[i][0] for i in idxs]
    qs_list = np.asarray([[windows[i][1]] for i in idxs])
    basecall_time = time.time() - start_time
    file_pre = os.path.splitext(fname)[0].replace(os.path.sep, "_")
    js_ratio = flags.jump / flags.segment_len
    kernel = get_assembler_kernel(flags.jump, flags.segment_len)
    nonempty = [i for i, b in enumerate(bpreads) if len(b) > 0]
    qs_string = None
    if not nonempty:
        consensus_seq = ""
        if flags.extension == "fastq":
            qs_string = ""
    elif flags.extension == "fastq":
        consensus, consensus_qs = simple_assembly_qs(
            [bpreads[i] for i in nonempty],
            qs_list[nonempty],
            js_ratio,
            kernel=kernel,
            alphabet=alphabet,
        )
        qs_string = qs(consensus, consensus_qs)
        consensus_seq = consensus_to_bases(consensus, alphabet)
    else:
        consensus = simple_assembly(
            [bpreads[i] for i in nonempty], js_ratio, kernel=kernel,
            alphabet=alphabet,
        )
        consensus_seq = consensus_to_bases(consensus, alphabet)
    assembly_time = time.time() - start_time
    write_output(
        bpreads,
        consensus_seq,
        [start_time, reading_time, basecall_time, assembly_time],
        file_pre,
        concise=flags.concise,
        suffix=flags.extension,
        q_score=qs_string,
        global_setting=flags,
    )
    return len(consensus_seq)


def run(flags) -> dict:
    """Entry point (parity: chiron/chiron_eval.py:525-544).

    ``flags.device`` (default cuda) picks the device. With ``flags.profile``
    set, the run is wrapped in a torch.profiler trace written to
    <output>/profile/trace.json.
    """
    import contextlib

    from chiron_tpu_torch.utils.timing import unix_time

    print(f"The result will be written to {flags.output}")
    if not os.path.isdir(flags.output):
        os.makedirs(flags.output)
    result = {}

    def _run():
        if getattr(flags, "profile", False):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            trace = profile(activities=acts)
        else:
            trace = contextlib.nullcontext()
        with trace:
            result.update(evaluation(flags))
        if getattr(flags, "profile", False):
            os.makedirs(os.path.join(flags.output, "profile"), exist_ok=True)
            trace.export_chrome_trace(os.path.join(flags.output, "profile", "trace.json"))

    time_dict = unix_time(_run)
    print(
        "Real time:%5.3f Systime:%5.3f Usertime:%5.3f"
        % (time_dict["real"], time_dict["sys"], time_dict["user"])
    )
    write_run_meta(flags.output, flags.input, time_dict)
    result["time"] = time_dict
    return result
