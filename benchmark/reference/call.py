"""The reference's basecall of sampled reads: window decodes and their path
probabilities, from the checkpoint, the raw ``.signal`` files and the batches
the call packs them into.

The program's batches are worked out again (``signal.batch_plan``): each
batch that holds a window of a sampled read is read from its files and run
through the reference's CNN front as a whole (batch norm takes its moments
over the batch); the sampled windows' features then go through the LSTM
stack, the head and the beam search, in blocks of rows.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable

import numpy as np
import torch

from benchmark.reference import beam, signal
from benchmark.reference.model import Reference, precision_flags

ALPHABET = "ACGT"
ROW_BLOCK = 1024


def labels_to_strings(decoded: torch.Tensor, lengths: torch.Tensor):
    dec = decoded.cpu().numpy()
    lens = lengths.cpu().numpy()
    lut = np.frombuffer(ALPHABET.encode(), np.uint8)
    return [lut[dec[i, :lens[i]]].tobytes().decode() for i in range(len(lens))]


def decode_rows(ref: Reference, features: torch.Tensor, frames: torch.Tensor, beam_width: int,
                length_bonus: float):
    """(strings, path probabilities, best-beam log masses) of feature rows."""
    strings, probs, scores = [], [], []
    for i in range(0, len(frames), ROW_BLOCK):
        f = features[i:i + ROW_BLOCK]
        n = frames[i:i + ROW_BLOCK]
        logits = ref.logits(f, n)
        dec, dlen, score = beam.decode(logits, n, beam_width, length_bonus)
        strings += labels_to_strings(dec, dlen)
        probs.append(beam.path_prob(logits).cpu().numpy())
        scores.append(score.cpu().numpy())
    return strings, np.concatenate(probs), np.concatenate(scores)


def reference_reads(model: Dict, call: Dict, input_dir: str, n_windows: Dict[str, int],
                    sampled: Iterable[str], precision: str, device) -> Dict[str, Dict]:
    """``{name: {"segments": [...], "probs": array}}`` for each sampled read
    of a call (``call``: batch_size, segment_len, jump, beam) over the
    ``.signal`` files named in ``n_windows``, in ``input_dir``, by the model
    of configuration ``model`` with its ``length_bonus``."""
    batch, seg, jump = call["batch_size"], call["segment_len"], call["jump"]
    ratio = seg / -(-seg // model["stride"])
    sampled = list(sampled)
    plan = signal.batch_plan(list(n_windows), n_windows, batch)
    where = {}
    for b, rows in enumerate(plan):
        for r, key in enumerate(rows):
            if key[0] in sampled and key not in where:
                where[key] = (b, r)
    cache: Dict[int, tuple] = {}

    def windows_of(name):
        path = os.path.join(input_dir, name + ".signal")
        inode = os.stat(path).st_ino  # the copies of one read are links to one file
        if inode not in cache:
            cache[inode] = signal.load_windows(path, jump, seg)
        return cache[inode]

    ref = Reference(model["model_dir"], model["front"], model["stride"], device, precision)
    feats, frames, keys = [], [], []
    with torch.no_grad(), precision_flags(precision):
        for b in sorted({b for b, _ in where.values()}):
            x = np.stack([windows_of(n)[0][i] for n, i in plan[b]])
            lens = np.asarray([windows_of(n)[1][i] for n, i in plan[b]])
            f = ref.features(torch.from_numpy(x).to(device))
            rows = [(key, r) for key, (bb, r) in where.items() if bb == b]
            idx = torch.tensor([r for _, r in rows], device=device)
            feats.append(f[idx])
            frames.append(np.round(lens[[r for _, r in rows]] / ratio).astype(np.int32))
            keys += [key for key, _ in rows]
        strings, probs, _ = decode_rows(
            ref, torch.cat(feats), torch.from_numpy(np.concatenate(frames)).to(device),
            call["beam"], model["model"]["length_bonus"])
    out = {n: {"segments": [None] * n_windows[n], "probs": np.zeros(n_windows[n])}
           for n in sampled}
    for (name, i), s, p in zip(keys, strings, probs):
        out[name]["segments"][i] = s
        out[name]["probs"][i] = p
    return out
