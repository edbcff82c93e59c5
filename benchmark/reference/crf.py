"""The plain reference of the ``bonito_hac.call`` cell: Bonito's CTC-CRF
basecaller in Bonito's layout, the median / MAD windows of ``--sig_norm 0``,
and the assembly of the window decodes at jump / segment 0.875 (Chiron's
"simple" assembly), written without the program's modules or kernels.

A copy of the port's test reference (``chiron_tpu_torch/reference/
bonito_crf.py``), which follows ``bonito/crf/model.py`` (github.com/
nanoporetech/bonito: ``rnn_encoder``, ``LinearCRFEncoder``, ``CTC_CRF``) at the
settings of ``dna_r9.4.1_e8_hac@v3.3``'s ``config.toml`` in float32 with TF32
off; this copy adds the reads' windows and their assembly. Bonito has no
batch norm, so a window's decode does not depend on its batch: only the
sampled windows are run, in blocks of rows.

- Stem: three convs, each ``x`` padded ``k // 2`` zeros on both sides and a
  sum over the taps of ``x[t * stride + tap] @ W[:, :, tap].T``, plus the
  bias, then ``v * sigmoid(v)``: 1 -> 4 (k 5), 4 -> 16 (k 5), 16 -> features
  (k winlen, at the stride).
- Encoder: LSTM layers of ``torch.nn.LSTM``'s equations (gates i, f, g, o,
  both biases); layer i runs reversed in time where ``(layers - i) % 2``.
  Each row runs over its own ``n = ceil(samples / stride)`` frames only (a
  reversed layer over them in reverse), its state frozen and its output zero
  past them. Departure: Bonito flips the whole padded chunk, its chunks all
  being full length; a read's last window is shorter here.
- Head: ``scale * tanh(h @ W.T + b)`` viewed as [S, 4] and a constant
  ``blank_score`` column put in front: M [B, T, S, 5].
- Decode (``CTC_CRF.decode_batch``): ``idx[s, 0] = s``, ``idx[s, k + 1] = k S /
  4 + s // 4``; alpha_0 = 0, alpha_{t+1}[s] = logsumexp_c(alpha_t[idx[s, c]] +
  M[t, s, c]); beta_n = 0, beta_t the same sums through the transposed index;
  logZ = logsumexp_s(alpha_n); P = exp(alpha_t[idx] + M_t + beta_{t+1} - logZ);
  Viterbi by max-plus over log(P + 1e-8) from 0, ties to the lowest column
  and final state; a frame's label is its best path's column, 1..4 emitting
  "ACGT"[c - 1]. ``score`` is the path's sum; ``prob`` the mean over the
  row's frames of the gap between the two largest log(P + 1e-8) of the
  frame (the counterpart of the CTC caller's path probability, which the
  assembly's qualities read).
- Assembly (chiron/utils/easy_assembler.py:212-250, 302-335): the non-empty
  window decodes in order, each placed at the displacement that the
  matching blocks of ``difflib.SequenceMatcher(cur, prev)`` vote for under
  the log-probability model at error rate 0.2; base counts and the windows'
  ``prob`` summed per position; qualities as ``reference.assembly``'s.

``precision``: ``"fp32"`` (the reference), ``"tf32"`` (TF32 on), or
``"fp8"`` (each product's two operands rounded to float8 e4m3 under a
per-tensor scale): the controls one precision below a cell's.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

_E4M3_MAX = 448.0
PRECISIONS = ("fp32", "tf32", "fp8")
POSTERIOR_EPS = 1e-8
BASES = "ACGT"


@contextlib.contextmanager
def precision_flags(precision: str):
    """TF32 on for ``"tf32"``, off otherwise, restored afterwards."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def stem_shapes(features: int, winlen: int, stride: int) -> List[Tuple[int, int, int, int]]:
    """(C_in, C_out, k, stride) of the three convs."""
    return [(1, 4, 5, 1), (4, 16, 5, 1), (16, features, winlen, stride)]


def init_bonito(seed: int, features: int = 384, state_len: int = 5, winlen: int = 19,
                stride: int = 5, layers: int = 5,
                gains: Dict[str, float] = None) -> Dict[str, np.ndarray]:
    """Seeded weights in Bonito's layout from PyTorch's default inits of
    ``nn.Conv1d``, ``nn.LSTM`` and ``nn.Linear``, made in the model's order;
    ``gains`` ({"conv", "lstm", "head"}) multiplies each kind's weights (not
    its biases)."""
    state: Dict[str, np.ndarray] = {}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(seed))
        for i, (c_in, c_out, k, s) in enumerate(stem_shapes(features, winlen, stride)):
            m = torch.nn.Conv1d(c_in, c_out, k, stride=s, padding=k // 2, bias=True)
            state[f"encoder.{i}.conv.weight"] = m.weight.detach().numpy()
            state[f"encoder.{i}.conv.bias"] = m.bias.detach().numpy()
        for i in range(4, 4 + layers):
            m = torch.nn.LSTM(features, features)
            for name, p in m.named_parameters():
                state[f"encoder.{i}.rnn.{name}"] = p.detach().numpy()
        m = torch.nn.Linear(features, 4 ** (state_len + 1))
        state[f"encoder.{4 + layers}.linear.weight"] = m.weight.detach().numpy()
        state[f"encoder.{4 + layers}.linear.bias"] = m.bias.detach().numpy()
    gains = gains or {}

    def gain(key):
        if not key.endswith("weight") and ".rnn.weight" not in key:
            return 1.0
        kind = "conv" if ".conv." in key else "head" if ".linear." in key else "lstm"
        return float(gains.get(kind, 1.0))

    return {k: np.array(v * gain(k), np.float32) for k, v in state.items()}


def model_dims(state: Dict[str, np.ndarray]) -> Dict[str, int]:
    """features, layers, state_len and winlen from the weights' shapes."""
    layers = len({k.split(".")[1] for k in state if ".rnn." in k})
    conv = state["encoder.2.conv.weight"]
    head = state[f"encoder.{4 + layers}.linear.weight"]
    return {"features": conv.shape[0], "winlen": conv.shape[2], "layers": layers,
            "state_len": int(round(np.log(head.shape[0]) / np.log(4))) - 1}


class BonitoCRF:
    """The model of one set of weights on ``device``, in ``precision``."""

    def __init__(self, state: Dict[str, np.ndarray], device, stride: int = 5,
                 scale: float = 5.0, blank_score: float = 2.0, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.w = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                  for k, v in state.items()}
        self.dims = model_dims(state)
        self.stride, self.scale, self.blank = stride, float(scale), float(blank_score)
        self.precision = precision
        s = 4 ** self.dims["state_len"]
        n = s // 4
        st = torch.arange(s, device=device)
        self.idx = torch.stack([st] + [k * n + st // 4 for k in range(4)], dim=1)  # [S, 5]
        # the transposed index: the 5 edges (s, c), flat s * 5 + c, into each state
        order = torch.argsort(self.idx.reshape(-1), stable=True)
        self.idx_t = order.reshape(s, 5)

    # -- products ------------------------------------------------------------
    def q(self, t: torch.Tensor) -> torch.Tensor:
        """A product's operand in this precision."""
        if self.precision != "fp8":
            return t
        amax = t.detach().abs().amax()
        scale = torch.where(amax > 0, _E4M3_MAX / amax, torch.ones_like(amax))
        return (t * scale).to(torch.float8_e4m3fn).float() / scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    # -- the model -----------------------------------------------------------
    def conv(self, x: torch.Tensor, i: int, stride: int) -> torch.Tensor:
        """x [B, T, C_in] -> swish(conv + bias) [B, T', C_out], k // 2 padding."""
        w = self.w[f"encoder.{i}.conv.weight"]  # [C_out, C_in, k]
        k = w.shape[2]
        xp = torch.nn.functional.pad(x, (0, 0, k // 2, k // 2))
        t_out = (xp.shape[1] - k) // stride + 1
        y = None
        for tap in range(k):
            xi = xp[:, tap:tap + (t_out - 1) * stride + 1:stride]
            yi = self.mm(xi, w[:, :, tap].T)
            y = yi if y is None else y + yi
        y = y + self.w[f"encoder.{i}.conv.bias"]
        return y * torch.sigmoid(y)

    def stem(self, windows: torch.Tensor) -> torch.Tensor:
        """Windows [B, L] -> features [B, ceil(L / stride), features]."""
        x = windows.float()[:, :, None]
        for i, (_, _, _, s) in enumerate(stem_shapes(self.dims["features"],
                                                     self.dims["winlen"], self.stride)):
            x = self.conv(x, i, s)
        return x

    def lstm(self, x: torch.Tensor, i: int, lengths: torch.Tensor, reverse: bool):
        """torch.nn.LSTM's layer over each row's first ``lengths`` frames."""
        bsz, t_max, _ = x.shape
        p = f"encoder.{i}.rnn."
        w_ih, w_hh = self.w[p + "weight_ih_l0"], self.w[p + "weight_hh_l0"]
        bias = self.w[p + "bias_ih_l0"] + self.w[p + "bias_hh_l0"]
        h_dim = w_hh.shape[1]
        tidx = torch.arange(t_max, device=x.device)[None, :]
        if reverse:
            src = torch.where(tidx < lengths[:, None], lengths[:, None] - 1 - tidx, tidx)
            x = torch.gather(x, 1, src[:, :, None].expand(x.shape))
        xw = self.mm(x.reshape(bsz * t_max, -1), w_ih.T).reshape(bsz, t_max, -1) + bias
        h = x.new_zeros((bsz, h_dim))
        c = x.new_zeros((bsz, h_dim))
        out = x.new_zeros((bsz, t_max, h_dim))
        for t in range(t_max):
            gates = xw[:, t] + self.mm(h, w_hh.T)
            gi, gf, gg, go = gates.split(h_dim, dim=1)
            nc = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            nh = torch.sigmoid(go) * torch.tanh(nc)
            live = (t < lengths)[:, None]
            c = torch.where(live, nc, c)
            h = torch.where(live, nh, h)
            out[:, t] = torch.where(live, nh, torch.zeros_like(nh))
        if reverse:
            out = torch.gather(out, 1, src[:, :, None].expand(out.shape))
        return out

    def encode(self, windows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Windows [B, L] and frames [B] -> the LSTMs' output [B, T, features]."""
        x = self.stem(windows)
        lengths = lengths.to(torch.int64)
        n = self.dims["layers"]
        for j in range(n):
            x = self.lstm(x, 4 + j, lengths, reverse=(n - j) % 2 == 1)
        return x

    def scores(self, h: torch.Tensor) -> torch.Tensor:
        """Features [B, T, F] -> M [B, T, S, 5] (the blank column first)."""
        bsz, t_max, f = h.shape
        head = f"encoder.{4 + self.dims['layers']}.linear."
        z = self.mm(h.reshape(bsz * t_max, f), self.w[head + "weight"].T) + self.w[head + "bias"]
        z = self.scale * torch.tanh(z).reshape(bsz, t_max, -1, 4)
        return torch.nn.functional.pad(z, (1, 0), value=self.blank)

    # -- the decode ----------------------------------------------------------
    def decode(self, m: torch.Tensor, lengths: torch.Tensor):
        """M [B, T, S, 5] and frames [B] -> (path columns [B, T] int64, -1 past
        each length; score [B]; prob [B]; log(P + 1e-8) [B, T, S, 5], zero
        past each length)."""
        bsz, t_max, s, _ = m.shape
        lengths = lengths.to(torch.int64)
        alphas = [m.new_zeros((bsz, s))]
        for t in range(t_max):
            a = torch.logsumexp(alphas[-1][:, self.idx] + m[:, t], dim=2)
            alphas.append(torch.where((t < lengths)[:, None], a, alphas[-1]))
        log_z = torch.logsumexp(alphas[-1], dim=1)
        betas = [m.new_zeros((bsz, s))]
        for t in range(t_max - 1, -1, -1):
            e = (betas[-1][:, :, None] + m[:, t]).reshape(bsz, s * 5)
            b = torch.logsumexp(e[:, self.idx_t], dim=2)
            betas.append(torch.where((t < lengths)[:, None], b, torch.zeros_like(b)))
        betas = betas[::-1]  # betas[t] = beta_t
        logp = m.new_zeros(m.shape)
        v = m.new_zeros((bsz, s))
        back = torch.zeros((bsz, t_max, s), dtype=torch.int64, device=m.device)
        gaps = m.new_zeros(bsz)
        for t in range(t_max):
            live = (t < lengths)
            lp = alphas[t][:, self.idx] + m[:, t] + betas[t + 1][:, :, None] - log_z[:, None, None]
            lpe = torch.log(torch.exp(lp) + POSTERIOR_EPS)
            best, arg = torch.max(v[:, self.idx] + lpe, dim=2)
            v = torch.where(live[:, None], best, v)
            back[:, t] = arg
            logp[:, t] = torch.where(live[:, None, None], lpe, torch.zeros_like(lpe))
            top2 = torch.topk(lpe.reshape(bsz, -1), 2, dim=1).values
            gaps = gaps + torch.where(live, top2[:, 0] - top2[:, 1], torch.zeros_like(gaps))
        score, state = torch.max(v, dim=1)
        path = torch.full((bsz, t_max), -1, dtype=torch.int64, device=m.device)
        rows = torch.arange(bsz, device=m.device)
        for t in range(t_max - 1, -1, -1):
            live = t < lengths
            col = back[rows, t, state]
            path[:, t] = torch.where(live, col, path[:, t])
            state = torch.where(live, self.idx[state, col], state)
        return path, score, gaps / torch.clamp(lengths, min=1).float(), logp

    def basecall(self, windows: torch.Tensor, lengths: torch.Tensor):
        """(bases a window, score [B], prob [B]) of windows [B, L] of
        ``lengths`` frames."""
        with precision_flags(self.precision):
            path, score, prob, _ = self.decode(self.scores(self.encode(windows, lengths)),
                                               lengths)
        return path_strings(path), score, prob


def path_strings(path: torch.Tensor) -> List[str]:
    """The bases each row's path emits: "ACGT"[c - 1] for its columns c >= 1."""
    lut = np.frombuffer(("?" + BASES).encode(), np.uint8)
    out = []
    for row in path.cpu().numpy():
        row = row[row >= 1]
        out.append(lut[row].tobytes().decode())
    return out


def window_frames(samples, stride: int = 5) -> np.ndarray:
    """The frames of windows of ``samples`` samples: ceil(samples / stride)."""
    return (np.asarray(samples, np.int64) + stride - 1) // stride


# -- the reads: windows of --sig_norm 0 -------------------------------------------

def normalize_median(signal: np.ndarray) -> np.ndarray:
    """(x - median) / MAD in float32, the MAD scaled to a standard deviation
    (1 / 0.6744897501960817; chiron/chiron_input.py:527-539, Bonito's
    ``med_mad`` at its factor 1.4826)."""
    signal = np.asarray(signal, np.float32)
    if len(signal) == 0:
        return signal
    mad = float(np.median(np.abs(signal - np.median(signal))) / 0.6744897501960817)
    return (signal - np.median(signal)) / np.float32(mad)


def load_windows(path: str, jump: int, seg: int) -> Tuple[np.ndarray, np.ndarray]:
    """(windows [N, seg] float32, samples [N] int32) of a ``.signal`` read."""
    from benchmark.reference import signal

    return signal.window(normalize_median(signal.read_signal(path)), jump, seg)


# -- the assembly at jump / segment <= 0.9 (chiron/utils/easy_assembler.py) -------

def simple_displacement(cur: str, prev: str, jump_ratio: float, error_rate: float = 0.2) -> int:
    """The offset of ``cur`` after ``prev`` that the matching blocks vote for."""
    import difflib
    import math

    back_ratio = 6.5 * 10e-4
    p_same = 1 - 2 * error_rate + 26 / 25 * (error_rate ** 2)
    votes: Dict[int, int] = {}
    for block in difflib.SequenceMatcher(a=cur, b=prev).get_matching_blocks():
        offset = block[1] - block[0]
        votes[offset] = votes.get(offset, 0) + block[2]
    log_same = np.log(p_same / 0.25)
    log_px = {}
    for key, same in votes.items():
        k = -key if key < 0 else key
        rate = back_ratio * len(cur) * jump_ratio if key < 0 else len(cur) * jump_ratio
        log_px[key] = k * np.log(rate) - math.lgamma(k + 1) + same * log_same + 0.0
    return max(log_px, key=log_px.get)


def assemble(segments, probs, jump_ratio: float) -> Tuple[np.ndarray, np.ndarray]:
    """(counts [4, L], summed probabilities [4, L]) of the non-empty windows."""
    keep = [i for i, s in enumerate(segments) if s]
    total = sum(len(segments[i]) for i in keep) + 1
    counts = np.zeros((4, total))
    qsum = np.zeros((4, total))
    pos = length = 0
    for n, i in enumerate(keep):
        seg = segments[i]
        disp = 0 if n == 0 else simple_displacement(seg, segments[keep[n - 1]], jump_ratio)
        start = max(pos + disp, 0) if n else 0
        if n and pos + disp < 0:
            seg = seg[-(pos + disp):]
        if seg:
            idx = np.asarray([BASES.index(c) for c in seg], np.int64)
            cols = np.arange(start, start + len(seg))
            np.add.at(counts, (idx, cols), 1)
            np.add.at(qsum, (idx, cols), float(probs[i]))
        if n:
            pos += disp
        length = max(length, start + len(seg))
    return counts[:, :length], qsum[:, :length]


def read_numbers(observed: Dict[str, Dict], reference: Dict[str, Dict],
                 jump_ratio: float) -> Dict[str, float]:
    """``window_edit``, ``consensus_diff`` and ``quality_gap`` of the sampled
    reads, as ``reference.compare.read_numbers`` takes them, with this
    assembly."""
    from benchmark.reference import assembly, compare

    obs_segs: List[str] = []
    ref_segs: List[str] = []
    diff = 0
    qgap = 0.0
    qn = 0
    for name, obs in observed.items():
        ref = reference[name]
        if len(obs["segments"]) != len(ref["segments"]):
            raise ValueError(f"{name}: {len(obs['segments'])} window decodes written, "
                             f"{len(ref['segments'])} windows in the read")
        obs_segs += obs["segments"]
        ref_segs += ref["segments"]
        counts, qsum = assemble(obs["segments"], ref["probs"], jump_ratio)
        cons = assembly.consensus(counts)
        qref = assembly.quality_values(counts, qsum)
        seq, qual = obs["consensus"], obs["quality"]
        n = min(len(seq), len(cons))
        diff += abs(len(seq) - len(cons)) + sum(a != b for a, b in zip(seq[:n], cons[:n]))
        qobs = np.frombuffer(qual.encode(), np.uint8).astype(int)[:n] - 33
        qgap += float(np.abs(qobs - qref[:n]).sum())
        qn += n
    return {"window_edit": compare.window_edit(obs_segs, ref_segs),
            "consensus_diff": float(diff),
            "quality_gap": qgap / max(qn, 1)}


ROW_BLOCK = 64


def reference_reads(state: Dict[str, np.ndarray], model: Dict, paths: Dict[str, str],
                    jump: int, seg: int, precision: str, device) -> Dict[str, Dict]:
    """``{name: {"segments", "probs", "scores", "windows", "frames"}}`` of each
    read ``paths[name]`` (a ``.signal`` file), its windows decoded in blocks
    of ``ROW_BLOCK`` rows by the model of the weights ``state``."""
    ref = BonitoCRF(state, device, stride=model["stride"], scale=model["scale"],
                    blank_score=model["blank_score"], precision=precision)
    out = {}
    cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    with torch.no_grad():
        for name, path in paths.items():
            inode = os.stat(path).st_ino  # a read's copies are links to one file
            if inode not in cache:
                w, n = load_windows(path, jump, seg)
                frames = window_frames(n, model["stride"])
                strings, probs, scores = [], [], []
                for i in range(0, len(w), ROW_BLOCK):
                    s_, sc, pr = ref.basecall(torch.from_numpy(w[i:i + ROW_BLOCK]).to(device),
                                              torch.from_numpy(frames[i:i + ROW_BLOCK]).to(device))
                    strings += s_
                    scores.append(sc.cpu().numpy())
                    probs.append(pr.cpu().numpy())
                cache[inode] = (w, frames, strings, np.concatenate(probs), np.concatenate(scores))
            w, frames, strings, probs, scores = cache[inode]
            out[name] = {"segments": strings, "probs": probs, "scores": scores, "windows": w,
                         "frames": frames}
    return out
