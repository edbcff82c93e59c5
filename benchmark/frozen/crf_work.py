"""The yardstick's counts for the CRF configurations (Bonito's CTC-CRF
models), computed from the configuration's shapes alone, as ``work.py``
counts the CTC ones: every product once at two FLOPs a multiply-add, every
byte in and out once, whatever route a kernel takes.

``work.py``'s model count takes every layer at the output frame rate
(``"frames_rate": "output"``); Bonito's first two convs run at the input's
rate (4,000 samples a window, 800 frames), so the model count is written out
here layer by layer: conv 2·k·C_in·C_out an output sample of the conv, each
LSTM layer 2·F·4F (projection) + 2·F·4F (recurrence) a frame, the head
2·F·4^(state_len + 1) a frame. At Bonito's HAC widths (features 384, 5
layers, state_len 5, winlen 19, stride 5) and a 4,000-sample window:
0.1895 + 9.437 + 2.517 = 12.14 GFLOP a window.
"""

from __future__ import annotations

from typing import Dict, Mapping

from benchmark.frozen.work import PEAKS, roofline_seconds  # noqa: F401 (the readers' own)


def stem_shapes(cfg: Mapping) -> list:
    """[k, c_in, c_out, stride] of each conv of the configuration's stem."""
    return [list(s) for s in cfg["stem"]]


def model_flops_per_window(cfg: Mapping, samples: int) -> float:
    """FLOPs of one window of ``samples`` samples through the whole model."""
    f, layers, s4 = cfg["features"], cfg["layers"], 4 ** (cfg["state_len"] + 1)
    flops, t = 0.0, samples
    for k, c_in, c_out, stride in stem_shapes(cfg):
        t = -(-t // stride)  # k odd, padded k // 2 on both sides: ceil(t / stride)
        flops += 2.0 * k * c_in * c_out * t
    flops += layers * (2.0 * f * 4 * f + 2.0 * f * 4 * f) * t
    flops += 2.0 * f * s4 * t
    return flops


def lstm_work(layers: int, hidden: int, frames_total: float, frames_padded: float,
              act_bytes: int) -> Dict[str, float]:
    """The single-direction LSTM layers of one batch (one kernel launch a
    layer): the recurrence's 2·H·4H FLOPs an active (row, frame); bytes: its
    xw [T, B, 4H] read and h [T, B, H] written at ``act_bytes``, and its
    float32 recurrent matrix read once. The projections are ``torch.matmul``
    calls outside the kernel and are not counted here."""
    flops = layers * 2.0 * hidden * 4 * hidden * frames_total
    nbytes = layers * (frames_padded * 4 * hidden * act_bytes + 4.0 * hidden * 4 * hidden
                       + frames_padded * hidden * act_bytes)
    return {"flops": flops, "bytes": nbytes}


def crf_decode_work(states: int, frames_total: float, batch: int) -> Dict[str, float]:
    """The CRF decode of one batch over ``frames_total`` row-frames (each
    row's own frames): the forward-backward posteriors and Viterbi over
    their logs.

    Bytes: the scores of each row-frame (4 S float32; the blank column is a
    constant) read in each of the two scans the decode needs, one a
    direction (the forward scan forms alpha, the posteriors and the
    Viterbi step together: they need beta of the frame after, so beta
    [frames, S] float32 is written by the backward scan and read once); one
    traceback byte a (frame, state) written, and a byte a frame read back
    along the path; the path's column a frame (int32) and three float32 a
    row written. Operations a (row-frame, state): 5 edges, each an add and
    an exp in each direction's logsumexp, an add, an exp, a log and a max in
    the posterior and Viterbi step, and the logsumexp's log twice: 32."""
    s4 = 4 * states
    nbytes = frames_total * (2 * 4.0 * s4 + 2 * 4.0 * states + states + 1 + 4) + 12.0 * batch
    flops = 32.0 * states * frames_total
    return {"flops": flops, "bytes": nbytes}
