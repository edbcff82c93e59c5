"""The yardstick's counts: the card's peaks, the model's FLOPs a window, and
each kernel layer's operations and bytes, computed from the shapes alone.

Every product is counted once, as two FLOPs a multiply-add, whatever route
its kernel takes (a 3xTF32 product counts once, as the layer needs it, not
three times as one implementation does it). Each input byte is counted as
read once and each output byte as written once. So a roofline share reads
the same work whatever implements the layer.

The model count is the one of ``chiron_tpu_torch/tools/mfu.py:flop_terms``
(4.459 MFLOP a sample for the bundled DNA_default, 3 x 128, at window 400;
3.629 at the published 3 x 100; 1.181 for the bundled DNA_slow at
2,000): conv 2·k·C_in·C_out an output frame, projection 2·C_in·4H and
recurrence 2·H·4H a frame, direction and layer, and the head. It is taken
here from the checkpoint's weight shapes, with every layer at the model's
output frame rate, which holds for the configurations that name it
(``"frames_rate": "output"`` in their file). Elementwise work, batch norm,
the gates, the log-softmax and the decode are not counted.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Sequence

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {
    "bf16": 989e12,   # tensor cores, bf16 and fp16
    "tf32": 495e12,   # tensor cores, the fastest float32-operand rate
    "fp32": 67e12,    # CUDA cores, float32 without tensor cores
}
HBM_BYTES_PER_S = 3.35e12

# the checkpoint keys whose leaves are one product a frame each
_MATRIX_LEAVES = ("w", "wx", "wh", "w_dir", "w_class")


def model_flops_per_frame(shapes: Mapping[str, Sequence[int]]) -> float:
    """FLOPs of one output frame of the model whose checkpoint leaves have
    ``shapes`` (key -> shape): every conv kernel, projection, recurrent
    matrix and head matrix, once, at two FLOPs a multiply-add."""
    total = 0
    for key, shape in shapes.items():
        if key.rsplit("/", 1)[-1] in _MATRIX_LEAVES:
            total += math.prod(shape)
    return 2.0 * total


def model_flops_per_window(shapes: Mapping[str, Sequence[int]], frames: int) -> float:
    return model_flops_per_frame(shapes) * frames


def roofline_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


def conv_bn_work(convs: Iterable[Sequence[int]], batch: int, act_bytes: int,
                 in_bytes: int) -> Dict[str, float]:
    """One batch through the fused conv + batch-norm layers.

    ``convs``: one entry a launch, ``[k, c_in, c_out, t_in, t_out, terms]``,
    ``terms`` the raw tensors its prologue sums (a residual block's output
    is two). The first launch reads the window at ``in_bytes`` an element;
    every other reads and writes activations at ``act_bytes``. Bytes: each
    term read once, the weights, the output, the terms' affines and the
    output's two moments."""
    convs = [tuple(c) for c in convs]
    flops = nbytes = 0.0
    for i, (k, c_in, c_out, t_in, t_out, terms) in enumerate(convs):
        e_in = in_bytes if i == 0 else act_bytes
        flops += 2.0 * batch * t_out * k * c_in * c_out
        nbytes += (terms * batch * t_in * c_in * e_in + 4.0 * k * c_in * c_out
                   + batch * t_out * c_out * act_bytes + terms * 2 * 4.0 * c_in
                   + 2 * 4.0 * c_out)
    return {"flops": flops, "bytes": nbytes, "launches": float(len(convs))}


def bilstm_work(layers: int, hidden: int, frames_total: float, frames_padded: float,
                act_bytes: int) -> Dict[str, float]:
    """The BiLSTM inference layers of one batch: ``frames_total`` the frames
    the rows are active on (sum of the logit lengths), ``frames_padded``
    the batch times its window of frames. Each direction's recurrence is
    2·H·4H FLOPs an active (row, step); it reads its xw [T, B, 4H] and its
    recurrent matrix once and writes h [T, B, H]."""
    dirs = 2
    flops = layers * dirs * 2.0 * hidden * 4 * hidden * frames_total
    nbytes = layers * dirs * (frames_padded * 4 * hidden * act_bytes
                              + 4.0 * hidden * 4 * hidden + frames_padded * hidden * act_bytes)
    return {"flops": flops, "bytes": nbytes}


def beam_work(width: int, classes: int, frames_total: float, frames_padded: float,
              batch: int) -> Dict[str, float]:
    """The CTC prefix beam search and its traceback over one batch.

    Operations a row's active step: 8 a candidate (the two masses, the
    extend and its merge), 4·W² for the hash match of every extend against
    every stay, and cand·log2(cand) for the top-W selection, cand = W·C.
    Bytes: the float32 log-probabilities read once, the label a frame
    written once, the final masses written once (the per-step trace is the
    layer's own intermediate)."""
    cand = width * classes
    ops_step = 8 * cand + 4 * width * width + cand * math.log2(cand)
    flops = ops_step * frames_total
    nbytes = frames_padded * classes * 4.0 + frames_padded * 4.0 + 2 * batch * width * 4.0
    return {"flops": flops, "bytes": nbytes}


def lstm_grad_work(layers: int, hidden: int, frames_total: float, frames_padded: float
                   ) -> Dict[str, float]:
    """The training LSTM layers of one step, float32, forward and backward:
    each direction's recurrence 2·H·4H FLOPs an active (row, step) forward,
    and twice that backward (dh·whᵀ and the dwh sum). Bytes: the forward
    reads xw [T, B, 4H] and writes h and c [T, B, 2H]; the backward reads
    the gates it needs [T, B, 4H], c and dh [T, B, 2H], writes dxw
    [T, B, 4H] and dwh once; the recurrent matrix read once each way."""
    dirs = 2
    flops = layers * dirs * 3 * 2.0 * hidden * 4 * hidden * frames_total
    per_dir = frames_padded * 4.0 * (4 * hidden + 2 * hidden + 4 * hidden + 2 * hidden
                                     + 4 * hidden) + 3 * 4.0 * hidden * 4 * hidden
    return {"flops": flops, "bytes": layers * dirs * per_dir}
