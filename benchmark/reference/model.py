"""Plain PyTorch reference of the bundled basecallers, from the checkpoint.

The forward pass of ``dna_model1`` and ``slow_model1`` with a stack of
bidirectional LSTMs and the direction-mixing head (reference:
chiron/cnn.py:234-262, 454-476, chiron/rnn.py:20-97), written from the
published description and the checkpoint's tree, with no kernel, no fused
layer and no batching of the program's:

- a conv is ``F.conv1d`` with XLA SAME padding, then batch norm over the
  current batch's (rows, frames) with biased variance and eps 1e-5 where the
  checkpoint holds a scale and an offset, then the activation;
- a residual block is relu(branch1(x) + conv2c(conv2b(conv2a(x))));
- an LSTM direction is the cell with gate order i, g, f, o and forget bias
  +1 over x @ wx + b, run on each row's first ``len`` frames (the backward
  direction on them reversed), zero past them; a layer's output is the two
  directions concatenated;
- the head mixes the two directions by ``w_dir`` and maps to the classes.

``precision`` says how the products are computed: ``"fp32"`` in float32
with TF32 off (the reference itself), ``"tf32"`` with TF32 on, or ``"fp8"``
with every product's two operands rounded to float8 e4m3 under a
per-tensor scale (the controls of the float32 and bf16 cells).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

_BN_EPS = 1e-5
_FORGET_BIAS = 1.0
_E4M3_MAX = 448.0
PRECISIONS = ("fp32", "tf32", "fp8")


def load_checkpoint(model_dir: str) -> Dict[str, np.ndarray]:
    """The flat checkpoint (key -> array) that ``model_dir/checkpoint`` names."""
    with open(os.path.join(model_dir, "checkpoint")) as f:
        name = f.read().strip().splitlines()[0]
    with np.load(os.path.join(model_dir, name)) as z:
        return {k: z[k] for k in z.files}


def weight_shapes(model_dir: str) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in load_checkpoint(model_dir).items()}


@contextlib.contextmanager
def precision_flags(precision: str):
    """TF32 on for ``"tf32"``, off otherwise, restored afterwards."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """The model of one configuration on ``device``, in ``precision``."""

    def __init__(self, model_dir: str, front: str, stride: int, device,
                 precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.w = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                  for k, v in load_checkpoint(model_dir).items()}
        self.front = front
        self.stride = stride
        self.precision = precision
        self.layers = len({k.split("/")[3] for k in self.w if k.startswith("rnn/stack/layers/")})

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

    # -- the front ---------------------------------------------------------------
    def conv(self, x: torch.Tensor, key: str, stride: int = 1, relu: bool = True):
        """x [B, C_in, T] -> [B, C_out, T'] (SAME), batch norm, activation."""
        w = self.w[key + "/w"]  # [k, C_in, C_out]
        k = w.shape[0]
        t = x.shape[-1]
        out_t = -(-t // stride)
        pad = max((out_t - 1) * stride + k - t, 0)
        xp = F.pad(x, (pad // 2, pad - pad // 2))
        y = F.conv1d(self.q(xp), self.q(w.permute(2, 1, 0).contiguous()), stride=stride)
        if key + "/bn_scale" in self.w:
            mean = y.mean(dim=(0, 2), keepdim=True)
            var = ((y - mean) ** 2).mean(dim=(0, 2), keepdim=True)
            y = ((y - mean) * torch.rsqrt(var + _BN_EPS) * self.w[key + "/bn_scale"][:, None]
                 + self.w[key + "/bn_offset"][:, None])
        return torch.relu(y) if relu else y

    def residual(self, x: torch.Tensor, key: str) -> torch.Tensor:
        identity = self.conv(x, key + "/branch1", relu=False)
        y = self.conv(x, key + "/conv2a")
        y = self.conv(y, key + "/conv2b")
        y = self.conv(y, key + "/conv2c", relu=False)
        return torch.relu(identity + y)

    def features(self, signal: torch.Tensor) -> torch.Tensor:
        """Windows [B, T] of one batch -> CNN features [B, T', 256]."""
        x = signal[:, None, :].float()
        if self.front == "slow_model1":
            x = self.conv(x, "cnn/front", stride=self.stride)
        elif self.front != "dna_model1":
            raise ValueError(f"no reference for the front {self.front!r}")
        for block in ("res1", "res2", "res3"):
            x = self.residual(x, "cnn/" + block)
        return x.transpose(1, 2)

    # -- the recurrent stack and the head -------------------------------------
    def lstm(self, x: torch.Tensor, key: str, lengths: torch.Tensor, reverse: bool):
        """x [B, T, C] -> h [B, T, H] over each row's first ``lengths`` frames."""
        bsz, t_max, _ = x.shape
        wx, wh, b = self.w[key + "/wx"], self.w[key + "/wh"], self.w[key + "/b"]
        h_dim = wh.shape[0]
        tidx = torch.arange(t_max, device=x.device)[None, :]
        if reverse:  # each row's valid frames in reverse order
            src = torch.where(tidx < lengths[:, None], lengths[:, None] - 1 - tidx, tidx)
            x = torch.gather(x, 1, src[:, :, None].expand(x.shape))
        xw = self.mm(x.reshape(bsz * t_max, -1), wx).reshape(bsz, t_max, 4 * h_dim) + b
        h = x.new_zeros((bsz, h_dim))
        c = x.new_zeros((bsz, h_dim))
        out = x.new_zeros((bsz, t_max, h_dim))
        for t in range(t_max):
            gates = xw[:, t] + self.mm(h, wh)
            i, g, f, o = gates.split(h_dim, dim=1)
            nc = torch.sigmoid(f + _FORGET_BIAS) * c + torch.sigmoid(i) * torch.tanh(g)
            nh = torch.sigmoid(o) * torch.tanh(nc)
            live = (t < lengths)[:, None]
            c = torch.where(live, nc, c)
            h = torch.where(live, nh, h)
            out[:, t] = torch.where(live, nh, torch.zeros_like(nh))
        if reverse:
            out = torch.gather(out, 1, src[:, :, None].expand(out.shape))
        return out

    def logits(self, features: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """CNN features [B, T, C] and logit lengths [B] -> logits [B, T, classes]."""
        x = features
        lengths = lengths.to(torch.int64)
        for i in range(self.layers):
            key = f"rnn/stack/layers/[{i}]"
            x = torch.cat([self.lstm(x, key + "/fw", lengths, False),
                           self.lstm(x, key + "/bw", lengths, True)], dim=-1)
        bsz, t_max, two_h = x.shape
        pair = x.reshape(bsz, t_max, 2, two_h // 2)
        merged = (self.q(pair) * self.q(self.w["rnn/head/w_dir"])).sum(dim=2) \
            + self.w["rnn/head/b_dir"]
        return self.mm(merged.reshape(bsz * t_max, -1), self.w["rnn/head/w_class"]).reshape(
            bsz, t_max, -1) + self.w["rnn/head/b_class"]
