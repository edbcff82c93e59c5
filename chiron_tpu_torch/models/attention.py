"""Experimental attention decode head (parity: chiron/utils/attention.py).

Port of ``chiron_tpu/models/attention.py``: a Bahdanau-attention GRU
decoder over the encoder features, trained with teacher forcing, decoding
with greedy argmax. Kept out of the main basecall path, as in the reference
(utils/attention.py:13-203) and the JAX package. Plain PyTorch: the JAX
package runs it through ``lax.scan`` with no Pallas kernel. Its GRU cell is
the JAX package's, which applies the reset gate before the recurrent
product, ``(r * h) @ wh`` (``nn.GRU`` applies it after).
``params.attention_from_jax`` carries a JAX tree of these weights across.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from chiron_tpu_torch.config import NUM_CLASSES
from chiron_tpu_torch.models.initializers import xavier_uniform

Params = Dict[str, Any]

GO_TOKEN = NUM_CLASSES  # decoder input vocabulary adds a <go> symbol
_MASKED = -1e30  # float32 score of a frame past a window's length


def init_attention_decoder(gen: torch.Generator, enc_dim: int, hidden: int,
                           class_n: int = NUM_CLASSES) -> Params:
    """Fresh weights (float32 CPU tensors drawn from ``gen``), in the JAX
    package's tree layout."""
    return {
        "embed": xavier_uniform(gen, (class_n + 1, hidden)),
        # Bahdanau score: v^T tanh(W_e e + W_h h)
        "att_we": xavier_uniform(gen, (enc_dim, hidden)),
        "att_wh": xavier_uniform(gen, (hidden, hidden)),
        "att_v": xavier_uniform(gen, (hidden, 1)),
        # GRU over [embed, context]
        "gru_wx": xavier_uniform(gen, (hidden + enc_dim, 3 * hidden)),
        "gru_wh": xavier_uniform(gen, (hidden, 3 * hidden)),
        "gru_b": torch.zeros(3 * hidden),
        "out_w": xavier_uniform(gen, (hidden + enc_dim, class_n)),
        "out_b": torch.zeros(class_n),
    }


def _gru_cell(params: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    hd = h.shape[-1]
    gates = x @ params["gru_wx"][:, :2 * hd] + h @ params["gru_wh"][:, :2 * hd] \
        + params["gru_b"][:2 * hd]
    r, u = torch.sigmoid(gates).split(hd, dim=-1)
    cand = torch.tanh(x @ params["gru_wx"][:, 2 * hd:] + (r * h) @ params["gru_wh"][:, 2 * hd:]
                      + params["gru_b"][2 * hd:])
    return u * h + (1 - u) * cand


def _attend(params: Params, enc: torch.Tensor, enc_proj: torch.Tensor,
            enc_mask: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc [B, T, E], enc_proj = enc @ att_we, h [B, H] -> context [B, E],
    weights [B, T]."""
    score = torch.tanh(enc_proj + (h @ params["att_wh"])[:, None, :])
    logits = (score @ params["att_v"])[..., 0]  # [B, T]
    logits = torch.where(enc_mask, logits, torch.full_like(logits, _MASKED))
    weights = torch.softmax(logits, dim=-1)
    context = torch.einsum("bt,bte->be", weights, enc)
    return context, weights


def _step(params: Params, enc, enc_proj, enc_mask, h, tok):
    """One decoder step: the new state and the step's logits [B, C]."""
    emb = params["embed"][tok]
    context, _ = _attend(params, enc, enc_proj, enc_mask, h)
    h = _gru_cell(params, torch.cat([emb, context], -1), h)
    return h, torch.cat([h, context], -1) @ params["out_w"] + params["out_b"]


def _setup(params: Params, encodings: torch.Tensor, enc_lengths: torch.Tensor):
    b, t, _ = encodings.shape
    enc_mask = torch.arange(t, device=encodings.device)[None, :] \
        < enc_lengths.to(encodings.device, torch.int64)[:, None]
    h0 = torch.zeros(b, params["att_wh"].shape[0], device=encodings.device)
    return encodings @ params["att_we"], enc_mask, h0


def attention_decode(params: Params, encodings: torch.Tensor, enc_lengths: torch.Tensor,
                     max_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy attention decoding.

    Returns (tokens [B, max_steps] int32, logits [B, max_steps, C]).
    """
    enc_proj, enc_mask, h = _setup(params, encodings, enc_lengths)
    tok = torch.full((encodings.shape[0],), GO_TOKEN, dtype=torch.int64,
                     device=encodings.device)
    tokens, logits = [], []
    for _ in range(max_steps):
        h, step_logits = _step(params, encodings, enc_proj, enc_mask, h, tok)
        tok = step_logits.argmax(dim=-1)  # first max on ties, as jnp.argmax
        tokens.append(tok)
        logits.append(step_logits)
    return torch.stack(tokens, 1).to(torch.int32), torch.stack(logits, 1)


def teacher_forced_logits(params: Params, encodings: torch.Tensor, enc_lengths: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """The decoder's logits [B, U, C] fed <go> and targets[:, :-1]."""
    b, u = targets.shape
    enc_proj, enc_mask, h = _setup(params, encodings, enc_lengths)
    targets = targets.to(encodings.device, torch.int64)
    # a -1 pad indexes the last embedding row, as in the JAX package
    inputs = torch.cat([torch.full((b, 1), GO_TOKEN, dtype=torch.int64,
                                   device=encodings.device), targets[:, :-1]], dim=1)
    logits = []
    for step in range(u):
        h, step_logits = _step(params, encodings, enc_proj, enc_mask, h, inputs[:, step])
        logits.append(step_logits)
    return torch.stack(logits, 1)


def attention_teacher_forcing_loss(params: Params, encodings: torch.Tensor,
                                   enc_lengths: torch.Tensor, targets: torch.Tensor,
                                   target_lengths: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with teacher forcing (training objective)."""
    u = targets.shape[1]
    logp = torch.log_softmax(teacher_forced_logits(params, encodings, enc_lengths, targets),
                             dim=-1)  # [B, U, C]
    targets = targets.to(encodings.device, torch.int64)
    tgt = targets.clamp(0, NUM_CLASSES - 1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = (torch.arange(u, device=encodings.device)[None, :]
            < target_lengths.to(encodings.device, torch.int64)[:, None]).to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp(min=1)
