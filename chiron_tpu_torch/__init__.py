"""chiron_tpu_torch — the Chiron basecaller in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``chiron_tpu`` that sits beside it and is held
against it with the same weights on the same inputs. It imports neither JAX
nor ``chiron_tpu``: the host-side modules it needs are its own copies.

Layering (bottom-up), mirroring ``chiron_tpu``:
  csrc/      hand-written CUDA kernels (conv+BN, BiLSTM, LSTM, GRU and BNLSTM
             layers, beam search, the training LSTM forward and backward)
  ops/       kernel wrappers (plain PyTorch version for CPU tensors) + CTC
             greedy decode
  models/    conv/residual/BiLSTM blocks as functions on tensors
  params.py  JAX params pytree (or bundled .npz) -> the port's model
  io/        .signal/.fast5 readers, windowing, writers
  assembly/  overlap-consensus stitching + phred quality scores
  eval/      the `call` pipeline: host producer -> device decode -> writer
  train/     the `train` loop: datasets, optimizers, EMA, checkpoints
  cli.py     `call` and `train` subcommands (``--device``, default cuda)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
missing GPU raises instead of falling back to the CPU.
"""

__version__ = "0.1.0"
