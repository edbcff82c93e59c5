"""The comparison that decides ``correct``, shown to fail.

Each test drives the rest of a run on the CPU at a tiny size (the look for
a card skipped, the program on its plain CPU paths), with the timed path
broken underneath (``benchmark/faults.py``), and sees ``correct`` come out
false for every fault the cell can have: a token or an answer altered where
it is produced, half of a batch left out, a training step that leaves its
state unchanged. The sound run comes out true, and the control (the
reference in a lower precision, put in the program's place) comes out false.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import faults
from benchmark import harness as H

torch.set_num_threads(2)

TINY_READS = {"n_reads": 2, "median_bases": 300, "sigma": 0.3, "min_bases": 200,
              "max_bases": 600, "sim": {"mean_dwell": 9.0}}


def _ctx(tmp_path, cell_name, **mix_changes):
    bench = H.manifest()
    cell = H.cell(cell_name, bench)
    mix = dict(H.traffic(cell["traffic"]))
    mix.update(mix_changes)
    return H.Context(cell=cell, config=H.config(cell["config"], bench), traffic=mix,
                     seed=2**31 + 101, seconds=0.01, trace=False, workdir=str(tmp_path),
                     t0=time.time(), device=torch.device("cpu"))


def _call_ctx(tmp_path):
    # at 15 samples a base a window holds ~26 bases, so one label altered a window reads
    # ~0.046 here, where the sound CPU path reads ~0.014: at the cell's own size on the card
    # (9 samples a base) the bf16 path reads 0.015-0.024 and the fault 0.036-0.046
    flags = list(H.traffic("dna_fast_reads")["flags"]) + ["--device", "cpu"]
    reads = dict(TINY_READS, sim={"mean_dwell": 15.0})
    return _ctx(tmp_path, "dna_default.call", reads=reads, copies=2, warm_reads=1,
                batch_size=8, check_reads=2, flags=flags)


def _train_ctx(tmp_path):
    return _ctx(tmp_path, "dna_default.train", reads=TINY_READS, batch_size=4)


CASES = {"call": _call_ctx, "train": _train_ctx}


@pytest.mark.parametrize("runner,fault", [(d, f) for d in sorted(faults.FAULTS)
                                          for f in [None] + sorted(faults.FAULTS[d])])
def test_fault_makes_the_run_incorrect(runner, fault, tmp_path, monkeypatch):
    if fault is not None:
        faults.plant(runner, fault, monkeypatch.setattr)
    ctx = CASES[runner](tmp_path)
    out = H.runner(runner).run(ctx)
    correct = out.failed == 0 and H.judge(out.numbers, H.limits(ctx.cell["name"]))
    assert correct == (fault is None), out.numbers


@pytest.mark.parametrize("runner", sorted(CASES))
def test_control_is_incorrect(runner, tmp_path):
    """The control at the CPU's size: the reference in fp8 put in the
    program's place (TF32, the card's control of the float32 cells, does
    not exist on the CPU)."""
    ctx = CASES[runner](tmp_path)
    assert not H.judge(H.runner(runner).control(ctx, "fp8"), H.limits(ctx.cell["name"]))


def test_patch_undoes_itself():
    from chiron_tpu_torch.eval import pipeline

    real = pipeline.decode_step
    p = faults.Patch()
    faults.plant("call", "half_batch", p)
    assert pipeline.decode_step is not real
    p.undo()
    assert pipeline.decode_step is real
