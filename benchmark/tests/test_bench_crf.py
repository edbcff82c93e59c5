"""The ``bonito_hac.call`` cell's own pieces: the reference copy against
``torch.nn`` and its assembly against the program's, the frozen count, the
per-layer readers on a synthetic trace, and the comparison that decides
``correct`` failing under each planted fault on a small CPU run (features
16, state_len 2, 400-sample windows at jump 350: the same jump / segment
ratio and so the same assembly as the cell's 3,500 / 4,000)."""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

from benchmark import harness as H
from benchmark import trace as T
from benchmark.frozen import crf_work
from benchmark.reference import crf as RC
from benchmark.runners import crf_call

torch.set_num_threads(2)

CELL = "bonito_hac.call"
MS = 1_000_000  # ns


def test_reference_copy_matches_torch_nn():
    state = RC.init_bonito(3, features=16, state_len=2, layers=2, gains={"conv": 3.0})
    ref = RC.BonitoCRF(state, "cpu")
    w = {k: torch.from_numpy(v) for k, v in state.items()}
    x = torch.randn(2, 300, generator=torch.Generator().manual_seed(0))
    y = x[:, None, :]
    for i, (c_in, c_out, k, s) in enumerate(RC.stem_shapes(16, 19, 5)):
        conv = torch.nn.Conv1d(c_in, c_out, k, stride=s, padding=k // 2)
        conv.load_state_dict({"weight": w[f"encoder.{i}.conv.weight"],
                              "bias": w[f"encoder.{i}.conv.bias"]})
        y = torch.nn.functional.silu(conv(y))
    with torch.no_grad():
        h = y.permute(2, 0, 1)
        for j in range(2):
            lstm = torch.nn.LSTM(16, 16)
            lstm.load_state_dict({n: w[f"encoder.{4 + j}.rnn.{n}"]
                                  for n, _ in lstm.named_parameters()})
            rev = (2 - j) % 2 == 1
            out = lstm(h.flip(0) if rev else h)[0]
            h = out.flip(0) if rev else out
        lin = torch.nn.Linear(16, 64)
        lin.load_state_dict({"weight": w["encoder.6.linear.weight"],
                             "bias": w["encoder.6.linear.bias"]})
        want = 5.0 * torch.tanh(lin(h.transpose(0, 1)))
        got = ref.scores(ref.encode(x, torch.tensor([60, 60])))
    assert torch.all(got[..., 0] == 2.0)
    assert float((got[..., 1:].reshape(want.shape) - want).abs().max()) < 1e-4


def test_reference_assembly_equals_the_programs():
    from chiron_tpu_torch.assembly import consensus as P

    rng = np.random.RandomState(0)
    truth = "".join(rng.choice(list("ACGT"), 3000))
    segs, probs = [], []
    for start in range(0, 2800, 220):
        s = list(truth[start:start + 250 + rng.randint(-20, 20)])
        for _ in range(8):
            s[rng.randint(len(s))] = "ACGT"[rng.randint(4)]
        segs.append("".join(s) if start != 440 else "")
        probs.append(rng.rand())
    segs.append("ACG")
    probs.append(0.5)
    keep = [i for i, s in enumerate(segs) if s]
    counts, qsum = RC.assemble(segs, probs, 0.875)
    pc, pq = P.simple_assembly_qs([segs[i] for i in keep], np.asarray(probs)[keep][:, None],
                                  0.875, kernel=P.get_assembler_kernel(3500, 4000))
    assert P.get_assembler_kernel(3500, 4000) == "simple"
    assert np.array_equal(counts, pc) and np.allclose(qsum, pq)


def test_frozen_count_at_the_published_widths():
    cfg = H.config("Bonito_HAC_r941")
    assert crf_work.model_flops_per_window(cfg, 4000) == pytest.approx(12.14e9, rel=1e-3)
    w = crf_work.lstm_work(5, 384, 800 * 400, 800 * 400, 2)
    assert w["flops"] == pytest.approx(5 * 1.18e6 * 800 * 400, rel=1e-2)


WORK = {"windows": 400.0, "batches": 1.0, "frames": 300000.0, "frames_padded": 320000.0,
        "calls": 1.0}


def _synthetic(with_kernels=True):
    dev = [("void conv_bn_mma_kernel<float, true>(...)", 0, 20 * MS),
           ("void lstm_infer_kernel<float, 13, true>(...)", 20 * MS, 600 * MS),
           ("void (anonymous namespace)::crf_beta_kernel<2>(...)", 600 * MS, 700 * MS),
           ("void (anonymous namespace)::crf_viterbi_kernel<2>(...)", 700 * MS, 800 * MS),
           ("(anonymous namespace)::crf_traceback_kernel(...)", 800 * MS, 810 * MS),
           ("Memcpy HtoD (Pageable -> Device)", 810 * MS, 850 * MS)]
    return T.reduce_trace(0, 1000 * MS, dev if with_kernels else [], [])


def _reader_ctx(trace):
    bench = H.manifest()
    cell = H.cell(CELL, bench)
    return H.ReaderContext(cell=cell, config=H.config(cell["config"], bench),
                           traffic=H.traffic(cell["traffic"]), trace=trace, work=WORK)


def test_readers_on_a_synthetic_trace():
    from chiron_tpu_torch.utils import timing

    ctx = _reader_ctx(_synthetic())
    metrics = H.per_layer_of(H.manifest(), CELL)
    assert {m["name"] for m in metrics} == {"hac.idle_share", "hac.mfu", "hac_lstm_roofline",
                                            "crf_decode_roofline", "hac.crf_span_share",
                                            "hac_stem_roofline"}
    timing.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timing.span("call.step"):
            with timing.span("model.crf_decode"):
                time.sleep(0.002)
    try:
        for m in metrics:
            value = H.reader(m["name"]).read(ctx)
            assert value is not None and 0.0 < value <= 100.0, (m["name"], value)
        assert H.reader("hac.idle_share").read(ctx) == pytest.approx(15.0)
        empty = _reader_ctx(_synthetic(with_kernels=False))
        for m in metrics:
            if "roofline" in m["name"]:
                assert H.reader(m["name"]).read(empty) is None
        timing.clear_spans()
        assert H.reader("hac.crf_span_share").read(ctx) is None  # no span recorded
    finally:
        timing.clear_spans()


def _tiny_ctx(tmp_path):
    """The cell at a CPU's size: features 16, state_len 2, 2 reads x 2 copies."""
    bench = H.manifest()
    cell = H.cell(CELL, bench)
    cfg = copy.deepcopy(H.config(cell["config"], bench))
    f = 16
    cfg.update(features=f, state_len=2, stem=[[5, 1, 4, 1], [5, 4, 16, 1], [19, 16, f, 5]])
    cfg["model"]["cnn"]["features"] = f
    cfg["model"]["rnn"]["hidden_num"] = f
    cfg["model"]["decoder"]["state_len"] = 2
    cfg["weights"]["gains"] = {"conv": 3.0, "lstm": 3.0, "head": 3.0}
    mix = dict(H.traffic(cell["traffic"]))
    mix.update(reads={"n_reads": 2, "median_bases": 250, "sigma": 0.2, "min_bases": 150,
                      "max_bases": 400, "sim": {"mean_dwell": 9.0}},
               copies=2, warm_reads=1, batch_size=8, check_reads=2, segment_len=400,
               jump=350, flags=list(mix["flags"]) + ["--device", "cpu"])
    return H.Context(cell=cell, config=cfg, traffic=mix, seed=2**31 + 77, seconds=0.01,
                     trace=False, workdir=str(tmp_path), t0=time.time(),
                     device=torch.device("cpu"))


@pytest.mark.parametrize("fault", [None] + sorted(crf_call.FAULTS))
def test_fault_makes_the_run_incorrect(fault, tmp_path, monkeypatch):
    if fault is not None:
        crf_call.plant(fault, monkeypatch.setattr)
    ctx = _tiny_ctx(tmp_path)
    out = crf_call.run(ctx)
    correct = out.failed == 0 and H.judge(out.numbers, H.limits(CELL))
    assert correct == (fault is None), out.numbers
    assert out.work["windows"] >= 8 and out.metrics["bases_per_s"] > 0


def test_control_is_incorrect(tmp_path):
    ctx = _tiny_ctx(tmp_path)
    assert not H.judge(crf_call.control(ctx, "fp8"), H.limits(CELL))
