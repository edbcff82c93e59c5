"""The port's span recorder (chiron_tpu_torch/utils/timing.py) on the CPU:
off outside a profiler, nesting, threads, exceptions and the profiler's
clock under a CPU torch.profiler; every span of a CPU `call` and of a CPU
train step in its thread; the `.meta` times taken from the spans' stamps;
and the spans.json that `call --profile` and `train --profile` write.
"""

import json
import os
import statistics
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chiron_tpu_torch import cli
from chiron_tpu_torch.models.model import init_model
from chiron_tpu_torch.params import from_jax_params, to_numpy_tree
from chiron_tpu_torch.train import loop
from chiron_tpu_torch.utils import timing
from synth import make_training_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DNA_DEFAULT = os.path.join(REPO, "chiron_tpu", "model", "DNA_default")

# span name -> the thread (name prefix) that records it in a call
CALL_THREADS = {"call.run": "MainThread", "call.load": "MainThread",
                "call.feed_wait": "MainThread", "call.step": "MainThread",
                "model.front": "MainThread", "model.rnn": "MainThread",
                "model.decode": "MainThread", "call.drain": "MainThread",
                "call.readback_wait": "MainThread", "call.finish": "MainThread",
                "call.read": "call-read", "call.upload": "call-producer",
                "call.readback": "call-readback", "call.assemble": "call-writer",
                "call.write": "call-writer"}
CALL_PARENTS = {"call.load": "call.run", "call.feed_wait": "call.run", "call.step": "call.run",
                "model.front": "call.step", "model.rnn": "call.step",
                "model.decode": "call.step", "call.drain": "call.run",
                "call.readback_wait": "call.drain", "call.finish": "call.run"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: several test workers' torch
    thread pools competing for the cores slow the CPU calls many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh():
    timing.clear_spans()
    yield
    timing.clear_spans()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_outside_a_profiler_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert timing.span("a") is timing.span("b", call=1)  # one shared no-op
    with timing.span("outer", call=3):
        with timing.span("inner"):
            timing.record("stamped", 0, 1)
            assert timing.current_ids() == {}
    assert timing.spans() == [] and timing.span_totals() == {}


def test_nested_spans_parents_ids_and_self_time():
    with _profiled():
        with timing.span("outer", call=7):
            time.sleep(0.02)
            with timing.span("inner", batch=2):
                assert timing.current_ids() == {"call": 7, "batch": 2}
                time.sleep(0.03)
            timing.record("stamped", time.time_ns() - 5_000_000, time.time_ns())
    got = {s.name: s for s in timing.spans()}
    assert got["inner"].parent == "outer" and got["outer"].parent is None
    assert got["stamped"].parent == "outer"
    assert got["inner"].ids == {"call": 7, "batch": 2} and got["outer"].ids == {"call": 7}
    assert {s.thread for s in got.values()} == {"MainThread"}
    tot = timing.span_totals()
    inner, stamped = tot["inner"]["seconds"], tot["stamped"]["seconds"]
    assert tot["inner"]["self_seconds"] == inner >= 0.03
    assert tot["outer"]["self_seconds"] == pytest.approx(
        tot["outer"]["seconds"] - inner - stamped, abs=1e-9)
    assert tot["outer"]["seconds"] >= 0.05


def test_pool_thread_spans_are_recorded_without_the_profiler_there():
    seen = []

    def work(i):
        seen.append(torch.autograd._profiler_enabled())  # the profiler skips this thread
        with timing.span("work", call=i):
            time.sleep(0.001)

    with _profiled(), ThreadPoolExecutor(2, thread_name_prefix="pool") as pool:
        list(pool.map(work, range(4)))
    got = [s for s in timing.spans() if s.name == "work"]
    assert seen == [False] * 4 and len(got) == 4
    assert all(s.thread.startswith("pool") and s.parent is None for s in got)
    assert sorted(s.ids["call"] for s in got) == [0, 1, 2, 3]


def test_a_span_closes_on_an_exception():
    with _profiled():
        with pytest.raises(ValueError):
            with timing.span("outer"):
                with timing.span("boom"):
                    raise ValueError("x")
        with timing.span("after"):
            pass
    got = {s.name: s for s in timing.spans()}
    assert got["boom"].parent == "outer" and got["after"].parent is None
    assert got["boom"].end_ns >= got["boom"].start_ns


def test_main_thread_span_starts_within_1ms_of_its_kineto_event():
    with _profiled() as prof:
        for i in range(12):
            with timing.span(f"k{i}"):
                time.sleep(0.001)
    kineto = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("k")}
    mine = {s.name: s.start_ns for s in timing.spans()}
    assert set(mine) <= set(kineto)
    offsets = [abs(kineto[n] - mine[n]) for n in mine]
    assert statistics.median(offsets) < 1_000_000


def test_profiled_writes_both_files_or_nothing(tmp_path):
    with timing.profiled(None):
        assert not torch.autograd.profiler._is_profiler_enabled
    with timing.profiled(str(tmp_path / "p")):
        with timing.span("only"):
            pass
    doc = json.loads((tmp_path / "p" / "spans.json").read_text())
    assert (tmp_path / "p" / "trace.json").stat().st_size > 0
    only = doc["totals"]["only"]
    assert set(doc["totals"]) == {"only"} and only["count"] == 1
    assert only["self_seconds"] == only["seconds"] > 0
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] == ["only"]


def test_the_list_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(timing, "MAX_SPANS", 3)
    with _profiled():
        for i in range(5):
            timing.record("r", i, i + 1)
    assert len(timing.spans()) == 3 and timing.dropped_spans() == 2


def _reads(tmp_path, lengths=(1200, 3000, 800)):
    sig = tmp_path / "sig"
    sig.mkdir()
    rng = np.random.RandomState(5)
    for i, n in enumerate(lengths):
        np.savetxt(sig / f"r{i}.signal", rng.randint(300, 700, n), fmt="%d")
    return sig


def _call(sig, out, *extra):
    return cli.main(["call", "-i", str(sig), "-o", str(out), "-m", DNA_DEFAULT, "-p", "dna-pre",
                     "-b", "4", "--beam", "0", "--device", "cpu"] + list(extra))


def test_cpu_call_records_every_span_in_its_thread(tmp_path):
    sig = _reads(tmp_path)
    with _profiled():
        first = _call(sig, tmp_path / "o1")
        second = _call(sig, tmp_path / "o2")
    got = timing.spans()
    tot = timing.span_totals()
    assert set(tot) == set(CALL_THREADS)
    for s in got:
        assert s.thread.startswith(CALL_THREADS[s.name]), (s.name, s.thread)
        assert s.parent == CALL_PARENTS.get(s.name), (s.name, s.parent)
    batches = sum(-(-r["total_windows"] // 4) for r in (first, second))
    assert tot["call.step"]["count"] == batches
    assert tot["call.read"]["count"] == 6 and tot["call.run"]["count"] == 2
    runs = [s for s in got if s.name == "call.run"]
    assert runs[0].ids["call"] != runs[1].ids["call"]
    for run in runs:  # every span of a call carries its id
        mine = [s for s in got if s.ids.get("call") == run.ids["call"]]
        assert {s.name for s in mine} == set(CALL_THREADS)
        covered = sum(s.end_ns - s.start_ns for s in mine if s.parent == "call.run")
        assert covered >= 0.95 * (run.end_ns - run.start_ns)


def test_meta_times_come_from_the_spans_stamps(tmp_path):
    sig = _reads(tmp_path, lengths=(1500,))
    with _profiled():
        _call(sig, tmp_path / "out")
    got = {s.name: s for s in timing.spans()}
    meta = (tmp_path / "out" / "meta" / "r0.meta").read_text().splitlines()
    assert meta[0] == "# Reading Basecalling assembly output total rate(bp/s)"
    reading, basecall, assembly = (float(v) for v in meta[1].split()[:3])
    read, asm = got["call.read"], got["call.assemble"]
    assert reading == pytest.approx((read.end_ns - read.start_ns) / 1e9, abs=6e-4)
    assert basecall == pytest.approx((asm.start_ns - read.end_ns) / 1e9, abs=6e-4)
    assert assembly == pytest.approx((asm.end_ns - asm.start_ns) / 1e9, abs=6e-4)
    assert meta[2] == "# read_len batch_size segment_len jump start_pos"


def test_call_profile_writes_spans_json_in_the_traces_clock(tmp_path):
    sig = _reads(tmp_path, lengths=(1200,))
    out = tmp_path / "out"
    _call(sig, out, "--profile")
    doc = json.loads((out / "profile" / "spans.json").read_text())
    trace = json.loads((out / "profile" / "trace.json").read_text())
    assert doc["baseTimeNanoseconds"] == trace.get("baseTimeNanoseconds", 0)
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in events}
    assert set(CALL_THREADS) <= names
    run = next(e for e in events if e["name"] == "call.run")
    kineto = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("name") ==
              "call.run"]
    assert kineto and abs(kineto[0]["ts"] - run["ts"]) < 1000  # microseconds
    threads = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert "MainThread" in threads and any(t.startswith("call-writer") for t in threads)
    assert doc["totals"]["call.run"]["count"] == 1 and doc["dropped"] == 0
    assert doc["totals"]["call.read"]["count"] == 1


def test_cpu_train_step_records_the_train_spans(tmp_path):
    cfg = {"cnn": {"model": "dna_model1"},
           "rnn": {"layer_num": 1, "hidden_num": 8, "cell_type": "LSTM",
                   "layer_type": "normal"}}
    tree = to_numpy_tree(from_jax_params(init_model(torch.Generator().manual_seed(0), cfg),
                                         cfg, "cpu"))
    model = from_jax_params(tree, cfg, "cpu").requires_grad_(True)
    ema = from_jax_params(tree, cfg, "cpu")
    opt = loop.make_optimizer("Adam", 1e-3, 100, model.parameters())
    step = loop.make_train_step(cfg, 0.0)
    rng = np.random.RandomState(1)
    host = {"signal": rng.randn(4, 64).astype(np.float32),
            "seq_len": np.full(4, 64, np.int32),
            "label": rng.randint(0, 4, (4, 6)).astype(np.int32),
            "label_len": np.full(4, 6, np.int32)}
    backward_threads = []

    def hook(_):
        backward_threads.append(threading.current_thread().name)

    with _profiled():
        for i in range(2):
            batch = loop.batch_to_device(host, 1.0, torch.device("cpu"))
            logits_hook = model.flat[next(iter(model.flat))].register_hook(hook)
            step(model, ema, opt, batch, i)
            logits_hook.remove()
    tot = timing.span_totals()
    assert {"train.step", "train.forward", "train.loss", "train.backward", "train.update",
            "train.ema", "train.upload", "train.loss_backward", "model.front",
            "model.rnn"} == set(tot)
    assert tot["train.step"]["count"] == tot["train.upload"]["count"] == 2
    assert tot["train.update"]["count"] == 4  # zero_grad, then the optimizer step
    got = timing.spans()
    for s in got:
        if s.name in ("train.forward", "train.loss", "train.backward", "train.update",
                      "train.ema"):
            assert s.parent == "train.step"
    lb = [s for s in got if s.name == "train.loss_backward"]
    assert [s.ids["step"] for s in lb] == [0, 1]
    # the thread autograd's engine ran the backward in: the caller's on the CPU
    # (a CPU graph), its device thread on the card
    assert {s.thread for s in lb} == set(backward_threads)


TRAIN_CONFIG = {"cnn": {"model": "dna_model1"},
                "rnn": {"layer_num": 1, "hidden_num": 8, "cell_type": "LSTM",
                        "layer_type": "normal"}, "opt_method": "Adam"}


def test_train_profile_writes_the_steps_spans_json(tmp_path):
    make_training_dir(str(tmp_path / "train"), n_files=2, n_bases=200, seed=0)
    config = tmp_path / "config.json"
    config.write_text(json.dumps(TRAIN_CONFIG))
    result = cli.main(["train", "-i", str(tmp_path / "train"), "-o", str(tmp_path / "log"),
                       "-m", "m", "-s", "120", "-b", "4", "-x", "3", "--configure", str(config),
                       "--device", "cpu", "--profile"])
    out = os.path.join(result["model_dir"], "profile")
    doc = json.loads(open(os.path.join(out, "spans.json")).read())
    trace = json.loads(open(os.path.join(out, "trace.json")).read())
    assert doc["baseTimeNanoseconds"] == trace.get("baseTimeNanoseconds", 0)
    assert doc["dropped"] == 0
    steps = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"] == "train.step"]
    assert [e["args"]["step"] for e in steps] == [0, 1, 2]
    tot = doc["totals"]
    assert tot["train.step"]["count"] == tot["train.upload"]["count"] == 3
    assert tot["train.loss_backward"]["count"] == 3
    for name in ("train.forward", "train.loss", "train.backward", "train.update", "train.ema"):
        assert 0 < tot[name]["seconds"] < tot["train.step"]["seconds"], name
    assert tot["train.step"]["self_seconds"] < tot["train.step"]["seconds"]
    assert not torch.autograd.profiler._is_profiler_enabled  # off once the run ends
