"""The port's three further training sources against the JAX package's: the
.bin folder (``io/binfmt.py``), TFRecord (``io/tfrecord.py``) and the
out-of-core window cache (``io/cache.py``). Each format is written by one
package and read by the other, byte for byte, and ``load_dataset`` gives the
JAX package's arrays for each source. Host-only numpy code: every
comparison is exact.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from chiron_tpu.io import binfmt as jbin
from chiron_tpu.io import cache as jcache
from chiron_tpu.io import tfrecord as jtf
from chiron_tpu.train import loop as jloop
from chiron_tpu_torch import cli
from chiron_tpu_torch.io import binfmt as tbin
from chiron_tpu_torch.io import cache as tcache
from chiron_tpu_torch.io import tfrecord as ttf
from chiron_tpu_torch.io.labels import read_raw_data_sets
from chiron_tpu_torch.train import loop as tloop
from synth import make_training_dir, synth_read

SEQ = 120
CONFIG = {"cnn": {"model": "dna_model1"},
          "rnn": {"layer_num": 1, "hidden_num": 16, "cell_type": "LSTM", "layer_type": "normal"},
          "opt_method": "Adam", "fl_gamma": 2}
KEYS = ("signal", "seq_len", "label", "label_len")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: the plain kernels run many
    small ops, and several test workers' torch thread pools competing for the
    cores made these tests ~60x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _int_corpus(root, n_files=3, n_bases=150, seed=0):
    """Reads with int16 signals (what a TFRecord holds), written as a
    .signal/.label folder and as one TFRecord. Returns (signal dir, TFRecord
    path, reads)."""
    rng = np.random.RandomState(seed)
    sig_dir = os.path.join(root, "sig")
    os.makedirs(sig_dir)
    reads = []
    for i in range(n_files):
        seq, starts, lengths, signal = synth_read(rng, n_bases)
        signal = np.round(signal).astype(np.int16)
        rows = [(int(s), int(s + n), b) for s, n, b in zip(starts, lengths, seq)]
        reads.append((f"read{i}", signal, rows))
        with open(os.path.join(sig_dir, f"read{i}.signal"), "w") as f:
            f.write(" ".join(str(int(v)) for v in signal))
        with open(os.path.join(sig_dir, f"read{i}.label"), "w") as f:
            f.writelines(f"{s} {e} {b}\n" for s, e, b in rows)
    path = os.path.join(root, "train.tfrecords")
    jtf.write_training_tfrecord(path, reads)
    return sig_dir, path, reads


def _write_bin_folder(mod, folder, arrays, per_file=7, length=SEQ):
    """A .bin folder of the windows in ``arrays`` (read_raw_data_sets output),
    written by ``mod`` (either package's binfmt)."""
    os.makedirs(folder)
    ev, evl, lb, lbl = arrays
    for k, ofs in enumerate(range(0, len(ev), per_file)):
        sl = slice(ofs, ofs + per_file)
        mod.write_bin(os.path.join(folder, f"data_batch_{k}.bin"), ev[sl], evl[sl],
                      [row[:n] for row, n in zip(lb[sl], lbl[sl])], lbl[sl])
    mod.write_meta(folder, length, per_file, "median", "RawGenomeCorrected_000",
                   "BaseCalled_template", "dna")


def _tree_bytes(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = f.read()
    return out


def _assert_arrays_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---- .bin -----------------------------------------------------------------


def test_bin_folder_bytes_and_arrays_both_ways(tmp_path):
    data = os.path.join(str(tmp_path), "data")
    make_training_dir(data, n_files=3, n_bases=200, seed=0)
    arrays = read_raw_data_sets(data, seq_length=SEQ)
    assert len(arrays[0]) > 7  # more than one .bin file
    t_dir, j_dir = os.path.join(str(tmp_path), "t"), os.path.join(str(tmp_path), "j")
    _write_bin_folder(tbin, t_dir, arrays)
    _write_bin_folder(jbin, j_dir, arrays)
    assert _tree_bytes(t_dir) == _tree_bytes(j_dir)
    assert tbin.read_meta(j_dir) == jbin.read_meta(t_dir)
    assert tbin.format_string(SEQ) == jbin.format_string(SEQ)
    assert tbin.record_dtype(SEQ) == jbin.record_dtype(SEQ)
    got, want = tbin.read_bin_folder(j_dir), jbin.read_bin_folder(t_dir)
    _assert_arrays_equal(got, want)
    # the records hold the in-RAM windows: labels -1-padded to the window
    ev, evl, lb, lbl = got
    np.testing.assert_array_equal(ev, arrays[0])
    np.testing.assert_array_equal(evl, arrays[1])
    np.testing.assert_array_equal(lbl, arrays[3])
    np.testing.assert_array_equal(lb[:, :arrays[2].shape[1]], arrays[2])
    assert (lb[:, arrays[2].shape[1]:] == -1).all()
    _assert_arrays_equal(tbin.read_bin(os.path.join(j_dir, "data_batch_0.bin"), SEQ),
                         jbin.read_bin(os.path.join(t_dir, "data_batch_0.bin"), SEQ))
    empty = os.path.join(str(tmp_path), "empty")
    os.makedirs(empty)
    _assert_arrays_equal(tbin.read_bin_folder(empty, SEQ), jbin.read_bin_folder(empty, SEQ))


@pytest.mark.parametrize("mode", ["dna", "rna"])
def test_segment_events_matches_jax(mode):
    rng = np.random.RandomState(5 if mode == "dna" else 6)
    n_events = 300
    lens = rng.randint(2, 30, n_events)
    raw_start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    raw_data = rng.randn(int(raw_start[-1] + lens[-1]) + 10).astype(np.float32)
    raw_label = np.zeros(n_events, dtype=[("base", "S1")])
    raw_label["base"] = [rng.choice(list("ACGT")).encode() for _ in range(n_events)]
    got = tbin.segment_events(raw_data, raw_label, raw_start, 100, mode)
    want = jbin.segment_events(raw_data, raw_label, raw_start, 100, mode)
    assert len(got[0]) == len(want[0]) > 5
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1:] == want[1:]


# ---- TFRecord -------------------------------------------------------------


def test_crc32c_known_vectors_and_codec_match_jax():
    # RFC 3720 test vectors
    assert ttf.crc32c(b"") == 0
    assert ttf.crc32c(b"123456789") == 0xE3069283
    assert ttf.crc32c(bytes(32)) == 0x8A9136AA
    data = bytes(range(256)) * 3
    assert ttf.crc32c(data) == jtf.crc32c(data)
    assert ttf._masked_crc(data) == jtf._masked_crc(data)
    for x in (0, 1, 127, 128, 300, 2 ** 35 + 7):
        assert ttf._varint(x) == jtf._varint(x)
        assert ttf._read_varint(jtf._varint(x), 0) == (x, len(jtf._varint(x)))
    ex = ttf.make_example({"raw_data": b"\x01\x02", "fname": b"read1"})
    assert ex == jtf.make_example({"raw_data": b"\x01\x02", "fname": b"read1"})
    assert ttf.parse_example(ex) == jtf.parse_example(ex)


def test_tfrecord_bytes_and_reads_both_ways(tmp_path):
    _, j_path, reads = _int_corpus(str(tmp_path))
    t_path = os.path.join(str(tmp_path), "port.tfrecords")
    ttf.write_training_tfrecord(t_path, reads)
    with open(t_path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()
    payloads = [b"hello", b"", b"x" * 1000]
    ttf.write_tfrecord(os.path.join(str(tmp_path), "p"), payloads)
    assert list(jtf.iter_tfrecords(os.path.join(str(tmp_path), "p"))) == payloads
    for got, want in zip(ttf.read_tfrecord_pairs(j_path), jtf.read_tfrecord_pairs(t_path)):
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])


def test_tfrecord_corruption_and_truncation_raise_value_error(tmp_path):
    path = os.path.join(str(tmp_path), "t.tfrecords")
    ttf.write_tfrecord(path, [b"hello world"])
    data = bytearray(pathlib.Path(path).read_bytes())
    data[14] ^= 0xFF  # flip a payload byte
    pathlib.Path(path).write_bytes(bytes(data))
    with pytest.raises(ValueError, match="payload crc"):
        list(ttf.iter_tfrecords(path))
    data = bytearray(pathlib.Path(path).read_bytes())
    data[14] ^= 0xFF
    data[0] ^= 0x01  # the length word no longer matches its crc
    pathlib.Path(path).write_bytes(bytes(data))
    with pytest.raises(ValueError, match="length crc"):
        list(ttf.iter_tfrecords(path))
    with pytest.raises(ValueError, match="truncated varint"):
        ttf._read_varint(b"\xff\xff", 0)  # continuation bit set on the final byte
    rng = np.random.RandomState(1)
    seq, starts, lengths, signal = synth_read(rng, 40)
    rows = [(int(s), int(s + n), b) for s, n, b in zip(starts, lengths, seq)]
    rows[-1] = (rows[-1][0], 123_456_789, rows[-1][2])  # 9 digits > |S8
    with pytest.raises(ValueError, match="S8"):
        ttf.write_training_tfrecord(os.path.join(str(tmp_path), "o.tfrecords"),
                                    [("read0", signal.astype(np.int16), rows)])


def test_tfrecord_data_sets_match_jax_and_the_signal_label_reader(tmp_path):
    sig_dir, path, _ = _int_corpus(str(tmp_path))
    got = ttf.read_tfrecord_data_sets(path, seq_length=SEQ)
    _assert_arrays_equal(got, jtf.read_tfrecord_data_sets(path, seq_length=SEQ))
    # a folder of TFRecords, normalised, capped and with 3-mers: still JAX's
    folder = os.path.dirname(path)
    kw = dict(seq_length=SEQ, k_mer=3, max_segments_num=9, skip_start=12, sig_norm=0)
    _assert_arrays_equal(ttf.read_tfrecord_data_sets(folder, **kw),
                         jtf.read_tfrecord_data_sets(folder, **kw))
    ev, evl, lb, lbl = read_raw_data_sets(sig_dir, seq_length=SEQ)
    assert got[0].shape == ev.shape
    np.testing.assert_array_equal(got[1], evl)
    np.testing.assert_array_equal(got[2], lb)
    np.testing.assert_array_equal(got[3], lbl)
    np.testing.assert_allclose(got[0], ev, rtol=1e-6)


# ---- the window cache -------------------------------------------------------


def _no_rebuild(monkeypatch, mod):
    def refuse(*a, **k):
        raise AssertionError("the cache was rebuilt")

    monkeypatch.setattr(mod, "build_cache", refuse)


@pytest.mark.parametrize("first_package", ["port", "jax"])
def test_cache_built_by_either_package_is_reused_by_the_other(tmp_path, monkeypatch,
                                                              first_package):
    data = os.path.join(str(tmp_path), "data")
    make_training_dir(data, n_files=3, n_bases=300, seed=0)
    cache = os.path.join(str(tmp_path), "cache")
    first, other = (tcache, jcache) if first_package == "port" else (jcache, tcache)
    first.cached_dataset(data, cache, 200, seed=3).close()
    files = _tree_bytes(cache)
    _no_rebuild(monkeypatch, other)
    ds = other.cached_dataset(data, cache, 200, seed=3)
    assert _tree_bytes(cache) == files
    assert ds.n > 0
    ds.close()
    # a cache each package builds from the same data is the same, file for file
    again = os.path.join(str(tmp_path), "again")
    monkeypatch.undo()
    other.cached_dataset(data, again, 200).close()
    assert _tree_bytes(again) == files


def test_cache_rebuilds_on_param_change_and_regenerated_data(tmp_path):
    data = os.path.join(str(tmp_path), "data")
    make_training_dir(data, n_files=2, n_bases=300, seed=1)
    cache = os.path.join(str(tmp_path), "c")
    d1 = tcache.cached_dataset(data, cache, 200, skip_start=10)
    n1, meta1 = d1.n, tcache.read_meta(cache)
    d1.close()
    tcache.cached_dataset(data, cache, 200, skip_start=10).close()
    assert tcache.read_meta(cache) == meta1  # same parameters: reused
    d3 = tcache.cached_dataset(data, cache, 200, skip_start=25)
    assert tcache.read_meta(cache)["build"]["skip_start"] == 25
    assert 0 < d3.n <= n1
    d3.close()
    make_training_dir(data, n_files=3, n_bases=300, seed=2)  # same path, new content
    d4 = tcache.cached_dataset(data, cache, 200, skip_start=25)
    assert d4.n > d3.n
    assert tcache.read_meta(cache)["build"]["signature"]["n_files"] == 6
    # a process's shard of the files: the two shards' caches partition this one
    parts = [tcache.cached_dataset(data, os.path.join(str(tmp_path), f"shard{i}"), 200,
                                   skip_start=25, file_shard=(i, 2)) for i in range(2)]
    assert [tcache.read_meta(os.path.join(str(tmp_path), f"shard{i}"))["build"]["file_shard"]
            for i in range(2)] == [[0, 2], [1, 2]]
    assert parts[0].n + parts[1].n == d4.n and parts[0].n and parts[1].n
    rows = sorted(r.tobytes() for p in parts for r in p.next_batch(p.n, shuffle=False)["signal"])
    assert rows == sorted(r.tobytes() for r in d4.next_batch(d4.n, shuffle=False)["signal"])
    for p in (d4, *parts):
        p.close()


def test_cached_dataset_batches_match_jax_and_in_ram(tmp_path):
    data = os.path.join(str(tmp_path), "data")
    make_training_dir(data, n_files=3, n_bases=300, seed=4)
    cache = os.path.join(str(tmp_path), "cache")
    port = tcache.cached_dataset(data, cache, 200, seed=7)
    jax_side = jcache.CachedDataset(cache, seed=7)
    ram = tloop.Dataset(*read_raw_data_sets(data, seq_length=200), seed=7)
    assert port.n == jax_side.n == ram.n > 0
    assert port.u_max == ram.labels.shape[1]
    for i in range(3 * -(-port.n // 16)):  # three epochs
        a, b, c = port.next_batch(16), jax_side.next_batch(16), ram.next_batch(16)
        for key in KEYS:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{key}, batch {i}")
            np.testing.assert_array_equal(a[key], c[key], err_msg=f"{key}, batch {i}")
    assert port.epochs_completed == jax_side.epochs_completed == ram.epochs_completed >= 2
    port.close()
    jax_side.close()


def test_cache_streams_windows_and_skips_bad_labels(tmp_path):
    cache = os.path.join(str(tmp_path), "cache")
    writer = tcache.CacheWriter(cache, 64)
    n = 3000
    for start in range(0, n, 1000):
        ev = np.zeros((1000, 64), np.float32)
        ev[:, 0] = np.arange(start, start + 1000)  # row fingerprint
        labels = np.tile(np.arange(4, dtype=np.int32), (1000, 1))
        labels[:, 3] = np.arange(start, start + 1000) % 4
        writer.append(ev, np.full(1000, 64, np.int32), labels, np.full(1000, 4, np.int32))
    assert writer.close()["n"] == n
    ds = tcache.CachedDataset(cache, seed=1)
    for _ in range(5):
        batch = ds.next_batch(256)
        np.testing.assert_array_equal(batch["label"][:, 3],
                                      batch["signal"][:, 0].astype(np.int64) % 4)
    ds.close()
    with open(os.path.join(cache, tcache.META_NAME)) as f:
        assert json.load(f) == jcache.read_meta(cache)
    # a malformed label file is skipped, as the port's read_raw_data_sets skips it
    data = os.path.join(str(tmp_path), "data")
    make_training_dir(data, n_files=2, n_bases=300, seed=5)
    with open(os.path.join(data, "read1.label"), "w") as f:
        f.write("0 x\n")
    meta = tcache.build_cache(data, os.path.join(str(tmp_path), "c2"), 200)
    assert meta["n"] == len(read_raw_data_sets(data, seq_length=200)[0]) > 0


# ---- load_dataset and `train` from each source ------------------------------


@pytest.fixture
def sources(tmp_path):
    """One corpus as each source: .signal/.label, .bin, a TFRecord named by
    -f and given by path, and the window cache."""
    root = str(tmp_path)
    sig_dir, tf_path, _ = _int_corpus(root, n_files=3, n_bases=200, seed=8)
    bin_dir = os.path.join(root, "bin")
    _write_bin_folder(tbin, bin_dir, read_raw_data_sets(sig_dir, seq_length=SEQ))
    return {"signal": (sig_dir, {}), "bin": (bin_dir, {}),
            "tfrecord": (root, {"tfrecord": os.path.basename(tf_path)}),
            "tfrecord_path": (tf_path, {}),
            "cache": (sig_dir, {"cache_dir": os.path.join(root, "cache")})}


@pytest.mark.parametrize("source", ["signal", "bin", "tfrecord", "tfrecord_path", "cache"])
def test_load_dataset_matches_jax_for_each_source(sources, source):
    data, kw = sources[source]
    got = tloop.load_dataset(data, SEQ, max_segments=20, **kw)
    want = jloop.load_dataset(data, SEQ, max_segments=20, **kw)
    assert got.n == want.n > 0
    for _ in range(4):
        a, b = got.next_batch(8), want.next_batch(8)
        for key in KEYS:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for ds in (got, want):
        if hasattr(ds, "close"):
            ds.close()


@pytest.mark.parametrize("source", ["signal", "bin", "tfrecord", "tfrecord_path", "cache"])
def test_load_dataset_file_shard_matches_jax_for_each_source(sources, source):
    """A process's share of a multi-process run: the files of its hash shard
    (.signal, cache) or every second row (.bin: before max_segments,
    TFRecord: after it), as the JAX package's load_dataset takes them."""
    data, kw = sources[source]
    if "cache_dir" in kw:
        kw = {"cache_dir": os.path.join(kw["cache_dir"], "shard1")}
    got = tloop.load_dataset(data, SEQ, max_segments=20, file_shard=(1, 2), **kw)
    want = jloop.load_dataset(data, SEQ, max_segments=20, file_shard=(1, 2), **kw)
    assert got.n == want.n > 0
    for _ in range(4):
        a, b = got.next_batch(8), want.next_batch(8)
        for key in KEYS:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for ds in (got, want):
        if hasattr(ds, "close"):
            ds.close()


def test_bin_folder_of_another_signal_length_raises(sources):
    bin_dir, _ = sources["bin"]
    for load in (tloop.load_dataset, jloop.load_dataset):
        with pytest.raises(ValueError, match="signal_length"):
            load(bin_dir, SEQ + 80)


@pytest.mark.parametrize("source", ["bin", "tfrecord", "cache"])
def test_cli_train_runs_from_each_source(tmp_path, sources, source):
    data, kw = sources[source]
    config = os.path.join(str(tmp_path), "config.json")
    with open(config, "w") as f:
        json.dump(CONFIG, f)
    extra = {"bin": [], "tfrecord": ["-f", kw.get("tfrecord", "")],
             "cache": ["--train_cache", kw.get("cache_dir", "")]}[source]
    result = cli.main(["train", "-i", data, "-o", os.path.join(str(tmp_path), "log"), "-m", "m",
                       "-s", str(SEQ), "-b", "8", "-x", "2", "--configure", config,
                       "--device", "cpu", *extra])
    assert len(result["losses"]) == 1 and np.isfinite(result["losses"]).all()
    assert "final-2.npz" in os.listdir(result["model_dir"])


def test_resample_reloads_the_cache_with_a_growing_offset(tmp_path, monkeypatch):
    import types

    data = os.path.join(str(tmp_path), "train")
    make_training_dir(data, n_files=1, n_bases=80, seed=4)
    cache = os.path.join(str(tmp_path), "cache")
    config = os.path.join(str(tmp_path), "config.json")
    with open(config, "w") as f:
        json.dump(CONFIG, f)
    calls = []
    real = tloop.load_dataset

    def spy(*args, **kw):
        calls.append((kw.get("skip_start", 10), kw.get("cache_dir")))
        return real(*args, **kw)

    monkeypatch.setattr(tloop, "load_dataset", spy)
    n = real(data, SEQ).n
    # a batch of n rows ends the first epoch, so the second step reloads with
    # the offset 3 further on, from a cache rebuilt for it
    tloop.train(types.SimpleNamespace(
        data_dir=data, log_dir=os.path.join(str(tmp_path), "log"), model_name="m",
        validation=None, sequence_len=SEQ, batch_size=n, step_rate=4e-3, max_steps=3,
        configure=config, device="cpu", save_every=2, train_cache=cache,
        resample_after_epoch=1))
    assert calls[:2] == [(10, cache), (13, cache)]
    assert tcache.read_meta(cache)["build"]["skip_start"] == calls[-1][0]
