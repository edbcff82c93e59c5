"""The port's data-prep and analysis tools against the JAX package's, on the
same seeded inputs: chiron_tpu_torch/{utils/progress,ops/ctc_align}.py and
tools/{resquiggle,pore_estimate,genome_model,dedup_fasta,merge_fasta,
label_slice,sim_gap,tf_index}.py. Arrays are compared exactly (the EM
estimate within rtol 1e-6), files byte for byte.
"""

import io
import os
import struct

import numpy as np
import pytest

from synth import synth_read, write_fast5

import chiron_tpu.tools.resquiggle as jrs
from chiron_tpu.io.labels import get_label_raw
from chiron_tpu.ops import ctc_align as jalign
from chiron_tpu.tools import dedup_fasta as jdedup
from chiron_tpu.tools import genome_model as jgm
from chiron_tpu.tools import label_slice as jslice
from chiron_tpu.tools import merge_fasta as jmerge
from chiron_tpu.tools import pore_estimate as jpe
from chiron_tpu.tools import sim_gap as jsg
from chiron_tpu.tools import simulate as jsim
from chiron_tpu.tools import tf_index as jtf
from chiron_tpu.utils import progress as jprog
from chiron_tpu_torch.ops import ctc_align as talign
from chiron_tpu_torch.tools import dedup_fasta as tdedup
from chiron_tpu_torch.tools import genome_model as tgm
from chiron_tpu_torch.tools import label_slice as tslice
from chiron_tpu_torch.tools import merge_fasta as tmerge
from chiron_tpu_torch.tools import pore_estimate as tpe
from chiron_tpu_torch.tools import resquiggle as trs
from chiron_tpu_torch.tools import sim_gap as tsg
from chiron_tpu_torch.tools import simulate as tsim
from chiron_tpu_torch.tools import tf_index as ttf
from chiron_tpu_torch.utils import progress as tprog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DNA_PORE = os.path.join(REPO, "chiron_tpu", "model", "DNA_default", "pore_model.tsv")


def _log_probs(rng, t, c=5):
    lp = rng.randn(t, c).astype(np.float32) * 2.0
    return lp - np.log(np.exp(lp).sum(1, keepdims=True))


# ---- ops/ctc_align ---------------------------------------------------------

@pytest.mark.parametrize("seed,t,u", [(0, 60, 20), (1, 120, 45), (2, 30, 30), (3, 9, 1)])
def test_forced_align_equal(seed, t, u):
    rng = np.random.RandomState(seed)
    lp, labels = _log_probs(rng, t), rng.randint(0, 4, u)
    got, want = talign.forced_align(lp, labels), jalign.forced_align(lp, labels)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_forced_align_label_longer_than_the_lattice_raises_in_both():
    rng = np.random.RandomState(4)
    lp, labels = _log_probs(rng, 10), rng.randint(0, 4, 11)
    for mod in (jalign, talign):
        with pytest.raises(AssertionError):
            mod.forced_align(lp, labels)


@pytest.mark.parametrize("pile", [False, True])
def test_chunked_forced_align_equal(pile):
    """Chunks of 50 frames over a 400-frame read; with ``pile`` the coarse
    pass puts 70 labels into one chunk (more labels than frames: that chunk
    keeps its coarse starts)."""
    rng = np.random.RandomState(5)
    t, u = 400, 120
    lp, labels = _log_probs(rng, t), rng.randint(0, 4, u)
    coarse = np.sort(rng.randint(0, t, u))
    if pile:
        coarse[20:90] = np.sort(rng.randint(100, 150, 70))
        coarse = np.sort(coarse)
    coarse = np.concatenate([coarse, [t]])
    got = talign.chunked_forced_align(lp, labels, coarse, chunk=50)
    want = jalign.chunked_forced_align(lp, labels, coarse, chunk=50)
    assert np.array_equal(got, want)


# ---- tools/resquiggle --------------------------------------------------------

@pytest.fixture
def jax_numpy_fallback(monkeypatch):
    """The JAX package's resquiggle on its numpy fallback (no native DTW)."""
    monkeypatch.setattr(jrs, "_lib", None)
    monkeypatch.setattr(jrs, "_load_native", lambda: None)


RESQUIGGLE = {
    "resquiggle_signal": lambda m, sig, seq: m.resquiggle_signal(sig, seq, radius=40),
    "resquiggle_events": lambda m, sig, seq: m.resquiggle_events(sig, seq, radius=60),
    "viterbi_segment": lambda m, sig, seq: m.viterbi_segment(sig, seq, band=300),
}


@pytest.mark.parametrize("backend", ["fallback", "native"])
@pytest.mark.parametrize("fn", sorted(RESQUIGGLE))
def test_resquiggle_equal_starts(request, fn, backend):
    """Each aligner on tests/synth.py reads, against the JAX package's numpy
    fallback and against its native DTW (viterbi_segment has no native
    path; it runs in both cases)."""
    if backend == "fallback":
        request.getfixturevalue("jax_numpy_fallback")
    elif not jrs.native_available():
        pytest.skip("the JAX package's native DTW does not build here")
    for seed, n_bases in ((0, 90), (1, 140)):
        seq, _, _, sig = synth_read(np.random.RandomState(seed), n_bases=n_bases, noise=3.0)
        got, want = RESQUIGGLE[fn](trs, sig, seq), RESQUIGGLE[fn](jrs, sig, seq)
        assert got.dtype == want.dtype and np.array_equal(got, want), (fn, seed)


def test_znorm_and_events_from_starts_equal():
    rng = np.random.RandomState(6)
    x = rng.randn(500).astype(np.float32) * 30 + 400
    assert trs.znorm(x).tobytes() == jrs.znorm(x).tobytes()
    assert trs.znorm(np.ones(7)).tobytes() == jrs.znorm(np.ones(7)).tobytes()
    starts = np.asarray([0, 5, 12, 20])
    assert trs.events_from_starts(starts, "ACG") == jrs.events_from_starts(starts, "ACG")


def _pore_tables(tmp_path):
    """TSV files written by each package's KmerModel.save, and an ONT-layout
    table with a comment and a short stdv-less row."""
    km = tsim.KmerModel.load(DNA_PORE)
    paths = {"torch": str(tmp_path / "torch.tsv"), "jax": str(tmp_path / "jax.tsv")}
    km.save(paths["torch"])
    jsim.KmerModel(km.means, km.stdvs, km.k).save(paths["jax"])
    ont = tmp_path / "ont.tsv"
    ont.write_text("# ONT layout\nkmer\tlevel_mean\tlevel_stdv\nAAA\t80.0\t2.0\nAAC\t90.5\tx\n"
                   "AAG\t95.25\n")
    paths["ont"] = str(ont)
    return paths


def test_pore_model_tables_read_back_in_both(tmp_path):
    rng = np.random.RandomState(7)
    seq = "".join("ACGT"[i] for i in rng.randint(0, 4, 300))
    for name, path in _pore_tables(tmp_path).items():
        got, want = trs.PoreModel.load(path), jrs.PoreModel.load(path)
        assert (got.k, got.levels, got.stdvs) == (want.k, want.levels, want.stdvs), name
        for fn in ("expected_signal", "expected_stdv"):
            assert getattr(got, fn)(seq).tobytes() == getattr(want, fn)(seq).tobytes()
    d = trs.PoreModel.default()
    assert d.expected_signal("ACGTU").tobytes() == \
        jrs.PoreModel.default().expected_signal("ACGTU").tobytes()


def test_write_corrected_events_read_back_by_jax(tmp_path):
    """The port's Corrected_000 write-back, read by the JAX package's
    get_label_raw, equals the JAX package's own write-back."""
    seq, _, _, sig = synth_read(np.random.RandomState(2), n_bases=60, noise=2.0)
    starts = trs.resquiggle_signal(sig, seq, radius=30)
    labels = {}
    for tag, mod in (("torch", trs), ("jax", jrs)):
        path = str(tmp_path / f"{tag}.fast5")
        write_fast5(path, sig)
        mod.write_corrected_events(path, starts, seq)
        mod.write_corrected_events(path, starts, seq)  # an existing table is replaced
        labels[tag] = get_label_raw(path, "Corrected_000", "BaseCalled_template")[0]
    (raw_t, lab_t, st_t, ln_t), (raw_j, lab_j, st_j, ln_j) = labels["torch"], labels["jax"]
    assert len(lab_t) == len(seq) and lab_t["base"][0].decode() == seq[0]
    assert raw_t.tobytes() == raw_j.tobytes() and lab_t.tobytes() == lab_j.tobytes()
    assert np.array_equal(st_t, st_j) and np.array_equal(ln_t, ln_j)


# ---- tools/pore_estimate -------------------------------------------------------

def test_detect_events_equal():
    rng = np.random.RandomState(8)
    x = np.repeat(rng.randn(80) * 3, rng.randint(2, 12, 80))
    x = x + rng.randn(len(x)) * 0.3
    for sig in (x, x[:10]):
        (gs, gm), (ws, wm) = tpe.detect_events(sig), jpe.detect_events(sig)
        assert np.array_equal(gs, ws) and gm.tobytes() == wm.tobytes()


def test_estimate_kmer_model_equal():
    """Two simulated reads at iters=2 (the k ramp, then the sample-level
    refinement): levels and stdvs within rtol 1e-6."""
    km = tsim.KmerModel.load(DNA_PORE)
    rng = np.random.RandomState(9)
    pairs = []
    for _ in range(2):
        seq, _, _, sig = tsim.simulate_read(rng, km, 200, tsim.SimConfig())
        pairs.append((sig, seq))
    got = tpe.estimate_kmer_model(pairs, k=5, iters=2)
    want = jpe.estimate_kmer_model(pairs, k=5, iters=2)
    assert got.k == want.k == 5
    np.testing.assert_allclose(got.means, want.means, rtol=1e-6)
    np.testing.assert_allclose(got.stdvs, want.stdvs, rtol=1e-6)


# ---- tools/genome_model, dedup_fasta, merge_fasta, label_slice ----------------

def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_genome_model_equal(tmp_path, fmt):
    rng = np.random.RandomState(10)
    seqs = ["".join("ACGT"[i] for i in rng.randint(0, 4, n)) for n in (300, 2, 157)]
    seqs[2] = seqs[2][:50] + "N" + seqs[2][51:]  # a base outside the alphabet
    ref = tmp_path / f"ref.{fmt}"
    if fmt == "fasta":
        ref.write_text("".join(f">r{i}\n{s[:70]}\n{s[70:]}\n" for i, s in enumerate(seqs)))
    else:
        ref.write_text("".join(f"@r{i}\n{s}\n+\n{'!' * len(s)}\n" for i, s in enumerate(seqs)))
    assert list(tgm.read_sequences(str(ref))) == list(jgm.read_sequences(str(ref)))
    for mode in (0, 1):
        got, want = tgm.build(str(ref), k=3, mode=mode), jgm.build(str(ref), k=3, mode=mode)
        assert got.kmer_count.tobytes() == want.kmer_count.tobytes()
        assert got.prob("ACG" if mode == 0 else "ACU").tobytes() == \
            want.prob("ACG" if mode == 0 else "ACU").tobytes()
        got.save(str(tmp_path / "torch.json"))
        want.save(str(tmp_path / "jax.json"))
        assert _read_bytes(tmp_path / "torch.json") == _read_bytes(tmp_path / "jax.json")
        back = tgm.GenomeModel.load(str(tmp_path / "jax.json"))
        assert back.kmer_count.tobytes() == want.kmer_count.tobytes()
    out = {}
    for tag, mod in (("torch", tgm), ("jax", jgm)):
        mod.main(["-i", str(ref), "-o", str(tmp_path / f"main_{tag}.json"), "-k", "2"])
        out[tag] = _read_bytes(tmp_path / f"main_{tag}.json")
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("text", [
    ">r1\nAAAA\n>r2\nCCCC\n>r1\nGGGG\nTTTT\n",
    "@r1\nACGT\n+\n@@@@\n@r1\nTTTT\n+\n!!!!\n@r2\nGG\n+\n##\n",
])
def test_dedup_fasta_equal(tmp_path, text):
    src = tmp_path / "in.fx"
    src.write_text(text)
    counts = {}
    for tag, mod in (("torch", tdedup), ("jax", jdedup)):
        counts[tag] = mod.dedup_fast(str(src), str(tmp_path / f"{tag}.fx"))
    assert counts["torch"] == counts["jax"] == (3, 2)
    assert _read_bytes(tmp_path / "torch.fx") == _read_bytes(tmp_path / "jax.fx")


def test_dedup_fasta_rejects_what_jax_rejects(tmp_path):
    for text in ("no header\n", "@r1\nACGT\n+\n"):
        src = tmp_path / "bad.fx"
        src.write_text(text)
        for mod in (tdedup, jdedup):
            with pytest.raises(ValueError):
                mod.dedup_fast(str(src), str(tmp_path / "out.fx"))


def test_merge_fasta_equal(tmp_path):
    d = tmp_path / "result"
    d.mkdir()
    (d / "readB.fasta").write_text(">readB\nACGTACGT\n")
    (d / "readA.fasta").write_text(">readA\nTTTT\n\n")
    (d / "empty.fasta").write_text("\n")
    (d / "skip.fastq").write_text("@x\nAC\n+\n!!\n")
    n = {tag: mod.merge_fasta(str(d), str(tmp_path / tag / "all.fasta"))
         for tag, mod in (("torch", tmerge), ("jax", jmerge))}
    assert n == {"torch": 2, "jax": 2}
    assert _read_bytes(tmp_path / "torch" / "all.fasta") == \
        _read_bytes(tmp_path / "jax" / "all.fasta")


def test_label_slice_equal(tmp_path):
    (tmp_path / "r.signal").write_text("10 20 30\n40 50 60\n")
    (tmp_path / "r.label").write_text("0 3 A\n3 5 C\nshort\n5 6 G\n")
    rows = {tag: mod.slice_labels(str(tmp_path / "r"), str(tmp_path / f"{tag}.tsv"))
            for tag, mod in (("torch", tslice), ("jax", jslice))}
    assert rows == {"torch": 3, "jax": 3}
    assert _read_bytes(tmp_path / "torch.tsv") == _read_bytes(tmp_path / "jax.tsv")
    assert tslice.main(["only one"]) == jslice.main(["only one"]) == 1


# ---- tools/sim_gap ------------------------------------------------------------

def _slow_read(seed, n_bases):
    km = tsim.KmerModel.load(DNA_PORE)
    cfg = tsim.SimConfig(mean_dwell=24.0, max_dwell=140, noise_ar=0.7)
    seq, _, _, sig = tsim.simulate_read(np.random.RandomState(seed), km, n_bases, cfg)
    return seq, sig


def test_sim_gap_read_statistics_equal():
    seq, sig = _slow_read(11, 150)
    got = tsg.read_statistics(sig, seq, trs.PoreModel.load(DNA_PORE))
    want = jsg.read_statistics(sig, seq, jrs.PoreModel.load(DNA_PORE))
    assert got == want
    assert tsg.pore_sd(trs.PoreModel.load(DNA_PORE)) == jsg.pore_sd(jrs.PoreModel.load(DNA_PORE))


def test_sim_gap_needs_a_reference_and_never_writes_simgap_json(tmp_path):
    with pytest.raises(SystemExit):
        tsg.main([])
    with pytest.raises(ValueError, match="SIMGAP.json"):
        tsg.main(["--reference", str(tmp_path), "--out", os.path.join(REPO, "SIMGAP.json")])
    assert tsg.DEFAULT_OUT.startswith(os.path.join(REPO, "chiron_tpu_torch", "_build"))


# ---- tools/tf_index -----------------------------------------------------------

def _vbytes(n):
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _block(entries, restart_every=2):
    """A table block: prefix-compressed entries, restart offsets, count."""
    out, restarts, prev = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        shared = 0
        if i % restart_every == 0:
            restarts.append(len(out))
        else:
            while shared < min(len(prev), len(key)) and prev[shared] == key[shared]:
                shared += 1
        out += _vbytes(shared) + _vbytes(len(key) - shared) + _vbytes(len(value))
        out += key[shared:] + value
        prev = key
    for r in restarts:
        out += struct.pack("<I", r)
    return bytes(out + struct.pack("<I", len(restarts)))


def _bundle_entry(dtype, shape, size):
    """BundleEntryProto with a shard_id (field 3), an offset (4), a size (5),
    a fixed32 crc (6) and, in the shape, a dim carrying a name (field 2)."""
    dims = b"".join(b"\x12" + _vbytes(len(d)) + d for d in
                    (b"\x08" + _vbytes(s) + b"\x12\x01n" for s in shape))
    return (b"\x08" + _vbytes(dtype) + b"\x12" + _vbytes(len(dims)) + dims + b"\x18\x00"
            + b"\x20" + _vbytes(300) + b"\x28" + _vbytes(size) + b"\x35" + b"\x01\x02\x03\x04")


def _index_file(path, variables):
    data, handles = bytearray(), []
    names = sorted(variables)
    for i, chunk in enumerate((names[:3], names[3:])):
        entries = [(n.encode(), _bundle_entry(*variables[n])) for n in chunk]
        if i == 0:
            entries = [(b"", b"\x08\x01")] + entries  # the BundleHeaderProto
        block = _block(entries)
        handles.append((entries[-1][0], _vbytes(len(data)) + _vbytes(len(block))))
        data += block + b"\x00" + b"\x00" * 4
    index = _block(handles)
    idx_handle = _vbytes(len(data)) + _vbytes(len(index))
    data += index + b"\x00" + b"\x00" * 4
    footer = _vbytes(0) + _vbytes(0) + idx_handle
    footer += b"\x00" * (40 - len(footer)) + struct.pack("<Q", jtf.TABLE_MAGIC)
    with open(path, "wb") as f:
        f.write(bytes(data + footer))


def test_tf_index_decoders_equal_on_hand_built_bytes(tmp_path):
    for n in (0, 1, 127, 128, 300, 2 ** 35 + 7):
        buf = b"\xff" + _vbytes(n) + b"\x00"
        assert ttf._varint(buf, 1) == jtf._varint(buf, 1) == (n, len(buf) - 1)
    for mod in (ttf, jtf):
        with pytest.raises(ValueError, match="truncated"):
            mod._varint(b"\x80\x80", 0)
    entry = _bundle_entry(1, [1, 3, 256, 256], 786432)
    shape_msg = entry[4:4 + entry[3]]  # tag 0x08, dtype, tag 0x12, length, shape
    assert ttf._parse_shape(shape_msg) == jtf._parse_shape(shape_msg) == [1, 3, 256, 256]
    assert ttf._parse_shape(b"\x12\x00") == jtf._parse_shape(b"\x12\x00") == [-1]
    got = ttf._parse_entry(entry)
    assert got == jtf._parse_entry(entry) == {"dtype": "float32", "shape": [1, 3, 256, 256],
                                                "size": 786432}
    block = _block([(b"res_layer1/a", b"v1"), (b"res_layer1/b", b"v22"), (b"rnn", b""),
                    (b"rnn_fnn", b"v4")])
    assert ttf._block_entries(block) == jtf._block_entries(block) == [
        (b"res_layer1/a", b"v1"), (b"res_layer1/b", b"v22"), (b"rnn", b""), (b"rnn_fnn", b"v4")]
    assert ttf._block_entries(b"\x00") == jtf._block_entries(b"\x00") == []
    variables = {"res_layer1/branch1/conv1/weights": (1, [1, 1, 1, 256], 1024),
                 "res_layer1/branch1/conv1_bn/pop_mean": (1, [256], 1024),
                 "global_step": (9, [], 8),
                 "rnn_fnn_layer/weights": (1, [2, 128], 1024),
                 "rnn_fnn_layer/weights/Adam": (1, [2, 128], 1024),
                 "beta1_power": (1, [], 4)}
    path = str(tmp_path / "model.ckpt.index")
    _index_file(path, variables)
    assert ttf.list_variables(path) == jtf.list_variables(path)
    assert sorted(ttf.list_variables(path)) == sorted(variables)
    assert ttf.model_variables(path) == jtf.model_variables(path)
    assert sorted(ttf.model_variables(path)) == [
        "res_layer1/branch1/conv1/weights", "res_layer1/branch1/conv1_bn/pop_mean",
        "rnn_fnn_layer/weights"]
    bad = tmp_path / "bad.index"
    bad.write_bytes(b"\x00" * 48)
    for mod in (ttf, jtf):
        with pytest.raises(ValueError, match="magic"):
            mod.list_variables(str(bad))


# ---- utils/progress ---------------------------------------------------------------

class _Tty(io.StringIO):
    def isatty(self):
        return True


def test_multi_pbars_draw_equal():
    out = {}
    for tag, mod in (("torch", tprog), ("jax", jprog)):
        stream = _Tty()
        bars = mod.multi_pbars(["reads", "a title longer than thirty characters"],
                               stream=stream)
        bars.update(0, progress=3, total=10)
        bars.refresh()
        bars.update(1, title="bases", progress=7, total=5)
        bars.update(0, progress=10)
        bars.refresh()
        bars.update_bar(min_interval=0.0)
        bars.update_bar(min_interval=1e12)  # within the interval: nothing drawn
        bars.end()
        out[tag] = stream.getvalue()
        silent = io.StringIO()  # not a terminal: nothing drawn
        mod.multi_pbars(["x"], stream=silent).refresh()
        assert silent.getvalue() == ""
    assert out["torch"] == out["jax"] and "\x1b[2A" in out["torch"]
