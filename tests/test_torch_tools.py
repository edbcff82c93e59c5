"""The port's copies of the simulator, aligner and oracle
(chiron_tpu_torch/tools/{simulate,assess,oracle}.py) against the JAX
package's on seeded inputs: byte-identical corpora, equal alignments and
equal summaries.
"""

import os

import numpy as np
import pytest

from chiron_tpu.tools import assess as jassess
from chiron_tpu.tools import oracle as joracle
from chiron_tpu.tools import simulate as jsim
from chiron_tpu_torch.tools import assess as tassess
from chiron_tpu_torch.tools import oracle as toracle
from chiron_tpu_torch.tools import simulate as tsim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "chiron_tpu", "model")

# the accuracy axes' generative families: (pore model, SimConfig kwargs or
# "rna", holdout seed); None = KmerModel.synthetic()
CORPORA = {
    "dna": ("DNA_default", {}, 991),
    "dna_slow": ("DNA_slow", dict(mean_dwell=24.0, max_dwell=140, noise_ar=0.7), 991),
    "rna": (None, "rna", 992),
}


def _family(sim, name):
    model_name, cfg_kw, seed = CORPORA[name]
    pore = (sim.KmerModel.synthetic() if model_name is None else
            sim.KmerModel.load(os.path.join(MODELS, model_name, "pore_model.tsv")))
    cfg = sim.SimConfig.rna() if cfg_kw == "rna" else sim.SimConfig(**cfg_kw)
    return pore, cfg, seed


def _tree_bytes(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_simulate_corpus_byte_identical(tmp_path, name):
    trees = {}
    for tag, sim in (("jax", jsim), ("torch", tsim)):
        pore, cfg, seed = _family(sim, name)
        root = tmp_path / tag
        root.mkdir()
        sim.simulate_corpus(str(root / "data"), 3, 600, seed=seed, model=pore, cfg=cfg,
                            fasta=str(root / "truth.fasta"))
        trees[tag] = _tree_bytes(str(root))
    assert len(trees["torch"]) == 7  # 3 x (.signal, .label) + the truth fasta
    assert trees["torch"] == trees["jax"]


@pytest.mark.parametrize("k,seed", [(6, 1234), (5, 7)])
def test_kmer_model_synthetic_bit_identical(k, seed):
    got, want = tsim.KmerModel.synthetic(k, seed), jsim.KmerModel.synthetic(k, seed)
    assert got.k == want.k == k
    assert got.means.tobytes() == want.means.tobytes()
    assert got.stdvs.tobytes() == want.stdvs.tobytes()


@pytest.mark.parametrize("source", ["synthetic", "DNA_default", "DNA_slow"])
def test_kmer_model_save_load_round_trip(tmp_path, source):
    if source == "synthetic":
        model = tsim.KmerModel.synthetic()
    else:
        model = tsim.KmerModel.load(os.path.join(MODELS, source, "pore_model.tsv"))
    path, jpath = str(tmp_path / "pore.tsv"), str(tmp_path / "jax_pore.tsv")
    model.save(path)
    jsim.KmerModel(model.means, model.stdvs, model.k).save(jpath)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    back = tsim.KmerModel.load(path)
    assert back.k == model.k
    # the file holds 6 decimals (<= 5e-7 off) read back into float32 (<= 2.4e-7
    # off at |level| < 4)
    np.testing.assert_allclose(back.means, model.means, rtol=0, atol=7.4e-7)
    np.testing.assert_allclose(back.stdvs, model.stdvs, rtol=0, atol=7.4e-7)
    jback = jsim.KmerModel.load(path)
    assert back.means.tobytes() == jback.means.tobytes()
    assert back.stdvs.tobytes() == jback.stdvs.tobytes()


def _mutate(rng, seq, rate):
    """Substitutions, insertions and deletions at ``rate`` each."""
    out = []
    for ch in seq:
        r = rng.rand()
        if r < rate:
            continue  # deletion
        out.append("ACGT"[rng.randint(4)] if r < 2 * rate else ch)
        if rng.rand() < rate:
            out.append("ACGT"[rng.randint(4)])  # insertion
    return "".join(out)


def _pair(seed, kind):
    rng = np.random.RandomState(seed)
    ref = "".join("ACGT"[i] for i in rng.randint(0, 4, 300 + 50 * seed))
    if kind == "random":
        called = "".join("ACGT"[i] for i in rng.randint(0, 4, len(ref) + rng.randint(-40, 40)))
    else:
        called = _mutate(rng, ref, 0.04 + 0.03 * seed)
    if kind == "rna":
        called = called.replace("T", "u")  # RNA calls against a T reference
    return called, ref


@pytest.mark.parametrize("kind", ["random", "mutated", "rna"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_align_assess_kmer_equal(seed, kind):
    called, ref = _pair(seed, kind)
    a, b = tassess._canon(called), tassess._canon(ref)
    assert a == jassess._canon(called)
    for band in (None, 20):
        assert tassess.banded_global_align(a, b, band) == \
            jassess.banded_global_align(a, b, band)
    assert tassess.kmer_hit_rate(a, b) == jassess.kmer_hit_rate(a, b)
    assert tassess.kmer_hit_rate(a, b, k=5) == jassess.kmer_hit_rate(a, b, k=5)
    assert tassess.assess_read(called, ref) == jassess.assess_read(called, ref)


def test_align_edge_cases_equal():
    for a, b in (("", "ACGT"), ("ACGT", ""), ("A", "A"), ("ACGT" * 50, "T" * 10)):
        assert tassess.banded_global_align(a, b) == jassess.banded_global_align(a, b)
    assert tassess.RANDOM_IDENTITY == jassess.RANDOM_IDENTITY == 0.525


def _write_fastx_dirs(root):
    """A result dir of called reads (fastq and fasta) and two reference
    layouts: the extraction layout (<name>_ref.fastq) and one truth fasta."""
    rng = np.random.RandomState(5)
    result, refdir = root / "result", root / "reference"
    result.mkdir()
    refdir.mkdir()
    truth = []
    for i in range(4):
        called, ref = _pair(i, "mutated")
        name = f"read{i}"
        truth.append(f">{name} extra words\n{ref[:150]}\n{ref[150:]}\n")
        (refdir / f"{name}_ref.fastq").write_text(f"@{name}\n{ref}\n+\n{'!' * len(ref)}\n")
        if i % 2:
            (result / f"{name}.fasta").write_text(f">{name}\n{called}\n")
        else:
            q = "".join(chr(33 + int(v)) for v in rng.randint(0, 40, len(called)))
            (result / f"{name}.fastq").write_text(f"@{name}\n{called}\n+\n{q}\n")
    (result / "notes.txt").write_text("not a read\n")
    (root / "truth.fasta").write_text("".join(truth))
    return str(result), {"dir": str(refdir), "fasta": str(root / "truth.fasta")}


@pytest.mark.parametrize("layout", ["dir", "fasta"])
def test_assess_dir_equal(tmp_path, layout):
    result, refs = _write_fastx_dirs(tmp_path)
    got = tassess.assess_dir(result, refs[layout])
    want = jassess.assess_dir(result, refs[layout])
    assert got["summary"]["n_reads"] == 4
    assert got == want
    assert tassess.summarize_rows(got["reads"]) == jassess.summarize_rows(want["reads"])
    assert tassess._read_fastx(refs["fasta"]) == jassess._read_fastx(refs["fasta"])


def test_oracle_summary_equal():
    """Two reads of 150 bases (DNA_default's family) through the exact-model
    Viterbi oracle: serially on the JAX package's side, in the port's spawned
    pool of two workers on the other."""
    summaries = []
    for sim, orc, workers in ((jsim, joracle, 0), (tsim, toracle, 2)):
        pore, cfg, seed = _family(sim, "dna")
        summaries.append(orc.measure_axis(2, 150, seed, pore, cfg, refine=1,
                                          workers=workers)["summary"])
    assert summaries[0]["n_reads"] == 2
    assert summaries[1] == summaries[0]
