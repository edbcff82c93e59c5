"""The port's `call` pipeline (chiron_tpu_torch/eval/pipeline.py, cli.py) on
the CPU against the committed goldens and the JAX pipeline, the step-output
packing, and the rule that the port imports nothing of JAX or chiron_tpu.
"""

import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.eval import pipeline as jpipe
from chiron_tpu_torch import cli as tcli
from chiron_tpu_torch.eval import pipeline as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "chiron_tpu", "example_data")
MODELS = os.path.join(REPO, "chiron_tpu", "model")

# (example dir, model, batch, segment, jump, mode): tests/test_golden.py's flags
GOLDENS = {
    "DNA": ("DNA", "DNA_default", 16, 400, 390, "dna"),
    "RNA": ("RNA", "RNA_default", 4, 2000, 1900, "rna"),
    "DNA_SLOW": ("DNA_SLOW", "DNA_slow", 8, 2000, 1900, "dna"),
}


def _flags(out, name, beam, **kw):
    ex, model, bsz, seg, jump, mode = GOLDENS[name]
    flags = types.SimpleNamespace(
        input=os.path.join(DATA, ex), output=out, model=os.path.join(MODELS, model),
        start=0, batch_size=bsz, segment_len=seg, jump=jump, threads=0, beam=beam,
        extension="fastq", concise=False, mode=mode, reverse_fast5=mode == "rna",
        recursive=False, sig_norm=1)
    for k, v in kw.items():
        setattr(flags, k, v)
    return flags


def _read_tree(root):
    out = {}
    for sub in ("result", "segments"):
        for f in sorted(os.listdir(os.path.join(root, sub))):
            with open(os.path.join(root, sub, f)) as fh:
                out[f"{sub}/{f}"] = fh.read()
    return out


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_greedy_call_reproduces_goldens(tmp_path, name):
    out = str(tmp_path / "out")
    tpipe.run(_flags(out, name, beam=0, device="cpu"))
    golden = _read_tree(os.path.join(DATA, GOLDENS[name][0], "output"))
    assert _read_tree(out) == golden


def test_beam30_call_matches_jax_pipeline(tmp_path):
    """Beam 30 with length_bonus from model.json (0.6), same fastq as JAX."""
    tout, jout = str(tmp_path / "torch"), str(tmp_path / "jax")
    tpipe.run(_flags(tout, "DNA", beam=30, device="cpu"))
    jpipe.run(_flags(jout, "DNA", beam=30))
    got, want = _read_tree(tout), _read_tree(jout)
    assert got == want and len(got) == 6


@pytest.mark.parametrize("two_bit,nclass", [(True, 5), (False, 6)])
def test_pack_unpack_round_trip_and_jax_layout(two_bit, nclass):
    rng = np.random.RandomState(0)
    b, t = 6, 11
    decoded = rng.randint(0, nclass - 1, size=(b, t)).astype(np.int32)
    lengths = rng.randint(0, t + 1, size=b).astype(np.int32)
    decoded[np.arange(t)[None, :] >= lengths[:, None]] = -1
    score = rng.randn(b).astype(np.float32)
    prob = rng.rand(b).astype(np.float32)
    buf = tpipe.pack_step_outputs(*(torch.tensor(a) for a in (decoded, lengths, score, prob)),
                                  two_bit=two_bit).numpy()
    jbuf = np.asarray(jpipe.pack_step_outputs(*(jnp.asarray(a) for a in
                                                (decoded, lengths, score, prob)),
                                              two_bit=two_bit))
    np.testing.assert_array_equal(buf, jbuf)
    d, n, s, p = tpipe.unpack_step_outputs(buf, two_bit=two_bit)
    np.testing.assert_array_equal(n, lengths)
    np.testing.assert_array_equal(s, score)
    np.testing.assert_array_equal(p, prob)
    for i in range(b):
        np.testing.assert_array_equal(d[i, :lengths[i]], decoded[i, :lengths[i]])


def test_path_prob_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 9, 5).astype(np.float32)
    np.testing.assert_allclose(tpipe.path_prob(torch.tensor(logits)).numpy(),
                               np.asarray(jpipe.path_prob(jnp.asarray(logits))),
                               rtol=1e-6, atol=1e-6)


def test_batch_stream_wrap_pads_like_jax(tmp_path):
    sig_dir = tmp_path / "sig"
    sig_dir.mkdir()
    rng = np.random.RandomState(2)
    for i, n in enumerate((950, 30, 1700)):
        np.savetxt(sig_dir / f"r{i}.signal", rng.randint(300, 700, n), fmt="%d")
    flags = types.SimpleNamespace(batch_size=4, segment_len=400, jump=390, start=0,
                                  sig_norm=1, reverse_fast5=False)
    file_dir, files = tpipe.list_input_files(str(sig_dir))
    assert (file_dir, files) == jpipe.list_input_files(str(sig_dir))
    got = list(tpipe._batch_stream(file_dir, files, flags, 1.0))
    want = list(jpipe._batch_stream(file_dir, files, flags, 1.0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g[:4], w[:4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert g[4].keys() == w[4].keys()


def test_cli_call_on_signal_files(tmp_path):
    sig_dir = tmp_path / "sig"
    sig_dir.mkdir()
    rng = np.random.RandomState(3)
    np.savetxt(sig_dir / "read0.signal", rng.randint(300, 700, 1200), fmt="%d")
    out = tmp_path / "out"
    result = tcli.main(["call", "-i", str(sig_dir), "-o", str(out), "-p", "dna-pre",
                        "-b", "8", "--beam", "4", "--device", "cpu", "--profile"])
    assert result["n_files"] == 1 and result["total_windows"] == 4
    assert (out / "profile" / "trace.json").stat().st_size > 0
    fq = (out / "result" / "read0.fastq").read_text().splitlines()
    assert fq[0] == "@read0" and len(fq[1]) == len(fq[3]) > 0


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["call", "-i", os.path.join(DATA, "DNA"), "-o", str(tmp_path / "o"),
                   "-p", "dna-pre"])


_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|chiron_tpu)(?![\w])|from\s+(?:jax|chiron_tpu)(?![\w])\S*\s+import)",
    re.MULTILINE)


def _port_sources():
    pkg = os.path.join(REPO, "chiron_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not sources
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_forbidden_import_pattern():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "import chiron_tpu", "from chiron_tpu.io import signal",
                "from chiron_tpu import config", "    import jax"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import chiron_tpu_torch", "from chiron_tpu_torch.io import signal",
               "from chiron_tpu_torch import config", "import jaxlib_free_module"):
        assert not _FORBIDDEN.search(ok), ok


def test_port_imports_no_jax_or_chiron_tpu():
    files = _port_sources()
    assert len(files) > 20 and os.path.basename(files[0]) == "chip_smoke.py"
    for path in files:
        with open(path) as f:
            src = f.read()
        m = _FORBIDDEN.search(src)
        assert m is None, f"{path}: {m.group(0).strip()}"
