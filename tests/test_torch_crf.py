"""Bonito's CTC-CRF model in the port (``models/crf.py``, the ``bonito_stem``
front, the ``alternating`` stack, ``ops/crf.py``, the pipeline's CRF step)
against the plain reference ``chiron_tpu_torch/reference/bonito_crf.py`` on
seeded weights in Bonito's layout, and the reference against ``torch.nn`` and
against a decode by enumeration of every path.

Small and on the CPU: features 16, state_len 1-3, windows of 60-300 samples.
Tolerances: float32 sums in other orders, 2e-5 of the largest value for
features and scores, 1e-4 absolute for log posteriors (alpha + beta of a
60-frame row is ~200) and for their mean gap, 1e-4 a frame for the Viterbi
score (a sum of one a frame); the decoded strings equal.
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from chiron_tpu_torch import cli
from chiron_tpu_torch import config as C
from chiron_tpu_torch.eval.pipeline import decode_step, unpack_step_outputs
from chiron_tpu_torch.models import crf as MC
from chiron_tpu_torch.models import model as M
from chiron_tpu_torch.models import rnn as R
from chiron_tpu_torch.ops import conv_bn as CB
from chiron_tpu_torch.ops import crf as OC
from chiron_tpu_torch.params import from_jax_params
from chiron_tpu_torch.reference import bonito_crf as RB
from chiron_tpu_torch.train import loop
from chiron_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(2)

GAINS = {"conv": 3.0, "lstm": 3.0, "head": 3.0}
FEATURES, LAYERS = 16, 5


def crf_config(state_len=2, features=FEATURES, layers=LAYERS):
    return {"cnn": {"model": "bonito_stem", "features": features, "winlen": 19, "stride": 5},
            "rnn": {"layer_num": layers, "hidden_num": features, "cell_type": "LSTM",
                    "layer_type": "alternating"},
            "decoder": {"type": "crf", "state_len": state_len, "scale": 5.0,
                        "blank_score": 2.0},
            "opt_method": "Adam", "fl_gamma": 0}


def _weights(state_len=2, seed=7):
    state = RB.init_bonito(seed, features=FEATURES, state_len=state_len, layers=LAYERS,
                           gains=GAINS)
    model = from_jax_params(MC.from_bonito(state, LAYERS), crf_config(state_len), "cpu")
    return state, model, RB.BonitoCRF(state, "cpu")


def _windows(samples, width=300, seed=0):
    x = torch.randn(len(samples), width, generator=torch.Generator().manual_seed(seed))
    for i, n in enumerate(samples):
        x[i, n:] = 0
    return x, torch.from_numpy(RB.window_frames(samples)).int()


SAMPLES = [300, 300, 251, 120, 7, 298]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# -- the reference against torch.nn, in Bonito's layout ------------------------

def test_reference_model_matches_torch_nn():
    state = RB.init_bonito(3, features=FEATURES, state_len=2, layers=LAYERS, gains=GAINS)
    ref = RB.BonitoCRF(state, "cpu")
    w = {k: torch.from_numpy(v) for k, v in state.items()}
    x, _ = _windows([300, 300])
    y = x[:, None, :]
    for i, (c_in, c_out, k, s) in enumerate(RB.stem_shapes(FEATURES, 19, 5)):
        conv = torch.nn.Conv1d(c_in, c_out, k, stride=s, padding=k // 2)
        conv.load_state_dict({"weight": w[f"encoder.{i}.conv.weight"],
                              "bias": w[f"encoder.{i}.conv.bias"]})
        y = torch.nn.functional.silu(conv(y))
    with torch.no_grad():
        feats = ref.stem(x)
        assert feats.shape == (2, 60, FEATURES)  # ceil(300 / 5): padding 9, not SAME's 7
        assert _rel(feats, y.detach().transpose(1, 2)) < 2e-5
        h = y.detach().permute(2, 0, 1)  # [T, B, C], Bonito's layout
        full = torch.full((2,), 60, dtype=torch.int64)
        for j in range(LAYERS):
            lstm = torch.nn.LSTM(FEATURES, FEATURES)
            lstm.load_state_dict({n: w[f"encoder.{4 + j}.rnn.{n}"] for n, _ in
                                  lstm.named_parameters()})
            rev = (LAYERS - j) % 2 == 1  # bonito's RNNWrapper flips the chunk
            out = lstm(h.flip(0) if rev else h)[0]
            mine = ref.lstm(h.transpose(0, 1), 4 + j, full, rev)
            h = out.flip(0) if rev else out
            assert _rel(mine, h.transpose(0, 1)) < 2e-5, j
        lin = torch.nn.Linear(FEATURES, 64)
        lin.load_state_dict({"weight": w["encoder.9.linear.weight"],
                             "bias": w["encoder.9.linear.bias"]})
        want = 5.0 * torch.tanh(lin(h.transpose(0, 1)))
        m = ref.scores(h.transpose(0, 1))
        assert m.shape == (2, 60, 16, 5)
        assert torch.all(m[..., 0] == 2.0)
        assert _rel(m[..., 1:].reshape(2, 60, 64), want) < 2e-5


def test_reference_decode_matches_enumeration():
    """Posteriors, logZ and the Viterbi path of the reference against a sum
    and a max over every path of a 4-state model over 4 frames."""
    g = torch.Generator().manual_seed(1)
    s_count, t_max = 4, 4
    m = torch.cat([torch.full((1, t_max, s_count, 1), 2.0),
                   3 * torch.randn(1, t_max, s_count, 4, generator=g)], dim=3).double()
    ref = RB.BonitoCRF(RB.init_bonito(0, features=4, state_len=1, layers=1), "cpu")
    path, score, prob, logp = ref.decode(m, torch.tensor([t_max]))
    idx = ref.idx
    total = torch.zeros((t_max, s_count, 5), dtype=torch.float64)
    edges_from = {p: [(s, c) for s in range(s_count) for c in range(5) if idx[s, c] == p]
                  for p in range(s_count)}  # the edges (s, c) whose predecessor is p
    paths = []
    for s0 in range(s_count):
        for steps in itertools.product(range(5), repeat=t_max):  # 5 edges leave each state
            st, w, edges = s0, 0.0, []
            for t, e in enumerate(steps):
                st, c = edges_from[st][e]
                w += float(m[0, t, st, c])
                edges.append((t, st, c))
            paths.append((w, edges))
    log_z = torch.logsumexp(torch.tensor([w for w, _ in paths], dtype=torch.float64), 0)
    for w, edges in paths:
        for t, s, c in edges:
            total[t, s, c] += torch.exp(w - log_z)
    assert torch.allclose(torch.exp(logp[0]), total + 1e-8, rtol=1e-12, atol=1e-15)
    lpe = torch.log(total + 1e-8)
    best = max(paths, key=lambda p: sum(float(lpe[t, s, c]) for t, s, c in p[1]))
    assert [c for _, _, c in best[1]] == path[0].tolist()
    assert float(score[0]) == pytest.approx(sum(float(lpe[t, s, c]) for t, s, c in best[1]))
    gaps = [float(v[-1] - v[-2]) for v in torch.sort(lpe.reshape(t_max, -1), dim=1).values]
    assert float(prob[0]) == pytest.approx(np.mean(gaps))


# -- the port against the reference ---------------------------------------------

def test_weight_import_and_every_layer_match_the_reference():
    state, model, ref = _weights()
    x, frames = _windows(SAMPLES)
    with torch.no_grad():
        fea = M._front_features(model.params, model.config, x, False, False)
        want = ref.stem(x)
        assert _rel(fea, want) < 2e-5  # the stem's kernels' plain versions, padding k // 2
        h = model.encode(x, frames)
        assert h.shape == (len(SAMPLES), 60, FEATURES)
        assert _rel(h, ref.encode(x, frames)) < 2e-5  # gates reordered, biases folded
        for i, n in enumerate(frames.tolist()):
            assert torch.all(h[i, n:] == 0)  # every layer zero past the row's frames
        scores = model(x, frames)
        assert _rel(scores, ref.scores(h)[..., 1:].reshape(scores.shape)) < 2e-5


@pytest.mark.parametrize("state_len", [2, 3])
def test_crf_plain_decode_matches_the_reference(state_len):
    g = torch.Generator().manual_seed(state_len)
    s_count = 4 ** state_len
    z = 5 * torch.tanh(1.5 * torch.randn(5, 60, 4 * s_count, generator=g))
    lengths = torch.tensor([60, 60, 41, 9, 1], dtype=torch.int32)
    beta = OC.crf_beta_plain(z, lengths, 2.0)
    tb, score, prob, final, post = OC.crf_forward_plain(z, lengths, beta, 2.0, posteriors=True)
    path = OC.crf_traceback_plain(tb, final, lengths)
    ref = RB.BonitoCRF(RB.init_bonito(0, features=4, state_len=state_len, layers=1), "cpu")
    m = torch.cat([torch.full(z.shape[:2] + (s_count, 1), 2.0), z.reshape(5, 60, s_count, 4)], 3)
    rpath, rscore, rprob, rlogp = ref.decode(m, lengths)
    assert (post - rlogp).abs().max() < 1e-4
    assert torch.equal(path.long(), rpath)
    assert ((score - rscore).abs() <= 1e-4 * lengths).all()  # 1e-4 a frame
    assert (prob - rprob).abs().max() < 1e-4
    decoded, n, score2, _ = OC.crf_decode(z, lengths, 2.0)
    assert torch.equal(score2, score)
    for i, s in enumerate(RB.path_strings(rpath)):
        assert "".join("ACGT"[c] for c in decoded[i, :n[i]].tolist()) == s


@pytest.mark.parametrize("bf16", [False, True])
def test_decode_step_matches_the_reference(bf16):
    """The pipeline's CRF step: the same strings, the scores within 1e-3 of
    the largest (float32) and 1e-2 (bf16 inference mode)."""
    _, model, ref = _weights(state_len=2)
    x, frames = _windows(SAMPLES)
    strings, score, prob = ref.basecall(x, frames)
    out = decode_step(model, x, frames, beam=30, bf16=bf16)
    dec, lens, sc, pr = unpack_step_outputs(out.numpy())
    got = ["".join("ACGT"[c] for c in dec[i, :lens[i]]) for i in range(len(SAMPLES))]
    assert got == strings
    assert sum(len(s) for s in got) > 60  # the weights emit bases
    gap = np.abs(sc - score.numpy()).max() / np.abs(score.numpy()).max()
    assert gap < (1e-2 if bf16 else 1e-5)
    assert np.abs(pr - prob.numpy()).max() < (1e-2 if bf16 else 1e-5)


def test_call_end_to_end_matches_the_reference(tmp_path):
    """A tiny `chiron call` of a CRF model directory: every window's decode in
    the segments file equals the reference's decode of the same window."""
    state, _, ref = _weights(state_len=2)
    model_dir = tmp_path / "model"
    os.makedirs(model_dir)
    with open(model_dir / "model.json", "w") as f:
        json.dump(crf_config(2), f)
    save_checkpoint(str(model_dir), MC.from_bonito(state, LAYERS), 0)
    rng = np.random.RandomState(5)
    inp = tmp_path / "in"
    os.makedirs(inp)
    reads = {"r0": rng.randint(300, 700, 1000), "r1": rng.randint(300, 700, 613)}
    for name, sig in reads.items():
        (inp / f"{name}.signal").write_text(" ".join(map(str, sig.tolist())))
    out = tmp_path / "out"
    cli.main(["call", "-i", str(inp), "-o", str(out), "-m", str(model_dir), "-l", "300",
              "-j", "250", "-b", "4", "--sig_norm", "0", "--device", "cpu"])
    from chiron_tpu_torch.io.signal import read_signal_for_eval

    for name in reads:
        w, lens = read_signal_for_eval(str(inp / f"{name}.signal"), 0, 250, 300, 0)
        want, _, _ = ref.basecall(torch.from_numpy(w),
                                  torch.from_numpy(RB.window_frames(lens)))
        lines = (out / "segments" / f"{name}.fastq").read_text().split("\n")
        got = [lines[i + 1] for i in range(0, len(lines) - 1, 2) if lines[i].startswith(">")]
        assert got == want
        fastq = (out / "result" / f"{name}.fastq").read_text().split("\n")
        assert fastq[0] == f"@{name}" and len(fastq[1]) == len(fastq[3]) > 0


def test_call_profile_writes_the_crf_spans(tmp_path):
    """`call --profile` on a CRF model: a ``model.crf_head`` and a
    ``model.crf_decode`` span a batch, inside ``model.decode``."""
    state, _, _ = _weights(state_len=2)
    model_dir = tmp_path / "model"
    os.makedirs(model_dir)
    (model_dir / "model.json").write_text(json.dumps(crf_config(2)))
    save_checkpoint(str(model_dir), MC.from_bonito(state, LAYERS), 0)
    os.makedirs(tmp_path / "in")
    sig = np.random.RandomState(1).randint(300, 700, 1400)
    (tmp_path / "in" / "r.signal").write_text(" ".join(map(str, sig.tolist())))
    out = tmp_path / "out"
    cli.main(["call", "-i", str(tmp_path / "in"), "-o", str(out), "-m", str(model_dir), "-l",
              "300", "-j", "250", "-b", "2", "--sig_norm", "0", "--device", "cpu",
              "--profile"])
    with open(out / "profile" / "spans.json") as f:
        doc = json.load(f)
    totals = doc["totals"]
    batches = 3  # 6 windows of 2
    assert totals["model.crf_head"]["count"] == totals["model.crf_decode"]["count"] == batches
    assert totals["model.decode"]["count"] == batches
    parents = {e["name"]: e.get("args", {}).get("parent") for e in doc["traceEvents"]
               if e.get("name", "").startswith("model.crf")}
    assert parents == {"model.crf_head": "model.decode", "model.crf_decode": "model.decode"}


# -- the pieces -------------------------------------------------------------------

def test_alternating_stack_reverses_the_last_layer_and_every_second_before():
    assert [R.layer_reversed(i, 5) for i in range(5)] == [True, False, True, False, True]
    assert [R.layer_reversed(i, 2) for i in range(2)] == [False, True]


def test_window_frames_ceil_for_crf_round_for_ctc():
    samples = np.array([4000, 3501, 3502, 3503, 1])
    assert M.window_frames(crf_config(), samples, 4000).tolist() == [800, 701, 701, 701, 1]
    dna = C.read_config(None)
    assert M.window_frames(dna, samples, 400).tolist() == np.round(samples / 1.0).tolist()


def test_stem_conv_swish_and_explicit_padding_plain():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 101, 4, generator=g)
    w = torch.randn(19, 4, 8, generator=g)
    a, b = torch.rand(4, generator=g) + 0.5, torch.randn(4, generator=g)
    y, sums, sqs = CB.conv_bn([(x, a, b)], w, False, stride=5, swish_in=True, padding=9)
    v = x * a + b
    want = torch.nn.functional.conv1d((v * torch.sigmoid(v)).transpose(1, 2),
                                      w.permute(2, 1, 0), stride=5, padding=9).transpose(1, 2)
    assert y.shape == (3, 21, 8) and _rel(y, want) < 1e-5
    assert torch.allclose(sums, want.sum(dim=(0, 1)), rtol=1e-4, atol=1e-4)
    assert CB.conv_window(4000, 19, 5, 1, 9) == (800, 9, 9)
    assert CB.conv_window(4000, 19, 5, 1, "SAME") == (800, 7, 7)
    with pytest.raises(ValueError):
        CB.conv_bn([(x, a, b)], w, True, swish_in=True)


def test_config_decoder():
    assert C.decoder(C.read_config(None)) == {"type": "ctc"}
    assert C.decoder({"decoder": {"type": "crf"}}) == C.CRF_DEFAULTS
    assert C.is_crf(crf_config()) and not C.is_crf(C.read_config(None))
    with pytest.raises(ValueError):
        C.decoder({"decoder": {"type": "beam"}})
    with pytest.raises(ValueError):
        C.decoder({"decoder": {"type": "crf"}, "alphabet": 5})
    bad = crf_config()
    bad["rnn"]["layer_type"] = "normal"
    with pytest.raises(ValueError):
        M.init_model(torch.Generator().manual_seed(0), bad)


def test_init_model_builds_the_from_bonito_tree():
    params = M.init_model(torch.Generator().manual_seed(0), crf_config(3))
    state = RB.init_bonito(0, features=FEATURES, state_len=3, layers=LAYERS)
    tree = MC.from_bonito(state, LAYERS)

    def shapes(t, p=""):
        if isinstance(t, dict):
            return {k2: v for k, sub in t.items() for k2, v in shapes(sub, f"{p}/{k}").items()}
        if isinstance(t, list):
            return {k2: v for i, sub in enumerate(t) for k2, v in shapes(sub, f"{p}/{i}").items()}
        return {p: tuple(t.shape)}

    assert shapes(params) == shapes(tree)


def test_crf_wrapper_checks_its_inputs():
    z = torch.zeros(2, 5, 48)
    with pytest.raises(ValueError):
        OC.crf_decode(z, torch.ones(2, dtype=torch.int32), 2.0)  # 48 is no 4^(L+1)
    with pytest.raises(ValueError):
        OC.crf_decode(torch.zeros(2, 5, 64), torch.ones(2, dtype=torch.int64), 2.0)
    assert OC.n_states(torch.zeros(1, 1, 4096)) == 1024


def test_train_refuses_a_crf_model(tmp_path):
    with pytest.raises(ValueError, match="CRF"):
        loop.make_train_step(crf_config(), 0.0)
    _, model, _ = _weights()
    x, frames = _windows([300])
    with pytest.raises(ValueError, match="CRF"):
        model(x, frames, training=True)
    conf = tmp_path / "crf.json"
    conf.write_text(json.dumps(crf_config()))
    with pytest.raises(ValueError, match="CRF"):
        cli.main(["train", "-i", str(tmp_path), "-o", str(tmp_path / "log"), "-m", "m",
                  "--configure", str(conf), "--device", "cpu"])
