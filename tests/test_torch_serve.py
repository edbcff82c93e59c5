"""The port's serving entry point (``chiron_tpu_torch/serve``) against the JAX
package's (``chiron_tpu/serve``), on the CPU.

The bundle layout and the wire protocol are byte-compatible, so each
package's client talks to each package's server. The port's engine decodes
as the JAX engine does on the same bundle and the same wrap-padded batches:
decodes identical, ``log_prob`` and ``prob_logits`` within 1e-4 relative,
logits within 5e-4 of max |logit| (the port's step tolerance against JAX:
12 batch-stat convs and an LSTM stack, float32 sums in another order).
Every server binds 127.0.0.1 port 0 and is shut down in a ``finally``; every
client call and join has a timeout of 60 s or less.
"""

import json
import os
import pathlib
import socket
import struct
import threading
import types

import jax
import numpy as np
import pytest
import torch

from chiron_tpu import config as jconfig
from chiron_tpu.models import init_model as jax_init_model
from chiron_tpu.serve import client as jclient
from chiron_tpu.serve import export as jexport
from chiron_tpu.serve import protocol as jprotocol
from chiron_tpu.serve import server as jserver
from chiron_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from chiron_tpu_torch.io.signal import read_signal_for_eval
from chiron_tpu_torch.serve import client as tclient
from chiron_tpu_torch.serve import export as texport
from chiron_tpu_torch.serve import protocol as tprotocol
from chiron_tpu_torch.serve import server as tserver
from synth import make_training_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DNA_DEFAULT = os.path.join(REPO, "chiron_tpu", "model", "DNA_default")
TIMEOUT = 60.0
STEP_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: the plain kernels run many
    small ops, and several test workers' torch thread pools competing for the
    cores made these tests ~60x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _custom_model_dir(path):
    """A `custom` front with one 16-unit LSTM layer, JAX seed-0 weights."""
    cfg = jconfig.default_config()
    cfg["rnn"] = {"layer_num": 1, "hidden_num": 16, "cell_type": "LSTM", "layer_type": "normal"}
    cfg["cnn"] = {"model": "custom"}
    os.makedirs(path, exist_ok=True)
    jconfig.save_config(os.path.join(path, "model.json"), cfg)
    jax_save_checkpoint(path, jax_init_model(jax.random.PRNGKey(0), cfg), 1)
    return path


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bundles"))
    custom = _custom_model_dir(os.path.join(root, "custom"))
    return {"custom": texport.export_model(custom, os.path.join(root, "export_custom"),
                                           segment_len=64, beam=0),
            "dna": texport.export_model(DNA_DEFAULT, os.path.join(root, "export_dna"),
                                        segment_len=400, beam=0)}


def _dna_windows(tmp_path, n):
    """n windows of 400 samples of synthetic reads, mean/std normalised."""
    sig = os.path.join(str(tmp_path), "sig")
    make_training_dir(sig, n_files=1, n_bases=60 * n, seed=11)
    x, lengths = read_signal_for_eval(os.path.join(sig, "read0.signal"), 0, step=390,
                                      seg_length=400, normalize=1)
    assert len(x) >= n
    return x[:n], lengths[:n].astype(np.int32)


@pytest.fixture
def port_server(request):
    servers = []

    def start(bundle, batch_size):
        server = tserver.serve(bundle, port=0, batch_size=batch_size, block=False, device="cpu")
        servers.append(server)
        return server

    yield start
    for server in servers:
        server.shutdown()
        server.server_close()


@pytest.fixture
def jax_server():
    servers = []

    def start(bundle, batch_size):
        server = jserver.serve(bundle, port=0, batch_size=batch_size, block=False)
        servers.append(server)
        return server

    yield start
    for server in servers:
        server.shutdown()
        server.server_close()


def _assert_same_response(got, want, rel=1e-4, exact=False):
    np.testing.assert_array_equal(got["decoded"], want["decoded"])
    np.testing.assert_array_equal(got["decoded_length"], want["decoded_length"])
    assert got["decoded"].dtype == want["decoded"].dtype == np.int32
    for key in ("log_prob", "prob_logits"):
        if exact:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=rel, atol=0, err_msg=key)


def _assert_minus_one_past_length(result):
    dec, dlen = result["decoded"], result["decoded_length"]
    for i in range(len(dec)):
        assert (dec[i, dlen[i]:] == -1).all()
        assert (dec[i, :dlen[i]] >= 0).all()


# ---- export ---------------------------------------------------------------


def test_export_bundle_matches_jax_byte_for_byte(tmp_path):
    model = _custom_model_dir(os.path.join(str(tmp_path), "model"))
    t_root, j_root = os.path.join(str(tmp_path), "t"), os.path.join(str(tmp_path), "j")
    for kw in (dict(segment_len=100, beam=0), dict(segment_len=400, beam=30)):
        t_b = texport.export_model(model, t_root, **kw)
        j_b = jexport.export_model(model, j_root, **kw)
        assert os.path.basename(t_b) == os.path.basename(j_b)
        names = sorted(os.listdir(t_b))
        assert names == sorted(os.listdir(j_b))
        assert {"model.json", "serving.json", "checkpoint", "model-1.npz"} <= set(names)
        for name in names:
            with open(os.path.join(t_b, name), "rb") as a, open(os.path.join(j_b, name), "rb") as b:
                assert a.read() == b.read(), name
    assert t_b.endswith("/2")  # the second export bumps the version
    assert texport.latest_bundle(j_root) == j_b and jexport.latest_bundle(t_root) == t_b
    assert texport.export_model(model, t_root, version=7).endswith("/7")
    assert texport.SIGNATURE == jexport.SIGNATURE
    assert json.loads(pathlib.Path(t_b, "serving.json").read_text())["beam"] == 30
    with pytest.raises(FileNotFoundError):
        texport.latest_bundle(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        texport.export_model(str(tmp_path), t_root)  # no checkpoint there
    assert texport.main(["-m", model, "-o", t_root, "-s", "64"]) == 0
    assert texport.latest_bundle(t_root).endswith("/8")


# ---- protocol -------------------------------------------------------------


def test_protocol_both_ways_over_a_socketpair():
    rng = np.random.RandomState(0)
    arrays = {"x": rng.randn(5, 64).astype(np.float32), "seq_len": np.arange(5, dtype=np.int32),
              "request_id": np.asarray(3), "error": np.frombuffer(b"boom", np.uint8)}
    for packer, reader in ((tprotocol.pack, jprotocol.read_message),
                           (jprotocol.pack, tprotocol.read_message)):
        a, b = socket.socketpair()
        a.settimeout(TIMEOUT)
        b.settimeout(TIMEOUT)
        try:
            msg = packer(arrays)
            sender = threading.Thread(target=a.sendall, args=(msg + msg,))
            sender.start()
            for _ in range(2):
                got = reader(b)
                assert sorted(got) == sorted(arrays)
                for k, v in arrays.items():
                    assert got[k].dtype == v.dtype
                    np.testing.assert_array_equal(got[k], v)
            sender.join(TIMEOUT)
            assert not sender.is_alive()
            # a stream cut inside a payload, then one cut inside a header
            a.sendall(msg[:len(msg) // 2])
            a.shutdown(socket.SHUT_WR)
            assert reader(b) is None
            assert reader(b) is None
        finally:
            a.close()
            b.close()
    a, b = socket.socketpair()
    b.settimeout(TIMEOUT)
    try:
        a.sendall(struct.pack(">Q", tprotocol.MAX_MESSAGE + 1))
        with pytest.raises(ValueError, match="too large"):
            tprotocol.read_message(b)
        a.sendall(b"\x00\x00\x00")
        a.close()
        assert tprotocol.read_message(b) is None
    finally:
        b.close()
    assert tprotocol.MAX_MESSAGE == jprotocol.MAX_MESSAGE


# ---- the engine -----------------------------------------------------------


@pytest.mark.parametrize("model,beam", [("custom", 0), ("custom", 4), ("dna", 0), ("dna", 4)])
def test_engine_decodes_as_the_jax_engine(tmp_path, bundles, model, beam):
    if model == "custom":
        x = np.random.RandomState(1).randn(19, 64).astype(np.float32)
        sl = np.random.RandomState(2).randint(1, 65, 19).astype(np.int32)
        batch = 8
    else:
        x, sl = _dna_windows(tmp_path, 6)
        sl[-1] = 250  # a short window
        batch = 4
    port = tserver.InferenceEngine(bundles[model], batch_size=batch, beam=beam, device="cpu")
    ref = jserver.InferenceEngine(bundles[model], batch_size=batch, beam=beam)
    got = port.predict(x, sl, want_logits=True)
    want = ref.predict(x, sl, want_logits=True)
    assert got["decoded"].shape == want["decoded"].shape == (len(x), port.t_out)
    _assert_same_response(got, want)
    _assert_minus_one_past_length(got)
    assert got["decoded_length"].sum() > 0
    assert got["logits"].shape == want["logits"].shape == (len(x), port.t_out, 5)
    scale = float(np.abs(want["logits"]).max())
    assert float(np.abs(got["logits"] - want["logits"]).max()) <= STEP_TOL * scale
    # the last, partial batch decodes as its wrap-padded batch does
    tail = len(x) - len(x) % batch
    padded = np.pad(x[tail:], ((0, batch - len(x) + tail), (0, 0)), mode="wrap")
    padded_sl = np.pad(sl[tail:], (0, batch - len(x) + tail), mode="wrap")
    alone = port.predict(padded, padded_sl)
    _assert_same_response({k: v[:len(x) - tail] for k, v in alone.items()},
                          {k: v[tail:] for k, v in got.items() if k != "logits"}, exact=True)


def test_engine_and_server_default_to_the_card(bundles):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.InferenceEngine(bundles["custom"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.serve(bundles["custom"], port=0, block=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.main(["-m", bundles["custom"], "--port", "0"])


def test_engine_without_a_checkpoint_takes_the_ports_seed_0_weights(tmp_path, bundles):
    from chiron_tpu_torch.models.model import init_model
    from chiron_tpu_torch.params import from_jax_params

    bare = os.path.join(str(tmp_path), "bare")
    os.makedirs(bare)
    for name in ("model.json", "serving.json"):
        with open(os.path.join(bundles["custom"], name), "rb") as a, \
                open(os.path.join(bare, name), "wb") as b:
            b.write(a.read())
    eng = tserver.InferenceEngine(bare, batch_size=4, device="cpu")
    want = from_jax_params(init_model(torch.Generator().manual_seed(0), eng.config), eng.config,
                           "cpu")
    for k, p in eng.model.flat.items():
        assert torch.equal(p, want.flat[k]), k


def test_a_bf16_bundle_is_served_in_bf16_mode(tmp_path, bundles):
    """JAX's engine takes the mode from the bundle's config (``"bf16": true``,
    what ``call --bf16`` sets): the port's engine decodes as the port's bf16
    decode_step on the same batch."""
    from chiron_tpu_torch.eval.pipeline import decode_step, unpack_step_outputs

    bundle = os.path.join(str(tmp_path), "bf16")
    os.makedirs(bundle)
    for name in os.listdir(bundles["custom"]):
        with open(os.path.join(bundles["custom"], name), "rb") as a, \
                open(os.path.join(bundle, name), "wb") as b:
            b.write(a.read())
    cfg = json.loads(pathlib.Path(bundle, "model.json").read_text())
    with open(os.path.join(bundle, "model.json"), "w") as f:
        json.dump({**cfg, "bf16": True}, f)
    x = np.random.RandomState(4).randn(8, 64).astype(np.float32)
    sl = np.full(8, 64, np.int32)
    eng = tserver.InferenceEngine(bundle, batch_size=8, beam=4, device="cpu")
    got = eng.predict(x, sl, want_logits=True)
    for bf16 in (True, False):
        dec, dlen, score, prob = unpack_step_outputs(decode_step(
            eng.model, torch.from_numpy(x), torch.from_numpy(sl), 4, bf16=bf16).numpy())
        same = np.array_equal(score, got["log_prob"]) and np.array_equal(prob, got["prob_logits"])
        assert same == bf16
    want = eng.model(torch.from_numpy(x), torch.from_numpy(sl), bf16=True).numpy()
    np.testing.assert_array_equal(got["logits"], want)


# ---- server and client, both packages -------------------------------------


def test_each_client_talks_to_each_server(bundles, port_server, jax_server):
    x = np.random.RandomState(3).randn(11, 64).astype(np.float32)
    sl = np.full(11, 64, np.int32)
    served = {}
    for side, start in (("port", port_server), ("jax", jax_server)):
        port = start(bundles["custom"], 8).server_address[1]
        by_client = {}
        for name, mod in (("port", tclient), ("jax", jclient)):
            client = mod.PredictionClient(port=port, timeout=TIMEOUT)
            try:
                by_client[name] = client.predict(x, sl, request_id=9)
            finally:
                client.close()
            assert int(by_client[name]["request_id"]) == 9
            _assert_minus_one_past_length(by_client[name])
        _assert_same_response(by_client["port"], by_client["jax"], exact=True)
        served[side] = by_client["port"]
    _assert_same_response(served["port"], served["jax"])
    # want_logits over the wire, and a request the engine refuses comes back as an error
    client = tclient.PredictionClient(port=port_server(bundles["custom"], 8).server_address[1],
                                      timeout=TIMEOUT)
    try:
        r = client.predict(x, sl, want_logits=True)
        assert r["logits"].shape == (11, 64, 5)
        _assert_same_response(r, served["port"], exact=True)
        with pytest.raises(RuntimeError):
            client.predict(np.zeros((2, 3, 4), np.float32), np.zeros(2, np.int32))
        # the connection survives an error
        _assert_same_response(client.predict(x, sl), served["port"], exact=True)
    finally:
        client.close()


def test_run_call_writes_the_jax_clients_fastq(tmp_path, bundles, port_server, jax_server):
    sig = os.path.join(str(tmp_path), "sig")
    make_training_dir(sig, n_files=3, n_bases=120, seed=12)
    for name in os.listdir(sig):
        if name.endswith(".label"):
            os.remove(os.path.join(sig, name))
    out = {}
    for side, start, mod in (("port", port_server, tclient), ("jax", jax_server, jclient)):
        port = start(bundles["dna"], 8).server_address[1]
        flags = types.SimpleNamespace(
            input=sig, output=os.path.join(str(tmp_path), f"out_{side}"), host="127.0.0.1",
            port=port, batch_size=8, segment_len=400, jump=390, start=0, extension="fastq",
            mode="dna", reverse_fast5=False, concise=False, model="remote", sig_norm=1,
            max_in_flight=2)
        res = {}
        t = threading.Thread(target=lambda: res.update(mod.run_call(flags)), daemon=True)
        t.start()
        t.join(TIMEOUT)
        assert not t.is_alive(), f"{side} run_call did not finish in {TIMEOUT} s"
        assert res["n_files"] == 3 and res["total_bases"] > 0
        result = os.path.join(flags.output, "result")
        out[side] = {n: pathlib.Path(result, n).read_text() for n in sorted(os.listdir(result))}
    assert len(out["port"]) == 3
    assert out["port"] == out["jax"]
