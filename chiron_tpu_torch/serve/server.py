"""Inference server: serve a bundle over TCP with batched device execution.

A port of ``chiron_tpu/serve/server.py`` (the reference delegates serving to
an external tensorflow_model_server, README; client at
chiron/chiron_client.py). A threaded socket server accepts {x, seq_len}
requests, wrap-pads them to the bundle's static batch, runs the port's
forward + decode (``eval/pipeline.decode_step``) on the device, and sends
back {logits?, decoded, decoded_length, prob_logits, log_prob}. One lock
serialises the device; request threads do the IO and the readback outside
it, so concurrent clients pipeline.

As in the JAX package: ``seq_len`` goes to the model as sent, the beam runs
with ``length_bonus`` 0.0 (the JAX server builds its step without one;
``call`` takes the model's value), a partial batch is wrap-padded (batch-stat
BN makes a decode depend on its batch), ``decoded`` has ``t_out`` columns and
is -1 past each length, ``want_logits`` runs a second forward, and a
bundle whose model.json sets ``"bf16": true`` is served in bf16 inference
mode (the JAX package reads the mode from the config).

    python -m chiron_tpu_torch.serve.server -m <bundle> --port 5001 -b 400 [--device cpu]
"""

from __future__ import annotations

import json
import os
import socketserver
import threading
from typing import Optional

import numpy as np
import torch

from chiron_tpu_torch import config as C
from chiron_tpu_torch.eval.pipeline import decode_step, two_bit_labels, unpack_step_outputs
from chiron_tpu_torch.models.model import init_model, output_len
from chiron_tpu_torch.params import from_jax_params
from chiron_tpu_torch.serve.protocol import pack, read_message
from chiron_tpu_torch.train.checkpoint import restore_latest
from chiron_tpu_torch.utils.device import resolve_device


class InferenceEngine:
    """Loads a bundle onto ``device`` and runs batched forward + decode.

    Without a checkpoint in the bundle the weights come from the port's
    ``init_model`` with seed 0 (not the JAX package's seed-0 weights). On the
    card the constructor runs one step, so the kernels are built and loaded
    before the first request arrives.
    """

    def __init__(self, bundle_dir: str, batch_size: int = 64,
                 segment_len: Optional[int] = None, beam: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        with open(os.path.join(bundle_dir, "serving.json")) as f:
            manifest = json.load(f)
        self.segment_len = segment_len or int(manifest.get("segment_len", 400))
        self.beam = beam if beam is not None else int(manifest.get("beam", 0))
        self.batch_size = batch_size
        self.config = C.read_config(os.path.join(bundle_dir, "model.json"))
        params, _ = restore_latest(bundle_dir)
        if params is None:
            params = init_model(torch.Generator().manual_seed(0), self.config)
        self.model = from_jax_params(params, self.config, self.device)
        self.t_out = output_len(self.config, self.segment_len)
        self._two_bit = two_bit_labels(self.config)
        self._bf16 = bool(self.config.get("bf16"))
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            x = torch.zeros(batch_size, self.segment_len, device=self.device)
            sl = torch.full((batch_size,), self.segment_len, dtype=torch.int32,
                            device=self.device)
            decode_step(self.model, x, sl, self.beam, bf16=self._bf16).cpu()

    def predict(self, x: np.ndarray, seq_len: np.ndarray, want_logits=False):
        n = len(x)
        out = {
            "decoded": [], "decoded_length": [], "log_prob": [], "prob_logits": [],
        }
        logits_parts = []
        for ofs in range(0, n, self.batch_size):
            bx = x[ofs:ofs + self.batch_size]
            bl = seq_len[ofs:ofs + self.batch_size]
            pad = self.batch_size - len(bx)
            if pad:
                bx = np.pad(bx, ((0, pad), (0, 0)), mode="wrap")
                bl = np.pad(bl, (0, pad), mode="wrap")
            take = self.batch_size - pad
            with self._lock:  # serialise device access
                xd = torch.from_numpy(np.ascontiguousarray(bx, np.float32)).to(self.device)
                ld = torch.from_numpy(np.ascontiguousarray(bl, np.int32)).to(self.device)
                if want_logits:
                    with torch.no_grad():  # grad mode is per thread
                        logits_parts.append(
                            self.model(xd, ld, bf16=self._bf16)[:take].cpu().numpy())
                packed = decode_step(self.model, xd, ld, self.beam, bf16=self._bf16)
            dec, dlen, score, prob = unpack_step_outputs(packed.cpu().numpy(),
                                                         two_bit=self._two_bit)
            # 2-bit packing rounds columns up to a multiple of 4; the
            # signature promises [B, t_out] for both packed layouts
            dec = dec[:, : self.t_out].astype(np.int32)
            # positions past each decoded length are -1 (the 2-bit packed
            # layout zeroes them; the signature documents -1 padding)
            dec[np.arange(dec.shape[1])[None, :] >= dlen[:, None]] = -1
            out["decoded"].append(dec[:take])
            out["decoded_length"].append(dlen[:take])
            out["log_prob"].append(score[:take])
            out["prob_logits"].append(prob[:take])
        result = {k: np.concatenate(v) for k, v in out.items()}
        if want_logits:
            result["logits"] = np.concatenate(logits_parts)
        return result


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        engine: InferenceEngine = self.server.engine  # type: ignore
        while True:
            msg = read_message(self.request)
            if msg is None:
                return
            try:
                x = msg["x"].astype(np.float32)
                seq_len = msg["seq_len"].astype(np.int32)
                want_logits = bool(msg.get("want_logits", np.asarray(0)))
                result = engine.predict(x, seq_len, want_logits)
                if "request_id" in msg:
                    result["request_id"] = msg["request_id"]
                self.request.sendall(pack(result))
            except Exception as e:  # the client raises it as a RuntimeError
                self.request.sendall(
                    pack({"error": np.frombuffer(str(e).encode(), np.uint8)})
                )


class PredictionServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address, engine: InferenceEngine):
        super().__init__(address, _Handler)
        self.engine = engine


def serve(bundle_dir: str, host: str = "127.0.0.1", port: int = 5001,
          batch_size: int = 64, block: bool = True, device="cuda") -> PredictionServer:
    engine = InferenceEngine(bundle_dir, batch_size=batch_size, device=device)
    server = PredictionServer((host, port), engine)
    if block:
        print(f"Serving {bundle_dir} on {host}:{server.server_address[1]} ({engine.device})")
        server.serve_forever()
    else:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
    return server


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="chiron_tpu_torch inference server")
    parser.add_argument("-m", "--bundle", required=True, help="serving bundle dir")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5001)
    parser.add_argument("-b", "--batch_size", type=int, default=64)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda without a GPU is an error.")
    args = parser.parse_args(argv)
    serve(args.bundle, args.host, args.port, args.batch_size, device=args.device)


if __name__ == "__main__":
    main()
