"""Remote basecalling client with async submission and throttled collection.

A port of ``chiron_tpu/serve/client.py`` (parity with
chiron/chiron_client.py:59-256): windows each signal file, submits its
batches to the prediction server from a submitter thread (bounded in-flight
count, like the reference's condition-variable throttle in
_Result_Collection), collects results keyed by (file, batch index), and on
a file's completion runs the same overlap-consensus assembly, quality score
and write path as the local pipeline. A batch never crosses files. Host
only: the model runs in the server.

    python -m chiron_tpu_torch.serve.client -i <.signal dir> -o <out> --port 5001 -b 400
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, Tuple

import numpy as np

from chiron_tpu_torch import config as C
from chiron_tpu_torch.assembly import (
    consensus_to_bases,
    get_assembler_kernel,
    qs,
    simple_assembly_qs,
)
from chiron_tpu_torch.eval.pipeline import list_input_files
from chiron_tpu_torch.io.signal import read_signal_for_eval
from chiron_tpu_torch.io.writers import ensure_output_dirs, write_output
from chiron_tpu_torch.serve.protocol import pack, read_message


class PredictionClient:
    """Blocking request/response client over the npz protocol."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5001, timeout=300.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._lock = threading.Lock()

    def predict(self, x: np.ndarray, seq_len: np.ndarray, request_id: int = 0,
                want_logits: bool = False):
        msg = {
            "x": x.astype(np.float32),
            "seq_len": seq_len.astype(np.int32),
            "request_id": np.asarray(request_id),
        }
        if want_logits:
            msg["want_logits"] = np.asarray(1)
        with self._lock:
            self.sock.sendall(pack(msg))
            result = read_message(self.sock)
        if result is None:
            raise ConnectionError("server closed connection")
        if "error" in result:
            raise RuntimeError(result["error"].tobytes().decode())
        return result

    def close(self):
        self.sock.close()


class _ResultCollector:
    """Throttled async collector (reference _Result_Collection parity)."""

    def __init__(self, max_in_flight: int = 8):
        self.results: Dict[Tuple[str, int], dict] = {}
        self.cond = threading.Condition()
        self.in_flight = 0
        self.max_in_flight = max_in_flight
        self.error = None

    def acquire(self):
        with self.cond:
            while self.in_flight >= self.max_in_flight:
                self.cond.wait()
            self.in_flight += 1

    def deliver(self, key, value):
        with self.cond:
            self.results[key] = value
            self.in_flight -= 1
            self.cond.notify_all()

    def fail(self, err):
        with self.cond:
            self.error = err
            self.in_flight -= 1
            self.cond.notify_all()

    def pop_file(self, fname, n_batches):
        with self.cond:
            while True:
                if self.error:
                    raise self.error
                keys = [k for k in self.results if k[0] == fname]
                if len(keys) == n_batches:
                    return [self.results.pop((fname, i)) for i in range(n_batches)]
                self.cond.wait()


def run_call(flags) -> dict:
    """Basecall via a remote prediction server (chiron_client.do_inference)."""
    ensure_output_dirs(flags.output)
    client = PredictionClient(flags.host, flags.port)
    file_dir, file_list = list_input_files(flags.input, True)
    collector = _ResultCollector(max_in_flight=getattr(flags, "max_in_flight", 8))
    batch_size = flags.batch_size
    plan = []  # (fname, n_batches, n_windows, read_time)

    def submitter():
        try:
            for name in file_list:
                t0 = time.time()
                windows, lengths = read_signal_for_eval(
                    os.path.join(file_dir, name),
                    flags.start,
                    step=flags.jump,
                    seg_length=flags.segment_len,
                    normalize=getattr(flags, "sig_norm", None),
                    reverse_fast5=getattr(flags, "reverse_fast5", False),
                )
                n_batches = -(-len(windows) // batch_size) if len(windows) else 0
                plan.append((name, n_batches, len(windows), time.time() - t0))
                for bi in range(n_batches):
                    collector.acquire()
                    sl = lengths[bi * batch_size:(bi + 1) * batch_size]
                    bx = windows[bi * batch_size:(bi + 1) * batch_size]
                    try:
                        result = client.predict(bx, sl, request_id=bi)
                        collector.deliver((name, bi), result)
                    except Exception as e:
                        collector.fail(e)
                        return
        finally:
            plan.append(None)  # sentinel

    t = threading.Thread(target=submitter, daemon=True)
    t.start()

    total_bases = 0
    fi = 0
    try:
        while True:
            while len(plan) <= fi:
                time.sleep(0.005)
            entry = plan[fi]
            if entry is None:
                break
            fname, n_batches, n_windows, read_time = entry
            fi += 1
            start_time = time.time() - read_time
            results = collector.pop_file(fname, n_batches)
            bpreads = []
            qs_list = []
            for r in results:
                dec = r["decoded"]
                dlen = r["decoded_length"]
                prob = r["prob_logits"]
                for i in range(len(dec)):
                    bpreads.append("".join(C.BASES[c] for c in dec[i][: dlen[i]]))
                    qs_list.append([float(prob[i])])
            basecall_time = time.time() - start_time
            nonempty = [i for i, b in enumerate(bpreads) if b]
            file_pre = os.path.splitext(fname)[0].replace(os.path.sep, "_")
            kernel = get_assembler_kernel(flags.jump, flags.segment_len)
            if nonempty:
                consensus, consensus_qs = simple_assembly_qs(
                    [bpreads[i] for i in nonempty],
                    np.asarray(qs_list)[nonempty],
                    flags.jump / flags.segment_len,
                    kernel=kernel,
                )
                qs_string = qs(consensus, consensus_qs)
                c_bpread = consensus_to_bases(consensus)
            else:
                qs_string = ""
                c_bpread = ""
            assembly_time = time.time() - start_time
            write_output(
                bpreads,
                c_bpread,
                [start_time, read_time, basecall_time, assembly_time],
                file_pre,
                concise=getattr(flags, "concise", False),
                suffix=getattr(flags, "extension", "fastq"),
                q_score=qs_string,
                global_setting=flags,
            )
            total_bases += len(c_bpread)
    finally:
        client.close()
    return {"n_files": len(file_list), "total_bases": total_bases}


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="chiron_tpu_torch serving client")
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5001)
    parser.add_argument("-b", "--batch_size", type=int, default=64)
    parser.add_argument("-l", "--segment_len", type=int, default=400)
    parser.add_argument("-j", "--jump", type=int, default=390)
    parser.add_argument("-s", "--start", type=int, default=0)
    parser.add_argument("-e", "--extension", default="fastq")
    parser.add_argument("--mode", default="dna")
    args = parser.parse_args(argv)
    args.model = f"{args.host}:{args.port}"
    args.reverse_fast5 = args.mode == "rna"
    args.concise = False
    return run_call(args)


if __name__ == "__main__":
    main()
