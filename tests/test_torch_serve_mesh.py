# -*- coding: utf-8 -*-
"""The port's server over a mesh (`python -m fddm_asr_tpu_torch.serve
--mesh ...`, one process a rank, gloo on the CPU) against a one-process
server, as the repository's `tests/test_serve.py:271-315` holds its sharded
server against a data-parallel one.

* Three servers on the same tiny model: one process, four ranks at data=2 x
  model=2 (tensor parallel) and two ranks at model=2 `--seq-parallel` (the
  ring).  The same uploads, sent one at a time, get the same ids from each;
  the mesh servers' `/healthz` names their mesh; SIGINT to rank 0 sends the
  stop op and every rank exits 0.
* `--max-batch` must be a multiple of the mesh's data axis, and batch
  buckets round up to it, as the JAX engine's `batch_multiple`."""
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import serve as jax_serve
from fddm_asr_tpu_torch import serve as S
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.data import audio_io as TA
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from test_torch_pipeline import CFG, _write_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
SERVE_CFG = {**CFG, "data": {**CFG["data"], "max_len": 8},
             "inference": {"T_infer": 4, "r": 2}}
MESHES = {"one": (1, []), "tp": (4, ["--mesh", "data=2,model=2"]),
          "ring": (2, ["--mesh", "model=2", "--seq-parallel"])}


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(d, name: str, world: int, flags: list) -> list:
    """The `world` ranks of one server (rank 0 serves HTTP on a free port)."""
    coordinator = f"127.0.0.1:{_port()}"
    argv = [sys.executable, "-m", "fddm_asr_tpu_torch.serve", "--config",
            str(d / "config.yaml"), "--ckpt", str(d / "decoder.pt"), "--tokenizer",
            str(d / "spm.vocab"), "--device", "cpu", "--port", "0", "--max-batch", "4",
            "--max-wait-ms", "20", *flags]
    procs = []
    for rank in range(world):
        env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": REPO}
        if world > 1:
            env.update(FDDM_COORDINATOR=coordinator, FDDM_NUM_PROCESSES=str(world),
                       FDDM_PROCESS_ID=str(rank))
        with open(d / f"{name}.rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(argv, env=env, cwd=REPO, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


def _url(d, name: str, procs: list, limit_s: float = 120.0) -> str:
    t0 = time.time()
    while time.time() - t0 < limit_s:
        for line in (d / f"{name}.rank0.log").read_text().splitlines():
            if line.startswith("{") and '"serving"' in line:
                return json.loads(line)["serving"]
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.2)
    raise RuntimeError(f"{name} did not start:\n" + "\n".join(
        (d / f"{name}.rank{r}.log").read_text()[-3000:] for r in range(len(procs))))


def _post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url + "/v1/transcribe", data=body,
                                 headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every server's answers to the same uploads, its /healthz and its
    ranks' exit codes after SIGINT to rank 0."""
    d = tmp_path_factory.mktemp("serve_mesh")
    _write_vocab(d / "spm.vocab")
    (d / "config.yaml").write_text(json.dumps(SERVE_CFG))  # JSON is YAML
    pipe = FDDMPipeline.from_config(Config(SERVE_CFG), tokenizer=object(), device="cpu", seed=3)
    torch.save(pipe.decoder.state_dict(), str(d / "decoder.pt"))
    rng = np.random.default_rng(0)
    bodies = []
    for i, seconds in enumerate((0.5, 1.3, 0.2, 2.0, 0.8)):
        path = d / f"clip{i}.wav"
        TA.save_wav(str(path), 0.3 * rng.standard_normal(int(SR * seconds)).astype(np.float32),
                    SR)
        bodies.append(path.read_bytes())
    procs = {name: _start(d, name, world, flags) for name, (world, flags) in MESHES.items()}
    out = {}
    try:
        for name, ranks in procs.items():
            url = _url(d, name, ranks)
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            results = [_post(url, body) for body in bodies]
            ranks[0].send_signal(signal.SIGINT)
            codes = [p.wait(timeout=120) for p in ranks]
            out[name] = {"health": health, "results": results, "codes": codes}
    finally:
        for ranks in procs.values():
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out["logs"] = {name: [(d / f"{name}.rank{r}.log").read_text()[-3000:]
                          for r in range(len(ranks))] for name, ranks in procs.items()}
    return out


@pytest.mark.parametrize("name", ["tp", "ring"])
def test_served_ids_equal_one_process(served, name):
    want = served["one"]["results"]
    got = served[name]["results"]
    assert all("ids" in r for r in want), want
    assert len({tuple(r["ids"]) for r in want}) > 1  # the uploads decode to different ids
    assert [r["ids"] for r in got] == [r["ids"] for r in want]
    assert [r["text"] for r in got] == [r["text"] for r in want]


@pytest.mark.parametrize("name,mesh", [
    ("tp", {"data": 2, "model": 2, "seq_parallel": False}),
    ("ring", {"data": 1, "model": 2, "seq_parallel": True})])
def test_mesh_servers_name_their_mesh_and_stop_cleanly(served, name, mesh):
    assert served[name]["health"]["mesh"] == mesh
    assert "mesh" not in served["one"]["health"]
    assert served[name]["codes"] == [0] * len(served[name]["codes"]), served["logs"][name]
    assert served["one"]["codes"] == [0]


def test_max_batch_must_divide_over_the_data_axis():
    class Nothing:
        device = torch.device("cpu")
        input_encoding = "f32"

    with pytest.raises(ValueError, match="multiple of the mesh"):
        S.BatchingEngine(Nothing(), {}, 8, max_batch=6, batch_multiple=4)
    ours = S.BatchingEngine(Nothing(), {}, 8, max_batch=6, batch_multiple=3)
    theirs = jax_serve.BatchingEngine(Nothing(), {}, 8, max_batch=6, batch_multiple=3)
    try:
        sizes = [ours._bucket_batch_size(n) for n in range(1, 7)]
        assert sizes == [theirs._bucket_batch_size(n) for n in range(1, 7)] == [3, 3, 6, 6, 6, 6]
    finally:
        ours.shutdown()
        theirs.shutdown()
