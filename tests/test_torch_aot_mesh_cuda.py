# -*- coding: utf-8 -*-
"""A sharded AOT artifact on the card.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_aot_mesh_cuda.py

Two ranks share the card over gloo (`tests/torch_parallel_worker.py`, case
`aot_cuda`): a small float32 pipeline whose WavLM heads are 64 wide (two
heads, one a rank at model=2, so attention takes B1) is exported at model=2
(`aot.save_artifact`), loaded in the same ranks, which run its programs
eagerly ("gloo: no graph capture"), and transcribes a batch at a seed.  Each
rank's ids equal one process's artifact's on the card at that seed (its
bucket a CUDA graph), and B1 launches once a WavLM layer and call inside the
sharded program (the wrapper's count).
"""
import json
import os

import numpy as np
import pytest
import torch

from fddm_asr_tpu_torch import aot
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from torch_parallel_worker import collect, launch  # tests/ is on the path

pytestmark = pytest.mark.cuda
K, SEQ_LEN, SEED = 64, 16, 11
BUCKETS = [[2, 16000]]
CFG = {
    "seed": 0,
    "data": {"vocab_size": K, "pad_id": 3, "bos_id": 1, "eos_id": 2},
    "model": {"d_model": 96, "nhead": 4, "num_layers": 2, "dim_ff": 192, "dtype": "float32",
              "encoder": {"wavlm_name": "tiny", "proj": "linear", "wavlm_config": {
                  "hidden_size": 128, "num_attention_heads": 2, "intermediate_size": 256}}},
    "diffusion": {"T": 200, "beta_max": 0.2},
}
SAMPLING = {"T_infer": 20, "r": 5, "greedy": True}
LAYERS = 2  # the tiny WavLM's


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _vocab(path) -> str:
    lines = ["<unk>\t0", "<s>\t0", "</s>\t0", "<pad>\t0"]
    lines += [f"{chr(0x4E00 + i)}\t{-(i + 1)}" for i in range(K - 4)]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


def test_a_model2_artifact_on_the_card_equals_one_process(cuda_device, tmp_path):
    wave = str(tmp_path / "wave.npy")
    np.save(wave, (0.3 * np.random.default_rng(1).standard_normal((2, 16000))).astype(
        np.float32))
    vocab = _vocab(tmp_path / "spm.vocab")
    with open(tmp_path / "aot_cuda.json", "w") as f:
        json.dump({"cfg": CFG, "buckets": BUCKETS, "seq_len": SEQ_LEN, "sampling": SAMPLING,
                   "tokenizer": vocab, "wave": wave, "seed": SEED}, f)
    procs = launch("aot_cuda", str(tmp_path), 2, {"FDDM_BACKEND": "gloo",
                                                  "FDDM_DEVICE": "cuda:0"})

    class Chars:
        def DecodeIds(self, ids):
            return "".join(chr(97 + (i % 26)) for i in ids)

    pipe = FDDMPipeline.from_config(Config(CFG), tokenizer=Chars(), device=cuda_device)
    art = str(tmp_path / "art_one")
    aot.save_artifact(pipe, art, [tuple(b) for b in BUCKETS], SEQ_LEN, SAMPLING, vocab)
    one = aot.ExportedPipeline.load(art, device="cuda")
    assert one.execution == "cuda graphs" and len(one.native) == len(BUCKETS)
    want = [ids for _, ids in one.transcribe_with_ids(np.load(wave), seed=SEED)]
    ranks = collect(procs, "aot_cuda", str(tmp_path))
    assert len({tuple(ids) for ids in want}) == 2  # the rows decode differently
    meta = aot.read_meta(str(tmp_path / "art_cuda"))
    assert meta["mesh"] == {"axis_names": ["data", "model"], "shape": [1, 2]}
    assert meta["platforms"] == ["cuda"]
    for rank in ranks:
        assert rank["ids"] == want
        assert rank["execution"] == "eager" and rank["eager_reason"] == "gloo: no graph capture"
        assert rank["b1_launches"] == LAYERS
