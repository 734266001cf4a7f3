# -*- coding: utf-8 -*-
"""The training loop (`train_lib.run_training`) on the card, at a small
config whose WavLM heads are 64 wide, so attention takes the kernels.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_train_cuda.py

* A fine-tune run: every step launches B3 2n - 1 times (n layers, all but
  the first recomputed in the backward), B4 and B5 n times each, and B1
  never; the loss is finite and the checkpoints are written.
* A frozen run on the feature cache: the cache build runs B1 n times a
  batch, the validation CER's encode n times a batch, and the steps no kernel.
* `make_batches(pin_memory=True)` gives the same batches with the waves in
  page-locked memory.
"""
import json
import os

import numpy as np
import pytest
import torch

from fddm_asr_tpu_torch import train_lib as TL
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.data.audio_io import save_wav
from fddm_asr_tpu_torch.data.dataset import ManifestDataset, make_batches
from fddm_asr_tpu_torch.ops import kernel_wrappers
from fddm_asr_tpu_torch.tokenizer import load_tokenizer

LAYERS = 2
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.fixture
def corpus(tmp_path):
    """A 64-piece tokenizer, 8 train and 4 validation clips of 0.3-0.6 s."""
    vocab = tmp_path / "spm.vocab"
    lines = ["<unk>\t0", "<s>\t0", "</s>\t0", "<pad>\t0"]
    vocab.write_text("\n".join(lines + [f"{chr(0x4E00 + i)}\t{-(i + 1)}" for i in range(60)])
                     + "\n", encoding="utf-8")
    rng = np.random.default_rng(0)
    manifests = {}
    for split, n in (("train", 8), ("validation", 4)):
        records = []
        for i in range(n):
            path = str(tmp_path / f"{split}{i}.wav")
            wav = 0.3 * rng.standard_normal(int(16000 * rng.uniform(0.3, 0.6)))
            save_wav(path, wav.astype(np.float32), 16000)
            text = "".join(chr(0x4E00 + int(j)) for j in rng.integers(0, 60, 8))
            records.append({"processed_path": path, "text": text})
        manifests[split] = str(tmp_path / f"{split}.json")
        with open(manifests[split], "w", encoding="utf-8") as f:
            json.dump(records, f, ensure_ascii=False)
    return tmp_path, manifests, str(vocab)


def _config(corpus, freeze: bool, validation: bool = True, **extra):
    root, manifests, vocab = corpus
    return Config({
        "seed": 0,
        "data": {"max_seconds": 0.6, "pad_id": 3, "max_len": 16, "vocab_size": 64,
                 "train_json": manifests["train"],
                 "val_json": manifests["validation"] if validation else "/nonexistent",
                 "test_json": "/nonexistent", "tokenizer_path": vocab, **extra},
        "model": {"d_model": 96, "nhead": 4, "num_layers": 1, "dim_ff": 192, "dropout": 0.0,
                  "dtype": "bfloat16", "projector": {"d_proj": 32},
                  "encoder": {"wavlm_name": "tiny", "freeze": freeze, "mask_time_prob": 0.2,
                              "mask_time_length": 3,
                              "wavlm_config": {"hidden_size": 128, "num_attention_heads": 2,
                                               "intermediate_size": 256,
                                               "num_hidden_layers": LAYERS,
                                               "attention_dropout": 0.0}}},
        "diffusion": {"T": 200, "beta_max": 0.2},
        "inference": {"T_infer": 4, "r": 2},
        "optim": {"batch_size": 4, "lr": 1e-3, "encoder_lr": 1e-4, "num_epochs": 1,
                  "dtype": "bfloat16", "ema_decay": 0.999},
        "lfd": {"n_step_fd": 2},
        "log": {"log_every": 1, "ckpt_dir": str(root / f"ckpt_{freeze}"), "metrics_jsonl": True,
                "val_loss": False},
    })


def _counts():
    return {k: w.launches for k, w in kernel_wrappers().items()}


def _reset():
    for w in kernel_wrappers().values():
        w.launches = 0


def test_finetune_loop_launches_the_training_kernels(cuda_device, corpus):
    cfg = _config(corpus, freeze=False, validation=False)  # no eval: the counts are the steps'
    _reset()
    summary = TL.run_training(cfg, device="cuda")
    torch.cuda.synchronize()
    steps = 2
    counts = _counts()
    assert counts["fwd_lse"] == steps * (2 * LAYERS - 1)
    assert counts["bwd_dq"] == counts["bwd_dkv"] == steps * LAYERS
    assert counts["fwd"] == 0
    assert np.isfinite(summary["train_loss"])
    names = os.listdir(cfg.log.ckpt_dir)
    assert {"ep001.pt", "ep001.state.pt", "ep001.encoder.pt", "ep001.meta.json"} <= set(names)


def test_frozen_loop_on_the_feature_cache(cuda_device, corpus):
    cfg = _config(corpus, freeze=True, cache_features=str(corpus[0] / "feats"))
    _reset()
    summary = TL.run_training(cfg, device="cuda")
    torch.cuda.synchronize()
    counts = _counts()
    # the cache build (2 batches of 4) and the validation CER (1 batch)
    assert counts["fwd"] == (2 + 1) * LAYERS
    assert counts["fwd_lse"] == counts["bwd_dq"] == counts["bwd_dkv"] == 0
    assert summary["val_cer"] is not None and np.isfinite(summary["train_loss"])
    with open(os.path.join(cfg.log.ckpt_dir, "metrics.jsonl"), encoding="utf-8") as f:
        cache = json.loads(f.readline())
    assert cache["kind"] == "feature_cache" and cache["device_resident"]


def test_pinned_batches_equal_the_plain_ones(cuda_device, corpus):
    _, manifests, vocab = corpus
    ds = ManifestDataset(manifests["train"], load_tokenizer(vocab), max_len=16, pad_id=3,
                         max_audio_seconds=0.6)
    plain = list(make_batches(ds, 4, shuffle=True, seed=1, epoch=1))
    pinned = list(make_batches(ds, 4, shuffle=True, seed=1, epoch=1, pin_memory=True))
    assert len(plain) == len(pinned) == 2
    for a, b in zip(plain, pinned):
        assert isinstance(b.wave, torch.Tensor) and b.wave.is_pinned()
        np.testing.assert_array_equal(b.wave.numpy(), a.wave)
        np.testing.assert_array_equal(b.tokens, a.tokens)
        on_card = b.wave.to(cuda_device, non_blocking=True)
        torch.cuda.synchronize()
        assert torch.equal(on_card.cpu(), b.wave)
