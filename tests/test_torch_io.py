# -*- coding: utf-8 -*-
"""The port's numpy-side modules against the JAX package's: tokenizer
decoding (`.model` and `.vocab`), WAV reading and resampling, config loading
with `base_config` and the special-id sidecar, transcript filtering and
confidence.  Same inputs on both sides; results must be equal (confidence
to float32 rounding)."""
import json
import struct
import wave

import numpy as np
import pytest
import torch

from fddm_asr_tpu import config as JC
from fddm_asr_tpu import eval as JE
from fddm_asr_tpu.data import audio_io as JA
from fddm_asr_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from fddm_asr_tpu.tokenizer import model_proto as JMP
from fddm_asr_tpu_torch import config as TC
from fddm_asr_tpu_torch import eval as TE
from fddm_asr_tpu_torch.data import audio_io as TA
from fddm_asr_tpu_torch.tokenizer import load_tokenizer

PIECES = ["<unk>", "<s>", "</s>", "<pad>", "▁", "▁今天", "天氣", "很", "好", "▁ok", "ay"]
TYPES = [JMP.UNKNOWN, JMP.CONTROL, JMP.CONTROL, JMP.CONTROL] + [JMP.NORMAL] * 7
ID_ROWS = [[5, 6, 7, 8], [9, 10, 4, 5], [1, 5, 0, 8, 2, 7], [3, 3], [], [4, 4, 6], [5, 99, 6]]


@pytest.fixture(scope="module")
def tokenizer_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tok")
    model = JMP.SPModel(pieces=[JMP.Piece(p, -float(i), t)
                                for i, (p, t) in enumerate(zip(PIECES, TYPES))])
    model_path = str(tmp / "spm.model")
    JMP.save_model(model, model_path)
    vocab_path = tmp / "spm.vocab"
    vocab_path.write_text("".join(f"{p}\t{-i}\n" for i, p in enumerate(PIECES)),
                          encoding="utf-8")
    return model_path, str(vocab_path)


@pytest.mark.parametrize("kind", ["model", "vocab"])
def test_tokenizer_decodes_like_the_jax_package(tokenizer_files, kind):
    path = tokenizer_files[0 if kind == "model" else 1]
    ours, theirs = load_tokenizer(path), jax_load_tokenizer(path)
    assert ours.vocab_size() == theirs.vocab_size() == len(PIECES)
    for row in ID_ROWS:
        assert ours.DecodeIds(row) == theirs.DecodeIds(row), row
    assert ours.decode(ID_ROWS) == theirs.decode(ID_ROWS)
    assert [ours.id_to_piece(i) for i in range(len(PIECES))] == PIECES


def test_ids_to_text_and_confidence_match(tokenizer_files, rng):
    tok = load_tokenizer(tokenizer_files[0])
    special = {"pad_id": 3, "bos_id": 1, "eos_id": 2, "unk_id": 0}
    ids = np.array([[1, 5, 6, 2, 7, 3], [3, 3, 3, 3, 3, 3], [5, 3, 6, 7, 8, 9]])
    p = rng.dirichlet(np.ones(len(PIECES)), size=ids.shape).astype(np.float32)
    for row in ids:
        assert TE.ids_to_text(row, tok, 3, 1, 2) == JE.ids_to_text(row, tok, 3, 1, 2)
    conf = TE.batch_confidence(torch.from_numpy(ids), torch.from_numpy(p), 3, special).numpy()
    expect = [JE.utterance_confidence(ids[i], p[i], 3, special) for i in range(len(ids))]
    np.testing.assert_allclose(conf, expect, rtol=1e-5)
    assert conf[1] == 0.0  # nothing decoded


def _write_float_wav(path, samples, sr, extensible):
    """IEEE-float WAV, optionally wrapped in WAVE_FORMAT_EXTENSIBLE."""
    data = samples.astype("<f4").tobytes()
    if extensible:
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, 1, sr, sr * 4, 4, 32, 22, 32, 0)
        fmt += struct.pack("<H", 3) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    else:
        fmt = struct.pack("<HHIIHH", 3, 1, sr, sr * 4, 4, 32)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(data)) + data
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("kind", ["pcm16", "pcm24_stereo", "float", "float_extensible"])
def test_wav_reading_matches(tmp_path, rng, kind):
    sr = 8000
    x = np.clip(0.3 * rng.standard_normal(1234), -1, 1).astype(np.float32)
    path = tmp_path / f"{kind}.wav"
    if kind == "pcm16":
        JA.save_wav(str(path), x, sr)
    elif kind == "pcm24_stereo":
        ints = np.round(np.stack([x, -x], 1) * 8388607).astype(np.int32).reshape(-1)
        raw = b"".join(struct.pack("<i", int(v))[:3] for v in ints)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(3)
            w.setframerate(sr)
            w.writeframes(raw)
    else:
        _write_float_wav(path, x, sr, extensible=kind == "float_extensible")
    ours, theirs = TA.load_wav(str(path)), JA.load_wav(str(path))
    assert ours[1] == theirs[1] == sr
    np.testing.assert_array_equal(ours[0], theirs[0])
    a, b = TA.load_audio(str(path), 16000), JA.load_audio(str(path), 16000)
    assert a[1] == b[1] == 16000
    np.testing.assert_array_equal(a[0], b[0])


def test_resample_matches(rng):
    x = rng.standard_normal(4410).astype(np.float32)
    for orig, target in ((44100, 16000), (8000, 16000), (16000, 16000)):
        np.testing.assert_array_equal(TA.resample(x, orig, target), JA.resample(x, orig, target))


def test_non_wav_input_raises(tmp_path, monkeypatch):
    """A format no decoder of the port reads (MP3 has its own): without
    ffmpeg, load_audio refuses it as the JAX package does."""
    path = tmp_path / "a.txt"
    path.write_bytes(b"\xff\xfb")
    monkeypatch.setattr(TA.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="WAV"):
        TA.load_audio(str(path))


def test_corrupt_mp3_raises(tmp_path):
    """An .mp3 with no MPEG frame: libmpg123 finds nothing to decode (without
    the library, the refusal names both decoders)."""
    from fddm_asr_tpu_torch.data.mp3 import mpg123_available

    path = tmp_path / "a.mp3"
    path.write_bytes(b"\x00" * 4096)
    if mpg123_available():
        with pytest.raises(ValueError, match="no decodable MPEG audio frames"):
            TA.load_audio(str(path))
    else:
        with pytest.raises(RuntimeError, match="libmpg123"):
            TA.load_audio(str(path))


def test_load_config_with_base_and_special_ids(tmp_path):
    (tmp_path / "tok").mkdir()
    (tmp_path / "tok" / "vocab.json").write_text(json.dumps(
        {"special_token_ids": {"pad_id": 3, "unk": 0, "bos_id": 1, "eos_id": 2}}))
    (tmp_path / "base.yaml").write_text(
        "seed: 7\ndata:\n  vocab_size: 8000\n  pad_id: 0\n"
        f"  tokenizer_path: {tmp_path / 'tok' / 'spm.model'}\n"
        "model:\n  d_model: 768\n  encoder:\n    proj: linear\n    freeze: true\n")
    (tmp_path / "child.yaml").write_text(
        "base_config: base.yaml\nmodel:\n  num_layers: 6\n  encoder:\n    freeze: false\n")
    ours = TC.load_config(str(tmp_path / "child.yaml"), {"diffusion": {"T": 200}})
    theirs = JC.load_config(str(tmp_path / "child.yaml"), {"diffusion": {"T": 200}})
    assert ours.to_dict() == theirs.to_dict()
    assert ours.model.encoder.proj == "linear" and ours.model.encoder.freeze is False
    assert TC.resolve_special_ids(ours) == JC.resolve_special_ids(theirs) == {
        "pad_id": 3, "bos_id": 1, "eos_id": 2, "unk_id": 0}


def test_shipped_flagship_config_loads_alike():
    ours = TC.load_config("configs/fddm_zhTW_base.yaml")
    theirs = JC.load_config("configs/fddm_zhTW_base.yaml")
    assert ours.to_dict() == theirs.to_dict()
    assert ours.model.dtype == "bfloat16" and ours.model.d_model == 768


def test_resolve_device_raises_without_cuda():
    assert TC.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TC.resolve_device(device)
