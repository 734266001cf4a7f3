# -*- coding: utf-8 -*-
"""The port's pipeline takes the JAX package's weights and wire dtypes:

  * the frozen encoder projection (hidden_size != d_model), which the JAX
    pipeline draws from the config's seed and no checkpoint carries, comes
    across as an `AcousticEncoder` state_dict (`encoder_state_dict`, CLI
    `--encoder-ckpt`, written by `scripts/export_torch_encoder.py`);
  * a sinusoidal-position decoder `.pt` as the JAX training loop exports it
    (with a `pos_emb.inv_freq` buffer) loads, and parameter keys stay strict;
  * int16 (pcm16) and uint8 (mu-law) waveforms are decoded, not read as codes.

Each is held against the JAX pipeline at one padded shape with an injected
x_T: token ids and texts identical, the condition c within 1e-5 (float32,
two tiny WavLM layers; the two frameworks sum in different orders)."""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu import diffusion as JD
from fddm_asr_tpu import sampler as JS
from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu.convert.torch_ckpt import save_reference_checkpoint
from fddm_asr_tpu.data.wire import encode_wire
from fddm_asr_tpu.pipeline import FDDMPipeline as JaxPipeline
from fddm_asr_tpu.pipeline import build_wavlm_config
from fddm_asr_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.convert import (acoustic_encoder_state_dict_from_jax_params,
                                        decoder_state_dict_from_jax_params,
                                        wavlm_state_dict_from_jax_params)
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from fddm_asr_tpu_torch.tokenizer import load_tokenizer

K, SEQ_LEN, B, T = 40, 12, 2, 6400
C_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(d_model, pos_emb_type="rope"):
    return {
        "seed": 0,
        "data": {"vocab_size": K, "pad_id": 3, "bos_id": 1, "eos_id": 2},
        "model": {"d_model": d_model, "nhead": 4, "num_layers": 2, "dim_ff": 64,
                  "dtype": "float32", "pos_emb_type": pos_emb_type,
                  "encoder": {"wavlm_name": "tiny", "proj": "linear"}},  # hidden 32
        "diffusion": {"T": 200, "beta_max": 0.2},
    }


CFG_PROJ = _cfg(48)                  # hidden 32 -> d_model 48: the encoder has a proj
CFG_SIN = _cfg(32, "sinusoidal")     # no proj; sinusoidal positions in the decoder


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "spm.vocab"
    lines = ["<unk>\t0", "<s>\t0", "</s>\t0", "<pad>\t0"]
    lines += [f"{chr(0x4E00 + i)}\t{-(i + 1)}" for i in range(K - 4)]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


def _jax_pipeline(cfg, vocab):
    """The JAX pipeline as `from_config` draws it (key(seed) split into the
    decoder's and the encoder's keys), with jitted inits: eager ones take
    tens of seconds even at this size."""
    jcfg = JaxConfig(cfg)
    d = cfg["model"]["d_model"]
    jp = JaxPipeline(jcfg, {}, {}, JD.make_schedule(K, 200, 0.2), jax_load_tokenizer(vocab),
                     {"pad_id": 3, "bos_id": 1, "eos_id": 2, "unk_id": None},
                     build_wavlm_config(jcfg.model.encoder))
    rng_dec, rng_enc = jax.random.split(jax.random.key(cfg["seed"]))
    jp.decoder_params = jax.jit(jp.decoder.init)(
        rng_dec, jnp.zeros((1, 8), jnp.int32), jnp.ones((1,), jnp.int32), jnp.zeros((1, 16, d)))
    jp.encoder_params = jax.jit(jp.encoder.init)(rng_enc, jnp.zeros((1, 640), jnp.float32))
    return jp


def _wave(rng):
    wav = (0.3 * rng.standard_normal((B, T))).astype(np.float32)
    wav[1, T // 2:] = 0.0  # a shorter utterance, zero-padded as in a batch
    return np.clip(wav, -1.0, 1.0)


def _jax_ids(jp, c, c_mask, x_init):
    scfg = JS.SamplerConfig(K=K, T_train=200, T_infer=20, r=5, greedy=True,
                            posterior_mode="map")

    def decoder_apply(params, xt, t, cond, cm):
        return jp.decoder.apply(params, xt, t, cond, None, cm, deterministic=True)

    ids, _ = JS.make_sample_fn(decoder_apply, jp.sched, scfg)(
        jp.decoder_params, jax.random.key(0), c, SEQ_LEN, c_mask, jnp.asarray(x_init))
    return np.asarray(ids)


def _assert_same_transcripts(jp, tp, wav, rng):
    """c within C_TOL and identical ids and texts from the same x_T."""
    x_init = rng.integers(0, K, (B, SEQ_LEN))
    c, c_mask = jp.encode_waveform(wav)
    tc, _ = tp.encode_waveform(wav)
    assert tuple(tc.shape) == np.asarray(c).shape
    assert np.abs(tc.numpy() - np.asarray(c)).max() <= C_TOL
    j_ids = _jax_ids(jp, c, c_mask, x_init)
    rows = tp.transcribe_with_ids(wav, seq_len=SEQ_LEN, x_init=x_init, T_infer=20, r=5,
                                  greedy=True)
    np.testing.assert_array_equal(np.asarray([r[1] for r in rows]), j_ids)
    texts = [jp.ids_to_text(row) for row in j_ids]
    assert [r[0] for r in rows] == texts
    assert any(texts)  # something was decoded, so the texts compare real work


# ------------------------------------------------ the frozen encoder projection
@pytest.fixture(scope="module")
def proj_side(tmp_path_factory, vocab):
    tmp = tmp_path_factory.mktemp("proj")
    jp = _jax_pipeline(CFG_PROJ, vocab)
    assert "proj" in jp.encoder_params["params"]
    ckpt = str(tmp / "dec.pt")
    save_reference_checkpoint(ckpt, jp.decoder_params["params"])
    enc_sd = acoustic_encoder_state_dict_from_jax_params(
        jax.tree.map(np.asarray, jp.encoder_params))
    return jp, ckpt, enc_sd, tmp


def test_jax_encoder_projection_gives_the_jax_transcripts(proj_side, vocab, rng, capsys):
    jp, ckpt, enc_sd, _ = proj_side
    tp = FDDMPipeline.from_config(Config(CFG_PROJ), ckpt_path=ckpt,
                                  tokenizer=load_tokenizer(vocab), encoder_state_dict=enc_sd,
                                  device="cpu")
    assert "random" not in capsys.readouterr().err
    _assert_same_transcripts(jp, tp, _wave(rng), rng)

    # without it the projection is the port's own draw, and the load says so on stderr
    own = FDDMPipeline.from_config(Config(CFG_PROJ), ckpt_path=ckpt,
                                   tokenizer=load_tokenizer(vocab), device="cpu")
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "projection is random" in err
    assert not torch.equal(own.encoder.proj.weight, tp.encoder.proj.weight)


def test_encoder_ckpt_round_trip_through_the_cli(proj_side, vocab):
    from fddm_asr_tpu_torch import inference

    _, ckpt, enc_sd, tmp = proj_side
    path = str(tmp / "encoder.pt")
    torch.save(enc_sd, path)
    cfg_path = tmp / "main.yaml"
    cfg_path.write_text(json.dumps(CFG_PROJ))  # JSON is YAML
    diff_path = tmp / "diffusion.yaml"
    diff_path.write_text(json.dumps({"diffusion": {"T": 200, "beta_max": 0.2}}))
    args = inference.parse_args(["--wav", "unused.wav", "--ckpt", ckpt, "--main-config",
                                 str(cfg_path), "--diffusion-config", str(diff_path),
                                 "--tokenizer", vocab, "--device", "cpu",
                                 "--encoder-ckpt", path])
    got = inference.build_pipeline(args).encoder.state_dict()
    assert set(got) == set(enc_sd)
    assert all(torch.equal(got[k], enc_sd[k]) for k in enc_sd)


def test_export_script_writes_the_jax_pipelines_encoder(proj_side):
    """The script builds the JAX pipeline with `from_config` itself (eager
    inits); its encoder is the one drawn from the config's seed, equal to
    the jitted draw within float32 rounding of the init's transforms."""
    _, _, enc_sd, tmp = proj_side
    spec = importlib.util.spec_from_file_location(
        "export_torch_encoder", os.path.join(REPO, "scripts", "export_torch_encoder.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    cfg_path = tmp / "export.yaml"
    cfg_path.write_text(json.dumps(CFG_PROJ))
    out = str(tmp / "exported" / "encoder.pt")
    script.main(["--main-config", str(cfg_path), "--out", out])
    got = torch.load(out, map_location="cpu", weights_only=True)
    assert set(got) == set(enc_sd) and "proj.weight" in got
    for key, want in enc_sd.items():
        torch.testing.assert_close(got[key], want, rtol=1e-6, atol=1e-7, msg=key)


# ---------------------------------------- sinusoidal decoder .pt, wire dtypes
@pytest.fixture(scope="module")
def sin_side(tmp_path_factory, vocab):
    tmp = tmp_path_factory.mktemp("sin")
    jp = _jax_pipeline(CFG_SIN, vocab)
    ckpt = str(tmp / "dec.pt")
    # as the JAX training loop exports it: without pos_emb_type, so with the buffer
    save_reference_checkpoint(ckpt, jp.decoder_params["params"])
    backbone = wavlm_state_dict_from_jax_params(
        jax.tree.map(np.asarray, jp.encoder_params["params"]["backbone"]))
    return jp, ckpt, backbone, tmp


def test_sinusoidal_decoder_pt_from_jax_loads(sin_side, vocab, rng):
    jp, ckpt, backbone, tmp = sin_side
    raw = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert "pos_emb.inv_freq" in raw["decoder"]
    tp = FDDMPipeline.from_config(Config(CFG_SIN), ckpt_path=ckpt,
                                  tokenizer=load_tokenizer(vocab), wavlm_state_dict=backbone,
                                  device="cpu")
    assert tp.decoder.pos_emb_type == "sinusoidal"
    _assert_same_transcripts(jp, tp, _wave(rng), rng)

    # an unexpected parameter key still refuses the file
    raw["decoder"]["blocks.0.extra.weight"] = torch.zeros(4)
    bad = str(tmp / "bad.pt")
    torch.save(raw, bad)
    with pytest.raises(RuntimeError, match="blocks.0.extra.weight"):
        FDDMPipeline.from_config(Config(CFG_SIN), ckpt_path=bad,
                                 tokenizer=load_tokenizer(vocab), device="cpu")


@pytest.mark.parametrize("encoding", ["pcm16", "mulaw8"])
def test_wire_dtypes_are_decoded_as_the_jax_pipeline_does(sin_side, vocab, rng, encoding):
    jp, _, backbone, _ = sin_side
    tp = FDDMPipeline.from_config(Config(CFG_SIN), tokenizer=load_tokenizer(vocab),
                                  wavlm_state_dict=backbone, device="cpu")
    tp.decoder.load_state_dict(decoder_state_dict_from_jax_params(
        jax.tree.map(np.asarray, jp.decoder_params), pos_emb_type="sinusoidal"), strict=True)
    codes = encode_wire(_wave(rng), encoding)
    assert codes.dtype == (np.int16 if encoding == "pcm16" else np.uint8)
    _assert_same_transcripts(jp, tp, codes, rng)
