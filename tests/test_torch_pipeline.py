# -*- coding: utf-8 -*-
"""The port's pipeline against the JAX package's: a tiny model with the same
weights and the same x_T must give identical token ids and texts.

The JAX side draws its random weights; the decoder crosses over through
a reference `.pt` (the port's checkpoint loader) and the WavLM backbone
through the port's converter.  Both transcribe the same padded batch."""
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu import diffusion as JD
from fddm_asr_tpu import sampler as JS
from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu.convert.torch_ckpt import save_reference_checkpoint
from fddm_asr_tpu.eval import utterance_confidence
from fddm_asr_tpu.pipeline import FDDMPipeline as JaxPipeline
from fddm_asr_tpu.pipeline import build_wavlm_config
from fddm_asr_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.convert import wavlm_state_dict_from_jax_params
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from fddm_asr_tpu_torch.tokenizer import load_tokenizer

K, SEQ_LEN, B, T = 40, 12, 2, 6400

CFG = {
    "seed": 0,
    "data": {"vocab_size": K, "pad_id": 3, "bos_id": 1, "eos_id": 2},
    "model": {"d_model": 32, "nhead": 4, "num_layers": 2, "dim_ff": 64,
              "dtype": "float32", "encoder": {"wavlm_name": "tiny", "proj": "linear"}},
    "diffusion": {"T": 200, "beta_max": 0.2},
}


def _write_vocab(path):
    """4 specials + single-ideograph pieces: a K-piece tokenizer both load."""
    lines = ["<unk>\t0", "<s>\t0", "</s>\t0", "<pad>\t0"]
    lines += [f"{chr(0x4E00 + i)}\t{-(i + 1)}" for i in range(K - 4)]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    vocab = _write_vocab(tmp / "spm.vocab")
    jcfg = JaxConfig(CFG)
    # JaxPipeline.from_config initialises eagerly; jitted inits are much faster
    jp = JaxPipeline(jcfg, {}, {}, JD.make_schedule(K, 200, 0.2), jax_load_tokenizer(vocab),
                     {"pad_id": 3, "bos_id": 1, "eos_id": 2, "unk_id": None},
                     build_wavlm_config(jcfg.model.encoder))
    jp.decoder_params = jax.jit(jp.decoder.init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1,), jnp.int32),
        jnp.zeros((1, 16, 32)))
    jp.encoder_params = jax.jit(jp.encoder.init)(jax.random.key(1), jnp.zeros((1, 640)))
    ckpt = str(tmp / "dec.pt")
    save_reference_checkpoint(ckpt, jp.decoder_params["params"])
    backbone = jax.tree.map(np.asarray, jp.encoder_params["params"]["backbone"])
    tp = FDDMPipeline.from_config(Config(CFG), ckpt_path=ckpt, tokenizer=load_tokenizer(vocab),
                                  wavlm_state_dict=wavlm_state_dict_from_jax_params(backbone),
                                  device="cpu")
    return jp, tp, tmp, ckpt, vocab


def _wave(rng):
    wav = (0.3 * rng.standard_normal((B, T))).astype(np.float32)
    wav[1, T // 2:] = 0.0  # a shorter utterance, zero-padded as in a batch
    return wav


def test_same_weights_same_x_init_identical_transcripts(pipelines, rng):
    jp, tp, *_ = pipelines
    wav = _wave(rng)
    x_init = rng.integers(0, K, (B, SEQ_LEN))

    c, c_mask = jp.encode_waveform(wav)
    scfg = JS.SamplerConfig(K=K, T_train=200, T_infer=20, r=5, greedy=True,
                            posterior_mode="map")

    def decoder_apply(params, xt, t, cond, cm):
        return jp.decoder.apply(params, xt, t, cond, None, cm, deterministic=True)

    j_ids, j_p = JS.make_sample_fn(decoder_apply, jp.sched, scfg)(
        jp.decoder_params, jax.random.key(0), c, SEQ_LEN, c_mask, jnp.asarray(x_init))
    j_ids, j_p = np.asarray(j_ids), np.asarray(j_p)
    j_texts = [jp.ids_to_text(row) for row in j_ids]

    tc, _ = tp.encode_waveform(wav)
    np.testing.assert_allclose(tc.numpy(), np.asarray(c), atol=1e-4, rtol=0)
    rows = tp.transcribe_with_ids(wav, seq_len=SEQ_LEN, x_init=x_init, with_confidence=True,
                                  T_infer=20, r=5, greedy=True)
    np.testing.assert_array_equal(np.asarray([r[1] for r in rows]), j_ids)
    assert [r[0] for r in rows] == j_texts
    assert tp.transcribe(wav, seq_len=SEQ_LEN, x_init=x_init) == j_texts
    assert any(j_texts)  # something was decoded, so the texts compare real work
    for (_, ids, conf), p_row in zip(rows, j_p):
        assert conf == pytest.approx(
            utterance_confidence(np.asarray(ids), p_row, 3, jp.special_ids), rel=1e-4)


def test_from_config_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FDDMPipeline.from_config(Config(CFG), tokenizer=object())


def test_inference_cli_on_cpu(pipelines, rng, tmp_path, capsys):
    from fddm_asr_tpu_torch import inference

    *_, ckpt, vocab = pipelines
    pcm = (np.clip(_wave(rng)[0], -1, 1) * 32767).astype("<i2")
    wav_path = tmp_path / "a.wav"
    with wave.open(str(wav_path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    main_cfg = tmp_path / "main.yaml"
    main_cfg.write_text(json.dumps(CFG))  # JSON is YAML
    diff_cfg = tmp_path / "diffusion.yaml"
    diff_cfg.write_text(json.dumps({"diffusion": {"T": 200, "beta_max": 0.2}}))
    out_json = tmp_path / "out.json"
    inference.main(["--wav", str(wav_path), "--ckpt", ckpt, "--main-config", str(main_cfg),
                    "--diffusion-config", str(diff_cfg), "--tokenizer", vocab,
                    "--greedy", "--seq-len", str(SEQ_LEN), "--device", "cpu",
                    "--confidence", "--out-json", str(out_json)])
    (res,) = json.loads(out_json.read_text())
    assert set(res) == {"wav", "text", "ids", "T_infer", "r", "greedy", "posterior_mode",
                        "confidence"}
    assert len(res["ids"]) == SEQ_LEN and res["T_infer"] == 20 and res["greedy"] is True
    # the CLI's encoder is the random one drawn from the config's seed
    tp = FDDMPipeline.from_config(Config(CFG), ckpt_path=ckpt, tokenizer=load_tokenizer(vocab),
                                  device="cpu")
    gen = torch.Generator().manual_seed(0)
    expect = tp.transcribe_with_ids(pcm[None].astype(np.float32) / 32768.0, seq_len=SEQ_LEN,
                                    generator=gen, T_infer=20, r=5, greedy=True)
    assert res["ids"] == expect[0][1] and res["text"] == expect[0][0]


QUANT_CFG = {
    **CFG,
    "model": {**CFG["model"], "quant_dense": "int8",
              "encoder": {**CFG["model"]["encoder"], "wavlm_config": {
                  "quant_dense": "int8_fused", "fused_frontend": True,
                  "gelu_approx_tanh": True}}},
}


def test_quantized_fused_configuration_matches_jax(pipelines, rng):
    """The slice as a whole: int8 encoder denses (fused kernel's path), the
    fused conv front-end with tanh GELU and the int8 decoder, at the
    full-precision pipelines' weights (the flags change no parameter), give
    the JAX pipeline's token ids and texts under the same flags.  The JAX
    pipeline runs jitted, where XLA rewrites f32 steps before a rounding,
    so a value within that of a tie may round to the other integer: the
    encoder outputs are held at rel-L2 2e-3, a tenth of the distance to
    the full-precision encoder, which is asserted too."""
    jp, tp, _, ckpt, vocab = pipelines
    jcfg = JaxConfig(QUANT_CFG)
    jq = JaxPipeline(jcfg, jp.decoder_params, jp.encoder_params, jp.sched, jp.tokenizer,
                     jp.special_ids, build_wavlm_config(jcfg.model.encoder))
    assert jq.wavlm_config.quant_dense == "int8_fused" and jq.wavlm_config.fused_frontend
    tq = FDDMPipeline.from_config(Config(QUANT_CFG), ckpt_path=ckpt,
                                  tokenizer=load_tokenizer(vocab), device="cpu")
    tq.encoder.load_state_dict(tp.encoder.state_dict(), strict=True)
    # the repaired fault: model.quant_dense reaches the decoder; the encoder's flags its config
    assert tq.decoder.quant_dense == "int8" and tp.decoder.quant_dense == "none"
    assert tq.encoder.config.quant_dense == "int8_fused" and tq.encoder.config.fused_frontend

    wav = _wave(rng)
    x_init = rng.integers(0, K, (B, SEQ_LEN))
    c, c_mask = jq.encode_waveform(wav)
    tc, _ = tq.encode_waveform(wav)
    full, _ = tp.encode_waveform(wav)

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel_l2(tc.numpy(), np.asarray(c)) < 2e-3
    assert 2e-3 < rel_l2(tc.numpy(), full.numpy()) < 0.05

    scfg = JS.SamplerConfig(K=K, T_train=200, T_infer=20, r=5, greedy=True,
                            posterior_mode="map")

    def decoder_apply(params, xt, t, cond, cm):
        return jq.decoder.apply(params, xt, t, cond, None, cm, deterministic=True)

    j_ids, _ = JS.make_sample_fn(decoder_apply, jq.sched, scfg)(
        jq.decoder_params, jax.random.key(0), c, SEQ_LEN, c_mask, jnp.asarray(x_init))
    rows = tq.transcribe_with_ids(wav, seq_len=SEQ_LEN, x_init=x_init, T_infer=20, r=5,
                                  greedy=True)
    np.testing.assert_array_equal(np.asarray([r[1] for r in rows]), np.asarray(j_ids))
    assert [r[0] for r in rows] == [jq.ids_to_text(row) for row in np.asarray(j_ids)]


def test_config_flags_reach_the_modules():
    """`encoder.wavlm_config.quant_dense` / `fused_frontend` are honoured, a
    JAX-only lowering switch is still accepted, unknown values raise."""
    from fddm_asr_tpu_torch.pipeline import build_wavlm_config as port_build

    enc = Config({"wavlm_name": "tiny", "wavlm_config": {
        "quant_dense": "int8", "fused_frontend": True, "scan_layers": True}})
    cfg = port_build(enc)
    assert cfg.quant_dense == "int8" and cfg.fused_frontend
    with pytest.raises(ValueError, match="quant_dense"):
        port_build(Config({"wavlm_name": "tiny", "wavlm_config": {"quant_dense": "fp8"}}))
    bad = {**CFG, "model": {**CFG["model"], "quant_dense": "int8_fused"}}
    with pytest.raises(ValueError, match="quant_dense"):
        FDDMPipeline.from_config(Config(bad), tokenizer=object(), device="cpu")
