# -*- coding: utf-8 -*-
"""The port's WavLM encoder against the JAX package's (and HF's) at the same weights.

Tiny config, float32 on the CPU, where attention goes through the plain
version of the gated-attention kernel.  Tolerance atol 1e-4: both sides
compute in f32, the differences are summation order through the conv
front-end and two transformer layers (HF, a third implementation, is held
at the JAX package's own 3e-4).  The JAX side runs jitted: one compile per
model costs far less than compiling each eager op."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu.models.encoder import AcousticEncoder as JaxAcousticEncoder
from fddm_asr_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from fddm_asr_tpu.models.wavlm import WavLMModel as JaxWavLMModel
from fddm_asr_tpu_torch.convert import (
    acoustic_encoder_state_dict_from_jax_params,
    wavlm_state_dict_from_hf,
    wavlm_state_dict_from_jax_params,
)
from fddm_asr_tpu_torch.models.encoder import AcousticEncoder
from fddm_asr_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

B, T = 2, 3200  # 0.2 s at 16 kHz -> 9 frames
ATOL = 1e-4


def _configs(stable: bool, seq_pad_multiple: int, scan_layers: bool):
    port = WavLMConfig.tiny_for_tests()
    if not stable:
        port = dataclasses.replace(port, feat_extract_norm="group",
                                   do_stable_layer_norm=False, conv_bias=False)
    port = dataclasses.replace(port, seq_pad_multiple=seq_pad_multiple)
    fields = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    return port, JaxWavLMConfig(**fields, scan_layers=scan_layers)


def _perturbed(params, rng):
    """Random offsets on every leaf, so norms and gates are not at their init."""
    return jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32), params)


def _wave_and_mask(rng, with_mask):
    wav = rng.standard_normal((B, T)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.ones((B, T), bool)
        mask[1, T // 2:] = False
    return wav, mask


@pytest.mark.parametrize("stable,with_mask,seq_pad_multiple,scan_layers", [
    (True, False, 1, False),
    (True, True, 128, True),
    (True, True, 1, False),
    (False, True, 1, True),
    (False, False, 128, False),
], ids=["large-nomask", "large-mask-pad128-scan", "large-mask", "base-mask-scan",
        "base-pad128"])
def test_wavlm_matches_jax(rng, stable, with_mask, seq_pad_multiple, scan_layers):
    port_cfg, jax_cfg = _configs(stable, seq_pad_multiple, scan_layers)
    wav, mask = _wave_and_mask(rng, with_mask)
    jmodel = JaxWavLMModel(jax_cfg)
    params = _perturbed(jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, T))), rng)
    ref = np.asarray(jax.jit(jmodel.apply)(
        params, jnp.asarray(wav), None if mask is None else jnp.asarray(mask)))
    model = WavLMModel(port_cfg).eval()  # the JAX side runs deterministic
    model.load_state_dict(wavlm_state_dict_from_jax_params(params), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(wav),
                    attention_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    assert out.shape == ref.shape == (B, 9, port_cfg.hidden_size)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_position_bias_follows_the_input_length(rng):
    """The bucket table is built once per length: one model fed two lengths
    in turn gives what a fresh model gives at each."""
    cfg, _ = _configs(True, 1, False)
    torch.manual_seed(0)
    model = WavLMModel(cfg).eval()
    wav = torch.from_numpy(rng.standard_normal((1, T)).astype(np.float32))
    with torch.no_grad():
        for x in (wav, wav[:, :1600], wav):
            fresh = WavLMModel(cfg).eval()
            fresh.load_state_dict(model.state_dict())
            torch.testing.assert_close(model(x), fresh(x), rtol=0, atol=0)


@pytest.mark.parametrize("stable", [True, False], ids=["large-style", "base-style"])
def test_wavlm_matches_transformers(rng, stable):
    from transformers import WavLMConfig as HFConfig
    from transformers import WavLMModel as HFModel

    torch.manual_seed(0)
    hf_cfg = HFConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=[16] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
        conv_bias=stable, feat_extract_norm="layer" if stable else "group",
        do_stable_layer_norm=stable, num_buckets=32, max_bucket_distance=80,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        mask_time_prob=0.0, mask_feature_prob=0.0, layerdrop=0.0)
    hf = HFModel(hf_cfg).eval()
    port_cfg, _ = _configs(stable, 1, False)
    model = WavLMModel(port_cfg).eval()
    model.load_state_dict(wavlm_state_dict_from_hf(hf.state_dict()), strict=True)
    wav, mask = _wave_and_mask(rng, True)
    with torch.no_grad():
        ref = hf(torch.from_numpy(wav),
                 attention_mask=torch.from_numpy(mask).long()).last_hidden_state.numpy()
        out = model(torch.from_numpy(wav), attention_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-4, rtol=1e-3)


def test_acoustic_encoder_proj_and_masks_match_jax(rng):
    port_cfg, jax_cfg = _configs(True, 128, True)
    wav, _ = _wave_and_mask(rng, False)
    lengths = np.array([T, 1900])
    jenc = JaxAcousticEncoder(jax_cfg, d_model=24, pooling="mean")
    params = _perturbed(jax.jit(jenc.init)(jax.random.key(1), jnp.zeros((1, T))), rng)
    feats, fmask, pooled = jax.jit(jenc.apply)(params, jnp.asarray(wav), jnp.asarray(lengths))
    enc = AcousticEncoder(port_cfg, d_model=24, pooling="mean").eval()
    enc.load_state_dict(acoustic_encoder_state_dict_from_jax_params(params), strict=True)
    out, mask, pool = enc(torch.from_numpy(wav), torch.from_numpy(lengths))
    assert out.shape == (B, 9, 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(feats), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(fmask))
    np.testing.assert_allclose(pool.numpy(), np.asarray(pooled), atol=ATOL, rtol=0)


# ------------------------------------------- int8 denses, fused conv front-end
def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


@pytest.fixture(scope="module")
def tiny_large_style():
    """One parameter tree, shared by every flag: the flags change no
    parameter, so the full-precision tree (through `convert.py`, unchanged)
    is the quantized model's too."""
    _, jax_cfg = _configs(True, 1, False)
    rng = np.random.default_rng(0)
    jmodel = JaxWavLMModel(jax_cfg)
    params = _perturbed(jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, T))), rng)
    wav, mask = _wave_and_mask(rng, True)
    return params, wav, mask


def _both(params, wav, mask, jit=True, **flags):
    """(port output, JAX output) of the tiny large-style model under `flags`."""
    port_cfg, jax_cfg = _configs(True, 1, False)
    port_cfg = dataclasses.replace(port_cfg, **flags)
    jmodel = JaxWavLMModel(dataclasses.replace(jax_cfg, **flags))
    apply = jax.jit(jmodel.apply) if jit else jmodel.apply
    ref = np.asarray(apply(params, jnp.asarray(wav), jnp.asarray(mask)))
    model = WavLMModel(port_cfg).eval()
    model.load_state_dict(wavlm_state_dict_from_jax_params(params), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(wav), attention_mask=torch.from_numpy(mask)).numpy()
    return out, ref


def test_quantized_wavlm_matches_jax_under_the_same_flag(tiny_large_style):
    """`quant_dense` "int8" and "int8_fused" against the JAX model under the
    same flag (its fused path is the Pallas kernel in interpret mode on the
    CPU), atol 2e-5 as `tests/test_quant.py` holds fused against unfused:
    the integers are identical, the rest is f32 summation order.  The two
    modes agree exactly, and differ from full precision by a little.  The
    JAX side runs op by op, as its own tests run it: under jit XLA rewrites
    the f32 steps before a rounding, and a value within that of a tie then
    rounds to the other integer (one step of 1/127 of the row's range)."""
    params, wav, mask = tiny_large_style
    full, _ = _both(params, wav, mask)
    out = {}
    for mode in ("int8", "int8_fused"):
        out[mode], ref = _both(params, wav, mask, jit=False, quant_dense=mode)
        np.testing.assert_allclose(out[mode], ref, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(out["int8"], out["int8_fused"])
    assert 1e-6 < _rel_l2(out["int8_fused"], full) < 0.05


@pytest.mark.parametrize("interpret", [False, True], ids=["xla-reference", "pallas-interpret"])
def test_fused_frontend_matches_jax(tiny_large_style, monkeypatch, interpret):
    """`fused_frontend` against the JAX model with it on: through its XLA
    reference (what the JAX dispatcher takes on the CPU) and through the
    Pallas kernel in interpret mode; and against the flag off, from which it
    differs by summation order only in float32."""
    import functools

    from fddm_asr_tpu.ops import conv_frontend as JC

    params, wav, mask = tiny_large_style
    if interpret:
        monkeypatch.setattr(JC, "conv_ln_gelu",
                            functools.partial(JC.conv_ln_gelu, interpret=True))
    out, ref = _both(params, wav, mask, fused_frontend=True, gelu_approx_tanh=True)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    monkeypatch.undo()
    unfused, _ = _both(params, wav, mask, gelu_approx_tanh=True)
    np.testing.assert_allclose(out, unfused, atol=ATOL, rtol=0)
    erf, _ = _both(params, wav, mask, fused_frontend=True)
    assert np.abs(out - erf).max() > 1e-6  # the tanh flag reaches the fused layers


def test_flags_keep_the_state_dict_and_refuse_autograd(tiny_large_style):
    """A quantized, fused model loads a full-precision state_dict strictly
    (and the other way round); both options raise where autograd records;
    an unknown quant_dense raises."""
    params, wav, _ = tiny_large_style
    cfg, _ = _configs(True, 1, False)
    full = WavLMModel(cfg).eval()
    full.load_state_dict(wavlm_state_dict_from_jax_params(params), strict=True)
    flagged = WavLMModel(dataclasses.replace(cfg, quant_dense="int8_fused",
                                             fused_frontend=True)).eval()
    flagged.load_state_dict(full.state_dict(), strict=True)
    full.load_state_dict(flagged.state_dict(), strict=True)
    assert list(flagged.state_dict()) == list(full.state_dict())
    x = torch.from_numpy(wav)
    with pytest.raises(RuntimeError, match="forward only"):
        flagged(x)
    with pytest.raises(RuntimeError, match="inference only"):
        WavLMModel(dataclasses.replace(cfg, quant_dense="int8")).eval()(x)
    with pytest.raises(ValueError, match="quant_dense"):
        dataclasses.replace(cfg, quant_dense="int4")
    with torch.no_grad():  # a reloaded weight is quantized anew
        before = flagged(x)
        flagged.load_state_dict({k: v * 1.5 for k, v in full.state_dict().items()})
        assert not torch.equal(flagged(x), before)
