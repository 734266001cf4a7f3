# -*- coding: utf-8 -*-
"""The port's WavLM in training mode against the JAX package's.

Tiny config, float32 on the CPU (attention through the plain version, which
autograd differentiates).  Forward outputs atol 1e-4 (test_torch_wavlm.py's
tolerance); gradients of sum(out * cotangent) within 1e-4 of the largest
reference gradient.  Covers the SpecAugment substitutions, the frozen conv
front-end, layer rematerialisation (remat_policy full and dots), and what
raises: a remat_policy other than "full" and "dots".  Attention dropout,
and what each remat_policy recomputes, are held in
tests/test_torch_train_recipe.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from fddm_asr_tpu.models.wavlm import WavLMModel as JaxWavLMModel
from fddm_asr_tpu_torch.convert import wavlm_state_dict_from_jax_params
from fddm_asr_tpu_torch.models.wavlm import WavLMConfig, WavLMModel, sample_time_mask

B, N_WAVE, S = 2, 3200, 9  # 0.2 s -> 9 frames
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  feat_proj_dropout=0.0)


def _port_config(**overrides):
    return dataclasses.replace(WavLMConfig.tiny_for_tests(), **{**NO_DROPOUT, **overrides})


@pytest.fixture(scope="module")
def jax_ref():
    """One JAX model (fused_attention, scanned layers), its perturbed
    parameters and inputs, shared by the tests below: each jit compile costs
    seconds on the CPU.  Remat is a port option that changes memory only, so
    both port variants are held against the same reference."""
    rng = np.random.default_rng(0)
    port = _port_config()
    fields = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    jmodel = JaxWavLMModel(JaxWavLMConfig(**fields, fused_attention=True, scan_layers=True))
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, N_WAVE)))
    params = jax.tree.map(lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
                          params)
    wav = rng.standard_normal((B, N_WAVE)).astype(np.float32)
    tm = np.zeros((B, S), bool)
    tm[0, 2:5] = True
    tm[1, 6:] = True
    fm = np.zeros((B, 32), bool)
    fm[1, 3:9] = True
    cot = rng.standard_normal((B, S, 32)).astype(np.float32)

    def loss(p):
        """Training mode (deterministic=False, fused_attention, which takes
        the XLA path on the CPU), SpecAugment time masks, dropout 0."""
        out = jmodel.apply(p, jnp.asarray(wav), mask_time_indices=jnp.asarray(tm),
                           deterministic=False, rngs={"dropout": jax.random.key(1)})
        return jnp.sum(out * cot)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss))(params)
    return dict(jmodel=jmodel, params=params, wav=wav, tm=tm, fm=fm, cot=cot,
                loss=float(ref_loss), grads=jax.tree.map(np.asarray, ref_grads))


def _port_model(jax_ref, **overrides):
    model = WavLMModel(_port_config(**overrides))
    model.load_state_dict(wavlm_state_dict_from_jax_params(jax_ref["params"]), strict=True)
    return model


def test_sample_time_mask_spans(rng):
    gen = torch.Generator().manual_seed(0)
    mask = sample_time_mask(64, 50, 0.2, 5, gen)
    assert mask.shape == (64, 50) and mask.dtype == torch.bool
    counts = mask.sum(1)
    assert (counts >= 5).all() and (counts <= 2 * 5).all()  # 2 spans of 5, may overlap
    # every masked run is a union of whole spans: no run shorter than 5
    for row in mask.numpy():
        edges = np.flatnonzero(np.diff(np.concatenate([[0], row.astype(int), [0]])))
        assert (np.diff(edges)[::2] >= 5).all()
    again = sample_time_mask(64, 50, 0.2, 5, torch.Generator().manual_seed(0))
    assert torch.equal(mask, again)
    short = sample_time_mask(3, 4, 0.5, 10, gen)  # spans longer than the sequence
    assert short.all()


def test_specaugment_substitutions_match_jax(jax_ref):
    r = jax_ref
    apply = jax.jit(lambda p, w, t, f: r["jmodel"].apply(
        p, w, mask_time_indices=t, mask_feature_indices=f))
    ref = np.asarray(apply(r["params"], r["wav"], r["tm"], r["fm"]))
    plain = np.asarray(apply(r["params"], r["wav"], np.zeros_like(r["tm"]),
                             np.zeros_like(r["fm"])))
    model = _port_model(r).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(r["wav"]), mask_time_indices=torch.from_numpy(r["tm"]),
                    mask_feature_indices=torch.from_numpy(r["fm"])).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert np.abs(ref - plain).max() > 1e-2  # the masks changed the output


@pytest.mark.parametrize("remat", [None, "full", "dots"], ids=["plain", "remat", "dots"])
def test_encoder_grads_match_jax(jax_ref, remat):
    """The port in training mode, its layers not recomputed, or recomputed
    under remat_policy full or dots, against jax.grad of the JAX model's
    training-mode loss."""
    r = jax_ref
    want = wavlm_state_dict_from_jax_params(r["grads"])
    model = _port_model(r, remat_layers=remat is not None, remat_policy=remat or "full").train()
    out = model(torch.from_numpy(r["wav"]), mask_time_indices=torch.from_numpy(r["tm"]))
    got_loss = (out * torch.from_numpy(r["cot"])).sum()
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), r["loss"], rtol=1e-5)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4 * scale, rtol=0,
                                   err_msg=name)
    assert model.masked_spec_embed.grad.abs().max() > 0


def _loss_and_grads(model, wav, seed):
    torch.manual_seed(seed)
    out = model(wav)
    loss = (out ** 2).sum()
    model.zero_grad()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def test_remat_gives_identical_loss_and_grads(rng):
    """Recomputed layers replay the dropout masks of their first pass
    (torch.utils.checkpoint restores the RNG state), so remat changes
    memory, never the numbers."""
    cfg = dataclasses.replace(WavLMConfig.tiny_for_tests(), num_hidden_layers=3,
                              attention_dropout=0.0)
    torch.manual_seed(0)
    base = WavLMModel(cfg).train()
    remat = WavLMModel(dataclasses.replace(cfg, remat_layers=True)).train()
    remat.load_state_dict(base.state_dict())
    wav = torch.from_numpy(rng.standard_normal((B, N_WAVE)).astype(np.float32))
    loss_a, grads_a = _loss_and_grads(base, wav, seed=3)
    loss_b, grads_b = _loss_and_grads(remat, wav, seed=3)
    assert loss_a == loss_b
    assert grads_a.keys() == grads_b.keys()
    for name in grads_a:
        torch.testing.assert_close(grads_a[name], grads_b[name], rtol=0, atol=0, msg=name)


def test_frozen_feature_extractor_gets_no_gradient(rng):
    cfg = dataclasses.replace(WavLMConfig.tiny_for_tests(), freeze_feature_extractor=True,
                              **NO_DROPOUT)
    model = WavLMModel(cfg).train()
    wav = torch.from_numpy(rng.standard_normal((B, N_WAVE)).astype(np.float32))
    _, grads = _loss_and_grads(model, wav, seed=0)
    assert not any(n.startswith("feature_extractor.") for n in grads)
    assert "feature_projection.projection.weight" in grads
    assert "encoder.layers.0.attention.rel_attn_embed.weight" in grads


def test_what_is_not_ported_raises(rng):
    """Attention dropout now trains (the plain path): a training forward
    differs from the evaluation one, which never drops.  A remat_policy
    other than "full" or "dots" raises, as in the JAX package."""
    wav = torch.from_numpy(rng.standard_normal((1, N_WAVE)).astype(np.float32))
    model = WavLMModel(dataclasses.replace(WavLMConfig.tiny_for_tests(),
                                           hidden_dropout=0.0)).train()
    trained = model(wav, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # evaluation never applies dropout
        evaluated = model.eval()(wav)
    assert not torch.allclose(trained, evaluated)
    other = WavLMModel(dataclasses.replace(WavLMConfig.tiny_for_tests(), remat_layers=True,
                                           remat_policy="offload", **NO_DROPOUT)).train()
    with pytest.raises(ValueError, match="remat_policy must be 'full' or 'dots'"):
        other(wav)
