# -*- coding: utf-8 -*-
"""The port's LoRA (`models/lora.py`, `convert.lora_adapters_from_jax`, the
LoRA train step) against the JAX package's (`fddm_asr_tpu/models/lora.py`,
the LoRA branch of `train_lib.make_train_step`).

* Targets: the port's adapters sit on the layers whose JAX kernels the JAX
  package's `init_lora` adapts (the default targets and a narrower
  pattern), with the same shapes and parameter count.
* The merge: the JAX adapters of a three-layer tiny WavLM with scanned
  layers (a [2, d_in, r] stack), in the flat and the nested (orbax
  without a template) form, crossed over and merged by the port, equal the
  JAX merge converted, bit for bit; at init (B = 0) the merge is the base,
  bit for bit; the differentiable `installed` block gives the same encoder
  output as the merged weights, and drops every merged weight on exit, by
  an error too; `merged_into`, evaluation and a second `installed` raise
  inside it, and a LoRA step's forward raises outside it.
* One LoRA fine-tune step with L_fd (float32, dropout 0, the JAX step's
  own draws and adapters handed across): loss terms within rtol 1e-5, the
  A and B gradients within 2e-5 of the largest A/B gradient, the decoder's
  and heads' within 1e-4 (test_torch_train_step.py's tolerance).  The
  largest A/B error seen is 1.4e-5 (layer 0's q_proj B; layer 1's all
  under 4.3e-7 of that scale, 0.6-2.6e-5 of each tensor's own largest in
  both layers).  Its witness: the port's A and B gradients are the chain
  rule, in float64, of its gradient G in the merged weight W_eff within
  1e-6 (held here), so the gap is in G, the encoder's backward, which the
  full fine-tune shares with no merge; there (test_torch_train_step.py,
  the same base weights and inputs) the dense weight gradients differ from
  JAX's by 0.24-1.1e-5 of each tensor's own largest, float32 rounding of
  the same size.  The updated adapters and their
  EMA within 1e-6 where Adam's sign is resolved; the base encoder
  unchanged on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu.models import lora as JLO
from fddm_asr_tpu.models.projection import SpeechProjector as JaxSpeechProjector
from fddm_asr_tpu.models.projection import TextEmbedding as JaxTextEmbedding
from fddm_asr_tpu.models.projection import TextProjector as JaxTextProjector
from fddm_asr_tpu.pipeline import build_wavlm_config as jax_build_wavlm_config
from fddm_asr_tpu.models.encoder import AcousticEncoder as JaxAcousticEncoder
from fddm_asr_tpu.train_lib import TrainState as JaxTrainState
from fddm_asr_tpu.train_lib import make_optimizer as jax_make_optimizer
from fddm_asr_tpu.train_lib import make_train_step as jax_make_train_step
from fddm_asr_tpu_torch import train_lib as TL
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.convert import (
    acoustic_encoder_state_dict_from_jax_params,
    decoder_state_dict_from_jax_params,
    lora_adapters_from_jax,
    projector_state_dict_from_jax_params,
    text_embedding_state_dict_from_jax_params,
)
from fddm_asr_tpu_torch.models import lora as LO
from fddm_asr_tpu_torch.models.encoder import AcousticEncoder
from fddm_asr_tpu_torch.pipeline import FDDMPipeline, build_wavlm_config
from tests.test_torch_train_step import (
    B, DM, DP, L, N_WAVE, V, _draws, _initial_params, _jax_pipe, _named, _perturbed,
    _stash_grads, _Tok,
)
from tests.test_torch_train_step import _cfg as _step_cfg

RANK, ALPHA = 2, 6.0  # scale 3.0
NARROW = r".*attention/(q_proj|v_proj)/kernel$"


def _encoder_cfg(layers: int) -> dict:
    return {"wavlm_name": "tiny", "freeze": False, "proj": "linear",
            "wavlm_config": {"scan_layers": True, "num_hidden_layers": layers}}


@pytest.fixture(scope="module")
def encoders():
    """A three-layer tiny JAX encoder (layers_0 and a 2-layer layers_scan
    stack), its parameters, and the port's encoder holding them."""
    enc_cfg = _encoder_cfg(3)
    jenc = JaxAcousticEncoder(jax_build_wavlm_config(JaxConfig(enc_cfg)), d_model=DM)
    params = jax.jit(jenc.init)(jax.random.key(3), jnp.zeros((1, 640)))
    params = jax.tree.map(np.asarray, params)
    enc = AcousticEncoder(build_wavlm_config(Config(enc_cfg)), d_model=DM)
    enc.load_state_dict(acoustic_encoder_state_dict_from_jax_params(params))
    return params, enc.eval()


def _jax_adapters(params, targets=JLO.DEFAULT_TARGETS, random_b=True, seed=0):
    adapters = JLO.init_lora(jax.random.key(1), params, RANK, targets=targets)
    rng = np.random.default_rng(seed)
    return {k: {"a": np.asarray(v["a"]),
                "b": (0.3 * rng.standard_normal(v["b"].shape)).astype(np.float32)
                if random_b else np.asarray(v["b"])}
            for k, v in adapters.items()}


def _nested(flat):
    out = {}
    for path, ad in flat.items():
        node = out
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node.update(ad)
    return out


@pytest.mark.parametrize("targets", [JLO.DEFAULT_TARGETS, NARROW], ids=["default", "narrow"])
def test_adapters_cover_the_jax_targets(encoders, targets):
    params, enc = encoders
    theirs = lora_adapters_from_jax(_jax_adapters(params, targets, random_b=False))
    ours = LO.init_lora(enc, RANK, targets, torch.Generator().manual_seed(0))
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        for ab in ("a", "b"):
            assert ours[name][ab].shape == theirs[name][ab].shape, (name, ab)
        assert torch.count_nonzero(ours[name]["b"]) == 0
    assert LO.lora_param_count(ours) == JLO.lora_param_count(
        _jax_adapters(params, targets, random_b=False))
    assert LO.adapter_rank(ours) == RANK
    # 3 layers x (4 attention + 2 FFN kernels), or 3 x 2 under the narrow pattern
    assert len(ours) == (18 if targets == JLO.DEFAULT_TARGETS else 6)
    a = torch.cat([ad["a"].reshape(-1) for ad in ours.values()])
    assert abs(float(a.std()) - RANK ** -0.5) < 0.05  # A ~ N(0, 1/r)


@pytest.mark.parametrize("form", ["flat", "nested"])
def test_merge_matches_jax(encoders, form):
    params, enc = encoders
    jad = _jax_adapters(params)
    assert any(v["a"].ndim == 3 and v["a"].shape[0] == 2 for v in jad.values())  # the stack
    merged = acoustic_encoder_state_dict_from_jax_params(
        jax.tree.map(np.asarray, JLO.merge_lora(params, jad, 3.0)))
    ours = LO.merge_lora(enc.state_dict(), lora_adapters_from_jax(
        jad if form == "flat" else _nested(jad)), 3.0)
    assert sorted(ours) == sorted(merged)
    changed = 0
    for name, want in merged.items():
        np.testing.assert_array_equal(ours[name].numpy(), want.numpy(), err_msg=name)
        changed += not torch.equal(ours[name], enc.state_dict()[name])
    assert changed == 18  # every adapted kernel moved, nothing else

    # at init (B = 0) the merge is the base, bit for bit
    base = {n: t.clone() for n, t in enc.state_dict().items()}
    at_init = LO.merge_lora(base, lora_adapters_from_jax(_jax_adapters(params, random_b=False)),
                            3.0)
    assert all(torch.equal(at_init[n], base[n]) for n in base)

    # the training path (installed) gives the merged weights' output, and
    # leaves nothing behind, on an error too; no merge nests in it
    wav = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3200)).astype(np.float32))
    adapters = lora_adapters_from_jax(jad)
    with LO.installed(enc, adapters, 3.0):
        installed = enc(wav)[0]
        for nested in (LO.installed, LO.merged_into):
            with pytest.raises(RuntimeError, match="inside lora.installed"):
                with nested(enc, adapters, 3.0):
                    pass
        assert LO.is_installed(enc)
    assert not LO.is_installed(enc)
    with pytest.raises(ZeroDivisionError):
        with LO.installed(enc, adapters, 3.0):
            1 / 0
    assert not LO.is_installed(enc)
    with LO.merged_into(enc, adapters, 3.0):
        in_place = enc(wav)[0]
    assert all(torch.equal(enc.state_dict()[n], base[n]) for n in base)  # put back
    np.testing.assert_array_equal(installed.detach().numpy(), in_place.numpy())
    assert not torch.allclose(in_place, enc(wav)[0])
    with pytest.raises(ValueError, match="not found"):
        LO.merge_lora({"x.weight": torch.zeros(2, 2)}, adapters, 1.0)


# ------------------------------------------------------------ the LoRA step
def _lora_cfg() -> dict:
    cfg = _step_cfg(freeze=False)
    cfg["model"]["encoder"].update({"lora_rank": RANK, "lora_alpha": ALPHA})
    return cfg


def test_lora_step_matches_jax():
    rng = np.random.default_rng(0)
    cfg_dict = _lora_cfg()
    jcfg, cfg = JaxConfig(cfg_dict), Config(cfg_dict)
    jpipe = _jax_pipe(jcfg)
    dec, enc = _initial_params()
    jpipe.decoder_params = _perturbed(dec, rng)
    jpipe.encoder_params = _perturbed(enc, rng)
    mods = (JaxSpeechProjector(d_proj=DP), JaxTextEmbedding(d_out=DP, mode="logits"),
            JaxTextProjector(d_proj=DP))
    keys = jax.random.split(jax.random.key(0), 3)
    heads = tuple(jax.jit(m.init)(k, jnp.zeros((1, 4, d)))
                  for m, k, d in zip(mods, keys, (DM, V, DP)))
    jad = _jax_adapters(jpipe.encoder_params, seed=2)
    tx = optax.chain(_stash_grads(), jax_make_optimizer(jcfg, train_encoder=True))
    params0 = (jpipe.decoder_params, *heads, jad)
    copy = lambda tree: jax.tree.map(jnp.array, tree)  # noqa: E731
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), decoder=copy(params0[0]), s_proj=params0[1],
        t_embed=params0[2], t_proj=params0[3], opt_state=jax.jit(tx.init)(params0),
        encoder=copy(jad), ema=copy(params0))
    jstep = jax_make_train_step(jpipe, *mods, tx, jcfg, train_encoder=True)

    pipe = FDDMPipeline.from_config(cfg, tokenizer=_Tok(), device="cpu")
    pipe.decoder.load_state_dict(decoder_state_dict_from_jax_params(jpipe.decoder_params))
    pipe.encoder.load_state_dict(
        acoustic_encoder_state_dict_from_jax_params(jpipe.encoder_params))
    base = {n: t.clone() for n, t in pipe.encoder.state_dict().items()}
    theads = TL.make_projection_heads(cfg, "cpu", torch.float32)
    theads[0].load_state_dict(projector_state_dict_from_jax_params(jstate.s_proj))
    theads[1].load_state_dict(text_embedding_state_dict_from_jax_params(jstate.t_embed))
    theads[2].load_state_dict(projector_state_dict_from_jax_params(jstate.t_proj))
    state = TL.init_train_state(pipe, cfg, heads=theads)
    assert state.encoder is None and state.lora_scale == ALPHA / RANK
    carried = lora_adapters_from_jax(jad)
    with torch.no_grad():
        for name, ad in state.lora.items():
            for ab, p in ad.items():
                p.copy_(carried[name][ab])
    state.ema = [p.detach().clone() for p in state.optimizer.params]
    assert not any(p.requires_grad for p in pipe.encoder.parameters())
    step = TL.make_train_step(pipe, cfg, train_encoder=True)

    wave = rng.standard_normal((B, N_WAVE)).astype(np.float32)
    x0 = rng.integers(1, V, (B, L)).astype(np.int32)
    x0[1, 9:] = 0
    key = jax.random.key(42)
    t, xt, tm = _draws(jpipe, x0, key, True)
    draws = dict(t=np.array(t), xt=np.array(xt), time_mask=np.array(tm))
    jbase = jax.tree.map(np.asarray, jpipe.encoder_params)
    jstate, jm = jstep(jstate, jpipe.encoder_params, jnp.asarray(wave), jnp.asarray(x0), key,
                       True)
    jgrads = jstate.opt_state[0]

    with pytest.raises(RuntimeError, match="inside step.merged"):
        step.forward(state, wave, x0, True, **draws)
    with step.merged(state):
        loss, _ = step.forward(state, wave, x0, True, **draws)
        w_eff = {n: m.__dict__[LO.LORA_WEIGHT] for n, m in pipe.encoder.named_modules()
                 if LO.LORA_WEIGHT in m.__dict__}
        assert sorted(w_eff) == sorted(state.lora)
        n_params = len(state.optimizer.params)
        ours = torch.autograd.grad(loss, [*state.optimizer.params, *w_eff.values()],
                                   allow_unused=True)
        d_weff = dict(zip(w_eff, ours[n_params:]))
        ours = ours[:n_params]
        with pytest.raises(RuntimeError, match="evaluation inside lora.installed"):
            with TL._evaluating(pipe, state, True):
                pass
    by_id = {id(p): (g if g is not None else torch.zeros_like(p))
             for p, g in zip(state.optimizer.params, ours)}
    # the adapters' gradients
    want = lora_adapters_from_jax(jax.tree.map(np.asarray, jgrads[4]))
    scale = max(float(w[ab].abs().max()) for w in want.values() for ab in ("a", "b"))
    assert scale > 0
    for name, ad in state.lora.items():
        # the chain rule through W_eff = W + s (A B)^T, in float64 from the
        # port's gradient G in W_eff: dA = s G^T B^T, dB = s A^T G^T; so a
        # gap to JAX's is in G, the encoder's backward, not in the merge
        g, a, b = (x.detach().double() for x in (d_weff[name], ad["a"], ad["b"]))
        chain = {"a": ALPHA / RANK * g.t() @ b.t(), "b": ALPHA / RANK * a.t() @ g.t()}
        for ab, p in ad.items():
            np.testing.assert_allclose(by_id[id(p)].double().numpy(), chain[ab].numpy(),
                                       atol=1e-6 * scale, rtol=0, err_msg=f"chain {name}.{ab}")
            np.testing.assert_allclose(by_id[id(p)].numpy(), want[name][ab].numpy(),
                                       atol=2e-5 * scale, rtol=0, err_msg=f"grad {name}.{ab}")
    # the decoder's and the heads'
    named = _named_main(state, jgrads)
    dscale = max(float(np.abs(g).max()) for _, _, g in named)
    for name, p, g in named:
        np.testing.assert_allclose(by_id[id(p)].numpy(), g, atol=1e-4 * dscale, rtol=0,
                                   err_msg=f"grad {name}")

    m = step(state, wave, x0, True, **draws)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert not LO.is_installed(pipe.encoder)
    # the updated adapters and their EMA (the EMA's adapters close the list)
    new = lora_adapters_from_jax(jax.tree.map(np.asarray, jstate.encoder))
    n_ad = 2 * len(state.lora)
    new_ema = lora_adapters_from_jax(jax.tree.map(np.asarray, jstate.ema[4]))
    lr = 3e-4  # encoder_lr: the adapters' group
    for (name, ad), i in zip(state.lora.items(), range(0, n_ad, 2)):
        for j, (ab, p) in enumerate(ad.items()):
            g = want[name][ab].numpy()
            resolved = np.abs(g) > 4e-5 * scale
            for got, ref in ((p.detach().numpy(), new[name][ab].numpy()),
                             (state.ema[-n_ad + i + j].numpy(), new_ema[name][ab].numpy())):
                diff = np.abs(got - ref)
                assert diff[resolved].max(initial=0) <= 1e-6, (name, ab)
                assert diff.max() <= 2.1 * lr, (name, ab)
            assert not np.array_equal(p.detach().numpy(), carried[name][ab].numpy())
    # the base encoder is untouched on both sides
    assert all(torch.equal(pipe.encoder.state_dict()[n], base[n]) for n in base)
    for a, b in zip(jax.tree_util.tree_leaves(jpipe.encoder_params),
                    jax.tree_util.tree_leaves(jbase)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _named_main(state, jparams):
    """test_torch_train_step._named over the decoder and the heads only."""
    stub = type("S", (), {"trained_modules": lambda self: state.trained_modules()[:4],
                          "optimizer": type("O", (), {"params": state.optimizer.params[
                              :sum(1 for m in state.trained_modules()[:4]
                                   for _ in m.parameters())]})()})()
    return _named(stub, jparams[:4])
