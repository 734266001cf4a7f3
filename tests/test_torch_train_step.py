# -*- coding: utf-8 -*-
"""The port's optimizer and train steps against the JAX package's.

* The optimizer: `train_lib.make_optimizer` against the JAX package's
  (optax) over several steps of the same random gradients, for the constant,
  cosine and linear schedules with warmup, an encoder_lr group, an active
  global-norm clip, 1-D decay exclusion and a skipped non-finite step;
  parameters within rtol 1e-5 (float32; optax and torch round the same
  formulas in different orders).  The first update under linear warmup has
  lr 0 and leaves the parameters exactly as they were.
* The EMA ramp min(decay, (1+step)/(10+step)).
* The fine-tune step and the frozen step on a tiny float32 config with
  dropout 0: the JAX step's own draws (t, x_t, the SpecAugment time mask,
  re-derived from its rng with its splits, train_lib.py:261-268, :312-327,
  :368-370) are handed to the port's step, and the JAX step's gradients
  are read back through an optax link chained in front of its optimizer
  that keeps them as its state.  Loss terms within rtol 1e-5,
  the pre-clip gradient norm within rtol 1e-5, every gradient within 1e-4 of
  the largest reference gradient, and the updated parameters within 1e-6,
  except where |grad| is below twice that tolerance: Adam's first update
  lr * g / (|g| + eps) is +-lr for a gradient whose sign both sides agree
  on, and for one at the noise level (or below the eps scale, 1e-8) the two
  may differ by up to twice the learning rate.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fddm_asr_tpu import diffusion as JD
from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu.models.projection import SpeechProjector as JaxSpeechProjector
from fddm_asr_tpu.models.projection import TextEmbedding as JaxTextEmbedding
from fddm_asr_tpu.models.projection import TextProjector as JaxTextProjector
from fddm_asr_tpu.models.wavlm import sample_time_mask as jax_sample_time_mask
from fddm_asr_tpu.pipeline import FDDMPipeline as JaxPipeline
from fddm_asr_tpu.pipeline import build_wavlm_config as jax_build_wavlm_config
from fddm_asr_tpu.train_lib import TrainState as JaxTrainState
from fddm_asr_tpu.train_lib import make_optimizer as jax_make_optimizer
from fddm_asr_tpu.train_lib import make_train_step as jax_make_train_step
from fddm_asr_tpu_torch import train_lib as TL
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.convert import (
    acoustic_encoder_state_dict_from_jax_params,
    decoder_state_dict_from_jax_params,
    projector_state_dict_from_jax_params,
    text_embedding_state_dict_from_jax_params,
)
from fddm_asr_tpu_torch.pipeline import FDDMPipeline

V, DM, DP = 96, 32, 16      # vocab, d_model, d_proj
B, N_WAVE, L = 3, 3200, 12  # batch, samples (9 frames), tokens
T_DIFF = 20
MASK_PROB, MASK_LEN = 0.3, 2


# ----------------------------------------------------------------- optimizer
def _optim_params(rng):
    shapes = [{"w": (5, 4), "b": (4,)}, {"w": (3, 3)}, {"w": (2, 6)}, {"b": (7,)},
              {"w": (4, 4), "b": (4,)}]  # decoder, s_proj, t_embed, t_proj, encoder
    return tuple({k: rng.standard_normal(s).astype(np.float32) for k, s in d.items()}
                 for d in shapes)


@pytest.mark.parametrize("schedule", [
    {"lr_schedule": "constant", "warmup_steps": 2},
    {"lr_schedule": "cosine", "warmup_steps": 2, "decay_steps": 6},
    {"lr_schedule": "linear", "warmup_steps": 2, "decay_steps": 5, "end_lr": 1e-4},
], ids=["constant", "cosine", "linear"])
def test_optimizer_matches_optax(rng, schedule):
    optim = {"lr": 1e-2, "encoder_lr": 3e-3, "weight_decay": 0.05, "grad_clip": 1.0,
             "decay_exclude_1d": True, "skip_nonfinite_updates": 2, **schedule}
    jtx = jax_make_optimizer(JaxConfig({"optim": optim}), train_encoder=True)
    params = _optim_params(rng)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jparams)
    jupdate = jax.jit(jtx.update)  # eager optax dispatch costs seconds on the CPU
    tparams = tuple({k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in d.items()}
                    for d in params)
    ours = TL.make_optimizer(Config({"optim": optim}),
                             [p for d in tparams[:4] for p in d.values()],
                             list(tparams[4].values()))
    flat = [p for d in tparams for p in d.values()]
    norms = []
    for i in range(7):
        grads = tuple({k: (3.0 * rng.standard_normal(v.shape)).astype(np.float32)
                       for k, v in d.items()} for d in params)
        if i == 3:  # a non-finite step: skipped, nothing moves
            grads[1]["w"][0, 0] = np.nan
        updates, jstate = jupdate(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = [p.detach().clone() for p in flat]
        norm, applied = ours.step([torch.from_numpy(g) for d in grads for g in d.values()])
        norms.append(float(norm))
        assert applied == (i != 3)
        if i in (0, 3):  # lr 0 at the first update (warmup); a skipped step
            assert all(torch.equal(a, b) for a, b in zip(before, flat)), i
        for d_j, d_t in zip(jparams, tparams):
            for k in d_t:
                np.testing.assert_allclose(d_t[k].detach().numpy(), np.asarray(d_j[k]),
                                           rtol=1e-5, atol=1e-7, err_msg=f"step {i} {k}")
    assert max(n for i, n in enumerate(norms) if i != 3) > 1.0  # the clip was active


def test_lr_schedule_reads_the_count_before_the_update():
    optim = Config({"lr_schedule": "cosine", "warmup_steps": 4, "decay_steps": 12,
                    "end_lr": 1e-5})
    ours = TL.lr_schedule(optim, 1e-3, 4)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 4, 12, end_value=1e-5)
    for count in range(15):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12)
    assert ours(0) == 0.0


# ---------------------------------------------------------------- the steps
class _Tok:
    def encode(self, text):
        return [5, 6, 7]


def _cfg(freeze: bool) -> dict:
    return {
        "seed": 0,
        "data": {"vocab_size": V, "pad_id": 0, "max_len": 16},
        "model": {"d_model": DM, "nhead": 4, "num_layers": 2, "dim_ff": 64, "dropout": 0.0,
                  "dtype": "float32", "projector": {"d_proj": DP},
                  "encoder": {"wavlm_name": "tiny", "freeze": freeze, "proj": "linear",
                              "mask_time_prob": MASK_PROB, "mask_time_length": MASK_LEN,
                              "wavlm_config": {"scan_layers": True, "fused_attention": True,
                                               "hidden_dropout": 0.0,
                                               "attention_dropout": 0.0,
                                               "activation_dropout": 0.0}}},
        "diffusion": {"T": T_DIFF, "beta_max": 0.2},
        "optim": {"batch_size": B, "lr": 1e-3, "encoder_lr": 3e-4, "weight_decay": 0.01,
                  "dtype": "float32", "ema_decay": 0.999},
        "lfd": {"lambda_offdiag": 5e-3, "n_step_fd": 2, "tau": 1.0},
    }


def _perturbed(params, rng):
    # in numpy: an eager JAX add per leaf costs seconds over the whole tree
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params)


def _jax_pipe(cfg):
    return JaxPipeline(cfg, {}, {}, JD.make_schedule(V, T_DIFF, 0.2), _Tok(),
                       {"pad_id": 0, "bos_id": None, "eos_id": None, "unk_id": None},
                       jax_build_wavlm_config(cfg.model.encoder))


@functools.lru_cache(maxsize=None)
def _initial_params():
    """The JAX decoder's and encoder's initial parameters, made once for both
    steps (their shapes do not depend on `freeze`): JaxPipeline.from_config
    initialises eagerly, and even a jitted init compiles for seconds."""
    pipe = _jax_pipe(JaxConfig(_cfg(freeze=False)))
    k_dec, k_enc = jax.random.split(jax.random.key(0))
    dec = jax.jit(pipe.decoder.init)(k_dec, jnp.zeros((1, 8), jnp.int32),
                                     jnp.ones((1,), jnp.int32), jnp.zeros((1, 16, DM)))
    enc = jax.jit(pipe.encoder.init)(k_enc, jnp.zeros((1, 640), jnp.float32))
    return dec, enc


def _stash_grads():
    """An optax link that passes the gradients on unchanged and keeps them as
    its state: chained in front of the JAX package's optimizer, it hands the
    test the gradients the JAX step computed (`opt_state[0]` after the step)."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_setup(cfg, train_encoder, rng):
    pipe = _jax_pipe(cfg)
    dec, enc = _initial_params()
    pipe.decoder_params = _perturbed(dec, rng)
    pipe.encoder_params = _perturbed(enc, rng)
    mods = (JaxSpeechProjector(d_proj=DP), JaxTextEmbedding(d_out=DP, mode="logits"),
            JaxTextProjector(d_proj=DP))
    keys = jax.random.split(jax.random.key(0), 3)
    heads = tuple(jax.jit(m.init)(k, jnp.zeros((1, 4, d)))
                  for m, k, d in zip(mods, keys, (DM, V, DP)))
    tx = optax.chain(_stash_grads(), jax_make_optimizer(cfg, train_encoder=train_encoder))
    params0 = (pipe.decoder_params, *heads)
    if train_encoder:
        params0 = params0 + (pipe.encoder_params,)
    copy = lambda tree: jax.tree.map(jnp.array, tree)  # noqa: E731
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), decoder=copy(params0[0]), s_proj=params0[1],
        t_embed=params0[2], t_proj=params0[3], opt_state=jax.jit(tx.init)(params0),
        encoder=copy(params0[4]) if train_encoder else None, ema=copy(params0))
    step = jax_make_train_step(pipe, *mods, tx, cfg, train_encoder=train_encoder)
    return pipe, mods, state, step


def _port_setup(cfg, jpipe, jstate, train_encoder):
    pipe = FDDMPipeline.from_config(cfg, tokenizer=_Tok(), device="cpu")
    pipe.decoder.load_state_dict(decoder_state_dict_from_jax_params(jpipe.decoder_params))
    pipe.encoder.load_state_dict(acoustic_encoder_state_dict_from_jax_params(jpipe.encoder_params))
    heads = TL.make_projection_heads(cfg, "cpu", torch.float32)
    heads[0].load_state_dict(projector_state_dict_from_jax_params(jstate.s_proj))
    heads[1].load_state_dict(text_embedding_state_dict_from_jax_params(jstate.t_embed))
    heads[2].load_state_dict(projector_state_dict_from_jax_params(jstate.t_proj))
    state = TL.init_train_state(pipe, cfg, train_encoder=train_encoder, heads=heads)
    return pipe, state, TL.make_train_step(pipe, cfg, train_encoder=train_encoder)


def _named(state, jparams):
    """[(name, port parameter, JAX value)] in the optimizer's order; jparams is
    the JAX (decoder, s_proj, t_embed, t_proj[, encoder]) tuple."""
    converters = (decoder_state_dict_from_jax_params, projector_state_dict_from_jax_params,
                  text_embedding_state_dict_from_jax_params,
                  projector_state_dict_from_jax_params,
                  acoustic_encoder_state_dict_from_jax_params)
    out = []
    for i, (mod, tree) in enumerate(zip(state.trained_modules(), jparams)):
        ref = converters[i](jax.tree.map(np.asarray, tree))
        out += [(f"{i}.{n}", p, ref[n].numpy()) for n, p in mod.named_parameters()
                if p.requires_grad]
    assert [id(p) for _, p, _ in out] == [id(p) for p in state.optimizer.params]
    return out


def _draws(jpipe, x0, rng_key, train_encoder):
    """The JAX step's own t, x_t and time mask, from its rng and splits."""
    if train_encoder:
        rng_core, _, rng_mask = jax.random.split(rng_key, 3)
    else:
        rng_core = rng_key
    rng_t, rng_q, _ = jax.random.split(rng_core, 3)
    t = jax.random.randint(rng_t, (B,), 1, T_DIFF + 1)
    xt = JD.sample_xt_tokens(jpipe.sched, rng_q, jnp.asarray(x0), t)
    tm = None
    if train_encoder:
        r_t, _ = jax.random.split(rng_mask)
        S = jpipe.encoder.config.feat_extract_output_length(N_WAVE)
        tm = jax_sample_time_mask(r_t, B, int(S), MASK_PROB, MASK_LEN)
    return t, xt, tm


def _jparams(jstate, train_encoder):
    p = (jstate.decoder, jstate.s_proj, jstate.t_embed, jstate.t_proj)
    return p + ((jstate.encoder,) if train_encoder else ())


@pytest.mark.parametrize("train_encoder,apply_lfd", [(True, True), (False, False)],
                         ids=["finetune-lfd", "frozen-kl"])
def test_train_step_matches_jax(train_encoder, apply_lfd):
    rng = np.random.default_rng(0)
    cfg_dict = _cfg(freeze=not train_encoder)
    jcfg, cfg = JaxConfig(cfg_dict), Config(cfg_dict)
    jpipe, mods, jstate, jstep = _jax_setup(jcfg, train_encoder, rng)
    pipe, state, step = _port_setup(cfg, jpipe, jstate, train_encoder)
    wave = rng.standard_normal((B, N_WAVE)).astype(np.float32)
    x0 = rng.integers(1, V, (B, L)).astype(np.int32)
    x0[1, 9:] = 0  # a pad tail: masked out of the KL
    key = jax.random.key(42)
    t, xt, tm = _draws(jpipe, x0, key, train_encoder)
    draws = dict(t=np.array(t), xt=np.array(xt), time_mask=None if tm is None else np.array(tm))

    # the JAX package's step; the first optax link keeps its gradients
    frozen_args = () if train_encoder else (jpipe.encoder_params,)
    jstate, jm = jstep(jstate, *frozen_args, jnp.asarray(wave), jnp.asarray(x0), key, apply_lfd)
    jgrads = jstate.opt_state[0]

    # gradients: the JAX step's vs autograd of the port's loss
    loss, _ = step.forward(state, wave, x0, apply_lfd, **draws)
    named_grads = _named(state, jgrads)
    ours = torch.autograd.grad(loss, [p for _, p, _ in named_grads], allow_unused=True)
    # the scale is the largest reference gradient anywhere: a gradient that
    # cancels to ~0 (a bias in front of L_fd's batch standardisation) is
    # pure rounding noise of the terms that cancel
    scale = max(float(np.abs(g).max()) for _, _, g in named_grads)
    for (name, p, want), got in zip(named_grads, ours):
        got = torch.zeros_like(p) if got is None else got
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * scale, rtol=0,
                                   err_msg=f"grad {name}")

    # one update: metrics, parameters, EMA
    m = step(state, wave, x0, apply_lfd, **draws)
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == 1
    # Adam's first update is lr * g / (|g| + eps): +-lr wherever the sign of
    # g is resolved (|g| above twice the gradient tolerance), anything in
    # between where it is not
    resolved = {name: np.abs(g) > 2e-4 * scale for name, _, g in named_grads}
    # the EMA after one step is 2/11 old + 9/11 new parameters (its ramp)
    for (name, p, want), (_, _, want_ema), ema in zip(
            _named(state, _jparams(jstate, train_encoder)), _named(state, jstate.ema),
            state.ema):
        lr = 3e-4 if name.startswith("4.") else 1e-3  # the encoder group's, the rest's
        for what, got, ref in (("param", p.detach(), want), ("ema", ema, want_ema)):
            diff = np.abs(got.numpy() - ref)
            assert diff[resolved[name]].max(initial=0) <= 1e-6, f"{what} {name}"
            assert diff.max() <= 2.1 * lr, f"{what} {name}"

    if train_encoder:
        # the frozen conv front-end: out of the port's optimizer, so unchanged;
        # the JAX package's AdamW still decays it (its grads are zero)
        conv = pipe.encoder.backbone.feature_extractor.conv_layers[0].conv.weight
        assert not conv.requires_grad
        name = "backbone.feature_extractor.conv_layers.0.conv.weight"
        start = acoustic_encoder_state_dict_from_jax_params(jpipe.encoder_params)[name].numpy()
        np.testing.assert_array_equal(conv.detach().numpy(), start)
        jax_conv = acoustic_encoder_state_dict_from_jax_params(
            jax.tree.map(np.asarray, jstate.encoder))[name].numpy()
        np.testing.assert_allclose(jax_conv, start * (1 - 3e-4 * 0.01), rtol=1e-6)  # lr * wd
