# -*- coding: utf-8 -*-
"""The rest of the port's training recipe against the JAX package's, on the CPU.

* Gradient accumulation and a bfloat16 first moment: `train_lib.AdamW`
  (from `make_optimizer`) against the JAX package's optimizer
  (optax.MultiSteps over clip + AdamW, mu_dtype) on the same random
  gradients, micro-step by micro-step, with the EMA updated after every
  micro-step as the JAX step does it (`fddm_asr_tpu/train_lib.py:284-289`,
  its expression jitted here): the parameters within rtol 1e-5, the update
  count the schedule reads and the micro-step equal, a bfloat16 first
  moment and EMA stored as bfloat16 (JAX's dtype too) and within one
  bfloat16 ulp, a float32 EMA within rtol 1e-5.  Parameters change only on
  every k-th micro-step, where the count moves.
* `remat_policy`: the layers run again in the backward, under dots with
  no dense projection recomputed, under full with six a layer (their
  gradients against JAX's: test_torch_wavlm_train.py).  `model.remat_blocks`:
  the decoder's scanned blocks recomputed give jax.grad's gradients of the
  JAX decoder built with remat_blocks, within 1e-5 of the largest, and
  with dropout the gradients of no remat bit for bit; without `scan_blocks`
  it raises the JAX decoder's error.
* Attention dropout: at p = 0 the dropout path is within 1e-5 of the JAX
  package's XLA path (`ops/attention.dot_product_attention`) and equals the
  plain (kernel) path bit for bit; at p > 0 the kept share of attention weight is 1 - p and
  the output changed; drawn from per-layer seeds, a layer recomputed in
  the backward (remat) draws the same mask, so remat keeps the gradients.
* Asynchronous checkpoints: the files equal a synchronous save's; a failed
  write raises from `AsyncWriter.wait`.
* The loop (`python -m fddm_asr_tpu_torch.train`) with LoRA (rank 2,
  alpha 6), grad_accum_steps 2, bfloat16 mu and EMA and async checkpoints:
  the encoder file holds the EMA adapters only, the sidecar rank and
  alpha; `restore_state` puts adapters, moments, accumulator (at the end of
  an epoch and in the middle of an accumulation), counts and bfloat16 EMA
  back bit for bit, and a run on other layers or without accumulation
  refuses the checkpoint; a resume through the CLI runs on; the
  inference CLI's `--encoder-ckpt` merges the adapters into the seed's
  encoder at scale 3, which differs from the base.
* A JAX training checkpoint with LoRA and an EMA (`run_training` of the JAX
  package) through `scripts/export_torch_encoder.py --ckpt --decoder-out`:
  the port's `encode_waveform` within 1e-5 of the JAX pipeline loaded from
  the same directory, and the same ids from the exported decoder at one
  padded shape with an injected x_T.
"""
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu.models.decoder import DenoisingTransformerDecoder as JaxDecoder
from fddm_asr_tpu.ops.attention import dot_product_attention as jax_dot_product_attention
from fddm_asr_tpu.train_lib import make_optimizer as jax_make_optimizer
from fddm_asr_tpu_torch import checkpoint as C
from fddm_asr_tpu_torch import inference as cli
from fddm_asr_tpu_torch import train_lib as TL
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.convert import decoder_state_dict_from_jax_params, lora_adapters_from_jax
from fddm_asr_tpu_torch.models import lora as LO
from fddm_asr_tpu_torch.models.decoder import DenoisingTransformerDecoder
from fddm_asr_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from fddm_asr_tpu_torch.ops import flash_attention as FA
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from tests.test_torch_train_loop import _config, _records, _train, corpus  # noqa: F401


# ------------------------------------------- accumulation, bf16 mu and EMA
def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (2^-7 of its power of two; the smallest
    normal's at 0)."""
    e = np.floor(np.log2(np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _as_np(x) -> np.ndarray:
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype != np.float32 else x


@pytest.mark.parametrize("optim", [
    {"grad_accum_steps": 2, "warmup_steps": 2},
    {"grad_accum_steps": 3, "grad_clip": 1.0, "lr_schedule": "cosine", "warmup_steps": 1,
     "decay_steps": 4, "ema_dtype": "bfloat16"},
    {"grad_accum_steps": 2, "adam_mu_dtype": "bfloat16", "ema_dtype": "bfloat16"},
    {"adam_mu_dtype": "bfloat16", "lr_schedule": "linear", "warmup_steps": 1,
     "decay_steps": 5, "end_lr": 1e-4},
], ids=["accum2", "accum3-clip-bf16ema", "accum2-bf16mu-bf16ema", "bf16mu"])
def test_optimizer_and_ema_match_jax(rng, optim):
    optim = {"lr": 1e-2, "weight_decay": 0.05, "ema_decay": 0.999, **optim}
    k = optim.get("grad_accum_steps", 1)
    jtx = jax_make_optimizer(JaxConfig({"optim": optim}))
    shapes = [{"b": (4,), "w": (5, 4)}, {"w": (3, 3)}, {"w": (2, 6)}, {"b": (7,)}]
    params = tuple({key: rng.standard_normal(s).astype(np.float32) for key, s in sorted(d.items())}
                   for d in shapes)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jparams)
    jupdate = jax.jit(jtx.update)
    ema_dtype = jnp.bfloat16 if optim.get("ema_dtype") == "bfloat16" else jnp.float32
    jema = jax.tree.map(lambda p: jnp.array(p, dtype=ema_dtype), jparams)

    @jax.jit
    def jax_ema(ema, new_params, step):  # fddm_asr_tpu/train_lib.py:284-289
        decay = jnp.minimum(optim["ema_decay"], (1.0 + step) / (10.0 + step))
        return jax.tree.map(lambda e, p: e + (1.0 - decay) * (p.astype(e.dtype) - e),
                            ema, new_params)

    tparams = [torch.nn.Parameter(torch.from_numpy(d[key].copy()))
               for d in params for key in d]
    ours = TL.make_optimizer(Config({"optim": optim}), tparams)
    ema = [p.detach().to(TL.state_dtype(Config(optim), "ema_dtype"), copy=True) for p in tparams]
    for i in range(3 * k + 1):
        grads = tuple({key: (3.0 * rng.standard_normal(v.shape)).astype(np.float32)
                       for key, v in d.items()} for d in params)
        updates, jstate = jupdate(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jema = jax_ema(jema, jparams, jnp.asarray(i + 1, jnp.int32))
        before = [p.detach().clone() for p in tparams]
        norm, applied = ours.step([torch.from_numpy(g) for d in grads for g in d.values()])
        TL.update_ema(ema, tparams, optim["ema_decay"], i + 1)

        assert applied == ((i + 1) % k == 0)
        if not applied:
            assert all(torch.equal(a, b) for a, b in zip(before, tparams)), i
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        if k > 1:
            assert ours.count == int(jstate.gradient_step) == (i + 1) // k
            assert ours.mini_step == int(jstate.mini_step)
        want = jax.tree_util.tree_leaves(jparams)
        for p, w in zip(tparams, want):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-7,
                                       err_msg=f"micro-step {i}")
        for e, w in zip(ema, jax.tree_util.tree_leaves(jema)):
            assert e.dtype == (torch.bfloat16 if ema_dtype == jnp.bfloat16 else torch.float32)
            assert w.dtype == ema_dtype  # JAX's promotion keeps a bfloat16 EMA bfloat16
            got, ref = _as_np(e.float().numpy()), _as_np(w)
            if ema_dtype == jnp.bfloat16:
                assert (np.abs(got - ref) <= _bf16_ulp(ref)).all(), f"ema {i}"
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    if optim.get("adam_mu_dtype") == "bfloat16":
        jmu = [x for x in jax.tree_util.tree_leaves(jstate) if x.dtype == jnp.bfloat16]
        assert len(jmu) == len(ours.mu)
        for mu, w in zip(ours.mu, jmu):
            assert mu.dtype == torch.bfloat16
            got, ref = mu.float().numpy(), _as_np(w)
            assert (np.abs(got - ref) <= _bf16_ulp(ref)).all()
    else:
        assert all(mu.dtype == torch.float32 for mu in ours.mu)


# -------------------------------------------------------------------- remat
class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _wavlm(**overrides):
    fields = dict(num_hidden_layers=3, hidden_dropout=0.0, activation_dropout=0.0,
                  feat_proj_dropout=0.0, attention_dropout=0.0)
    cfg = dataclasses.replace(WavLMConfig.tiny_for_tests(), **{**fields, **overrides})
    torch.manual_seed(0)
    return WavLMModel(cfg).train()


def _count_calls(modules) -> list:
    """Count each module's forward calls, a recompute's too (forward hooks
    do not run there)."""
    calls = []
    for m in modules:
        def forward(*a, _f=m.forward, **k):
            calls.append(1)
            return _f(*a, **k)
        m.forward = forward
    return calls


def _grads_and_backward_matmuls(model, wav, seed=None):
    """{name: grad} of sum(out * cot), the matmuls the backward ran, the
    layers' forward calls."""
    calls = _count_calls(model.encoder.layers)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    out = model(wav, generator=gen)
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(out.shape).astype(np.float32))
    loss = (out * cot).sum()
    counter = _CountMatmuls()
    with counter:
        loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return grads, counter.n, len(calls), out.detach()


def test_dots_recomputes_no_dense_projection(rng):
    """What each policy recomputes (its gradients against JAX's are
    test_torch_wavlm_train.py::test_encoder_grads_match_jax[remat|dots])."""
    wav = torch.from_numpy(rng.standard_normal((2, 3200)).astype(np.float32))
    plain = _grads_and_backward_matmuls(_wavlm(), wav)
    full = _grads_and_backward_matmuls(_wavlm(remat_layers=True), wav)
    dots = _grads_and_backward_matmuls(_wavlm(remat_layers=True, remat_policy="dots"), wav)
    assert plain[2] == 3 and full[2] == dots[2] == 5  # layers 1 and 2 ran again
    # the dense projections: 7 a layer (the gate's, q, k, v, out and the
    # FFN's two); full remat recomputes 6 of layers 1-2's (the recompute
    # stops before the FFN's last, whose output no backward reads), dots none
    assert full[1] == plain[1] + 2 * 6
    assert dots[1] == plain[1]


def _port_decoder(params, dropout, remat_blocks):
    dec = DenoisingTransformerDecoder(40, d_model=32, nhead=4, num_layers=2, dim_ff=64,
                                      dropout=dropout, scan_blocks=True,
                                      remat_blocks=remat_blocks)
    dec.load_state_dict(decoder_state_dict_from_jax_params(params), strict=True)
    return dec.train()


def test_decoder_remat_blocks_grads_match_jax(rng):
    """model.remat_blocks: the port's decoder in training mode, its scanned
    blocks recomputed, against jax.grad of the JAX decoder built with
    remat_blocks (dropout 0: the two frameworks draw other masks): logits
    within 2e-4 (test_torch_decoder.py's tolerance), gradients within 1e-5
    of the largest.  Each block runs again in the backward.  With dropout
    0.1 the recompute replays the blocks' masks: the gradients of no remat,
    bit for bit."""
    xt = rng.integers(1, 40, (2, 12))
    t = rng.integers(1, 200, (2,))
    cond = rng.standard_normal((2, 9, 32)).astype(np.float32)
    cot = rng.standard_normal((2, 12, 40)).astype(np.float32)
    jdec = JaxDecoder(vocab_size=40, d_model=32, nhead=4, num_layers=2, dim_ff=64, dropout=0.0,
                      scan_blocks=True, remat_blocks=True)
    params = jax.jit(jdec.init)(jax.random.key(0), jnp.ones((1, 4), jnp.int32),
                                jnp.ones((1,), jnp.int32), jnp.zeros((1, 3, 32)))
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
        np.float32), params)
    tdec = _port_decoder(params, 0.0, True)

    def loss(p):
        logits = jdec.apply(p, jnp.asarray(xt), jnp.asarray(t), jnp.asarray(cond),
                            deterministic=False)
        return jnp.sum(logits * cot), logits

    (_, ref_logits), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want = decoder_state_dict_from_jax_params(jax.tree.map(np.asarray, ref_grads))
    calls = _count_calls(tdec.blocks)
    logits = tdec(torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(cond))
    (logits * torch.from_numpy(cot)).sum().backward()
    assert len(calls) == 4  # 2 blocks, each again in the backward
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=2e-4,
                               rtol=0)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, p in tdec.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5 * scale, rtol=0,
                                   err_msg=name)

    out = {}
    for remat in (False, True):
        dec = _port_decoder(params, 0.1, remat)
        torch.manual_seed(1)  # dropout's masks: the recompute draws them again
        dec(torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(cond)).square().mean(
            ).backward()
        out[remat] = {n: p.grad for n, p in dec.named_parameters() if p.grad is not None}
    for n, g in out[False].items():
        torch.testing.assert_close(out[True][n], g, rtol=0, atol=0, msg=n)


def test_remat_blocks_needs_scan_blocks():
    with pytest.raises(ValueError, match="remat_blocks requires scan_blocks") as ours:
        DenoisingTransformerDecoder(40, d_model=32, nhead=4, num_layers=1, remat_blocks=True)
    jdec = JaxDecoder(vocab_size=40, d_model=32, nhead=4, num_layers=1, dim_ff=64,
                      remat_blocks=True)
    with pytest.raises(ValueError) as theirs:
        jdec.init(jax.random.key(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1,), jnp.int32),
                  jnp.zeros((1, 3, 32)))
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------- attention dropout
def _attention_inputs(rng, B=2, L=24, H=4, dh=8):
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H * dh)).astype(np.float32))
               for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((H, L, L)).astype(np.float32))
    gate = torch.from_numpy(rng.uniform(0.5, 2.0, (B, H, L)).astype(np.float32))
    mask = torch.ones(B, L, dtype=torch.bool)
    mask[1, 17:] = False
    return q, k, v, bias, gate, mask, H


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_attention_dropout(rng, rate):
    q, k, v, bias, gate, mask, H = _attention_inputs(rng)
    gen = torch.Generator().manual_seed(3)
    out = FA.wavlm_gated_attention_dropout(q, k, v, bias, gate, mask, H, rate, gen)
    plain = FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, H)
    if rate == 0.0:
        # the JAX package's XLA path (its training attention with dropout),
        # at rate 0; the port's kernel path's plain version bit for bit
        B, L, HD = q.shape
        heads = [jnp.asarray(x.numpy().reshape(B, L, H, HD // H)) for x in (q, k, v)]
        ref = jax_dot_product_attention(
            *heads, key_mask=jnp.asarray(mask.numpy()),
            bias=jnp.asarray(gate.numpy()[..., None] * bias.numpy()[None]), dropout_rate=0.0,
            dropout_rng=jax.random.key(0))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(B, L, HD), atol=1e-5,
                                   rtol=0)
        assert torch.equal(out, plain)
        return
    assert not torch.allclose(out, plain)
    # with v = 1 each output is the kept weight of its row over (1 - rate):
    # its mean over rows is 1, its spread that of a binomial share
    ones = torch.ones_like(v)
    kept = FA.wavlm_gated_attention_dropout(q, k, ones, bias, gate, mask, H, rate,
                                            torch.Generator().manual_seed(4)) * (1 - rate)
    share = kept[..., 0].mean().item()  # one head-dim lane a (row, head)
    assert abs(share - (1 - rate)) < 0.03, share
    assert kept.min() >= 0 and kept.max() <= 1 + 1e-6


def test_attention_dropout_draws_again_under_remat(rng):
    """attention_dropout 0.1 through the layers: the same generator seed gives
    the same output and gradients with and without remat (the recomputed
    layers draw their masks from the same per-layer seeds); another seed
    another output."""
    wav = torch.from_numpy(rng.standard_normal((2, 3200)).astype(np.float32))
    plain = _grads_and_backward_matmuls(_wavlm(attention_dropout=0.1), wav, seed=11)
    remat = _grads_and_backward_matmuls(_wavlm(attention_dropout=0.1, remat_layers=True,
                                               remat_policy="dots"), wav, seed=11)
    torch.testing.assert_close(remat[3], plain[3], rtol=0, atol=0)
    for n, g in plain[0].items():
        torch.testing.assert_close(remat[0][n], g, rtol=1e-6, atol=1e-7, msg=n)
    other = _grads_and_backward_matmuls(_wavlm(attention_dropout=0.1), wav, seed=12)
    assert not torch.allclose(other[3], plain[3])
    no_drop = _grads_and_backward_matmuls(_wavlm(), wav)
    assert not torch.allclose(no_drop[3], plain[3])


# ------------------------------------------------------------ async saves
def _tiny_lora_state(corpus):  # noqa: F811
    cfg = Config(_config(corpus, "unused", model={
        **_config(corpus, "x")["model"],
        "encoder": {**_config(corpus, "x")["model"]["encoder"], "freeze": False,
                    "lora_rank": 2}}, optim={"ema_dtype": "bfloat16", "grad_accum_steps": 2}))
    pipe = FDDMPipeline.from_config(cfg, device="cpu")
    state = TL.init_train_state(pipe, cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in state.optimizer.params:
            p.add_(0.01)
    return state


def _load_all(prefix):
    out = {}
    for ext in (".state.pt", ".pt", ".encoder.pt"):
        out[ext] = torch.load(prefix + ext, map_location="cpu", weights_only=False)
    with open(prefix + ".meta.json", encoding="utf-8") as f:
        out[".meta.json"] = json.load(f)
    return out


def _assert_same(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for key in a:
            _assert_same(a[key], b[key], f"{where}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}/{i}")
    else:
        assert a == b, where


@pytest.mark.parametrize("case", ["equal", "failed-write"])
def test_async_checkpoint(corpus, tmp_path, case):  # noqa: F811
    state = _tiny_lora_state(corpus)
    writer = C.AsyncWriter()
    if case == "failed-write":
        os.makedirs(str(tmp_path / "b.state.pt"))  # os.replace cannot put a file there
        files = C.save_ckpt(str(tmp_path / "b"), state, 1, None, None, True, writer=writer)
        with pytest.raises(RuntimeError, match="asynchronous checkpoint write failed"):
            writer.wait()
        writer.wait()  # raised once; nothing pending now
        assert "b.state.pt" not in files
        assert not any(".tmp" in name for name in os.listdir(tmp_path))
        return
    sync_files = C.save_ckpt(str(tmp_path / "a"), state, 1, None, 0.5, True, ema_export=True,
                             extra_meta={"lora_rank": 2, "lora_alpha": 2.0})
    files = C.save_ckpt(str(tmp_path / "b"), state, 1, None, 0.5, True, ema_export=True,
                        extra_meta={"lora_rank": 2, "lora_alpha": 2.0}, writer=writer)
    with torch.no_grad():  # the next step may run while the thread writes
        for p in state.optimizer.params:
            p.add_(1.0)
    writer.wait()
    assert sorted(sync_files) == ["a.encoder.pt", "a.pt", "a.state.pt"]
    assert sorted(files) == ["b.encoder.pt", "b.pt", "b.state.pt"]
    assert all(f["bytes"] > 0 for f in files.values())
    _assert_same(_load_all(str(tmp_path / "a")), _load_all(str(tmp_path / "b")))
    assert not any(".tmp" in name for name in os.listdir(tmp_path))


# --------------------------------------------------------- the loop with LoRA
NARROW = r".*attention/(q_proj|v_proj)/kernel$"


def _fresh(cfg: dict):
    """A fresh state of `cfg` (its own draws) and its fine-tune step."""
    c = Config(copy.deepcopy(cfg))
    pipe = FDDMPipeline.from_config(c, device="cpu")
    state = TL.init_train_state(pipe, c, generator=torch.Generator().manual_seed(1))
    return state, TL.make_train_step(pipe, c, train_encoder=True)


def _assert_restored(state, blob):
    """`state` holds `blob`'s adapters, moments, accumulator, counts and EMA
    bit for bit, in their stored dtypes."""
    opt, saved = state.optimizer, blob["optimizer"]
    _assert_same({n: {ab: t.detach() for ab, t in ad.items()} for n, ad in state.lora.items()},
                 blob["lora"], "lora")
    _assert_same(opt.mu, [t for g in saved["groups"] for t in g["mu"]], "mu")
    _assert_same(opt.nu, [t for g in saved["groups"] for t in g["nu"]], "nu")
    _assert_same(opt.acc, saved["acc"], "acc")
    _assert_same(state.ema, blob["ema"], "ema")
    assert opt.mu[0].dtype == state.ema[0].dtype == torch.bfloat16
    assert (opt.mini_step, opt.count, opt.notfinite_count, state.step) == (
        saved["mini_step"], saved["groups"][0]["count"], saved["notfinite_count"], blob["step"])


def test_lora_recipe_loop(corpus, tmp_path):  # noqa: F811
    model = _config(corpus, "x")["model"]
    model["encoder"] = {**model["encoder"], "freeze": False, "lora_rank": 2, "lora_alpha": 6}
    recipe = dict(model=model, optim={"grad_accum_steps": 2, "adam_mu_dtype": "bfloat16",
                                      "ema_dtype": "bfloat16", "encoder_lr": 1e-2},
                  log={"async_checkpoint": True})
    cfg, summary, ckpt_dir = _train(corpus, "lora_recipe", **recipe)
    assert np.isfinite(summary["train_loss"]) and summary["val_cer"] is not None
    records = _records(ckpt_dir)
    saves = [r for r in records if r["kind"] == "checkpoint"]
    assert [r["name"] for r in saves] == ["best_model", "ep001"]
    assert all(r["asynchronous"] and r["files"] and r["blocked_seconds"] >= 0 for r in saves)
    with open(os.path.join(ckpt_dir, "ep001.meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    assert meta["lora_rank"] == 2 and meta["lora_alpha"] == 6.0 and meta["train_encoder"]
    blob = torch.load(os.path.join(ckpt_dir, "ep001.state.pt"), weights_only=True)
    assert blob["modules"]["encoder"] is None and LO.is_adapter_dict(blob["lora"])
    assert blob["optimizer"]["mini_step"] == 0 and blob["optimizer"]["acc"] is not None
    assert blob["step"] == 2 and blob["optimizer"]["groups"][0]["count"] == 1
    assert all(t.dtype == torch.bfloat16 for t in blob["ema"])
    assert all(t.dtype == torch.bfloat16 for g in blob["optimizer"]["groups"] for t in g["mu"])
    adapters = torch.load(os.path.join(ckpt_dir, "ep001.encoder.pt"), weights_only=True)
    assert LO.is_adapter_dict(adapters) and sorted(adapters) == sorted(blob["lora"])
    # the EMA's adapters (ema_eval), as float32
    names = [f"{n}.{ab}" for n, ad in blob["lora"].items() for ab in ad]
    ema = dict(zip(names, blob["ema"][-len(names):]))
    for n, ad in adapters.items():
        for ab, t in ad.items():
            assert t.dtype == torch.float32 and torch.equal(t, ema[f"{n}.{ab}"].float())
    assert any(torch.count_nonzero(ad["b"]) for ad in adapters.values())  # B trained

    # restore_state puts adapters, moments, accumulator, counts and EMA
    # back bit for bit into a fresh run's state (B = 0 there, so they moved)
    state, step = _fresh(cfg)
    assert not any(torch.count_nonzero(ad["b"]) for ad in state.lora.values())
    assert C.restore_state(state, blob)[0] == 1
    _assert_restored(state, blob)
    # ... and in the middle of an accumulation: one micro-step, saved, restored
    wav = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3200)).astype(np.float32))
    step(state, wav, np.random.default_rng(3).integers(1, 96, (2, 6)),
         generator=torch.Generator().manual_seed(4))
    assert state.optimizer.mini_step == 1 and any(torch.count_nonzero(a) for a in state.optimizer.acc)
    C.save_ckpt(str(tmp_path / "mid"), state, 1, None, None, True)
    mid = C.load_state(str(tmp_path / "mid.state.pt"))
    again, _ = _fresh(cfg)
    C.restore_state(again, mid)
    _assert_restored(again, mid)
    # a run on other layers, or without accumulation, refuses the checkpoint
    for what, changes in (("other layers", {"lora_targets": NARROW}),
                          ("accumulates gradients", {"grad_accum_steps": 1})):
        other = copy.deepcopy(cfg)
        if "lora_targets" in changes:
            other["model"]["encoder"].update(changes)
        else:
            other["optim"].update(changes)
        with pytest.raises(ValueError, match=what):
            C.restore_state(_fresh(other)[0], blob)

    # a resume to epoch 2 through the CLI
    _, resumed, _ = _train(corpus, "lora_recipe", "--resume",
                           os.path.join(ckpt_dir, "ep001.state.pt"),
                           **{**recipe, "optim": {**recipe["optim"], "num_epochs": 2}})
    assert resumed["epoch"] == 2 and np.isfinite(resumed["train_loss"])

    # the inference CLI merges the adapters into the seed's encoder at 6 / 2
    args = cli.parse_args(["--wav", "x.wav", "--ckpt", os.path.join(ckpt_dir, "ep001.pt"),
                           "--encoder-ckpt", os.path.join(ckpt_dir, "ep001.encoder.pt"),
                           "--main-config", os.path.join(str(corpus[0]), "lora_recipe.yaml"),
                           "--diffusion-config",
                           os.path.join(str(corpus[0]), "lora_recipe.yaml"),
                           "--tokenizer", cfg["data"]["tokenizer_path"], "--device", "cpu"])
    tuned = cli.build_pipeline(args).encoder.state_dict()
    base = FDDMPipeline.from_config(Config(cfg), device="cpu").encoder.state_dict()
    expect = LO.merge_lora(base, adapters, 3.0)
    assert all(torch.equal(tuned[n], expect[n]) for n in expect)
    assert sum(not torch.equal(tuned[n], base[n]) for n in base) == len(adapters)


# ------------------------------------------------------------------------ A1
def test_export_of_a_jax_lora_ema_checkpoint(corpus, tmp_path):  # noqa: F811
    from fddm_asr_tpu import sampler as JS
    from fddm_asr_tpu.checkpoint import load_checkpoint_any
    from fddm_asr_tpu.pipeline import FDDMPipeline as JaxPipeline
    from fddm_asr_tpu.train_lib import run_training as jax_run_training
    from scripts import export_torch_encoder

    model = _config(corpus, "x")["model"]
    model["encoder"] = {**model["encoder"], "freeze": False, "lora_rank": 2, "lora_alpha": 6}
    none = str(tmp_path / "none.json")
    raw = _config(corpus, "a1", model=model, data={"val_json": none, "test_json": none},
                  optim={"batch_size": 8, "encoder_lr": 1e-2, "lr": 1e-2, "ema_decay": 0.5},
                  log={"ckpt_dir": str(tmp_path / "ck")})
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(raw, f)
    # one step of 8 (the JAX mesh spans the CPU's 8 virtual devices)
    jax_run_training(JaxConfig(copy.deepcopy(raw)), raw_cfg=raw, export_pt=False,
                     max_steps_per_epoch=1)
    ckpt = str(tmp_path / "ck" / "ep001.orbax")
    enc_pt, dec_pt = str(tmp_path / "enc.pt"), str(tmp_path / "dec.pt")
    export_torch_encoder.main(["--main-config", cfg_path, "--ckpt", ckpt, "--out", enc_pt,
                               "--decoder-out", dec_pt])
    loaded = load_checkpoint_any(ckpt)
    assert loaded["meta"]["ema_eval"] and loaded["meta"]["lora_alpha"] == 6.0
    adapters = lora_adapters_from_jax(loaded["encoder"])  # the EMA's: B moved off 0
    assert any(torch.count_nonzero(ad["b"]) for ad in adapters.values())

    jp = JaxPipeline.from_config(JaxConfig(copy.deepcopy(raw)), ckpt_path=ckpt)
    tp = FDDMPipeline.from_config(Config(copy.deepcopy(raw)), ckpt_path=dec_pt,
                                  encoder_state_dict=torch.load(enc_pt, weights_only=True),
                                  device="cpu")
    rng = np.random.default_rng(0)
    wav = (0.3 * rng.standard_normal((2, 4800))).astype(np.float32)
    wav[1, 2400:] = 0.0
    c, c_mask = jp.encode_waveform(wav)
    tc, _ = tp.encode_waveform(wav)
    np.testing.assert_allclose(tc.numpy(), np.asarray(c), atol=1e-5, rtol=0)

    K, seq_len = raw["data"]["vocab_size"], 12
    x_init = rng.integers(0, K, (2, seq_len))
    scfg = JS.SamplerConfig(K=K, T_train=raw["diffusion"]["T"], T_infer=4, r=2, greedy=True,
                            posterior_mode="map")

    def decoder_apply(params, xt, t, cond, cm):
        return jp.decoder.apply(params, xt, t, cond, None, cm, deterministic=True)

    j_ids, _ = JS.make_sample_fn(decoder_apply, jp.sched, scfg)(
        jp.decoder_params, jax.random.key(0), c, seq_len, c_mask, jnp.asarray(x_init))
    rows = tp.transcribe_with_ids(wav, seq_len=seq_len, x_init=x_init, T_infer=4, r=2,
                                  greedy=True)
    np.testing.assert_array_equal(np.asarray([r[1] for r in rows]), np.asarray(j_ids))
