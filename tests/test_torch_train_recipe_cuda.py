# -*- coding: utf-8 -*-
"""The training recipe's options on the card: a LoRA fine-tune step with
gradient accumulation through the training kernels (B3, B4, B5) against the
same step with the kernels' plain versions on the card.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_train_recipe_cuda.py

A small float32 config whose WavLM heads are 64 wide (so attention takes
the kernels), two layers, LoRA rank 4, grad_accum_steps 2, the same weights,
adapters and draws on both sides.  Held as `chip_smoke.py` phase 6 holds
the fine-tune step: the first micro-step's loss terms within rtol 1e-4 and
every gradient within 1e-4 of the largest; after the second micro-step (the
update) the parameters within 1e-5 where the gradient's sign is resolved and
within 2.1 lr elsewhere.  The kernel side launches B3 2n - 1 times and B4
and B5 n times a micro-step (n layers), the plain side none; under
remat_policy "dots" the counts are the same (the attention forward is
recomputed).  attention_dropout 0.1 takes the plain path: B3 never runs.
"""
import numpy as np
import pytest
import torch

from fddm_asr_tpu_torch import train_lib as TL
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.models import wavlm as W
from fddm_asr_tpu_torch.ops import flash_attention as FA
from fddm_asr_tpu_torch.ops import kernel_wrappers
from fddm_asr_tpu_torch.pipeline import FDDMPipeline

LAYERS, B, SEQ, V = 2, 3, 16, 64
pytestmark = pytest.mark.cuda


class _Tok:
    def encode(self, text):
        return [5, 6, 7]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _config(remat_policy: str = "full", **optim) -> Config:
    return Config({
        "seed": 0,
        "data": {"vocab_size": V, "pad_id": 3, "max_len": SEQ},
        "model": {"d_model": 96, "nhead": 4, "num_layers": 1, "dim_ff": 192, "dropout": 0.0,
                  "dtype": "float32", "projector": {"d_proj": 32},
                  "encoder": {"wavlm_name": "tiny", "freeze": False, "mask_time_prob": 0.2,
                              "mask_time_length": 3, "lora_rank": 4, "lora_alpha": 8,
                              "wavlm_config": {"hidden_size": 128, "num_attention_heads": 2,
                                               "intermediate_size": 256,
                                               "num_hidden_layers": LAYERS,
                                               "hidden_dropout": 0.0, "attention_dropout": 0.0,
                                               "activation_dropout": 0.0,
                                               "remat_policy": remat_policy}}},
        "diffusion": {"T": 200, "beta_max": 0.2},
        "optim": {"batch_size": B, "lr": 1e-3, "encoder_lr": 3e-4, "weight_decay": 0.01,
                  "dtype": "float32", "ema_decay": 0.999, "grad_accum_steps": 2, **optim},
        "lfd": {"n_step_fd": 2},
    })


def _counts():
    return {k: w.launches for k, w in kernel_wrappers().items()}


def _reset():
    for w in kernel_wrappers().values():
        w.launches = 0


def _side(cfg, ref=None):
    pipe = FDDMPipeline.from_config(cfg, tokenizer=_Tok(), device="cuda")
    heads = TL.make_projection_heads(cfg, "cuda", torch.float32,
                                     torch.Generator(device="cuda").manual_seed(1))
    if ref is not None:
        pipe.decoder.load_state_dict(ref[0].decoder.state_dict())
        pipe.encoder.load_state_dict(ref[0].encoder.state_dict())
        for h, r in zip(heads, ref[1].trained_modules()[1:4]):
            h.load_state_dict(r.state_dict())
    state = TL.init_train_state(pipe, cfg, heads=heads)
    with torch.no_grad():  # B off 0, the same on both sides
        gen = torch.Generator(device="cuda").manual_seed(2)
        for ad in state.lora.values():
            ad["b"].copy_(0.1 * torch.randn(ad["b"].shape, generator=gen, device="cuda"))
    state.ema = [p.detach().to(e.dtype, copy=True) for p, e in
                 zip(state.optimizer.params, state.ema)]
    return pipe, state, TL.make_train_step(pipe, cfg, train_encoder=True)


def _draws(rng, pipe):
    wav = (0.3 * rng.standard_normal((B, 16000))).astype(np.float32)
    x0 = rng.integers(4, V, (B, SEQ))
    x0[1, 10:] = 3
    S = pipe.encoder.config.feat_extract_output_length(wav.shape[1])
    return wav, x0, {"t": rng.integers(1, 201, (B,)), "xt": rng.integers(0, V, (B, SEQ)),
                     "time_mask": rng.random((B, S)) < 0.2}


@pytest.mark.parametrize("optim", [{}, {"remat_policy": "dots", "adam_mu_dtype": "bfloat16",
                                        "ema_dtype": "bfloat16"}],
                         ids=["lora-accum2", "lora-accum2-dots-bf16-state"])
def test_lora_accumulation_step_kernels_vs_plain(cuda_device, monkeypatch, optim):
    cfg = _config(**optim)
    kernel = _side(cfg)
    plain = _side(cfg, ref=kernel)
    rng = np.random.default_rng(0)
    micro = [_draws(rng, kernel[0]) for _ in range(2)]
    plain_attention = FA.wavlm_gated_attention_plain

    def run(side, fn):
        if side is plain:
            with monkeypatch.context() as m:
                m.setattr(W, "wavlm_gated_attention_heads_packed_trainable", plain_attention)
                return fn()
        return fn()

    # each micro-step's loss and gradients, without an update
    mean = {}
    for wav, x0, draws in micro:
        grads, metrics, launches = {}, {}, {}
        for name, side in (("kernel", kernel), ("plain", plain)):
            pipe, state, step = side

            def forward():
                with step.merged(state):
                    loss, m = step.forward(state, wav, x0, True, **draws)
                    g = torch.autograd.grad(loss, state.optimizer.params, allow_unused=True)
                return m, g

            _reset()
            m, g = run(side, forward)
            torch.cuda.synchronize()
            launches[name] = _counts()
            metrics[name] = {k: float(v.detach()) for k, v in m.items()}
            grads[name] = [torch.zeros_like(p) if x is None else x
                           for p, x in zip(state.optimizer.params, g)]
        want = {"fwd_lse": 2 * LAYERS - 1, "bwd_dq": LAYERS, "bwd_dkv": LAYERS}
        assert {k: launches["kernel"][k] for k in want} == want
        assert launches["kernel"]["fwd"] == 0 and not any(launches["plain"].values())
        for k, v in metrics["plain"].items():
            assert metrics["kernel"][k] == pytest.approx(v, rel=1e-4), k
        scale = max(g.abs().max().item() for g in grads["plain"])
        for a, b in zip(grads["kernel"], grads["plain"]):
            assert (a - b).abs().max().item() <= 1e-4 * scale
        # the update's gradient: the two micro-steps' mean
        mean = {"g": [g / len(micro) + mean["g"][i] if mean else g / len(micro)
                      for i, g in enumerate(grads["plain"])]}
    scale = max(g.abs().max().item() for g in mean["g"])

    # the two micro-steps through `step`: parameters move on the second only
    for name, side in (("kernel", kernel), ("plain", plain)):
        pipe, state, step = side
        before = [p.detach().clone() for p in state.optimizer.params]
        for i, (wav, x0, draws) in enumerate(micro):
            run(side, lambda: step(state, wav, x0, True, **draws))
            moved = any(not torch.equal(a, p) for a, p in zip(before, state.optimizer.params))
            assert moved == (i == 1) and state.optimizer.count == i
        assert state.step == 2
    for i, (pk, pp, g) in enumerate(zip(kernel[1].optimizer.params, plain[1].optimizer.params,
                                        mean["g"])):
        diff = (pk.detach() - pp.detach()).abs()
        resolved = g.abs() > 2e-4 * scale
        assert diff.max().item() <= 2.1 * 1e-3
        if resolved.any():
            assert diff[resolved].max().item() <= 1e-5, i
    for ek, ep in zip(kernel[1].ema, plain[1].ema):
        assert ek.dtype == ep.dtype


def test_attention_dropout_runs_no_kernel(cuda_device):
    raw = _config().to_dict()
    raw["model"]["encoder"]["wavlm_config"]["attention_dropout"] = 0.1
    cfg = Config(raw)
    pipe, state, step = _side(cfg)
    wav, x0, draws = _draws(np.random.default_rng(1), pipe)
    _reset()
    m = step(state, wav, x0, True, generator=torch.Generator(device="cuda").manual_seed(0),
             **draws)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["total_loss"]))
    assert not any(_counts().values())
