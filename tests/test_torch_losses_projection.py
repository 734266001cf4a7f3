# -*- coding: utf-8 -*-
"""The port's L_fd loss, speech/text alignment and projection heads against
the JAX package's, float32 on the same numpy inputs and weights (carried by
the port's converters, which are also held against the JAX package's own
`projection_state_dict_from_params`).  Losses rtol 1e-5, head outputs atol
1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu.convert.torch_ckpt import projection_state_dict_from_params
from fddm_asr_tpu.losses import align_speech_to_text as jax_align
from fddm_asr_tpu.losses import lfd_loss as jax_lfd_loss
from fddm_asr_tpu.models import projection as JP
from fddm_asr_tpu_torch import losses as TLS
from fddm_asr_tpu_torch.convert import (
    projector_state_dict_from_jax_params,
    text_embedding_state_dict_from_jax_params,
)
from fddm_asr_tpu_torch.models import projection as TP


@pytest.mark.parametrize("lam", [5e-3, 0.5])
def test_lfd_loss_matches_jax(rng, lam):
    za = rng.standard_normal((4, 6, 8)).astype(np.float32)
    zb = (0.5 * za + rng.standard_normal((4, 6, 8))).astype(np.float32)
    want = jax.value_and_grad(lambda a: jax_lfd_loss(a, jnp.asarray(zb), lam))(jnp.asarray(za))
    a = torch.from_numpy(za).requires_grad_()
    got = TLS.lfd_loss(a, torch.from_numpy(zb), lam)
    (grad,) = torch.autograd.grad(got, a)
    np.testing.assert_allclose(float(got), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want[1]), atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("L", [3, 6, 10])  # cut, equal, edge-padded
def test_align_speech_to_text_matches_jax(rng, L):
    z = rng.standard_normal((2, 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(TLS.align_speech_to_text(torch.from_numpy(z), L).numpy(),
                                  np.asarray(jax_align(jnp.asarray(z), L)))


@pytest.mark.parametrize("hidden", [0, 12])
def test_projection_heads_match_jax(rng, hidden):
    d_in, d_proj, vocab = 10, 7, 30
    c = rng.standard_normal((2, 5, d_in)).astype(np.float32)
    logits = (3 * rng.standard_normal((2, 4, vocab))).astype(np.float32)
    z = rng.standard_normal((2, 4, d_proj)).astype(np.float32)
    keys = jax.random.split(jax.random.key(0), 3)
    cases = [
        (JP.SpeechProjector(d_proj, hidden), TP.SpeechProjector(d_in, d_proj, hidden), c,
         projector_state_dict_from_jax_params, "s_proj"),
        (JP.TextEmbedding(d_proj, mode="logits"), TP.TextEmbedding(vocab, d_proj), logits,
         text_embedding_state_dict_from_jax_params, "t_embed"),
        (JP.TextProjector(d_proj, hidden), TP.TextProjector(d_proj, d_proj, hidden), z,
         projector_state_dict_from_jax_params, "t_proj"),
    ]
    for (jmod, tmod, x, convert, kind), key in zip(cases, keys):
        params = jmod.init(key, jnp.asarray(x))
        params = jax.tree.map(lambda p: p + 0.1 * rng.standard_normal(p.shape), params)
        sd = convert(params)
        oracle = projection_state_dict_from_params(params["params"], kind)
        assert sorted(sd) == sorted(oracle)
        for name in sd:
            np.testing.assert_array_equal(sd[name].numpy(), oracle[name])
        tmod.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = tmod(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jmod.apply(params, jnp.asarray(x))),
                                   atol=1e-5, rtol=0, err_msg=kind)


def test_text_embedding_bf16_compute(rng):
    logits = rng.standard_normal((2, 3, 9)).astype(np.float32)
    emb = TP.TextEmbedding(9, 4, dtype=torch.bfloat16)
    with torch.no_grad():
        out = emb(torch.from_numpy(logits))
        want = torch.softmax(torch.from_numpy(logits), -1) @ emb.proj.weight.T
    assert out.dtype == torch.bfloat16 and emb.proj.weight.dtype == torch.float32
    torch.testing.assert_close(out.float(), want, atol=2e-2, rtol=0)
