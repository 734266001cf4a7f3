# -*- coding: utf-8 -*-
"""The port's denoising decoder against the JAX package's at the same weights.

JAX parameter trees go through the port's converter into the port's
reference-named state_dict (loaded with strict=True); logits must agree at
atol 2e-4 in float32, the JAX package's own decoder parity tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu.convert.torch_ckpt import (
    decoder_state_dict_from_params,
    save_reference_checkpoint,
)
from fddm_asr_tpu.models.decoder import DenoisingTransformerDecoder as JaxDecoder
from fddm_asr_tpu_torch.convert import (
    decoder_state_dict_from_jax_params,
    load_reference_checkpoint,
)
from fddm_asr_tpu_torch.models.decoder import DenoisingTransformerDecoder

V, D, H, LAYERS, FF = 50, 32, 4, 2, 64
B, L, S = 2, 10, 13
PAD = 3
ATOL = 2e-4


def _inputs(rng):
    xt = rng.integers(0, V, (B, L))
    xt[0, -2:] = PAD  # pad tail: the auto x_mask path
    t = rng.integers(1, 200, (B,))
    cond = rng.standard_normal((B, S, D)).astype(np.float32)
    c_mask = np.ones((B, S), bool)
    c_mask[1, -4:] = False
    return xt, t, cond, c_mask


def _jax_decoder(pos_emb_type, use_film, scan_blocks, rng_seed=0):
    dec = JaxDecoder(vocab_size=V, d_model=D, nhead=H, num_layers=LAYERS, dim_ff=FF,
                     max_len=64, pad_id=PAD, pos_emb_type=pos_emb_type,
                     use_film=use_film, scan_blocks=scan_blocks)
    params = jax.jit(dec.init)(jax.random.key(rng_seed), jnp.zeros((1, 4), jnp.int32),
                      jnp.ones((1,), jnp.int32), jnp.zeros((1, 3, D)))
    return dec, params


def _port_decoder(pos_emb_type, use_film, params):
    dec = DenoisingTransformerDecoder(V, D, H, LAYERS, FF, max_len=64, pad_id=PAD,
                                      pos_emb_type=pos_emb_type, use_film=use_film)
    dec.load_state_dict(decoder_state_dict_from_jax_params(params, pos_emb_type), strict=True)
    return dec.eval()


def _logits_both(jdec, params, tdec, inputs, with_c_mask=True):
    xt, t, cond, c_mask = inputs
    cm = c_mask if with_c_mask else None
    ref = np.asarray(jax.jit(jdec.apply)(params, jnp.asarray(xt), jnp.asarray(t),
                                         jnp.asarray(cond), None,
                                         None if cm is None else jnp.asarray(cm)))
    with torch.no_grad():  # the decoder records autograd unless told not to
        out = tdec(torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(cond), None,
                   None if cm is None else torch.from_numpy(cm)).numpy()
    return out, ref


@pytest.mark.parametrize("pos_emb_type,use_film,scan_blocks", [
    (pos, film, False) for pos in ("rope", "sinusoidal", "learned") for film in (True, False)
] + [("rope", True, True), ("learned", False, True)])
def test_logits_match_jax(rng, pos_emb_type, use_film, scan_blocks):
    jdec, params = _jax_decoder(pos_emb_type, use_film, scan_blocks)
    tdec = _port_decoder(pos_emb_type, use_film, params)
    out, ref = _logits_both(jdec, params, tdec, _inputs(rng))
    assert out.dtype == np.float32 and out.shape == (B, L, V)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_converter_matches_the_jax_package_converter():
    _, params = _jax_decoder("rope", True, scan_blocks=True)
    ours = decoder_state_dict_from_jax_params(params, "rope")
    theirs = decoder_state_dict_from_params(params["params"], "rope")
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)


def test_reference_checkpoint_loads_strict(rng, tmp_path):
    jdec, params = _jax_decoder("rope", True, scan_blocks=False)
    path = str(tmp_path / "ref.pt")
    save_reference_checkpoint(path, params["params"], epoch=3, step=7)
    loaded = load_reference_checkpoint(path)
    assert (loaded["epoch"], loaded["step"]) == (3, 7)
    tdec = DenoisingTransformerDecoder(V, D, H, LAYERS, FF, max_len=64, pad_id=PAD)
    tdec.load_state_dict(loaded["decoder"], strict=True)
    out, ref = _logits_both(jdec, params, tdec.eval(), _inputs(rng))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_pad_row_and_all_pad_row(rng):
    """The pad embedding row is masked on the output side (a nonzero table
    row changes nothing), and an all-pad row gives finite logits equal to
    the JAX package's."""
    jdec, params = _jax_decoder("rope", True, scan_blocks=False)
    emb = np.array(params["params"]["tok_emb"]["embedding"])
    emb[PAD] = 5.0
    params = jax.tree.map(lambda x: x, params)
    params["params"]["tok_emb"]["embedding"] = jnp.asarray(emb)
    tdec = _port_decoder("rope", True, params)
    xt, t, cond, c_mask = _inputs(rng)
    xt[1] = PAD
    out, ref = _logits_both(jdec, params, tdec, (xt, t, cond, c_mask), with_c_mask=False)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_int8_decoder_matches_jax_and_differs_from_full_precision(rng):
    """`quant_dense="int8"` against the JAX decoder under the same flag at
    the same weights.  Tolerance 2e-4, the file's own: the integers are
    identical wherever the f32 inputs to a quantization agree to the last
    bit of the rounding, and the products are exact.  The packed
    in-projection is quantized slice by slice, as JAX's three denses are."""
    jdec, params = _jax_decoder("rope", True, scan_blocks=False)
    jq = JaxDecoder(vocab_size=V, d_model=D, nhead=H, num_layers=LAYERS, dim_ff=FF,
                    max_len=64, pad_id=PAD, quant_dense="int8")
    inputs = _inputs(rng)
    full, _ = _logits_both(jdec, params, _port_decoder("rope", True, params), inputs)
    tq = DenoisingTransformerDecoder(V, D, H, LAYERS, FF, max_len=64, pad_id=PAD,
                                     quant_dense="int8")
    tq.load_state_dict(decoder_state_dict_from_jax_params(params, "rope"), strict=True)
    out, ref = _logits_both(jq, params, tq.eval(), inputs)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    rel = np.linalg.norm(out - full) / np.linalg.norm(full)
    assert 1e-6 < rel < 0.05
    xt, t, cond, _ = inputs
    with pytest.raises(RuntimeError, match="inference only"):
        tq(torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(cond))
    with pytest.raises(ValueError, match="quant_dense"):
        DenoisingTransformerDecoder(V, D, H, LAYERS, FF, quant_dense="int8_fused")
