# -*- coding: utf-8 -*-
"""A pretrained WavLM from a local Hugging Face directory in the port
(`fddm_asr_tpu_torch.convert.load_pretrained_wavlm`, `--wavlm-ckpt`), read
without `transformers` or `safetensors`: a tiny random
`transformers.WavLMModel` is saved both ways (model.safetensors and
pytorch_model.bin); the port's safetensors reader gives exactly what
`safetensors.torch.load_file` gives; the pipeline built on those weights
encodes as the JAX encoder built from the JAX package's
`load_pretrained_wavlm` (atol 1e-5, f32); a config whose geometry
disagrees with the weights raises naming both."""
import json
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu.convert.wavlm_convert import load_pretrained_wavlm as jax_load_pretrained
from fddm_asr_tpu.models.wavlm import WavLMModel as JaxWavLMModel
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.convert import (load_pretrained_wavlm, load_wavlm, read_safetensors,
                                        wavlm_state_dict_from_hf)
from fddm_asr_tpu_torch.models.wavlm import WavLMConfig
from fddm_asr_tpu_torch.pipeline import FDDMPipeline

T = 6400
CFG = {
    "seed": 0,
    "data": {"vocab_size": 40, "pad_id": 3, "bos_id": 1, "eos_id": 2},
    "model": {"d_model": 32, "nhead": 4, "num_layers": 1, "dim_ff": 64, "dtype": "float32",
              "encoder": {"wavlm_name": "tiny", "proj": "linear"}},
    "diffusion": {"T": 200, "beta_max": 0.2},
}


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    from transformers import WavLMConfig as HFConfig
    from transformers import WavLMModel as HFModel

    torch.manual_seed(0)
    hf = HFModel(HFConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=[16] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
        conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True, num_buckets=32,
        max_bucket_distance=80, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4))
    with torch.no_grad():  # move norms and biases off their init
        for p in hf.parameters():
            p.add_(0.05 * torch.randn_like(p))
    root = tmp_path_factory.mktemp("hf")
    dirs = {}
    for safe in (True, False):
        d = root / ("safetensors" if safe else "bin")
        hf.save_pretrained(str(d), safe_serialization=safe)
        dirs[safe] = str(d)
    return hf, dirs


def test_both_formats_load_the_same_tensors(hf_dirs):
    from safetensors.torch import load_file

    hf, dirs = hf_dirs
    assert sorted(p.name for p in pathlib.Path(dirs[True]).iterdir()) == [
        "config.json", "model.safetensors"]
    assert (pathlib.Path(dirs[False]) / "pytorch_model.bin").exists()
    raw = read_safetensors(dirs[True] + "/model.safetensors")
    want = load_file(dirs[True] + "/model.safetensors")
    assert raw.keys() == want.keys()
    for k in want:
        assert raw[k].dtype == want[k].dtype and torch.equal(raw[k], want[k]), k
    cfg_st, sd_st = load_pretrained_wavlm(dirs[True])
    cfg_bin, sd_bin = load_pretrained_wavlm(dirs[False])
    assert cfg_st == cfg_bin == WavLMConfig.tiny_for_tests()
    expect = wavlm_state_dict_from_hf(hf.state_dict())
    for sd in (sd_st, sd_bin):
        assert sd.keys() == expect.keys()
        for k in expect:
            torch.testing.assert_close(sd[k], expect[k], rtol=0, atol=0)


def test_safetensors_reader_takes_every_dtype_and_checks_sizes(tmp_path):
    from safetensors.torch import save_file

    tensors = {"f64": torch.randn(3, dtype=torch.float64), "bf16": torch.randn(2, 3).bfloat16(),
               "f16": torch.randn(4).half(), "i64": torch.arange(5),
               "i8": torch.tensor([-3, 7], dtype=torch.int8),
               "u8": torch.tensor([255], dtype=torch.uint8), "b": torch.tensor([True, False]),
               "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
    header = json.dumps({"x": {"dtype": "F64", "shape": [3], "data_offsets": [0, 12]}}).encode()
    (tmp_path / "bad.safetensors").write_bytes(struct.pack("<Q", len(header)) + header
                                               + bytes(12))
    with pytest.raises(ValueError, match="holds 12 bytes"):
        read_safetensors(str(tmp_path / "bad.safetensors"))


def test_pipeline_encoder_on_hf_weights_matches_jax(hf_dirs, rng):
    """The YAML's geometry (tiny, hidden 32 = d_model: no projection), the
    weights from the directory: the port pipeline's condition equals the JAX
    WavLM's output on the JAX package's own load of the same directory."""
    _, dirs = hf_dirs
    wav = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
    jcfg, jparams = jax_load_pretrained(dirs[True])
    ref = np.asarray(jax.jit(JaxWavLMModel(jcfg).apply)({"params": jparams}, jnp.asarray(wav)))
    for safe in (True, False):
        tp = FDDMPipeline.from_config(Config(CFG), tokenizer=object(), device="cpu",
                                      wavlm_state_dict=load_wavlm(dirs[safe]))
        feats, _ = tp.encode_waveform(wav)
        assert feats.shape == ref.shape
        np.testing.assert_allclose(feats.numpy(), ref, atol=1e-5, rtol=0)


def test_geometry_from_the_yaml_that_disagrees_raises(hf_dirs):
    _, dirs = hf_dirs
    cfg = Config(CFG).updated({"model": {"encoder": {"wavlm_config": {
        "hidden_size": 64, "intermediate_size": 128}}}})
    with pytest.raises(ValueError, match=r"config hidden 64, 2 layers, ff 128.*"
                                         r"weights hidden 32, 2 layers, ff 64"):
        FDDMPipeline.from_config(cfg, tokenizer=object(), device="cpu",
                                 wavlm_state_dict=load_wavlm(dirs[False]))


def test_a_directory_that_is_not_hf_raises_naming_the_export(tmp_path):
    (tmp_path / "checkpoint_0").mkdir()
    with pytest.raises(NotImplementedError, match="scripts/export_torch_encoder.py"):
        load_wavlm(str(tmp_path))
