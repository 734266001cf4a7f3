# -*- coding: utf-8 -*-
"""FDDMPipeline — waveform to transcript: encoder, decoder, schedule, sampler, tokenizer.

Counterpart of `fddm_asr_tpu/pipeline.py` (the single-utterance-batch
transcription path):

  encode_waveform(wave, lengths) -> (c, c_mask)
  sample(cond, seq_len, ...)     -> (ids, p_x0)
  transcribe_with_ids(wave, ...) -> [(text, ids[, confidence])]

The reference calls the encoder without lengths, so no condition mask exists
at inference; `use_condition_mask=False` (default) keeps that, True masks
padded audio frames in cross-attention.

Weights: the decoder from a reference `.pt` (`ckpt_path`), the WavLM
backbone from an HF-named state_dict (`wavlm_state_dict`), the whole
encoder (backbone and the `proj` that maps hidden_size to d_model) from an
`AcousticEncoder` state_dict (`encoder_state_dict`); whatever is not given
is drawn at random from a `torch.Generator` seeded by `seed` (default the
config's `seed`).  `torch.Generator` and `jax.random` differ, so a random
encoder here is not the JAX package's random encoder: a decoder trained by
the JAX package on a frozen encoder needs that encoder's `proj`, which no
checkpoint carries (the JAX pipeline redraws it from the config's seed);
`scripts/export_torch_encoder.py` writes it as a state_dict.

Waveforms may come as float samples or in the wire dtypes of the JAX
package's serving path (int16 pcm16, uint8 mu-law), decoded on the device.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from fddm_asr_tpu_torch import diffusion as D
from fddm_asr_tpu_torch.config import Config, resolve_device, resolve_special_ids
from fddm_asr_tpu_torch.convert import load_reference_checkpoint
from fddm_asr_tpu_torch.data.wire import decode_wire
from fddm_asr_tpu_torch.eval import batch_confidence, ids_to_text
from fddm_asr_tpu_torch.models.decoder import DenoisingTransformerDecoder, MultiheadAttention
from fddm_asr_tpu_torch.models.encoder import AcousticEncoder
from fddm_asr_tpu_torch.models.wavlm import GatedRelPosAttention, WavLMConfig, WavLMModel
from fddm_asr_tpu_torch.sampler import SamplerConfig, make_sample_fn

# WavLMConfig fields of the JAX package that choose how XLA lowers the same
# numerics and that the port ignores; a config naming them is still valid.
# (`fused_attention`: the port's attention always takes its kernels on the
# card, in both directions, and their plain versions on the CPU.)
_JAX_ONLY_WAVLM_FIELDS = {"scan_layers", "fused_attention"}


def build_wavlm_config(encoder_cfg: Config) -> WavLMConfig:
    """The reference YAML's encoder block -> WavLMConfig.

    `wavlm_name` containing "tiny" selects the test config, "base" wavlm-base,
    anything else wavlm-large with seq_pad_multiple=128 (the flagship); a
    dict under `wavlm_config` overrides field by field.  A fine-tuned
    encoder (freeze: false) defaults to remat_layers and a frozen conv
    front-end, as in the JAX package; `remat_layers` and
    `freeze_feature_extractor` in the encoder block itself override."""
    name = (encoder_cfg.get("wavlm_name") or "microsoft/wavlm-large").lower()
    if "tiny" in name:
        cfg = WavLMConfig.tiny_for_tests()
    elif "base" in name:
        cfg = WavLMConfig.base()
    else:
        cfg = dataclasses.replace(WavLMConfig.large(), seq_pad_multiple=128)
    overrides = dict(encoder_cfg.get("wavlm_config") or {})
    fields = {f.name for f in dataclasses.fields(WavLMConfig)}
    unknown = set(overrides) - fields - _JAX_ONLY_WAVLM_FIELDS
    if unknown:
        raise ValueError(f"unknown encoder.wavlm_config fields: {sorted(unknown)}")
    cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items() if k in fields})
    fine_tune = not encoder_cfg.get("freeze", True)
    for key in ("remat_layers", "freeze_feature_extractor"):
        if key in encoder_cfg:
            cfg = dataclasses.replace(cfg, **{key: bool(encoder_cfg[key])})
        elif fine_tune and key not in overrides:
            cfg = dataclasses.replace(cfg, **{key: True})
    return cfg


def _compute_dtype(name: Union[str, torch.dtype, None]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return torch.bfloat16 if str(name).lower() in ("bfloat16", "bf16") else torch.float32


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of `module` from `generator` (torch's own
    default distributions): Linear/Conv uniform(±1/sqrt(fan_in)), packed
    attention in-projections xavier-uniform with zero bias, embeddings
    N(0, 1), norms 1/0, WavLM gate constants 1; last, WavLM's
    `masked_spec_embed` uniform(0, 1) (HF's and the JAX package's init;
    drawn after everything else so the other weights of a seed stay put)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, MultiheadAttention):
            fan_out, fan_in = m.in_proj_weight.shape
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            m.in_proj_weight.uniform_(-bound, bound, generator=generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, GatedRelPosAttention):
            m.gru_rel_pos_const.fill_(1.0)
    if isinstance(module, DenoisingTransformerDecoder):
        module.tok_emb.weight[module.pad_id].zero_()
    for m in module.modules():
        if isinstance(m, WavLMModel):
            m.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)


class FDDMPipeline:
    def __init__(self, cfg: Config, decoder: DenoisingTransformerDecoder,
                 encoder: AcousticEncoder, sched: D.DiffusionSchedule, tokenizer,
                 special_ids: Dict[str, Optional[int]], device: torch.device,
                 use_condition_mask: bool = False) -> None:
        self.cfg = cfg
        self.decoder = decoder
        self.encoder = encoder
        self.sched = sched
        self.tokenizer = tokenizer
        self.special_ids = special_ids
        self.pad_id = special_ids["pad_id"]
        self.device = device
        self.use_condition_mask = use_condition_mask

    @classmethod
    def from_config(cls, cfg: Config, ckpt_path: Optional[str] = None,
                    wavlm_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                    encoder_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                    tokenizer=None, device: Optional[str] = None,
                    dtype: Union[str, torch.dtype, None] = None,
                    seed: Optional[int] = None,
                    use_condition_mask: Optional[bool] = None) -> "FDDMPipeline":
        """Build every module from one config on `device` (default CUDA;
        raises without a GPU unless device="cpu").  `dtype` defaults to the
        config's model.dtype; parameters stay float32.  `encoder_state_dict`
        (the port's `AcousticEncoder` keys, loaded strictly) is applied after
        `wavlm_state_dict`."""
        dev = resolve_device(device)
        if seed is None:
            seed = int(cfg.get("seed", 0))
        enc_cfg = cfg.model.get("encoder", Config())
        if use_condition_mask is None:
            use_condition_mask = bool(enc_cfg.get("condition_mask", False))
        dtype = _compute_dtype(dtype if dtype is not None else cfg.model.get("dtype", "float32"))
        special = resolve_special_ids(cfg)
        if tokenizer is None:
            from fddm_asr_tpu_torch.tokenizer import load_tokenizer

            tokenizer = load_tokenizer(cfg.data.get("tokenizer_path") or cfg.data.get(
                "tokenizer_model_path", "data/tokenizer/zh-TW_A/spm_zhTW_A.model"))
        sched = D.make_schedule(cfg.data.vocab_size, cfg.diffusion["T"],
                                cfg.diffusion.get("beta_max", 0.2), device=dev)
        model_cfg = cfg.model
        generator = torch.Generator(device=dev).manual_seed(seed)
        with dev:
            decoder = DenoisingTransformerDecoder(
                vocab_size=cfg.data.vocab_size, d_model=model_cfg.d_model,
                nhead=model_cfg.nhead, num_layers=model_cfg.num_layers,
                dim_ff=model_cfg.dim_ff,
                max_len=1024,  # the reference hardcodes 1024
                pad_id=special["pad_id"],
                pos_emb_type=model_cfg.get("pos_emb_type", "rope"),
                use_film=model_cfg.get("use_film", True),
                dropout=model_cfg.get("dropout", 0.1), dtype=dtype,
                quant_dense=model_cfg.get("quant_dense", "none"))
            encoder = AcousticEncoder(
                build_wavlm_config(enc_cfg), d_model=model_cfg.d_model,
                proj=enc_cfg.get("proj", "linear"),
                pooling=enc_cfg.get("pooling", "none"),
                freeze=enc_cfg.get("freeze", True), dtype=dtype)
        random_init_(decoder, generator)
        random_init_(encoder, generator)
        if ckpt_path:
            sd = load_reference_checkpoint(ckpt_path)["decoder"]
            if decoder.pos_emb_type != "rope":
                # a buffer, not a parameter: the JAX training loop's export
                # writes it for every decoder; parameter keys stay strict
                sd = {k: v for k, v in sd.items() if k != "pos_emb.inv_freq"}
            decoder.load_state_dict(sd, strict=True)
            if encoder_state_dict is None and hasattr(encoder, "proj"):
                print("FDDMPipeline: hidden_size != d_model and no encoder state_dict was "
                      "given, so the encoder projection is random from this seed and is "
                      "not the JAX package's (see scripts/export_torch_encoder.py)",
                      file=sys.stderr)
        if wavlm_state_dict is not None:
            encoder.backbone.load_state_dict(wavlm_state_dict, strict=True)
        if encoder_state_dict is not None:
            encoder.load_state_dict(encoder_state_dict, strict=True)
        decoder.eval()
        encoder.eval()
        return cls(cfg, decoder, encoder, sched, tokenizer, special, dev,
                   use_condition_mask=use_condition_mask)

    # ------------------------------------------------------------------ api
    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype, device=self.device)

    def encode_waveform(self, wave, lengths=None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """`wave` [B, T]: float samples, int16 pcm16 or uint8 mu-law codes
        (moved to the device as they are, decoded there)."""
        wave = decode_wire(self._tensor(wave))
        if not self.use_condition_mask:
            lengths = None  # reference parity: the encoder sees no lengths
        elif lengths is not None:
            lengths = self._tensor(lengths, torch.long)
        with torch.inference_mode():
            feats, feat_mask, _ = self.encoder(wave, lengths)
        return feats, feat_mask

    def sample(self, cond: torch.Tensor, seq_len: int, c_mask=None,
               generator: Optional[torch.Generator] = None, x_init=None,
               T_infer: int = 20, r: int = 5, greedy: bool = True,
               posterior_mode: str = "map", sampling_mode: str = "exact",
               temperature: float = 1.0, ref_compat: bool = True,
               repeat_penalty: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Jumpy sampling from x_T (uniform from `generator`, or `x_init`);
        returns device tensors (ids [B, seq_len], last p_x0 [B, seq_len, K])."""
        scfg = SamplerConfig(
            K=self.cfg.data.vocab_size, T_train=self.cfg.diffusion["T"],
            T_infer=T_infer, r=r, greedy=greedy, posterior_mode=posterior_mode,
            sampling_mode=sampling_mode, temperature=temperature,
            ref_compat=ref_compat, repeat_penalty=repeat_penalty)
        if not self.use_condition_mask:
            c_mask = None
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def decoder_apply(xt, t, c, cm):
            return self.decoder(xt, t, c, None, cm)

        fn = make_sample_fn(decoder_apply, self.sched, scfg)
        with torch.inference_mode():
            return fn(cond, seq_len, c_mask=c_mask, x_init=x_init, generator=generator)

    def ids_to_text(self, ids) -> str:
        return ids_to_text(ids, self.tokenizer, self.pad_id,
                           self.special_ids.get("bos_id"), self.special_ids.get("eos_id"))

    def transcribe(self, wave, lengths=None, seq_len: int = 64,
                   generator: Optional[torch.Generator] = None, **sampling) -> List[str]:
        return [row[0] for row in self.transcribe_with_ids(
            wave, lengths, seq_len=seq_len, generator=generator, **sampling)]

    def transcribe_with_ids(self, wave, lengths=None, seq_len: int = 64,
                            generator: Optional[torch.Generator] = None,
                            with_confidence: bool = False, num_candidates: int = 1,
                            x_init=None, **sampling) -> List[tuple]:
        """[(text, ids)] per utterance, or [(text, ids, confidence)] with
        `with_confidence`: the geometric mean of the final p_x0 of each
        emitted token over the decoded span (0.0 when nothing decoded)."""
        if num_candidates != 1:
            raise NotImplementedError("best-of-N decoding is not ported yet")
        wave = np.asarray(wave) if not torch.is_tensor(wave) else wave
        if wave.ndim == 1:
            wave = wave[None]
        c, c_mask = self.encode_waveform(wave, lengths)
        ids_d, p = self.sample(c, seq_len, c_mask, generator=generator, x_init=x_init,
                               **sampling)
        confs = None
        if with_confidence:
            confs = batch_confidence(ids_d, p, self.pad_id, self.special_ids).cpu().numpy()
        ids = ids_d.cpu().numpy()
        out = []
        for i in range(ids.shape[0]):
            row = (self.ids_to_text(ids[i]), ids[i].tolist())
            if confs is not None:
                row = row + (float(confs[i]),)
            out.append(row)
        return out
