# -*- coding: utf-8 -*-
"""FDDMPipeline — waveform to transcript: encoder, decoder, schedule, sampler, tokenizer.

Counterpart of `fddm_asr_tpu/pipeline.py` (the transcription paths):

  encode_waveform(wave, lengths)            -> (c, c_mask)
  decoder_forward(xt, t, c, x_mask, c_mask) -> logits
  sample(cond, seq_len, ...)                -> (ids, p_x0)
  sample_nbest(cond, seq_len, n, ...)       -> (ids [B, N, L], p_x0 [B, N, L, K])
  transcribe_with_ids(wave, ...)            -> [(text, ids[, confidence])]
  transcribe_with_ids_async(wave, ...)      -> finalize() -> the same rows
  transcribe_nbest(wave, ...)               -> [[(text, ids, confidence)] * N]

Best-of-N encodes once and folds the N candidates into the batch, rows
[u0c0, u0c1, ..., u1c0, ...] (`repeat_interleave`), with the x_T of all
B*N rows from one draw of the caller's generator; confidence is reduced on
the device and only ids and [B*N] confidences reach the host, where the
winner is `np.argmax` (ties to the first candidate).

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

Over several GPUs (`apply_mesh`, one process a GPU) the batch rows split
over the mesh's "data" ranks, and over its "model" ranks either each
utterance's encoder frames (`seq_parallel`) or the weights of the attention
heads, the FFNs and the vocabulary (tensor parallelism); the results equal
one process's.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from fddm_asr_tpu_torch import CONV_RECEPTIVE_FIELD
from fddm_asr_tpu_torch import diffusion as D
from fddm_asr_tpu_torch.config import Config, resolve_device, resolve_special_ids
from fddm_asr_tpu_torch.convert import load_reference_checkpoint
from fddm_asr_tpu_torch.data.wire import decode_wire
from fddm_asr_tpu_torch.eval import batch_confidence, ids_to_text
from fddm_asr_tpu_torch.models.decoder import DenoisingTransformerDecoder, MultiheadAttention
from fddm_asr_tpu_torch.models import lora as LO
from fddm_asr_tpu_torch.models.encoder import AcousticEncoder
from fddm_asr_tpu_torch.models.wavlm import GatedRelPosAttention, WavLMConfig, WavLMModel
from fddm_asr_tpu_torch.sampler import SamplerConfig, make_sample_fn, sampling_draws

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
    default distributions, `model.init_scheme: "torch"` for the decoder):
    Linear/Conv uniform(±1/sqrt(fan_in)), packed attention in-projections
    xavier-uniform with zero bias and the out-projections' biases zero (as
    `nn.MultiheadAttention` has them), embeddings N(0, 1), norms 1/0, WavLM
    gate constants 1; last, WavLM's `masked_spec_embed` uniform(0, 1) (HF's
    and the JAX package's init; drawn after everything else so the other
    weights of a seed stay put)."""
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
            if isinstance(m, MultiheadAttention):
                m.out_proj.bias.zero_()  # after the loop above drew it as a Linear
    for m in module.modules():
        if isinstance(m, WavLMModel):
            m.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)


# flax's lecun_normal: a normal truncated at two standard deviations, rescaled
# by the standard deviation of the unit normal so truncated (variance_scaling)
_TRUNCATED_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def flax_init_(decoder: DenoisingTransformerDecoder, generator: torch.Generator) -> None:
    """Redraw the decoder as the JAX package's flax init draws it
    (`model.init_scheme: "flax"`): dense kernels, the packed q/k/v
    in-projection included, lecun-normal (variance 1/fan_in, truncated at
    two standard deviations) with zero biases; token embeddings N(0, 1)
    with the pad row zero; a learned position table N(0, 1/d_model), flax's
    `Embed` default.  LayerNorms keep the 1/0 `random_init_` gave them."""
    def lecun_normal_(w: torch.Tensor) -> None:
        std = math.sqrt(1.0 / w.shape[1]) / _TRUNCATED_NORMAL_STD  # [out, in]: fan_in = in
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    for m in decoder.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight)
            m.bias.zero_()
        elif isinstance(m, MultiheadAttention):
            lecun_normal_(m.in_proj_weight)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.Embedding):
            std = 1.0 if m is decoder.tok_emb else 1.0 / math.sqrt(m.weight.shape[1])
            m.weight.normal_(0.0, std, generator=generator)
    decoder.tok_emb.weight[decoder.pad_id].zero_()


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
        # the wire dtype (data/wire.py) a server encodes requests in; every
        # one of them is decoded on the device by `encode_waveform`
        self.input_encoding = "f32"
        self._samplers: Dict[SamplerConfig, Callable] = {}
        # `apply_mesh`: batch rows split over the mesh's "data" ranks
        self.mesh = None
        # the whole mesh `apply_mesh` took and its model axis' use (what an
        # exported artifact records)
        self.applied_mesh = None
        self.seq_parallel = False

    @classmethod
    def from_config(cls, cfg: Config, ckpt_path: Optional[str] = None,
                    wavlm_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                    encoder_state_dict: Union[Dict[str, torch.Tensor], LO.EncoderAdapters,
                                              None] = None,
                    tokenizer=None, device: Optional[str] = None,
                    dtype: Union[str, torch.dtype, None] = None,
                    seed: Optional[int] = None,
                    use_condition_mask: Optional[bool] = None) -> "FDDMPipeline":
        """Build every module from one config on `device` (default CUDA;
        raises without a GPU unless device="cpu").  `dtype` defaults to the
        config's model.dtype; parameters stay float32.  `encoder_state_dict`
        (the port's `AcousticEncoder` keys, loaded strictly) is applied after
        `wavlm_state_dict`; a `lora.EncoderAdapters` in its place (an
        adapter-only checkpoint, `convert.load_encoder_weights`) is merged
        into the encoder those weights (or the seed) make."""
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
                quant_dense=model_cfg.get("quant_dense", "none"),
                scan_blocks=bool(model_cfg.get("scan_blocks", False)),
                remat_blocks=bool(model_cfg.get("remat_blocks", False)))
            encoder = AcousticEncoder(
                build_wavlm_config(enc_cfg), d_model=model_cfg.d_model,
                proj=enc_cfg.get("proj", "linear"),
                pooling=enc_cfg.get("pooling", "none"),
                freeze=enc_cfg.get("freeze", True), dtype=dtype)
        random_init_(decoder, generator)
        random_init_(encoder, generator)
        if not ckpt_path:
            # model.init_scheme, read as the JAX pipeline reads it: only for a
            # decoder that no checkpoint replaces
            scheme = str(model_cfg.get("init_scheme", "flax")).lower()
            if scheme == "flax":
                # a stream of its own: the encoder drawn after the torch draw
                # above stays the same under either scheme
                flax_init_(decoder, torch.Generator(device=dev).manual_seed(
                    (int(seed) + (1 << 32)) % (1 << 64)))
            elif scheme != "torch":
                raise ValueError(f"model.init_scheme={scheme!r}: expected 'flax' or 'torch'")
        else:
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
            try:
                encoder.backbone.load_state_dict(wavlm_state_dict, strict=True)
            except RuntimeError as e:
                raise ValueError(
                    "the WavLM weights do not fit the encoder model.encoder builds: config "
                    f"{_geometry(encoder.config)}, weights {_state_dict_geometry(wavlm_state_dict)}"
                    f"\n{e}") from e
        if isinstance(encoder_state_dict, LO.EncoderAdapters):
            # an adapter-only checkpoint: merged into the encoder built so
            # far (the WavLM weights given, or the seed's), at the training
            # run's alpha when its sidecar has one, else the config's
            adapters = encoder_state_dict.adapters
            alpha = encoder_state_dict.alpha
            if alpha is None:
                alpha = enc_cfg.get("lora_alpha")
            scale = LO.resolve_scale(LO.adapter_rank(adapters), alpha)
            encoder.load_state_dict(LO.merge_lora(encoder.state_dict(), adapters, scale),
                                    strict=True)
        elif encoder_state_dict is not None:
            encoder.load_state_dict(encoder_state_dict, strict=True)
        decoder.eval()
        encoder.eval()
        return cls(cfg, decoder, encoder, sched, tokenizer, special, dev,
                   use_condition_mask=use_condition_mask)

    # --------------------------------------------------------- multi-device
    def apply_mesh(self, mesh, seq_parallel: bool = False) -> "FDDMPipeline":
        """Transcribe over a `parallel.Mesh` (one process a GPU, every rank
        making the same calls): the batch rows split over "data"; over
        "model" the encoder's frames with `seq_parallel` (the ring,
        `enable_seq_parallel`, its weights whole on every rank), else the
        weights of the rules (`enable_tensor_parallel`).

        Under a data axis of D ranks the API takes and gives global batches:
        `encode_waveform` takes the global batch (B rows, B divisible by D)
        and returns this rank's B / D rows; `sample` takes those rows and
        returns theirs, with x_T and the sampling draws made for the global
        batch from the same generator on every rank (an `x_init` given is
        the global batch's), so each row gets what it gets in one process;
        `transcribe*` take the global batch and return every row, gathered
        over "data".  The "model" ranks of a data index compute the same
        rows together and return the same results."""
        self.mesh = mesh if mesh.shape["data"] > 1 else None
        self.applied_mesh, self.seq_parallel = mesh, bool(seq_parallel)
        if seq_parallel:
            self.enable_seq_parallel(mesh)
        else:
            self.enable_tensor_parallel(mesh)
        return self

    def enable_tensor_parallel(self, mesh) -> bool:
        """The decoder's and the encoder's weights of `_DECODER_RULES` split
        over the mesh's "model" ranks (`parallel/tensor.shard_module`: the
        attention heads, the FFNs' columns and rows, the vocabulary), the
        outputs summed or gathered over "model" where the layers need them
        whole; the decoder's logits leave it whole, so the sampler and the
        losses run as in one process.  Shared by `apply_mesh` and the
        training loop.  False (nothing changed) on a one-wide model axis."""
        from fddm_asr_tpu_torch.parallel import tensor as T

        if mesh.shape["model"] <= 1:
            return False
        if self.encoder.backbone.encoder.ring is not None:
            raise ValueError("the encoder is sequence-parallel over the model axis already: "
                             "a model axis is either the ring or tensor parallelism")
        T.shard_module(self.decoder, mesh)
        T.shard_module(self.encoder, mesh)
        return True

    def enable_seq_parallel(self, mesh) -> bool:
        """The encoder's layers over the mesh's "model" ranks (the ring of
        `ops/ring_attention.py`): its frames padded to a multiple of
        lcm(seq_pad_multiple, ring), each rank's layers on its block, the
        output gathered whole for the decoder, which runs replicated on the
        ring.  Shared by `apply_mesh(seq_parallel=True)` and the training loop
        (model.encoder.seq_parallel).  False (nothing changed) on a one-wide
        model axis."""
        from fddm_asr_tpu_torch.parallel.tensor import is_sharded

        if mesh.shape["model"] <= 1:
            return False
        if is_sharded(self.encoder):
            raise ValueError("the encoder is tensor-parallel over the model axis already: "
                             "a model axis is either the ring or tensor parallelism")
        self.encoder.backbone.set_ring(mesh.model_group)
        return True

    def _rows(self, x, b: int):
        """This data rank's b rows of a global-batch tensor (or array)."""
        if self.mesh is None or x is None:
            return x
        r = self.mesh.data_rank
        return x[r * b:(r + 1) * b]

    def _local_rows(self, B: int) -> int:
        """The rows of a B-row global batch that this data rank takes."""
        if self.mesh is None:
            return B
        D = self.mesh.shape["data"]
        if B % D:
            raise ValueError(f"a global batch of {B} rows does not split over {D} data ranks: "
                             f"pad it to a multiple of {D}")
        return B // D

    def _gathered(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of `x`, in rank order (global batch order)."""
        if self.mesh is None:
            return x
        from fddm_asr_tpu_torch.parallel.distributed import all_gather

        return all_gather(x, self.mesh.data_group)

    # ------------------------------------------------------------------ api
    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype, device=self.device)

    def encode_waveform(self, wave, lengths=None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """`wave` [B, T]: float samples, int16 pcm16 or uint8 mu-law codes
        (moved to the device as they are, decoded there).  T must be at
        least `CONV_RECEPTIVE_FIELD` samples: a shorter batch gives no
        encoder frame (the JAX pipeline returns NaN there), so it raises
        before any device work."""
        if np.shape(wave)[-1] < CONV_RECEPTIVE_FIELD:
            raise ValueError(
                f"a batch of {np.shape(wave)[-1]} samples is shorter than one conv receptive "
                f"field (CONV_RECEPTIVE_FIELD = {CONV_RECEPTIVE_FIELD}) and gives no encoder "
                "frame; pad it to at least that")
        if self.mesh is not None:  # this data rank's rows of the global batch
            b = self._local_rows(np.shape(wave)[0])
            wave, lengths = self._rows(wave, b), self._rows(lengths, b)
        wave = decode_wire(self._tensor(wave))
        if not self.use_condition_mask:
            lengths = None  # reference parity: the encoder sees no lengths
        elif lengths is not None:
            lengths = self._tensor(lengths, torch.long)
        with torch.inference_mode():
            feats, feat_mask, _ = self.encoder(wave, lengths)
        return feats, feat_mask

    def decoder_forward(self, xt, t, c: torch.Tensor, x_mask=None, c_mask=None
                        ) -> torch.Tensor:
        """One decoder call: [B, L] ids at [B] steps over the condition ->
        logits [B, L, K] (dropout off)."""
        with torch.inference_mode():
            return self.decoder(self._tensor(xt, torch.long), self._tensor(t, torch.long), c,
                                None if x_mask is None else self._tensor(x_mask),
                                None if c_mask is None else self._tensor(c_mask))

    def _sampler(self, scfg: SamplerConfig) -> Callable:
        if scfg not in self._samplers:
            def decoder_apply(xt, t, c, cm):
                return self.decoder(xt, t, c, None, cm)

            self._samplers[scfg] = make_sample_fn(decoder_apply, self.sched, scfg)
        return self._samplers[scfg]

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
        noise = None
        if self.mesh is not None:  # the global batch's draws, this rank's rows
            b = cond.shape[0]
            B = b * self.mesh.shape["data"]
            if x_init is None:
                x_init = torch.randint(0, scfg.K, (B, seq_len), generator=generator,
                                       device=self.device)
            draws = [torch.rand((B, seq_len), generator=generator, device=self.device)
                     for _ in range(sampling_draws(scfg))]
            x_init = self._rows(self._tensor(x_init, torch.long), b)
            noise = torch.stack([self._rows(u, b) for u in draws]) if draws else None
        with torch.inference_mode():
            return self._sampler(scfg)(cond, seq_len, c_mask=c_mask, x_init=x_init,
                                       generator=generator, noise=noise)

    def sample_nbest(self, cond: torch.Tensor, seq_len: int, num_candidates: int,
                     c_mask=None, generator: Optional[torch.Generator] = None, x_init=None,
                     **sampling) -> Tuple[torch.Tensor, torch.Tensor]:
        """`num_candidates` trajectories per utterance of an encoded batch, as
        one sample at batch B*N (rows [u0c0, u0c1, ..., u1c0, ...]; `x_init`,
        if given, is [B*N, seq_len]); device tensors ids [B, N, seq_len] and
        p_x0 [B, N, seq_len, K]."""
        n = _candidates(num_candidates)
        B = cond.shape[0]
        if n > 1:
            cond = cond.repeat_interleave(n, dim=0)
            c_mask = None if c_mask is None else c_mask.repeat_interleave(n, dim=0)
        ids, p = self.sample(cond, seq_len, c_mask, generator=generator, x_init=x_init,
                             **sampling)
        return ids.reshape(B, n, *ids.shape[1:]), p.reshape(B, n, *p.shape[1:])

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
        emitted token over the decoded span (0.0 when nothing decoded).
        `num_candidates` N > 1 keeps, per utterance, the most confident of N
        trajectories (`transcribe_nbest` gives them all)."""
        return self.transcribe_with_ids_async(
            wave, lengths, seq_len=seq_len, generator=generator,
            with_confidence=with_confidence, num_candidates=num_candidates, x_init=x_init,
            **sampling)()

    def _encode_and_sample(self, wave, lengths, seq_len, generator, n, confidence, x_init,
                           sampling) -> torch.Tensor:
        """Queue the encode and the sample (at batch B*n) and, with
        `confidence`, the per-row confidence; returns one device tensor
        [B*n, seq_len (+1)] of ids (and confidences), float64 when it holds
        both, so a single copy brings everything to the host."""
        wave = np.asarray(wave) if not torch.is_tensor(wave) else wave
        if wave.ndim == 1:
            wave = wave[None]
        c, c_mask = self.encode_waveform(wave, lengths)
        ids, p = self.sample_nbest(c, seq_len, n, c_mask, generator=generator, x_init=x_init,
                                   **sampling)
        ids, p = ids.flatten(0, 1), p.flatten(0, 1)
        if not confidence:
            return self._gathered(ids)
        conf = batch_confidence(ids, p, self.pad_id, self.special_ids)
        return self._gathered(torch.cat([ids.double(), conf.double()[:, None]], dim=1))

    def transcribe_with_ids_async(self, wave, lengths=None, seq_len: int = 64,
                                  generator: Optional[torch.Generator] = None,
                                  with_confidence: bool = False, num_candidates: int = 1,
                                  x_init=None, **sampling) -> Callable[[], List[tuple]]:
        """`transcribe_with_ids` in two phases: queues the encode, the sample
        and the confidence on the device and returns at once with a
        `finalize()` that makes the one device-to-host copy and builds the
        rows; nothing in between waits for the device."""
        n = _candidates(num_candidates)
        out = self._encode_and_sample(wave, lengths, seq_len, generator, n,
                                      with_confidence or n > 1, x_init, sampling)

        def finalize() -> List[tuple]:
            host = out.cpu().numpy()
            ids = host[:, :seq_len].astype(np.int64)
            confs = host[:, seq_len] if host.shape[1] > seq_len else None
            rows = []
            for i in range(ids.shape[0] // n):
                k = i * n + (int(np.argmax(confs[i * n:(i + 1) * n])) if n > 1 else 0)
                row = (self.ids_to_text(ids[k]), ids[k].tolist())
                if with_confidence:
                    row = row + (float(confs[k]),)
                rows.append(row)
            return rows

        return finalize

    def transcribe_nbest(self, wave, lengths=None, seq_len: int = 64,
                         generator: Optional[torch.Generator] = None,
                         num_candidates: int = 4, x_init=None,
                         **sampling) -> List[List[Tuple[str, List[int], float]]]:
        """Per utterance, its `num_candidates` trajectories as (text, ids,
        confidence), most confident first (a stable sort: ties keep the
        candidates' order)."""
        n = _candidates(num_candidates)
        host = self._encode_and_sample(wave, lengths, seq_len, generator, n, True, x_init,
                                       sampling).cpu().numpy()
        ids = host[:, :seq_len].astype(np.int64)
        out = []
        for i in range(ids.shape[0] // n):
            cands = [(self.ids_to_text(ids[k]), ids[k].tolist(), float(host[k, seq_len]))
                     for k in range(i * n, (i + 1) * n)]
            cands.sort(key=lambda cand: cand[2], reverse=True)
            out.append(cands)
        return out


def _geometry(c: WavLMConfig) -> str:
    return (f"hidden {c.hidden_size}, {c.num_hidden_layers} layers, ff "
            f"{c.intermediate_size}, {c.num_attention_heads} heads, conv {list(c.conv_dim)}")


def _state_dict_geometry(sd: Dict[str, torch.Tensor]) -> str:
    """The shape facts a WavLM state_dict carries, in `_geometry`'s words."""
    def dim(key, axis=0):
        return tuple(sd[key].shape)[axis] if key in sd else "?"

    layers = {k.split(".")[2] for k in sd if k.startswith("encoder.layers.")}
    convs = sorted(int(k.split(".")[2]) for k in sd
                   if k.startswith("feature_extractor.conv_layers.") and k.endswith("conv.weight"))
    heads = dim("encoder.layers.0.attention.rel_attn_embed.weight", 1)
    return (f"hidden {dim('feature_projection.projection.weight')}, {len(layers)} layers, ff "
            f"{dim('encoder.layers.0.feed_forward.intermediate_dense.weight')}, {heads} heads, "
            f"conv {[dim(f'feature_extractor.conv_layers.{i}.conv.weight') for i in convs]}")


def _candidates(num_candidates) -> int:
    n = int(num_candidates)
    if n < 1:
        raise ValueError(f"num_candidates must be >= 1, got {n}")
    return n
