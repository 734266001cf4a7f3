# -*- coding: utf-8 -*-
"""Weights into the port's modules: JAX parameter trees, HF WavLM, reference `.pt`.

Counterpart of `fddm_asr_tpu/convert/torch_ckpt.py` and
`fddm_asr_tpu/convert/wavlm_convert.py`, in the other direction: JAX
parameter trees (nested dicts of numpy arrays) become the port's
`state_dict`s.  Layouts: a flax Dense kernel is [in, out] (torch Linear
[out, in]); a flax Conv kernel is [k, in/groups, out] (torch Conv1d
[out, in/groups, k]).  Scanned trees (`layers_scan` / `blocks_scan`) hold
layers stacked on a leading axis and are unstacked here.

A pretrained WavLM comes from a local Hugging Face directory
(`load_pretrained_wavlm`: `config.json` with `pytorch_model.bin` or
`model.safetensors`), read without `transformers` or `safetensors`.

The int8 and fused-front-end options (`quant_dense`, `fused_frontend`)
change no parameter, in the JAX package or here: weights are quantized on
the fly from the same `nn.Linear` / `Conv1d` tensors, so a quantized model
takes the state_dict these functions make for the full-precision one, and
no function here knows of the options (`tests/test_torch_wavlm.py` loads
one into the other with `strict=True`).
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from fddm_asr_tpu_torch.models import lora as LO
from fddm_asr_tpu_torch.models.wavlm import WavLMConfig

StateDict = Dict[str, torch.Tensor]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":  # e.g. ml_dtypes bfloat16
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _dense(p: Mapping[str, Any], prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _tensor(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _tensor(p["bias"])


def _conv(p: Mapping[str, Any], prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _tensor(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    if "bias" in p:
        out[f"{prefix}.bias"] = _tensor(p["bias"])


def _norm(p: Mapping[str, Any], prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _tensor(p["scale"])
    out[f"{prefix}.bias"] = _tensor(p["bias"])


def _unstack(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """Layer i of a tree whose leaves are stacked on a leading axis."""
    return {k: _unstack(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def _unwrap(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if "params" in params and len(params) == 1 else params


def _layers(tree: Mapping[str, Any], first: str, scan: str, inner: str):
    """[(index, layer tree)] from unrolled `{first}{i}` or stacked `{scan}`."""
    out = [(int(k[len(first):]), v) for k, v in tree.items()
           if k.startswith(first) and k[len(first):].isdigit()]
    if scan in tree:
        stacked = tree[scan][inner]
        n = len(np.asarray(next(iter(_leaves(stacked)))))
        start = len(out)  # the encoder scans layers 1..N-1, the decoder 0..N-1
        out += [(start + i, _unstack(stacked, i)) for i in range(n)]
    return sorted(out, key=lambda kv: kv[0])


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v


# ------------------------------------------------------------------- WavLM
def wavlm_state_dict_from_jax_params(params: Mapping[str, Any]) -> StateDict:
    """JAX `WavLMModel` params (unrolled `layers_i` or stacked `layers_scan`)
    -> the port's `WavLMModel` state_dict (HF names)."""
    p = _unwrap(params)
    sd: StateDict = {}
    fe = p["feature_extractor"]
    for name, layer in fe.items():
        i = int(name.rsplit("_", 1)[1])
        prefix = f"feature_extractor.conv_layers.{i}"
        _conv(layer["conv"], f"{prefix}.conv", sd)
        if "layer_norm" in layer:
            _norm(layer["layer_norm"], f"{prefix}.layer_norm", sd)
    _norm(p["feature_projection"]["layer_norm"], "feature_projection.layer_norm", sd)
    _dense(p["feature_projection"]["projection"], "feature_projection.projection", sd)
    enc = p["encoder"]
    _conv(enc["pos_conv_embed"]["conv"], "encoder.pos_conv_embed.conv", sd)
    _norm(enc["layer_norm"], "encoder.layer_norm", sd)
    for i, layer in _layers(enc, "layers_", "layers_scan", "layer"):
        prefix = f"encoder.layers.{i}"
        attn = layer["attention"]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj", "gru_rel_pos_linear"):
            _dense(attn[proj], f"{prefix}.attention.{proj}", sd)
        sd[f"{prefix}.attention.gru_rel_pos_const"] = _tensor(attn["gru_rel_pos_const"])
        if "rel_attn_embed" in attn:
            sd[f"{prefix}.attention.rel_attn_embed.weight"] = _tensor(
                attn["rel_attn_embed"]["embedding"])
        _norm(layer["layer_norm"], f"{prefix}.layer_norm", sd)
        _norm(layer["final_layer_norm"], f"{prefix}.final_layer_norm", sd)
        ff = layer["feed_forward"]
        _dense(ff["intermediate_dense"], f"{prefix}.feed_forward.intermediate_dense", sd)
        _dense(ff["output_dense"], f"{prefix}.feed_forward.output_dense", sd)
    sd["masked_spec_embed"] = _tensor(p["masked_spec_embed"])
    return sd


def acoustic_encoder_state_dict_from_jax_params(params: Mapping[str, Any]) -> StateDict:
    """JAX `AcousticEncoder` params ({backbone, [proj]}) -> the port's
    `AcousticEncoder` state_dict."""
    p = _unwrap(params)
    sd = {f"backbone.{k}": v for k, v in
          wavlm_state_dict_from_jax_params(p["backbone"]).items()}
    if "proj" in p:
        _dense(p["proj"], "proj", sd)
    return sd


# ------------------------------------------------------------ LoRA adapters
# a list's entry in a flax path ("layers_3") and the encoder's scanned stack
_LIST_ENTRY = re.compile(r"^(layers|conv_layers)_(\d+)$")


def _flat_adapters(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Dict[str, Any]]:
    """The JAX package's flat {"path/kernel": {"a", "b"}} adapter dict from
    itself or from its nested form (`lora.normalize_adapter_tree`: every
    leaf path ends in "a" or "b", paired per kernel)."""
    flat: Dict[str, Dict[str, Any]] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping) and set(value) == {"a", "b"} and not any(
                isinstance(v, Mapping) for v in value.values()):
            flat[path] = dict(value)
        elif isinstance(value, Mapping):
            flat.update(_flat_adapters(value, path))
        else:
            raise ValueError(f"not a LoRA adapter tree: leaf {path!r} does not end in 'a' or 'b'")
    return flat


def lora_adapters_from_jax(adapters: Mapping[str, Any]) -> LO.Adapters:
    """The JAX package's LoRA adapters of an `AcousticEncoder`
    ({"params/backbone/encoder/layers_0/attention/q_proj/kernel": {"a": [d_in,
    r], "b": [r, d_out]}}, or the nested form orbax restores without a
    template) -> the port's {"backbone.encoder.layers.0.attention.q_proj":
    {"a", "b"}}, same orientation.  A scanned stack (`layers_scan/layer/...`,
    [N-1, d_in, r] and [N-1, r, d_out]) is unstacked into layers 1..N-1."""
    out: LO.Adapters = {}
    for path, ad in _flat_adapters(adapters).items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if parts[-1] != "kernel":
            raise ValueError(f"LoRA adapter path {path!r} is not a kernel's")
        parts = parts[:-1]
        if "layers_scan" in parts:
            i = parts.index("layers_scan")
            if parts[i + 1:i + 2] != ["layer"]:
                raise ValueError(f"LoRA adapter path {path!r}: expected layers_scan/layer/...")
            a, b = np.asarray(ad["a"]), np.asarray(ad["b"])
            for j in range(a.shape[0]):  # the scan holds layers 1..N-1
                name = ".".join(parts[:i] + ["layers", str(1 + j)] + parts[i + 2:])
                out[_module_name(name)] = {"a": _tensor(a[j]), "b": _tensor(b[j])}
        else:
            out[_module_name(".".join(parts))] = {"a": _tensor(ad["a"]), "b": _tensor(ad["b"])}
    return out


def _module_name(dotted: str) -> str:
    parts = []
    for part in dotted.split("."):
        m = _LIST_ENTRY.match(part)
        parts += [m.group(1), m.group(2)] if m else [part]
    return ".".join(parts)


def wavlm_state_dict_from_hf(sd: Mapping[str, Any]) -> StateDict:
    """A `transformers.WavLMModel` state_dict -> the port's: the positional
    conv's weight norm (g, v over dims 0 and 1) is folded into a plain
    weight, and a missing `masked_spec_embed` (HF creates it only for
    SpecAugment) becomes zeros."""
    out = {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}
    prefix = "encoder.pos_conv_embed.conv"
    for g_key, v_key in ((f"{prefix}.parametrizations.weight.original0",
                          f"{prefix}.parametrizations.weight.original1"),
                         (f"{prefix}.weight_g", f"{prefix}.weight_v")):
        if g_key in out:
            g = out.pop(g_key).double()
            v = out.pop(v_key)
            norm = v.double().pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
            out[f"{prefix}.weight"] = (g * v.double() / norm.clamp(min=1e-12)).to(v.dtype)
    if "masked_spec_embed" not in out:
        out["masked_spec_embed"] = torch.zeros(out["feature_projection.projection.bias"].shape)
    return out


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> StateDict:
    """A `.safetensors` file -> {name: tensor} on the CPU.  The format: an
    8-byte little-endian header length, a JSON header naming each tensor's
    dtype, shape and [begin, end) byte offsets into the data that follows
    (plus an optional `__metadata__`), then the data, little-endian.  The
    tensors share one buffer read from the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        f.readinto(data)
    out: StateDict = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(_SAFETENSORS_DTYPES)}")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: tensor {name!r} holds {end - begin} bytes, "
                             f"not those of {shape} {info['dtype']}")
        out[name] = (torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
                     .reshape(shape) if count else torch.empty(shape, dtype=dtype))
    return out


def load_pretrained_wavlm(path: str) -> Tuple[WavLMConfig, StateDict]:
    """A local Hugging Face WavLM directory -> (WavLMConfig from its
    `config.json`, the port's WavLMModel state_dict).  Weights come from
    `model.safetensors` or `pytorch_model.bin` (`torch.load` with
    weights_only); a checkpoint of a model around WavLM (keys under
    `wavlm.`) gives its WavLM part."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        config = WavLMConfig.from_hf(json.load(f))
    st_path = os.path.join(path, "model.safetensors")
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st_path):
        sd = read_safetensors(st_path)
    elif os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{path} holds neither model.safetensors nor "
                                "pytorch_model.bin")
    if any(k.startswith("wavlm.") for k in sd):
        sd = {k[len("wavlm."):]: v for k, v in sd.items() if k.startswith("wavlm.")}
    return config, wavlm_state_dict_from_hf(sd)


def load_wavlm(path: str) -> StateDict:
    """The WavLM state_dict of a local Hugging Face directory.  The JAX
    CLI's other source, an orbax checkpoint, needs JAX to read: there the
    encoder crosses over as a state_dict (scripts/export_torch_encoder.py
    --wavlm-ckpt, then --encoder-ckpt)."""
    if not os.path.isfile(os.path.join(path, "config.json")):
        raise NotImplementedError(
            f"--wavlm-ckpt {path}: not a Hugging Face WavLM directory (config.json with "
            "model.safetensors or pytorch_model.bin); an orbax checkpoint needs JAX to "
            "read: write the encoder with scripts/export_torch_encoder.py --wavlm-ckpt where "
            "JAX is and pass it as --encoder-ckpt")
    return load_pretrained_wavlm(path)[1]


def add_encoder_weight_args(parser) -> None:
    """`--encoder-ckpt` and `--wavlm-ckpt`, as the inference, export and
    serving CLIs take them (read by `load_encoder_weights`)."""
    parser.add_argument(
        "--encoder-ckpt", type=str, default=None,
        help=".pt of the port's AcousticEncoder state_dict (backbone and proj), "
             "e.g. from scripts/export_torch_encoder.py, applied after --wavlm-ckpt; or "
             "a LoRA run's adapter-only {prefix}.encoder.pt, merged into the "
             "--wavlm-ckpt (or seed) encoder at its sidecar's lora_alpha")
    parser.add_argument(
        "--wavlm-ckpt", type=str, default=None,
        help="local Hugging Face WavLM directory (config.json with "
             "model.safetensors or pytorch_model.bin); default: random from "
             "the config's seed")


def load_encoder_weights(wavlm_ckpt: Optional[str], encoder_ckpt: Optional[str]
                         ) -> Tuple[Optional[StateDict],
                                    Union[StateDict, LO.EncoderAdapters, None]]:
    """(wavlm_state_dict, encoder weights) for `FDDMPipeline.from_config`
    from the `--wavlm-ckpt` directory and the `--encoder-ckpt` file, None for
    a flag not given.  An encoder file that holds LoRA adapters (a LoRA
    run's `{prefix}.encoder.pt`) comes back as `lora.EncoderAdapters` with
    the lora_alpha of its `{prefix}.meta.json` sidecar, and `from_config`
    merges it into the encoder the WavLM weights (or the seed) make.  A
    missing or unreadable file raises here, one whose tensors do not fit the
    config's encoder in `from_config`: never the seed's encoder in its
    place."""
    wavlm_sd = load_wavlm(wavlm_ckpt) if wavlm_ckpt else None
    encoder_sd = (torch.load(encoder_ckpt, map_location="cpu", weights_only=True)
                  if encoder_ckpt else None)
    if LO.is_adapter_dict(encoder_sd):
        alpha = None
        if encoder_ckpt.endswith(".encoder.pt"):
            sidecar = encoder_ckpt[:-len(".encoder.pt")] + ".meta.json"
            if os.path.exists(sidecar):
                with open(sidecar, encoding="utf-8") as f:
                    alpha = json.load(f).get("lora_alpha")
        encoder_sd = LO.EncoderAdapters(encoder_sd, alpha)
    return wavlm_sd, encoder_sd


# ----------------------------------------------------------------- decoder
def _mha(a: Mapping[str, Any], prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.in_proj_weight"] = _tensor(np.concatenate(
        [np.asarray(a[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")], 0))
    sd[f"{prefix}.in_proj_bias"] = _tensor(np.concatenate(
        [np.asarray(a[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")], 0))
    _dense(a["out_proj"], f"{prefix}.out_proj", sd)


def decoder_state_dict_from_jax_params(params: Mapping[str, Any],
                                       pos_emb_type: str = "rope",
                                       rope_base: float = 10000.0) -> StateDict:
    """JAX `DenoisingTransformerDecoder` params (unrolled `blocks_i` or
    stacked `blocks_scan`) -> reference-format state_dict."""
    p = _unwrap(params)
    sd: StateDict = {"tok_emb.weight": _tensor(p["tok_emb"]["embedding"])}
    _dense(p["time_emb"]["mlp_0"], "time_emb.mlp.0", sd)
    _dense(p["time_emb"]["mlp_2"], "time_emb.mlp.2", sd)
    _dense(p["time_proj"], "time_proj", sd)
    _dense(p["head"], "head", sd)
    d_model = sd["time_proj.weight"].shape[0]
    if pos_emb_type == "rope":
        sd["pos_emb.inv_freq"] = _tensor(
            1.0 / (rope_base ** (np.arange(0, d_model, 2, dtype=np.float32) / d_model)))
    elif pos_emb_type == "learned":
        sd["pos_emb.weight"] = _tensor(p["pos_emb"]["embedding"])
    for i, blk in _layers(p, "blocks_", "blocks_scan", "block"):
        prefix = f"blocks.{i}"
        _mha(blk["self_attn"], f"{prefix}.self_attn", sd)
        _mha(blk["cross_attn"], f"{prefix}.cross_attn", sd)
        if "film_layer" in blk:
            _dense(blk["film_layer"]["scale_proj"], f"{prefix}.film_layer.scale_proj", sd)
            _dense(blk["film_layer"]["shift_proj"], f"{prefix}.film_layer.shift_proj", sd)
        _dense(blk["ff_0"], f"{prefix}.ff.0", sd)
        _dense(blk["ff_3"], f"{prefix}.ff.3", sd)
        for n in ("norm1", "norm2", "norm3"):
            _norm(blk[n], f"{prefix}.{n}", sd)
    return sd


# --------------------------------------------------------- projection heads
def projector_state_dict_from_jax_params(params: Mapping[str, Any]) -> StateDict:
    """JAX `SpeechProjector` / `TextProjector` params ({proj: {net_0[, net_2]}})
    -> the port's state_dict (`proj.net.0.weight`, ...)."""
    sd: StateDict = {}
    for name, layer in _unwrap(params)["proj"].items():
        _dense(layer, f"proj.net.{int(name.rsplit('_', 1)[1])}", sd)
    return sd


def text_embedding_state_dict_from_jax_params(params: Mapping[str, Any]) -> StateDict:
    """JAX `TextEmbedding` params ({proj: {kernel}}) -> `proj.weight`."""
    sd: StateDict = {}
    _dense(_unwrap(params)["proj"], "proj", sd)
    return sd


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """A reference `.pt` in any of the three formats the reference inference
    accepts: a training dict with a `decoder` key, `{state_dict: ...}`, or a
    bare decoder state_dict.  Returns {decoder, s_proj, t_embed, t_proj,
    epoch, step, best_val_cer, config}, absent entries None.  A directory
    (the JAX package's orbax checkpoint) raises: it needs JAX to read."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"--ckpt {path}: a directory, not a reference .pt (an orbax checkpoint needs JAX "
            "to read).  The port's own training (python -m fddm_asr_tpu_torch.train) writes "
            "{prefix}.pt and, for a fine-tuned encoder, {prefix}.encoder.pt: pass them as "
            "--ckpt and --encoder-ckpt.  For a JAX run, where JAX is, "
            "scripts/export_torch_encoder.py --ckpt DIR --out E.pt --decoder-out D.pt writes "
            "its encoder (LoRA merged, EMA under ema_eval) and decoder: pass them the same "
            "way")
    raw = torch.load(path, map_location="cpu", weights_only=False)
    out: Dict[str, Any] = dict.fromkeys(
        ("s_proj", "t_embed", "t_proj", "epoch", "step", "best_val_cer", "config"))
    if isinstance(raw, dict) and "decoder" in raw:
        out["decoder"] = raw["decoder"]
        for key in out:
            if key != "decoder":
                out[key] = raw.get(key)
    elif isinstance(raw, dict) and "state_dict" in raw:
        out["decoder"] = raw["state_dict"]
    else:
        out["decoder"] = raw
    return out
