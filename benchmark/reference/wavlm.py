"""Plain float32 WavLM (HF `WavLMModel`, stable layer norm) and the acoustic
encoder's projection, written from the published description.

This is the benchmark's yardstick for the encoder.  It imports torch and
numpy only.  Parameter names are those of HF's state_dict (the positional
conv's weight norm folded into `conv.weight`), under `backbone.` with the
projection to d_model as `proj`, so one state_dict made by the benchmark
loads here and into the program alike.

Departures from HF: none in the forward pass at inference (no dropout, no
SpecAugment, no attention mask: the benchmark's transcribe cells feed the
encoder no lengths).

The forward pass is split where the benchmark's comparison checks it: the
front-end up to the feature projection (`frontend`), and the positional
conv, the layers and the projection to d_model (`layers`).  The caller runs
them in blocks of batch rows (`in_blocks`), so a batch of 32 x 20 s fits
beside the [B, H, L, L] scores.
"""
from __future__ import annotations

import math
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def relative_buckets(L: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """[L, L] int64: T5's bidirectional log bucket of (key - query)."""
    rel = np.arange(L)[None, :] - np.arange(L)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    exact = nb // 2
    large = np.log(np.maximum(rel, 1).astype(np.float32) / exact) / math.log(max_distance / exact)
    large = np.minimum((exact + large * (nb - exact)).astype(np.int64), nb - 1)
    return out + np.where(rel < exact, rel, large)


class ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, eps: float):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=s, bias=True)
        self.layer_norm = nn.LayerNorm(cout, eps=eps)


class FeatureEncoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        dims = [1] + list(c["conv_dim"])
        self.conv_layers = nn.ModuleList(
            ConvLayer(dims[i], dims[i + 1], k, s, c["layer_norm_eps"])
            for i, (k, s) in enumerate(zip(c["conv_kernel"], c["conv_stride"])))


class FeatureProjection(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c["conv_dim"][-1], eps=c["layer_norm_eps"])
        self.projection = nn.Linear(c["conv_dim"][-1], c["hidden_size"])


class PosConv(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        k = c["num_conv_pos_embeddings"]
        self.conv = nn.Conv1d(c["hidden_size"], c["hidden_size"], k, padding=k // 2,
                              groups=c["num_conv_pos_embedding_groups"])


class Attention(nn.Module):
    def __init__(self, c: dict, first: bool):
        super().__init__()
        D, H = c["hidden_size"], c["num_attention_heads"]
        self.q_proj, self.k_proj = nn.Linear(D, D), nn.Linear(D, D)
        self.v_proj, self.out_proj = nn.Linear(D, D), nn.Linear(D, D)
        self.gru_rel_pos_linear = nn.Linear(D // H, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
        if first:
            self.rel_attn_embed = nn.Embedding(c["num_buckets"], H)


class FeedForward(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.intermediate_dense = nn.Linear(c["hidden_size"], c["intermediate_size"])
        self.output_dense = nn.Linear(c["intermediate_size"], c["hidden_size"])


class Layer(nn.Module):
    def __init__(self, c: dict, first: bool):
        super().__init__()
        eps = c["layer_norm_eps"]
        self.attention = Attention(c, first)
        self.layer_norm = nn.LayerNorm(c["hidden_size"], eps=eps)
        self.feed_forward = FeedForward(c)
        self.final_layer_norm = nn.LayerNorm(c["hidden_size"], eps=eps)


class Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.pos_conv_embed = PosConv(c)
        self.layer_norm = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])
        self.layers = nn.ModuleList(Layer(c, i == 0) for i in range(c["num_hidden_layers"]))


class Backbone(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.feature_extractor = FeatureEncoder(c)
        self.feature_projection = FeatureProjection(c)
        self.masked_spec_embed = nn.Parameter(torch.zeros(c["hidden_size"]))
        self.encoder = Encoder(c)


class AcousticEncoder(nn.Module):
    """WavLM (stable layer norm, "layer" feature norm) + Linear to d_model
    when d_model differs from the hidden size.  `c` holds HF's config keys."""

    def __init__(self, c: dict, d_model: int):
        super().__init__()
        self.c = dict(c)
        if c.get("feat_extract_norm", "layer") != "layer" or not c.get("do_stable_layer_norm", True):
            raise ValueError("the reference covers WavLM-large's layout (layer norm, stable)")
        self.backbone = Backbone(c)
        if c["hidden_size"] != d_model:
            self.proj = nn.Linear(c["hidden_size"], d_model)

    def _attention(self, att: Attention, x, bias):
        c = self.c
        B, L, D = x.shape
        H = c["num_attention_heads"]
        dh = D // H
        heads = lambda t: t.reshape(B, L, H, dh).transpose(1, 2)  # noqa: E731
        q, k, v = heads(att.q_proj(x)), heads(att.k_proj(x)), heads(att.v_proj(x))
        g = torch.sigmoid(att.gru_rel_pos_linear(x.reshape(B, L, H, dh))
                          .reshape(B, L, H, 2, 4).sum(-1))
        gate = g[..., 0] * (g[..., 1] * att.gru_rel_pos_const[0, :, 0, 0] - 1.0) + 2.0
        scores = q @ k.transpose(-1, -2) / math.sqrt(dh)
        scores = scores + gate.transpose(1, 2)[..., None] * bias[None]
        out = torch.softmax(scores, dim=-1) @ v
        return att.out_proj(out.transpose(1, 2).reshape(B, L, D))

    def conv_features(self, wave: torch.Tensor, fp8: bool = False) -> torch.Tensor:
        """[B, T] float32 samples -> the conv stack's output [B, S, 512].
        `fp8`: every product's operands rounded to float8 e4m3 (one scale a
        tensor), the comparison's control one precision below bfloat16."""
        q = _fp8 if fp8 else (lambda t: t)
        x = wave[:, None, :]
        for layer in self.backbone.feature_extractor.conv_layers:
            conv = layer.conv
            x = F.conv1d(q(x), q(conv.weight), conv.bias, conv.stride)
            x = F.gelu(layer.layer_norm(x.transpose(1, 2)).transpose(1, 2))
        return x.transpose(1, 2)

    def project(self, feats: torch.Tensor, time_mask=None, fp8: bool = False) -> torch.Tensor:
        """The feature projection [B, S, 512] -> [B, S, hidden]; `time_mask`
        [B, S] bool: frames replaced by `masked_spec_embed` (SpecAugment)."""
        q = _fp8 if fp8 else (lambda t: t)
        proj = self.backbone.feature_projection
        x = F.linear(q(proj.layer_norm(feats)), q(proj.projection.weight), proj.projection.bias)
        if time_mask is not None:
            x = torch.where(time_mask[..., None], self.backbone.masked_spec_embed, x)
        return x

    def frontend(self, wave: torch.Tensor, fp8: bool = False) -> torch.Tensor:
        """[B, T] float32 samples -> the feature projection's output."""
        return self.project(self.conv_features(wave, fp8), fp8=fp8)

    def position_bias(self, L: int, device) -> torch.Tensor:
        """[H, L, L]: layer 0's embedding of each (query, key) bucket."""
        c = self.c
        buckets = torch.from_numpy(relative_buckets(L, c["num_buckets"],
                                                    c["max_bucket_distance"])).to(device)
        return self.backbone.encoder.layers[0].attention.rel_attn_embed(buckets).permute(2, 0, 1)

    def attention_branch(self, i: int, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """Layer i's attention on its normed input x [B, L, hidden]."""
        return self._attention(self.backbone.encoder.layers[i].attention, x, bias)

    def ffn_branch(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer i's feed-forward on its normed input x."""
        ff = self.backbone.encoder.layers[i].feed_forward
        return ff.output_dense(F.gelu(ff.intermediate_dense(x)))

    def layer(self, i: int, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """Layer i on the residual stream x (pre-LN)."""
        layer = self.backbone.encoder.layers[i]
        x = x + self.attention_branch(i, layer.layer_norm(x), bias)
        return x + self.ffn_branch(i, layer.final_layer_norm(x))

    def posconv(self, x: torch.Tensor, fp8: bool = False) -> torch.Tensor:
        """The positional conv embedding of x [B, S, hidden] (grouped conv,
        the trailing frame of an even kernel dropped, GELU); `fp8` as in
        `frontend`."""
        conv = self.backbone.encoder.pos_conv_embed.conv
        q = _fp8 if fp8 else (lambda t: t)
        h = F.conv1d(q(x.transpose(1, 2)), q(conv.weight), conv.bias, padding=conv.padding,
                     groups=conv.groups)
        if conv.kernel_size[0] % 2 == 0:
            h = h[:, :, :-1]
        return F.gelu(h).transpose(1, 2)

    def layers(self, x: torch.Tensor) -> torch.Tensor:
        """The feature projection's output [B, S, hidden] -> [B, S, d_model]:
        positional conv, the layers, the final norm and the projection."""
        enc = self.backbone.encoder
        x = x + self.posconv(x)
        bias = self.position_bias(x.shape[1], x.device)
        for i in range(len(enc.layers)):
            x = self.layer(i, x, bias)
        x = enc.layer_norm(x)
        return self.proj(x) if hasattr(self, "proj") else x


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


@torch.no_grad()
def in_blocks(fn, x: torch.Tensor, rows: int = 4) -> torch.Tensor:
    """`fn(x)` in blocks of `rows` batch rows (the attention scores of a
    block are [rows, H, L, L] float32)."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])
