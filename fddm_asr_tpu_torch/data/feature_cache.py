# -*- coding: utf-8 -*-
"""Frozen-encoder feature cache for training.

Counterpart of `fddm_asr_tpu/data/feature_cache.py`, in the same files:
the condition `c` of a frozen encoder is computed once per utterance and
every later step feeds it to the decoder, skipping the WavLM forward.

Layout under `<dir>/<split>/`:
  feats.npy  np.memmap [N, S, d]; bfloat16 is stored as its 16-bit
             patterns (numpy has no bfloat16) and read back bit-exact as
             `torch.bfloat16`
  meta.json  shape, dtype and a fingerprint (the manifest, its content
             digest, the row count and an encoder-weight checksum), so a
             stale cache is refused instead of read.

The checksum samples the encoder's `state_dict`, whose leaves come in
another order than the JAX package's parameter tree, so the two packages'
checksums of one encoder differ.  The fingerprint also names its leaf
order (`checksum_leaves`), so a cache the JAX package built is always
refused here as stale, never read.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["FeatureCache", "build_cache", "cache_exists", "fingerprint", "param_checksum"]

_META = "meta.json"
_FEATS = "feats.npy"
CHECKSUM_LEAVES = "torch_state_dict"


def _dtype_token(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def param_checksum(state_dict: Dict[str, torch.Tensor]) -> float:
    """A cheap encoder-weight fingerprint: the sum of mean |leaf| over up to
    ~16 leaves sampled evenly from the state_dict."""
    leaves = list(state_dict.values())
    total = 0.0
    for leaf in leaves[:: max(1, len(leaves) // 16)]:
        total += float(leaf.detach().float().abs().mean())
    return round(total, 6)


def _manifest_digest(manifest_path: str) -> str:
    """md5 of the manifest's bytes plus (name, size, mtime) of every clip it
    references: re-preprocessed audio under the same paths changes it."""
    h = hashlib.md5()
    try:
        with open(manifest_path, "rb") as f:
            data = f.read()
    except OSError:
        return "unreadable"
    h.update(data)
    try:
        records = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        records = []
    for rec in records if isinstance(records, list) else []:
        p = rec.get("processed_path") if isinstance(rec, dict) else None
        if p and os.path.exists(p):
            st = os.stat(p)
            h.update(f"{os.path.basename(p)}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()


def fingerprint(manifest_path: str, n: int, checksum: float, masked: bool = False) -> dict:
    """The cache's identity; `masked` (features encoded with the attention
    mask of model.encoder.condition_mask) appears only when true."""
    fp = {"manifest": os.path.abspath(manifest_path), "n": n, "encoder_checksum": checksum,
          "content": _manifest_digest(manifest_path), "checksum_leaves": CHECKSUM_LEAVES}
    if masked:
        fp["masked"] = True
    return fp


def cache_exists(cache_dir: str, split: str) -> bool:
    d = os.path.join(cache_dir, split)
    return os.path.exists(os.path.join(d, _META)) and os.path.exists(os.path.join(d, _FEATS))


class FeatureCache:
    """Random-access reader over a feats memmap."""

    def __init__(self, cache_dir: str, split: str, expect_fingerprint: Optional[dict] = None):
        d = os.path.join(cache_dir, split)
        with open(os.path.join(d, _META), encoding="utf-8") as f:
            self.meta = json.load(f)
        if expect_fingerprint is not None and self.meta["fingerprint"] != expect_fingerprint:
            raise ValueError(
                f"stale feature cache at {d}: fingerprint {self.meta['fingerprint']} != "
                f"expected {expect_fingerprint}; delete the cache dir or point "
                "data.cache_features elsewhere")
        self.dtype_token = self.meta["dtype"]
        self._mm = np.lib.format.open_memmap(os.path.join(d, _FEATS), mode="r")
        if self._mm.shape != self.shape:
            raise ValueError(f"feature cache at {d}: feats.npy is {self._mm.shape}, "
                             f"meta.json says {self.shape}")

    @property
    def shape(self):
        return tuple(self.meta["shape"])

    @property
    def nbytes(self) -> int:
        return int(self._mm.nbytes)

    def rows(self, indices: Sequence[int]) -> torch.Tensor:
        """[B, S, d] on the host in the stored dtype (bfloat16 bit patterns
        restored)."""
        out = np.ascontiguousarray(self._mm[np.asarray(indices)])
        if self.dtype_token == "bfloat16":
            return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(out)


def build_cache(cache_dir: str, split: str, dataset, encode_fn: Callable,
                batch_size: int = 8, manifest_path: str = "", checksum: float = 0.0,
                log_every: int = 0, masked: bool = False) -> None:
    """Run `encode_fn(wave [B, T]) -> c [B, S, d]` (a tensor) over the
    dataset in manifest order and write the memmap and its meta.  With
    `masked`, `encode_fn(wave, lengths)`: WavLM runs with its attention
    mask, as condition_mask's features need."""
    d = os.path.join(cache_dir, split)
    os.makedirs(d, exist_ok=True)
    n = len(dataset)
    mm = dtype_token = None
    for start in range(0, n, batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, n))]
        waves = np.stack([it["wave"] for it in items])
        if masked:
            c = encode_fn(waves, np.asarray([it["wave_length"] for it in items], np.int32))
        else:
            c = encode_fn(waves)
        c = c.detach().cpu()
        if mm is None:
            dtype_token = _dtype_token(c.dtype)
            store = np.uint16 if c.dtype == torch.bfloat16 else np.dtype(dtype_token)
            mm = np.lib.format.open_memmap(os.path.join(d, _FEATS), mode="w+", dtype=store,
                                           shape=(n,) + tuple(c.shape[1:]))
        if dtype_token == "bfloat16":
            mm[start:start + len(items)] = c.view(torch.int16).numpy().view(np.uint16)
        else:
            mm[start:start + len(items)] = c.numpy()
        if log_every and (start // batch_size) % log_every == 0:
            logging.info(f"feature cache {split}: {start + len(items)}/{n}")
    mm.flush()
    meta = {"shape": list(mm.shape), "dtype": dtype_token,
            "fingerprint": fingerprint(manifest_path, n, checksum, masked=masked)}
    with open(os.path.join(d, _META), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
