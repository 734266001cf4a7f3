# -*- coding: utf-8 -*-
"""Config object, YAML loading with `base_config:` merge, special ids, device.

Counterpart of `fddm_asr_tpu/config.py`: one dict-like `Config` with both
attribute and `.get`/`[]` access serves every entry point.  `yaml` is
imported only inside `load_yaml` and `dump_yaml`, so building a pipeline
in code needs no YAML package.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Iterator, Mapping, Optional

import torch

__all__ = ["Config", "load_config", "load_yaml", "dump_yaml", "deep_merge",
           "resolve_special_ids", "resolve_device"]


class Config(Mapping):
    """Read-mostly nested mapping with attribute access and dict semantics.

    cfg.model.d_model == cfg["model"]["d_model"] == cfg.get("model").get("d_model")
    """

    __slots__ = ("_data",)

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_data", dict(data or {}))

    def __getitem__(self, key: str) -> Any:
        return _wrap(self._data[key])

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return _wrap(self._data.get(key, default))

    def __getattr__(self, key: str) -> Any:
        try:
            return _wrap(self._data[key])
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def updated(self, other: Mapping[str, Any]) -> "Config":
        return Config(deep_merge(self._data, dict(other)))

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _wrap(v: Any) -> Any:
    return Config(v) if isinstance(v, dict) else v


def deep_merge(base: Mapping[str, Any], override: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = copy.deepcopy(dict(base))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f) or {}


def dump_yaml(data: Mapping[str, Any], path: str) -> None:
    """Write `data` as YAML (`yaml.safe_dump`, the JAX scripts' writer)."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dict(data), f)


def load_config(path: str, overrides: Optional[Mapping[str, Any]] = None) -> Config:
    """Load a YAML config, resolving `base_config:` inheritance chains.

    A relative base path is tried as given, then relative to the child's
    directory, then as the child directory plus its basename."""
    raw = load_yaml(path)
    if "base_config" in raw:
        base_path = raw.pop("base_config")
        if not os.path.isabs(base_path):
            candidates = [
                base_path,
                os.path.join(os.path.dirname(path), base_path),
                os.path.join(os.path.dirname(path), os.path.basename(base_path)),
            ]
            for cand in candidates:
                if os.path.exists(cand):
                    base_path = cand
                    break
            else:
                raise FileNotFoundError(
                    f"base_config {base_path!r} (from {path}) not found; "
                    f"tried: {candidates}")
        raw = deep_merge(load_config(base_path).to_dict(), raw)
    if overrides:
        raw = deep_merge(raw, dict(overrides))
    return Config(raw)


def resolve_special_ids(cfg: Config, tokenizer_dir: Optional[str] = None) -> Dict[str, Optional[int]]:
    """pad/bos/eos/unk ids, preferring the tokenizer's `vocab.json` sidecar.

    Search order: `vocab.json` beside data.tokenizer_path (or in
    tokenizer_dir), then cfg.data.{pad,bos,eos,unk}_id; pad_id falls back
    to 0.  The shipped YAML says pad_id=0 while the trained tokenizer has
    <pad>=3, hence the sidecar first."""
    data = cfg.get("data", Config())
    out = {key: data.get(key) for key in ("pad_id", "bos_id", "eos_id", "unk_id")}
    tok_path = tokenizer_dir or data.get("tokenizer_path") or data.get("tokenizer_model_path")
    if tok_path:
        d = tok_path if os.path.isdir(tok_path) else os.path.dirname(tok_path)
        sidecar = os.path.join(d, "vocab.json")
        if os.path.exists(sidecar):
            try:
                with open(sidecar, "r", encoding="utf-8") as f:
                    special = json.load(f).get("special_token_ids", {})
            except (json.JSONDecodeError, OSError):
                special = {}
            for key in out:
                if key in special:
                    out[key] = int(special[key])
                elif key[:-3] in special:  # bare "pad" style
                    out[key] = int(special[key[:-3]])
    if out["pad_id"] is None:
        out["pad_id"] = 0
    return out


def resolve_device(device: Optional[str] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    present: nothing falls back to the CPU silently."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return dev
