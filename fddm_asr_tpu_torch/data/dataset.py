# -*- coding: utf-8 -*-
"""Host-side data pipeline: manifest dataset and prefetching batcher.

Counterpart of `fddm_asr_tpu/data/dataset.py`, with the same batches bit
for bit:

  * a manifest is a JSON list of records; a record whose `processed_path`
    does not exist is left out; its text is the first non-empty of `text`,
    `sentence`, `normalized_sentence`;
  * a waveform is read at the sample rate, zero-padded or cut to
    `max_audio_seconds`; its text is encoded, with optional bos/eos, and
    padded or cut to `max_len` with `pad_id`;
  * `make_batches` shuffles by `np.random.default_rng((seed, epoch))`, so
    every host draws the same global order; with `shard = (host,
    num_hosts)` host h's k-th batch is rows [h B, (h + 1) B) of the k-th
    global batch of B num_hosts, so the global batch keeps the
    single-process row order;
  * batches are decoded by a thread pool and prefetched through a bounded
    queue; a consumer that leaves early stops the producer, and a worker's
    failure is raised in the consumer.

Added here: `pin_memory=True` collates each batch's waveforms into a
page-locked torch tensor (`Batch.wave`), so that its copy to the card can
be non-blocking.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fddm_asr_tpu_torch.data.audio_io import load_audio

__all__ = ["Batch", "ManifestDataset", "shard_example_count", "make_batches"]


@dataclass
class Batch:
    wave: Union[np.ndarray, torch.Tensor]  # [B, T_max] float32 (pinned tensor with pin_memory)
    wave_lengths: np.ndarray    # [B] int32, valid samples before padding
    tokens: np.ndarray          # [B, L] int32, x0 padded with pad_id
    token_lengths: np.ndarray   # [B] int32
    indices: Optional[np.ndarray] = None  # [B] dataset indices (feature cache rows)


class ManifestDataset:
    """A `data/processed/{split}.json`-style manifest."""

    def __init__(self, json_file: str, tokenizer, max_len: int = 128, pad_id: int = 0,
                 bos_id: Optional[int] = None, eos_id: Optional[int] = None,
                 max_audio_seconds: float = 20.0, sample_rate: int = 16000,
                 filter_missing: bool = True) -> None:
        with open(json_file, "r", encoding="utf-8") as f:
            self.data = json.load(f)
        self.tokenizer = tokenizer
        self.max_len = int(max_len)
        self.pad_id = int(pad_id)
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.sample_rate = int(sample_rate)
        self.max_audio_samples = int(max_audio_seconds * sample_rate)
        self.valid_indices: List[int] = [
            i for i, item in enumerate(self.data)
            if not filter_missing or (item.get("processed_path")
                                      and os.path.exists(item["processed_path"]))]

    def __len__(self) -> int:
        return len(self.valid_indices)

    @staticmethod
    def text_of(item: Dict) -> str:
        for key in ("text", "sentence", "normalized_sentence"):
            if item.get(key):
                return item[key]
        return ""

    def tokenize(self, text: str) -> Tuple[np.ndarray, int]:
        tokens = list(self.tokenizer.encode(text))
        if self.bos_id is not None:
            tokens = [self.bos_id] + tokens
        if self.eos_id is not None:
            tokens = tokens + [self.eos_id]
        length = min(len(tokens), self.max_len)
        out = np.full((self.max_len,), self.pad_id, np.int32)
        out[:length] = tokens[:length]
        return out, length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.data[self.valid_indices[idx]]
        wav, _ = load_audio(item["processed_path"], target_sr=self.sample_rate, mono=True)
        n = min(len(wav), self.max_audio_samples)
        wave = np.zeros((self.max_audio_samples,), np.float32)
        wave[:n] = wav[:n]
        tokens, tok_len = self.tokenize(self.text_of(item))
        return {"wave": wave, "wave_length": np.int32(n), "tokens": tokens,
                "token_length": np.int32(tok_len)}


def shard_example_count(n: int, batch_size: int, shard: Optional[Sequence[int]],
                        drop_last: bool = False) -> int:
    """How many of n examples `make_batches(batch_size, shard=shard,
    drop_last=drop_last)` gives this host (the weight of its eval metrics)."""
    if shard is None:
        return (n // batch_size) * batch_size if drop_last else n
    host, num_hosts = shard
    global_bs = batch_size * num_hosts
    if drop_last:
        n = (n // global_bs) * global_bs
    full, rem = divmod(n, global_bs)
    return full * batch_size + max(0, min(batch_size, rem - host * batch_size))


def _batch_indices(n: int, batch_size: int, shuffle: bool, seed: int, epoch: int,
                   drop_last: bool, shard: Optional[Sequence[int]]) -> List[np.ndarray]:
    order = np.random.default_rng((seed, epoch)).permutation(n) if shuffle else np.arange(n)
    host, num_hosts = shard if shard is not None else (0, 1)
    global_bs = batch_size * num_hosts
    if drop_last:
        order = order[: (len(order) // global_bs) * global_bs]
    batches = [order[i:i + global_bs][host * batch_size:(host + 1) * batch_size]
               for i in range(0, len(order), global_bs)]
    return [b for b in batches if len(b)]


def make_batches(dataset: ManifestDataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, epoch: int = 0, drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 2, shard: Optional[Sequence[int]] = None,
                 pin_memory: bool = False) -> Iterator[Batch]:
    """Fixed-shape batches, decoded by `num_workers` threads, `prefetch`
    batches ahead of the consumer (see the module docstring)."""
    batches = _batch_indices(len(dataset), batch_size, shuffle, seed, epoch, drop_last, shard)
    if not batches:
        return
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    failure: list = [None]

    def put(item) -> bool:
        """A bounded put that gives up once the consumer has left, so the
        producer never blocks on a full queue forever."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def collate(pool, idxs) -> Batch:
        items = list(pool.map(dataset.__getitem__, idxs))
        if pin_memory:
            wave = torch.empty((len(items), dataset.max_audio_samples), dtype=torch.float32,
                               pin_memory=True)
            rows = wave.numpy()
            for i, it in enumerate(items):
                rows[i] = it["wave"]
        else:
            wave = np.stack([it["wave"] for it in items])
        return Batch(wave=wave,
                     wave_lengths=np.stack([it["wave_length"] for it in items]),
                     tokens=np.stack([it["tokens"] for it in items]),
                     token_lengths=np.stack([it["token_length"] for it in items]),
                     indices=np.asarray(idxs, np.int64))

    def producer():
        try:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                for idxs in batches:
                    if stop.is_set() or not put(collate(pool, idxs)):
                        return
        except BaseException as e:  # raised in the consumer, never swallowed
            failure[0] = e
        finally:
            if not put(None):  # the end-of-data sentinel
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass

    thread = threading.Thread(target=producer, name="make_batches", daemon=True)
    thread.start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                if failure[0] is not None:
                    raise RuntimeError("data pipeline worker failed mid-epoch") from failure[0]
                break
            yield batch
    finally:
        stop.set()
        thread.join(timeout=60)
